"""Data: the certification's conditioning contexts (numpy)."""
