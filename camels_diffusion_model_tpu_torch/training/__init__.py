"""Checkpoint loading (counterpart of ``camels_diffusion_model_tpu.training``)."""
