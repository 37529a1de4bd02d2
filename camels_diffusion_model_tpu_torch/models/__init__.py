"""The canonical ContextUnet in PyTorch (counterpart of ``camels_diffusion_model_tpu.models``)."""
