"""Schedule, samplers and spectral calibration (counterpart of ``camels_diffusion_model_tpu.diffusion``)."""
