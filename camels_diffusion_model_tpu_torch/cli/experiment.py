"""Post-training evaluation of the experiment CLI (counterpart of parts of
``camels_diffusion_model_tpu/cli/experiment.py``).

Plain functions for now; ``run_experiment`` itself comes with training.

* :func:`sample_metrics`: ELBO, BPD and NLL of a map set
  (``_sample_metrics``, ``experiment.py:103-115``).
* :func:`reconstruct`: maps forward-diffused to ``t = T`` by ``q_sample``,
  then the exact chain from that noise with its saved intermediates
  (``experiment.py:609-630``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import batch_iterator
from ..diffusion.likelihood import NoiseFn, calculate_elbo_and_bpd, calculate_likelihood
from ..diffusion.sampler import SamplerOutput, ZFn, sample_ddpm_from_noise
from ..diffusion.schedule import DDPMSchedule, NoiseScaling, q_sample


def sample_metrics(model, schedule: DDPMSchedule, x, c, generator,
                   batch_size: int, dims: Optional[int] = None,
                   elbo_noise_fn: Optional[NoiseFn] = None,
                   nll_noise_fn: Optional[NoiseFn] = None,
                   device=None) -> tuple:
    """``(elbo, bpd, nll)`` of maps ``x`` (NHWC) on contexts ``c``, in
    ordered batches of ``batch_size``; the ELBO pass draws its noise from
    ``generator`` first, then the NLL sweep (or each from its noise_fn)."""
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    c = c.cpu().numpy() if torch.is_tensor(c) else np.asarray(c)
    batches = list(batch_iterator(x, c, batch_size, shuffle=False))
    elbo, bpd = calculate_elbo_and_bpd(
        model, schedule, batches, generator, dims=dims, batch_size=batch_size,
        noise_fn=elbo_noise_fn, device=device)
    nll = calculate_likelihood(model, schedule, batches, generator,
                               batch_size=batch_size, noise_fn=nll_noise_fn,
                               device=device)
    return elbo, bpd, nll


def reconstruct(model, schedule: DDPMSchedule, images, params, generator,
                scaling: NoiseScaling = NoiseScaling.REFERENCE,
                save_rate: int = 20, noise=None, z_fn: Optional[ZFn] = None,
                device=None) -> SamplerOutput:
    """Forward-diffuse ``images`` (NHWC) to ``t = T`` with ``noise`` (drawn
    from ``generator`` when None) and run ``sample_ddpm_from_noise`` from
    there on ``params`` (None: the zero context, as for an unconditional
    experiment)."""
    device = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, device=device)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
    x_fwd = q_sample(schedule, images, schedule.timesteps, noise, scaling)
    return sample_ddpm_from_noise(model, schedule, generator, x_fwd, params=params,
                                  save_rate=save_rate, device=device, z_fn=z_fn)
