"""Strided DDPM, the certified serving sampler (counterpart of
``camels_diffusion_model_tpu/diffusion/ddim.py``, ``sigma_mode="beta"``).

The reference chain's ancestral update with the composite alpha of each jump
``a_jump = ab_t / ab_prev`` and ``sigma^2 = 1 - a_jump`` (``ddim.py:100-106``),
``sigma = 0`` on the last jump.  At stride 1 it is ``sample_ddpm`` up to fp32
rounding of ``ab_t / ab_{t-1}``.  Same loop (``sampler.run_chain``),
guidance and FiLM tables as ``sample_ddpm``, and the same step kernel K1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .sampler import ZFn, prepare, run_chain
from .schedule import DDPMSchedule


def ddim_timesteps(timesteps: int, n_steps: int) -> np.ndarray:
    """Strided subsequence tau_1 < ... < tau_n of [1, T] (endpoints
    included), as ``ddim.py:39-44``."""
    taus = np.unique(np.linspace(1, timesteps, min(n_steps, timesteps)).round())
    return taus.astype(np.int32)


def beta_coefficients(schedule: DDPMSchedule, taus: np.ndarray) -> torch.Tensor:
    """``(n, 3)`` fp32 ``[c_eps, inv_sqrt_a, sigma]`` of the strided update
    over the reversed ``taus`` (T..1), each jump to the next (0 last)."""
    t = torch.as_tensor(taus[::-1].copy(), dtype=torch.long)
    t_prev = torch.cat([t[1:], torch.zeros(1, dtype=torch.long)])
    ab_t = schedule.alpha_bar[t]
    a_jump = ab_t / schedule.alpha_bar[t_prev]
    c_eps = (1.0 - a_jump) * torch.rsqrt(1.0 - ab_t)
    sigma = torch.sqrt(torch.clamp(1.0 - a_jump, min=0.0))
    sigma = torch.where(t_prev > 0, sigma, 0.0)
    return torch.stack([c_eps, torch.rsqrt(a_jump), sigma], dim=1)


def sample_ddim(
    model,
    schedule: DDPMSchedule,
    generator: torch.Generator,
    n_sample: int = 1,
    size: int = 64,
    params=None,
    guide_w=0.0,
    n_steps: int = 50,
    x_init=None,
    taus: Optional[np.ndarray] = None,
    sigma_mode: str = "beta",
    device=None,
    z_fn: Optional[ZFn] = None,
) -> torch.Tensor:
    """Samples ``(B, size, size, C)`` by the strided DDPM over ``taus``
    (default :func:`ddim_timesteps` of ``n_steps``).  Only
    ``sigma_mode="beta"`` is ported; arguments as ``sample_ddpm``."""
    if sigma_mode != "beta":
        raise ValueError(f"only sigma_mode='beta' is ported, got {sigma_mode!r}")
    if taus is None:
        taus = ddim_timesteps(schedule.timesteps, n_steps)
    taus = np.asarray(taus, np.int64)
    if taus.ndim != 1 or len(taus) < 2 or np.any(np.diff(taus) <= 0) or (
        taus[0] < 1 or taus[-1] > schedule.timesteps
    ):
        raise ValueError(
            "taus must be a strictly increasing subsequence of "
            f"[1, {schedule.timesteps}]"
        )
    x, params, use_cfg, w = prepare(
        model, n_sample, size, params, guide_w, x_init, generator, device
    )
    return run_chain(model, x, params, use_cfg, w, schedule.timesteps,
                     taus[::-1].tolist(), beta_coefficients(schedule, taus),
                     generator, z_fn)
