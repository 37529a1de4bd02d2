"""Strided samplers over a timestep subsequence (counterpart of
``camels_diffusion_model_tpu/diffusion/ddim.py``).

* ``sigma_mode="beta"``, the certified serving sampler (strided DDPM): the
  reference chain's ancestral update with the composite alpha of each jump
  ``a_jump = ab_t / ab_prev`` and ``sigma^2 = 1 - a_jump``
  (``ddim.py:100-106``).  At stride 1 it is ``sample_ddpm`` up to fp32
  rounding of ``ab_t / ab_{t-1}``.
* ``sigma_mode="posterior"`` (the default, as in JAX), DDIM:
  ``x' = sqrt(ab_prev) * x0_hat + sqrt(max(1 - ab_prev - sigma^2, 0)) * eps
  + sigma * z`` with ``x0_hat = (x - sqrt(1 - ab_t) * eps) / sqrt(ab_t)``
  and ``sigma = eta * sqrt((1 - ab_prev)/(1 - ab_t)) * sqrt(1 - ab_t/
  ab_prev)`` (``ddim.py:107-116``).  It is ``x' = A*x + B*eps + sigma*z``,
  which the step kernel takes as ``inv_sqrt_a = A``, ``c_eps = -B/A``.

Both set ``sigma = 0`` on the last jump and run the same loop
(``sampler.run_chain``), guidance, FiLM tables, step kernel K1,
stochastic-shortcut draws (``ddim.py:84``) and ``mesh=`` batch sharding
(``ddim.py:200-218``) as ``sample_ddpm``, each with its own table of step
coefficients.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from .sampler import ShortcutFn, ZFn, prepare, run_chain
from .schedule import DDPMSchedule


def ddim_timesteps(timesteps: int, n_steps: int) -> np.ndarray:
    """Strided subsequence tau_1 < ... < tau_n of [1, T] (endpoints
    included), as ``ddim.py:39-44``."""
    taus = np.unique(np.linspace(1, timesteps, min(n_steps, timesteps)).round())
    return taus.astype(np.int32)


def hybrid_timesteps(timesteps: int, t_exact: int, stride: int) -> np.ndarray:
    """Every step for ``t <= t_exact``, a stride of ``stride`` above it, and
    ``T`` (``ddim.py:45-61``)."""
    if not 0 < t_exact <= timesteps:
        raise ValueError(f"t_exact must be in (0, {timesteps}]")
    coarse = np.arange(t_exact + stride, timesteps + 1, stride, dtype=np.int64)
    taus = np.concatenate([np.arange(1, t_exact + 1), coarse, [timesteps]])
    return np.unique(taus).astype(np.int32)


def _jumps(taus: np.ndarray):
    """The reversed ``taus`` (T..1) and each one's next timestep (0 last)."""
    t = torch.as_tensor(taus[::-1].copy(), dtype=torch.long)
    return t, torch.cat([t[1:], torch.zeros(1, dtype=torch.long)])


def beta_coefficients(schedule: DDPMSchedule, taus: np.ndarray) -> torch.Tensor:
    """``(n, 3)`` fp32 ``[c_eps, inv_sqrt_a, sigma]`` of the strided update
    over the reversed ``taus`` (T..1), each jump to the next (0 last)."""
    t, t_prev = _jumps(taus)
    ab_t = schedule.alpha_bar[t]
    a_jump = ab_t / schedule.alpha_bar[t_prev]
    c_eps = (1.0 - a_jump) * torch.rsqrt(1.0 - ab_t)
    sigma = torch.sqrt(torch.clamp(1.0 - a_jump, min=0.0))
    sigma = torch.where(t_prev > 0, sigma, 0.0)
    return torch.stack([c_eps, torch.rsqrt(a_jump), sigma], dim=1)


def posterior_coefficients(schedule: DDPMSchedule, taus: np.ndarray,
                           eta: float) -> torch.Tensor:
    """``(n, 3)`` fp32 ``[c_eps, inv_sqrt_a, sigma]`` of the DDIM update
    ``x' = A*x + B*eps + sigma*z`` over the reversed ``taus``:
    ``inv_sqrt_a = A = sqrt(ab_prev / ab_t)`` and ``c_eps = -B / A`` with
    ``B = sqrt(max(1 - ab_prev - sigma^2, 0)) - sqrt(ab_prev) * sqrt(1 -
    ab_t) / sqrt(ab_t)``."""
    t, t_prev = _jumps(taus)
    ab_t, ab_prev = schedule.alpha_bar[t], schedule.alpha_bar[t_prev]
    sigma = (eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab_t))
             * torch.sqrt(1.0 - ab_t / ab_prev))
    sigma = torch.where(t_prev > 0, sigma, 0.0)
    sqrt_ab_prev = torch.sqrt(ab_prev)
    a = sqrt_ab_prev * torch.rsqrt(ab_t)
    b = (torch.sqrt(torch.clamp(1.0 - ab_prev - sigma**2, min=0.0))
         - sqrt_ab_prev * torch.sqrt(1.0 - ab_t) * torch.rsqrt(ab_t))
    return torch.stack([-b / a, a, sigma], dim=1)


def sample_ddim(
    model,
    schedule: DDPMSchedule,
    generator: torch.Generator,
    n_sample: int = 1,
    size: int = 64,
    params=None,
    guide_w=0.0,
    n_steps: int = 50,
    eta: float = 0.0,
    x_init=None,
    taus: Optional[np.ndarray] = None,
    sigma_mode: str = "posterior",
    device=None,
    z_fn: Optional[ZFn] = None,
    shortcut_fn: Optional[ShortcutFn] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Samples ``(B, size, size, C)`` over ``taus`` (default
    :func:`ddim_timesteps` of ``n_steps``) by DDIM (``sigma_mode=
    "posterior"``, noise scaled by ``eta``; ``eta=0`` draws no z) or by the
    strided DDPM (``"beta"``, ``eta`` ignored); other arguments, ``mesh``
    included, as ``sample_ddpm``."""
    if sigma_mode not in ("posterior", "beta"):
        raise ValueError(f"unknown sigma_mode {sigma_mode!r}: 'posterior' or 'beta'")
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
    x, params, use_cfg, w, shard = prepare(
        model, n_sample, size, params, guide_w, x_init, generator, device, mesh
    )
    coefs = (beta_coefficients(schedule, taus) if sigma_mode == "beta"
             else posterior_coefficients(schedule, taus, eta))
    x, _ = run_chain(model, x, params, use_cfg, w, schedule.timesteps,
                     taus[::-1].tolist(), coefs, generator, z_fn,
                     shortcut_fn=shortcut_fn, shard=shard)
    return x
