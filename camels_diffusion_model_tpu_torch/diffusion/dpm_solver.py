"""DPM-Solver++(2M), the second-order multistep ODE sampler (counterpart of
``camels_diffusion_model_tpu/diffusion/dpm_solver.py``).

Over the strided subsequence ``tau_n > ... > tau_1`` of
:func:`~.ddim.ddim_timesteps`, with ``alpha = sqrt(ab)``, ``sigma =
sqrt(1 - ab)`` and ``lambda = log(alpha / sigma)``, each step takes the
data prediction ``x0 = (x - sigma * eps) / alpha`` and

    h = lambda_prev - lambda_t,  r = h_last / h
    D = (1 + 1/(2r)) * x0 - 1/(2r) * x0_last          (first step: D = x0)
    x' = (sigma_prev / sigma_t) * x - alpha_prev * expm1(-h) * D

and the final jump to ``t = 0`` returns ``x0`` (``dpm_solver.py:43-93``).
The step's scalars are computed once per call in fp32 in JAX's order of
operations; the update is a few tensor operations (no Pallas kernel in
JAX either).

Each step is one model forward with the FiLM tables hoisted
(:func:`~.sampler.film_tables`): the encoder once and, under guidance, the
decoder on the doubled ``[cond, uncond]`` batch, so kernels K2 (twice) and
K3 (once) launch a step; ``out_conv2`` (and the deep and big variants'
tanh) runs as ``ContextUnet.decode`` runs it, then the guidance combine.
No z is drawn: the sampler is deterministic given ``x_init``, but for a
stochastic-shortcut model's projection, one draw a forward from
``generator`` (``dpm_solver.py:64-69``) or from ``shortcut_fn(step, t)``.
A bf16 model's eps is cast to the fp32 state, as in JAX.  ``mesh=`` shards
the batch as the other samplers do (``dpm_solver.py:145-165``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import fp32_math
from ..ops.sampler_step import guided_eps
from ..parallel.mesh import Mesh
from .ddim import ddim_timesteps
from .sampler import ShortcutFn, film_tables, prepare
from .schedule import DDPMSchedule


def dpm2m_coefficients(schedule: DDPMSchedule, taus: np.ndarray) -> List[tuple]:
    """One ``(t, s_eps, inv_sqrt_ab, c_x0, c_last, sig_ratio, c_d, last)``
    a step over the reversed ``taus`` (T..1), fp32 as the JAX scan body
    computes them: ``x0 = (x - s_eps * eps) * inv_sqrt_ab``, ``D = c_x0 * x0
    - c_last * x0_last`` (but for the first step), ``x' = sig_ratio * x -
    c_d * D``; ``last`` marks the final jump, which returns ``x0``."""
    ab_all = schedule.alpha_bar.detach().cpu().to(torch.float32)
    t = torch.as_tensor(taus[::-1].copy(), dtype=torch.long)
    t_prev = torch.cat([t[1:], torch.zeros(1, dtype=torch.long)])
    t_prev1 = torch.clamp(t_prev, min=1)  # guards lambda(0) = inf; discarded

    def lam(ts):
        ab = ab_all[ts]
        return 0.5 * (torch.log(ab) - torch.log1p(-ab))

    ab, ab_p = ab_all[t], ab_all[t_prev1]
    h = lam(t_prev1) - lam(t)
    last = t_prev == 0
    h_last = torch.cat([torch.ones(1), h[:-1]])  # the step before's (JAX's carry)
    r = h_last / h
    c_last = 1.0 / (2.0 * r)
    rows = zip(t.tolist(), torch.sqrt(1.0 - ab).tolist(), torch.rsqrt(ab).tolist(),
               (1.0 + c_last).tolist(), c_last.tolist(),
               torch.sqrt((1.0 - ab_p) / (1.0 - ab)).tolist(),
               (torch.sqrt(ab_p) * torch.expm1(-h)).tolist(), last.tolist())
    return list(rows)


def sample_dpm2m(
    model,
    schedule: DDPMSchedule,
    generator: torch.Generator,
    n_sample: int = 1,
    size: int = 64,
    params=None,
    guide_w=0.0,
    n_steps: int = 25,
    x_init=None,
    device=None,
    shortcut_fn: Optional[ShortcutFn] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Samples ``(B, size, size, C)`` by DPM-Solver++(2M) over
    :func:`ddim_timesteps` of ``n_steps`` (module docstring).

    ``generator`` (on ``device``) draws ``x_init`` and ``params`` when they
    are not given (params uniform in [0, 1) per sample) and a stochastic
    model's projections unless ``shortcut_fn`` gives them.  ``guide_w``: a
    float, or a ``(B,)`` array of all-positive weights (JAX's
    ``ValueError`` for mixed signs or another length).  Runs inside
    :func:`fp32_math`."""
    x, params, use_cfg, w, shard = prepare(
        model, n_sample, size, params, guide_w, x_init, generator, device, mesh
    )
    steps = dpm2m_coefficients(schedule, ddim_timesteps(schedule.timesteps, n_steps))
    with torch.inference_mode(), fp32_math():
        tables = film_tables(model, params, schedule.timesteps, use_cfg)
        cemb1, cemb2, temb1_tab, temb2_tab = tables
        x0_last = None
        for k, (t, s_eps, inv_sqrt_ab, c_x0, c_last, sig_ratio, c_d, last) in enumerate(steps):
            proj = None
            if model.stochastic:
                proj = (shortcut_fn(k, t) if shortcut_fn is not None
                        else model.draw_shortcut(generator))
            enc = model.encode(x, shortcut=proj)
            if use_cfg:
                enc = enc.doubled()
            film = (cemb1, temb1_tab[t:t + 1], cemb2, temb2_tab[t:t + 1])
            eps = guided_eps(model.decode(enc, film=film), w if use_cfg else None)
            x0 = (x - s_eps * eps.to(x.dtype)) * inv_sqrt_ab
            if last:
                x = x0
            else:
                d = x0 if x0_last is None else c_x0 * x0 - c_last * x0_last
                x = sig_ratio * x - c_d * d
            x0_last = x0
        return shard.gather(x)
