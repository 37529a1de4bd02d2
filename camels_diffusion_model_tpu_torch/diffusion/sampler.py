"""Ancestral DDPM sampling (counterpart of
``camels_diffusion_model_tpu/diffusion/sampler.py``).

A Python loop over the reverse steps; each step runs the encoder once, the
FiLM decoder up to ``out_norm`` on ``[cond, uncond]`` under classifier-free
guidance (the unconditional context is zeros, ``sampler.py:144-167``), and
one launch of the step kernel K1, which applies the decoder's output conv
(and the tanh of the deep and big variants), the guidance combine and the
update.  The FiLM embeddings are hoisted out
of the loop (``:369-381``): the context MLPs run once per call and the time
MLPs once for all ``T + 1`` timesteps.  With
``guide_w == 0`` the model runs once per step with the conditional context
and no guidance, as in the reference; ``z = 0`` at ``t == 1``.
``sample_ddpm_from_noise`` runs the same chain from given noisy maps and
keeps the states of the reference's save schedule (``sampler.py:95-102``).

With a bf16 model (``ContextUnet(dtype=torch.bfloat16)``) the FiLM tables,
the features and eps are bf16 and the state x stays fp32, as in JAX
(``sampler.py:264-276``): K1's bf16 instance takes the bf16 features and
``out_conv2``'s weights cast to bf16 once per call, and z is drawn in x's
dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import fp32_math, resolve_device
from ..models.blocks import to_compute, to_nhwc
from ..ops.sampler_step import fused_head_step
from .schedule import DDPMSchedule, ddpm_coefficients

# z_fn(step, t) -> z for reverse step number ``step`` (0 first) at timestep
# ``t``: the tests' hook for feeding both packages the same noise.
ZFn = Callable[[int, int], torch.Tensor]


class SamplerOutput(NamedTuple):
    x: torch.Tensor  # final samples, (B, H, W, C)
    intermediate: torch.Tensor  # saved states, (n_saves, B, H, W, C)


def save_schedule(timesteps: int, save_rate: int) -> tuple:
    """``(mask, slots, n_saves)``: which of the reversed steps ``T..1`` keep
    the state they produce (``t % save_rate == 0``, ``t == T`` or ``t <
    8``), and the chronological slot of each (``sampler.py:95-102``)."""
    steps = np.arange(timesteps, 0, -1)
    mask = (steps % save_rate == 0) | (steps == timesteps) | (steps < 8)
    slots = np.cumsum(mask) - 1
    return mask.astype(np.bool_), slots.astype(np.int32), int(mask.sum())


def guidance(guide_w, batch: int, device) -> tuple:
    """``(use_cfg, w)`` for the step kernel: ``w`` a float or a ``(B,)``
    tensor on ``device``, validated as ``sampler.py:402-414`` does."""
    w_arr = np.asarray(guide_w, np.float64)
    use_cfg = bool(np.any(w_arr > 0.0))
    if w_arr.ndim > 0 and use_cfg and np.any(w_arr <= 0.0):
        raise ValueError(
            "per-sample guide_w must be all-positive (w=0 uses a different "
            "single-forward semantics in the reference; run it separately)"
        )
    if w_arr.ndim > 0 and w_arr.shape[0] != batch:
        raise ValueError(
            f"per-sample guide_w length {w_arr.shape[0]} must match the "
            f"batch size {batch}"
        )
    if not use_cfg:
        return False, None
    if w_arr.ndim == 0:
        return True, float(w_arr)
    return True, torch.as_tensor(w_arr, dtype=torch.float32, device=device)


def film_tables(model, params: torch.Tensor, timesteps: int, use_cfg: bool):
    """``(cemb1, cemb2, temb1_tab, temb2_tab)`` in the model's dtype:
    context embeddings once per call (for ``[cond, uncond]`` under CFG) and
    the time embeddings of every timestep ``0..T`` (normalised in fp32) as
    ``(T+1, C)`` tables."""
    c = params
    if use_cfg:
        c = torch.cat([params, torch.zeros_like(params)], dim=0)
    cemb1, cemb2 = model.context_embed(c)
    t_norm = torch.arange(timesteps + 1, dtype=torch.float32,
                          device=params.device) / timesteps
    temb1_tab, temb2_tab = model.time_embed(t_norm.reshape(-1, 1))
    return cemb1, cemb2, temb1_tab, temb2_tab


def predict_features(model, x, tables, t: int, use_cfg: bool) -> torch.Tensor:
    """The decoder's features at timestep ``t`` (``out_norm``'s output as
    NHWC, in the model's dtype): ``(B, ...)``, or ``(2B, ...)`` stacked
    ``[cond; uncond]`` under CFG, for the step kernel to apply ``out_conv2``
    and combine."""
    cemb1, cemb2, temb1_tab, temb2_tab = tables
    enc = model.encode(x)
    if use_cfg:
        enc = enc.doubled()
    film = (cemb1, temb1_tab[t:t + 1], cemb2, temb2_tab[t:t + 1])
    return to_nhwc(model.decode_features(enc, film=film))


def prepare(model, n_sample, size, params, guide_w, x_init, generator, device):
    """Shared set-up of both samplers on ``device``: initial noise, context
    and guidance."""
    device = resolve_device(device)
    if next(model.parameters()).device != device:
        raise ValueError(f"model is not on {device}")
    if x_init is None:
        x = torch.randn((n_sample, size, size, model.in_channels),
                        generator=generator, device=device)
    else:
        x = torch.as_tensor(x_init, dtype=torch.float32, device=device).clone()
    if params is None:
        params = torch.rand((x.shape[0], model.n_cfeat), generator=generator,
                            device=device)
    params = torch.as_tensor(params, dtype=torch.float32, device=device)
    use_cfg, w = guidance(guide_w, x.shape[0], device)
    return x, params, use_cfg, w


def sample_ddpm(
    model,
    schedule: DDPMSchedule,
    generator: torch.Generator,
    n_sample: int = 1,
    size: int = 64,
    params=None,
    guide_w=0.0,
    x_init=None,
    device=None,
    z_fn: Optional[ZFn] = None,
) -> torch.Tensor:
    """Samples ``(B, size, size, C)`` by the exact ``T``-step ancestral chain.

    ``generator`` (on ``device``) draws ``x_init`` and ``params`` when they
    are not given (params uniform in [0, 1) per sample) and every step's z
    unless ``z_fn`` supplies it.  ``guide_w``: a float, or a ``(B,)`` array
    of all-positive weights.
    """
    x, params, use_cfg, w = prepare(
        model, n_sample, size, params, guide_w, x_init, generator, device
    )
    x, _ = _ddpm_chain(model, schedule, x, params, use_cfg, w, generator, z_fn)
    return x


def sample_ddpm_from_noise(
    model,
    schedule: DDPMSchedule,
    generator: torch.Generator,
    noise_images,
    params=None,
    guide_w=0.0,
    save_rate: int = 20,
    device=None,
    z_fn: Optional[ZFn] = None,
) -> SamplerOutput:
    """The exact ``T``-step chain seeded with forward-diffused maps
    ``noise_images`` ``(B, H, W, C)`` (``sampler.py:344-366``).
    ``params=None`` means the zero context, and then no guidance.  Returns
    the samples and the states of :func:`save_schedule` in chronological
    order; other arguments as :func:`sample_ddpm`."""
    noise_images = torch.as_tensor(noise_images)
    if params is None:
        params = torch.zeros(noise_images.shape[0], model.n_cfeat)
        guide_w = 0.0
    x, params, use_cfg, w = prepare(
        model, None, None, params, guide_w, noise_images, generator, device
    )
    mask, _, _ = save_schedule(schedule.timesteps, save_rate)
    x, saved = _ddpm_chain(model, schedule, x, params, use_cfg, w, generator,
                           z_fn, mask)
    return SamplerOutput(x, torch.stack(saved))


def _ddpm_chain(model, schedule, x, params, use_cfg, w, generator, z_fn,
                save_mask=None):
    steps = torch.arange(schedule.timesteps, 0, -1)
    coefs = ddpm_coefficients(schedule, steps)
    return run_chain(model, x, params, use_cfg, w, schedule.timesteps,
                     steps.tolist(), coefs, generator, z_fn, save_mask)


def run_chain(model, x, params, use_cfg: bool, w, timesteps: int, steps,
              coefs: torch.Tensor, generator, z_fn: Optional[ZFn],
              save_mask: Optional[np.ndarray] = None):
    """The reverse loop of the samplers: at each timestep of ``steps``
    (descending) the decoder's features and one launch of the step kernel
    (output conv, guidance, update) with that step's ``[c_eps, inv_sqrt_a,
    sigma]`` row of ``coefs``; z is drawn (or taken from ``z_fn``) only
    where sigma is not 0.  Returns the last state and the list of the
    states of the steps where ``save_mask`` (one bool a step) is set.
    Runs inside :func:`fp32_math`."""
    saved = []
    with torch.inference_mode(), fp32_math():
        head = (to_compute(model.out_conv2.weight, model.dtype),
                to_compute(model.out_conv2.bias, model.dtype))
        tables = film_tables(model, params, timesteps, use_cfg)
        for k, (t, (c_eps, inv_sqrt_a, sigma)) in enumerate(zip(steps, coefs.tolist())):
            h = predict_features(model, x, tables, t, use_cfg)
            z = None
            if sigma != 0.0:
                z = (z_fn(k, t).to(x.device) if z_fn is not None else
                     torch.randn(x.shape, generator=generator, device=x.device))
            x = fused_head_step(h, *head, x, z, c_eps, inv_sqrt_a, sigma, w,
                                tanh=model.final_tanh)
            if save_mask is not None and save_mask[k]:
                saved.append(x)
    return x, saved
