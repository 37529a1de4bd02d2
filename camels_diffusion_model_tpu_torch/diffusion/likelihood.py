"""ELBO / BPD / NLL evaluation passes (counterpart of
``camels_diffusion_model_tpu/diffusion/likelihood.py``).

The reference's three likelihood formulas, each reproduced with its own
noise scaling and weight:

* :func:`elbo_bpd_batch` / :func:`calculate_elbo_and_bpd` (paper form): the
  10 truncated-linspace timesteps of :func:`elbo_timesteps`, STANDARD
  scaling, weight ``0.5 * b_t / (1 - ab_t)`` for ``t > 1`` only, averaged
  over the 10; ``bpd = elbo / (dims * ln 2)`` (``likelihood.py:53-85,
  179-212``).
* :func:`nll_batch` / :func:`calculate_likelihood`: a sweep over ``t = 1..T``
  with REFERENCE scaling and weight ``1 / (2 b_t)`` (``:89-141, 215-239``);
  the JAX docstring's "second hot loop": T full forwards a batch.
* :func:`elbo_full_trajectory_batch` (the same sweep, weight ``0.5 * (1 /
  (1 - ab_t) - 1)``, divided by T) and :func:`elbo_per_batch` (that weight
  at given timesteps, ``:143-165``).

Each forward is ``ContextUnet.forward`` -- the encoder, the decoder with
kernels K2 (FiLM stage 0 as its epilogue) and K3, then ``out_conv2`` as a
cuDNN conv, as the JAX package runs it outside any Pallas kernel -- under
``torch.inference_mode()`` and :func:`fp32_math`.  With a bf16 model eps is
bf16 (its ``out_conv2`` a bf16 conv) and its squared error against the fp32
noise promotes to fp32, as in JAX.  The sweeps take an
explicit range of timesteps (default ``1..T``) and run it as one loop.

Noise: JAX draws each tensor from a key chain; here every noise tensor comes
from ``generator`` (on the device) unless ``noise_fn(batch_index,
step_index, t, shape)`` gives it, as ``z_fn`` does for the samplers.
``batch_index`` counts the batches of the dataset-level functions (0 for a
single batch), ``step_index`` the timesteps of one batch's pass.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import fp32_math, resolve_device
from .schedule import DDPMSchedule, NoiseScaling, q_sample

NoiseFn = Callable[[int, int, int, tuple], torch.Tensor]


def elbo_timesteps(timesteps: int, n: int = 10) -> np.ndarray:
    """The reference's ``torch.linspace(1, T, n).long()``: linspace, then
    truncation toward zero, with the last entry ``T``."""
    ts = np.linspace(1.0, float(timesteps), n)
    ts = np.trunc(ts).astype(np.int32)
    ts[-1] = timesteps
    return ts


def _per_sample_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE over all non-batch axes -> ``(B,)``."""
    return torch.mean(torch.square(pred - target), dim=tuple(range(1, pred.dim())))


def _on_device(model, x, c, device):
    """``x`` and ``c`` as fp32 tensors on the device the pass runs on, after
    checking the model can run it: on that device, BatchNorm (if not
    folded) in eval mode, no stochastic shortcut."""
    device = resolve_device(device)
    if next(model.parameters()).device != device:
        raise ValueError(f"model is not on {device}")
    if getattr(model, "shortcut", "learned") == "stochastic":
        raise NotImplementedError("the stochastic init_conv shortcut is not ported")
    if any(isinstance(m, nn.BatchNorm2d) and m.training for m in model.modules()):
        raise ValueError("BatchNorm must be in eval mode (model.eval()) or folded")
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    c = torch.as_tensor(c, dtype=torch.float32, device=device)
    return x, c


def _noise(noise_fn: Optional[NoiseFn], generator, batch_index: int, k: int,
           t: int, x: torch.Tensor) -> torch.Tensor:
    if noise_fn is not None:
        z = noise_fn(batch_index, k, t, tuple(x.shape))
        if not torch.is_tensor(z):
            z = torch.from_numpy(np.array(z, np.float32))  # a writable copy
        return z.to(x.device, torch.float32)
    if generator is None:
        raise ValueError("pass a generator or a noise_fn")
    return torch.randn(x.shape, generator=generator, device=x.device)


def _eps(model, x_t: torch.Tensor, t: int, timesteps: int, c: torch.Tensor):
    """The model's eps at integer timestep ``t`` (normalised to ``t / T`` in
    fp32, one row for the batch)."""
    t_norm = torch.full((1,), float(t), device=x_t.device) / timesteps
    return model(x_t, t_norm, c)


@fp32_math()
def elbo_bpd_batch(model, schedule: DDPMSchedule, x, c, generator=None,
                   sampled_t: Optional[Sequence[int]] = None,
                   noise_fn: Optional[NoiseFn] = None, batch_index: int = 0,
                   device=None) -> torch.Tensor:
    """Per-sample ELBO ``(B,)`` of one batch (paper form) at ``sampled_t``
    (default :func:`elbo_timesteps` of T); ``x`` NHWC, ``c`` ``(B,
    n_cfeat)``."""
    x, c = _on_device(model, x, c, device)
    ts = elbo_timesteps(schedule.timesteps) if sampled_t is None else sampled_t
    ts = [int(t) for t in ts]
    acc = torch.zeros(x.shape[0], device=x.device)
    with torch.inference_mode():
        for k, t in enumerate(ts):
            noise = _noise(noise_fn, generator, batch_index, k, t, x)
            x_t = q_sample(schedule, x, t, noise, NoiseScaling.STANDARD)
            mse = _per_sample_mse(_eps(model, x_t, t, schedule.timesteps, c), noise)
            weight = 0.5 * schedule.beta[t] / (1.0 - schedule.alpha_bar[t])
            acc = acc + (float(weight) if t > 1 else 0.0) * mse / len(ts)
    return acc


def _sweep_weights(schedule: DDPMSchedule, weighting: str) -> torch.Tensor:
    if weighting == "nll":
        return 1.0 / (2.0 * schedule.beta)
    if weighting == "elbo":
        return 0.5 * (1.0 / (1.0 - schedule.alpha_bar) - 1.0)
    raise ValueError(f"unknown weighting {weighting!r}: 'nll' or 'elbo'")


@fp32_math()
def _t_sweep(model, schedule: DDPMSchedule, x, c, generator=None,
            ts: Optional[Sequence[int]] = None, weighting: str = "nll",
            noise_fn: Optional[NoiseFn] = None, batch_index: int = 0,
            device=None) -> torch.Tensor:
    """``sum_t w_t * mse_t`` per sample ``(B,)`` over the timesteps ``ts``
    (default ``1..T``, ascending as in JAX), REFERENCE scaling; ``w_t`` of
    ``weighting`` "nll" (``1/(2 b_t)``) or "elbo" (``0.5*(1/(1-ab_t)-1)``)
    (``likelihood.py:89-114``)."""
    x, c = _on_device(model, x, c, device)
    weights = _sweep_weights(schedule, weighting)
    ts = range(1, schedule.timesteps + 1) if ts is None else ts
    acc = torch.zeros(x.shape[0], device=x.device)
    with torch.inference_mode():
        for k, t in enumerate(int(t) for t in ts):
            noise = _noise(noise_fn, generator, batch_index, k, t, x)
            x_t = q_sample(schedule, x, t, noise, NoiseScaling.REFERENCE)
            mse = _per_sample_mse(_eps(model, x_t, t, schedule.timesteps, c), noise)
            acc = acc + float(weights[t]) * mse
    return acc


def nll_batch(model, schedule: DDPMSchedule, x, c, generator=None, ts=None,
              noise_fn: Optional[NoiseFn] = None, batch_index: int = 0,
              device=None) -> torch.Tensor:
    """Per-sample NLL ``(B,)`` of one batch: the "nll" :func:`_t_sweep`."""
    return _t_sweep(model, schedule, x, c, generator, ts, "nll", noise_fn,
                   batch_index, device)


def elbo_full_trajectory_batch(model, schedule: DDPMSchedule, x, c,
                               generator=None, ts=None,
                               noise_fn: Optional[NoiseFn] = None,
                               batch_index: int = 0, device=None) -> torch.Tensor:
    """Per-sample full-trajectory ELBO ``(B,)``: the "elbo" :func:`_t_sweep`
    divided by T."""
    acc = _t_sweep(model, schedule, x, c, generator, ts, "elbo", noise_fn,
                  batch_index, device)
    return acc / schedule.timesteps


def elbo_per_batch(schedule: DDPMSchedule, mse_per_sample: torch.Tensor, t,
                   mask=None) -> torch.Tensor:
    """Training-time ELBO of one batch: ``mean(0.5*(1/(1-ab_t)-1) * mse)``
    at the batch's timesteps ``t`` ``(B,)``; with ``mask`` ``(B,)`` the mean
    over the real rows of a padded batch.  The weights are gathered where
    the schedule lives."""
    mse_per_sample = torch.as_tensor(mse_per_sample)
    ab = schedule.alpha_bar[torch.as_tensor(t, dtype=torch.long).to(schedule.alpha_bar.device)]
    weight = (0.5 * (1.0 / (1.0 - ab) - 1.0)).to(mse_per_sample.device)
    if mask is None:
        return torch.mean(weight * mse_per_sample)
    m = torch.as_tensor(mask, device=mse_per_sample.device).to(mse_per_sample.dtype)
    return torch.sum(weight * mse_per_sample * m) / torch.sum(m)


def _pad_batch(x: np.ndarray, c: np.ndarray, batch_size: int):
    """Zero-pad a partial batch to ``batch_size``: ``(x, c, n_real)``."""
    n = x.shape[0]
    if n == batch_size:
        return x, c, n
    pad = batch_size - n
    x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    c = np.concatenate([c, np.zeros((pad,) + c.shape[1:], c.dtype)], axis=0)
    return x, c, n


def _dataset_mean(batches, batch_size, per_batch) -> Tuple[float, Optional[int]]:
    """Mean over the real rows of ``batches`` of ``per_batch(bi, x, c)``
    ``(B,)``, each partial batch padded to ``batch_size`` (default its own
    size) as the JAX package pads it; also ``H*W`` of the first batch."""
    total, count, hw = 0.0, 0, None
    for bi, (x, c) in enumerate(batches):
        x, c = np.asarray(x), np.asarray(c)
        if hw is None:
            hw = x.shape[1] * x.shape[2]
        x_p, c_p, n_real = _pad_batch(x, c, batch_size or x.shape[0])
        total += float(torch.sum(per_batch(bi, x_p, c_p)[:n_real]))
        count += n_real
    return total / max(count, 1), hw


def calculate_elbo_and_bpd(model, schedule: DDPMSchedule,
                           batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                           generator=None, dims: Optional[int] = None,
                           batch_size: Optional[int] = None,
                           noise_fn: Optional[NoiseFn] = None,
                           device=None) -> Tuple[float, float]:
    """Dataset-level ELBO and BPD (paper form) over ``(x NHWC, c)``
    batches; ``dims`` defaults to H*W of the first batch."""
    elbo, hw = _dataset_mean(batches, batch_size, lambda bi, x, c: elbo_bpd_batch(
        model, schedule, x, c, generator, noise_fn=noise_fn, batch_index=bi,
        device=device))
    return elbo, elbo / ((dims or hw or 1) * math.log(2.0))


def calculate_likelihood(model, schedule: DDPMSchedule,
                         batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                         generator=None, batch_size: Optional[int] = None,
                         ts=None, noise_fn: Optional[NoiseFn] = None,
                         device=None) -> float:
    """Dataset-mean NLL over ``(x NHWC, c)`` batches (:func:`nll_batch`)."""
    nll, _ = _dataset_mean(batches, batch_size, lambda bi, x, c: nll_batch(
        model, schedule, x, c, generator, ts, noise_fn, bi, device))
    return nll
