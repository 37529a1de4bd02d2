"""Training and validation steps with Adam and the per-epoch linear decay
(counterpart of ``camels_diffusion_model_tpu/training/trainer.py``).

The step is the JAX package's: t ~ U{1..T} per sample, ``q_sample`` in the
mode's scaling (``_noise_coeff``, ``trainer.py:69-72``), the per-sample
epsilon MSE averaged over the real rows of a padded batch
(:func:`masked_mean`), Adam with torch's defaults and a learning rate that
falls linearly per epoch.  The model's ``train=True`` forward normalises its
BatchNorms with batch statistics (flax's biased variance) and runs the
decoder's GroupNorm and FiLM in plain PyTorch under autograd, as the JAX
package trains without its Pallas kernels; the validation step is a no-grad
``train=False`` forward, so it runs kernels K2 and K3 on the card.

Noise: JAX draws ``t``, the noise and a stochastic-shortcut model's
projection of each step from ``split(rng, 3)`` of the step's key
(``trainer.py:168-183,247``).  Here a step draws ``t`` first, then the
noise, then the projection (stochastic models only) from a generator
seeded by ``(run seed, 0, step)`` (:func:`seeded_generator`), so a run
resumed at step ``n`` draws what the unbroken run drew; the tests inject
JAX's draws through ``t=``, ``noise=`` and ``shortcut=``.  The projection
goes into the forward as an argument, so a rematerialised forward uses
the same one.  The steps run inside
:func:`fp32_math` (TF32 off).  A bf16 model (``ContextUnet(dtype=
torch.bfloat16)``) computes its forward in bf16 on fp32 parameters: its eps
is bf16, the loss against the fp32 noise promotes to fp32, autograd carries
the gradient through the layers' casts to the fp32 parameters, and Adam
updates those (fp32 masters, fp32 moments), as the JAX step does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .. import fp32_math
from ..diffusion.schedule import DDPMSchedule, make_schedule, q_sample
from ..models.blocks import commit_batch_stats


def linear_decay_schedule(lrate: float, n_epoch: int, steps_per_epoch: int):
    """``lrate * (1 - ep / n_epoch)`` with ``ep = step // steps_per_epoch``
    (``trainer.py:34-41``)."""

    def schedule(step: int) -> float:
        ep = step // steps_per_epoch
        return lrate * (1.0 - ep / n_epoch)

    return schedule


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its Adam optimizer,
    the learning-rate schedule, the count of updates done and the run seed
    the steps' noise is drawn from."""

    model: nn.Module
    optimizer: torch.optim.Adam
    lr_schedule: Callable[[int], float]
    step: int = 0
    seed: int = 0


def create_train_state(model: nn.Module, lrate: float, n_epoch: int,
                       steps_per_epoch: int, beta1: float = 0.9,
                       beta2: float = 0.999, seed: int = 0) -> TrainState:
    """Adam (betas ``(beta1, beta2)``, eps 1e-8, torch's and the reference's
    defaults) over ``model``'s parameters with :func:`linear_decay_schedule`:
    each update takes the schedule at the count of updates before it, as
    optax's ``scale_by_schedule`` does (``trainer.py:44-66``)."""
    if seed < 0:
        raise ValueError(f"the run seed must be >= 0, got {seed}")
    schedule = linear_decay_schedule(lrate, n_epoch, steps_per_epoch)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(beta1, beta2), eps=1e-8)
    return TrainState(model, optimizer, schedule, 0, int(seed))


def seeded_generator(device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded by the non-negative ints ``keys``
    through numpy's ``SeedSequence``: one independent stream per key tuple
    (the training step's is ``(run seed, 0, step)``)."""
    seed = int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def masked_mean(per_sample: torch.Tensor, mask: Optional[torch.Tensor]):
    """``(per_sample_masked, mean)`` over the real rows of a padded batch:
    ``mask`` ``(B,)`` is 1 for real rows and 0 for pad rows (None: all
    real); pad rows come back zeroed (``trainer.py:75-89``)."""
    if mask is None:
        return per_sample, torch.mean(per_sample)
    m = mask.to(per_sample.dtype)
    per_sample = per_sample * m
    return per_sample, torch.sum(per_sample) / torch.sum(m)


def parse_remat_env(value):
    """A remat mode string -> :func:`make_train_step`'s ``remat``: '' or
    None -> False, 'full' -> True, 'convs' -> 'convs' (``trainer.py:
    92-104``; ``CAMELS_TRAIN_REMAT``)."""
    value = value or ""
    modes = {"": False, "full": True, "convs": "convs"}
    if value not in modes:
        raise ValueError(
            f"remat mode {value!r} — valid values: '' (off), 'full', 'convs'"
        )
    return modes[value]


def _save_convolutions(ctx, op, *args, **kwargs):
    """Selective checkpointing policy of ``remat="convs"``: keep the
    convolution outputs (and transposed convolutions': one aten op), run
    everything else again in the backward pass."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _training_forward(model: nn.Module, remat):
    def forward(x, t, c, proj=None):
        return model(x, t, c, train=True, shortcut=proj)

    if remat == "convs":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_convolutions)
        return lambda *args: checkpoint(forward, *args, use_reentrant=False,
                                        context_fn=context)
    if remat:
        return lambda *args: checkpoint(forward, *args, use_reentrant=False)
    return forward


class _Noising:
    """``t``, the noise and ``q_sample`` of one batch on the model's device:
    the part the train and the eval step share."""

    def __init__(self, model: nn.Module, timesteps: int, scaling: str,
                 beta1: float, beta2: float):
        self.model, self.timesteps, self.scaling = model, timesteps, scaling
        self.schedule = make_schedule(timesteps, beta1, beta2)
        self._on = {}  # device -> the schedule there (no host sync a step)

    def needs_generator(self, t, noise, shortcut) -> bool:
        return t is None or noise is None or (self.model.stochastic and shortcut is None)

    def __call__(self, x, c, mask, generator, t, noise, shortcut):
        dev = next(self.model.parameters()).device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        c = torch.as_tensor(c, dtype=torch.float32, device=dev)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        if self.needs_generator(t, noise, shortcut) and generator is None:
            raise ValueError("give a generator, or t, noise (and a stochastic "
                             "model's shortcut)")
        if t is None:
            t = torch.randint(1, self.timesteps + 1, (x.shape[0],),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=dev)
        if self.model.stochastic and shortcut is None:
            shortcut = self.model.draw_shortcut(generator)
        if shortcut is not None:
            shortcut = tuple(torch.as_tensor(p, dtype=torch.float32, device=dev)
                             for p in shortcut)
        t = torch.as_tensor(t, dtype=torch.long, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        if dev not in self._on:
            self._on[dev] = DDPMSchedule(*(a.to(dev) for a in self.schedule[:3]),
                                         self.timesteps)
        x_pert = q_sample(self._on[dev], x, t, noise, self.scaling)
        return x_pert, t, t.float() / self.timesteps, c, noise, mask, shortcut


def _per_sample_mse(out, noise):
    return torch.mean(torch.square(out - noise), dim=tuple(range(1, out.dim())))


def make_train_step(model: nn.Module, timesteps: int, scaling: str = "reference",
                    beta1: float = 1e-4, beta2: float = 0.02, remat=False):
    """The training step (``trainer.py:107-214``):

        metrics = step(state, x, c, mask=None, *, t=None, noise=None, shortcut=None)

    ``x`` NHWC, ``c`` ``(B, n_cfeat)``, ``mask`` ``(B,)`` (1 real row, 0
    pad row: the loss and its gradient are the mean over the real rows;
    the pad rows still count in the BatchNorm statistics, as in JAX).
    ``t`` ``(B,)``, ``noise`` (``x``'s shape) and ``shortcut`` (a stochastic
    model's ``(kernel, bias)``) replace the draws from the step's
    generator.  The step updates ``state`` in place -- parameters,
    Adam moments, BatchNorm running statistics, ``step`` -- and leaves this
    step's gradients in each parameter's ``.grad``; the JAX step's
    ``donate`` has no counterpart, as torch updates in place anyway.
    Returns ``{"loss", "per_sample_mse", "t"}`` as device tensors (no
    host sync).  ``beta1``/``beta2`` are the noise schedule's ends.

    ``remat``: False keeps autograd's saved tensors; True
    (``torch.utils.checkpoint``) saves none and runs the forward again in
    the backward pass; ``"convs"`` saves only the convolution outputs
    (selective checkpointing).  The math is the same in all three.
    """
    noising = _Noising(model, timesteps, scaling, beta1, beta2)
    forward = _training_forward(model, remat)

    def train_step(state: TrainState, x, c, mask=None, *, t=None, noise=None,
                   shortcut=None):
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        dev = next(model.parameters()).device
        generator = None
        if noising.needs_generator(t, noise, shortcut):
            generator = seeded_generator(dev, state.seed, 0, state.step)
        with fp32_math():
            x_pert, t, t_norm, c, noise, mask, proj = noising(x, c, mask, generator, t,
                                                              noise, shortcut)
            state.optimizer.zero_grad(set_to_none=True)
            args = (x_pert, t_norm, c) + ((proj,) if proj is not None else ())
            per_sample = _per_sample_mse(forward(*args), noise)
            per_sample, loss = masked_mean(per_sample, mask)
            loss.backward()
            for group in state.optimizer.param_groups:
                group["lr"] = state.lr_schedule(state.step)
            state.optimizer.step()
            commit_batch_stats(model)
        state.step += 1
        return {"loss": loss.detach(), "per_sample_mse": per_sample.detach(), "t": t}

    return train_step


def make_eval_step(model: nn.Module, timesteps: int, scaling: str = "reference",
                   beta1: float = 1e-4, beta2: float = 0.02):
    """The validation MSE step (``trainer.py:217-255``):

        metrics = eval_step(x, c, mask=None, *, generator=None, t=None, noise=None,
                            shortcut=None)

    A ``train=False`` forward of ``model`` (running statistics; kernels K2
    and K3 on the card) under ``torch.inference_mode()``, with ``t``, the
    noise and a stochastic model's projection drawn from ``generator`` in
    that order unless given.  Returns
    ``{"loss", "per_sample_mse", "t"}`` as device tensors."""
    noising = _Noising(model, timesteps, scaling, beta1, beta2)

    def eval_step(x, c, mask=None, *, generator=None, t=None, noise=None, shortcut=None):
        with torch.inference_mode(), fp32_math():
            x_pert, t, t_norm, c, noise, mask, proj = noising(x, c, mask, generator, t,
                                                              noise, shortcut)
            per_sample = _per_sample_mse(model(x_pert, t_norm, c, shortcut=proj), noise)
            per_sample, loss = masked_mean(per_sample, mask)
        return {"loss": loss, "per_sample_mse": per_sample, "t": t}

    return eval_step
