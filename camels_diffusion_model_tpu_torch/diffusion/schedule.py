"""DDPM noise schedule, the forward perturbation and the reverse-step
coefficients.

Counterpart of ``camels_diffusion_model_tpu/diffusion/schedule.py``:
``NoiseScaling`` (``:32``), ``make_schedule`` (``:68-85``), ``q_sample`` in
both scalings (``:97``), ``p_sample_step`` in its rsqrt form (``:116-133``)
and ``ddpm_loss`` (``:136``).  The schedule lives on the CPU in fp32: the
samplers read three scalar coefficients per step from it and hand them to
the step kernel; ``q_sample`` gathers its coefficients there and moves them
to the maps' device.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch


class NoiseScaling(str, enum.Enum):
    """Which ``q_sample`` noise scaling to use.

    REFERENCE: ``sqrt(ab_t) * x + (1 - ab_t) * noise``, the form of the
    reference's trainers and of its NLL sweep.  STANDARD: ``sqrt(ab_t) * x
    + sqrt(1 - ab_t) * noise``, the textbook form of its ELBO evaluator.
    """

    REFERENCE = "reference"
    STANDARD = "standard"


class DDPMSchedule(NamedTuple):
    """Linear-beta schedule of length ``timesteps + 1`` (index 0: ab = 1)."""

    beta: torch.Tensor
    alpha: torch.Tensor
    alpha_bar: torch.Tensor
    timesteps: int


def make_schedule(
    timesteps: int, beta1: float = 1e-4, beta2: float = 0.02
) -> DDPMSchedule:
    """``b_t = (beta2 - beta1) * linspace(0, 1, T+1) + beta1``, ``a = 1 - b``,
    ``ab = exp(cumsum(log a))`` with ``ab[0] = 1``, all fp32 on the CPU."""
    if timesteps < 1:
        raise ValueError(f"timesteps must be >= 1, got {timesteps}")
    lin = torch.linspace(0.0, 1.0, timesteps + 1, dtype=torch.float32)
    beta = (beta2 - beta1) * lin + beta1
    alpha = 1.0 - beta
    alpha_bar = torch.exp(torch.cumsum(torch.log(alpha), dim=0))
    alpha_bar[0] = 1.0
    return DDPMSchedule(beta, alpha, alpha_bar, int(timesteps))


def ddpm_coefficients(schedule: DDPMSchedule, t: torch.Tensor) -> torch.Tensor:
    """``(n, 3)`` fp32 ``[c_eps, inv_sqrt_a, sigma]`` of the ancestral step
    at integer timesteps ``t``: ``x' = (x - c_eps*eps)*inv_sqrt_a + sigma*z``
    with ``c_eps = (1-a)/sqrt(1-ab)``, ``inv_sqrt_a = 1/sqrt(a)`` and
    ``sigma = sqrt(b)``, except ``sigma = 0`` at ``t == 1`` (no noise on the
    last step)."""
    a = schedule.alpha[t]
    ab = schedule.alpha_bar[t]
    c_eps = (1.0 - a) * torch.rsqrt(1.0 - ab)
    sigma = torch.where(t > 1, torch.sqrt(schedule.beta[t]), 0.0)
    return torch.stack([c_eps, torch.rsqrt(a), sigma], dim=1)


def p_sample_step(schedule: DDPMSchedule, x, t: int, eps, z):
    """One ancestral reverse step at scalar ``t`` on plain tensors; the
    caller passes ``z = 0`` at ``t == 1``, as in the JAX package."""
    a = schedule.alpha[t]
    c_eps = float((1.0 - a) * torch.rsqrt(1.0 - schedule.alpha_bar[t]))
    mean = (x - eps * c_eps) * float(torch.rsqrt(a))
    return mean + float(torch.sqrt(schedule.beta[t])) * z


def _bcast_t(coeff: torch.Tensor, t, like: torch.Tensor) -> torch.Tensor:
    """``coeff[t]`` broadcastable against ``like`` (``schedule.py:88-94``),
    gathered on ``coeff``'s device (a schedule moved to the maps' device
    costs no host sync): for a scalar ``t`` a 0-d tensor, which torch
    applies as a scalar when it is on the CPU; for a ``(B,)`` one
    ``(B, 1, ...)`` on ``like``'s device."""
    g = coeff[torch.as_tensor(t, dtype=torch.long).to(coeff.device)]
    if g.dim() == 0:
        return g
    return g.reshape(g.shape + (1,) * (like.dim() - g.dim())).to(like.device)


def q_sample(schedule: DDPMSchedule, x0: torch.Tensor, t, noise: torch.Tensor,
             scaling: NoiseScaling = NoiseScaling.REFERENCE) -> torch.Tensor:
    """Forward-diffuse ``x0`` to integer timestep ``t`` (scalar or ``(B,)``,
    in ``[0, T]``) with ``noise`` of ``x0``'s shape."""
    ab = _bcast_t(schedule.alpha_bar, t, x0)
    omab = 1.0 - ab
    if NoiseScaling(scaling) == NoiseScaling.REFERENCE:
        return torch.sqrt(ab) * x0 + omab * noise
    return torch.sqrt(ab) * x0 + torch.sqrt(omab) * noise


def ddpm_loss(pred_noise: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The epsilon-prediction MSE, a 0-d tensor."""
    return torch.mean(torch.square(pred_noise - noise))
