"""Post-training int8 quantization, W8A8 with int32 accumulation
(counterpart of ``camels_diffusion_model_tpu/models/quantize.py``).

* weights: per-output-channel symmetric int8 (absmax / 127), from the fp32
  kernel at each call;
* activations: dynamic per-tensor symmetric int8 (absmax / 127);
* accumulation: int32, rescaled by ``s_x * s_w[o]`` and the bias added in
  fp32, in JAX's order: ``acc.float() * (s_x * s_w) + bias``.

The int8 convolution is an XLA op in the JAX package, not a Pallas kernel,
so here it is a library GEMM: the quantized input is unfolded into int8
columns (zero padding, the SAME convolution) and ``torch._int_mm``
multiplies them with the int8 weights on the card (cuBLASLt, int32
accumulation).  The reduction axis is padded to a multiple of 8 (and the
rows past 16, the output channels to a multiple of 8) with zeros, as the
card's ``_int_mm`` asks.  On the CPU the same columns are multiplied as
float64, whose sums of these products (below 2^53) are exact whatever the
CPU: its ``_int_mm`` goes through oneDNN, whose int8 kernels for CPUs
without VNNI add products in pairs into 16 bits, which may saturate.  As in JAX, nothing
wires this layer into the model: it is the building block of an int8
serving experiment.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

QMAX = 127.0  # +-127 keeps the quantizer symmetric


def quantize_symmetric(x: torch.Tensor, axis=None):
    """``(q, scale)`` with ``q`` int8 and ``x ~= q * scale`` (``quantize.py:
    45-58``): ``axis`` names the axes reduced into each scale (None: one
    scale for the tensor; ``(0, 1, 2)`` of an HWIO kernel, or ``(1, 2, 3)``
    of an OIHW one, gives one per output channel).  Rounds half to even, as
    ``jnp.round`` does; every division is a true one on either device."""
    x = x.float()
    if axis is None:
        absmax = x.abs().amax()
    else:
        absmax = x.abs().amax(dim=axis, keepdim=True)
    # A tensor divisor: CUDA divides by a Python number as a multiplication
    # by its rounded reciprocal, an ulp off the CPU's (and XLA's) quotient.
    # Filled on the device, so a CUDA graph can capture it.
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, QMAX)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    if axis is not None:
        scale = scale.reshape([n for d, n in enumerate(scale.shape)
                               if d not in {a % x.dim() for a in axis}])
    return q, scale


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def int8_conv_sums(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 sums of the same-padding stride-1 convolution of the int8
    NCHW ``x_q`` with the int8 OIHW ``w_q`` (odd kernel sizes), NCHW out:
    int8 columns times int8 weights, ``torch._int_mm`` on the card and an
    exact float64 product on the CPU (module docstring)."""
    b, c, h, w = x_q.shape
    o, _, kh, kw = w_q.shape
    xp = F.pad(x_q, (kw // 2, kw // 2, kh // 2, kh // 2))
    cols = xp.unfold(2, kh, 1).unfold(3, kw, 1)  # (B, C, H, W, kh, kw)
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(b * h * w, c * kh * kw)
    k, m = c * kh * kw, b * h * w
    kp, op, mp = _round_up(k, 8), _round_up(o, 8), max(m, 17)
    a = torch.zeros((mp, kp), dtype=torch.int8, device=x_q.device)
    a[:m, :k] = cols
    wt = torch.zeros((kp, op), dtype=torch.int8, device=x_q.device)
    wt[:k, :o] = w_q.reshape(o, k).t()
    if a.device.type == "cuda":
        acc = torch._int_mm(a, wt)
    else:
        acc = (a.double() @ wt.double()).to(torch.int32)
    return acc[:m, :o].reshape(b, h, w, o).permute(0, 3, 1, 2)


class QuantConv(nn.Module):
    """Int8 W8A8 stand-in for a same-padding conv (``quantize.py:61-105``),
    over NCHW as the port's convolutions.  ``weight`` ``(O, I, kh, kw)``
    and ``bias`` ``(O,)`` fp32 start at zero, as the flax module's; the
    JAX tree's ``kernel`` (HWIO) loads through :meth:`load_jax_params`.
    The output is in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros((features, in_channels) + tuple(kernel_size)))
        self.bias = nn.Parameter(torch.zeros(features))

    def load_jax_params(self, params: dict) -> "QuantConv":
        """Take the flax ``{"kernel": HWIO, "bias": (O,)}`` of a QuantConv
        or an ``nn.Conv`` (the same tree)."""
        with torch.no_grad():
            self.weight.copy_(torch.as_tensor(params["kernel"]).permute(3, 2, 0, 1))
            self.bias.copy_(torch.as_tensor(params["bias"]))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_q, s_w = quantize_symmetric(self.weight, axis=(1, 2, 3))  # s_w: (O,)
        x_q, s_x = quantize_symmetric(x)
        acc = int8_conv_sums(x_q, w_q)
        y = acc.float() * (s_x * s_w)[:, None, None] + self.bias.float()[:, None, None]
        return y.to(self.dtype)


def dequantized_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fp32 convolution a :class:`QuantConv` approximates, on the same
    quantized operands, dequantized (``quantize.py:108-123``): ``conv(x_q *
    s_x, w_q * s_w) + bias`` over NCHW ``x`` and the OIHW ``weight``."""
    w_q, s_w = quantize_symmetric(weight, axis=(1, 2, 3))
    x_q, s_x = quantize_symmetric(x)
    kh, kw = weight.shape[2:]
    y = F.conv2d(x_q.float() * s_x, w_q.float() * s_w[:, None, None, None],
                 padding=(kh // 2, kw // 2))
    return (y + bias.float()[:, None, None]).to(dtype)
