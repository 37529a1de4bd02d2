"""GroupNorm + affine + activation kernel K2 (NHWC).

Wraps ``csrc/groupnorm.cu``, the counterpart of the Pallas
``fused_groupnorm_act`` (``camels_diffusion_model_tpu/ops/pallas/
groupnorm.py:65``).  The decoder runs it at ``up0_norm`` ``(N, 16, 16, 256)``
and ``out_norm`` ``(N, 64, 64, 128)``: two launches per decoder call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

ACTS = {"none": 0, "relu": 1, "gelu": 2, "leaky_relu": 3}

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p,
)


def activation(y, act: str):
    """The activations of the JAX package (``context_unet.py:54-61``)."""
    if act == "relu":
        return F.relu(y)
    if act == "gelu":
        return F.gelu(y, approximate="none")
    if act == "leaky_relu":
        return F.leaky_relu(y, 0.2)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def groupnorm_act_plain(x, gamma, beta, num_groups: int = 8,
                        eps: float = 1e-5, act: str = "relu"):
    """Two-pass fp32 GroupNorm + affine + act over NHWC, as the JAX XLA
    path computes it (``models/blocks.py:322-330``)."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return activation(y * gamma + beta, act).to(x.dtype)


def fused_groupnorm_act(x, gamma, beta, num_groups: int = 8,
                        eps: float = 1e-5, act: str = "relu"):
    """GroupNorm(num_groups) + ``gamma``/``beta`` + act of NHWC ``x``.

    On CUDA tensors this launches the kernel; on CPU tensors it runs
    :func:`groupnorm_act_plain`.
    """
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return groupnorm_act_plain(x, gamma, beta, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_groupnorm_act: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"fused_groupnorm_act: {name} must be a contiguous float32 "
                f"tensor on {x.device}"
            )
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must be ({c},)")
    out = torch.empty_like(x)
    fn = _build.kernel("camels_groupnorm_act", _ARGTYPES)
    err = fn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        b, h * w, c, num_groups, float(eps), ACTS[act],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "camels_groupnorm_act")
    fused_groupnorm_act.launches += 1
    return out


fused_groupnorm_act.launches = 0
