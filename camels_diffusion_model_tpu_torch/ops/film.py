"""FiLM modulation kernel K3: ``scale * x + shift`` over NHWC.

Wraps ``csrc/film.cu``, the counterpart of the Pallas ``fused_film``
(``camels_diffusion_model_tpu/ops/pallas/film.py:29``).  The decoder runs it
at FiLM stage 0 ``(N, 16, 16, 256)`` and stage 1 ``(N, 32, 32, 128)``
(``context_unet.py:304-307``): two launches per decoder call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


def film_plain(x, scale, shift):
    """``scale * x + shift`` with ``(N or 1, C)`` rows broadcast over H, W."""
    return scale[:, None, None, :] * x + shift[:, None, None, :]


def fused_film(x, scale, shift):
    """FiLM of NHWC ``x`` by ``scale``/``shift`` rows, each ``(N, C)`` or
    ``(1, C)`` (broadcast over the batch).

    On CUDA tensors this launches the kernel; on CPU tensors it runs
    :func:`film_plain`.
    """
    if x.device.type == "cpu":
        return film_plain(x, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"fused_film: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if n > 65535 or h * w * c >= 2**31:
        raise ValueError(f"fused_film: shape {tuple(x.shape)} is too large")
    for name, t in (("x", x), ("scale", scale), ("shift", shift)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"fused_film: {name} must be a contiguous float32 tensor on "
                f"{x.device}"
            )
        if name != "x" and (t.dim() != 2 or t.shape[1] != c or t.shape[0] not in (1, n)):
            raise ValueError(f"{name} must be ({n}, {c}) or (1, {c}), got {tuple(t.shape)}")
    out = torch.empty_like(x)
    fn = _build.kernel("camels_film", _ARGTYPES)
    err = fn(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        n, h * w, c,
        c if scale.shape[0] > 1 else 0,
        c if shift.shape[0] > 1 else 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "camels_film")
    fused_film.launches += 1
    return out


fused_film.launches = 0
