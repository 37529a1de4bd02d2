"""FiLM modulation kernel K3: ``scale * x + shift`` over NHWC.

Wraps ``csrc/film.cu``, the counterpart of the Pallas ``fused_film``
(``camels_diffusion_model_tpu/ops/pallas/film.py:29``).  The decoder runs it
at FiLM stage 1 (``context_unet.py:304-307``), one launch per decoder call,
at ``(N, 32, 32, 128)`` in the canonical model, ``(N, 32, 32, 256)`` in the
deep one and ``(N, 32, 32, 512)`` in the big one; stage 0 is the epilogue
of the GroupNorm kernel (``ops/groupnorm.py``).  :func:`launch_plan` chooses
the kernel's geometry.

Two instances: float32 and bfloat16 (the bf16 model's FiLM stage 1), each
with its own launch count (``fused_film.launches`` and ``.launches_bf16``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

THREADS = 256  # a block, rounded down to whole pixels
MAX_THREADS = 1024  # the most a block may have
BLOCKS_PER_SM = 2048 // THREADS  # resident blocks of THREADS on one SM
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}  # the instances' types
C_NAMES = {torch.float32: "camels_film", torch.bfloat16: "camels_film_bf16"}

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


class Plan(NamedTuple):
    """The kernel's launch geometry for one input shape."""

    vec: int  # elements per access: 16 bytes (4 floats, 8 bf16) or 1
    threads: int  # per block: whole pixels of vec-wide accesses
    blocks_per_sample: int  # grid.x; grid.y is the sample


def launch_plan(n: int, hw: int, c: int, aligned: bool = True, sms: int = 132,
                element_bytes: int = 4) -> Plan:
    """Geometry of :func:`fused_film` for ``n`` samples of ``hw`` pixels of
    ``c`` channels of ``element_bytes`` each (4 fp32, 2 bf16) on a card of
    ``sms`` SMs.

    The 16-byte path needs ``c`` to be a multiple of one access's elements
    and ``aligned`` pointers; other shapes take the scalar path.  A block covers whole pixels, so each
    thread keeps its channels; the grid is at most one wave of resident
    blocks, split evenly over each sample's pixels.  Raises ``ValueError``
    for a pixel wider than ``MAX_THREADS`` accesses, and for shapes the
    kernel cannot index: a sample of ``2**31`` elements or more (its offsets
    are 32-bit) or more than 65535 samples (``grid.y``).
    """
    if n > 65535 or hw * c >= 2**31:
        raise ValueError(f"fused_film: {n} samples of {hw} x {c} elements are too large")
    wide = 16 // element_bytes
    vec = wide if aligned and c % wide == 0 else 1
    per_pixel = c // vec
    if not 0 < per_pixel <= MAX_THREADS:
        raise ValueError(f"fused_film: a pixel of {c} channels takes no path")
    threads = per_pixel * max(1, THREADS // per_pixel)
    steps = -(-hw // (threads // per_pixel))  # block-wide steps per sample
    wave = max(1, sms * BLOCKS_PER_SM // max(n, 1))  # blocks per sample
    per_block = max(1, -(-steps // wave))
    return Plan(vec, threads, max(1, -(-steps // per_block)))


def film_plain(x, scale, shift):
    """``scale * x + shift`` with ``(N or 1, C)`` rows broadcast over H, W,
    in the tensors' dtype: in bf16 the product rounds, then the sum, as the
    JAX program does (``context_unet.py:300-307``)."""
    return scale[:, None, None, :] * x + shift[:, None, None, :]


def check_rows(film, n: int, c: int) -> None:
    """``film = (scale, shift)`` must be rows ``(n, c)`` or ``(1, c)``."""
    for name, t in zip(("scale", "shift"), film):
        if t.dim() != 2 or t.shape[1] != c or t.shape[0] not in (1, n):
            raise ValueError(f"{name} must be ({n}, {c}) or (1, {c}), got {tuple(t.shape)}")


def fused_film(x, scale, shift):
    """FiLM of NHWC ``x`` by ``scale``/``shift`` rows, each ``(N, C)`` or
    ``(1, C)`` (broadcast over the batch), all float32 or all bfloat16.

    On CUDA tensors this launches the kernel of ``x``'s dtype, and raises
    for another dtype or where autograd would record the call
    (:func:`_build.refuse_autograd`); on CPU tensors it runs
    :func:`film_plain`.
    """
    if x.device.type == "cpu":
        return film_plain(x, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"fused_film: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if x.dtype not in ELEMENT_BYTES:
        raise ValueError(f"fused_film: no kernel for {x.dtype}; float32 or bfloat16")
    for name, t in (("x", x), ("scale", scale), ("shift", shift)):
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(
                f"fused_film: {name} must be a contiguous {_build.type_name(x.dtype)} "
                f"tensor on {x.device}"
            )
    check_rows((scale, shift), n, c)
    _build.refuse_autograd("fused_film", x, scale, shift)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, shift, out))
    plan = launch_plan(n, h * w, c, aligned,
                       torch.cuda.get_device_properties(x.device).multi_processor_count,
                       ELEMENT_BYTES[x.dtype])
    fn = _build.kernel(C_NAMES[x.dtype], _ARGTYPES)
    err = fn(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        n, h * w, c,
        c if scale.shape[0] > 1 else 0,
        c if shift.shape[0] > 1 else 0,
        plan.vec, plan.threads, plan.blocks_per_sample,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, C_NAMES[x.dtype])
    if x.dtype == torch.bfloat16:
        fused_film.launches_bf16 += 1
    else:
        fused_film.launches += 1
    return out


fused_film.launches = 0
fused_film.launches_bf16 = 0
