"""Bilinear resize with torch ``F.interpolate(mode="bilinear",
align_corners=False)`` semantics, as two matmuls with static interpolation
matrices (counterpart of ``camels_diffusion_model_tpu/ops/resize.py``; the
reference downsamples the 256x256 CAMELS maps to 64x64 this way,
``train_diffusion_paper.py:262``).  ``data.pipeline.resize_maps_np`` uses
the same matrices on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``(out_size, in_size)`` bilinear weights, torch align_corners=False
    (``resize.py:26-40``).  Cached: callers must not write to it."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    lo = np.clip(i0, 0, in_size - 1)
    hi = np.clip(i0 + 1, 0, in_size - 1)
    w = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w


def bilinear_resize(x, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the trailing two axes of ``x`` (any ``(..., H, W)``) to
    ``(out_h, out_w)`` with ``F.interpolate(mode="bilinear",
    align_corners=False)`` semantics, on its device, in fp32
    (``resize.py:58-63``)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    wh = torch.from_numpy(_interp_matrix(x.shape[-2], int(out_h))).to(x.device)
    ww = torch.from_numpy(_interp_matrix(x.shape[-1], int(out_w))).to(x.device)
    return torch.einsum("pw,...ow->...op", ww, torch.einsum("oh,...hw->...ow", wh, x))


def resize_maps(maps: torch.Tensor, size: int) -> torch.Tensor:
    """Resize the trailing two axes of ``maps`` (``(B, H, W)`` or any
    ``(..., H, W)``) to ``(size, size)``: :func:`bilinear_resize`."""
    return bilinear_resize(maps, size, size)
