"""Per-image normalisation helpers (counterpart of
``camels_diffusion_model_tpu/utils/image_norm.py``), numpy on the host.

The reference's display helpers (``diffusion_utilities.py:147-185``):
:func:`unorm` (one ``(H, W, C)`` image to [0, 1]), :func:`norm_all` (every
frame of a ``(T, S, H, W, C)`` trajectory store), :func:`norm_batch` (an
NHWC batch, image by image) and :func:`gen_tst_context` (the 5-class
one-hot test contexts the reference kept from its sprites course; no
CAMELS flow uses them).
"""

from __future__ import annotations

import numpy as np


def unorm(x: np.ndarray) -> np.ndarray:
    """Min-max of one ``(H, W, C)`` image to [0, 1], per channel."""
    xmax = x.max((0, 1))
    xmin = x.min((0, 1))
    return (x - xmin) / (xmax - xmin)


def norm_all(store: np.ndarray, n_t: int, n_s: int) -> np.ndarray:
    """:func:`unorm` of every (timestep, sample) frame of ``store``."""
    nstore = np.zeros_like(store)
    for t in range(n_t):
        for s in range(n_s):
            nstore[t, s] = unorm(store[t, s])
    return nstore


def norm_batch(x_all: np.ndarray) -> np.ndarray:
    """Per-image min-max of an NHWC batch to [0, 1]."""
    x = np.asarray(x_all)
    xmax = x.max((1, 2), keepdims=True)
    xmin = x.min((1, 2), keepdims=True)
    return (x - xmin) / (xmax - xmin)


def gen_tst_context(n_cfeat: int = 5):
    """``(36, (36, 5))``: six copies of the five one-hot rows and a zero
    row, float32 (``n_cfeat`` is unused, as in the reference)."""
    block = np.concatenate([np.eye(5, dtype=np.float32), np.zeros((1, 5), np.float32)])
    vec = np.tile(block, (6, 1))
    return len(vec), vec
