"""Pixel-PDF statistics (counterpart of ``camels_diffusion_model_tpu/ops/
stats.py``) and the certification's pooled PDF battery.

* :func:`pixel_pdf` and :func:`compare_pdf_stats`: per-image density
  histograms over a bin grid of width 0.01 spanning the joint min/max of
  both image sets, then the mean and std PDF of each set (``stats.py:17-
  49``).
* :class:`PooledPdf` and :func:`pdf_tv`: the battery of ``scripts/
  certify_fast_sampler.py:274-285,341-352``.  A fixed grid
  (:data:`PDF_BINS`) lets chunks of maps accumulate one histogram; the
  pooled density is ``hist / (n_pix * delta)``, and two densities are
  compared by their total-variation distance.

Host-side numpy, for exact ``np.histogram`` semantics: maps on the card are
copied to the host first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PDF_DELTA = 0.01
PDF_BINS = np.arange(-3.0, 3.0 + PDF_DELTA / 2, PDF_DELTA)


def _host(images) -> np.ndarray:
    if torch.is_tensor(images):
        return images.detach().cpu().numpy()
    return np.asarray(images)


def pixel_pdf(images, bins: np.ndarray) -> np.ndarray:
    """Per-image density histograms -> ``(n_images, n_bins - 1)``."""
    images = _host(images)
    return np.stack(
        [np.histogram(img.ravel(), bins, density=True)[0] for img in images]
    )


def compare_pdf_stats(
    camels_images, diffusion_images, bin_delta: float = 0.01
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(bin_mid, orig_mean, orig_std, gen_mean, gen_std)`` over the grid
    ``arange(joint_min, joint_max + delta, delta)``."""
    camels_images = _host(camels_images)
    diffusion_images = _host(diffusion_images)
    bin_max = max(camels_images.max(), diffusion_images.max())
    bin_min = min(camels_images.min(), diffusion_images.min())
    bins = np.arange(bin_min, bin_max + bin_delta, bin_delta)
    train_pdf = pixel_pdf(camels_images, bins)
    test_pdf = pixel_pdf(diffusion_images, bins)
    bin_mid = (bins[:-1] + bins[1:]) / 2.0
    return (
        bin_mid,
        train_pdf.mean(axis=0),
        train_pdf.std(axis=0),
        test_pdf.mean(axis=0),
        test_pdf.std(axis=0),
    )


class PooledPdf:
    """A pixel histogram on :data:`PDF_BINS` pooled over chunks of maps.

    With equal pixel counts per map the pooled density equals the mean of
    per-map densities; pixels outside [-3, 3] count in ``n_pix`` and in no
    bin, as in the certification."""

    def __init__(self):
        self.hist = np.zeros(PDF_BINS.size - 1, np.int64)
        self.n_pix = 0

    def add(self, maps) -> "PooledPdf":
        maps = _host(maps).astype(np.float32, copy=False)
        self.hist += np.histogram(maps, PDF_BINS)[0]
        self.n_pix += maps.size
        return self

    @property
    def pdf(self) -> np.ndarray:
        return self.hist / (self.n_pix * PDF_DELTA)


def pdf_tv(p, q) -> float:
    """Total-variation distance ``0.5 * sum|p - q| * delta`` of two
    densities on :data:`PDF_BINS`."""
    return float(0.5 * np.abs(np.asarray(p) - np.asarray(q)).sum() * PDF_DELTA)
