"""Isotropic 2-D power spectra of map batches (counterpart of
``camels_diffusion_model_tpu/ops/spectrum.py``).

* :func:`power_spectrum_batch`: linear bins of width ``2*pi/(n*dl)`` over an
  orthonormal FFT, bin ``rint(k/dk)``, out-of-range modes dropped (not
  clipped), empty bins 0, scaled by ``dl**2`` (``spectrum.py:37-99``).
* :func:`calculate_power_spectrum_2d_batch`: 20 log bins from
  ``2*pi/(N*dl)`` to ``pi/dl`` over an unnormalised fftshifted FFT with the
  k-grid in cycle units, empty bins dropped (``spectrum.py:107-161``).

Bin memberships depend only on the shape and ``dl``: numpy tables built once
per shape, applied on the maps' device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _linear_bin_info(shape: Tuple[int, int], dl: float):
    comps = [2 * np.pi * np.fft.fftfreq(d, dl) for d in shape]
    grids = np.meshgrid(*comps, indexing="ij")
    kgrid = np.sqrt(sum(g**2 for g in grids))
    dk = 2 * np.pi / (min(shape) * dl)
    n_bins = int(np.ceil(kgrid.max() / dk)) + 1
    bin_idx = np.rint(kgrid / dk).astype(np.int64).ravel()
    valid = bin_idx < n_bins
    bin_idx = np.where(valid, bin_idx, n_bins)  # overflow bucket n_bins
    count = np.bincount(bin_idx[valid], minlength=n_bins)[:n_bins]
    k_bins = np.arange(n_bins) * dk
    for a in (bin_idx, count, k_bins):
        a.setflags(write=False)
    return bin_idx, count, n_bins, k_bins


def power_spectrum_batch(maps: torch.Tensor, dl: float = 1.0):
    """Per-map linear-bin P(k): ``(B, H, W) -> (k_bins, (B, n_bins))``;
    ``k_bins`` is numpy, ``pk`` an fp32 tensor on the maps' device."""
    if maps.dim() != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(maps.shape)}")
    shape = (maps.shape[1], maps.shape[2])
    bin_idx, count, n_bins, k_bins = _linear_bin_info(shape, float(dl))
    ft = torch.fft.fftn(maps.float(), dim=(1, 2), norm="ortho")
    power = ft.abs().square().reshape(maps.shape[0], -1)
    idx = torch.tensor(bin_idx, device=maps.device)
    sums = torch.zeros(maps.shape[0], n_bins + 1, device=maps.device)
    sums.index_add_(1, idx, power)
    cnt = torch.tensor(count, device=maps.device)
    pk = torch.where(cnt > 0, sums[:, :n_bins] / cnt.clamp(min=1), 0.0)
    return k_bins, pk * dl**2


@functools.lru_cache(maxsize=32)
def _log_bin_info(shape: Tuple[int, int], dl: float):
    nx, ny = shape
    kx = np.fft.fftshift(np.fft.fftfreq(nx, dl))
    ky = np.fft.fftshift(np.fft.fftfreq(ny, dl))
    kx2, ky2 = np.meshgrid(kx, ky, indexing="ij")
    k_flat = np.sqrt(kx2**2 + ky2**2).ravel()
    k_bins = np.logspace(np.log10(2 * np.pi / (nx * dl)), np.log10(np.pi / dl), 20)
    rows, k_centers = [], []
    for i in range(len(k_bins) - 1):
        mask = (k_flat >= k_bins[i]) & (k_flat < k_bins[i + 1])
        n = mask.sum()
        if n > 0:
            rows.append(mask.astype(np.float32) / n)
            k_centers.append(k_flat[mask].mean())
    bin_matrix = (np.stack(rows) if rows else np.zeros((0, k_flat.size))).astype(np.float32)
    k_centers = np.asarray(k_centers)
    for a in (bin_matrix, k_centers):
        a.setflags(write=False)
    return bin_matrix, k_centers


def calculate_power_spectrum_2d_batch(maps: torch.Tensor, dl: float = 1.0):
    """Batched log-bin P(k): ``(B, H, W) -> (k_centers, (B, n_kept))``."""
    if maps.dim() != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(maps.shape)}")
    bin_matrix, k_centers = _log_bin_info((maps.shape[1], maps.shape[2]), float(dl))
    ft = torch.fft.fftshift(torch.fft.fft2(maps.float()), dim=(1, 2))
    power = ft.abs().square().reshape(maps.shape[0], -1)
    m = torch.tensor(bin_matrix, device=maps.device)
    return k_centers, power @ m.T
