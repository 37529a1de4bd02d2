"""Isotropic power spectra of maps and boxes (counterpart of
``camels_diffusion_model_tpu/ops/spectrum.py``).

* :func:`power_spectrum` (one 2-D or 3-D box) and
  :func:`power_spectrum_batch`: linear bins of width ``2*pi/(n*dl)`` over
  an orthonormal FFT, bin ``rint(k/dk)``, out-of-range modes dropped (not
  clipped), empty bins 0, scaled by ``dl**ndims`` (``spectrum.py:37-99``).
* :func:`calculate_power_spectrum_2d` (one image) and
  :func:`calculate_power_spectrum_2d_batch`: 20 log bins from
  ``2*pi/(N*dl)`` to ``pi/dl`` over an unnormalised fftshifted FFT with the
  k-grid in cycle units, empty bins dropped (``spectrum.py:107-161``).
* :func:`compare_power_spectra_stats` and :func:`compare_power_spectra`:
  mean and std of two batches' linear-bin spectra, and their plot
  (``spectrum.py:164-212``).

Bin memberships depend only on the shape and ``dl``: numpy tables built once
per shape, applied on the maps' device.
"""

from __future__ import annotations

import functools
import os
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


def _linear_pk(boxes: torch.Tensor, dl: float):
    """Linear-bin P(k) of each box of the batch ``(B, *shape)``."""
    shape = tuple(boxes.shape[1:])
    bin_idx, count, n_bins, k_bins = _linear_bin_info(shape, float(dl))
    dims = tuple(range(1, boxes.dim()))
    ft = torch.fft.fftn(boxes.float(), dim=dims, norm="ortho")
    power = ft.abs().square().reshape(boxes.shape[0], -1)
    idx = torch.tensor(bin_idx, device=boxes.device)
    sums = torch.zeros(boxes.shape[0], n_bins + 1, device=boxes.device)
    sums.index_add_(1, idx, power)
    cnt = torch.tensor(count, device=boxes.device)
    pk = torch.where(cnt > 0, sums[:, :n_bins] / cnt.clamp(min=1), 0.0)
    return k_bins, pk * dl ** len(shape)


def power_spectrum(box, dl: float = 1.0):
    """Linear-bin P(k) of one 2-D or 3-D box: ``(k_bins, (n_bins,))``,
    ``k_bins`` numpy, ``pk`` an fp32 tensor on the box's device."""
    box = torch.as_tensor(box)
    if box.dim() not in (2, 3):
        raise ValueError("Input box must be 2D or 3D")
    k_bins, pk = _linear_pk(box[None], dl)
    return k_bins, pk[0]


def power_spectrum_batch(maps: torch.Tensor, dl: float = 1.0):
    """Per-map linear-bin P(k): ``(B, H, W) -> (k_bins, (B, n_bins))``;
    ``k_bins`` is numpy, ``pk`` an fp32 tensor on the maps' device."""
    if maps.dim() != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(maps.shape)}")
    return _linear_pk(maps, dl)


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


def calculate_power_spectrum_2d(image, dl: float = 1.0):
    """Log-bin P(k) of one ``(H, W)`` image: ``(k_centers, (n_kept,))``."""
    image = torch.as_tensor(image)
    if image.dim() != 2:
        raise ValueError(f"expected (H, W), got {tuple(image.shape)}")
    k_centers, pk = calculate_power_spectrum_2d_batch(image[None], dl)
    return k_centers, pk[0]


def _bhw(maps) -> torch.Tensor:
    maps = torch.as_tensor(maps)
    return maps[..., 0] if maps.dim() == 4 else maps


def compare_power_spectra_stats(original_maps, generated_maps, dl: float = 1.0):
    """``(k, orig_mean, orig_std, gen_mean, gen_std)`` as numpy arrays: the
    mean and (population) std over each batch ``(B, H, W)`` of its
    per-map linear-bin spectra."""
    k, orig_pk = power_spectrum_batch(torch.as_tensor(original_maps), dl)
    _, gen_pk = power_spectrum_batch(torch.as_tensor(generated_maps), dl)
    orig_pk = orig_pk.cpu().numpy()
    gen_pk = gen_pk.cpu().numpy()
    return (k, orig_pk.mean(axis=0), orig_pk.std(axis=0),
            gen_pk.mean(axis=0), gen_pk.std(axis=0))


def compare_power_spectra(original_images, generated_images, output_dir: str,
                          dl: float = 1.0, title: str = "Power Spectrum Comparison"):
    """:func:`compare_power_spectra_stats` of two ``(B, H, W)`` or NHWC
    batches, plotted log-log with one-std bands (the first bin left out) to
    ``output_dir/power_spectrum_comparison.png``; returns ``(k,
    orig_pk_mean, gen_pk_mean)``.  Needs matplotlib, imported here only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k, om, os_, gm, gs = compare_power_spectra_stats(
        _bhw(original_images), _bhw(generated_images), dl)
    plt.figure(figsize=(10, 6))
    for mean, std, style, label in ((om, os_, "b", "Original"),
                                    (gm, gs, "r", "Diffusion Model")):
        plt.loglog(k[1:], mean[1:], f"{style}-", label=label)
        plt.fill_between(k[1:], mean[1:] - std[1:], mean[1:] + std[1:],
                         alpha=0.3, color=style)
    plt.xlabel("k")
    plt.ylabel("P(k)")
    plt.title(title)
    plt.legend()
    plt.grid(True, which="both", ls="-", alpha=0.2)
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "power_spectrum_comparison.png"), dpi=150)
    plt.close()
    return k, om, gm
