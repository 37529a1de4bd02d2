"""Spectral calibration of reduced-step sampler output (counterpart of
``camels_diffusion_model_tpu/diffusion/calibration.py``).

A fixed radial Fourier filter ``g(|k|) = r_fit(|k|)^(-1/2)`` (DC passes
through) fitted offline against the exact chain; serving applies it to each
map with one fp32 ``rfft2``/``irfft2`` pair (``calibration.py:199-251``).
The filter table is numpy float64 cast to fp32, as in the JAX package.
:meth:`SpectralCalibration.save` and :func:`fit_spectral_transfer` are
numpy copies of the JAX package's (``calibration.py:95-120, 153-196``), so
a calibration refit on the port's maps is written in the same file format
that both packages load.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SpectralCalibration:
    """Smooth multiplicative P(k) correction, P_corrected = P / r_fit(k),
    with an optional binwise factor per linear P(k) bin."""

    coeffs: Tuple[float, ...]
    k_min: float
    k_max: float
    dl: float = 1.0
    clip: Tuple[float, float] = (0.7, 1.4)
    bin_ratios: Optional[Tuple[float, ...]] = None

    def ratio(self, k):
        """Polynomial power ratio r(k), clamped to the fit range and clip."""
        k = np.clip(np.asarray(k, np.float64), self.k_min, self.k_max)
        r = np.polyval(np.asarray(self.coeffs, np.float64), k)
        return np.clip(r, self.clip[0], self.clip[1])

    def bin_ratio(self, k, n: int):
        """Binwise ratio at |k| for an n-pixel map (1 without a table)."""
        k = np.asarray(k, np.float64)
        if self.bin_ratios is None:
            return np.ones_like(k)
        dk = 2 * np.pi / (n * self.dl)
        idx = np.rint(k / dk).astype(np.int64)
        table = np.asarray(self.bin_ratios, np.float64)
        safe = np.minimum(idx, len(table) - 1)
        return np.where(idx < len(table), table[safe], 1.0)

    def total_ratio(self, k, n: int):
        """Full fitted power ratio: polynomial x binwise."""
        return self.ratio(k) * self.bin_ratio(k, n)

    def save(self, path: str, meta: Optional[dict] = None) -> None:
        """Write the filter as an npz, with ``meta`` entries as
        ``meta_<key>`` arrays (provenance, e.g. ``checkpoint_fingerprint``,
        read by :func:`load_calibration_meta`) and ``bin_ratios`` when the
        filter has a binwise table (``calibration.py:95-120``)."""
        extra = {f"meta_{key}": np.asarray(val) for key, val in (meta or {}).items()}
        if self.bin_ratios is not None:
            extra["bin_ratios"] = np.asarray(self.bin_ratios, np.float64)
        np.savez(path, coeffs=np.asarray(self.coeffs, np.float64), k_min=self.k_min,
                 k_max=self.k_max, dl=self.dl, clip=np.asarray(self.clip, np.float64),
                 **extra)

    @staticmethod
    def load(path: str) -> "SpectralCalibration":
        z = np.load(path)
        bin_ratios = None
        if "bin_ratios" in z.files:
            bin_ratios = tuple(float(v) for v in z["bin_ratios"])
        return SpectralCalibration(
            coeffs=tuple(float(c) for c in z["coeffs"]),
            k_min=float(z["k_min"]),
            k_max=float(z["k_max"]),
            dl=float(z["dl"]),
            clip=(float(z["clip"][0]), float(z["clip"][1])),
            bin_ratios=bin_ratios,
        )


def load_calibration_meta(path: str) -> dict:
    """Provenance stamped into a calibration npz (``meta_<key>`` arrays),
    e.g. ``checkpoint_fingerprint``; ``{}`` for unstamped files."""
    z = np.load(path)
    out = {}
    for name in z.files:
        if name.startswith("meta_"):
            v = z[name]
            out[name[len("meta_"):]] = v.item() if v.ndim == 0 else v.tolist()
    return out


def fit_spectral_transfer(k_bins, pk_fast, pk_ref, *, deg: int = 6, counts=None,
                          dl: float = 1.0,
                          clip: Tuple[float, float] = (0.7, 1.4)) -> SpectralCalibration:
    """A polynomial of degree ``deg`` (at most the populated bins less one)
    fitted to the per-bin power ratio ``pk_fast / pk_ref`` over the
    populated non-DC bins, weighted by ``sqrt(counts)`` when the modes per
    bin are given (``calibration.py:153-196``); raises ``ValueError`` when
    no bin is usable."""
    k_bins = np.asarray(k_bins, np.float64)
    pk_fast = np.asarray(pk_fast, np.float64)
    pk_ref = np.asarray(pk_ref, np.float64)
    good = (k_bins > 0) & np.isfinite(pk_ref) & (pk_ref > 0)
    good &= np.isfinite(pk_fast) & (pk_fast > 0)
    k = k_bins[good]
    if k.size == 0:
        raise ValueError(
            "fit_spectral_transfer: no valid (positive, finite) bins in the "
            "calibration input — check the sweep spectra"
        )
    r = pk_fast[good] / pk_ref[good]
    w = np.sqrt(np.asarray(counts, np.float64)[good]) if counts is not None else None
    coeffs = np.polyfit(k, r, min(deg, len(k) - 1), w=w)
    return SpectralCalibration(coeffs=tuple(float(c) for c in coeffs), k_min=float(k.min()),
                               k_max=float(k.max()), dl=dl, clip=clip)


@functools.lru_cache(maxsize=16)
def _amplitude_filter(calib: SpectralCalibration, shape: Tuple[int, int]) -> np.ndarray:
    """``(H, W//2+1)`` rfft2-layout fp32 filter ``r(|k|)^(-1/2)``, DC = 1."""
    h, w = shape
    if calib.bin_ratios is not None and h != w:
        raise ValueError(
            "binwise calibration tables are tied to the square-map linear "
            f"binning; got shape {shape}"
        )
    ky = 2 * np.pi * np.fft.fftfreq(h, calib.dl)
    kx = 2 * np.pi * np.fft.rfftfreq(w, calib.dl)
    kgrid = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    g = 1.0 / np.sqrt(calib.total_ratio(kgrid, h))
    g[0, 0] = 1.0
    g = g.astype(np.float32)
    g.setflags(write=False)
    return g


def apply_spectral_calibration(x: torch.Tensor, calib: SpectralCalibration):
    """Filter maps ``(H, W)``, ``(B, H, W)`` or NHWC ``(B, H, W, C)``; same
    shape, dtype and device out."""
    if x.dim() == 4:
        dims = (1, 2)
    elif x.dim() in (2, 3):
        dims = (-2, -1)
    else:
        raise ValueError(f"expected 2-4 dims, got shape {tuple(x.shape)}")
    hw = (x.shape[dims[0]], x.shape[dims[1]])
    g = torch.tensor(_amplitude_filter(calib, hw), device=x.device)
    if x.dim() == 4:
        g = g[None, :, :, None]
    xf = torch.fft.rfft2(x.float(), dim=dims)
    out = torch.fft.irfft2(xf * g, s=hw, dim=dims)
    return out.to(x.dtype)
