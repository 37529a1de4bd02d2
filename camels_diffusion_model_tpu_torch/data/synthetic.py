"""Synthetic CAMELS-like maps and parameters (counterpart of
``camels_diffusion_model_tpu/data/synthetic.py``).

The real maps (15000 x 256 x 256) and parameters (1000 x 6) are not in the
repository, so the experiment runner falls back to lognormal Gaussian
random fields whose power-spectrum slope and amplitude follow the first two
parameters.  Pure numpy, so a seed gives the JAX package's arrays bit for
bit.  The certification and the serving CLI draw their contexts from the
parameters, the generator's first draw (:func:`synthetic_params`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# CAMELS LH parameter ranges: Omega_m, sigma_8, A_SN1, A_AGN1, A_SN2, A_AGN2
# (``synthetic.py:18-29``).
PARAM_RANGES = np.array(
    [
        [0.1, 0.5],
        [0.6, 1.0],
        [0.25, 4.0],
        [0.25, 4.0],
        [0.5, 2.0],
        [0.25, 4.0],
    ]
)


def synthetic_params(n_param_sets: int = 16, seed: int = 0) -> np.ndarray:
    """``(n_param_sets, 6)`` float64: the ``params`` that
    ``synthetic_camels(n_param_sets, ..., seed=seed)`` returns, whatever its
    map count and size (``synthetic.py:43-46``, the generator's first draw)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(PARAM_RANGES[:, 0], PARAM_RANGES[:, 1], size=(n_param_sets, 6))


def synthetic_camels(n_param_sets: int = 16, maps_per_set: int = 15,
                     size: int = 256, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``(maps (n_param_sets * maps_per_set, size, size) float32, params
    (n_param_sets, 6))``; positive, heavy-tailed maps, so the log10
    normalisations apply (``synthetic.py:32-66``)."""
    rng = np.random.default_rng(seed)
    params = rng.uniform(PARAM_RANGES[:, 0], PARAM_RANGES[:, 1], size=(n_param_sets, 6))
    kx = np.fft.fftfreq(size)[:, None]
    ky = np.fft.fftfreq(size)[None, :]
    k = np.sqrt(kx**2 + ky**2)
    k[0, 0] = 1.0  # no division by zero; the DC term is set to 0 below
    maps = np.empty((n_param_sets * maps_per_set, size, size), np.float32)
    for i, p in enumerate(params):
        slope = 1.5 + 2.0 * (p[0] - 0.1) / 0.4  # from Omega_m
        amp = 0.5 + 2.0 * (p[1] - 0.6) / 0.4  # from sigma_8
        pk = amp * k ** (-slope)
        pk[0, 0] = 0.0
        for j in range(maps_per_set):
            white = rng.normal(size=(size, size))
            field = np.fft.ifft2(np.fft.fft2(white) * np.sqrt(pk)).real
            field = field / (field.std() + 1e-12)
            maps[i * maps_per_set + j] = np.exp(1.5 * field).astype(np.float32)
    return maps, params
