"""The synthetic CAMELS parameter sets (counterpart of
``camels_diffusion_model_tpu/data/synthetic.py``).

The certification and the serving CLI draw their contexts from
``synthetic_camels``; its parameters are the generator's first draw, so
they are reproduced here without the maps.
"""

from __future__ import annotations

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
