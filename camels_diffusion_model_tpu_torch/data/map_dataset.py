"""A map dataset with the log1p / [-1, 1] normalisation and its sanity
checks (counterpart of ``camels_diffusion_model_tpu/data/map_dataset.py``),
numpy on the host.

The reference's ``CustomDataset`` (``diffusion_utilities.py:220-296``)
loads a ``.npy`` stack, takes the global statistics once, and maps each
item by ``log1p(x + 1e-6)`` and the global min-max to [-1, 1], as NHWC
float32; :func:`verify_dataset` is its shape / NaN / Inf check.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class MapDataset:
    """Indexable dataset over a ``(N, H, W)`` or ``(N, H, W, 1)`` map stack
    (an array, or the path of a ``.npy``); items are ``(H, W, 1)``
    float32."""

    def __init__(self, source, transform=None):
        maps = np.load(source) if isinstance(source, str) else np.asarray(source)
        self.global_min = float(np.min(maps))
        self.global_max = float(np.max(maps))
        log_maps = np.log1p(maps + 1e-6)
        self.log_global_min = float(np.min(log_maps))
        self.log_global_max = float(np.max(log_maps))
        if maps.ndim == 3:
            maps = maps[..., np.newaxis]
        self.maps = maps
        self.maps_shape = maps.shape
        self.transform = transform

    def __len__(self) -> int:
        return len(self.maps)

    def __getitem__(self, idx: int) -> np.ndarray:
        image = np.log1p(self.maps[idx].astype(np.float32) + 1e-6)
        image = (2.0 * (image - self.log_global_min)
                 / (self.log_global_max - self.log_global_min) - 1.0)
        if self.transform is not None:
            image = self.transform(image)
        return image.astype(np.float32)

    def getshapes(self) -> Tuple[int, ...]:
        return self.maps_shape


def verify_dataset(dataset: MapDataset, num_samples: int = 5) -> list:
    """Print the first item's shape and range and check the first
    ``num_samples`` items' shape, NaNs and Infs (``map_dataset.py:52-73``);
    returns the warnings (empty when clean)."""
    warnings = []
    sample = dataset[0]
    print("\nDataset Verification:")
    print(f"Single sample shape: {sample.shape}")
    print(f"Sample min: {sample.min():.4f}")
    print(f"Sample max: {sample.max():.4f}")
    for i in range(min(num_samples, len(dataset))):
        s = dataset[i]
        if not (s.ndim == 3 and s.shape[-1] == 1):
            warnings.append(f"Sample {i} has incorrect shape: {s.shape}")
        if np.isnan(s).any():
            warnings.append(f"Sample {i} contains NaN values")
        if np.isinf(s).any():
            warnings.append(f"Sample {i} contains infinite values")
    for w in warnings:
        print(f"Warning: {w}")
    return warnings
