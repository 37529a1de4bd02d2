"""The CAMELS data pipeline on the host: normalise the maps and the
parameters, resize, split, batch (counterpart of
``camels_diffusion_model_tpu/data/pipeline.py``, its numpy path).

Map normalisations by name (``pipeline.py:62-84``): ``"code"`` (the
``code/`` trainers: shift positive, divide by the maximum, log10, min-max
to [0, 1]), ``"initial"`` (shift positive, log10, z-score, clip to [-1, 1])
and ``"big"`` (shift positive, log10, z-score, min-max to [-1, 1]), in
float64 as the reference's numpy.  The split is a numpy permutation of seed
42, as in the JAX package (the reference's ``torch.random_split`` order
cannot be reproduced).  Style ``"code"`` takes the multithreaded C++ path
(``data/native_prep.py``, the repository's ``native/camels_prep.cpp``)
whenever its library loads, and the numpy path otherwise, as the JAX
package does (``pipeline.py:160-173``): the two differ by an ulp on about
a third of the pixels, so both packages take the same one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..ops.resize import _interp_matrix
from . import native_prep


@dataclasses.dataclass
class CamelsDataset:
    """A split dataset: NHWC maps and their normalised parameters."""

    train_x: np.ndarray  # (N_train, H, W, 1) float32
    train_c: np.ndarray  # (N_train, num_params) float32
    test_x: np.ndarray
    test_c: np.ndarray
    param_min: np.ndarray  # (1, 6): the sidecars that undo the normalisation
    param_max: np.ndarray
    split_indices: np.ndarray  # the permutation of the split
    info: Dict[str, object]

    @property
    def n_train(self) -> int:
        return self.train_x.shape[0]

    @property
    def n_test(self) -> int:
        return self.test_x.shape[0]


def normalize_maps(raw: np.ndarray, style: str = "code") -> np.ndarray:
    """One of the reference's map normalisations (module docstring), in
    float64; the caller casts."""
    data = np.asarray(raw, np.float64)
    min_value = data.min()
    if min_value <= 0:
        data = data - min_value + 1e-8
    if style == "code":
        data = data / data.max()
        data = np.log10(data)
        data = (data - data.min()) / (data.max() - data.min())
    elif style == "initial":
        data = np.log10(data)
        data = (data - data.mean()) / data.std()
        data = np.clip(data, -1.0, 1.0)
    elif style == "big":
        data = np.log10(data)
        data = (data - data.mean()) / data.std()
        dmin, dmax = data.min(), data.max()
        data = 2 * (data - dmin) / (dmax - dmin) - 1
    else:
        raise ValueError(f"unknown normalization style {style!r}")
    return data


def resize_maps_np(maps: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize (torch ``align_corners=False``) of a ``(B, H, W)``
    stack on the host, with ``ops.resize``'s matrices."""
    maps = np.asarray(maps, np.float32)
    wh = _interp_matrix(maps.shape[1], size)
    ww = _interp_matrix(maps.shape[2], size)
    out = np.einsum("oh,bhw->bow", wh, maps)
    return np.einsum("pw,bow->bop", ww, out)


def normalize_params(
    param_data: np.ndarray,
    n_maps: int,
    num_params: int,
    expand: int = 15,
    param_index: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand each set ``expand`` times, min-max normalise, select columns
    (``pipeline.py:87-127``).

    ``param_index`` selects one column; otherwise the first ``num_params``
    columns are kept (zero-padded if fewer exist).  Returns (normalized
    ``(n_maps, num_params)`` float32, param_min, param_max), the min/max
    taken over the expanded, unselected data.
    """
    expanded = np.repeat(np.asarray(param_data, np.float64), expand, axis=0)
    if expanded.shape[0] != n_maps:
        raise ValueError("Parameter expansion doesn't match image count")
    pmin = expanded.min(axis=0, keepdims=True)
    pmax = expanded.max(axis=0, keepdims=True)
    normalized = (expanded - pmin) / (pmax - pmin + 1e-8)
    if param_index is not None:
        normalized = normalized[:, param_index : param_index + 1]
        if num_params != 1:
            raise ValueError("param_index implies num_params == 1")
    elif normalized.shape[1] > num_params:
        normalized = normalized[:, :num_params]
    elif normalized.shape[1] < num_params:
        pad = np.zeros((normalized.shape[0], num_params - normalized.shape[1]))
        normalized = np.concatenate([normalized, pad], axis=1)
    return normalized.astype(np.float32), pmin, pmax


def train_test_split(
    n_total: int, test_size: int, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic permutation split -> (train_idx, test_idx,
    permutation) (``pipeline.py:130-137``)."""
    perm = np.random.default_rng(seed).permutation(n_total)
    return perm[: n_total - test_size], perm[n_total - test_size :], perm


def load_camels_dataset(
    maps: np.ndarray,
    params: np.ndarray,
    num_params: int,
    height: int = 64,
    test_size: int = 1500,
    seed: int = 42,
    style: str = "code",
    expand: int = 15,
    param_index: Optional[int] = None,
) -> CamelsDataset:
    """Raw ``maps`` ``(N, H0, W0)`` and ``params`` ``(N / expand, 6)`` ->
    a split :class:`CamelsDataset` of ``height`` x ``height`` NHWC maps
    (``pipeline.py:140-199``)."""
    maps = np.asarray(maps)
    n_maps = maps.shape[0]
    cond, pmin, pmax = normalize_params(
        params, n_maps, num_params, expand=expand, param_index=param_index
    )
    use_native = style == "code" and native_prep.available()
    if use_native:
        data = native_prep.normalize_maps_native(maps)
    else:
        data = normalize_maps(maps, style=style).astype(np.float32)
    if data.shape[1] != height or data.shape[2] != height:
        resize = native_prep.resize_maps_native if use_native else resize_maps_np
        data = resize(data, height)
    data = data[..., None]
    train_idx, test_idx, perm = train_test_split(n_maps, test_size, seed)
    info = {
        "total": n_maps,
        "train": len(train_idx),
        "test": len(test_idx),
        "num_params": num_params,
        "original_param_shape": tuple(np.asarray(params).shape),
        "expanded_param_shape": (n_maps, np.asarray(params).shape[1]),
        "final_param_shape": tuple(cond.shape),
        "style": style,
        "height": height,
        "seed": seed,
    }
    return CamelsDataset(
        train_x=data[train_idx], train_c=cond[train_idx],
        test_x=data[test_idx], test_c=cond[test_idx],
        param_min=pmin, param_max=pmax, split_indices=perm, info=info,
    )


def batch_iterator(
    x: np.ndarray,
    c: np.ndarray,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    drop_last: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of ``(x, c)`` batches of host arrays, shuffled by ``rng``
    or in order (``pipeline.py:202-220``)."""
    idx = np.arange(x.shape[0])
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    end = (x.shape[0] // batch_size) * batch_size if drop_last else x.shape[0]
    for start in range(0, end, batch_size):
        sel = idx[start : start + batch_size]
        yield x[sel], c[sel]


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    """Batches of one epoch of ``n`` rows (``pipeline.py:223``)."""
    return n // batch_size if drop_last else -(-n // batch_size)
