"""Parameter normalisation, the train/test split and the batch iterator
(counterpart of ``camels_diffusion_model_tpu/data/pipeline.py``, numpy)."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


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
