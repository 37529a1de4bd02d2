"""PyTorch port: the certification's contexts and the serving CLI's default
context against the JAX package, on the same seeds."""

import random

import numpy as np
import pytest

from camels_diffusion_model_tpu.data.pipeline import (
    load_camels_dataset as jax_load_camels_dataset,
    normalize_params as jax_normalize_params,
    train_test_split as jax_train_test_split,
)
from camels_diffusion_model_tpu.data.synthetic import (
    PARAM_RANGES as JAX_PARAM_RANGES,
    synthetic_camels as jax_synthetic_camels,
)
from camels_diffusion_model_tpu_torch.cli.serve import default_params, serving_params
from camels_diffusion_model_tpu_torch.data.pipeline import normalize_params, train_test_split
from camels_diffusion_model_tpu_torch.data.synthetic import PARAM_RANGES, synthetic_params
from camels_diffusion_model_tpu_torch.serving import certification_contexts


@pytest.mark.parametrize("n_sets,seed", [(8, 0), (20, 42), (1000, 42)])
def test_synthetic_params_equal_jax(n_sets, seed):
    """The first draw of ``synthetic_camels``, whatever its map count and
    size (tiny maps here): bitwise equal."""
    np.testing.assert_array_equal(PARAM_RANGES, JAX_PARAM_RANGES)
    _, want = jax_synthetic_camels(n_param_sets=n_sets, maps_per_set=1, size=4, seed=seed)
    got = synthetic_params(n_sets, seed=seed)
    assert got.dtype == want.dtype and got.shape == (n_sets, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [{}, {"num_params": 4}, {"num_params": 8},
                                    {"num_params": 1, "param_index": 2}, {"expand": 3}])
def test_normalize_params_equals_jax(kwargs):
    raw = np.random.RandomState(0).uniform(0.1, 4.0, size=(12, 6))
    expand = kwargs.get("expand", 15)
    args = {"num_params": 6, **kwargs}
    got = normalize_params(raw, 12 * expand, **args)
    want = jax_normalize_params(raw, 12 * expand, **args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="expansion"):
        normalize_params(raw, 12 * expand + 1, 6, expand=expand)


@pytest.mark.parametrize("n_total,test_size,seed", [(300, 30, 42), (15000, 1500, 42), (45, 15, 3)])
def test_train_test_split_equals_jax(n_total, test_size, seed):
    for g, w in zip(train_test_split(n_total, test_size, seed),
                    jax_train_test_split(n_total, test_size, seed)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [30, 45, 7])
def test_certification_contexts_are_the_jax_datasets_test_split(n):
    """``param_sets=20`` on small maps: the contexts equal
    ``load_camels_dataset(...).test_c`` of the certification's recipe
    (``scripts/certify_fast_sampler.py:154-160``), tiled to ``n`` as
    ``:253-255`` tiles them."""
    maps, params = jax_synthetic_camels(n_param_sets=20, maps_per_set=15, size=16, seed=42)
    ds = jax_load_camels_dataset(maps, params, num_params=6, height=16,
                                 test_size=max(20 * 15 // 10, 15), seed=42)
    want = np.tile(ds.test_c, (n // ds.test_c.shape[0] + 1, 1))[:n]
    got = certification_contexts(n, param_sets=20)
    assert got.dtype == np.float32 and got.shape == (n, 6)
    np.testing.assert_array_equal(got, want)


def test_certification_contexts_at_the_references_param_sets():
    """``param_sets=1000`` (``scripts/run_n16k_confirmation.sh:47``): the
    JAX package's params of ``synthetic_camels(1000, ..., seed=42)``
    (maps_per_set=1, size=8: the params are the first draw) through its
    ``normalize_params`` and ``train_test_split``: the 1500 test contexts,
    in order, then tiled."""
    _, raw = jax_synthetic_camels(n_param_sets=1000, maps_per_set=1, size=8, seed=42)
    cond, _, _ = jax_normalize_params(raw, 15000, 6)
    _, test_idx, _ = jax_train_test_split(15000, 1500, seed=42)
    got = certification_contexts(3016)
    np.testing.assert_array_equal(got[:1500], cond[test_idx])
    np.testing.assert_array_equal(got[1500:3000], cond[test_idx])
    np.testing.assert_array_equal(got[3000:], cond[test_idx][:16])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_default_params_are_the_jax_serving_clis(seed):
    """``camels_diffusion_model_tpu/cli/sample.py:101-116`` with the data
    files absent: the synthetic stand-in's 8 sets (size 128 there; the
    params do not depend on it), min-max over those 8, and the set
    ``random.Random(seed).randint(0, 7)``."""
    _, raw = jax_synthetic_camels(n_param_sets=8, maps_per_set=1, size=8, seed=seed or 0)
    norm = (raw - raw.min(axis=0)) / (raw.max(axis=0) - raw.min(axis=0) + 1e-8)
    want = norm[random.Random(seed).randint(0, len(norm) - 1)].astype(np.float32)
    got = default_params(seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_serving_params_tile_pass_through_and_refuse():
    one = np.linspace(0, 1, 6, dtype=np.float32)
    np.testing.assert_array_equal(serving_params(one, 3), np.tile(one, (3, 1)))
    many = np.random.RandomState(0).rand(3, 6).astype(np.float32)
    np.testing.assert_array_equal(serving_params(many, 3), many)
    np.testing.assert_array_equal(serving_params(None, 2, seed=5),
                                  np.tile(default_params(5), (2, 1)))
    np.testing.assert_array_equal(serving_params(None, 2, n_cfeat=3),
                                  np.tile(default_params(0)[:3], (2, 1)))
    with pytest.raises(ValueError, match="params must be"):
        serving_params(many, 4)
