"""PyTorch port: the data pipeline against the JAX package on the CPU --
synthetic maps, map normalisations, resize, the dataset split, the
weights-file cadence -- and the card-side prefetch's order, count and
errors."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from camels_diffusion_model_tpu.data import native_prep
from camels_diffusion_model_tpu.data import pipeline as jax_pipeline
from camels_diffusion_model_tpu.data.synthetic import synthetic_camels as jax_synthetic_camels
from camels_diffusion_model_tpu.ops.resize import resize_maps as jax_resize_maps
from camels_diffusion_model_tpu.training.checkpoints import (
    weights_checkpoint_plan as jax_weights_checkpoint_plan,
)
from camels_diffusion_model_tpu_torch.data import pipeline
from camels_diffusion_model_tpu_torch.data.prefetch import device_prefetch
from camels_diffusion_model_tpu_torch.data.synthetic import synthetic_camels, synthetic_params
from camels_diffusion_model_tpu_torch.ops.resize import resize_maps
from camels_diffusion_model_tpu_torch.training.checkpoints import weights_checkpoint_plan


@pytest.fixture(scope="module")
def raw():
    return synthetic_camels(n_param_sets=4, maps_per_set=15, size=32, seed=3)


def test_synthetic_camels_is_bit_equal_to_jax(raw):
    maps, params = raw
    want_maps, want_params = jax_synthetic_camels(n_param_sets=4, maps_per_set=15,
                                                  size=32, seed=3)
    assert maps.dtype == want_maps.dtype and maps.shape == (60, 32, 32)
    np.testing.assert_array_equal(maps, want_maps)
    np.testing.assert_array_equal(params, want_params)
    np.testing.assert_array_equal(synthetic_params(4, seed=3), params)


@pytest.mark.parametrize("style", ["code", "initial", "big"])
def test_normalize_maps_matches_jax(raw, style):
    got = pipeline.normalize_maps(raw[0], style)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, jax_pipeline.normalize_maps(raw[0], style),
                               rtol=0, atol=1e-6)


def test_normalize_maps_rejects_an_unknown_style(raw):
    with pytest.raises(ValueError, match="unknown normalization style"):
        pipeline.normalize_maps(raw[0], "log")


@pytest.mark.parametrize("size", [16, 20, 64])
def test_resize_matches_jax_and_torch_bilinear(raw, size):
    """Host (numpy) and device (torch) resize equal the JAX package's and
    ``F.interpolate(mode="bilinear", align_corners=False)``."""
    maps = pipeline.normalize_maps(raw[0][:6]).astype(np.float32)
    host = pipeline.resize_maps_np(maps, size)
    np.testing.assert_allclose(host, jax_pipeline.resize_maps_np(maps, size), rtol=0, atol=1e-6)
    np.testing.assert_allclose(host, np.asarray(jax_resize_maps(maps, size)), rtol=0, atol=1e-6)
    dev = resize_maps(torch.tensor(maps), size)
    np.testing.assert_allclose(dev.numpy(), host, rtol=0, atol=1e-6)
    want = F.interpolate(torch.tensor(maps)[:, None], size=(size, size), mode="bilinear",
                         align_corners=False)[:, 0]
    np.testing.assert_allclose(dev.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("style,num_params,param_index", [
    ("code", 6, None), ("code", 3, None), ("initial", 8, None), ("big", 1, 2)])
def test_load_camels_dataset_matches_jax_numpy_path(raw, monkeypatch, style, num_params,
                                                     param_index):
    """Split, maps, contexts, parameter min/max and ``info`` equal the JAX
    package's numpy path (its C++ fast path is not ported)."""
    monkeypatch.setattr(native_prep, "available", lambda: False)
    maps, params = raw
    kw = dict(num_params=num_params, height=16, test_size=6, seed=42, style=style,
              param_index=param_index)
    got = pipeline.load_camels_dataset(maps, params, **kw)
    want = jax_pipeline.load_camels_dataset(maps, params, **kw)
    for name in ("train_x", "train_c", "test_x", "test_c", "param_min", "param_max"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.split_indices, want.split_indices)
    assert got.info == want.info
    assert (got.n_train, got.n_test) == (54, 6)


def test_num_batches_matches_jax():
    for n, b, drop in [(432, 32, False), (432, 32, True), (48, 32, False), (64, 32, False)]:
        assert pipeline.num_batches(n, b, drop) == jax_pipeline.num_batches(n, b, drop)


@pytest.mark.parametrize("style,every", [("plus1", 25), ("plus1", 1), ("list25", 25),
                                         ("list25", 3), ("mod0", 4), ("mod0", 1)])
@pytest.mark.parametrize("n_epoch", [1, 7, 120])
def test_weights_checkpoint_plan_matches_jax(style, every, n_epoch):
    for ep in range(n_epoch + 1):
        assert (weights_checkpoint_plan(style, ep, n_epoch, every)
                == jax_weights_checkpoint_plan(style, ep, n_epoch, every))


def test_weights_checkpoint_plan_rejects_an_unknown_style():
    with pytest.raises(ValueError, match="unknown ckpt_style"):
        weights_checkpoint_plan("every", 0, 2, 1)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_device_prefetch_keeps_order_and_count(depth):
    items = [(np.full((2, 3), i, np.float32), np.arange(i, i + 4)) for i in range(7)]
    out = list(device_prefetch(iter(items), "cpu", depth=depth))
    assert len(out) == len(items)
    for (a, b), (ga, gb) in zip(items, out):
        assert torch.is_tensor(ga) and torch.is_tensor(gb)
        np.testing.assert_array_equal(ga.numpy(), a)
        np.testing.assert_array_equal(gb.numpy(), b)


def test_device_prefetch_applies_the_transform_in_order():
    seen = []

    def transform(item):
        seen.append(item)
        return (np.array([item]), np.array([2 * item]))

    out = [tuple(int(t) for t in pair) for pair in
           device_prefetch(range(5), "cpu", transform=transform, depth=3)]
    assert out == [(i, 2 * i) for i in range(5)] and seen == list(range(5))


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("where", ["source", "transform"])
def test_device_prefetch_raises_errors_after_the_earlier_items(depth, where):
    """The items before a failing one still reach the consumer, then the
    error itself, in its place."""
    def source():
        for i in range(5):
            if where == "source" and i == 3:
                raise KeyError("source failed at 3")
            yield i

    def transform(item):
        if where == "transform" and item == 3:
            raise KeyError("transform failed at 3")
        return (np.array([item]),)

    got = []
    with pytest.raises(KeyError, match="failed at 3"):
        for (t,) in device_prefetch(source(), "cpu", transform=transform, depth=depth):
            got.append(int(t))
    assert got == [0, 1, 2]


def test_device_prefetch_rejects_depth_0():
    with pytest.raises(ValueError, match="depth"):
        next(device_prefetch([], "cpu", depth=0))
