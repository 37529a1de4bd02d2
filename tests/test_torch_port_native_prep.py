"""PyTorch port: the native (C++) host prep and the map dataset against
the JAX package on the CPU -- the port's own build of
``native/camels_prep.cpp`` against the JAX package's library bit for bit,
``load_camels_dataset`` against the JAX package's default path bit for bit
(no monkeypatch), the numpy fallback when no library is built, a build
that leaves ``native/`` as it was, and ``MapDataset`` / ``verify_dataset``."""

import hashlib
import os

import numpy as np
import pytest

from camels_diffusion_model_tpu.data import map_dataset as jax_map_dataset
from camels_diffusion_model_tpu.data import native_prep as jax_native_prep
from camels_diffusion_model_tpu.data import pipeline as jax_pipeline
from camels_diffusion_model_tpu_torch.data import map_dataset, native_prep, pipeline
from camels_diffusion_model_tpu_torch.data.synthetic import synthetic_camels

NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")

needs_native = pytest.mark.skipif(
    not jax_native_prep.available(), reason="no C++ toolchain: neither package has the library")


def _raw(shape, seed):
    rs = np.random.RandomState(seed)
    return (rs.lognormal(0.0, 2.0, shape) - 0.5).astype(np.float32)


def _fresh(monkeypatch, build_root):
    """The port's loader with nothing loaded yet and its builds under
    ``build_root``."""
    monkeypatch.setattr(native_prep, "BUILD_ROOT", build_root)
    monkeypatch.setattr(native_prep, "_lib", None)
    monkeypatch.setattr(native_prep, "_tried", False)


SHAPES = [(3, 32, 32), (5, 64, 48), (2, 128, 128)]


@needs_native
@pytest.mark.parametrize("shape", SHAPES)
def test_native_functions_equal_the_jax_library_bit_for_bit(shape):
    raw = _raw(shape, seed=sum(shape))
    assert native_prep.available()
    assert native_prep.minmax_native(raw) == jax_native_prep.minmax_native(raw)
    got = native_prep.normalize_maps_native(raw)
    want = jax_native_prep.normalize_maps_native(raw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for size in (16, 64):
        np.testing.assert_array_equal(native_prep.resize_maps_native(got, size),
                                      jax_native_prep.resize_maps_native(want, size))


@pytest.mark.parametrize("style,num_params,param_index", [
    ("code", 6, None), ("code", 3, None), ("initial", 8, None), ("big", 1, 2)])
def test_load_camels_dataset_equals_the_jax_default_path_bit_for_bit(style, num_params,
                                                                    param_index):
    """Whatever path the JAX package takes on this machine (the C++ one
    for ``"code"`` when its library loads), the port takes it too: every
    array equal, not within an ulp."""
    maps, params = synthetic_camels(n_param_sets=4, maps_per_set=15, size=32, seed=3)
    kw = dict(num_params=num_params, height=16, test_size=6, seed=42, style=style,
              param_index=param_index)
    got = pipeline.load_camels_dataset(maps, params, **kw)
    want = jax_pipeline.load_camels_dataset(maps, params, **kw)
    assert native_prep.available() == jax_native_prep.available()
    for name in ("train_x", "train_c", "test_x", "test_c", "param_min", "param_max",
                 "split_indices"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.info == want.info


@needs_native
def test_native_path_differs_from_numpy_where_the_jax_package_does():
    """The C++ and numpy ``"code"`` paths differ by rounding on some pixels
    (why the port must take the JAX package's path): by at most an ulp of
    1.0 on maps in [0, 1]."""
    raw = _raw((4, 64, 64), seed=5)
    native = native_prep.normalize_maps_native(raw)
    numpy_path = pipeline.normalize_maps(raw, "code").astype(np.float32)
    assert np.any(native != numpy_path)
    np.testing.assert_allclose(native, numpy_path, rtol=0, atol=2.0**-23)


def test_no_library_and_camels_no_native_takes_the_numpy_path(tmp_path, monkeypatch):
    """``CAMELS_NO_NATIVE=1`` with nothing built: no build, ``available()``
    False, and the dataset is the numpy path's (the JAX package's with its
    library switched off)."""
    _fresh(monkeypatch, tmp_path / "native_prep")
    monkeypatch.setenv("CAMELS_NO_NATIVE", "1")
    assert not native_prep.available()
    assert not (tmp_path / "native_prep").exists()
    monkeypatch.setattr(jax_native_prep, "available", lambda: False)
    maps, params = synthetic_camels(n_param_sets=4, maps_per_set=15, size=32, seed=4)
    kw = dict(num_params=6, height=16, test_size=6, seed=42, style="code")
    got = pipeline.load_camels_dataset(maps, params, **kw)
    want = jax_pipeline.load_camels_dataset(maps, params, **kw)
    np.testing.assert_array_equal(got.train_x, want.train_x)
    np.testing.assert_array_equal(got.test_x, want.test_x)
    with pytest.raises(RuntimeError, match="not available"):
        native_prep.normalize_maps_native(maps)


def test_a_failed_build_falls_back_to_numpy(tmp_path, monkeypatch):
    _fresh(monkeypatch, tmp_path / "native_prep")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native_prep.available()


def _snapshot(path):
    return {name: hashlib.sha256(open(os.path.join(path, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(path))}


@needs_native
def test_the_build_writes_only_under_its_build_root(tmp_path, monkeypatch):
    """A fresh build compiles ``native/camels_prep.cpp`` in place into the
    build root (one library under a hash directory, no temporary left) and
    leaves ``native/`` byte for byte as it was."""
    before = _snapshot(NATIVE)
    root = tmp_path / "native_prep"
    _fresh(monkeypatch, root)
    monkeypatch.delenv("CAMELS_NO_NATIVE", raising=False)
    assert native_prep.available()
    assert _snapshot(NATIVE) == before
    built = sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())
    assert len(built) == 1 and built[0].endswith("/libcamels_prep.so")
    assert native_prep.library_path() == root / built[0]
    raw = _raw((2, 32, 32), seed=9)
    np.testing.assert_array_equal(native_prep.normalize_maps_native(raw),
                                  jax_native_prep.normalize_maps_native(raw))


def test_library_path_hashes_source_and_compiler(monkeypatch):
    a = native_prep.library_path()
    monkeypatch.setenv("CXX", "clang++")
    assert native_prep.library_path() != a
    assert a.name == "libcamels_prep.so"


@pytest.mark.parametrize("ndim", [3, 4])
def test_map_dataset_equals_jax(tmp_path, ndim):
    rs = np.random.RandomState(ndim)
    maps = rs.lognormal(0.0, 1.5, (6, 8, 8) + (1,) * (ndim - 3)).astype(np.float32)
    path = str(tmp_path / "maps.npy")
    np.save(path, maps)
    for source in (maps, path):
        got, want = map_dataset.MapDataset(source), jax_map_dataset.MapDataset(source)
        assert len(got) == len(want) == 6
        assert got.getshapes() == want.getshapes() == (6, 8, 8, 1)
        for name in ("global_min", "global_max", "log_global_min", "log_global_max"):
            assert getattr(got, name) == getattr(want, name), name
        for i in range(6):
            g, w = got[i], want[i]
            assert g.dtype == w.dtype == np.float32 and g.shape == (8, 8, 1)
            np.testing.assert_array_equal(g, w)
    flip = map_dataset.MapDataset(maps, transform=lambda im: im[::-1])
    jflip = jax_map_dataset.MapDataset(maps, transform=lambda im: im[::-1])
    np.testing.assert_array_equal(flip[2], jflip[2])


def test_verify_dataset_equals_jax(capsys):
    rs = np.random.RandomState(0)
    clean = rs.rand(4, 8, 8).astype(np.float32)
    assert map_dataset.verify_dataset(map_dataset.MapDataset(clean)) == []
    out = capsys.readouterr().out
    assert jax_map_dataset.verify_dataset(jax_map_dataset.MapDataset(clean)) == []
    assert capsys.readouterr().out == out
    bad = clean.copy()
    bad[1, 0, 0] = np.nan
    bad[2, 0, 0] = np.inf
    bad_maps = map_dataset.MapDataset(bad)
    got = map_dataset.verify_dataset(bad_maps, num_samples=4)
    out = capsys.readouterr().out
    want = jax_map_dataset.verify_dataset(jax_map_dataset.MapDataset(bad), num_samples=4)
    assert got == want and len(got) >= 2
    assert capsys.readouterr().out == out
    wide = map_dataset.MapDataset(rs.rand(3, 4, 4, 2).astype(np.float32))
    assert map_dataset.verify_dataset(wide, 2) == jax_map_dataset.verify_dataset(
        jax_map_dataset.MapDataset(wide.maps), 2)
