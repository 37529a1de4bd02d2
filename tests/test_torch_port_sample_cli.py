"""PyTorch port: the power-spectrum comparison CLI (``cli/sample.py``) and
its helpers against the JAX package on the CPU -- the files, printed lines
and ``results`` of ``generate_comparison_plot`` (T 20, n_feat 8, 5 maps:
the example-maps figure of either package draws five),
the CAMELS side of ``results`` equal to JAX's, ``.pth`` and ``.msgpack``
inputs, ``main``'s positional contract against ``sample_power_spectra.py``
and ``--serving``'s refusal of a foreign checkpoint, the figures skipped
without matplotlib, and ``utils/image_norm.py``.

The sampled maps differ from JAX's (torch generators, not threefry), so
the model's side of ``results`` is held by shape and finiteness; the
CAMELS side (the same maps through each package's P(k)) to 1e-5 relative,
the spectra's tolerance in ``test_torch_port_eval.py``."""

import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
from flax import serialization

import sample_power_spectra
from camels_diffusion_model_tpu.cli import sample as jax_sample
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.training import load_model_weights as jax_load_model_weights
from camels_diffusion_model_tpu.utils import image_norm as jax_image_norm
from camels_diffusion_model_tpu.utils import torch_interop as jax_interop
from camels_diffusion_model_tpu_torch.cli import sample
from camels_diffusion_model_tpu_torch.serving import resolve_serving_config
from camels_diffusion_model_tpu_torch.utils import image_norm

FILES = ["example_maps_comparison.png", "power_spectrum_comparison.png",
         "power_spectrum_results.npy"]
KW = dict(n_maps=5, timesteps=20, n_feat=8, seed=3)
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A narrow JAX model's variables as a ``.msgpack`` weights file and as
    a reference ``.pth``."""
    root = tmp_path_factory.mktemp("ckpt")
    model = JaxContextUnet(n_feat=8, n_cfeat=6, height=64, levels=2)
    variables = jax.device_get(model.init(jax.random.PRNGKey(4), np.zeros((1, 64, 64, 1),
                                                                           np.float32),
                                          np.array([0.5], np.float32)))
    msgpack_path = str(root / "model.msgpack")
    with open(msgpack_path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    pth_path = str(root / "model.pth")
    jax_interop.save_torch_checkpoint(variables, pth_path)
    return model, variables, msgpack_path, pth_path


def _run(fn, out, capsys, model_path, **kw):
    res = fn(model_path=model_path, camels_data_path="absent.npy", params_path="absent.npy",
             output_dir=str(out), selected_params_dict=dict(sample.SELECTED_PARAMS),
             **dict(KW, **kw))
    return res, capsys.readouterr().out


def _lines(text, out):
    """Printed lines with numbers, the platform and the output directory
    masked."""
    text = text.replace("platform: cpu", "platform: #").replace(str(out), "OUT")
    return [NUMBER.sub("#", line) for line in text.splitlines()]


def test_comparison_writes_the_jax_files_lines_and_results(checkpoints, tmp_path, capsys):
    _, _, msgpack_path, _ = checkpoints
    want, jax_out = _run(jax_sample.generate_comparison_plot, tmp_path / "jax", capsys,
                         msgpack_path)
    got, port_out = _run(sample.generate_comparison_plot, tmp_path / "port", capsys,
                         msgpack_path, device="cpu")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == FILES
    assert _lines(port_out, tmp_path / "port") == _lines(jax_out, tmp_path / "jax")
    assert list(got) == list(want)
    saved = np.load(tmp_path / "port" / "power_spectrum_results.npy", allow_pickle=True).item()
    assert list(saved) == list(got)
    for key in ("k", "camels_pk_mean", "camels_pk_std"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, atol=0,
                                   err_msg=key)
        np.testing.assert_array_equal(saved[key], got[key])
    for key in ("hicdm_pk_mean", "hicdm_pk_std"):
        assert got[key].shape == np.asarray(want[key]).shape and np.isfinite(got[key]).all()
    assert got["parameters"] == want["parameters"]


@pytest.mark.parametrize("kind", ["pth", "msgpack"])
def test_both_checkpoint_formats_load_as_jax_loads_them(checkpoints, tmp_path, capsys, kind):
    """The variables the CLI serves from each format are the JAX CLI's (the
    ``.pth``'s learned shortcut re-seeded by threefry, bit for bit), and a
    run on them completes."""
    jm, variables, msgpack_path, pth_path = checkpoints
    path = pth_path if kind == "pth" else msgpack_path
    got = sample._variables(path, 8, 6, 64)
    template = jax.device_get(jm.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 1),
                                                                       np.float32),
                                      np.array([0.5], np.float32)))
    want = (jax_interop.load_torch_checkpoint(template, path) if kind == "pth"
            else jax_load_model_weights(template, path))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(want)))
    assert set(map(str, flat_got)) == set(map(str, flat_want))
    by_name = {str(k): v for k, v in flat_want.items()}
    for k, v in flat_got.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(by_name[str(k)]), err_msg=str(k))
    res, _ = _run(sample.generate_comparison_plot, tmp_path, capsys, path, device="cpu",
                  timesteps=8)
    assert np.isfinite(res["hicdm_pk_mean"]).all()


def test_missing_checkpoint_and_fresh_weights(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("CAMELS_ALLOW_FRESH_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="CAMELS_ALLOW_FRESH_WEIGHTS"):
        _run(sample.generate_comparison_plot, tmp_path, capsys, "none.msgpack", device="cpu")
    with pytest.raises(FileNotFoundError):
        _run(sample.generate_comparison_plot, tmp_path, capsys, "none.pth", device="cpu")
    monkeypatch.setenv("CAMELS_ALLOW_FRESH_WEIGHTS", "1")
    res, out = _run(sample.generate_comparison_plot, tmp_path, capsys, "none.msgpack",
                    device="cpu", timesteps=6)
    assert "demo mode" in out and np.isfinite(res["hicdm_pk_mean"]).all()


def test_serving_steps_and_calibration_take_the_strided_sampler(checkpoints, tmp_path, capsys,
                                                               monkeypatch):
    """``CAMELS_SERVING_STEPS`` selects ``sample_ddim(sigma_mode="beta")``
    at that many steps and ``CAMELS_CALIBRATION`` the filter, as in JAX."""
    _, _, msgpack_path, _ = checkpoints
    calls = []
    real = sample.sample_ddim

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(sample, "sample_ddim", spy)
    monkeypatch.setenv("CAMELS_SERVING_STEPS", "5")
    monkeypatch.setenv("CAMELS_CALIBRATION", resolve_serving_config(0).calibration_path)
    res, out = _run(sample.generate_comparison_plot, tmp_path, capsys, msgpack_path,
                    device="cpu", guide_w=2.0)
    assert [(c["n_steps"], c["sigma_mode"], c["guide_w"]) for c in calls] == [(5, "beta", 2.0)]
    assert "(serving fast path: strided DDPM, 5 steps, guide_w=2.0)" in out
    assert "(spectral calibration:" in out and np.isfinite(res["hicdm_pk_mean"]).all()


def _captured(module, monkeypatch):
    seen = []
    monkeypatch.setattr(module, "generate_comparison_plot", lambda **kw: seen.append(kw))
    return seen


@pytest.mark.parametrize("argv", [
    [], ["m.pth"], ["m.msgpack", "50"], ["m.pth", "50", "out"], ["--serving"],
    ["--serving", "2"], ["--serving", "2", "--device", "cpu"]])
def test_main_follows_the_positional_contract(monkeypatch, capsys, argv):
    """``main`` hands ``generate_comparison_plot`` what the root
    ``sample_power_spectra.py`` hands the JAX one, plus the device."""
    monkeypatch.setenv("CAMELS_SAMPLE_N_MAPS", "7")
    want = _captured(sample_power_spectra, monkeypatch)
    got = _captured(sample, monkeypatch)
    sample_power_spectra.main([a for a in argv if a not in ("--device", "cpu")])
    sample.main(list(argv))
    assert len(got) == len(want) == 1
    device = got[0].pop("device")
    assert device == ("cpu" if "--device" in argv else None)
    assert got[0] == want[0]
    assert got[0]["n_maps"] == 7


def test_serving_refuses_a_foreign_checkpoint(monkeypatch):
    _captured(sample, monkeypatch)
    with pytest.raises(SystemExit, match="certified checkpoint"):
        sample.main(["--serving", "2", "other.msgpack"])
    with pytest.raises(SystemExit, match="certified checkpoint"):
        sample.main(["--serving", "other.pth"])


def test_figures_are_skipped_without_matplotlib(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = str(tmp_path / "power_spectrum_comparison.png")
    k = np.arange(1.0, 5.0)
    assert not sample.viz.plot_log_spectrum_comparison(k, k, k, k, k, {"a": 1}, path)
    assert not sample.viz.plot_example_maps_comparison(np.zeros((5, 4, 4)), np.zeros((5, 4, 4)),
                                                       str(tmp_path / "example.png"))
    out = capsys.readouterr().out.splitlines()
    assert out == ["skipped power_spectrum_comparison.png: matplotlib is not installed",
                   "skipped example.png: matplotlib is not installed"]
    assert not os.listdir(tmp_path)


def test_figures_are_written_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    maps = np.random.RandomState(0).rand(5, 8, 8, 1)
    assert sample.viz.plot_example_maps_comparison(maps, maps, str(tmp_path / "a.png"))
    k = np.arange(1.0, 5.0)
    assert sample.viz.plot_log_spectrum_comparison(k, k, k * 0.1, k, k * 0.1, {"Ωm": 0.3},
                                                   str(tmp_path / "b.png"))
    assert sorted(os.listdir(tmp_path)) == ["a.png", "b.png"]


# ---- image_norm ---------------------------------------------------------------

def test_image_norm_equals_jax():
    rs = np.random.RandomState(1)
    img = rs.randn(8, 8, 2).astype(np.float32)
    np.testing.assert_array_equal(image_norm.unorm(img), jax_image_norm.unorm(img))
    store = rs.randn(3, 2, 8, 8, 1).astype(np.float32)
    np.testing.assert_array_equal(image_norm.norm_all(store, 3, 2),
                                  jax_image_norm.norm_all(store, 3, 2))
    batch = rs.randn(4, 8, 8, 1).astype(np.float32)
    np.testing.assert_array_equal(image_norm.norm_batch(batch), jax_image_norm.norm_batch(batch))
    n, vec = image_norm.gen_tst_context()
    jn, jvec = jax_image_norm.gen_tst_context()
    assert n == jn == 36 and vec.dtype == jvec.dtype
    np.testing.assert_array_equal(vec, jvec)
