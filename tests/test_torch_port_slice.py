"""PyTorch port: the serving slice against the JAX package — samplers under
injected noise, calibration, both spectra, the serving resolver and the
serve entry point."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from camels_diffusion_model_tpu.diffusion import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.diffusion import sample_ddpm as jax_sample_ddpm
from camels_diffusion_model_tpu.diffusion.calibration import (
    SpectralCalibration as JaxCalibration,
    apply_spectral_calibration as jax_apply_calibration,
)
from camels_diffusion_model_tpu.diffusion.ddim import (
    ddim_timesteps as jax_ddim_timesteps,
    sample_ddim as jax_sample_ddim,
)
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.ops.spectrum import (
    calculate_power_spectrum_2d_batch as jax_log_pk,
    power_spectrum_batch as jax_linear_pk,
)
from camels_diffusion_model_tpu.serving import resolve_serving_config as jax_resolve
from camels_diffusion_model_tpu_torch.cli import serve as serve_cli
from camels_diffusion_model_tpu_torch.diffusion.calibration import (
    SpectralCalibration,
    apply_spectral_calibration,
    load_calibration_meta,
)
from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.ops.spectrum import (
    calculate_power_spectrum_2d_batch,
    power_spectrum_batch,
)
from camels_diffusion_model_tpu_torch.serving import (
    ServingConfigError,
    load_model,
    resolve_serving_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "certification")
T = 20
B, H, NC = 2, 16, 3


@pytest.fixture(scope="module")
def tiny():
    model = JaxContextUnet(n_feat=8, n_cfeat=NC, height=H, levels=2)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(11), np.zeros((1, H, H, 1), np.float32),
        np.array([0.5], np.float32),
    ))
    return model, variables, load_model(variables, "cpu", fold_bn=False)


def _z_sequence(rng, n_steps, shape):
    """The per-step z the JAX samplers draw from ``rng``: both split
    ``rng, xkey, pkey`` first, then ``key, zkey, skey = split(key, 3)``
    per step (``tests/test_trajectory_parity.py:55-69``)."""
    key = jax.random.split(rng, 3)[0]
    zs = []
    for _ in range(n_steps):
        key, zkey, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(zkey, shape, jnp.float32)))
    return zs


def _inputs():
    rs = np.random.RandomState(3)
    x0 = rs.randn(B, H, H, 1).astype(np.float32)
    params = rs.rand(B, NC).astype(np.float32)
    return x0, params


GUIDES = {"w0": 0.0, "w2": 2.0, "per-sample": np.array([1.5, 3.0], np.float32)}


@pytest.mark.parametrize("guide", sorted(GUIDES))
def test_sample_ddpm_matches_jax_under_injected_noise(tiny, guide):
    """T=20 exact chain, same x_init/params/z: <= 1e-4 abs on maps of
    |x| ~ 1-3 (fp32 differences of two stacks compounded over 20 steps)."""
    jm, variables, port = tiny
    x0, params = _inputs()
    w = GUIDES[guide]
    rng = jax.random.PRNGKey(42)
    want = np.asarray(jax_sample_ddpm(
        jm, variables, jax_make_schedule(T), rng, params=params, guide_w=w,
        x_init=jnp.asarray(x0),
    ).x)
    zs = _z_sequence(rng, T, x0.shape)
    got = sample_ddpm(
        port, make_schedule(T), torch.Generator(), params=params, guide_w=w,
        x_init=x0, device="cpu", z_fn=lambda k, t: torch.tensor(zs[k]),
    ).numpy()
    assert got.shape == want.shape == (B, H, H, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("guide", sorted(GUIDES))
def test_sample_ddim_beta_matches_jax_under_injected_noise(tiny, guide):
    """Strided DDPM, T=20 at stride 4 (ddim_timesteps of 5 steps)."""
    jm, variables, port = tiny
    x0, params = _inputs()
    w = GUIDES[guide]
    rng = jax.random.PRNGKey(7)
    taus = jax_ddim_timesteps(T, 6)
    np.testing.assert_array_equal(ddim_timesteps(T, 6), taus)
    want = np.asarray(jax_sample_ddim(
        jm, variables, jax_make_schedule(T), rng, params=params, guide_w=w,
        x_init=jnp.asarray(x0), taus=taus, sigma_mode="beta",
    ).x)
    zs = _z_sequence(rng, len(taus), x0.shape)
    got = sample_ddim(
        port, make_schedule(T), torch.Generator(), params=params, guide_w=w,
        x_init=x0, taus=taus, sigma_mode="beta", device="cpu",
        z_fn=lambda k, t: torch.tensor(zs[k]),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_beta_at_stride_one_is_sample_ddpm(tiny):
    """``a_jump = ab_t/ab_{t-1}`` equals ``a_t`` only to fp32 rounding, and
    ``1 - a_jump`` (~1e-4 at small t) loses most of its digits to
    cancellation; the chained model amplifies it.  Same bound as the JAX
    test of this identity (``tests/test_ddim.py``): atol 0.02."""
    _, _, port = tiny
    x0, params = _inputs()
    zs = [torch.tensor(z) for z in _z_sequence(jax.random.PRNGKey(1), T, x0.shape)]
    kw = dict(params=params, guide_w=2.0, x_init=x0, device="cpu",
              z_fn=lambda k, t: zs[k])
    a = sample_ddpm(port, make_schedule(T), torch.Generator(), **kw)
    b = sample_ddim(port, make_schedule(T), torch.Generator(),
                    taus=np.arange(1, T + 1), sigma_mode="beta", **kw)
    torch.testing.assert_close(b, a, atol=0.02, rtol=0)


def test_samplers_draw_from_the_generator(tiny):
    _, _, port = tiny
    outs = [
        sample_ddim(port, make_schedule(T), torch.Generator().manual_seed(s),
                    n_sample=2, size=H, guide_w=2.0, n_steps=4, sigma_mode="beta",
                    device="cpu")
        for s in (0, 0, 1)
    ]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert bool(torch.isfinite(outs[0]).all())


@pytest.mark.parametrize("guide_w,match", [
    (np.array([2.0, 0.0], np.float32), "all-positive"),
    (np.array([2.0, 2.0, 2.0], np.float32), "batch size"),
])
def test_per_sample_guidance_is_validated(tiny, guide_w, match):
    _, _, port = tiny
    x0, params = _inputs()
    with pytest.raises(ValueError, match=match):
        sample_ddpm(port, make_schedule(T), torch.Generator(), params=params,
                    guide_w=guide_w, x_init=x0, device="cpu")


def test_sample_ddim_rejects_bad_taus_and_modes(tiny):
    _, _, port = tiny
    with pytest.raises(ValueError, match="increasing"):
        sample_ddim(port, make_schedule(T), torch.Generator(), taus=[5, 3], device="cpu")
    with pytest.raises(ValueError, match="unknown sigma_mode"):
        sample_ddim(port, make_schedule(T), torch.Generator(),
                    sigma_mode="ddpm", device="cpu")


# ---- calibration and spectra ------------------------------------------------

@pytest.mark.parametrize("name", ["calib_w2_500.npz", "calib_w0_430.npz"])
@pytest.mark.parametrize("layout", ["nhwc", "bhw"])
def test_calibration_apply_matches_jax(name, layout):
    """The committed filters on the same maps; two fp32 FFTs: atol 2e-6."""
    path = os.path.join(ART, name)
    rs = np.random.RandomState(0)
    maps = rs.randn(3, 64, 64, 1).astype(np.float32)
    if layout == "bhw":
        maps = maps[..., 0]
    want = np.asarray(jax_apply_calibration(maps, JaxCalibration.load(path)))
    got = apply_spectral_calibration(torch.tensor(maps), SpectralCalibration.load(path))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_calibration_ratio_and_meta_match_jax():
    path = os.path.join(ART, "calib_w2_500.npz")
    ours, theirs = SpectralCalibration.load(path), JaxCalibration.load(path)
    k = np.linspace(0, 4.5, 50)
    np.testing.assert_array_equal(ours.total_ratio(k, 64), theirs.total_ratio(k, 64))
    from camels_diffusion_model_tpu.diffusion.calibration import (
        load_calibration_meta as jax_meta,
    )
    assert load_calibration_meta(path) == jax_meta(path)


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 32, 48)])
def test_linear_power_spectrum_matches_jax(shape):
    maps = np.random.RandomState(1).randn(*shape).astype(np.float32) * 3 + 1
    k_j, pk_j = jax_linear_pk(maps, dl=0.5)
    k, pk = power_spectrum_batch(torch.tensor(maps), dl=0.5)
    np.testing.assert_array_equal(k, k_j)
    np.testing.assert_allclose(pk.numpy(), np.asarray(pk_j), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 32, 48)])
def test_log_power_spectrum_matches_jax(shape):
    maps = np.random.RandomState(2).randn(*shape).astype(np.float32)
    k_j, pk_j = jax_log_pk(maps)
    k, pk = calculate_power_spectrum_2d_batch(torch.tensor(maps))
    np.testing.assert_array_equal(k, k_j)
    np.testing.assert_allclose(pk.numpy(), np.asarray(pk_j), rtol=2e-5, atol=1e-3)


# ---- serving ----------------------------------------------------------------

@pytest.mark.parametrize("w", [0, 2])
def test_resolver_picks_the_same_row_as_jax(w):
    ours, theirs = resolve_serving_config(w), jax_resolve(w)
    for field in ("guide_w", "steps", "config", "expected_maps_per_min",
                  "max_err_vs_indep_pct", "checkpoint_fingerprint"):
        assert getattr(ours, field) == getattr(theirs, field), field
    for field in ("model_path", "calibration_path"):
        assert os.path.samefile(getattr(ours, field), getattr(theirs, field))
    assert ours.steps == {0: 430, 2: 500}[w]


def _mock_art_dir(tmp_path, *, steps=3, w=2, stamp_ok=True, calib_stamp=None,
                  model_bytes=b"fake checkpoint bytes"):
    art = tmp_path / "certification"
    (art / "model").mkdir(parents=True)
    (art / "model" / "train_state.msgpack").write_bytes(model_bytes)
    md5 = hashlib.md5(model_bytes).hexdigest()
    rows = [
        {"config": f"strided DDPM {steps} + spectral calibration", "steps": steps,
         "maps_per_min": 100.0, "max_err_vs_indep_pct": 1.2},
        {"config": "strided DDPM 2 + spectral calibration", "steps": 2,
         "maps_per_min": 500.0, "max_err_vs_indep_pct": 9.9},
    ]
    (art / f"validation_w{w}_calibrated.indep.json").write_text(json.dumps({
        "guide_w": float(w), "checkpoint_fingerprint": md5 if stamp_ok else "deadbeef",
        "rows": rows, "certified_configs_independent": [rows[0]["config"]],
    }))
    JaxCalibration(coeffs=(1.0,), k_min=0.1, k_max=3.0).save(
        str(art / f"calib_w{w}_{steps}.npz"),
        meta={"checkpoint_fingerprint": calib_stamp or md5, "timesteps": 1500},
    )
    return str(art)


@pytest.mark.parametrize("case,match", [
    ("nonintegral", "integer guidance"),
    ("unknown_w", "no certification"),
    ("stale_artifact", "stamped for checkpoint"),
    ("stale_calibration", "calibrations are model-specific"),
    ("missing_calibration", "missing"),
])
def test_resolver_rejections(tmp_path, case, match):
    art = _mock_art_dir(
        tmp_path, stamp_ok=case != "stale_artifact",
        calib_stamp="0" * 32 if case == "stale_calibration" else None,
    )
    if case == "missing_calibration":
        os.remove(os.path.join(art, "calib_w2_3.npz"))
    with pytest.raises(ServingConfigError, match=match):
        resolve_serving_config({"nonintegral": 0.5, "unknown_w": 1}.get(case, 2),
                               art_dir=art)


def test_resolver_picks_the_certified_row_not_the_fastest(tmp_path):
    cfg = resolve_serving_config(2, art_dir=_mock_art_dir(tmp_path, steps=4))
    assert cfg.steps == 4 and cfg.expected_maps_per_min == 100.0


def test_serve_end_to_end_on_cpu(tiny, tmp_path, monkeypatch):
    """``cli.serve`` on a mock certified tree whose checkpoint is the tiny
    model, written by flax: resolve, load, sample, calibrate, P(k), npz."""
    _, variables, _ = tiny
    data = serialization.to_bytes({**variables, "opt_state": {"mu": np.ones(3)}})
    art = _mock_art_dir(tmp_path, steps=3, model_bytes=data)
    monkeypatch.setattr(serve_cli, "TIMESTEPS", T)
    out = tmp_path / "out"
    r = serve_cli.serve(2, 2, str(out), seed=1, device="cpu", art_dir=art)
    assert r["maps"].shape == (2, H, H, 1) and bool(torch.isfinite(r["maps"]).all())
    assert r["steps"] == 3 and r["pk"].shape[0] == 2 and np.isfinite(r["pk"]).all()
    saved = np.load(r["path"])
    assert os.path.dirname(r["path"]) == str(out)
    np.testing.assert_array_equal(saved["pk"], r["pk"])
    assert "maps" not in saved.files and float(saved["guide_w"]) == 2.0


@pytest.fixture
def recorded_serve(tiny, tmp_path, monkeypatch):
    """``cli.serve`` on the mock certified tree with ``sample_ddim``
    replaced by a recorder: returns (serve, the recorded calls)."""
    _, variables, _ = tiny
    data = serialization.to_bytes({**variables, "opt_state": {"mu": np.ones(3)}})
    art = _mock_art_dir(tmp_path, steps=3, model_bytes=data)
    calls = []

    def record(model, schedule, generator, n_sample, size, params, **kw):
        calls.append({"params": params, "n_sample": n_sample, **kw})
        return torch.zeros(n_sample, size, size, 1)

    monkeypatch.setattr(serve_cli, "sample_ddim", record)

    def run(n, **kw):
        return serve_cli.serve(2, n, str(tmp_path / "out"), device="cpu", art_dir=art, **kw)
    return run, calls


def test_serve_tiles_one_given_context(recorded_serve):
    """One context, tiled to every map as ``cli/sample.py:127`` does."""
    run, calls = recorded_serve
    ctx = np.array([0.1, 0.9, 0.5], np.float32)
    r = run(4, params=ctx)
    np.testing.assert_array_equal(calls[0]["params"], np.tile(ctx, (4, 1)))
    np.testing.assert_array_equal(r["params"], np.tile(ctx, (4, 1)))
    assert calls[0]["guide_w"] == 2.0 and calls[0]["n_steps"] == 3


def test_serve_passes_one_context_per_map_through(recorded_serve):
    run, calls = recorded_serve
    ctx = np.random.RandomState(0).rand(3, NC).astype(np.float32)
    run(3, params=ctx)
    np.testing.assert_array_equal(calls[0]["params"], ctx)
    with pytest.raises(ValueError, match="params must be"):
        run(2, params=ctx)


@pytest.mark.parametrize("seed", [0, 3])
def test_serve_without_params_serves_the_jax_clis_context(recorded_serve, seed):
    """The JAX serving CLI's context on this tree (data files absent): the
    synthetic stand-in's 8 sets, min-max over them, the set
    ``random.Random(seed).randint(0, 7)`` (``cli/sample.py:101-116``), cut
    to the model's ``n_cfeat`` as ``:127`` does."""
    import random

    from camels_diffusion_model_tpu.data.synthetic import synthetic_camels

    run, calls = recorded_serve
    _, raw = synthetic_camels(n_param_sets=8, maps_per_set=1, size=8, seed=seed or 0)
    norm = (raw - raw.min(axis=0)) / (raw.max(axis=0) - raw.min(axis=0) + 1e-8)
    want = norm[random.Random(seed).randint(0, 7)].astype(np.float32)[:NC]
    run(2, seed=seed)
    np.testing.assert_array_equal(calls[0]["params"], np.tile(want, (2, 1)))


def test_serve_runs_in_fp32_and_restores_the_flags(tiny, tmp_path, monkeypatch):
    """Both TF32 flags are False while ``serve`` samples, and the caller's
    values come back after it (``cli/serve.py`` states its precision)."""
    _, variables, _ = tiny
    data = serialization.to_bytes({**variables, "opt_state": {"mu": np.ones(3)}})
    art = _mock_art_dir(tmp_path, steps=3, model_bytes=data)
    monkeypatch.setattr(serve_cli, "TIMESTEPS", T)
    seen = []
    real = serve_cli.sample_ddim

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(serve_cli, "sample_ddim", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    r = serve_cli.serve(2, 2, str(tmp_path / "out"), device="cpu", art_dir=art)
    assert seen == [(False, False)] and bool(torch.isfinite(r["maps"]).all())
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ServingConfigError):
        serve_cli.serve(2, 2, str(tmp_path / "out"), device="cpu",
                        art_dir=str(tmp_path / "missing"))
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert "fp32" in serve_cli.__doc__ and "TF32" in serve_cli.__doc__


def test_serve_help_states_the_precision(capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--help"])
    assert "fp32" in capsys.readouterr().out


def test_serve_cli_takes_params(recorded_serve, monkeypatch):
    run, calls = recorded_serve
    seen = {}
    monkeypatch.setattr(serve_cli, "serve", lambda *a, **k: seen.update(a=a, k=k) or {
        "config": "c", "guide_w": 2.0, "seconds": 1.0, "path": "p"})
    serve_cli.main(["--guide-w", "2", "--n", "2", "--out", "o", "--params",
                    "0.1", "0.2", "0.3", "0.4", "0.5", "0.6"])
    assert seen["k"]["params"] == [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]
