"""PyTorch port: the stages of a run after the reconstruction against the
JAX runner on the CPU -- the recon P(k) lines, ``means.txt`` and
``corrected_means.txt``, the parameter grid, the guidance sweep and the
sensitivity rows.

Both runners run the same mode at the tiny size of
``tests/test_torch_port_experiment.py`` with their samplers replaced by
one that records what it was asked for and returns the same maps, so the
stages see the same input in both.  The JAX runner's training and
likelihood passes are replaced by stand-ins (its stage code runs as it
is; no JAX file changes), and so are the port's likelihood passes, so the
metric lines carry the same numbers in both logs.  In one case of the
paper stages both runners write their figures (dpi 300, seconds each),
and the port's PNG files are the JAX runner's by name; elsewhere both
runners' figure writers are stand-ins.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from camels_diffusion_model_tpu.cli import experiment as jax_experiment
from camels_diffusion_model_tpu.config import ExperimentConfig as JaxExperimentConfig
from camels_diffusion_model_tpu.ops import spectrum as jax_spectrum
from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.diffusion.sampler import SamplerOutput, sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.ops import spectrum as port_spectrum

TINY = dict(lrate=1e-3, n_epoch=2, timesteps=8, num_params=3, n_feat=8, height=16,
            data_size=32, synthetic_param_sets=4, batch_size=8, n_eval_images=2,
            eval_batch_size=8, nll_subset=8, elbo_subset=8)
SECONDS = re.compile(r"\d+\.\d+ seconds")
# Stand-in metrics, the same in both runners.
ELBO, BPD, NLL = 0.125, 0.0625, 321.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _maps(n, height=16):
    """The maps every sampler returns: the first ``n`` of a fixed set."""
    return np.random.RandomState(99).rand(40, height, height, 1).astype(np.float32)[:n]


def _np(a):
    return None if a is None else np.asarray(a.cpu() if torch.is_tensor(a) else a)


class NoFigures:
    """A stand-in for a runner's ``viz`` module: every writer does nothing
    and returns a true value (nothing skipped)."""

    def __getattr__(self, name):
        return lambda *a, **k: True


def _run_jax(mode, root, calls, monkeypatch, figures=False, **kw):
    """The JAX runner with recording samplers and stand-ins for its
    training, likelihood passes and (unless ``figures``) figures."""

    def train_step(state, bx, bc, key, mask):
        n = bx.shape[0]
        return state, {"loss": jnp.float32(0.5), "per_sample_mse": jnp.zeros(n),
                       "t": jnp.ones(n, jnp.int32)}

    def eval_step(params, batch_stats, bx, bc, key, mask):
        return train_step(None, bx, bc, key, mask)[1]

    def sampler(model, variables, schedule, key, n_sample=None, size=None, params=None,
                guide_w=0.0, mesh=None):
        calls.append((n_sample, _np(params), _np(guide_w)))
        return types.SimpleNamespace(x=_maps(n_sample), sampling_time=0.1,
                                     timestep_times=np.array([0.01]))

    def from_noise(model, variables, schedule, key, x_fwd, params=None, mesh=None):
        n = x_fwd.shape[0]
        calls.append((n, _np(params), None))
        return types.SimpleNamespace(x=_maps(n), intermediate=np.zeros((1, *x_fwd.shape)),
                                     sampling_time=0.1, timestep_times=np.array([0.01]))

    for name, value in (
            *(() if figures else (("viz", NoFigures()),)),
            ("make_train_step", lambda *a, **k: train_step),
            ("make_eval_step", lambda *a, **k: eval_step),
            ("calculate_elbo_and_bpd", lambda *a, **k: (ELBO, BPD)),
            ("calculate_likelihood", lambda *a, **k: NLL),
            ("_sample_metrics", lambda *a, **k: (ELBO, BPD, NLL)),
            ("elbo_bpd_batch", lambda model, v, b, ab, x, *a: np.full(len(x), ELBO)),
            ("nll_batch", lambda model, v, b, ab, x, *a: np.full(len(x), NLL)),
            ("sample_ddpm", sampler), ("sample_ddpm_from_noise", from_noise)):
        monkeypatch.setattr(jax_experiment, name, value)
    return jax_experiment.run_experiment(
        JaxExperimentConfig(mode=mode, output_root=str(root), **kw))


def _run_port(mode, root, calls, monkeypatch, figures=False, **kw):
    """The port's runner with recording samplers, the stand-in metrics and
    (unless ``figures``) figure writers, on its own dataset (the JAX
    package's bit for bit, ``tests/test_torch_port_native_prep.py``)."""

    def sampler(model, schedule, generator, n_sample=1, size=64, params=None,
                guide_w=0.0, device=None, mesh=None):
        calls.append((n_sample, _np(params), _np(guide_w)))
        return torch.tensor(_maps(n_sample))

    def from_noise(model, schedule, generator, noise_images, params=None, save_rate=20,
                   device=None, z_fn=None, mesh=None):
        n = noise_images.shape[0]
        calls.append((n, _np(params), None))
        return SamplerOutput(torch.tensor(_maps(n)), torch.zeros(1, *noise_images.shape))

    for name, value in (
            ("sample_metrics", lambda *a, **k: (ELBO, BPD, NLL)),
            ("elbo_bpd_batch", lambda model, schedule, x, *a, **k: torch.full((len(x),), ELBO)),
            ("nll_batch", lambda model, schedule, x, *a, **k: torch.full((len(x),), NLL)),
            ("sample_ddpm", sampler), ("sample_ddpm_from_noise", from_noise),
            *(() if figures else (("viz", NoFigures()),))):
        monkeypatch.setattr(experiment, name, value)
    return experiment.run_experiment(ExperimentConfig(mode=mode, output_root=str(root), **kw),
                                     device="cpu")


def _pngs(root):
    pngs = sorted(f for f in os.listdir(root) if f.endswith(".png"))
    assert pngs
    return pngs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _stage_lines(path):
    """The log from the sampling header on, times masked."""
    with open(path) as f:
        text = f.read()
    return SECONDS.sub("# seconds", text[text.index("=== Sampling Performance ==="):])


@pytest.mark.parametrize("num_params", [1, 2, 6])
def test_paper_stages_equal_the_jax_runners(tmp_path, monkeypatch, num_params):
    """Mode ``paper``: the samplers are asked for the same maps in the same
    order (the reconstruction, the 25 grid contexts, each w <= 0 of the
    sweep alone and every w > 0 in one call with a per-sample w, one call
    for all ``num_params * 5`` sensitivity rows), and the log from the
    sampling header on is the JAX runner's line for line, times masked;
    with two parameters both runners write the same PNG files."""
    kw = dict(TINY, num_params=num_params)
    figures = num_params == 2
    jax_calls, port_calls = [], []
    jax_res = _run_jax("paper", tmp_path / "jax", jax_calls, monkeypatch, figures, **kw)
    port_res = _run_port("paper", tmp_path / "port", port_calls, monkeypatch, figures, **kw)
    assert [n for n, _, _ in port_calls] == [n for n, _, _ in jax_calls] == [
        2, 25, 5, 20, 5 * num_params]
    for (_, p_port, w_port), (_, p_jax, w_jax) in zip(port_calls, jax_calls):
        np.testing.assert_array_equal(p_port, p_jax)
        np.testing.assert_array_equal(w_port, w_jax)
    assert port_calls[3][2].tolist() == np.repeat([1.0, 2.0, 3.0, 5.0], 5).tolist()
    assert (_stage_lines(os.path.join(port_res["output_dir"], "timing_and_performance.log"))
            == _stage_lines(os.path.join(jax_res["output_dir"], "timing_and_performance.log")))
    for key in ("grid_metrics", "guidance_metrics"):
        assert port_res[key] == jax_res[key]
    assert port_res["not_ported"] == [] and port_res["figures_skipped"] == []
    if figures:
        assert _pngs(port_res["output_dir"]) == _pngs(jax_res["output_dir"])


@pytest.mark.parametrize("num_params", [1, 2, 6])
def test_grid_params_equal_the_jax_runners(num_params):
    cfg = ExperimentConfig(mode="paper", **dict(TINY, num_params=num_params))
    selected = np.random.RandomState(num_params).rand(3, num_params).astype(np.float32)
    got = experiment._build_grid_params(cfg, selected)
    want = jax_experiment._build_grid_params(
        JaxExperimentConfig(mode="paper", **dict(TINY, num_params=num_params)), selected)
    assert got.dtype == want.dtype and got.shape == (25, num_params)
    np.testing.assert_array_equal(got, want)


def test_spectrum_indiv_pk_lines_equal_the_jax_runners(tmp_path, monkeypatch):
    """Mode ``spectrum_indiv``: the "Power Spectrum Analysis" block (the
    reference's ratio line with its nan, the nan-safe line, the k range of
    a good match) and ``results["pk_ratio"]`` are the JAX runner's, byte
    for byte, on the same maps.  The port's spectra differ from the JAX
    package's by float32 rounding (within 1e-5 relative here, as
    ``test_torch_port_eval.py::test_compare_power_spectra_stats_matches_jax``
    holds them); a ratio of nearly empty bins carries that into the fourth
    decimal.  So the port takes the JAX spectra of the maps it is given
    (its dataset is the JAX package's bit for bit), and the stage's own
    arithmetic and lines are compared."""
    kw = dict(TINY, num_params=1, param_index=2)
    seen = []

    def jax_stats(original, generated):
        seen.append((original, generated))
        return jax_spectrum.compare_power_spectra_stats(original, generated)

    monkeypatch.setattr(experiment, "compare_power_spectra_stats", jax_stats)
    jax_res = _run_jax("spectrum_indiv", tmp_path / "jax", [], monkeypatch, **kw)
    port_res = _run_port("spectrum_indiv", tmp_path / "port", [], monkeypatch, **kw)
    (original, generated), = seen
    for got, want in zip(port_spectrum.compare_power_spectra_stats(original, generated),
                         jax_spectrum.compare_power_spectra_stats(original, generated)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

    def block(res):
        text = _read(os.path.join(res["output_dir"], "timing_and_performance.log")).decode()
        return SECONDS.sub("# seconds", text[text.index("\nPower Spectrum Analysis:"):])

    assert block(port_res) == block(jax_res)
    assert "Mean P(k) ratio over populated bins" in block(port_res)
    assert port_res["pk_ratio"].keys() == jax_res["pk_ratio"].keys()
    for key, value in jax_res["pk_ratio"].items():
        np.testing.assert_equal(port_res["pk_ratio"][key], value)


@pytest.mark.parametrize("mode", ["uncond", "initial2"])
def test_mean_correction_files_equal_the_jax_runners(tmp_path, monkeypatch, mode):
    """``means.txt`` and ``corrected_means.txt`` byte for byte, and
    ``results["mean_ratio"]``, on the same data and reconstructed maps."""
    jax_res = _run_jax(mode, tmp_path / "jax", [], monkeypatch, **TINY)
    port_res = _run_port(mode, tmp_path / "port", [], monkeypatch, **TINY)
    for name in ("means.txt", "corrected_means.txt"):
        assert (_read(os.path.join(port_res["output_dir"], name))
                == _read(os.path.join(jax_res["output_dir"], name)))
    assert port_res["mean_ratio"] == jax_res["mean_ratio"]


@pytest.mark.parametrize("strengths", [(0.0, 1.0, 2.0, 3.0, 5.0), (2.0, 0.5)])
def test_batched_guidance_sweep_equals_per_strength_calls(strengths):
    """Every w > 0 of the sweep in one sampler call with a per-sample w
    gives what a call for each strength gives, on the same initial maps
    and under the same injected z (atol 1e-6: the decoder's batch differs);
    ``guidance_sweep`` makes the batched call."""
    T, H = 6, 16
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ContextUnet(n_feat=8, n_cfeat=3, height=H).eval()
    rs = np.random.RandomState(1)
    base = np.tile(rs.rand(1, 3).astype(np.float32), (5, 1))
    pos = [w for w in strengths if w > 0]
    x0 = rs.randn(5 * len(pos), H, H, 1).astype(np.float32)
    zs = [rs.randn(*x0.shape).astype(np.float32) for _ in range(T)]
    schedule = make_schedule(T)
    batched = sample_ddpm(model, schedule, torch.Generator(), params=np.tile(base, (len(pos), 1)),
                          guide_w=np.repeat(np.asarray(pos, np.float32), 5), x_init=x0,
                          device="cpu", z_fn=lambda k, t: torch.tensor(zs[k])).numpy()
    for i, w in enumerate(pos):
        rows = slice(5 * i, 5 * (i + 1))
        alone = sample_ddpm(model, schedule, torch.Generator(), params=base, guide_w=w,
                            x_init=x0[rows], device="cpu",
                            z_fn=lambda k, t: torch.tensor(zs[k][rows])).numpy()
        np.testing.assert_allclose(batched[rows], alone, atol=1e-6, rtol=0)
    sweep = experiment.guidance_sweep(model, schedule, base, strengths, torch.Generator(), H,
                                      "cpu")
    assert list(sweep) == [w for w in strengths if w <= 0] + pos
    assert all(v.shape == (5, H, H, 1) and np.isfinite(v).all() for v in sweep.values())
