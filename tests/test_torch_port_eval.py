"""PyTorch port: the evaluation battery and samplers against the JAX package
-- pixel PDFs and the certification's pooled PDF, single-map spectra and
their comparison, DDIM in its posterior mode, the chain from forward-
diffused maps with its saved intermediates, and the experiment's
reconstruction and sample metrics."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.cli.experiment import _sample_metrics as jax_sample_metrics
from camels_diffusion_model_tpu.diffusion import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.diffusion.ddim import (
    hybrid_timesteps as jax_hybrid_timesteps,
    sample_ddim as jax_sample_ddim,
)
from camels_diffusion_model_tpu.diffusion.sampler import (
    _save_schedule as jax_save_schedule,
    sample_ddpm_from_noise as jax_sample_ddpm_from_noise,
)
from camels_diffusion_model_tpu.diffusion.schedule import (
    NoiseScaling as JaxNoiseScaling,
    q_sample as jax_q_sample,
)
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.ops import spectrum as jspec
from camels_diffusion_model_tpu.ops.stats import (
    compare_pdf_stats as jax_compare_pdf_stats,
    pixel_pdf as jax_pixel_pdf,
)
from camels_diffusion_model_tpu_torch.cli.experiment import reconstruct, sample_metrics
from camels_diffusion_model_tpu_torch.diffusion.ddim import (
    ddim_timesteps,
    hybrid_timesteps,
    posterior_coefficients,
    sample_ddim,
)
from camels_diffusion_model_tpu_torch.diffusion.sampler import (
    sample_ddpm_from_noise,
    save_schedule,
)
from camels_diffusion_model_tpu_torch.diffusion.schedule import NoiseScaling, make_schedule
from camels_diffusion_model_tpu_torch.ops import spectrum as tspec
from camels_diffusion_model_tpu_torch.ops import stats
from camels_diffusion_model_tpu_torch.ops.sampler_step import sampler_step_plain
from camels_diffusion_model_tpu_torch.serving import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = os.path.join(REPO, "artifacts", "certification", "n16k")
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


def _inputs(seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, H, 1).astype(np.float32),
            rs.rand(B, NC).astype(np.float32))


def _z_chain(key, n_steps, shape):
    """``key, zkey, skey = split(key, 3)`` a step, ``z = normal(zkey)``."""
    zs = []
    for _ in range(n_steps):
        key, zkey, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(zkey, shape, jnp.float32)))
    return zs


# ---- pixel PDFs ---------------------------------------------------------------

def _maps(seed, n=3, size=16):
    return np.random.RandomState(seed).randn(n, size, size).astype(np.float32) * 0.8


def test_pixel_pdf_matches_jax():
    bins = np.arange(-3.0, 3.0 + 0.05, 0.05)
    maps = _maps(0)
    got = stats.pixel_pdf(torch.tensor(maps), bins)
    np.testing.assert_array_equal(got, jax_pixel_pdf(maps, bins))


def test_compare_pdf_stats_matches_jax():
    a, b = _maps(1), _maps(2, n=4) + 0.2
    for got, want in zip(stats.compare_pdf_stats(a, torch.tensor(b)),
                         jax_compare_pdf_stats(a, b)):
        np.testing.assert_array_equal(got, want)


def test_pooled_pdf_and_tv_equal_the_certification_battery():
    """The battery of ``scripts/certify_fast_sampler.py:274-285,341-352``
    over two chunks, its lines written out here: exact equality, and the TV
    distance to the committed reference's ``pdf`` on the same grid."""
    chunks = [_maps(3, n=4, size=64)[..., None] * 1.5, _maps(4, n=2, size=64)[..., None]]
    pdf_delta = 0.01
    pdf_bins = np.arange(-3.0, 3.0 + pdf_delta / 2, pdf_delta)
    hist_acc, n_pix = np.zeros(pdf_bins.size - 1, np.int64), 0
    for maps_np in chunks:
        h, _ = np.histogram(maps_np, pdf_bins)
        hist_acc += h
        n_pix += maps_np.size
    want = hist_acc / (n_pix * pdf_delta)
    pooled = stats.PooledPdf()
    for maps_np in chunks:
        pooled.add(torch.tensor(maps_np))
    np.testing.assert_array_equal(stats.PDF_BINS, pdf_bins)
    np.testing.assert_array_equal(pooled.pdf, want)
    ref = np.load(os.path.join(REFS, "w0", "DDPM_1500_seed_A.npz"))["pdf"]
    assert ref.shape == want.shape == (600,)
    assert stats.pdf_tv(pooled.pdf, ref) == float(
        0.5 * np.abs(np.asarray(want) - np.asarray(ref)).sum() * pdf_delta)
    assert stats.pdf_tv(ref, ref) == 0.0


# ---- spectra ------------------------------------------------------------------

def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape,dl", [((64, 64), 1.0), ((32, 48), 0.5), ((16, 16, 16), 0.25),
                                      ((12, 16, 20), 1.0)])
def test_power_spectrum_of_one_box_matches_jax(shape, dl):
    box = np.random.RandomState(5).randn(*shape).astype(np.float32) * 2 + 1
    k_j, pk_j = jspec.power_spectrum(box, dl)
    k, pk = tspec.power_spectrum(torch.tensor(box), dl)
    np.testing.assert_array_equal(k, k_j)
    assert pk.shape == pk_j.shape and _rel(pk.numpy(), pk_j) <= 1e-5


def test_power_spectrum_rejects_other_ranks():
    with pytest.raises(ValueError, match="2D or 3D"):
        tspec.power_spectrum(torch.zeros(2, 2, 2, 2))


@pytest.mark.parametrize("shape", [(64, 64), (32, 48)])
def test_calculate_power_spectrum_2d_matches_jax(shape):
    image = np.random.RandomState(6).randn(*shape).astype(np.float32)
    k_j, pk_j = jspec.calculate_power_spectrum_2d(image)
    k, pk = tspec.calculate_power_spectrum_2d(torch.tensor(image))
    np.testing.assert_array_equal(k, k_j)
    assert _rel(pk.numpy(), pk_j) <= 1e-5


def test_compare_power_spectra_stats_matches_jax():
    a = np.random.RandomState(7).randn(5, 64, 64).astype(np.float32)
    b = np.random.RandomState(8).randn(3, 64, 64).astype(np.float32) * 1.3
    got = tspec.compare_power_spectra_stats(a, torch.tensor(b))
    want = jspec.compare_power_spectra_stats(a, b)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g, w) <= 1e-5


def test_compare_power_spectra_matches_jax_and_plots(tmp_path):
    a = np.random.RandomState(9).randn(4, 32, 32, 1).astype(np.float32)
    b = np.random.RandomState(10).randn(4, 32, 32, 1).astype(np.float32)
    os.makedirs(tmp_path / "jax")
    want = jspec.compare_power_spectra(a, b, str(tmp_path / "jax"))
    got = tspec.compare_power_spectra(torch.tensor(a), b, str(tmp_path))
    np.testing.assert_array_equal(got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-5 and _rel(got[2], want[2]) <= 1e-5
    assert os.path.getsize(tmp_path / "power_spectrum_comparison.png") > 0


# ---- DDIM, posterior mode -----------------------------------------------------

@pytest.mark.parametrize("args", [(1500, 100, 50), (20, 4, 5), (20, 20, 3), (37, 1, 10)])
def test_hybrid_timesteps_match_jax(args):
    np.testing.assert_array_equal(hybrid_timesteps(*args), jax_hybrid_timesteps(*args))


def test_hybrid_timesteps_reject_t_exact_out_of_range():
    with pytest.raises(ValueError, match="t_exact"):
        hybrid_timesteps(20, 0, 5)


GUIDES = {"w0": 0.0, "w2": 2.0, "per-sample": np.array([1.5, 3.0], np.float32)}


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("guide", sorted(GUIDES))
def test_sample_ddim_posterior_matches_jax_under_injected_noise(tiny, guide, eta):
    """DDIM at T=20 over 6 strided steps, same x_init/params/z: atol 1e-4;
    the default mode is the posterior one, as in JAX."""
    jm, variables, port = tiny
    x0, params = _inputs()
    w = GUIDES[guide]
    rng = jax.random.PRNGKey(13)
    taus = ddim_timesteps(T, 6)
    want = np.asarray(jax_sample_ddim(
        jm, variables, jax_make_schedule(T), rng, params=params, guide_w=w,
        x_init=jnp.asarray(x0), taus=taus, eta=eta,
    ).x)
    zs = _z_chain(jax.random.split(rng, 3)[0], len(taus), x0.shape)
    drawn = []
    got = sample_ddim(
        port, make_schedule(T), torch.Generator(), params=params, guide_w=w,
        x_init=x0, taus=taus, eta=eta, device="cpu",
        z_fn=lambda k, t: drawn.append(k) or torch.tensor(zs[k]),
    ).numpy()
    assert drawn == ([] if eta == 0.0 else list(range(len(taus) - 1)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
def test_posterior_coefficients_are_the_jax_update(eta):
    """Each row of the table through the step's plain version equals the
    JAX update ``sqrt(ab_prev)*x0_hat + dir + sigma*z`` on the same x, eps,
    z, for every jump of a T=1500, 50-step schedule: atol 1e-5."""
    schedule = make_schedule(1500)
    taus = ddim_timesteps(1500, 50)
    coefs = posterior_coefficients(schedule, taus, eta)
    t = taus[::-1].astype(np.int64)
    t_prev = np.concatenate([t[1:], [0]])
    ab = schedule.alpha_bar.numpy()
    rs = np.random.RandomState(1)
    for i, (c_eps, inv_sqrt_a, sigma) in enumerate(coefs.tolist()):
        x, eps, z = (rs.randn(2, 8, 8, 1).astype(np.float32) for _ in range(3))
        ab_t, ab_prev = ab[t[i]], ab[t_prev[i]]
        s = eta * np.sqrt((1 - ab_prev) / (1 - ab_t)) * np.sqrt(1 - ab_t / ab_prev)
        s = s if t_prev[i] > 0 else 0.0
        x0_hat = (x - np.sqrt(1 - ab_t) * eps) / np.sqrt(ab_t)
        want = (np.sqrt(ab_prev) * x0_hat + np.sqrt(max(1 - ab_prev - s**2, 0)) * eps
                + s * z)
        got = sampler_step_plain(torch.tensor(x), torch.tensor(eps), torch.tensor(z),
                                 c_eps, inv_sqrt_a, sigma)
        np.testing.assert_allclose(sigma, s, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---- the chain from forward-diffused maps --------------------------------------

@pytest.mark.parametrize("timesteps,save_rate", [(1500, 20), (20, 20), (20, 3), (7, 5)])
def test_save_schedule_matches_jax(timesteps, save_rate):
    for got, want in zip(save_schedule(timesteps, save_rate),
                         jax_save_schedule(timesteps, save_rate)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conditional", [False, True])
def test_sample_ddpm_from_noise_matches_jax(tiny, conditional):
    """From the same noisy maps with the same z, the samples and every saved
    state in chronological order: atol 1e-4.  Without ``params`` the zero
    context and no guidance, as in JAX."""
    jm, variables, port = tiny
    x0, params = _inputs(seed=4)
    rng = jax.random.PRNGKey(21)
    kw = dict(params=params, guide_w=2.0) if conditional else {}
    want = jax_sample_ddpm_from_noise(jm, variables, jax_make_schedule(T), rng,
                                      jnp.asarray(x0), save_rate=3, **kw)
    zs = _z_chain(rng, T, x0.shape)
    got = sample_ddpm_from_noise(port, make_schedule(T), torch.Generator(), x0,
                                 save_rate=3, device="cpu",
                                 z_fn=lambda k, t: torch.tensor(zs[k]), **kw)
    assert got.intermediate.shape == want.intermediate.shape == (
        save_schedule(T, 3)[2], B, H, H, 1)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.intermediate.numpy(), np.asarray(want.intermediate),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(got.intermediate[-1], got.x, atol=0, rtol=0)


@pytest.mark.parametrize("scaling", ["reference", "standard"])
def test_reconstruct_matches_the_jax_experiment(tiny, scaling):
    """``experiment.py:609-630``: ``q_sample`` of the maps to t=T with the
    noise of ``nkey``, then the chain from noise with ``rkey`` on the maps'
    contexts; the same noise and z given to the port: atol 1e-4."""
    jm, variables, port = tiny
    images, params = _inputs(seed=5)
    _, nkey, rkey = jax.random.split(jax.random.PRNGKey(2), 3)
    noise = np.array(jax.random.normal(nkey, images.shape, jnp.float32))
    js = jax_make_schedule(T)
    x_fwd = jax_q_sample(js, jnp.asarray(images), T, jnp.asarray(noise),
                         scaling=JaxNoiseScaling(scaling))
    want = jax_sample_ddpm_from_noise(jm, variables, js, rkey, x_fwd,
                                      params=jnp.asarray(params))
    zs = _z_chain(rkey, T, images.shape)
    got = reconstruct(port, make_schedule(T), images, params, torch.Generator(),
                      scaling=NoiseScaling(scaling), noise=noise, device="cpu",
                      z_fn=lambda k, t: torch.tensor(zs[k]))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.intermediate.numpy(), np.asarray(want.intermediate),
                               atol=1e-4, rtol=0)


def test_sample_metrics_match_the_jax_experiment(tiny):
    """``_sample_metrics`` over ordered batches of 3 (one partial): ELBO and
    BPD from the first half of the split key, the NLL from the second;
    JAX's key chains injected: rel 1e-4."""
    jm, variables, port = tiny
    rs = np.random.RandomState(6)
    x = rs.randn(5, H, H, 1).astype(np.float32)
    c = rs.rand(5, NC).astype(np.float32)
    key = jax.random.PRNGKey(31)
    want = jax_sample_metrics(jm, variables, jax_make_schedule(T), x, c, key, 3, H * H)
    k1, k2 = jax.random.split(key)
    shape = (3, H, H, 1)

    def batch_keys(rng):
        keys = []
        for _ in range(2):
            rng, k = jax.random.split(rng)
            keys.append(k)
        return keys

    elbo_keys = [jax.random.split(k, 10) for k in batch_keys(k1)]
    nll_noise = [_z_chain(k, T, shape) for k in batch_keys(k2)]
    got = sample_metrics(
        port, make_schedule(T), torch.tensor(x), c, None, 3, H * H, device="cpu",
        elbo_noise_fn=lambda bi, k, t, s: np.asarray(jax.random.normal(
            jax.random.split(elbo_keys[bi][k])[0], s, jnp.float32)),
        nll_noise_fn=lambda bi, k, t, s: nll_noise[bi][k])
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w)
