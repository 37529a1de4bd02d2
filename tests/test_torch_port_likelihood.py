"""PyTorch port: the forward perturbation, ``ddpm_loss`` and the ELBO / BPD /
NLL passes against the JAX package, with JAX's noise key chain replayed on
the host and injected through ``noise_fn``; on the tiny model unfolded and
BN-folded, and on the committed checkpoint at full width."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.diffusion import likelihood as jl
from camels_diffusion_model_tpu.diffusion.schedule import (
    NoiseScaling as JaxNoiseScaling,
    ddpm_loss as jax_ddpm_loss,
    make_schedule as jax_make_schedule,
    q_sample as jax_q_sample,
)
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.models.fold_bn import fold_inference
from camels_diffusion_model_tpu_torch.diffusion import likelihood as tl
from camels_diffusion_model_tpu_torch.diffusion.schedule import (
    NoiseScaling,
    ddpm_loss,
    make_schedule,
    q_sample,
)
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "certification", "model", "train_state.msgpack")
T = 12
B, H, NC = 3, 16, 3
REL = 1e-4  # two fp32 stacks of some twenty convs, summed over timesteps


@pytest.fixture(scope="module")
def tiny():
    """The narrow JAX model with non-trivial BatchNorm statistics, and the
    port's model of the same weights unfolded (eval-mode BatchNorm) and
    folded: ``(jax model, jax variables, {"unfolded": .., "folded": ..})``."""
    model = JaxContextUnet(n_feat=8, n_cfeat=NC, height=H, levels=2)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(3), np.zeros((1, H, H, 1), np.float32),
        np.array([0.5], np.float32),
    ))
    rs = np.random.RandomState(8)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (
            (rs.randn(*leaf.shape) * 0.1).astype(np.float32)
            if "mean" in jax.tree_util.keystr(path)
            else (rs.rand(*leaf.shape) + 0.5).astype(np.float32)
        ),
        variables["batch_stats"],
    )
    ports = {"unfolded": load_model(variables, "cpu", fold_bn=False),
             "folded": load_model(variables, "cpu", fold_bn=True)}
    return model, variables, ports


def _inputs(n=B, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, H, H, 1).astype(np.float32),
            rs.rand(n, NC).astype(np.float32))


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _elbo_noise(key):
    """``elbo_bpd_batch``'s draws from the batch key ``key``: ``keys =
    split(key, 10)``, then ``nkey, skey = split(keys[k])``."""
    keys = jax.random.split(key, 10)
    return lambda k, shape: _normal(jax.random.split(keys[k])[0], shape)


def _sweep_noise(key, n_steps, shape):
    """The t-sweep's draws: ``key, nkey, skey = split(key, 3)`` a step,
    carried across the whole sweep."""
    out = []
    for _ in range(n_steps):
        key, nkey, _ = jax.random.split(key, 3)
        out.append(_normal(nkey, shape))
    return out


def _batch_keys(rng, n_batches):
    """The dataset level: ``rng, key = split(rng)`` for each batch."""
    keys = []
    for _ in range(n_batches):
        rng, key = jax.random.split(rng)
        keys.append(key)
    return keys


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_model(tiny, form):
    model, variables, _ = tiny
    return fold_inference(model, variables) if form == "folded" else (model, variables)


# ---- q_sample and ddpm_loss -------------------------------------------------

@pytest.mark.parametrize("scaling", ["reference", "standard"])
@pytest.mark.parametrize("t", [0, 1, 700, 1500, "per-sample"])
def test_q_sample_matches_jax(scaling, t):
    """Both scalings at a scalar t (0 and T included) and at one t per
    sample: atol 1e-6 (alpha_bar differs by up to 32 ulp, 2e-6 rel)."""
    rs = np.random.RandomState(1)
    x0, noise = (rs.randn(4, 8, 8, 1).astype(np.float32) for _ in range(2))
    if t == "per-sample":
        t = np.array([1, 10, 750, 1500])
    want = jax_q_sample(jax_make_schedule(1500), jnp.asarray(x0), jnp.asarray(t),
                        jnp.asarray(noise), JaxNoiseScaling(scaling))
    got = q_sample(make_schedule(1500), torch.tensor(x0), t, torch.tensor(noise),
                   NoiseScaling(scaling))
    assert got.shape == x0.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_ddpm_loss_matches_jax():
    rs = np.random.RandomState(2)
    a, b = (rs.randn(3, 8, 8, 1).astype(np.float32) for _ in range(2))
    got = ddpm_loss(torch.tensor(a), torch.tensor(b))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(jax_ddpm_loss(a, b)), atol=1e-6, rtol=0)


# ---- one batch --------------------------------------------------------------

@pytest.mark.parametrize("timesteps", [10, 12, 37, 1500])
def test_elbo_timesteps_match_jax(timesteps):
    np.testing.assert_array_equal(tl.elbo_timesteps(timesteps),
                                  jl.elbo_timesteps(timesteps))


@pytest.mark.parametrize("form", ["unfolded", "folded"])
def test_elbo_bpd_batch_matches_jax(tiny, form):
    jm, jv = _jax_model(tiny, form)
    x, c = _inputs()
    key = jax.random.PRNGKey(5)
    js = jax_make_schedule(T)
    want = jl.elbo_bpd_batch(jm, jv, js.beta, js.alpha_bar, x, c, key,
                             jnp.asarray(jl.elbo_timesteps(T)))
    noise = _elbo_noise(key)
    got = tl.elbo_bpd_batch(tiny[2][form], make_schedule(T), x, c, device="cpu",
                            noise_fn=lambda bi, k, t, shape: noise(k, shape))
    assert got.shape == (B,)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("weighting", ["nll", "elbo"])
@pytest.mark.parametrize("form", ["unfolded", "folded"])
def test_t_sweep_matches_jax(tiny, form, weighting):
    """The full sweep t = 1..T of ``nll_batch`` and of
    ``elbo_full_trajectory_batch``."""
    jm, jv = _jax_model(tiny, form)
    x, c = _inputs(seed=1)
    key = jax.random.PRNGKey(6)
    js = jax_make_schedule(T)
    jfn, tfn = {"nll": (jl.nll_batch, tl.nll_batch),
                "elbo": (jl.elbo_full_trajectory_batch,
                         tl.elbo_full_trajectory_batch)}[weighting]
    want = jfn(jm, jv, js.beta, js.alpha_bar, x, c, key)
    zs = _sweep_noise(key, T, x.shape)
    steps = []
    got = tfn(tiny[2][form], make_schedule(T), x, c, device="cpu",
              noise_fn=lambda bi, k, t, shape: steps.append(t) or zs[k])
    assert steps == list(range(1, T + 1))
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("weighting", ["nll", "elbo"])
def test_t_sweep_over_a_short_range_matches_jax(tiny, weighting):
    """``nll_batch`` and ``elbo_full_trajectory_batch`` over the first 4 of
    T = 1500 timesteps, against JAX's sweep body over the same range
    (``_t_sweep_chunk``; the full-trajectory form divides by T): the NLL's
    weight reaches 1/(2 b_1) = 4.4e3 there."""
    jm, jv = _jax_model(tiny, "folded")
    x, c = _inputs(seed=2)
    key = jax.random.PRNGKey(7)
    js = jax_make_schedule(1500)
    ts = np.arange(1, 5, dtype=np.int32)
    want, _ = jl._t_sweep_chunk(jm, jv, js.beta, js.alpha_bar, x, c,
                                jnp.zeros(B, jnp.float32), key, jnp.asarray(ts),
                                timesteps=1500, weighting=weighting)
    if weighting == "elbo":
        want = want / 1500
    zs = _sweep_noise(key, len(ts), x.shape)
    fn = {"nll": tl.nll_batch, "elbo": tl.elbo_full_trajectory_batch}[weighting]
    got = fn(tiny[2]["folded"], make_schedule(1500), x, c, ts=ts, device="cpu",
             noise_fn=lambda bi, k, t, shape: zs[k])
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("masked", [False, True])
def test_elbo_per_batch_matches_jax(masked):
    rs = np.random.RandomState(4)
    mse = rs.rand(6).astype(np.float32)
    t = np.array([1, 2, 5, 9, 12, 7])
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if masked else None
    js = jax_make_schedule(T)
    want = jl.elbo_per_batch(js.beta, js.alpha_bar, jnp.asarray(mse), jnp.asarray(t),
                             None if mask is None else jnp.asarray(mask))
    got = tl.elbo_per_batch(make_schedule(T), torch.tensor(mse), t,
                            None if mask is None else torch.tensor(mask))
    assert got.dim() == 0 and _rel(float(got), float(want)) <= REL


# ---- the dataset level ------------------------------------------------------

def _two_batches():
    """A full batch of 3 and a partial one of 2, padded to 3."""
    x, c = _inputs(n=5, seed=3)
    return [(x[:3], c[:3]), (x[3:], c[3:])]


@pytest.mark.parametrize("form", ["unfolded", "folded"])
def test_calculate_elbo_and_bpd_matches_jax(tiny, form):
    jm, jv = _jax_model(tiny, form)
    rng = jax.random.PRNGKey(9)
    batches = _two_batches()
    want = jl.calculate_elbo_and_bpd(jm, jv, jax_make_schedule(T), batches, rng,
                                     batch_size=B)
    noise = [_elbo_noise(k) for k in _batch_keys(rng, 2)]
    shapes = []
    got = tl.calculate_elbo_and_bpd(
        tiny[2][form], make_schedule(T), batches, batch_size=B, device="cpu",
        noise_fn=lambda bi, k, t, shape: shapes.append(shape) or noise[bi](k, shape))
    assert set(shapes) == {(B, H, H, 1)} and len(shapes) == 20
    assert _rel(got[0], want[0]) <= REL and _rel(got[1], want[1]) <= REL
    np.testing.assert_allclose(got[1], got[0] / (H * H * np.log(2.0)), rtol=1e-12)


@pytest.mark.parametrize("form", ["unfolded", "folded"])
def test_calculate_likelihood_matches_jax(tiny, form):
    jm, jv = _jax_model(tiny, form)
    rng = jax.random.PRNGKey(10)
    batches = _two_batches()
    want = jl.calculate_likelihood(jm, jv, jax_make_schedule(T), batches, rng,
                                   batch_size=B)
    zs = [_sweep_noise(k, T, (B, H, H, 1)) for k in _batch_keys(rng, 2)]
    got = tl.calculate_likelihood(tiny[2][form], make_schedule(T), batches,
                                  batch_size=B, device="cpu",
                                  noise_fn=lambda bi, k, t, shape: zs[bi][k])
    assert _rel(got, want) <= REL


def test_padding_leaves_the_real_rows_alone(tiny):
    """A partial batch padded to 3 gives its real rows the values they get
    unpadded, on the same noise rows."""
    x, c = _inputs(n=2, seed=5)
    g = np.random.RandomState(0).randn(3, H, H, 1).astype(np.float32)
    outs = [tl.calculate_elbo_and_bpd(tiny[2]["folded"], make_schedule(T), [(x, c)],
                                      batch_size=bs, device="cpu",
                                      noise_fn=lambda bi, k, t, shape: g[:shape[0]])
            for bs in (3, None)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)


# ---- full width ---------------------------------------------------------------

def test_elbo_bpd_batch_full_width_matches_jax():
    """The committed checkpoint (n_feat 128, 64x64), BN-folded in both
    packages, on 2 maps with the same noise: rel 1e-4."""
    variables = load_variables(CKPT)
    jm, jv = fold_inference(JaxContextUnet(), {"params": variables["params"],
                                               "batch_stats": variables["batch_stats"]})
    rs = np.random.RandomState(11)
    x = rs.randn(2, 64, 64, 1).astype(np.float32)
    c = rs.rand(2, 6).astype(np.float32)
    key = jax.random.PRNGKey(4242)
    js = jax_make_schedule(1500)
    want = jl.elbo_bpd_batch(jm, jv, js.beta, js.alpha_bar, x, c, key,
                             jnp.asarray(jl.elbo_timesteps(1500)))
    noise = _elbo_noise(key)
    got = tl.elbo_bpd_batch(load_model(variables, "cpu"), make_schedule(1500), x, c,
                            device="cpu", noise_fn=lambda bi, k, t, s: noise(k, s))
    assert _rel(got, want) <= REL


# ---- precision, checks, generator -----------------------------------------

def test_likelihood_runs_in_fp32_and_restores_the_flags(tiny, monkeypatch):
    """TF32 is off for cuDNN and cuBLAS while the model runs, and the
    caller's settings come back after."""
    model = tiny[2]["folded"]
    seen = []
    real_forward = type(model).forward

    def spy(self, *a, **k):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real_forward(self, *a, **k)

    monkeypatch.setattr(type(model), "forward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x, c = _inputs()
    tl.elbo_bpd_batch(model, make_schedule(T), x, c, torch.Generator(), device="cpu")
    tl.nll_batch(model, make_schedule(T), x, c, torch.Generator(), ts=[1, 2],
                 device="cpu")
    assert seen == [(False, False)] * 12
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_likelihood_checks_the_model(tiny):
    model = load_model(tiny[1], "cpu", fold_bn=False)
    x, c = _inputs()
    model.train()
    with pytest.raises(ValueError, match="eval mode"):
        tl.elbo_bpd_batch(model, make_schedule(T), x, c, torch.Generator(), device="cpu")
    model.eval()
    model.shortcut = "stochastic"
    with pytest.raises(NotImplementedError, match="stochastic"):
        tl.nll_batch(model, make_schedule(T), x, c, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="generator or a noise_fn"):
        tl.elbo_bpd_batch(tiny[2]["folded"], make_schedule(T), x, c, device="cpu")


def test_likelihood_draws_from_the_generator(tiny):
    model = tiny[2]["folded"]
    x, c = _inputs()
    outs = [tl.elbo_bpd_batch(model, make_schedule(T), x, c,
                              torch.Generator().manual_seed(s), device="cpu")
            for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert bool(torch.isfinite(outs[0]).all()) and bool((outs[0] > 0).all())
