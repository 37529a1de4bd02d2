"""PyTorch port: schedule, the ContextUnet and BatchNorm folding against the
JAX package, and the full-width forward against the JAX golden fixture."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.diffusion.schedule import (
    make_schedule as jax_make_schedule,
    p_sample_step as jax_p_sample_step,
)
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
import chip_smoke
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule, p_sample_step
from camels_diffusion_model_tpu_torch.models import blocks, context_unet
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "certification", "model", "train_state.msgpack")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")


@pytest.fixture(scope="module")
def tiny():
    """The jitted ``apply`` of a narrow ContextUnet (n_feat 8, 16x16) and
    its variables (numpy) with non-trivial BatchNorm running statistics."""
    model = JaxContextUnet(n_feat=8, n_cfeat=3, height=16, levels=2)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), np.zeros((2, 16, 16, 1), np.float32),
        np.array([0.5], np.float32),
    ))
    rs = np.random.RandomState(5)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (
            (rs.randn(*leaf.shape) * 0.1).astype(np.float32)
            if "mean" in jax.tree_util.keystr(path)
            else (rs.rand(*leaf.shape) + 0.5).astype(np.float32)
        ),
        variables["batch_stats"],
    )
    return jax.jit(model.apply), variables


def _inputs(seed, batch=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 16, 16, 1).astype(np.float32)
    t = rs.rand(batch).astype(np.float32)
    c = rs.rand(batch, 3).astype(np.float32)
    return x, t, c


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# ---- schedule ---------------------------------------------------------------

@pytest.mark.parametrize("field,max_ulp", [("beta", 2), ("alpha", 0), ("alpha_bar", 32)])
def test_schedule_matches_jax(field, max_ulp):
    """T=1500 in fp32, in units of the JAX value's ulp.  beta: linspace
    rounds one ulp apart, then one multiply-add; alpha: exact; alpha_bar =
    exp(cumsum(log a)) sums 1500 terms in another order than XLA's cumsum
    (measured 32 ulp, 2e-6 relative, at the smallest values)."""
    got = getattr(make_schedule(1500), field).numpy()
    want = np.asarray(getattr(jax_make_schedule(1500), field))
    assert got.dtype == want.dtype == np.float32 and got.shape == (1501,)
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= max_ulp
    assert got[0] == want[0] and (field != "alpha_bar" or got[0] == 1.0)


@pytest.mark.parametrize("t", [1, 2, 750, 1500])
def test_p_sample_step_matches_jax(t):
    rs = np.random.RandomState(t)
    x, eps, z = (rs.randn(2, 8, 8, 1).astype(np.float32) for _ in range(3))
    want = jax_p_sample_step(jax_make_schedule(1500), jnp.asarray(x), t,
                             jnp.asarray(eps), jnp.asarray(z))
    got = p_sample_step(make_schedule(1500), torch.tensor(x), t,
                        torch.tensor(eps), torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---- model ------------------------------------------------------------------

@pytest.mark.parametrize("fold_bn", [False, True])
@pytest.mark.parametrize("context", ["given", "zeros", "none"])
def test_tiny_forward_matches_jax(tiny, fold_bn, context):
    """fp32 forward on the same weights, <= 1e-5 relative to max |eps|."""
    apply, variables = tiny
    x, t, c = _inputs(1)
    c_j = {"given": c, "zeros": np.zeros_like(c), "none": None}[context]
    want = np.asarray(apply(variables, x, t, c_j))
    port = load_model(variables, "cpu", fold_bn=fold_bn)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t),
                   None if c_j is None else torch.tensor(c_j)).numpy()
    assert got.shape == want.shape == (3, 16, 16, 1)
    assert _rel_err(got, want) <= 1e-5


def test_scalar_time_broadcasts_like_jax(tiny):
    apply, variables = tiny
    x, _, c = _inputs(2)
    t = np.array([0.37], np.float32)
    want = np.asarray(apply(variables, x, t, c))
    with torch.no_grad():
        got = load_model(variables, "cpu")(torch.tensor(x), torch.tensor(t), torch.tensor(c))
    assert _rel_err(got.numpy(), want) <= 1e-5


def test_encode_decode_equals_forward_and_film_rows_equal_inline(tiny):
    _, variables = tiny
    port = load_model(variables, "cpu")
    x, t, c = (torch.tensor(a) for a in _inputs(3))
    with torch.no_grad():
        full = port(x, t, c)
        enc = port.encode(x)
        assert torch.equal(port.decode(enc, t, c), full)
        cemb1, cemb2 = port.context_embed(c)
        temb1, temb2 = port.time_embed(t)
        via_film = port.decode(enc, film=(cemb1, temb1, cemb2, temb2))
        torch.testing.assert_close(via_film, full, rtol=0, atol=1e-6)
        # Guided form: encoder once, decoder on [cond, uncond].
        uncond = port(x, t, torch.zeros_like(c))
        c2 = torch.cat([c, torch.zeros_like(c)])
        cemb1, cemb2 = port.context_embed(c2)
        temb1, temb2 = port.time_embed(torch.cat([t, t]))
        pair = port.decode(enc.doubled(), film=(cemb1, temb1, cemb2, temb2))
        torch.testing.assert_close(pair, torch.cat([full, uncond]), rtol=0, atol=1e-6)


def test_decoder_runs_film_stage_0_as_the_groupnorm_epilogue(tiny, monkeypatch):
    """One decoder call: K2 at up0_norm with the stage-0 FiLM rows, K2 at
    out_norm without, K3 once (stage 1): ``chip_smoke.LAUNCHES_PER_STEP``
    less the step kernel."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, args))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(blocks, "fused_groupnorm_act", spy("groupnorm_act", blocks.fused_groupnorm_act))
    monkeypatch.setattr(context_unet, "fused_film", spy("film", context_unet.fused_film))
    _, variables = tiny
    port = load_model(variables, "cpu")
    x, t, c = (torch.tensor(a) for a in _inputs(6))
    with torch.no_grad():
        cemb1, _ = port.context_embed(c)
        temb1, _ = port.time_embed(t)
        port(x, t, c)
    names = [name for name, _ in calls]
    assert {n: names.count(n) for n in set(names)} == {
        k: v for k, v in chip_smoke.LAUNCHES_PER_STEP.items() if k != "head_step"}
    up0, out = [args for name, args in calls if name == "groupnorm_act"]
    assert up0[0].shape == (3, 4, 4, 16) and out[6] is None
    assert torch.equal(up0[6][0], cemb1) and torch.equal(up0[6][1], temb1)


def test_decode_is_out_conv2_of_decode_features(tiny):
    """``decode`` = ``out_conv2`` of ``decode_features`` (bitwise), whose
    output is out_norm's, channels_last, and what the samplers hand the
    step kernel."""
    _, variables = tiny
    port = load_model(variables, "cpu")
    x, t, c = (torch.tensor(a) for a in _inputs(7))
    with torch.no_grad():
        enc = port.encode(x)
        feats = port.decode_features(enc, t, c)
        assert feats.shape == (3, port.n_feat, 16, 16)
        assert feats.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(port.decode(enc, t, c), blocks.to_nhwc(port.out_conv2(feats)))
        assert torch.equal(port(x, t, c), port.decode(enc, t, c))


def test_folded_equals_unfolded(tiny):
    _, variables = tiny
    x, t, c = (torch.tensor(a) for a in _inputs(4))
    with torch.no_grad():
        a = load_model(variables, "cpu", fold_bn=False)(x, t, c)
        b = load_model(variables, "cpu", fold_bn=True)(x, t, c)
    assert _rel_err(b.numpy(), a.numpy()) <= 1e-5
    folded = load_model(variables, "cpu", fold_bn=True)
    assert not any("_bn" in name for name, _ in folded.named_modules())


def test_model_activations_stay_channels_last(tiny):
    _, variables = tiny
    port = load_model(variables, "cpu")
    x, _, _ = _inputs(5)
    with torch.no_grad():
        enc = port.encode(torch.tensor(x))
    assert enc.x0.is_contiguous(memory_format=torch.channels_last)
    assert all(d.is_contiguous(memory_format=torch.channels_last) for d in enc.downs)


# ---- full width on the committed checkpoint ---------------------------------

@pytest.fixture(scope="module")
def serving_model():
    return load_model(load_variables(CKPT), "cpu")


@pytest.mark.parametrize("which", ["eps", "eps_uncond", "cfg_pair"])
def test_full_width_forward_matches_golden(serving_model, which):
    """The folded serving model at n_feat 128, 64x64 on the CPU vs the JAX
    ``ContextUnet.apply`` eps in the fixture: <= 1e-4 abs (|eps| <= ~4)."""
    d = np.load(GOLDEN)
    x, t, c = (torch.tensor(d[k]) for k in ("x", "t", "c"))
    m = serving_model
    with torch.no_grad():
        if which == "eps":
            got, want = m(x, t, c), d["eps"]
        elif which == "eps_uncond":
            got, want = m(x, t, torch.zeros_like(c)), d["eps_uncond"]
        else:
            cemb1, cemb2 = m.context_embed(torch.cat([c, torch.zeros_like(c)]))
            temb1, temb2 = m.time_embed(torch.cat([t, t]))
            got = m.decode(m.encode(x).doubled(), film=(cemb1, temb1, cemb2, temb2))
            want = np.concatenate([d["eps"], d["eps_uncond"]])
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4
