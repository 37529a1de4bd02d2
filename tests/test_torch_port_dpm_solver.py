"""PyTorch port: DPM-Solver++(2M) (``diffusion/dpm_solver.py``) against the
JAX package's ``sample_dpm2m`` on the CPU.

The narrow model (n_feat 8, 16x16, n_cfeat 3) from the JAX ``model.init``
with non-trivial BatchNorm running statistics, folded, at T 20 over 6
strided steps; both samplers start from the same x_init and contexts.  The
solver draws no noise, so fp32 cases are held at 1e-5 abs on maps of |x|
~ 1-4.  A stochastic-shortcut model takes JAX's projection draws, recorded
from an eager JAX ``encode`` of each step's ``"shortcut"`` key
(``dpm_solver.py:64-69``: ``key, skey = split(key)``).  The bf16 case
holds the port's bf16 within 2x JAX's own bf16-vs-fp32 distance, the
yardstick of ``tests/test_torch_port_bf16.py``.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.diffusion.dpm_solver import sample_dpm2m as jax_sample_dpm2m
from camels_diffusion_model_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.models.fold_bn import fold_inference
from camels_diffusion_model_tpu.ops.pallas import groupnorm as jax_pallas_groupnorm
from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps
from camels_diffusion_model_tpu_torch.diffusion.dpm_solver import (
    dpm2m_coefficients,
    sample_dpm2m,
)
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.serving import load_model

H, NC, B, T, STEPS = 16, 3, 3, 20, 6
TOL = 1e-5
GUIDES = {"deterministic_w0": 0.0, "cfg_w2": 2.0,
          "per_sample_w": np.array([1.5, 3.0, 0.5], np.float32)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(model, seed):
    variables = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed), "shortcut": jax.random.PRNGKey(seed + 1)},
        np.zeros((1, H, H, 1), np.float32), np.array([0.5], np.float32)))
    rs = np.random.RandomState(seed)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((rs.randn(*leaf.shape) * 0.1).astype(np.float32)
                            if "mean" in jax.tree_util.keystr(path)
                            else (rs.rand(*leaf.shape) + 0.5).astype(np.float32)),
        variables["batch_stats"])
    return variables


@pytest.fixture(scope="module", params=["learned", "stochastic"])
def tiny(request):
    model = JaxContextUnet(n_feat=8, n_cfeat=NC, height=H, levels=2, shortcut=request.param)
    variables = _variables(model, 11)
    return (*fold_inference(model, variables), load_model(variables, "cpu"))


def _inputs(seed=3):
    rs = np.random.RandomState(seed)
    return rs.randn(B, H, H, 1).astype(np.float32), rs.rand(B, NC).astype(np.float32)


@contextlib.contextmanager
def _recorded_uniform(seen):
    """``jax.random.uniform`` with its concrete results appended to
    ``seen`` (flax also traces its initialisers abstractly in ``apply``)."""
    orig = jax.random.uniform

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        if not isinstance(out, jax.core.Tracer):
            seen.append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", spy)
        yield


def _jax_draws(model, variables, rng, n_steps):
    """Each step's projection, as the JAX solver draws it from ``rng``, in
    the port's layout ``(kernel (O, I, 1, 1), bias (O,))``."""
    key = jax.random.split(rng, 3)[0]
    draws = []
    for _ in range(n_steps):
        key, skey = jax.random.split(key)
        seen = []
        with _recorded_uniform(seen):
            model.apply(variables, np.zeros((1, H, H, 1), np.float32), method="encode",
                        rngs={"shortcut": skey})
        kernel, bias = seen
        draws.append((torch.tensor(kernel.transpose(3, 2, 0, 1)), torch.tensor(bias)))
    return draws


@pytest.mark.parametrize("guide", sorted(GUIDES))
def test_dpm2m_matches_jax(tiny, guide):
    """Deterministic (w 0), CFG (w 2: the encoder once, the decoder on the
    doubled batch) and per-sample w; a stochastic model with JAX's draws."""
    jm, jv, port = tiny
    x0, params = _inputs()
    rng = jax.random.PRNGKey(5)
    w = GUIDES[guide]
    want = np.asarray(jax_sample_dpm2m(jm, jv, jax_make_schedule(T), rng, params=params,
                                       guide_w=w, n_steps=STEPS, x_init=jnp.asarray(x0)).x)
    asked, shortcut_fn = [], None
    if port.stochastic:
        draws = _jax_draws(jm, jv, rng, STEPS)

        def shortcut_fn(k, t):
            asked.append((k, t))
            return draws[k]
    got = sample_dpm2m(port, make_schedule(T), torch.Generator(), params=params, guide_w=w,
                       n_steps=STEPS, x_init=x0, device="cpu",
                       shortcut_fn=shortcut_fn).numpy()
    assert got.shape == want.shape == (B, H, H, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    taus = ddim_timesteps(T, STEPS)[::-1]
    assert asked == ([(k, int(t)) for k, t in enumerate(taus)] if port.stochastic else [])


@pytest.mark.parametrize("guide_w,match", [
    (np.array([1.0, -1.0, 2.0], np.float32), "all-positive"),
    (np.array([1.0, 2.0], np.float32), "must match the batch size"),
])
def test_dpm2m_rejects_bad_per_sample_w_as_jax_does(tiny, guide_w, match):
    jm, jv, port = tiny
    x0, params = _inputs()
    with pytest.raises(ValueError, match=match):
        jax_sample_dpm2m(jm, jv, jax_make_schedule(T), jax.random.PRNGKey(0), params=params,
                         guide_w=guide_w, n_steps=STEPS, x_init=jnp.asarray(x0))
    with pytest.raises(ValueError, match=match):
        sample_dpm2m(port, make_schedule(T), torch.Generator(), params=params,
                     guide_w=guide_w, n_steps=STEPS, x_init=x0, device="cpu")


def test_dpm2m_coefficients_follow_the_log_snr_steps():
    """Each step's scalars against float64 from the schedule: fp32 within
    1e-5 relative; the first step's and the final jump's flags."""
    schedule = make_schedule(T)
    taus = ddim_timesteps(T, STEPS)
    rows = dpm2m_coefficients(schedule, taus)
    ab = schedule.alpha_bar.double().numpy()
    lam = 0.5 * (np.log(ab[1:]) - np.log1p(-ab[1:]))
    t_seq = [int(t) for t in taus[::-1]]
    assert [r[0] for r in rows] == t_seq and [r[-1] for r in rows] == [False] * 5 + [True]
    h_last = 1.0
    for (t, s_eps, inv, c_x0, c_last, sig, c_d, last), t_prev in zip(rows, t_seq[1:] + [0]):
        tp = max(t_prev, 1)
        h = lam[tp - 1] - lam[t - 1]
        want = (np.sqrt(1 - ab[t]), 1 / np.sqrt(ab[t]), 1 + h / (2 * h_last),
                h / (2 * h_last), np.sqrt((1 - ab[tp]) / (1 - ab[t])),
                np.sqrt(ab[tp]) * np.expm1(-h))
        np.testing.assert_allclose((s_eps, inv, c_x0, c_last, sig, c_d), want, rtol=1e-5)
        h_last = h


def test_dpm2m_draws_from_the_generator_and_is_deterministic_given_x_init(tiny):
    """Without x_init and params the generator draws both (x_init first):
    the same seed gives the same maps; given x_init, the maps do not depend
    on the generator but for a stochastic model's draws."""
    _, _, port = tiny
    s = make_schedule(T)
    a, b = (sample_dpm2m(port, s, torch.Generator().manual_seed(3), n_sample=B, size=H,
                         guide_w=2.0, n_steps=STEPS, device="cpu") for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((B, H, H, 1), generator=g)
    params = torch.rand((B, NC), generator=g)
    replay = sample_dpm2m(port, s, g, params=params, guide_w=2.0, n_steps=STEPS, x_init=x0,
                          device="cpu")
    torch.testing.assert_close(replay, a, rtol=0, atol=0)
    if not port.stochastic:
        other = sample_dpm2m(port, s, torch.Generator().manual_seed(99), params=params,
                             guide_w=2.0, n_steps=STEPS, x_init=x0, device="cpu")
        torch.testing.assert_close(other, a, rtol=0, atol=0)


def test_dpm2m_with_a_bf16_model_matches_jax_bf16(monkeypatch):
    """The folded canonical model in bf16 (eps bf16, the state fp32), w 2:
    within 2x the max-abs distance of JAX's bf16 from its fp32 of JAX's
    bf16 (``tests/test_torch_port_bf16.py``'s yardstick).  JAX's models take
    the Pallas GroupNorm (interpret mode here), which applies the
    activation before rounding, as the port's kernel path does."""
    monkeypatch.setattr(jax_pallas_groupnorm, "fused_groupnorm_act", functools.partial(
        jax_pallas_groupnorm.fused_groupnorm_act, interpret=True))
    model = JaxContextUnet(n_feat=16, n_cfeat=NC, height=H, levels=2)
    variables = _variables(model, 21)
    x0, params = _inputs(seed=6)
    rng = jax.random.PRNGKey(7)
    want = [np.asarray(jax_sample_dpm2m(*fold_inference(model.clone(dtype=d, pallas_gn=True),
                                                        variables),
                                        jax_make_schedule(T), rng, params=params,
                                        guide_w=2.0, n_steps=STEPS,
                                        x_init=jnp.asarray(x0)).x)
            for d in (jnp.bfloat16, jnp.float32)]
    got = sample_dpm2m(load_model(variables, "cpu", dtype=torch.bfloat16), make_schedule(T),
                       torch.Generator(), params=params, guide_w=2.0, n_steps=STEPS,
                       x_init=x0, device="cpu")
    assert got.dtype == torch.float32
    yard = np.abs(want[0] - want[1]).max()
    assert 0 < yard and np.abs(got.numpy() - want[0]).max() <= 2 * yard
