"""PyTorch port: the reference's stochastic init_conv shortcut (a fresh
random 1x1 projection each forward, ``diffusion_utilities.py:54``) against
the JAX package's ``shortcut="stochastic"`` on the CPU.

Each check replays JAX's key chain on the host and injects both JAX's
noise and JAX's projection draws: the draws of a ``"shortcut"`` key are
recorded from an eager JAX ``encode`` (:func:`jax_draws`), and go in
through the port's ``shortcut_fn`` / ``shortcut=`` hooks as ``z`` goes in
through ``z_fn``.  Tolerances are the port's existing ones for the same
functions: samplers 1e-4 abs (``test_torch_port_eval.py``), likelihoods
1e-5 relative (``test_torch_port_likelihood.py``), the train step's loss
1e-5 and gradients 1e-4 / 1e-6 (``test_torch_port_training.py``), the
init_conv block 1e-5 of its largest value in fp32 and, in bf16, 2x JAX's
own bf16-vs-fp32 distance (``test_torch_port_bf16.py``'s yardstick)."""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.cli.experiment import run_experiment as jax_run_experiment
from camels_diffusion_model_tpu.config import ExperimentConfig as JaxExperimentConfig
from camels_diffusion_model_tpu.diffusion import likelihood as jl
from camels_diffusion_model_tpu.diffusion.ddim import sample_ddim as jax_sample_ddim
from camels_diffusion_model_tpu.diffusion.sampler import sample_ddpm as jax_sample_ddpm
from camels_diffusion_model_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.models import blocks as jax_blocks
from camels_diffusion_model_tpu.models.fold_bn import fold_inference
from camels_diffusion_model_tpu.training import make_train_step as jax_make_train_step
from camels_diffusion_model_tpu.training.trainer import _noise_coeff
from camels_diffusion_model_tpu.training.trainer import masked_mean as jax_masked_mean
from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.diffusion import likelihood as tl
from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.models.blocks import to_nhwc
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training import trainer
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

H, NC, B = 16, 3, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(dtype=jnp.float32):
    return JaxContextUnet(n_feat=8, n_cfeat=NC, height=H, levels=2, shortcut="stochastic",
                          dtype=dtype)


@pytest.fixture(scope="module")
def tiny():
    """The stochastic JAX model (no ``init_conv/shortcut`` leaves) with
    non-trivial running statistics."""
    model = _jax_model()
    variables = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(11), "shortcut": jax.random.PRNGKey(12)},
        np.zeros((1, H, H, 1), np.float32), np.array([0.5], np.float32)))
    rs = np.random.RandomState(8)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((rs.randn(*leaf.shape) * 0.1).astype(np.float32)
                            if "mean" in jax.tree_util.keystr(path)
                            else (rs.rand(*leaf.shape) + 0.5).astype(np.float32)),
        variables["batch_stats"])
    assert "shortcut" not in variables["params"]["init_conv"]
    return model, variables


@contextlib.contextmanager
def recorded_draws(seen):
    """``jax.random.uniform`` with its concrete results appended to
    ``seen``: the stochastic block's kernel, then its bias (flax also
    traces its parameters' initialisers abstractly in ``apply``)."""
    orig = jax.random.uniform

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        if not isinstance(out, jax.core.Tracer):
            seen.append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", spy)
        yield


@contextlib.contextmanager
def injected_draws(draws):
    """``jax.random.uniform`` returning the port-layout ``draws`` (kernel,
    then bias) in the dtype asked for: a float64 run of the JAX model would
    draw other values (64 random bits an element)."""
    orig = jax.random.uniform
    queue = [np.asarray(draws[0]).transpose(2, 3, 1, 0), np.asarray(draws[1])]

    def inject(*args, **kwargs):
        out = orig(*args, **kwargs)
        if isinstance(out, jax.core.Tracer):  # an initialiser traced by flax
            return out
        value = queue.pop(0)
        assert value.shape == out.shape
        return jnp.asarray(value, out.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", inject)
        yield queue


def jax_draws(model, variables, skey):
    """The projection JAX's model draws from the ``"shortcut"`` key
    ``skey``, in the port's layout: ``(kernel (O, I, 1, 1), bias (O,))``."""
    seen = []
    with recorded_draws(seen):
        model.apply(variables, np.zeros((1, H, H, 1), np.float32), method="encode",
                    rngs={"shortcut": skey})
    kernel, bias = seen
    return torch.tensor(kernel.transpose(3, 2, 0, 1)), torch.tensor(bias)


def _chain(key, n):
    """``key, zkey, skey = split(key, 3)`` a step: the zkeys and skeys."""
    out = []
    for _ in range(n):
        key, zkey, skey = jax.random.split(key, 3)
        out.append((zkey, skey))
    return out


def _inputs(seed=3, n=B):
    rs = np.random.RandomState(seed)
    return rs.randn(n, H, H, 1).astype(np.float32), rs.rand(n, NC).astype(np.float32)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---- the block -------------------------------------------------------------------

def test_draw_is_torch_conv_init_and_follows_the_generator():
    model = ContextUnet(n_feat=8, n_cfeat=NC, height=H, shortcut="stochastic")
    assert not hasattr(model.init_conv, "shortcut") and model.stochastic
    assert not any("shortcut" in name for name in model.state_dict())
    k1, b1 = model.draw_shortcut(torch.Generator().manual_seed(0))
    k2, b2 = model.draw_shortcut(torch.Generator().manual_seed(0))
    assert k1.shape == (8, 1, 1, 1) and b1.shape == (8,) and k1.dtype == torch.float32
    assert torch.equal(k1, k2) and torch.equal(b1, b2)
    assert float(k1.abs().max()) <= 1.0 and float(k1.std()) > 0.1
    x = torch.randn(2, H, H, 1)
    with torch.no_grad():
        a = model.encode(x, shortcut=(k1, b1)).x0
        c = model.encode(x, shortcut=model.draw_shortcut(torch.Generator().manual_seed(1))).x0
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="needs its draw"):
        model.encode(x)
    with pytest.raises(ValueError, match="takes no shortcut"):
        ContextUnet(n_feat=8, n_cfeat=NC, height=H).encode(x, shortcut=(k1, b1))
    with pytest.raises(ValueError, match="unknown shortcut"):
        ContextUnet(n_feat=8, n_cfeat=NC, height=H, shortcut="fixed")


def test_load_model_reads_the_mode_from_the_tree(tiny):
    _, variables = tiny
    assert load_model(variables, "cpu").stochastic
    assert load_model(variables, "cpu", fold_bn=False).stochastic
    learned = JaxContextUnet(n_feat=8, n_cfeat=NC, height=H, levels=2)
    lv = jax.device_get(learned.init(jax.random.PRNGKey(0), np.zeros((1, H, H, 1), np.float32),
                                     np.array([0.5], np.float32)))
    assert not load_model(lv, "cpu").stochastic


@pytest.mark.parametrize("fold_bn", [False, True])
def test_init_conv_matches_jax_fp32(tiny, fold_bn):
    """init_conv's output (the encoder's x0) and the whole forward on the
    same draws: <= 1e-5 of the largest value."""
    model, variables = tiny
    x, c = _inputs()
    t = np.array([0.3], np.float32)
    skey = jax.random.PRNGKey(5)
    jm, jv = fold_inference(model, variables) if fold_bn else (model, variables)
    want_x0 = np.asarray(jm.apply(jv, x, method="encode", rngs={"shortcut": skey}).x0)
    want_eps = np.asarray(jm.apply(jv, x, t, c, rngs={"shortcut": skey}))
    draws = jax_draws(model, variables, skey)
    port = load_model(variables, "cpu", fold_bn=fold_bn)
    with torch.no_grad():
        got_x0 = to_nhwc(port.encode(torch.tensor(x), shortcut=draws).x0).numpy()
        got_eps = port(torch.tensor(x), torch.tensor(t), torch.tensor(c), shortcut=draws).numpy()
    assert _max_rel(got_x0, want_x0) <= 1e-5
    assert _max_rel(got_eps, want_eps) <= 1e-5


def test_init_conv_matches_jax_bf16(tiny):
    """The projection cast to bf16 with x, as JAX casts its draws: the
    port's bf16 x0 within 2x JAX's own bf16-vs-fp32 distance."""
    model, variables = tiny
    x, _ = _inputs(seed=4)
    skey = jax.random.PRNGKey(6)
    draws = jax_draws(model, variables, skey)
    want32 = np.asarray(model.apply(variables, x, method="encode", rngs={"shortcut": skey}).x0,
                        np.float32)
    want16 = np.asarray(_jax_model(jnp.bfloat16).apply(
        variables, x, method="encode", rngs={"shortcut": skey}).x0.astype(jnp.float32))
    yardstick = np.abs(want16 - want32).max()
    assert yardstick > 0
    port = load_model(variables, "cpu", fold_bn=False, dtype=torch.bfloat16)
    with torch.no_grad():
        got = to_nhwc(port.encode(torch.tensor(x), shortcut=draws).x0).float().numpy()
    assert np.abs(got - want16).max() <= 2 * yardstick


# ---- samplers -----------------------------------------------------------------

@pytest.mark.parametrize("guide_w", [0.0, 2.0])
def test_four_exact_chain_steps_match_jax(tiny, guide_w):
    """``sample_ddpm`` at T 4 from the same x_init and params, the same z
    and projection draws each step (one draw shared by CFG's halves):
    atol 1e-4."""
    model, variables = tiny
    x0, params = _inputs(seed=7)
    rng = jax.random.PRNGKey(13)
    T = 4
    want = np.asarray(jax_sample_ddpm(model, variables, jax_make_schedule(T), rng, n_sample=B,
                                      size=H, params=params, guide_w=guide_w,
                                      x_init=jnp.asarray(x0)).x)
    keys = _chain(jax.random.split(rng, 3)[0], T)
    zs = [np.asarray(jax.random.normal(zk, x0.shape, jnp.float32)) for zk, _ in keys]
    draws = [jax_draws(model, variables, sk) for _, sk in keys]
    asked = []
    got = sample_ddpm(load_model(variables, "cpu"), make_schedule(T), torch.Generator(),
                      params=params, guide_w=guide_w, x_init=x0, device="cpu",
                      z_fn=lambda k, t: torch.tensor(zs[k]),
                      shortcut_fn=lambda k, t: asked.append((k, t)) or draws[k]).numpy()
    assert asked == [(k, T - k) for k in range(T)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("guide_w", [0.0, 2.0])
def test_four_strided_ddpm_steps_match_jax(tiny, guide_w):
    """The certified sampler's mode (``sigma_mode="beta"``) over four
    strided steps of T 20: atol 1e-4."""
    model, variables = tiny
    x0, params = _inputs(seed=8)
    rng = jax.random.PRNGKey(17)
    T = 20
    taus = ddim_timesteps(T, 4)
    want = np.asarray(jax_sample_ddim(model, variables, jax_make_schedule(T), rng, n_sample=B,
                                      size=H, params=params, guide_w=guide_w,
                                      x_init=jnp.asarray(x0), taus=taus,
                                      sigma_mode="beta").x)
    keys = _chain(jax.random.split(rng, 3)[0], len(taus))
    zs = [np.asarray(jax.random.normal(zk, x0.shape, jnp.float32)) for zk, _ in keys]
    draws = [jax_draws(model, variables, sk) for _, sk in keys]
    got = sample_ddim(load_model(variables, "cpu"), make_schedule(T), torch.Generator(),
                      params=params, guide_w=guide_w, x_init=x0, taus=taus, sigma_mode="beta",
                      device="cpu", z_fn=lambda k, t: torch.tensor(zs[k]),
                      shortcut_fn=lambda k, t: draws[k]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_sampler_draws_the_projection_each_step_from_the_generator(tiny):
    """Without ``shortcut_fn`` the draw of each step comes from the
    generator, before that step's z: a replay of the generator's stream
    in that order gives the same maps."""
    _, variables = tiny
    port = load_model(variables, "cpu")
    x0, params = _inputs(seed=9)
    T = 3
    got = sample_ddpm(port, make_schedule(T), torch.Generator().manual_seed(4), params=params,
                      guide_w=2.0, x_init=x0, device="cpu")
    g = torch.Generator().manual_seed(4)
    draws, zs = [], []
    for t in range(T, 0, -1):
        draws.append(port.draw_shortcut(g))
        zs.append(torch.randn((B, H, H, 1), generator=g) if t > 1 else None)
    replay = sample_ddpm(port, make_schedule(T), torch.Generator(), params=params, guide_w=2.0,
                         x_init=x0, device="cpu", z_fn=lambda k, t: zs[k],
                         shortcut_fn=lambda k, t: draws[k])
    torch.testing.assert_close(got, replay, rtol=0, atol=0)


# ---- likelihood -----------------------------------------------------------------

@pytest.mark.parametrize("fold_bn", [False, True])
def test_elbo_and_bpd_match_jax(tiny, fold_bn):
    """``calculate_elbo_and_bpd`` of one batch (the dataset level's
    ``rng, key = split(rng)``, then ``split(key, 10)`` and ``nkey, skey``
    a timestep): rel 1e-5."""
    model, variables = tiny
    jm, jv = fold_inference(model, variables) if fold_bn else (model, variables)
    x, c = _inputs(seed=10, n=3)
    T = 20
    rng = jax.random.PRNGKey(23)
    want_elbo, want_bpd = jl.calculate_elbo_and_bpd(jm, jv, jax_make_schedule(T), [(x, c)], rng)
    _, key = jax.random.split(rng)
    keys = [jax.random.split(k) for k in jax.random.split(key, 10)]
    noise = [np.asarray(jax.random.normal(nk, x.shape, jnp.float32)) for nk, _ in keys]
    draws = [jax_draws(model, variables, sk) for _, sk in keys]
    port = load_model(variables, "cpu", fold_bn=fold_bn)
    elbo, bpd = tl.calculate_elbo_and_bpd(
        port, make_schedule(T), [(x, c)], device="cpu",
        noise_fn=lambda bi, k, t, shape: noise[k],
        shortcut_fn=lambda bi, k, t: draws[k])
    assert abs(elbo - float(want_elbo)) <= 1e-5 * abs(float(want_elbo))
    assert abs(bpd - float(want_bpd)) <= 1e-5 * abs(float(want_bpd))


def test_nll_sweep_matches_jax(tiny):
    """The t-sweep (``key, nkey, skey = split(key, 3)`` a timestep) over
    T 6: rel 1e-5."""
    model, variables = tiny
    x, c = _inputs(seed=11)
    T = 6
    rng = jax.random.PRNGKey(29)
    want = jl.calculate_likelihood(model, variables, jax_make_schedule(T), [(x, c)], rng)
    _, key = jax.random.split(rng)
    keys = _chain(key, T)
    noise = [np.asarray(jax.random.normal(nk, x.shape, jnp.float32)) for nk, _ in keys]
    draws = [jax_draws(model, variables, sk) for _, sk in keys]
    got = tl.calculate_likelihood(load_model(variables, "cpu", fold_bn=False), make_schedule(T),
                                  [(x, c)], device="cpu",
                                  noise_fn=lambda bi, k, t, shape: noise[k],
                                  shortcut_fn=lambda bi, k, t: draws[k])
    assert abs(got - float(want)) <= 1e-5 * abs(float(want))


def test_likelihood_draws_from_the_generator(tiny):
    port = load_model(tiny[1], "cpu")
    x, c = _inputs(seed=12)
    outs = [tl.elbo_bpd_batch(port, make_schedule(10), x, c, torch.Generator().manual_seed(s),
                              device="cpu") for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert bool(torch.isfinite(outs[0]).all())


# ---- training ------------------------------------------------------------------

class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64`` (as
    ``test_torch_port_training.py``)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_one_train_step_loss_and_gradients_match_jax(tiny):
    """One step on the draws of its ``skey``, put into both packages.  The
    JAX side computes in float64 (``test_torch_port_training.py``).  The
    port's fp32 step: loss rtol 1e-5.  Its gradients are held in float64
    (the model's training forward on the same perturbed maps), every leaf
    within 1e-6 of its largest value, or 1e-7 abs for the biases whose
    gradient is zero up to rounding (ahead of a norm; the port's plain
    GroupNorm keeps fp32 statistics in a float64 copy): in fp32 the encoder's gradients sit 3e-3 from
    float64 here in either package, as flax's BatchNorm variance
    ``E[x^2] - E[x]^2`` (which the port keeps) cancels on the offsets the
    random projection adds (its bias is uniform in +-1)."""
    model, variables = tiny
    T, n = 8, 6
    rs = np.random.RandomState(3)
    x = rs.rand(n, H, H, 1).astype(np.float32)
    c = rs.rand(n, NC).astype(np.float32)
    tkey, nkey, skey = jax.random.split(jax.random.PRNGKey(7), 3)
    t = np.asarray(jax.random.randint(tkey, (n,), 1, T + 1))
    noise = np.asarray(jax.random.normal(nkey, x.shape, jnp.float32))
    draws = jax_draws(model, variables, skey)
    ab = jax_make_schedule(T).alpha_bar[t][:, None, None, None]
    x_pert = np.asarray(jnp.sqrt(ab) * x + _noise_coeff(ab, "reference") * noise)
    t_norm = np.asarray((t / T).astype(jnp.float32))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            injected_draws(draws) as queue:
        mp.setattr(jax_blocks, "jnp", _Float64Numpy())
        m64 = _jax_model(jnp.float64)

        def loss_fn(params, batch_stats):
            out, _ = m64.apply({"params": params, "batch_stats": batch_stats}, x_pert, t_norm,
                               c, train=True, mutable=["batch_stats"], rngs={"shortcut": skey})
            per_sample = jnp.mean(jnp.square(out - noise), axis=(1, 2, 3))
            return jax_masked_mean(per_sample, None)[1]

        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        loss, grads = jax.value_and_grad(loss_fn)(v["params"], v["batch_stats"])
        loss, grads = float(loss), jax.device_get(grads)
    assert not queue  # the one forward took both draws

    port = ContextUnet(n_feat=8, n_cfeat=NC, height=H, shortcut="stochastic")
    port.load_state_dict(from_jax_variables(variables))
    state = trainer.create_train_state(port, 1e-3, 4, 2)
    m = trainer.make_train_step(port, T)(state, x, c, t=torch.tensor(t),
                                         noise=torch.tensor(noise), shortcut=draws)
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)

    p64 = ContextUnet(n_feat=8, n_cfeat=NC, height=H, shortcut="stochastic")
    p64.load_state_dict(from_jax_variables(variables))
    p64 = p64.double()
    out = p64(torch.tensor(x_pert).double(), torch.tensor(t_norm).double(),
              torch.tensor(c).double(), train=True, shortcut=tuple(d.double() for d in draws))
    loss64 = torch.mean(torch.square(out - torch.tensor(noise).double()))
    loss64.backward()
    np.testing.assert_allclose(float(loss64.detach()), loss, rtol=1e-7)
    got = dict(_leaves(to_jax_variables({k: p.grad for k, p in p64.named_parameters()})["params"]))
    want = dict(_leaves(grads))
    assert set(got) == set(want)
    for name, value in want.items():
        err = np.abs(got[name] - value).max()
        assert err <= 1e-6 * np.abs(value).max() or err <= 1e-7, (name, err)


def test_rematerialised_step_takes_the_same_draw(tiny):
    """``remat`` runs the forward again in the backward pass: with the
    draw as an argument of the checkpointed forward the gradients are the
    step's without remat (atol 1e-6), whether the draw is given or comes
    from the step's generator."""
    _, variables = tiny
    x, c = _inputs(seed=14, n=4)
    grads = {}
    for remat in (False, True, "convs"):
        port = ContextUnet(n_feat=8, n_cfeat=NC, height=H, shortcut="stochastic")
        port.load_state_dict(from_jax_variables(variables))
        state = trainer.create_train_state(port, 1e-3, 4, 2, seed=3)
        trainer.make_train_step(port, 8, remat=remat)(state, np.abs(x), c)
        grads[remat] = [p.grad.clone() for p in port.parameters()]
    for remat in (True, "convs"):
        for a, b in zip(grads[remat], grads[False]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def test_train_step_draws_after_t_and_noise():
    """The step's generator ``(seed, 0, step)`` draws t, the noise, then
    the projection; a step given all three draws nothing."""
    torch.manual_seed(0)
    port = ContextUnet(n_feat=8, n_cfeat=NC, height=H, shortcut="stochastic")
    x, c = _inputs(seed=13, n=4)
    x = np.abs(x)
    ref = [p.detach().clone() for p in port.parameters()]

    def run(**kw):
        with torch.no_grad():
            for p, r in zip(port.parameters(), ref):
                p.copy_(r)
        state = trainer.create_train_state(port, 1e-3, 4, 2, seed=5)
        return float(trainer.make_train_step(port, 8)(state, x, c, **kw)["loss"])

    g = trainer.seeded_generator("cpu", 5, 0, 0)
    t = torch.randint(1, 9, (4,), generator=g)
    noise = torch.randn((4, H, H, 1), generator=g)
    draws = port.draw_shortcut(g)
    assert run() == run(t=t, noise=noise, shortcut=draws)
    assert run() != run(t=t, noise=noise, shortcut=port.draw_shortcut(torch.Generator()))


# ---- run_experiment ------------------------------------------------------------

TINY = dict(lrate=1e-3, n_epoch=1, timesteps=8, num_params=3, n_feat=8, height=16,
            data_size=32, synthetic_param_sets=4, batch_size=8, n_eval_images=2,
            eval_batch_size=8, nll_subset=8, elbo_subset=8, shortcut="stochastic")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_stochastic_condition_run_writes_the_jax_runners_files(tmp_path):
    """Mode ``condition`` with ``shortcut="stochastic"``, both runners: the
    JAX runner's files, its PNGs by name among them, the same sidecars, the
    JAX ``results`` keys (the port adds ``pdf_stats``, ``not_ported`` and
    ``figures_skipped``), a checkpoint without shortcut leaves that the
    port serves as a stochastic model, and finite losses."""
    want = jax_run_experiment(JaxExperimentConfig(mode="condition",
                                                  output_root=str(tmp_path / "jax"), **TINY))
    got = experiment.run_experiment(
        ExperimentConfig(mode="condition", output_root=str(tmp_path / "port"), **TINY),
        device="cpu")
    figures = [f for f in _files(want["output_dir"]) if f.endswith(".png")]
    assert figures
    assert _files(got["output_dir"]) == _files(want["output_dir"])
    for name in ("param_min.npy", "param_max.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(got["output_dir"], name)),
                                      np.load(os.path.join(want["output_dir"], name)))
    for name in ("dataset_info.txt", "selected_params.txt"):
        with open(os.path.join(got["output_dir"], name)) as a, \
                open(os.path.join(want["output_dir"], name)) as b:
            assert a.read() == b.read()
    assert set(got) - {"pdf_stats", "not_ported", "figures_skipped"} == set(want)
    assert got["not_ported"] == [] and got["figures_skipped"] == []
    assert np.isfinite(got["loss_log"] + got["val_loss_log"]).all()
    ckpt = load_variables(os.path.join(got["output_dir"], "weights", "train_state.msgpack"))
    assert "shortcut" not in ckpt["params"]["init_conv"]
    assert load_model(ckpt, "cpu").stochastic
