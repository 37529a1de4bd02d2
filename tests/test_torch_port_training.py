"""PyTorch port: the training path against the JAX package on the CPU.

BatchNorm in training mode with flax's semantics, one step's loss and
gradients against ``jax.value_and_grad`` of the same loss, three Adam steps
against ``make_train_step`` (the learning rate crossing an epoch), the eval
step against ``make_eval_step``, and the three remat modes.  The narrow model
of ``tests/test_trainer.py`` (n_feat 8, 16x16, n_cfeat 3, T 8), batch 8 with
2 wrap-padded rows masked out; weights from the JAX ``model.init`` through
``from_jax_variables``; t and the noise replayed from JAX's ``split(rng, 3)``.

The JAX side runs in float64 (:func:`jax_float64`): in float32 on the CPU
its BatchNorm statistics (``mean(x^2) - mean(x)^2`` summed by XLA) lose
digits where a channel's mean is large against its spread, as on maps in
[0, 1) at init, and its gradients then stray from a float64 evaluation by
more than the tolerances below, which the port's float32 meets.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from camels_diffusion_model_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.models import blocks as jax_blocks
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.training import create_train_state as jax_create_train_state
from camels_diffusion_model_tpu.training import make_eval_step as jax_make_eval_step
from camels_diffusion_model_tpu.training import make_train_step as jax_make_train_step
from camels_diffusion_model_tpu.training.trainer import _noise_coeff
from camels_diffusion_model_tpu.training.trainer import masked_mean as jax_masked_mean
from camels_diffusion_model_tpu_torch.models.blocks import BatchNorm, commit_batch_stats
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.training import trainer
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

H, T, B, REAL = 16, 8, 8, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The narrow model's ops gain nothing from threads, and tier-1 runs six
    pytest workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_model():
    model = JaxContextUnet(in_channels=1, n_feat=8, n_cfeat=3, height=H, levels=2)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), np.zeros((1, H, H, 1), np.float32),
        np.array([0.5], np.float32)))
    return model, variables


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the dtype the
    JAX blocks hard-code for their norms' statistics."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_float64():
    """The JAX package's narrow model computing in float64 (x64 on, its
    norms' float32 read as float64); nothing of the package changes."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_blocks, "jnp", _Float64Numpy())
        yield JaxContextUnet(in_channels=1, n_feat=8, n_cfeat=3, height=H, levels=2,
                             dtype=jnp.float64)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _port(variables):
    model = ContextUnet(n_feat=8, n_cfeat=3, height=H)
    model.load_state_dict(from_jax_variables(variables))
    return model


def _batch(seed):
    """B rows, the last B - REAL wrapped from the first (the runner's pad),
    and the mask of the real rows."""
    rs = np.random.RandomState(seed)
    idx = np.arange(B) % REAL
    x = rs.rand(REAL, H, H, 1).astype(np.float32)[idx]
    c = rs.rand(REAL, 3).astype(np.float32)[idx]
    return x, c, (np.arange(B) < REAL).astype(np.float32)


def _draws(rng):
    """t and the noise of a JAX step of key ``rng`` (``trainer.py:152-155``)."""
    tkey, nkey, _ = jax.random.split(rng, 3)
    t = jax.random.randint(tkey, (B,), 1, T + 1)
    noise = jax.random.normal(nkey, (B, H, H, 1), jnp.float32)
    return np.asarray(t), np.asarray(noise)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _assert_trees_close(got, want, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def test_batchnorm_training_forward_and_stats_match_flax(jax_model):
    """Three train=True forwards, committing the staged statistics each
    time, against flax's ``mutable=["batch_stats"]``: outputs and running
    statistics atol 1e-5."""
    _, variables = jax_model
    port = _port(variables)
    with jax_float64() as model:
        apply = jax.jit(lambda v, x, t, c: model.apply(v, x, t, c, train=True,
                                                       mutable=["batch_stats"]))
        v = _f64(variables)
        for seed in range(3):
            x, c, _ = _batch(seed)
            t = np.full((B,), 0.25 * (seed + 1), np.float32)
            want, mutated = apply(v, x, t, c)
            v = {"params": v["params"], "batch_stats": mutated["batch_stats"]}
            got = port(torch.tensor(x), torch.tensor(t), torch.tensor(c), train=True)
            commit_batch_stats(port)
            np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
        want_stats = jax.device_get(v["batch_stats"])
    _assert_trees_close(to_jax_variables(port.state_dict())["batch_stats"], want_stats,
                        atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 2, 2, 4), (8, 4, 4, 16)])
def test_batchnorm_update_is_flax_biased_not_torch_unbiased(shape):
    """The staged running variance is flax's (biased); ``nn.BatchNorm2d``'s
    training update (unbiased, n/(n-1)) misses it by more than the
    tolerance."""
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)  # NHWC
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = flax_bn.init(jax.random.PRNGKey(0), x)
    want, mutated = flax_bn.apply(v, x, mutable=["batch_stats"])
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    bn = BatchNorm(shape[-1])
    got = bn(xt, train=True)
    commit_batch_stats(bn)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mutated["batch_stats"]["mean"], atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), mutated["batch_stats"]["var"], atol=1e-5)
    torch_bn = torch.nn.BatchNorm2d(shape[-1], eps=1e-5, momentum=0.1)
    torch_bn(xt)
    miss = np.abs(torch_bn.running_var.numpy() - mutated["batch_stats"]["var"]).max()
    assert miss > 1e-5


def _jax_loss(model, alpha_bar, scaling):
    def loss_fn(params, batch_stats, x, c, t, noise, mask):
        ab = alpha_bar[t][:, None, None, None]
        x_pert = jnp.sqrt(ab) * x + _noise_coeff(ab, scaling) * noise
        out, _ = model.apply({"params": params, "batch_stats": batch_stats}, x_pert,
                             (t / T).astype(jnp.float32), c, train=True,
                             mutable=["batch_stats"])
        per_sample = jnp.mean(jnp.square(out - noise), axis=(1, 2, 3))
        return jax_masked_mean(per_sample, mask)[1]
    return loss_fn


@pytest.mark.parametrize("scaling", ["reference", "standard"])
def test_one_step_loss_and_gradients_match_jax(jax_model, scaling):
    """Loss rtol 1e-5; every gradient leaf rtol 1e-4 / atol 1e-6 (the conv
    biases ahead of a BatchNorm have gradients that are zero up to
    rounding)."""
    _, variables = jax_model
    x, c, mask = _batch(3)
    with jax_float64() as model:
        t, noise = _draws(jax.random.PRNGKey(7))
        loss_fn = _jax_loss(model, jax_make_schedule(T).alpha_bar, scaling)
        v = _f64(variables)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            v["params"], v["batch_stats"], x, c, t, noise, mask)
        loss, grads = float(loss), jax.device_get(grads)
    port = _port(variables)
    state = trainer.create_train_state(port, 1e-3, 4, 2)
    step = trainer.make_train_step(port, T, scaling=scaling)
    m = step(state, x, c, mask, t=torch.tensor(t), noise=torch.tensor(noise))
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)
    got = to_jax_variables({n: p.grad for n, p in port.named_parameters()})["params"]
    _assert_trees_close(got, grads, rtol=1e-4, atol=1e-6)


def _zero_gradient(name):
    """Biases whose gradient is zero but for rounding at this width: the
    convs ahead of a BatchNorm, and ``out_conv1`` ahead of a GroupNorm of
    one channel a group (8 channels, 8 groups)."""
    return name.endswith(".conv.bias") or name == "out_conv1.bias"


@pytest.mark.parametrize("scaling", ["reference", "standard"])
def test_three_adam_steps_and_eval_step_match_jax(jax_model, scaling):
    """Three steps of 2 an epoch (the third at the second epoch's rate):
    params, Adam moments and batch_stats atol 1e-5, per-sample MSE rtol
    1e-5; then the eval step against ``make_eval_step`` rtol 1e-5.

    Adam moves a parameter by about the rate whatever its gradient's size,
    so the biases whose gradient is rounding noise (:func:`_zero_gradient`:
    below 1e-6 in both packages, checked here) take steps of either sign in
    either package.  They change neither the loss nor another gradient, but
    they shift the BatchNorm running means; so after each step the port
    takes JAX's values of them, and every leaf is compared."""
    _, variables = jax_model
    lr = 1e-4
    port = _port(variables)
    state = trainer.create_train_state(port, lr, 4, 2)
    step = trainer.make_train_step(port, T, scaling=scaling)
    with jax_float64() as model:
        jstate = jax_create_train_state(model, _f64(variables), lr, 4, 2)
        jstep = jax_make_train_step(model, T, scaling=scaling)
        key = jax.random.PRNGKey(11)
        for i in range(3):
            key, k = jax.random.split(key)
            x, c, mask = _batch(10 + i)
            jstate, jm = jstep(jstate, x, c, k, mask)
            t, noise = _draws(k)
            m = step(state, x, c, mask, t=torch.tensor(t), noise=torch.tensor(noise))
            np.testing.assert_array_equal(m["t"].numpy(), np.asarray(jm["t"]))
            np.testing.assert_allclose(m["per_sample_mse"].numpy(), jm["per_sample_mse"],
                                       rtol=1e-5)
            jax_params = from_jax_variables({"params": _f64(jax.device_get(jstate.params))})
            with torch.no_grad():
                for name, p in port.named_parameters():
                    if _zero_gradient(name):
                        assert p.grad.abs().max() < 1e-6, name
                        p.copy_(jax_params[name])
        want = jax.device_get((jstate.params, jstate.batch_stats, jstate.opt_state[0]))
        x, c, mask = _batch(20)
        rng = jax.random.PRNGKey(21)
        jm = jax.device_get(jax_make_eval_step(model, T, scaling=scaling)(
            jstate.params, jstate.batch_stats, x, c, rng, mask))
        t, noise = _draws(rng)
    assert state.step == 3
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(lr * 0.75)
    got = to_jax_variables(port.state_dict())
    _assert_trees_close(got["params"], want[0], atol=1e-5, rtol=0)
    _assert_trees_close(got["batch_stats"], want[1], atol=1e-5, rtol=0)
    for key_name, jax_tree in (("exp_avg", want[2].mu), ("exp_avg_sq", want[2].nu)):
        moments = {n: state.optimizer.state[p][key_name] for n, p in port.named_parameters()}
        _assert_trees_close(to_jax_variables(moments)["params"], jax_tree, atol=1e-5, rtol=0)

    m = trainer.make_eval_step(port, T, scaling=scaling)(
        x, c, mask, t=torch.tensor(t), noise=torch.tensor(noise))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["per_sample_mse"].numpy(), jm["per_sample_mse"], rtol=1e-5)
    assert m["loss"].grad_fn is None


@pytest.mark.parametrize("remat", [True, "convs"])
def test_remat_modes_equal_no_remat(jax_model, remat):
    """``torch.utils.checkpoint`` (full) and selective checkpointing of the
    convolution outputs change what autograd keeps, not the math: three
    steps equal to atol 1e-6, the running statistics updated once a step."""
    _, variables = jax_model
    runs = []
    for mode in (False, remat):
        port = _port(variables)
        state = trainer.create_train_state(port, 1e-3, 4, 2, seed=5)
        step = trainer.make_train_step(port, T, remat=mode)
        losses = [float(step(state, *_batch(30 + i))["loss"]) for i in range(3)]
        runs.append((losses, to_jax_variables(port.state_dict())))
    np.testing.assert_allclose(runs[1][0], runs[0][0], atol=1e-6, rtol=0)
    for col in ("params", "batch_stats"):
        _assert_trees_close(runs[1][1][col], runs[0][1][col], atol=1e-6, rtol=0)


def test_train_step_draws_from_the_seed_and_step():
    """Without injected draws a step's t and noise come from ``(seed, 0,
    step)``: two states of one seed draw alike, another seed differently."""
    def first_t(seed):
        port = ContextUnet(n_feat=8, n_cfeat=3, height=H)
        state = trainer.create_train_state(port, 1e-3, 4, 2, seed=seed)
        step = trainer.make_train_step(port, T)
        x, c, mask = _batch(0)
        return [step(state, x, c, mask)["t"].tolist() for _ in range(2)]
    a, b, other = first_t(3), first_t(3), first_t(4)
    assert a == b and a[0] != a[1] and a != other


def test_parse_remat_env_and_schedule():
    assert [trainer.parse_remat_env(v) for v in ("", None, "full", "convs")] == \
        [False, False, True, "convs"]
    with pytest.raises(ValueError, match="remat mode"):
        trainer.parse_remat_env("all")
    sched = trainer.linear_decay_schedule(1e-3, 10, 5)
    assert [sched(s) for s in (0, 4, 5, 49)] == pytest.approx([1e-3, 1e-3, 9e-4, 1e-4])
