"""PyTorch port: the deep and big ContextUnet variants against the JAX
package on the CPU, and kernels K1-K3 at the shapes and activations the
variants give them.

The variants at n_feat 8, 16x16 (``TINY`` of
``tests/test_torch_port_experiment.py``): the forward (unfolded and
BatchNorm-folded), one train step against ``jax.value_and_grad`` of the JAX
loss in float64, and the ancestral sampler against the JAX trajectory under
injected z, each on the same weights (``utils/weights.py``).  Then the
plain versions of the kernels with tanh, leaky ReLU and GELU against the
JAX functions, and the launch plans at every shape the variants run.
Last, ``chip_smoke.kink_sides``, which the card's train-step gate of the
variants relies on, at n_feat 16, 64x64 (where a free fp32 step sits
about 3e-3 from float64 on an x86 CPU).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.diffusion import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.diffusion import sample_ddpm as jax_sample_ddpm
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.models import blocks as jax_blocks
from camels_diffusion_model_tpu.models.blocks import GroupNormAct as JaxGroupNormAct
from camels_diffusion_model_tpu.ops.pallas import fused_p_sample_step as jax_fused_p_sample_step
from camels_diffusion_model_tpu.ops.pallas.film import film_xla
from camels_diffusion_model_tpu.training.trainer import _noise_coeff
from camels_diffusion_model_tpu.training.trainer import masked_mean as jax_masked_mean
import chip_smoke
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import ddpm_coefficients, make_schedule
from camels_diffusion_model_tpu_torch.models.context_unet import VARIANTS, ContextUnet
from camels_diffusion_model_tpu_torch.ops import film as film_ops
from camels_diffusion_model_tpu_torch.ops import groupnorm as groupnorm_ops
from camels_diffusion_model_tpu_torch.ops import sampler_step as sampler_step_ops
from camels_diffusion_model_tpu_torch.ops.film import film_plain
from camels_diffusion_model_tpu_torch.ops.groupnorm import groupnorm_act_plain
from camels_diffusion_model_tpu_torch.ops.sampler_step import head_step_plain, sampler_step_plain
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training import trainer
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

H, NF = 16, 8
NCFEAT = {"deep": 5, "big": 10}  # the factories' defaults
VARIANT_NAMES = ("deep", "big")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The narrow models gain nothing from threads, and tier-1 runs six
    pytest workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variant(name, **kw):
    return getattr(JaxContextUnet, name)(n_feat=NF, height=H, **kw)


@pytest.fixture(scope="module")
def variants():
    """Per variant: the JAX module and its numpy variables with non-trivial
    BatchNorm running statistics."""
    out = {}
    for i, name in enumerate(VARIANT_NAMES):
        model = _jax_variant(name)
        variables = jax.device_get(jax.jit(model.init)(
            jax.random.PRNGKey(i), np.zeros((1, H, H, 1), np.float32),
            np.array([0.5], np.float32)))
        rs = np.random.RandomState(10 + i)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, leaf: (
                (rs.randn(*leaf.shape) * 0.1).astype(np.float32)
                if "mean" in jax.tree_util.keystr(path)
                else (rs.rand(*leaf.shape) + 0.5).astype(np.float32)),
            variables["batch_stats"])
        out[name] = (model, variables)
    return out


def _inputs(seed, name, batch=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, H, H, 1).astype(np.float32)
    t = rs.rand(batch).astype(np.float32)
    c = rs.rand(batch, NCFEAT[name]).astype(np.float32)
    return x, t, c


# ---- the model --------------------------------------------------------------

@pytest.mark.parametrize("name", VARIANT_NAMES)
def test_variant_carries_the_flax_parameter_names(variants, name):
    """``from_jax_variables`` fills the port's variant exactly (``down3``,
    ``up3`` and, for big, ``out_conv_extra`` included), and
    ``to_jax_variables`` gives the flax tree back."""
    _, variables = variants[name]
    port = getattr(ContextUnet, name)(n_feat=NF, height=H)
    sd = from_jax_variables(variables)
    assert set(sd) == set(port.state_dict())
    assert ("out_conv_extra.weight" in sd) == (name == "big") and "up3.upconv.weight" in sd
    port.load_state_dict(sd)
    back = to_jax_variables(port.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert {jax.tree_util.keystr(k) for k in flat} == {
        jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(back)}
    assert load_model(variables, "cpu", fold_bn=False).final_tanh


@pytest.mark.parametrize("fold_bn", [False, True])
@pytest.mark.parametrize("context", ["given", "none"])
@pytest.mark.parametrize("name", VARIANT_NAMES)
def test_variant_forward_matches_jax(variants, name, fold_bn, context):
    """fp32 forward on the same weights, rtol 1e-6 and atol 1e-6 (the tanh
    output is in [-1, 1])."""
    model, variables = variants[name]
    x, t, c = _inputs(1, name)
    c_j = c if context == "given" else None
    want = np.asarray(jax.jit(model.apply)(variables, x, t, c_j))
    port = load_model(variables, "cpu", fold_bn=fold_bn)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t),
                   None if c_j is None else torch.tensor(c_j)).numpy()
    assert got.shape == want.shape == (3, H, H, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", VARIANT_NAMES)
def test_variant_factories_take_the_jax_defaults(name):
    """Full width: the JAX factories' n_feat, n_cfeat, height and heads;
    the big model's ``up0_conv`` is 1024 x 1024 x 16 x 16."""
    with torch.device("meta"):
        port = getattr(ContextUnet, name)()
    jax_model = getattr(JaxContextUnet, name)()
    assert (port.n_feat, port.n_cfeat, port.height, port.levels) == (
        jax_model.n_feat, jax_model.n_cfeat, jax_model.height, jax_model.levels)
    assert (port.up0_norm.act, port.out_norm.act, port.final_tanh) == (
        jax_model.up0_act, jax_model.out_act, jax_model.final_tanh)
    assert hasattr(port, "out_conv_extra") == jax_model.extra_out_conv
    assert VARIANTS[name]["levels"] == 3
    if name == "big":
        assert tuple(port.up0_conv.weight.shape) == (1024, 1024, 16, 16)
        assert sum(p.numel() for p in port.parameters()) > 300e6


# ---- one train step in float64 ----------------------------------------------

class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the dtype the
    JAX blocks hard-code for their norms' statistics."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_float64(name):
    """The JAX variant computing in float64 (as
    ``tests/test_torch_port_training.py::jax_float64``)."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_blocks, "jnp", _Float64Numpy())
        yield _jax_variant(name, dtype=jnp.float64)


@pytest.mark.parametrize("scaling", ["reference", "standard"])
@pytest.mark.parametrize("name", VARIANT_NAMES)
def test_variant_train_step_matches_jax(variants, name, scaling):
    """Batch 8 (2 wrap-padded rows masked), T 8: loss rtol 1e-5; every
    gradient leaf rtol 1e-4 / atol 1e-6, the tolerances of
    ``tests/test_torch_port_training.py``."""
    _, variables = variants[name]
    T, B, REAL = 8, 8, 6
    rs = np.random.RandomState(3)
    idx = np.arange(B) % REAL
    x = rs.rand(REAL, H, H, 1).astype(np.float32)[idx]
    c = rs.rand(REAL, NCFEAT[name]).astype(np.float32)[idx]
    mask = (np.arange(B) < REAL).astype(np.float32)
    t = rs.randint(1, T + 1, B)
    noise = rs.randn(B, H, H, 1).astype(np.float32)
    f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    alpha_bar = jax_make_schedule(T).alpha_bar
    with jax_float64(name) as model:
        def loss_fn(params):
            ab = alpha_bar[t][:, None, None, None]
            x_pert = jnp.sqrt(ab) * x + _noise_coeff(ab, scaling) * noise
            out, _ = model.apply({"params": params, "batch_stats": f64["batch_stats"]},
                                 x_pert, (t / T).astype(jnp.float32), c, train=True,
                                 mutable=["batch_stats"])
            return jax_masked_mean(jnp.mean(jnp.square(out - noise), axis=(1, 2, 3)), mask)[1]
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(f64["params"])
        loss, grads = float(loss), jax.device_get(grads)
    port = getattr(ContextUnet, name)(n_feat=NF, height=H)
    port.load_state_dict(from_jax_variables(variables))
    state = trainer.create_train_state(port, 1e-3, 4, 2)
    m = trainer.make_train_step(port, T, scaling=scaling)(
        state, x, c, mask, t=torch.tensor(t), noise=torch.tensor(noise))
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_variables({n: p.grad for n, p in port.named_parameters()})["params"]))
    want = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert {jax.tree_util.keystr(k) for k in got} == {jax.tree_util.keystr(k) for k in want}
    want = {jax.tree_util.keystr(k): v for k, v in want.items()}
    for k, v in got.items():
        np.testing.assert_allclose(v, want[jax.tree_util.keystr(k)], rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(k))


# ---- the ancestral sampler ----------------------------------------------------

def _z_sequence(rng, n_steps, shape):
    """The per-step z of the JAX sampler of key ``rng``
    (``tests/test_torch_port_slice.py::_z_sequence``)."""
    key = jax.random.split(rng, 3)[0]
    zs = []
    for _ in range(n_steps):
        key, zkey, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(zkey, shape, jnp.float32)))
    return zs


@pytest.mark.parametrize("guide_w", [0.0, 2.0])
@pytest.mark.parametrize("name", VARIANT_NAMES)
def test_variant_sampler_matches_jax_under_injected_noise(variants, name, guide_w):
    """T=12 exact chain, same x_init, contexts and z: within 1e-4 abs.  The
    port's step kernel applies out_conv2 and the tanh (its plain version on
    the CPU)."""
    model, variables = variants[name]
    T = 12
    rs = np.random.RandomState(4)
    x0 = rs.randn(2, H, H, 1).astype(np.float32)
    params = rs.rand(2, NCFEAT[name]).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax_sample_ddpm(model, variables, jax_make_schedule(T), rng,
                                      params=params, guide_w=guide_w,
                                      x_init=jnp.asarray(x0)).x)
    zs = _z_sequence(rng, T, x0.shape)
    got = sample_ddpm(load_model(variables, "cpu"), make_schedule(T), torch.Generator(),
                      params=params, guide_w=guide_w, x_init=x0, device="cpu",
                      z_fn=lambda k, t: torch.tensor(zs[k])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---- the kernels' plain versions --------------------------------------------

@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("c", [128, 256])
def test_head_step_plain_with_tanh_matches_jax(c, w):
    """eps = tanh(out_conv2(h)) as the JAX decoder ends
    (``context_unet.py:314-316``), then the guidance combine and the Pallas
    step in interpret mode: atol 2e-6."""
    from camels_diffusion_model_tpu.diffusion.sampler import _combine_cfg

    T, t, b = 50, 17, 2
    cfg = w is not None
    rs = np.random.RandomState(c)
    h = np.maximum(rs.randn(2 * b if cfg else b, 8, 8, c), 0).astype(np.float32)
    kernel = (rs.randn(3, 3, c, 1) * 0.05).astype(np.float32)
    bias = rs.randn(1).astype(np.float32)
    x, z = (rs.randn(b, 8, 8, 1).astype(np.float32) for _ in range(2))
    w_val = np.array([1.5, 3.0], np.float32) if w == "per-sample" else w
    eps = jnp.tanh(jax.lax.conv_general_dilated(
        jnp.asarray(h), jnp.asarray(kernel), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias)
    if cfg:
        eps = _combine_cfg(eps[:b], eps[b:], w_val)
    s = jax_make_schedule(T)
    want = np.asarray(jax_fused_p_sample_step(s.beta, s.alpha, s.alpha_bar, x, t, eps, z,
                                              interpret=True))
    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(make_schedule(T), torch.tensor([t]))[0].tolist()
    weight = torch.tensor(kernel.transpose(3, 2, 0, 1).copy())
    w_t = torch.tensor(w_val) if w == "per-sample" else w_val
    got = head_step_plain(torch.tensor(h), weight, torch.tensor(bias), torch.tensor(x),
                          torch.tensor(z), c_eps, inv_sqrt_a, sigma, w_t, tanh=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    eps_t = torch.tensor(np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(h), jnp.asarray(kernel), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias))
    via_step = sampler_step_plain(torch.tensor(x), eps_t, torch.tensor(z), c_eps, inv_sqrt_a,
                                  sigma, w_t, tanh=True)
    np.testing.assert_allclose(via_step.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("act,film", [("leaky_relu", False), ("gelu", False),
                                      ("leaky_relu", True), ("gelu", True)])
@pytest.mark.parametrize("c", [512, 1024])
def test_groupnorm_act_plain_matches_jax_at_the_variant_widths(c, act, film):
    """GroupNorm(8) + act at up0_norm's widths (deep 512, big 1024), with
    FiLM stage 0 as the JAX decoder applies it after ``up0_norm``
    (``context_unet.py:296-305``): atol 1e-5."""
    rs = np.random.RandomState(c + len(act))
    x = (rs.randn(3, 4, 4, c) * 2 + 0.5).astype(np.float32)
    gamma, beta = rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)
    want = np.asarray(JaxGroupNormAct(num_groups=8, epsilon=1e-5, act=act).apply(
        {"params": {"scale": gamma, "bias": beta}}, x))
    rows = None
    if film:
        rows = (rs.randn(3, c).astype(np.float32), rs.randn(1, c).astype(np.float32))
        want = rows[0][:, None, None, :] * want + rows[1][:, None, None, :]
    got = groupnorm_act_plain(torch.tensor(x), torch.tensor(gamma), torch.tensor(beta), 8,
                              1e-5, act, None if rows is None else
                              tuple(torch.tensor(r) for r in rows))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("c", [256, 512])
def test_film_plain_matches_jax_at_the_variant_widths(c):
    """FiLM stage 1 at the variants' widths (deep 256, big 512): atol 1e-6."""
    rs = np.random.RandomState(c)
    x = rs.randn(3, 8, 8, c).astype(np.float32)
    scale, shift = rs.randn(3, c).astype(np.float32), rs.randn(1, c).astype(np.float32)
    want = np.asarray(film_xla(x, scale[:, None, None, :], shift[:, None, None, :]))
    got = film_plain(torch.tensor(x), torch.tensor(scale), torch.tensor(shift)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---- launch plans at the variants' shapes -----------------------------------

# (name, n, hw, c): K2 at up0_norm and out_norm of each variant, at the
# sampling batch (10 maps, 20 under CFG) and the validation batch (32).
GROUPNORM_SHAPES = [
    (head, n, hw, c)
    for n in (10, 20, 32)
    for head, hw, c in (("deep up0_norm", 16 * 16, 512), ("deep out_norm", 128 * 128, 128),
                        ("big up0_norm", 16 * 16, 1024), ("big out_norm", 128 * 128, 256))
]


def _groupnorm_passes(plan, hw, cg):
    """The kernel's index map (csrc/groupnorm.cu) under ``plan``: per
    (pixel, channel) of one group, how often the first pass reads it from
    device memory and how often the later passes read it from shared
    memory; and the bytes each CTA holds."""
    first = np.zeros((hw, cg), np.int64)
    shared = np.zeros((hw, cg), np.int64)
    vpp = cg // plan.vec
    pstride = plan.threads // vpp
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.pixels_per_cta)
        np_ = min(hw, p0 + plan.pixels_per_cta) - p0
        assert np_ * cg * 4 <= plan.smem_bytes
        for t in range(pstride * vpp):
            j = slice((t % vpp) * plan.vec, (t % vpp + 1) * plan.vec)
            f = t // vpp
            first[p0 + f:p0 + np_:pstride, j] += 1
            shared[p0 + f:p0 + np_:pstride, j] += 1
    return first, shared


@pytest.mark.parametrize("head,n,hw,c", GROUPNORM_SHAPES)
def test_groupnorm_launch_plan_at_the_variant_shapes(head, n, hw, c):
    """The template's plan at every shape the variants run but the big
    out_norm, on the 16-byte path: every element read once by the first
    pass and once more by each later pass, from shared memory; its CTAs of
    512 threads at the deep out_norm (a slice over half of ``SLICE_MAX``),
    256 at the up0_norm.  The big out_norm (2 MiB a group, 256 KiB a CTA)
    is over ``SLICE_MAX``, which the template's plan refuses; the route
    gives both out_norm the large-slice kernel
    (tests/test_torch_port_variant_kernels.py)."""
    if head == "big out_norm":
        with pytest.raises(ValueError, match="per CTA"):
            groupnorm_ops.launch_plan(n, hw, c, 8)
        assert groupnorm_ops.single_route(n, hw, c, 8, torch.float32)[0] == (
            groupnorm_ops.LARGE_NAME)
        return
    plan = groupnorm_ops.launch_plan(n, hw, c, 8)
    assert plan.vec == 4 and plan.cluster <= groupnorm_ops.MAX_CLUSTER
    assert plan.smem_bytes <= groupnorm_ops.SLICE_MAX
    first, shared = _groupnorm_passes(plan, hw, c // 8)
    assert (first == 1).all() and (shared == 1).all()
    assert plan.threads == (512 if "out_norm" in head else 256)


def test_groupnorm_spill_path_reads_each_element_once_a_pass(monkeypatch):
    """No pass reads device memory again: at a forced small ``SLICE_MAX``
    (20 pixels of 4 channels) a slice of 16 pixels is held whole, every
    element read once by the first pass and once by each later pass from
    shared memory; a slice of 32 pixels (in a cluster of 8), which the
    template once spilled, is refused by its plan and routed to the
    statistics and apply pair."""
    monkeypatch.setattr(groupnorm_ops, "SLICE_MAX", 20 * 4 * 4)
    monkeypatch.setattr(groupnorm_ops, "SLICE_TARGET", 16 * 4 * 4)
    monkeypatch.setattr(groupnorm_ops, "MIN_CTAS", 32)
    plan = groupnorm_ops.launch_plan(2, 64, 32, 8)
    assert (plan.cluster, plan.pixels_per_cta, plan.smem_bytes) == (4, 16, 16 * 4 * 4)
    first, shared = _groupnorm_passes(plan, 64, 4)
    assert (first == 1).all() and (shared == 1).all()
    with pytest.raises(ValueError, match="per CTA"):
        groupnorm_ops.launch_plan(2, 256, 32, 8)  # 32 pixels a CTA in a cluster of 8
    name, pair = groupnorm_ops.single_route(2, 256, 32, 8, torch.float32)
    assert name == groupnorm_ops.PAIR_NAMES[torch.float32]
    assert isinstance(pair, groupnorm_ops.PairPlan)


@pytest.mark.parametrize("units,cfg", [(10, False), (10, True), (2, False), (5, True)])
@pytest.mark.parametrize("c", [128, 256])
def test_head_launch_plan_at_the_variant_shapes(c, units, cfg):
    """K1 at width 128 (deep 128 channels, big 256), with and without CFG:
    a plan within the thread and shared-memory limits; without CFG at 10
    maps bands of 4 rows, under CFG bands of one row (3 x 128 pixels
    pairs, 384 threads); the big chunk of 32 channels in 2 stages,
    225 KiB."""
    plan = sampler_step_ops.launch_plan(units, 128, 128, c, cfg=cfg, sms=132)
    assert plan.threads <= sampler_step_ops.MAX_THREADS
    assert plan.smem_bytes <= sampler_step_ops.SMEM_MAX and c % plan.ck == 0
    if units == 10:
        assert plan.rows == (1 if cfg else 4)
    if c == 256 and plan.threads == 384:
        assert (plan.ck, plan.stages, plan.smem_bytes) == (32, 2, 225 * 1024)


@pytest.mark.parametrize("n", [10, 20, 32])
@pytest.mark.parametrize("c", [256, 512])
def test_film_launch_plan_at_the_variant_shapes(n, c):
    """K3 at FiLM stage 1 of the variants, (n, 32, 32, 256) and (n, 32, 32,
    512): the 16-byte path within one wave of 132 SMs."""
    plan = film_ops.launch_plan(n, 32 * 32, c, sms=132)
    assert plan.vec == 4 and plan.threads % (c // 4) == 0
    assert n * plan.blocks_per_sample <= 132 * film_ops.BLOCKS_PER_SM


@pytest.mark.parametrize("name", VARIANT_NAMES)
def test_kink_sides_pin_an_fp32_step_to_the_float64_steps_sides(name):
    """Recording the kinks' sides leaves the float64 gradients as they are;
    an fp32 step that takes the recorded sides is within 1e-5 of float64
    over all leaves, whichever sides its own rounding would take; a replay
    that takes fewer kinks than were recorded fails."""
    torch.manual_seed(0)
    base = getattr(ContextUnet, name)(n_feat=16, height=64).to(memory_format=torch.channels_last)
    batch = chip_smoke.variant_batch(base, 2, 2)
    scaling = "standard" if name == "big" else "reference"

    def make(device):
        return copy.deepcopy(base).to(device=device, memory_format=torch.channels_last)

    def grads(dtype):
        return chip_smoke.witness_grads(make, torch.device("cpu"), *batch, scaling, dtype, True)

    def flat(tree):
        return torch.cat([tree[n].flatten() for n in sorted(tree)])

    sides = []
    with chip_smoke.kink_sides(sides, replay=False):
        ref = flat(grads(torch.float64))
    assert (flat(grads(torch.float64)) - ref).norm() <= 1e-12 * ref.norm()
    with chip_smoke.kink_sides(sides, replay=True) as flips:
        pinned = flat(grads(torch.float32))
    assert (pinned - ref).norm() <= 1e-5 * ref.norm()
    assert flips[1] == sum(side.numel() for side in sides)
    with pytest.raises(SystemExit, match="fewer kinks"):
        with chip_smoke.kink_sides(sides + sides[:1], replay=True):
            grads(torch.float32)
