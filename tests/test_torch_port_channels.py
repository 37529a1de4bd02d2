"""PyTorch port: models of several image channels (``ContextUnet(in_channels=k)``,
as a model trained jointly on several CMD fields) against the JAX package
on the CPU, and the plans of the kernels that take them on the card.

The samplers (the exact chain, strided DDPM, posterior DDIM and
DPM-Solver++(2M)) at ``in_channels`` 2, 3 and 13 (the CAMELS Multifield
Dataset's fields) run the JAX package's flax
model and the port's model built from the same variables by
``load_model`` (``from_jax_variables``) on the same numpy x_init and
contexts, the JAX samplers' z injected into the port's.  K1's plain
versions at two output channels run against flax's conv and the Pallas
step in interpret mode.  K1's plans must give every ``cout`` from 1 to 16
a kernel at the committed models' shapes (from two channels the
output-stationary kernel, one CTA a band for every channel), and K2's
statistics and apply
plans 16-byte packs where packs straddle groups.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from camels_diffusion_model_tpu.diffusion import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.diffusion import sample_ddpm as jax_sample_ddpm
from camels_diffusion_model_tpu.diffusion.ddim import sample_ddim as jax_sample_ddim
from camels_diffusion_model_tpu.diffusion.dpm_solver import sample_dpm2m as jax_sample_dpm2m
from camels_diffusion_model_tpu.diffusion.sampler import _combine_cfg
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.ops.pallas.sampler_step import (
    fused_p_sample_step as jax_fused_p_sample_step,
)
from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
from camels_diffusion_model_tpu_torch.diffusion.dpm_solver import sample_dpm2m
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import ddpm_coefficients, make_schedule
from camels_diffusion_model_tpu_torch.ops import groupnorm as groupnorm_ops
from camels_diffusion_model_tpu_torch.ops import sampler_step as ops
from camels_diffusion_model_tpu_torch.ops.sampler_step import (
    head_step_plain,
    head_step_split_plain,
)
from camels_diffusion_model_tpu_torch.serving import load_model

T, B, H, NC, STEPS = 20, 2, 16, 3, 6
GUIDES = {"w0": 0.0, "w2": 2.0, "per-sample": np.array([1.5, 3.0], np.float32)}


@pytest.fixture(scope="module", params=[2, 3, 13],
                ids=["in_channels 2", "in_channels 3", "in_channels 13"])
def tiny(request):
    """``(flax model, its variables, the port's model)`` at ``in_channels``
    k, n_feat 8, 16x16, with BatchNorm running statistics away from their
    init, unfolded on both sides."""
    k = request.param
    model = JaxContextUnet(in_channels=k, n_feat=8, n_cfeat=NC, height=H, levels=2)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(11 + k), np.zeros((1, H, H, k), np.float32),
        np.array([0.5], np.float32)))
    rs = np.random.RandomState(k)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((rs.randn(*leaf.shape) * 0.1).astype(np.float32)
                            if "mean" in jax.tree_util.keystr(path)
                            else (rs.rand(*leaf.shape) + 0.5).astype(np.float32)),
        variables["batch_stats"])
    port = load_model(variables, "cpu", fold_bn=False)
    assert port.in_channels == k and tuple(port.out_conv2.weight.shape) == (k, 8, 3, 3)
    return model, variables, port


def _inputs(k):
    rs = np.random.RandomState(3)
    return rs.randn(B, H, H, k).astype(np.float32), rs.rand(B, NC).astype(np.float32)


def _z_chain(rng, n_steps, shape):
    """The per-step z the JAX samplers draw from ``rng``: ``rng, xkey, pkey``
    first, then ``key, zkey, skey = split(key, 3)`` a step."""
    key = jax.random.split(rng, 3)[0]
    zs = []
    for _ in range(n_steps):
        key, zkey, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(zkey, shape, jnp.float32)))
    return zs


@pytest.mark.parametrize("guide", sorted(GUIDES))
@pytest.mark.parametrize("sampler", ["ddpm", "ddim beta", "ddim posterior", "dpm2m"])
def test_samplers_of_several_channels_match_jax_under_injected_noise(tiny, sampler, guide):
    """The exact chain (T 20), strided DDPM ("beta") and posterior DDIM
    (eta 1, so every step but the last draws z) over 6 steps, and
    DPM-Solver++(2M) over 6 steps, at w 0, 2 and per sample: the same
    x_init, contexts and z, maps of (B, 16, 16, in_channels) within 1e-4
    abs (fp32 differences of two stacks compounded over the chain)."""
    jm, variables, port = tiny
    k = port.in_channels
    x0, params = _inputs(k)
    w = GUIDES[guide]
    rng = jax.random.PRNGKey(17)
    taus = ddim_timesteps(T, STEPS)
    common = dict(params=params, guide_w=w)
    if sampler == "ddpm":
        want = jax_sample_ddpm(jm, variables, jax_make_schedule(T), rng, x_init=jnp.asarray(x0),
                               **common).x
        zs = _z_chain(rng, T, x0.shape)
        got = sample_ddpm(port, make_schedule(T), torch.Generator(), x_init=x0, device="cpu",
                          z_fn=lambda i, t: torch.tensor(zs[i]), **common)
    elif sampler.startswith("ddim"):
        mode = sampler.split()[1]
        extra = dict(taus=taus, sigma_mode=mode, **({"eta": 1.0} if mode == "posterior" else {}))
        want = jax_sample_ddim(jm, variables, jax_make_schedule(T), rng,
                               x_init=jnp.asarray(x0), **common, **extra).x
        zs = _z_chain(rng, len(taus), x0.shape)
        got = sample_ddim(port, make_schedule(T), torch.Generator(), x_init=x0, device="cpu",
                          z_fn=lambda i, t: torch.tensor(zs[i]), **common, **extra)
    else:
        want = jax_sample_dpm2m(jm, variables, jax_make_schedule(T), rng, n_steps=STEPS,
                                x_init=jnp.asarray(x0), **common).x
        got = sample_dpm2m(port, make_schedule(T), torch.Generator(), n_steps=STEPS,
                           x_init=x0, device="cpu", **common)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (B, H, H, k)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("plain", [head_step_plain, head_step_split_plain],
                         ids=["head_step_plain", "head_step_split_plain"])
def test_head_step_plain_at_two_output_channels_matches_jax(plain, w, tanh):
    """K1's plain versions at two output channels (the conv's ``(2, C, 3,
    3)`` weights and ``(2,)`` bias; the split launch's arithmetic in ranges
    of ``SPLIT_SPAN`` channels, 300 channels making three) against flax's
    conv to two channels, its tanh, JAX's combine and the Pallas step in
    interpret mode, fp32: 1e-5 abs."""
    rs = np.random.RandomState(5)
    b, c, t, cout = 2, 300, 7, 2
    h = np.maximum(rs.randn(2 * b if w else b, 8, 8, c), 0.0).astype(np.float32)
    kernel = (rs.randn(3, 3, c, cout) * 0.05).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    x, z = (rs.randn(b, 8, 8, cout).astype(np.float32) for _ in range(2))
    wv = np.array([1.5, 3.0], np.float32) if w == "per-sample" else w
    conv = fnn.Conv(cout, (3, 3), padding="SAME")
    eps = conv.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(h))
    if tanh:
        eps = jnp.tanh(eps)
    if wv is not None:
        eps = _combine_cfg(*jnp.split(eps, 2), wv)
    schedule = jax_make_schedule(T)
    want = np.asarray(jax_fused_p_sample_step(schedule.beta, schedule.alpha, schedule.alpha_bar,
                                              jnp.asarray(x), t, eps, jnp.asarray(z),
                                              interpret=True))
    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(make_schedule(T), torch.tensor([t]))[0].tolist()
    got = plain(torch.tensor(h), torch.tensor(kernel).permute(3, 2, 0, 1), torch.tensor(bias),
                torch.tensor(x), torch.tensor(z), c_eps, inv_sqrt_a, sigma,
                torch.tensor(wv) if w == "per-sample" else wv, tanh)
    assert got.shape == (b, 8, 8, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_out_groups_split_the_channels_into_equal_groups_of_at_most_four():
    """``out_groups``: the fewest groups of at most ``COUT_MAX`` (the
    kernels' template instances 1-4), equal in size, the last masked past
    ``cout`` by fewer than a group; below one channel no kernel."""
    for cout in range(1, 65):
        groups, g = ops.out_groups(cout)
        assert 1 <= g <= ops.COUT_MAX and groups == -(-cout // ops.COUT_MAX)
        assert (groups - 1) * g < cout <= groups * g
    assert ops.out_groups(13) == (4, 4) and ops.out_groups(5) == (2, 3)
    with pytest.raises(ValueError, match="one output channel"):
        ops.out_groups(0)


@pytest.mark.parametrize("cout", list(range(1, 17)) + [20, 33])
def test_head_step_grid_takes_every_pixel_and_output_channel_once(cout):
    """The output-stationary kernel's grid (csrc ``head_step_os_kernel``;
    one channel the band kernels', ``out_group``): block b is band ``b //
    groups`` and channels ``(b % groups) * g`` on, those past ``cout``
    masked: over the grid every (unit, band, output channel) once, and up
    to ``OS_COUT_MAX`` channels one CTA a band takes every channel (h
    read once)."""
    groups, g = ops.out_groups(1) if cout == 1 else ops.os_groups(cout)
    assert (groups == 1) == (cout <= ops.OS_COUT_MAX) and g <= ops.OS_COUT_MAX
    units, bands = 3, 5
    seen = np.zeros((units * bands, cout), np.int64)
    for block in range(units * bands * groups):
        blk, o0 = block // groups, block % groups * g
        for oc in range(g):
            if o0 + oc < cout:
                seen[blk, o0 + oc] += 1
    assert (seen == 1).all()


# The committed models' K1 shapes: (units, height, width, c, CFG, halo), the
# served w=2 and w=0 steps and the exact chain at 64x64 (16 and 4 maps), the
# deep and big models' steps at 128x128 (10 maps), a 1x2 mesh's half of the
# served w=2 features, and a split width (6000 channels on 8x8 maps).
K1_SHAPES = {"serve w=2": (16, 64, 64, 128, True, False),
             "serve w=0": (16, 64, 64, 128, False, False),
             "exact chain": (4, 64, 64, 128, False, False),
             "deep w=2": (10, 128, 128, 128, True, False),
             "big": (10, 128, 128, 256, False, False),
             "big w=2": (10, 128, 128, 256, True, False),
             "half of serve w=2": (16, 32, 64, 128, True, True),
             "half of deep w=2": (10, 64, 128, 128, True, True),
             "half of big w=2": (10, 64, 128, 256, True, True),
             "split width": (1, 8, 8, 6000, True, False)}


# The bf16 crossovers measured on the card (``os_from_bf16``'s docstring):
# (width, c, halo, the least output channels of the output-stationary kernel).
BF16_CROSSOVERS = {"served 64-wide": (64, 128, False, 4), "its halo half": (64, 128, True, 3),
                   "deep 128-wide": (128, 128, False, 4), "big 128-wide": (128, 256, False, 3),
                   "deep halo half": (128, 128, True, 2), "big halo half": (128, 256, True, 2)}


@pytest.mark.parametrize("case", BF16_CROSSOVERS, ids=list(BF16_CROSSOVERS))
def test_bf16_route_takes_the_output_stationary_kernel_from_the_measured_crossover(case):
    """In bf16 ``route`` gives the grouped kernels below the channel count
    where the output-stationary kernel ran faster, and that kernel from
    it, at each committed model's 128-wide or 64-wide step and halo half."""
    width, c, halo, least = BF16_CROSSOVERS[case]
    assert ops.os_from_bf16(width, c, halo) == least
    for cout in range(2, 9):
        name = ops.route(10, width, width, c, torch.bfloat16, cout, halo=halo)[0]
        assert (name == ops.OS_NAMES[torch.bfloat16]) == (cout >= least)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K1_SHAPES, ids=list(K1_SHAPES))
def test_head_step_route_takes_every_output_channel_count(shape, dtype):
    """``route`` gives every ``cout`` from 1 to 16 a kernel (never the
    plain version) at the committed shapes and at a split width: its plan
    within the card's shared memory and threads; from two channels at the
    committed shapes the output-stationary kernel (in bf16 from
    ``os_from_bf16``; below, the grouped kernels' one group), one
    CTA a band taking every output channel (h read once), its shared
    memory within ``SMEM_MAX``; at a split width the split launch, a CTA
    for every (band, output group, range); one channel keeps its plan."""
    units, height, width, c, cfg, halo = K1_SHAPES[shape]
    one = ops.route(units, height, width, c, dtype, 1, cfg, halo=halo)
    for cout in range(1, 17):
        groups, g = ops.out_groups(cout)
        name, plan = ops.route(units, height, width, c, dtype, cout, cfg, halo=halo)
        assert plan.smem_bytes <= ops.SMEM_MAX
        bands = -(-height // plan.rows)
        least = 2 if dtype == torch.float32 else ops.os_from_bf16(width, c, halo)
        if cout >= least and shape != "split width":
            assert name == ops.OS_NAMES[dtype] and isinstance(plan, ops.OsPlan)
            assert plan == ops.os_plan(units, height, width, c, cout, cfg,
                                       element_bytes=ops.ELEMENT_BYTES[dtype])
            assert plan.ctas == units * bands and plan.threads == ops.OS_THREADS
        elif isinstance(plan, ops.SplitPlan):
            assert name == ops.SPLIT_NAMES[dtype]
            assert plan.ctas == units * bands * groups * plan.splits
            assert plan.threads in (ops.BF16_THREADS, ops.HALO_THREADS)
        else:
            assert plan.ctas == units * bands * groups
            assert plan.threads <= ops.MAX_THREADS
            if shape != "split width":  # the band kernels take the committed widths
                assert name == one[0] and cout <= ops.COUT_MAX and groups == 1
        if cout == 1:
            assert (name, plan) == one


# Several output channels that the output-stationary kernel does not take:
# (units, height, width, c, dtype, cout, CFG).  Features of 2**31 elements
# (its offsets are 32-bit: a bf16 128-wide step from 4 channels, an fp32
# 64-wide one from 2), and fp32 maps too wide for its shared memory under
# CFG (at 2 channels from 227 pixels) or for its threads (over 256).
SPLIT_COUT_SHAPES = {"bf16 2**31 elements": (16, 128, 128, 4096, torch.bfloat16, 4, True),
                     "fp32 2**31 elements": (2048, 64, 64, 128, torch.float32, 2, True),
                     "fp32 2**31 elements w=0": (4096, 64, 64, 128, torch.float32, 13, False),
                     "fp32 232 wide w=2": (2, 16, 232, 128, torch.float32, 2, True),
                     "fp32 264 wide w=0": (2, 16, 264, 128, torch.float32, 3, False)}


@pytest.mark.parametrize("shape", SPLIT_COUT_SHAPES, ids=list(SPLIT_COUT_SHAPES))
def test_head_step_route_gives_the_split_launch_where_the_output_stationary_kernel_refuses(
        shape):
    """At several output channels ``route`` gives the split launch of the
    features' type where the output-stationary kernel would overflow its
    32-bit offsets or does not fit the map (in fp32 the band kernels take
    one channel): a CTA for every (band, output group, range)."""
    units, height, width, c, dtype, cout, cfg = SPLIT_COUT_SHAPES[shape]
    name, plan = ops.route(units, height, width, c, dtype, cout, cfg)
    assert name == ops.SPLIT_NAMES[dtype] and isinstance(plan, ops.SplitPlan)
    assert plan.ctas == (units * -(-height // plan.rows) * ops.out_groups(cout)[0]
                         * len(ops.split_ranges(c)))
    if (2 if cfg else 1) * units * height * width * c < 2**31:
        with pytest.raises(ValueError):
            ops.os_plan(units, height, width, c, cout, cfg, element_bytes=ops.ELEMENT_BYTES[dtype])


def test_head_step_route_gives_the_output_stationary_kernel_where_the_grouped_kernels_refuse():
    """Where the output-stationary kernel takes a shape that no grouped
    kernel takes (fp32 at 4 channels on 192-wide maps under CFG: the split
    launch's partials of a one-row band outgrow shared memory), ``route``
    gives it rather than raising."""
    with pytest.raises(ValueError):
        ops.split_plan(8, 192, 192, 64, 4)
    name, plan = ops.route(8, 192, 192, 64, torch.float32, 4)
    assert (name, plan) == (ops.OS_NAMES[torch.float32], ops.os_plan(8, 192, 192, 64, 4))


@pytest.mark.parametrize("cout", range(1, 17))
def test_head_step_plans_size_weights_and_partials_by_the_group(cout):
    """Each plan's shared memory at ``cout`` channels.  The grouped
    kernels' (several channels only where the output-stationary kernel
    does not take them): the weights' rows and the partials grow with the
    group ``g`` (bf16: B's ``b_columns(g)`` rows, 16 at one channel, 24,
    32, 40), so at one channel every plan is the one it was; the float
    template and the fp32 band kernels take one channel, the template's
    ring holding its 18 partials a thread pair.  The output-stationary plan's,
    from two channels, at the served, deep and big steps and their halo
    halves in both types: one CTA a band for every output channel, its
    ring of chunks of h and weights (no partials) and sources within
    ``SMEM_MAX``, bf16 rows ``16 / os_tiles(width)`` a set, fp32
    ``OS_THREADS // width``."""
    if cout > 1:
        for units, height, width, c in ((16, 64, 64, 128), (16, 32, 64, 128),
                                        (10, 128, 128, 128), (10, 64, 128, 128),
                                        (10, 128, 128, 256), (10, 64, 128, 256)):
            for cfg in (True, False):
                for eb in (4, 2):
                    p = ops.os_plan(units, height, width, c, cout, cfg, element_bytes=eb)
                    per_set = 16 // ops.os_tiles(width) if eb == 2 else ops.OS_THREADS // width
                    assert p.rows == (per_set if cfg else 2 * per_set)
                    staged = ops.os_tiles(width) * 16 + 2 if eb == 2 else width + 2
                    npix = (2 if cfg else 1) * (p.rows + 2) * staged
                    co = (8 if cout <= 8 else 16) if eb == 2 else cout
                    stage = npix * ops.OS_PIXEL_BYTES[eb] + ops.OS_WEIGHT_BYTES * co
                    assert p.smem_bytes == ops.OS_STAGES * stage + 8 * npix <= ops.SMEM_MAX
                    assert p.ctas == units * -(-height // p.rows)
    groups, g = ops.out_groups(cout)
    if cout > 1:  # the float template and the fp32 band kernels take one channel
        with pytest.raises(ValueError, match="one output channel"):
            ops.launch_plan(16, 64, 64, 128, cout)
        with pytest.raises(ValueError, match="one output channel"):
            ops.halo_plan(16, 32, 64, 128, cout)
    else:
        p = ops.launch_plan(16, 64, 64, 128)
        ring = max(4 * p.stages * 2 * p.threads * ops.staged_stride(p.ck), 4 * 9 * 2 * p.threads)
        assert p.smem_bytes == 4 * 9 * 128 + ring <= ops.SMEM_MAX
        assert (p.rows, p.threads, p.ck, p.stages) == (4, 384, 32, 2)
        hp = ops.halo_plan(16, 32, 64, 128)
        m = 2 * (hp.rows + 2) * 64
        assert hp.smem_bytes == 4 * (9 * 128 + 8 * ops.HALO_RING * ops.HALO_TILE * ops.HALO_CK
                                     + 9 * -(-m // ops.HALO_TILE) * ops.HALO_TILE)
    b = ops.bf16_plan(16, 64, 64, 128, cout)
    m = 2 * (b.rows + 2) * 64
    assert ops.b_columns(g) == -(-9 * g // 8) * 8
    assert b.smem_bytes == (2 * ops.b_columns(g) * ops.weight_stride(128)
                            + 2 * 8 * ops.BF16_RING * ops.BF16_TILE * ops.BF16_BLOCK
                            + 4 * 9 * g * ops.partial_stride(m)) <= ops.SMEM_MAX
    for eb in (4, 2):
        sp = ops.split_plan(1, 8, 8, 6000, cout, element_bytes=eb)
        assert sp.smem_bytes <= ops.SMEM_MAX and sp.splits == len(ops.split_ranges(6000))


# K2's statistics and apply launches: (n, hw, c, element bytes) where a
# pixel's channels are whole packs but a group's are not.
STRADDLE_SHAPES = {"n_feat 1032 up0_norm fp32": (32, 256, 2064, 4),
                   "n_feat 1032 up0_norm bf16": (32, 256, 2064, 2),
                   "n_feat 136 out_norm half fp32": (32, 32 * 64, 136, 4),
                   "n_feat 136 up0_norm half bf16": (32, 8 * 16, 272, 2),
                   "n_feat 264 out_norm half bf16": (32, 32 * 64, 264, 2),
                   "n_feat 264 up0_norm half fp32": (32, 8 * 16, 528, 4),
                   "n_feat 40 out_norm fp32 (5 a group)": (32, 32 * 64, 40, 4)}


@pytest.mark.parametrize("shape", STRADDLE_SHAPES, ids=list(STRADDLE_SHAPES))
def test_groupnorm_statistics_and_apply_plans_take_packs_that_straddle_groups(shape):
    """16-byte packs (4 fp32, 8 bf16) for both launches where a group's
    channels are not whole packs, groups at least a pack wide: the
    statistics a unit of one group, its threads the packs that overlap the
    group; n_feat 1032's up0_norm the pair on one card with both."""
    n, hw, c, eb = STRADDLE_SHAPES[shape]
    wide = 16 // eb
    assert c // 8 % wide and c % wide == 0
    sp = groupnorm_ops.stats_plan(n, hw, c, 8, True, eb)
    ap = groupnorm_ops.apply_plan(n, hw, c, 8, True, eb)
    assert sp.vec == ap.vec == wide and sp.seg == 1
    cg = c // 8
    vs = groupnorm_ops.straddle_packs(8, cg, wide)
    assert vs == max(((g + 1) * cg - 1) // wide - g * cg // wide + 1 for g in range(8))
    assert -(-cg // wide) <= vs <= -(-cg // wide) + 1
    assert sp.threads % 32 == 0 and sp.threads <= groupnorm_ops.STATS_MAX_THREADS
    if c == 2064:
        dtype = torch.float32 if eb == 4 else torch.bfloat16
        name, plan = groupnorm_ops.single_route(n, hw, c, 8, dtype)
        assert name == groupnorm_ops.PAIR_NAMES[dtype] and plan == (sp, ap)


@pytest.mark.parametrize("c,groups,eb,aligned", [(2064, 8, 2, False), (136, 8, 4, False),
                                                 (68, 4, 2, True), (40, 8, 2, True),
                                                 (24, 8, 4, True)])
def test_groupnorm_statistics_and_apply_plans_keep_elements_where_packs_cannot_go(
        c, groups, eb, aligned):
    """The element path stays where a pointer is unaligned, a pixel's
    channels are not whole packs (68 bf16 channels) or a group is narrower
    than a pack (n_feat 40's 5 channels in bf16, 3 in fp32)."""
    assert groupnorm_ops.stats_plan(4, 64, c, groups, aligned, eb).vec == 1
    assert groupnorm_ops.apply_plan(4, 64, c, groups, aligned, eb).vec == 1


@pytest.mark.parametrize("c,vec", [(2064, 8), (2064, 4), (136, 8), (272, 4), (528, 8), (40, 4)])
def test_groupnorm_apply_pack_split_gives_each_element_its_group(c, vec):
    """The apply kernel's straddling pack (csrc ``groupnorm_apply_kernel``):
    pack j's group ``g = j vec / cg`` and split point ``(g + 1) cg - j
    vec`` put element e in group g before the split and g + 1 from it,
    every channel's own group."""
    cg = c // 8
    for j in range(c // vec):
        ch = j * vec
        g = ch // cg
        split = (g + 1) * cg - ch
        for e in range(vec):
            assert (g if e < split else g + 1) == (ch + e) // cg
