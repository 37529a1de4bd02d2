"""PyTorch port: the fp32 kernels of their own at the deep and big variants'
heads, on the CPU.

K2's large-slice kernel (``csrc/groupnorm.cu``, ``groupnorm_f32_large_kernel``)
and K1's band kernel (``csrc/head_step.cu``, ``head_step_f32_band_kernel``):
their plans (every pixel and channel read once and written once, no spill,
within the on-chip budget), the routes that give them their shapes (and
leave every served 64x64 shape its kernel), and their arithmetic emulated
in the kernels' order (Chan's merge per thread, lane, warp and rank; the
per-tap partials of the band's quarters, then the 3x3 gather) against the
JAX package's ``GroupNormAct`` and its step at the variants' widths.  Also
the repair of K2's shadowed CTA size: the template's large-slice CTA and
the bf16 wide layout's pinned by value, and no module-level name of
``ops/*.py`` bound twice.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camels_diffusion_model_tpu.diffusion import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.diffusion.sampler import _combine_cfg
from camels_diffusion_model_tpu.models.blocks import GroupNormAct as JaxGroupNormAct
from camels_diffusion_model_tpu.ops.pallas import fused_p_sample_step as jax_fused_p_sample_step
from camels_diffusion_model_tpu_torch.diffusion.schedule import ddpm_coefficients, make_schedule
from camels_diffusion_model_tpu_torch.ops import groupnorm as groupnorm_ops
from camels_diffusion_model_tpu_torch.ops import sampler_step as sampler_step_ops
from camels_diffusion_model_tpu_torch.ops.groupnorm import groupnorm_apply_plain

F32, BF16 = torch.float32, torch.bfloat16
OPS = pathlib.Path(groupnorm_ops.__file__).parent
# K2 at the variants' out_norm (n, hw, c, act) and K1 at their step.
OUT_NORMS = {f"{v} out_norm, {n} maps": (n, 128 * 128, c, act)
             for n in (2, 10, 20, 32)
             for v, c, act in (("deep", 128, "leaky_relu"), ("big", 256, "gelu"))}


# ---- the repair: no name bound twice, the CTAs pinned ------------------------

def _module_bindings(tree) -> list:
    """Plain names a module binds at its top level: assignment targets
    (tuples unpacked), annotated and augmented assignments, ``def`` and
    ``class``; not attributes (``fused_film.launches = 0``)."""
    names = []

    def targets(node):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                targets(elt)

    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                targets(t)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets(node.target)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
    return names


@pytest.mark.parametrize("path", sorted(OPS.glob("*.py")), ids=lambda p: p.name)
def test_no_module_level_name_is_bound_twice(path):
    """A second binding of a module-level name silently replaces the first
    for every later reader (a second ``WIDE_THREADS`` once gave the fp32
    template's large slices the bf16 wide layout's 384 threads)."""
    names = _module_bindings(ast.parse(path.read_text()))
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice, f"{path.name} binds {twice} more than once"


def test_module_bindings_catch_a_rebinding():
    """The walk above sees a plain name bound twice, through a tuple or a
    ``def``, and no attribute."""
    tree = ast.parse("A = 1\nB, A = 2, 3\nf.count = 0\nf.count = 1\ndef g(): pass\ng = 4\n")
    names = _module_bindings(tree)
    assert sorted({n for n in names if names.count(n) > 1}) == ["A", "g"]


@pytest.mark.parametrize("n", [10, 32])
def test_template_and_bf16_wide_ctas_are_pinned_by_value(n):
    """The float template's CTA at a slice over ``SLICE_TARGET``, as
    ``scripts/compare_torch_kernels.py --variants`` and ``--template``
    timed 384 against 512 threads in turns: 512 where the slice leaves its
    SM no room for a second CTA (the deep out_norm's 128 KiB, n_feat 224's
    224 KiB at 128x128), 384 where it does (n_feat 224's 56 KiB and 448's
    112 KiB at 64x64); 256 at slices of up to 48 KiB.  The bf16 wide
    layout's CTA at n_feat 264's 2-map out_norm: 384 threads (11 pixels of
    33 packs, 21 lanes idle)."""
    for c in (128, 224):
        assert groupnorm_ops.launch_plan(n, 128 * 128, c, 8).threads == 512
    for c in (224, 448):
        assert groupnorm_ops.launch_plan(n, 64 * 64, c, 8).threads == 384
    assert groupnorm_ops.launch_plan(n, 64 * 64, 128, 8).threads == 256
    plan = groupnorm_ops.narrow_plan(4, 64 * 64, 264, 8)
    assert plan.wide and plan.threads == 384


# ---- K2's large-slice plan ---------------------------------------------------

def _large_passes(plan, hw, cg):
    """The large-slice kernel's index map under ``plan`` over one group of
    ``hw`` pixels of ``cg`` channels: per (pixel, channel), how often a
    thread reads it into the statistics (from a box in shared memory or
    its registers) and how often it is written (a whole box by its tensor
    store, the box past the part's end and the register packs by the
    threads' own stores)."""
    reads = np.zeros((hw, cg), np.int64)
    writes = np.zeros((hw, cg), np.int64)
    vpg = cg // 4
    pstride = plan.threads // vpg
    resident = plan.boxes * plan.box_px
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        np_ = min(hw, p0 + plan.part_px) - p0
        used = min(plan.boxes, -(-np_ // plan.box_px))
        for b in range(used):
            if (b + 1) * plan.box_px <= np_:
                writes[p0 + b * plan.box_px:p0 + (b + 1) * plan.box_px] += 1
        cross = used * plan.box_px > np_  # the last box runs past the part
        for t in range(pstride * vpg):
            j = slice((t % vpg) * 4, (t % vpg) * 4 + 4)
            f = t // vpg
            on_chip = slice(p0 + f, p0 + min(resident, np_), pstride)
            reads[on_chip, j] += 1
            if cross:
                first_cross = (used - 1) * plan.box_px
                p = f + -(-max(0, first_cross - f) // pstride) * pstride
                writes[p0 + p:p0 + min(resident, np_):pstride, j] += 1
            regs = slice(p0 + resident + f,
                         p0 + min(np_, resident + f + groupnorm_ops.LARGE_PACKS * pstride),
                         pstride)
            reads[regs, j] += 1
            writes[regs, j] += 1
    return reads, writes


def _on_chip_budget(plan, cg):
    """The plan's shared memory within a CTA's 227 KiB and ``per_sm`` CTAs'
    within an SM's 228 KiB (1 KiB a CTA, the static arrays), and its boxes
    and box shape within the kernel's and the tensor copy's limits."""
    ops = groupnorm_ops
    assert plan.smem_bytes == 128 + plan.boxes * plan.box_px * cg * 4
    assert plan.smem_bytes + ops.LARGE_STATIC <= 227 * 1024
    assert plan.per_sm * (plan.smem_bytes + ops.LARGE_STATIC + 1024) <= ops.SM_SMEM
    assert plan.boxes <= ops.LARGE_MAX_BOXES and plan.box_px <= ops.LARGE_BOX_PX
    assert plan.box_px % 8 == 0 and cg % plan.box_ch == 0 and cg // plan.box_ch <= 256


@pytest.mark.parametrize("shape", list(OUT_NORMS))
def test_large_plan_at_the_variant_shapes(shape):
    """The deep and big out_norm at 2, 10, 20 and 32 maps: every pixel and
    channel read once into the statistics and written once, nothing read
    again (no spill); the deep part (128 KiB) as 7 boxes of 256 pixels and
    2 register packs a thread, two CTAs an SM; the big part (256 KiB) as 7
    boxes of 32 KiB and 4 packs, one CTA an SM."""
    n, hw, c, _ = OUT_NORMS[shape]
    plan = groupnorm_ops.large_plan(n, hw, c, 8)
    cg = c // 8
    reads, writes = _large_passes(plan, hw, cg)
    assert (reads == 1).all() and (writes == 1).all()
    _on_chip_budget(plan, cg)
    assert (plan.cluster, plan.threads, plan.part_px, plan.boxes, plan.box_px) == (
        8, 512, 2048, 7, 256)
    assert plan.per_sm == (2 if c == 128 else 1)
    rest = plan.part_px - plan.boxes * plan.box_px
    assert rest == (2 if c == 128 else 4) * (plan.threads // (cg // 4))  # packs of the 4


@pytest.mark.parametrize("hw,c,budget_boxes", [(150, 64, 1), (40, 64, None), (4096, 224, None),
                                               (150, 32, 2)])
def test_large_plan_forced_small(monkeypatch, hw, c, budget_boxes):
    """Plans forced at small sizes, as the template's plan test forces
    one: boxes of 8 pixels and a shared-memory budget of ``budget_boxes``
    of them (the rest of each part in registers, a last rank shorter than
    the others), parts shorter than a box (the box past the part's end
    written by the threads), and groups of 28 channels (7 packs, a lane
    idle): every pixel and channel read once and written once.  A part
    over every budget raises."""
    ops = groupnorm_ops
    if budget_boxes is not None:
        monkeypatch.setattr(ops, "LARGE_BOX_PX", 8)
        cg = c // 8
        overhead = 1024 + ops.LARGE_STATIC + 128
        monkeypatch.setattr(ops, "SM_SMEM", 2 * (budget_boxes * 8 * cg * 4 + overhead))
    plan = ops.large_plan(2, hw, c, 8)
    reads, writes = _large_passes(plan, hw, c // 8)
    assert (reads == 1).all() and (writes == 1).all()
    if budget_boxes is not None:
        assert plan.boxes == budget_boxes and plan.box_px == 8
        assert plan.part_px > plan.boxes * plan.box_px  # registers hold the rest
    with pytest.raises(ValueError, match="over the large-slice kernel"):
        ops.large_plan(2, 128 * 128 * 16, c, 8)


def test_large_plan_refuses_what_it_does_not_take():
    """Channels a group not whole packs, an unaligned pointer, a part over
    its budget (n_feat 384 at 128x128: 384 KiB a CTA, which the pair
    takes) raise."""
    with pytest.raises(ValueError, match="multiple of 4"):
        groupnorm_ops.large_plan(10, 128 * 128, 200, 8)
    with pytest.raises(ValueError, match="aligned"):
        groupnorm_ops.large_plan(10, 128 * 128, 128, 8, aligned=False)
    with pytest.raises(ValueError, match="over the large-slice kernel"):
        groupnorm_ops.large_plan(10, 128 * 128, 384, 8)


# ---- the routes ---------------------------------------------------------------

def test_single_route_takes_the_large_kernel_exactly_where_stated():
    """fp32 K2 takes the large-slice kernel exactly where the template's
    slice is over ``SLICE_TARGET`` in groups of whole 32-byte sectors (8
    channels) and its budget holds the part: the deep and big out_norm, the
    128x128 family's at n_feat 64, 128, 192 and 256, the canonical out_norm
    from n_feat 256 in steps of 64, the three-level up0_norm only from
    n_feat 784 (no committed model's).  Groups of 4 mod 8 channels (n_feat
    224's 28) and the scalar groups (n_feat 200 at 64x64) keep the
    template, bf16 never takes it, and the served shapes keep their
    kernels."""
    ops = groupnorm_ops
    large = []
    for n_feat in range(8, 1025, 8):
        for label, hw, c in (("canonical out_norm", 64 * 64, n_feat),
                             ("three-level out_norm", 128 * 128, n_feat),
                             ("up0_norm", 16 * 16, 4 * n_feat)):
            for n in (2, 10, 32):
                name, plan = ops.single_route(n, hw, c, 8, F32)
                over = c // 8 % 8 == 0 and -(-hw // 8) * (c // 8) * 4 > ops.SLICE_TARGET
                try:
                    fits = ops.large_plan(n, hw, c, 8)
                except ValueError:
                    fits = None
                if over and fits is not None:
                    assert (name, plan) == (ops.LARGE_NAME, fits)
                    large.append((label, n_feat))
                    continue
                try:
                    tp = ops.launch_plan(n, hw, c, 8)
                except ValueError:  # over SLICE_MAX: no spill, the pair
                    assert name == ops.PAIR_NAMES[F32]
                    continue
                assert (name, plan) == (ops.C_NAME, tp)
                assert ops.single_route(n, hw, c, 8, BF16)[0] != ops.LARGE_NAME
    feats = {label: sorted({f for lb, f in large if lb == label}) for label, _ in large}
    assert feats["canonical out_norm"][:3] == [256, 320, 384]
    assert feats["three-level out_norm"] == [64, 128, 192, 256]
    assert feats["up0_norm"][0] == 784
    for c in (200, 224):
        assert ops.single_route(32, 64 * 64, c, 8, F32)[0] == ops.C_NAME
    for c in (320, 384, 448, 512):  # over the large kernel's budget and SLICE_MAX
        assert ops.single_route(10, 128 * 128, c, 8, F32)[0] == ops.PAIR_NAMES[F32]
    for n, hw, c in ((32, 16 * 16, 256), (32, 64 * 64, 128), (16, 64 * 64, 128),
                     (4, 64 * 64, 128), (32, 32 * 32, 128)):  # the served shapes
        assert ops.single_route(n, hw, c, 8, F32) == (ops.C_NAME, ops.launch_plan(n, hw, c, 8))
        assert ops.single_route(n, hw, c, 8, BF16)[0] == ops.BF16_NAME


def test_k1_route_takes_the_band_kernel_from_width_128():
    """fp32 unsharded K1 takes the band kernel under :func:`halo_plan` at
    the deep and big steps under CFG and at the deep step without, at
    every batch, in bands of 2 rows at 128 channels and 4 at 256; the big
    step without CFG, the served 64x64 steps keep the template, the halo
    mode its kernel, bf16 its kernels; weights over the band kernel's
    shared memory take the split launch."""
    ops = sampler_step_ops
    for units in (1, 2, 5, 10, 16):
        for c in (128, 256):
            for cfg in (False, True):
                args = (units, 128, 128, c)
                if cfg or c == 128:
                    plan = ops.halo_plan(*args, cfg=cfg, rows=2 if c == 128 else 4)
                    assert ops.route(*args, F32, cfg=cfg) == (ops.F32_BAND_NAME, plan)
                    assert plan.rows == (2 if c == 128 else 4)
                else:
                    assert ops.route(*args, F32, cfg=cfg) == (
                        ops.C_NAME, ops.launch_plan(*args, cfg=cfg))
                assert ops.route(*args, BF16, cfg=cfg)[0] == ops.BF16_NAME
                assert ops.route(units, 64, 128, c, F32, cfg=cfg, halo=True)[0] == (
                    ops.HALO_NAMES[F32])
    for units, cfg in ((16, True), (16, False), (4, False)):
        assert ops.route(units, 64, 64, 128, F32, cfg=cfg) == (
            ops.C_NAME, ops.launch_plan(units, 64, 64, 128, cfg=cfg))
    assert ops.route(10, 128, 128, 4800, F32)[0] == ops.SPLIT_NAMES[F32]


# ---- the arithmetic, emulated in the kernels' order ----------------------------

def _merge(a, b):
    """The kernels' Chan merge of moments ``a`` then ``b`` (count, mean,
    M2 tensors), b skipped where its count is 0."""
    an, am, aq = a
    bn, bm, bq = b
    n = an + bn
    f = bn / torch.where(n > 0, n, torch.ones_like(n))
    d = bm - am
    merged = (n, am + d * f, aq + bq + d * d * an * f)
    return tuple(torch.where(bn == 0, u, v) for u, v in zip(a, merged))


def _large_moments(x, groups, plan):
    """``(B, G, 3)`` fp32 (count, mean, M2) of NHWC ``x`` as the
    large-slice kernel merges them: each thread's packs (a pack's centred
    moments) in order, the boxes' pixels then its register packs; the
    lanes in a butterfly, lower lane first; the warps in order; the
    cluster's ranks in order."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // groups
    vpg = cg // 4
    pstride = plan.threads // vpg
    resident = plan.boxes * plan.box_px
    xs = x.float().reshape(b, hw, groups, vpg, 4)
    t = torch.arange(plan.threads)
    j = t % vpg
    zero = torch.zeros(b, groups, plan.threads)
    ranks = []
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        np_ = min(hw, p0 + plan.part_px) - p0
        first = torch.where(t < pstride * vpg, t // vpg, torch.full_like(t, np_))
        m = (zero, zero, zero)
        steps = [first + k * pstride for k in range(-(-min(resident, np_) // pstride))]
        limits = [min(resident, np_)] * len(steps)
        steps += [resident + first + i * pstride for i in range(groupnorm_ops.LARGE_PACKS)]
        limits += [np_] * groupnorm_ops.LARGE_PACKS
        for p, limit in zip(steps, limits):
            valid = p < limit
            v = xs[:, p0 + p.clamp(0, max(np_ - 1, 0)), :, j, :].permute(1, 2, 0, 3)
            pm = (v[..., 0] + v[..., 1] + v[..., 2] + v[..., 3]) * 0.25
            pq = torch.zeros_like(pm)
            for e in range(4):
                pq = pq + (v[..., e] - pm) * (v[..., e] - pm)
            four = torch.where(valid, torch.full_like(pm, 4.0), torch.zeros_like(pm))
            m = _merge(m, (four, pm, pq))
        m = tuple(v.reshape(b, groups, -1, 32) for v in m)
        lane = torch.arange(32)
        for off in (1, 2, 4, 8, 16):
            o = tuple(v[..., lane ^ off] for v in m)
            hi = (lane & off) != 0
            m = tuple(torch.where(hi, u, v) for u, v in zip(_merge(o, m), _merge(m, o)))
        block = (zero[..., 0],) * 3
        for warp in range(plan.threads // 32):
            block = _merge(block, tuple(v[..., warp, 0] for v in m))
        ranks.append(block)
    total = ranks[0]
    for r in ranks[1:]:
        total = _merge(total, r)
    return torch.stack(total, dim=-1)


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("c,act", [(128, "leaky_relu"), (256, "gelu")])
def test_large_kernel_arithmetic_matches_jax_group_norm_act(c, act, film):
    """The large-slice kernel's statistics, emulated in its order under its
    plan at the deep and big out_norm (2 maps of 128x128), then its
    normalise, act and FiLM epilogue, against the JAX package's
    ``GroupNormAct`` (two-pass fp32, ``models/blocks.py:322-330``; FiLM as
    the decoder applies it): atol 2e-5 on outputs up to ~10 (two fp32
    orders of the statistics' sums); the merged mean and M2 within 2e-6
    and 1e-5 relative of float64."""
    rs = np.random.RandomState(c + film)
    x = (rs.randn(2, 128, 128, c) * 2 + 0.5).astype(np.float32)
    gamma, beta = rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)
    plan = groupnorm_ops.large_plan(2, 128 * 128, c, 8)
    stats = _large_moments(torch.tensor(x), 8, plan)
    xg = x.astype(np.float64).reshape(2, -1, 8, c // 8)
    mean = xg.mean(axis=(1, 3))
    m2 = ((xg - mean[:, None, :, None]) ** 2).sum(axis=(1, 3))
    np.testing.assert_array_equal(stats[..., 0].numpy(), 128 * 128 * c // 8)
    np.testing.assert_allclose(stats[..., 1].numpy(), mean, rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(stats[..., 2].numpy(), m2, rtol=1e-5)
    want = np.asarray(JaxGroupNormAct(num_groups=8, epsilon=1e-5, act=act).apply(
        {"params": {"scale": gamma, "bias": beta}}, x))
    rows = None
    if film:
        rows = (rs.randn(2, c).astype(np.float32), rs.randn(1, c).astype(np.float32))
        want = rows[0][:, None, None, :] * want + rows[1][:, None, None, :]
    got = groupnorm_apply_plain(torch.tensor(x), stats[None], torch.tensor(gamma),
                                torch.tensor(beta), 8, 1e-5, act,
                                None if rows is None else tuple(map(torch.tensor, rows)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def _band_step(h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, w, tanh):
    """The band kernel's arithmetic on whole maps: each pixel's nine per-tap
    partials summed by its lanes' quarters (channels 8 q .. 8 q + 7 of
    every 32, in order), the quarters' sums paired ((0 + 1) + (2 + 3));
    then each output pixel's gather (the bias, then the taps in (ky, kx)
    order, zero outside the map), tanh per branch, the guidance combine
    and the step."""
    n, height, width, c = h.shape
    c32 = -(-c // 32) * 32
    hp = torch.zeros(n, height, width, c32)
    hp[..., :c] = h
    wt = torch.zeros(9, c32)
    wt[:, :c] = weight[0].permute(1, 2, 0).reshape(9, c)
    quarters = []
    for q in range(4):
        acc = torch.zeros(n, height, width, 9)
        for cb in range(c32 // 32):
            for k in range(8):
                ch = cb * 32 + 8 * q + k
                acc = acc + hp[..., ch, None] * wt[:, ch]
        quarters.append(acc)
    part = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
    padded = torch.zeros(n, height + 2, width + 2, 9)
    padded[:, 1:-1, 1:-1] = part
    eps = torch.full((n, height, width), float(bias[0]))
    for ky in range(3):
        for kx in range(3):
            eps = eps + padded[:, ky:ky + height, kx:kx + width, ky * 3 + kx]
    if tanh:
        eps = torch.tanh(eps)
    b = x.shape[0]
    if w is not None:
        wu = w.reshape(-1, 1, 1) if torch.is_tensor(w) else w
        eps = eps[b:] + wu * (eps[:b] - eps[b:])
    out = (x[..., 0] - eps * c_eps) * inv_sqrt_a
    return (out + sigma * z[..., 0])[..., None]


@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("c", [128, 256])
def test_band_kernel_arithmetic_matches_jax_step(c, w):
    """The band kernel's partials and gather (:func:`_band_step`) on whole
    128x128 maps at the deep and big widths, with the tanh of their output
    layer, against the JAX decoder's end (``context_unet.py:314-316``: the
    conv, tanh), the guidance combine and the Pallas step in interpret
    mode: atol 2e-5 (fp32 sums of 9 c terms in two orders)."""
    T, t, b = 50, 17, 2
    cfg = w is not None
    rs = np.random.RandomState(c + 3)
    h = np.maximum(rs.randn(2 * b if cfg else b, 128, 128, c), 0).astype(np.float32)
    kernel = (rs.randn(3, 3, c, 1) / (3 * c**0.5)).astype(np.float32)
    bias = rs.randn(1).astype(np.float32)
    x, z = (rs.randn(b, 128, 128, 1).astype(np.float32) for _ in range(2))
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
    got = _band_step(torch.tensor(h), weight, torch.tensor(bias), torch.tensor(x),
                     torch.tensor(z), c_eps, inv_sqrt_a, sigma, w_t, True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
