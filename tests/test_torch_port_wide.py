"""PyTorch port at every model width the JAX package computes: the routes
of K1 (out_conv2 + step), K2 (GroupNorm + act) and K3 (FiLM) take every
shape a canonical or three-level model of ``n_feat`` 8 to 4096 gives them,
the split K1's ranges and copy map, the split and pair launches' plain
arithmetic, and a canonical n_feat 1032 model against the JAX package."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu_torch.models import blocks, context_unet
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.ops import film as film_ops
from camels_diffusion_model_tpu_torch.ops import groupnorm as groupnorm_ops
from camels_diffusion_model_tpu_torch.ops import sampler_step as sampler_step_ops
from camels_diffusion_model_tpu_torch.serving import load_model

F32, BF16 = torch.float32, torch.bfloat16
MAPS = (1, 2, 10, 15, 16)
FAMILIES = {"canonical": (64, 2), "three-level": (128, 4)}  # height, cb / n_feat


def model_shapes(family: str, n_feat: int, maps: int, cfg: bool) -> dict:
    """The shapes a model of ``family`` (canonical: 64x64, two levels;
    three-level: the deep and big models, 128x128) at ``n_feat`` gives
    each kernel at a reverse step of ``maps`` maps (a decoder batch of
    ``2 maps`` under CFG), whole and on one half of a (1 x 2) mesh:
    K2's ``(n, hw, c)`` at up0_norm (the bottleneck's ``cb`` channels at
    16x16) and out_norm, K3's at FiLM stage 1 (32x32), K1's ``(units,
    height, width, c)``."""
    height, widen = FAMILIES[family]
    n = maps * (2 if cfg else 1)
    stage1 = n_feat if family == "canonical" else 2 * n_feat
    return {"up0_norm": (n, 16 * 16, widen * n_feat), "out_norm": (n, height * height, n_feat),
            "film": (n, 32 * 32, stage1), "head_step": (maps, height, height, n_feat),
            "up0_norm half": (n, 8 * 16, widen * n_feat),
            "out_norm half": (n, height // 2 * height, n_feat),
            "film half": (n, 16 * 32, stage1), "head_step half": (maps, height // 2, height, n_feat)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_wide_sweep_shapes_are_the_models(family, monkeypatch):
    """:func:`model_shapes` at n_feat 8, 2 maps under CFG, against the
    shapes a decoder call hands K2 and K3 and out_conv2's features."""
    calls = []

    def spy(name, fn):
        def wrapped(x, *args, **kwargs):
            calls.append((name, tuple(x.shape)))
            return fn(x, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(blocks, "fused_groupnorm_act", spy("K2", blocks.fused_groupnorm_act))
    monkeypatch.setattr(context_unet, "fused_film", spy("K3", context_unet.fused_film))
    height, _ = FAMILIES[family]
    model = (ContextUnet.canonical(n_feat=8) if family == "canonical"
             else ContextUnet.deep(n_feat=8))
    x = torch.zeros(4, height, height, 1)
    with torch.no_grad():
        feats = model.decode_features(model.encode(x), torch.zeros(4), None)
    shapes = model_shapes(family, 8, 2, True)
    nhwc = [(n, hw, c) for _, (n, h, w, c) in calls for hw in [h * w]]
    assert [name for name, _ in calls] == ["K2", "K3", "K2"]
    assert nhwc == [shapes["up0_norm"], shapes["film"], shapes["out_norm"]]
    assert tuple(feats.shape) == (4, 8, height, height)
    assert shapes["head_step"] == (2, height, height, 8)


def _k1_band_route(units, height, width, c, dtype, cfg, halo):
    """K1's band kernel and plan where they take the shape (the fp32
    unsharded launch: the band kernel from ``BAND_WIDTH`` under CFG or at
    up to ``BAND_NARROW_C`` channels, else the template), else None."""
    ops = sampler_step_ops
    if (2 if cfg else 1) * units * height * width * c >= 2**31:
        return None
    try:
        narrow = c <= ops.BAND_NARROW_C
        band = width >= ops.BAND_WIDTH and (cfg or narrow)
        if dtype == F32 and not halo and not band:
            return ops.C_NAME, ops.launch_plan(units, height, width, c, cfg=cfg)
        if dtype == F32 and not halo:
            return ops.F32_BAND_NAME, ops.halo_plan(units, height, width, c, cfg=cfg,
                                                    rows=ops.BAND_ROWS[narrow])
        if dtype == F32:
            return ops.HALO_NAMES[F32], ops.halo_plan(units, height, width, c, cfg=cfg)
        plan = ops.bf16_plan(units, height, width, c, cfg=cfg)
    except ValueError:
        return None
    narrow = plan.block == ops.BF16_NARROW_BLOCK
    names = ((ops.HALO_NARROW_NAME, ops.HALO_NAMES[BF16]) if halo
             else (ops.BF16_NARROW_NAME, ops.BF16_NAME))
    return names[0] if narrow else names[1], plan


def _k2_single_route(n, hw, c, dtype):
    """K2's single launch and plan where one takes the shape, else None:
    in fp32 the large-slice kernel where a group's slice over a cluster of
    8 is over ``SLICE_TARGET`` in whole 32-byte sectors and its budget
    holds the part, else the template where its plan takes the shape (a
    slice of at most ``SLICE_MAX``)."""
    ops = groupnorm_ops
    plans = ((ops.C_NAME, lambda: ops.launch_plan(n, hw, c, 8)),)
    if dtype == F32 and c // 8 % 8 == 0 and -(-hw // 8) * (c // 8) * 4 > ops.SLICE_TARGET:
        plans = ((ops.LARGE_NAME, lambda: ops.large_plan(n, hw, c, 8)),) + plans
    if dtype != F32:
        plans = ((ops.BF16_NAME, lambda: ops.bf16_plan(n, hw, c, 8)),
                 (ops.BF16_NARROW_NAME, lambda: ops.narrow_plan(n, hw, c, 8)),
                 (ops.BF16_GENERIC_NAME, lambda: ops.launch_plan(n, hw, c, 8, True, 2)))
    for name, plan in plans:
        try:
            return name, plan()
        except ValueError:
            pass
    return None


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_model_width_takes_a_kernel(family, dtype):
    """For every n_feat a multiple of 8 from 8 to 4096, at 1, 2, 10, 15
    and 16 maps, with and without CFG: K1 unsharded and on a (1 x 2)
    half, K2 at up0_norm and out_norm (the single launch, and the sharded
    statistics and apply launches on the halves) and K3 at FiLM stage 1
    each get a plan; no route raises.  Where the band kernels, the single
    launches and K3's one-access-a-thread plan take a shape, as they did
    before the split and pair launches (their plans unchanged; the fp32
    unsharded K1 from width 128 and K2 at slices over 48 KiB in whole
    packs on the kernels of their own), the routes keep their names and
    plans; K1 takes the split launch and K2
    the pair on one card exactly elsewhere."""
    eb = groupnorm_ops.ELEMENT_BYTES[dtype]
    splits = pairs = wide_film = 0
    for n_feat in range(8, 4097, 8):
        for maps in MAPS:
            for cfg in (True, False):
                s = model_shapes(family, n_feat, maps, cfg)
                for key, halo in (("head_step", False), ("head_step half", True)):
                    got = sampler_step_ops.route(*s[key], dtype, cfg=cfg, halo=halo)
                    band = _k1_band_route(*s[key], dtype, cfg, halo)
                    if band is None:
                        splits += 1
                        assert got == (sampler_step_ops.SPLIT_NAMES[dtype],
                                       sampler_step_ops.split_plan(*s[key], cfg=cfg,
                                                                   element_bytes=eb))
                    else:
                        assert got == band
                for head in ("up0_norm", "out_norm"):
                    got = groupnorm_ops.single_route(*s[head], 8, dtype)
                    single = _k2_single_route(*s[head], dtype)
                    if single is None:
                        pairs += 1
                        assert got[0] == groupnorm_ops.PAIR_NAMES[dtype]
                    else:
                        assert got == single
                    half = s[f"{head} half"]
                    groupnorm_ops.stats_plan(*half, 8, True, eb)
                    groupnorm_ops.apply_plan(*half, 8, True, eb)
                for key in ("film", "film half"):
                    plan = film_ops.launch_plan(*s[key], element_bytes=eb)
                    per_pixel = s[key][2] // plan.vec
                    if per_pixel <= film_ops.MAX_THREADS:
                        assert plan.threads == per_pixel * max(1, film_ops.THREADS // per_pixel)
                    else:
                        wide_film += 1
    # The widths past the earlier kernels' limits are in the sweep: the
    # split K1 in all but the canonical bf16 models (from 4840 channels at
    # 64x64), K3's pixels of over 1024 accesses only in the three-level
    # fp32 models (stage 1's 2 n_feat channels from n_feat 2052).
    assert pairs
    assert (splits > 0) == ((family, dtype) != ("canonical", BF16))
    assert (wide_film > 0) == (family == "three-level" and dtype == F32)


@pytest.mark.parametrize("c", [8, 120, 128, 4840, 6000, 3056, 4104])
def test_split_ranges_cover_every_channel_once_and_depend_on_c_alone(c):
    """:func:`split_ranges`: contiguous ranges of ``SPLIT_SPAN`` channels
    (the last shorter) that cover ``c`` once; :func:`split_plan` takes as
    many ranges at every shape of ``c`` channels, on a shard as on the
    whole map, in either type."""
    ranges = sampler_step_ops.split_ranges(c)
    assert ranges[0][0] == 0 and sum(cs for _, cs in ranges) == c
    assert all(a + ca == b for (a, ca), (b, _) in zip(ranges, ranges[1:]))
    assert all(0 < cs <= sampler_step_ops.SPLIT_SPAN for _, cs in ranges)
    assert all(cs == sampler_step_ops.SPLIT_SPAN for _, cs in ranges[:-1])
    for eb in (4, 2):
        if c % (16 // eb):
            continue
        plans = [sampler_step_ops.split_plan(u, h, 64, c, element_bytes=eb)
                 for u, h in ((16, 64), (16, 32), (1, 64), (1, 8))]
        assert {(p.span, p.splits) for p in plans} == {(sampler_step_ops.SPLIT_SPAN,
                                                        len(ranges))}


@pytest.mark.parametrize("shape,eb,rows,ctas", [
    ((1, 8, 8, 6000), 2, 4, 94), ((1, 4, 8, 6000), 2, 4, 47), ((1, 4, 8, 6000), 4, 2, 94),
    ((16, 64, 64, 4840), 2, 4, 9728), ((16, 64, 64, 3056), 4, 2, 12288),
    ((16, 32, 64, 4240), 4, 2, 8704), ((10, 128, 128, 4096), 2, 4, 10240),
    ((1, 8, 512, 6000), 2, 1, 376)])
def test_split_plan_fits_two_ctas_an_sm(shape, eb, rows, ctas):
    """The split plan at the shapes the band kernels refuse: a range's
    weights, the rings and the band's partials fit two CTAs an SM, at
    bands of ``SPLIT_ROWS`` rows (bf16 4, fp32 2) where they fit, else
    the tallest shorter band that does, else one row (at a width of 512:
    one CTA an SM); items of 64 channels where 64 divides ``c``, else 32."""
    ops = sampler_step_ops
    plan = ops.split_plan(*shape, element_bytes=eb)
    assert (plan.rows, plan.ctas) == (rows, ctas)
    assert (2 if shape[2] <= 128 else 1) * (plan.smem_bytes + 1024) <= ops.SM_SMEM
    assert plan.rows <= ops.SPLIT_ROWS[eb] and plan.threads == 256
    c = shape[-1]
    assert plan.block == (ops.HALO_CK if eb == 4 else 64 if c % 64 == 0 else 32)


def _split_sources(plan, units, height, width, c, cfg, halo):
    """The split launch's copy map (``csrc/head_step.cu::split_band``) under
    ``plan``, in numpy: per CTA (unit x band, range) each band pixel's
    (whole tiles) source of channel c0 of its range, ``where`` (0 zero,
    1 ``h``, 2 the row above, 3 the row below) and its element offset,
    computed as the kernel computes them (a 64-bit base per branch at
    channel c0 plus q * c); the range and the output pixels."""
    pb = (plan.rows + 2) * width
    m = (2 if cfg else 1) * pb
    tile = 32
    p = np.arange(-(-m // tile) * tile)
    s = (p >= pb).astype(np.int64)
    q = p - s * pb
    bands = -(-height // plan.rows)
    for k, (c0, cs) in enumerate(sampler_step_ops.split_ranges(c)):
        for cta in range(units * bands):
            unit, y0 = cta // bands, (cta % bands) * plan.rows
            q_lo = width if y0 == 0 else 0
            q_bottom = (height - y0 + 1) * width
            q_hi, qb_hi = min(pb, q_bottom), min(pb, q_bottom + width)
            sample = unit + s * units if cfg else np.full_like(p, unit)
            row = width * c
            bases = {1: (sample * height + y0 - 1) * row + c0, 2: sample * row + c0,
                     3: sample * row - q_bottom * c + c0}
            where = np.where((p < m) & (q >= q_lo) & (q < q_hi), 1, 0)
            if halo:
                where[(p < m) & (q < q_lo)] = 2
                where[(p < m) & (q >= q_hi) & (q < qb_hi)] = 3
            off = np.zeros_like(p)
            for code, base in bases.items():
                off = np.where(where == code, base + q * c, off)
            o = np.arange(min(plan.rows, height - y0) * width)
            yield (k, c0, cs), (where, off, sample, y0 - 1 + q // width, q % width, p < m), (
                unit, y0 + o // width, o % width)


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 5, 264, True), (2, 8, 8, 304, True),
                                   (2, 6, 4, 136, False)])
def test_split_copies_stage_each_range_of_the_padded_map(shape, halo):
    """Every range's staged band elements (``cs`` channels from the range's
    base, the channels of a range's last 32-channel block past ``cs``
    zero-filled) are the padded map's channels ``c0 .. c0 + cs`` (rows -1
    and H from the halo rows, or zero), and each (range, output pixel) is
    written once, at several band heights, with ranges that end inside a
    32-channel block (264 = 2 x 128 + 8) and in a 64-channel one (304)."""
    units, height, width, c, cfg = shape
    rs = np.random.RandomState(c + height)
    nd = 2 * units if cfg else units
    h = rs.randn(nd, height, width, c).astype(np.float32) + 5
    buf = rs.randn(2, nd, width, c).astype(np.float32) - 5
    top, bottom = (buf[0], buf[1]) if halo else (None, None)
    rows = tuple(None if r is None else torch.tensor(r) for r in (top, bottom))
    padded = sampler_step_ops.halo_buffer(torch.tensor(h), rows)
    padded = torch.cat([padded[0][:, None], torch.tensor(h), padded[1][:, None]], dim=1).numpy()
    srcs = {1: h.reshape(-1), 2: None if top is None else top.reshape(-1),
            3: None if bottom is None else bottom.reshape(-1)}
    for band_rows in (1, 2, 4, 3):
        plan = sampler_step_ops.split_plan(units, height, width, c, cfg=cfg)._replace(
            rows=band_rows)
        splits = len(sampler_step_ops.split_ranges(c))
        written = np.zeros((splits, units, height, width), np.int64)
        for (k, c0, cs), (where, off, sample, gy, gx, real), (unit, oy, ox) in _split_sources(
                plan, units, height, width, c, cfg, halo):
            np.add.at(written, (k, unit, oy, ox), 1)
            cpad = -(-cs // 32) * 32
            got = np.zeros((len(where), cpad), np.float32)
            for code, src in srcs.items():
                sel = where == code
                if src is None or not sel.any():
                    continue
                chans = np.arange(cpad)
                inside = chans < cs  # a chunk past the range is zero-filled
                idx = off[sel][:, None] + np.where(inside, chans, 0)
                assert (off[sel] >= 0).all() and (idx.max() < src.size)
                got[sel] = np.where(inside, src[idx], 0)
            keep = real & (gy >= -1) & (gy <= height)
            want = np.zeros_like(got)
            want[:, :cs] = np.where(keep[:, None],
                                    padded[sample, np.clip(gy + 1, 0, height + 1), gx,
                                           c0:c0 + cs], 0)
            np.testing.assert_array_equal(got, want)
        assert (written == 1).all()


def _head_inputs(seed, c, b=2, hw=8, cfg=True, halo=False):
    rs = np.random.RandomState(seed)
    h = np.maximum(rs.randn(2 * b if cfg else b, hw, hw, c), 0).astype(np.float32)
    weight = (rs.randn(1, c, 3, 3) / (3 * np.sqrt(c))).astype(np.float32)
    bias = rs.randn(1).astype(np.float32)
    x, z = (rs.randn(b, hw, hw, 1).astype(np.float32) for _ in range(2))
    rows = (tuple(np.maximum(rs.randn(2 * b if cfg else b, hw, c), 0).astype(np.float32)
                  for _ in range(2)) if halo else None)
    return h, weight, bias, x, z, rows


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("c,w,tanh", [(600, 2.0, False), (264, None, True), (1032, "vector", False)])
def test_head_step_split_plain_sums_ranges_in_order(c, w, tanh, halo):
    """:func:`head_step_split_plain`: each range's conv (no bias) summed in
    range order, then the bias, equals that sum built range by range here
    bit for bit, and :func:`head_step_plain` within 1e-5 relative in
    fp32; in bf16 (exact products summed in fp32) within 4 bf16 ulps of
    eps times c_eps / sqrt(a), as the card's gate holds the kernel."""
    ops = sampler_step_ops
    h, weight, bias, x, z, rows = _head_inputs(c, c, cfg=w is not None, halo=halo)
    guide = (torch.tensor([1.5, 3.0]) if w == "vector" else w)
    t = [torch.tensor(a) for a in (h, weight, bias, x, z)]
    halo_t = tuple(torch.tensor(r) for r in rows) if halo else None
    coeffs = (0.02, 1.01, 0.3)
    got = ops.head_step_split_plain(*t, *coeffs, guide, tanh, halo_t)
    want = ops.head_step_plain(*t, *coeffs, guide, tanh, halo_t)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    hp, padding = t[0], 1
    if halo:
        hp = torch.cat([halo_t[0][:, None], hp, halo_t[1][:, None]], dim=1)
        padding = (0, 1)
    total = None
    for c0, cs in ops.split_ranges(c):
        part = F.conv2d(hp.permute(0, 3, 1, 2)[:, c0:c0 + cs], t[1][:, c0:c0 + cs],
                        padding=padding)
        total = part if total is None else total + part
    eps = (total + t[2][None, :, None, None]).permute(0, 2, 3, 1)
    assert torch.equal(got, ops.sampler_step_plain(t[3], eps, t[4], *coeffs, guide, tanh))
    hb, wb, bb = (a.bfloat16() for a in t[:3])
    halo_b = tuple(r.bfloat16() for r in halo_t) if halo else None
    got16 = ops.head_step_split_plain(hb, wb, bb, t[3], t[4], *coeffs, guide, tanh, halo_b)
    want16 = ops.head_step_plain(hb, wb, bb, t[3], t[4], *coeffs, guide, tanh, halo_b)
    eps16 = ops.head_step_plain(hb, wb, bb, torch.zeros_like(t[3]), None, -1.0, 1.0, 0.0,
                                guide, tanh, halo_b)  # the guided eps, as the kernel rounds it
    ulp = 2.0 ** (np.floor(np.log2(eps16.abs().max().item())) - 7)
    diff = (got16 - want16).abs()
    assert diff.max().item() <= 4 * 0.02 * 1.01 * ulp
    assert (diff > 1e-5).float().mean().item() <= 0.01


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act,film", [("relu", True), ("gelu", True), ("leaky_relu", False)])
def test_groupnorm_pair_plain_equals_the_single_launch_at_n_feat_1032_up0_norm(act, film, dtype):
    """The pair on one card in plain PyTorch (:func:`groupnorm_stats_plain`
    of the whole map as the one shard's partials, then
    :func:`groupnorm_apply_plain`) equals :func:`groupnorm_act_plain` at a
    canonical n_feat 1032 model's up0_norm (2064 channels, 258 a group;
    4 maps of 16x16, the FiLM epilogue's rows as the sampler gives them):
    within 2e-6 of the largest value in fp32 (Chan's merge of one part is
    the two-pass statistics), a bf16 ulp in bf16."""
    ops = groupnorm_ops
    rs = np.random.RandomState(7)
    n, hw, c = 4, 16 * 16, 2064
    x = torch.tensor(rs.randn(n, 16, 16, c).astype(np.float32) * 3 + 1).to(dtype)
    gamma, beta = (torch.tensor(rs.randn(c).astype(np.float32)) for _ in range(2))
    rows = ((torch.tensor(rs.randn(n, c).astype(np.float32)).to(dtype),
             torch.tensor(rs.randn(1, c).astype(np.float32)).to(dtype)) if film else None)
    assert ops.single_route(n, hw, c, 8, dtype)[0] == ops.PAIR_NAMES[dtype]
    parts = ops.groupnorm_stats_plain(x, 8)[None]
    got = ops.groupnorm_apply_plain(x, parts, gamma, beta, 8, 1e-5, act, rows).float()
    want = ops.groupnorm_act_plain(x, gamma, beta, 8, 1e-5, act, rows).float()
    scale = want.abs().max().item()
    tol = 2e-6 * scale if dtype == F32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (got - want).abs().max().item() <= tol


def _seeded_variables(model, x, t, seed=0):
    """Variables of the JAX ``model`` shaped by its init (traced, not run),
    drawn from a numpy generator: kernels uniform in +-1/sqrt(fan_in) (the
    torch init's scale), biases and norm parameters small, BatchNorm
    statistics non-trivial."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t)
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "kernel" in name:
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            return rs.uniform(-bound, bound, shape).astype(np.float32)
        if "var" in name:
            return (rs.rand(*shape) + 0.5).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_n_feat_1032_forward_matches_jax():
    """A canonical n_feat 1032 model (its up0_norm: 2064 channels, 258 a
    group, the width at which the single GroupNorm launch first refuses
    the canonical up0_norm), 8x8 maps, batch 1, on the same seeded numpy
    weights: the port's fp32 forward (the plain versions on the CPU)
    within 1e-5 of the JAX package's, relative to max |eps|, as the tiny
    model's slice test; its K2 and K1 routes take the pair and a band
    kernel on the card."""
    model = JaxContextUnet(n_feat=1032, n_cfeat=6, height=8, levels=2)
    rs = np.random.RandomState(11)
    x = rs.randn(1, 8, 8, 1).astype(np.float32)
    t = rs.rand(1).astype(np.float32)
    c = rs.rand(1, 6).astype(np.float32)
    variables = _seeded_variables(model, x, t)
    want = np.asarray(jax.jit(model.apply)(variables, x, t, c))
    port = load_model(variables, "cpu")
    del variables
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t), torch.tensor(c)).numpy()
    assert got.shape == want.shape == (1, 8, 8, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert groupnorm_ops.single_route(1, 2 * 2, 2064, 8, F32)[0] == groupnorm_ops.PAIR_NAMES[F32]
    assert sampler_step_ops.route(1, 8, 8, 1032, F32, cfg=False)[0] == sampler_step_ops.C_NAME
