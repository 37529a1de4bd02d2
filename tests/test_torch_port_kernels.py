"""PyTorch port: each kernel's plain version (what its wrapper runs on CPU
tensors) against the JAX Pallas kernel in interpret mode and the JAX XLA
path, on the same numpy inputs; the launch plans' index maps."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from camels_diffusion_model_tpu.diffusion.sampler import _combine_cfg
from camels_diffusion_model_tpu.diffusion.schedule import (
    make_schedule as jax_make_schedule,
    p_sample_step as jax_p_sample_step,
)
from camels_diffusion_model_tpu.models.blocks import GroupNormAct as JaxGroupNormAct
from camels_diffusion_model_tpu.ops.pallas import (
    fused_film as jax_fused_film,
    fused_groupnorm_act as jax_fused_groupnorm_act,
    fused_p_sample_step as jax_fused_p_sample_step,
)
from camels_diffusion_model_tpu.ops.pallas.film import film_xla
from camels_diffusion_model_tpu_torch.diffusion.ddim import beta_coefficients
from camels_diffusion_model_tpu_torch.diffusion.schedule import (
    ddpm_coefficients,
    make_schedule,
)
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.ops import _build
from camels_diffusion_model_tpu_torch.ops import film as film_ops
from camels_diffusion_model_tpu_torch.ops import groupnorm as groupnorm_ops
from camels_diffusion_model_tpu_torch.ops import sampler_step as sampler_step_ops
from camels_diffusion_model_tpu_torch.ops.film import film_plain, fused_film
from camels_diffusion_model_tpu_torch.ops.groupnorm import (
    fused_groupnorm_act,
    groupnorm_act_plain,
)
from camels_diffusion_model_tpu_torch.ops.sampler_step import (
    fused_head_step,
    head_step_plain,
    sampler_step_plain,
)

T = 50
B = 2
SHAPE = (B, 16, 16, 1)


def _inputs(seed, cfg):
    rs = np.random.RandomState(seed)
    x = rs.randn(*SHAPE).astype(np.float32)
    eps = rs.randn(2 * B if cfg else B, *SHAPE[1:]).astype(np.float32)
    z = rs.randn(*SHAPE).astype(np.float32)
    return x, eps, z


# ---- K1: sampler step -------------------------------------------------------

@pytest.mark.parametrize("t", [1, 17, T])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
def test_sampler_step_ddpm_matches_jax_xla(t, w):
    """Guided combine + ancestral update vs ``_combine_cfg`` +
    ``schedule.p_sample_step`` (z = 0 at t = 1, as the JAX sampler passes);
    fp32, rtol 1e-6 / atol 1e-6 (one rounding of the folded coefficient)."""
    x, eps, z = _inputs(t, w is not None)
    w_val = np.array([1.5, 3.0], np.float32) if w == "per-sample" else w
    if w is not None:
        eps_j = _combine_cfg(eps[:B], eps[B:], w_val)
    else:
        eps_j = jnp.asarray(eps)
    z_j = z if t > 1 else np.zeros_like(z)
    want = np.asarray(jax_p_sample_step(jax_make_schedule(T), jnp.asarray(x), t, eps_j, z_j))
    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(make_schedule(T), torch.tensor([t]))[0].tolist()
    w_t = torch.tensor(w_val) if w == "per-sample" else w_val
    got = sampler_step_plain(
        torch.tensor(x), torch.tensor(eps), torch.tensor(z) if t > 1 else None,
        c_eps, inv_sqrt_a, sigma, w_t,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [2, 17, T])
def test_sampler_step_matches_jax_pallas_interpret(t):
    """The unguided form vs the Pallas kernel itself (interpret mode)."""
    x, eps, z = _inputs(100 + t, False)
    s = jax_make_schedule(T)
    want = np.asarray(jax_fused_p_sample_step(
        s.beta, s.alpha, s.alpha_bar, x, t, eps, z, interpret=True))
    c = ddpm_coefficients(make_schedule(T), torch.tensor([t]))[0].tolist()
    got = sampler_step_plain(torch.tensor(x), torch.tensor(eps), torch.tensor(z), *c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("w", [None, 2.0])
def test_sampler_step_beta_coefficients_match_jax_ddim(stride, w):
    """The strided "beta" update of ``ddim.py:100-106`` in jnp, every jump
    of a stride-``stride`` schedule, sigma = 0 on the last."""
    taus = np.arange(1, T + 1, stride)
    coefs = beta_coefficients(make_schedule(T), taus).tolist()
    ab = jax_make_schedule(T).alpha_bar
    rev = taus[::-1]
    prev = np.concatenate([rev[1:], [0]])
    for k, (t, t_prev) in enumerate(zip(rev, prev)):
        x, eps, z = _inputs(k, w is not None)
        e = _combine_cfg(eps[:B], eps[B:], w) if w is not None else jnp.asarray(eps)
        a_jump = ab[t] / ab[t_prev]
        mean = (x - e * (1.0 - a_jump) * jax.lax.rsqrt(1.0 - ab[t])) * jax.lax.rsqrt(a_jump)
        sigma = jnp.where(t_prev > 0, jnp.sqrt(jnp.clip(1.0 - a_jump, 0.0, None)), 0.0)
        want = np.asarray(mean + sigma * z)
        c_eps, inv_sqrt_a, sig = coefs[k]
        got = sampler_step_plain(
            torch.tensor(x), torch.tensor(eps), torch.tensor(z) if t_prev > 0 else None,
            c_eps, inv_sqrt_a, sig, w,
        )
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_sampler_step_requires_z_when_sigma_nonzero():
    x, eps, _ = _inputs(0, False)
    with pytest.raises(ValueError, match="sigma"):
        sampler_step_plain(torch.tensor(x), torch.tensor(eps), None, 0.1, 1.0, 0.5)
    h = torch.zeros(B, 16, 16, 8)
    with pytest.raises(ValueError, match="sigma"):
        fused_head_step(h, torch.zeros(1, 8, 3, 3), torch.zeros(1), torch.tensor(x),
                        None, 0.1, 1.0, 0.5)


# ---- K1: output conv + guidance + step ---------------------------------------

def _head_inputs(seed, cfg, b=B, hw=16, c=16):
    rs = np.random.RandomState(seed)
    h = np.maximum(rs.randn(2 * b if cfg else b, hw, hw, c), 0).astype(np.float32)
    kernel = (rs.randn(3, 3, c, 1) * 0.1).astype(np.float32)  # flax HWIO
    bias = rs.randn(1).astype(np.float32)
    x, z = (rs.randn(b, hw, hw, 1).astype(np.float32) for _ in range(2))
    return h, kernel, bias, x, z


def _torch_head(kernel, bias):
    """flax HWIO (3, 3, C, 1) -> torch OIHW (1, C, 3, 3)."""
    return torch.tensor(kernel.transpose(3, 2, 0, 1).copy()), torch.tensor(bias)


@pytest.mark.parametrize("t", [1, 17, T])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
def test_head_step_plain_matches_jax_conv_and_pallas_step(t, w):
    """out_conv2 through ``lax.conv_general_dilated`` (SAME, as the flax
    ``nn.Conv`` of ``context_unet.py:314``), the CFG combine of
    ``sampler.py::_combine_cfg``, then the Pallas ``fused_p_sample_step``
    in interpret mode (z = 0 at t = 1).  Conv sums of 144 terms in another
    order, then one step: atol 2e-6."""
    cfg = w is not None
    h, kernel, bias, x, z = _head_inputs(t, cfg)
    w_val = np.array([1.5, 3.0], np.float32) if w == "per-sample" else w
    eps = jax.lax.conv_general_dilated(
        jnp.asarray(h), jnp.asarray(kernel), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    if cfg:
        eps = _combine_cfg(eps[:B], eps[B:], w_val)
    z_j = z if t > 1 else np.zeros_like(z)
    s = jax_make_schedule(T)
    want = np.asarray(jax_fused_p_sample_step(
        s.beta, s.alpha, s.alpha_bar, x, t, eps, z_j, interpret=True))
    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(make_schedule(T), torch.tensor([t]))[0].tolist()
    w_t = torch.tensor(w_val) if w == "per-sample" else w_val
    got = head_step_plain(torch.tensor(h), *_torch_head(kernel, bias), torch.tensor(x),
                          torch.tensor(z) if t > 1 else None, c_eps, inv_sqrt_a, sigma, w_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def _head_kernel_index_map(plan, units, height, width, cfg):
    """The index maps of ``csrc/head_step.cu`` under ``plan``: per CTA
    (unit major, band minor) the tile rows' (sample, input row, column) and
    the output pixels' (unit, row, column), each as arrays."""
    t = plan.threads
    npix = (plan.rows + 2) * width
    bands = -(-height // plan.rows)
    k = np.arange(2 * t)
    half = (k >= t).astype(np.int64)
    for cta in range(units * bands):
        unit, y0 = cta // bands, (cta % bands) * plan.rows
        sample = unit + half * units if cfg else np.full_like(k, unit)
        pix = k - half * t if cfg else k
        assert (pix < npix).all()
        staged = (sample, y0 - 1 + pix // width, pix % width)
        o = np.arange(min(plan.rows, height - y0) * width)
        out = (unit, y0 + o // width, o % width)
        yield staged, out


@pytest.mark.parametrize("units,cfg", [(16, True), (16, False), (4, False)])
def test_head_launch_plan_at_the_path_shapes(units, cfg):
    """Decoder batches 32 (w=2: 16 pairs), 16 (w=0) and 4 (exact chain) at
    64x64x128: every output pixel is written once, every staged pixel of a
    band is one of its rows or their halo, each band stages all of them,
    the band is the tallest whose grid keeps one CTA per SM, the chunk the
    one that keeps the most CTAs resident (two an SM fit at w=0, where the
    grid has two an SM to run), and a CTA's shared memory fits in 227 KB."""
    plan = sampler_step_ops.launch_plan(units, 64, 64, 128, cfg=cfg, sms=132)
    assert (plan.rows, plan.ck) == {(16, True): (4, 32), (16, False): (4, 16),
                                    (4, False): (2, 32)}[units, cfg]
    assert plan.ctas >= sampler_step_ops.MIN_CTAS >= 128
    resident = sampler_step_ops.SM_SMEM // (plan.smem_bytes + 1024)
    assert resident == (1 if cfg else 2)
    assert plan.smem_bytes <= 227 * 1024 and plan.threads <= sampler_step_ops.MAX_THREADS
    written = np.zeros((units, 64, 64), np.int64)
    ctas = 0
    for (sample, gy, gx), (unit, oy, ox) in _head_kernel_index_map(plan, units, 64, 64, cfg):
        ctas += 1
        np.add.at(written, (unit, oy, ox), 1)
        samples = (unit, unit + units) if cfg else (unit,)
        need = {(s, y, x) for s in samples for y in range(oy.min() - 1, oy.max() + 2)
                for x in range(64)}
        assert set(zip(sample.tolist(), gy.tolist(), gx.tolist())) == need
    assert ctas == plan.ctas
    assert (written == 1).all()


def _emulate_head_kernel(plan, h, wt, bias, x, z, c_eps, inv_sqrt_a, sigma, w, cfg):
    """``csrc/head_step.cu`` in numpy: stage each CTA's tile rows (zero
    outside the map), reduce them into 9 per-tap partials, gather each
    output pixel's 3x3 neighbourhood from the partials, combine, step."""
    units, height, width = x.shape[:3]
    out = np.full(x.shape[:3], np.nan, np.float32)
    for (sample, gy, gx), (unit, oy, ox) in _head_kernel_index_map(plan, units, height, width, cfg):
        valid = (gy >= 0) & (gy < height)
        tile = np.where(valid[:, None], h[sample, np.clip(gy, 0, height - 1), gx], 0.0)
        part = tile @ wt.T  # (2T, 9)
        r = oy - oy.min()
        eps = []
        for s in range(2 if cfg else 1):
            acc = np.full(r.shape, bias[0], np.float64)
            for ky in range(3):
                for kx in range(3):
                    col = ox + kx - 1
                    ok = (col >= 0) & (col < width)
                    idx = s * plan.threads + (r + ky) * width + np.clip(col, 0, width - 1)
                    acc += np.where(ok, part[idx, ky * 3 + kx], 0.0)
            eps.append(acc)
        if cfg:
            wu = w[unit] if isinstance(w, np.ndarray) else w
            e = eps[1] + wu * (eps[0] - eps[1])
        else:
            e = eps[0]
        v = (x[unit, oy, ox, 0] - e * c_eps) * inv_sqrt_a
        if z is not None:
            v = v + sigma * z[unit, oy, ox, 0]
        out[unit, oy, ox] = v
    return out[..., None]


@pytest.mark.parametrize("rows", [None, 1, 2, 4, 5])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("hw,c", [(16, 8), (12, 12), (8, 48)])
def test_head_kernel_algorithm_matches_plain(monkeypatch, rows, w, hw, c):
    """The kernel's staging, per-tap partials and gather, emulated on the
    CPU at narrow test widths and every band height (5 leaves a ragged last
    band), against :func:`head_step_plain`: atol 1e-5."""
    cfg = w is not None
    h, kernel, bias, x, z = _head_inputs(len(str(w)) + (rows or 0), cfg, b=3, hw=hw, c=c)
    w_val = np.array([1.5, 3.0, 0.5], np.float32) if w == "per-sample" else w
    weight, bias_t = _torch_head(kernel, bias)
    if rows is not None:
        monkeypatch.setattr(sampler_step_ops, "ROWS", (rows,))
    plan = sampler_step_ops.launch_plan(3, hw, hw, c, cfg=cfg)
    assert rows in (None, plan.rows)
    assert c % plan.ck == 0
    wt = weight[0].permute(1, 2, 0).reshape(9, c).numpy().astype(np.float64)
    got = _emulate_head_kernel(plan, h.astype(np.float64), wt, bias, x, z,
                               0.02, 1.01, 0.3, w_val, cfg)
    want = head_step_plain(torch.tensor(h), weight, bias_t, torch.tensor(x), torch.tensor(z),
                           0.02, 1.01, 0.3,
                           torch.tensor(w_val) if w == "per-sample" else w_val)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kwargs,match", [
    ({"cout": 0}, "one output channel"),
    ({"c": 126}, "channels % 4"),
    ({"aligned": False}, "aligned"),
    ({"width": 63, "cfg": False}, "even width"),
    ({"width": 512}, "takes no path"),
])
def test_head_launch_plan_raises_on_shapes_no_path_takes(kwargs, match):
    args = {"units": 4, "height": 64, "width": 64, "c": 128, **kwargs}
    with pytest.raises(ValueError, match=match):
        sampler_step_ops.launch_plan(**args)


def test_head_staged_pixels_hit_eight_bank_groups():
    """A 16-byte shared-memory access serves 8 threads at a time; thread t
    reads staged pixel t, so the stride in 16-byte slots must be odd."""
    for ck in sampler_step_ops.CHUNKS:
        slots = sampler_step_ops.staged_stride(ck) // 4
        assert len({(t * slots) % 8 for t in range(8)}) == 8


# ---- K2: GroupNorm + act ----------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "gelu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (3, 8, 8, 64)])
def test_groupnorm_act_matches_jax(act, shape):
    """vs the two-pass XLA path of ``GroupNormAct`` (atol 2e-6) and the
    Pallas kernel in interpret mode, whose E[x^2]-E[x]^2 variance differs
    by fp32 cancellation (atol 5e-5)."""
    rs = np.random.RandomState(len(act))
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    gamma = (rs.rand(shape[-1]) + 0.5).astype(np.float32)
    beta = rs.randn(shape[-1]).astype(np.float32)
    got = fused_groupnorm_act(torch.tensor(x), torch.tensor(gamma), torch.tensor(beta),
                              num_groups=8, eps=1e-5, act=act).numpy()
    if act != "none":
        xla = JaxGroupNormAct(num_groups=8, epsilon=1e-5, act=act).apply(
            {"params": {"scale": gamma, "bias": beta}}, x)
    else:  # GroupNormAct has no identity act; flax GroupNorm is the XLA path
        xla = nn.GroupNorm(num_groups=8, epsilon=1e-5).apply(
            {"params": {"scale": gamma, "bias": beta}}, x)
    np.testing.assert_allclose(got, np.asarray(xla), atol=2e-6, rtol=1e-5)
    pallas = jax_fused_groupnorm_act(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                     num_groups=8, act=act, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("scale_rows,shift_rows", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_groupnorm_act_film_epilogue_matches_jax(scale_rows, shift_rows):
    """``film=(scale, shift)`` vs the JAX decoder's stage 0: the XLA
    ``GroupNormAct`` (``up0_norm``) then ``cemb1 * u + temb1``
    (``context_unet.py:300,305``); fp32, atol 1e-5."""
    rs = np.random.RandomState(10 * scale_rows + shift_rows)
    x = (rs.randn(3, 4, 4, 64) * 2 + 0.5).astype(np.float32)
    gamma = (rs.rand(64) + 0.5).astype(np.float32)
    beta = rs.randn(64).astype(np.float32)
    scale = rs.randn(scale_rows, 64).astype(np.float32)
    shift = rs.randn(shift_rows, 64).astype(np.float32)
    got = fused_groupnorm_act(
        torch.tensor(x), torch.tensor(gamma), torch.tensor(beta), 8, 1e-5, "relu",
        film=(torch.tensor(scale), torch.tensor(shift)),
    ).numpy()
    u = JaxGroupNormAct(num_groups=8, epsilon=1e-5, act="relu").apply(
        {"params": {"scale": gamma, "bias": beta}}, x)
    want = scale.reshape(-1, 1, 1, 64) * u + shift.reshape(-1, 1, 1, 64)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def _groupnorm_plan_coverage(plan, hw, cg):
    """How often the kernel's index map (csrc/groupnorm.cu) touches each
    (pixel, channel) of one group under ``plan``."""
    counts = np.zeros((hw, cg), np.int64)
    vpp = cg // plan.vec
    pstride = plan.threads // vpp
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.pixels_per_cta)
        p1 = min(hw, p0 + plan.pixels_per_cta)
        for t in range(pstride * vpp):  # threads past that only join the sums
            j = (t % vpp) * plan.vec
            counts[p0 + t // vpp:p1:pstride, j:j + plan.vec] += 1
        assert (p1 - p0) * cg * 4 <= plan.smem_bytes
    return counts


@pytest.mark.parametrize("n", [32, 16, 4])
@pytest.mark.parametrize("head", ["up0_norm", "out_norm"])
def test_groupnorm_launch_plan_at_the_path_shapes(n, head):
    """Decoder batches 32 (w=2), 16 (w=0) and 4 (exact chain): every element
    of a group is touched once, the 16-byte path is taken, the slice fits,
    and the grid reaches 256 CTAs."""
    hw, c = {"up0_norm": (16 * 16, 256), "out_norm": (64 * 64, 128)}[head]
    plan = groupnorm_ops.launch_plan(n, hw, c, 8)
    assert plan.vec == 4 and plan.cluster in (1, 2, 4, 8)
    assert n * 8 * plan.cluster >= groupnorm_ops.MIN_CTAS  # the grid, in CTAs
    assert plan.smem_bytes <= groupnorm_ops.SLICE_MAX
    assert (_groupnorm_plan_coverage(plan, hw, c // 8) == 1).all()


@pytest.mark.parametrize("shape,aligned", [((2, 5, 7, 24), True), ((3, 8, 8, 64), False),
                                           ((1, 3, 3, 16), True)])
def test_groupnorm_launch_plan_scalar_and_small_shapes(shape, aligned):
    n, h, w, c = shape
    plan = groupnorm_ops.launch_plan(n, h * w, c, 8, aligned)
    assert plan.vec == (4 if aligned and c // 8 % 4 == 0 else 1)
    assert plan.cluster <= groupnorm_ops.MAX_CLUSTER
    assert (_groupnorm_plan_coverage(plan, h * w, c // 8) == 1).all()


@pytest.mark.parametrize("hw,c", [(256 * 256, 128), (16, 8 * 2048)])
def test_groupnorm_launch_plan_raises_on_shapes_no_path_takes(hw, c):
    """A group whose slice overflows shared memory even in a cluster of 8,
    or whose channels outnumber a CTA's threads."""
    with pytest.raises(ValueError):
        groupnorm_ops.launch_plan(4, hw, c, 8)


@pytest.mark.parametrize("n,hw,c,aligned", [(32, 256, 256, True), (32, 1024, 128, True),
                                            (16, 1024, 128, True), (4, 1024, 128, True),
                                            (3, 35, 6, True), (2, 64, 128, False),
                                            (4, 1024, 8192, True), (2, 64, 4104, True),
                                            (2, 16, 1030, False), (32, 64, 2064, True)])
def test_film_launch_plan_covers_every_element_once(n, hw, c, aligned):
    """The kernel's index map (csrc/film.cu) under the plan: each (pixel,
    channel) of a sample once; at most one wave of 132 SMs.  A pixel of
    over 1024 accesses (fp32 8192 and 4104 channels, 1030 unaligned:
    K3 at the widths JAX computes): a block of whole warps, a thread
    accesses t, t + threads, ... of each pixel, the block a pixel a step."""
    plan = film_ops.launch_plan(n, hw, c, aligned, sms=132)
    assert plan.vec == (4 if aligned and c % 4 == 0 else 1)
    per_pixel = c // plan.vec
    assert plan.threads <= film_ops.MAX_THREADS
    counts = np.zeros((hw, c), np.int64)
    if per_pixel > film_ops.MAX_THREADS:  # several accesses of a pixel a thread
        assert plan.threads % 32 == 0 and plan.threads <= film_ops.THREADS
        assert -(-per_pixel // plan.threads) == -(-per_pixel // film_ops.THREADS)
        for bx in range(plan.blocks_per_sample):
            for t in range(plan.threads):
                for j in range(t * plan.vec, c, plan.threads * plan.vec):
                    counts[bx::plan.blocks_per_sample, j:j + plan.vec] += 1
    else:
        pstride = plan.threads // per_pixel
        assert plan.threads % per_pixel == 0
        for bx in range(plan.blocks_per_sample):
            for t in range(plan.threads):
                j = (t % per_pixel) * plan.vec
                counts[bx * pstride + t // per_pixel::plan.blocks_per_sample * pstride,
                       j:j + plan.vec] += 1
    assert (counts == 1).all()
    assert n * plan.blocks_per_sample <= 132 * film_ops.BLOCKS_PER_SM or plan.blocks_per_sample == 1



@pytest.mark.parametrize("n,hw,c", [(65536, 16, 128), (1, 2**24, 128), (2, 16, 0)])
def test_film_launch_plan_raises_on_shapes_no_path_takes(n, hw, c):
    """More samples than grid.y holds, a sample of 2**31 floats (the
    kernel's offsets are 32-bit), or no channels (a pixel wider than a
    block takes several accesses a thread:
    :func:`test_film_launch_plan_covers_every_element_once`)."""
    with pytest.raises(ValueError):
        film_ops.launch_plan(n, hw, c)

def test_groupnorm_act_rejects_unknown_activation():
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="activation"):
        fused_groupnorm_act(x, torch.ones(8), torch.zeros(8), act="tanh")


# ---- K3: FiLM ---------------------------------------------------------------

@pytest.mark.parametrize("scale_rows", [1, 3])
@pytest.mark.parametrize("shift_rows", [1, 3])
def test_film_matches_jax(scale_rows, shift_rows):
    """vs the Pallas kernel (interpret) and ``film_xla``; exact in fp32 up
    to one rounding (atol 1e-6)."""
    rs = np.random.RandomState(scale_rows * 10 + shift_rows)
    x = rs.randn(3, 8, 8, 128).astype(np.float32)
    scale = rs.randn(scale_rows, 128).astype(np.float32)
    shift = rs.randn(shift_rows, 128).astype(np.float32)
    got = fused_film(torch.tensor(x), torch.tensor(scale), torch.tensor(shift)).numpy()
    s4, h4 = scale[:, None, None, :], shift[:, None, None, :]
    np.testing.assert_allclose(got, np.asarray(film_xla(x, s4, h4)), atol=1e-6, rtol=1e-6)
    if scale_rows == shift_rows:  # the Pallas kernel broadcasts both or neither
        pallas = jax_fused_film(x, s4, h4, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-6, rtol=1e-6)


# ---- K1 bf16: the taps on tensor cores ----------------------------------------

def _head_bf16_index_map(plan, units, height, width, cfg):
    """The index maps of ``csrc/head_step.cu::head_step_bf16_kernel`` under
    ``plan``: per CTA (unit major, band minor) each tile row's band index,
    (sample, input row, column) and whether its copy reads (inside the
    band and the map; else it is zero-filled), and the output pixels'
    (unit, row, column)."""
    pb = (plan.rows + 2) * width
    m = (2 if cfg else 1) * pb
    tile = sampler_step_ops.BF16_TILE
    p = np.arange(-(-m // tile) * tile)
    s = (p >= pb).astype(np.int64)
    q = p - s * pb
    bands = -(-height // plan.rows)
    for cta in range(units * bands):
        unit, y0 = cta // bands, (cta % bands) * plan.rows
        gy = y0 - 1 + q // width
        valid = (p < m) & (gy >= 0) & (gy < height)
        sample = unit + s * units if cfg else np.full_like(p, unit)
        o = np.arange(min(plan.rows, height - y0) * width)
        yield (p, sample, gy, q % width, valid), (unit, y0 + o // width, o % width)


HEAD_BF16_SHAPES = {  # (units, height, width, c, cfg): the shapes the bf16 paths give K1
    "serve w=2": (16, 64, 64, 128, True), "serve w=0": (16, 64, 64, 128, False),
    "exact chain": (4, 64, 64, 128, False), "deep": (10, 128, 128, 128, False),
    "big": (10, 128, 128, 256, False), "deep cfg": (10, 128, 128, 128, True),
    "big cfg": (10, 128, 128, 256, True), "one pair": (1, 64, 64, 128, True),
    # the narrow item: n_feat 32, 96 and 160 (c an odd multiple of 32)
    "n_feat 32 serve w=2": (16, 64, 64, 32, True), "n_feat 32 2 maps": (2, 64, 64, 32, True),
    "n_feat 96 serve w=2": (16, 64, 64, 96, True), "n_feat 160 serve w=2": (16, 64, 64, 160, True),
    "n_feat 32 exact chain": (4, 64, 64, 32, False),
    # the narrow item with a masked last block: c a multiple of 8, not of 32
    "n_feat 40 serve w=2": (16, 64, 64, 40, True), "n_feat 40 2 maps": (2, 64, 64, 40, True),
    "n_feat 264 serve w=2": (16, 64, 64, 264, True), "n_feat 264 2 maps": (2, 64, 64, 264, True),
    "n_feat 8 exact chain": (4, 64, 64, 8, False),
}


@pytest.mark.parametrize("shape", HEAD_BF16_SHAPES, ids=list(HEAD_BF16_SHAPES))
def test_head_bf16_plan_at_the_path_shapes(shape):
    """Every output pixel written once; the tile rows that read are each
    band's rows and halo rows of every sample it needs, each once (the
    rest zero-filled); warp w takes tiles w, w + 8, ..., every tile once,
    an item a lane's 4 copies of 16 bytes; the grid is the CTAs the plan
    claims; shared memory (weights, the warps' rings, partials) fits in
    227 KB; the band is the shortest whose grid is one wave of two CTAs an
    SM; and the strides keep their bank patterns.  At the w=2
    serving shape: bands of 4 rows, 256 CTAs.  Where ``c`` is not a
    multiple of 64 (n_feat 32, 96, 160; 8, 40, 264) the narrow item, 32
    pixels x 32 channels, its weights staged as rows of ``c`` rounded up
    to 32; else 16 pixels x 64: 2 KiB either way, ``BF16_RING``
    slots."""
    units, height, width, c, cfg = HEAD_BF16_SHAPES[shape]
    ops = sampler_step_ops
    plan = ops.bf16_plan(units, height, width, c, cfg=cfg, sms=132)
    m = (2 if cfg else 1) * (plan.rows + 2) * width
    warps = plan.threads // 32
    assert plan.block == (ops.BF16_BLOCK if c % 64 == 0 else ops.BF16_NARROW_BLOCK)
    item_px = ops.BF16_TILE * ops.BF16_BLOCK // plan.block  # an item's pixels: 16 or 32
    ring = 2 * warps * item_px * plan.block  # bytes a ring slot takes, all warps
    staged = ops.staged_channels(c)
    assert staged == (c if c % 64 == 0 else -(-c // 32) * 32)
    assert plan.smem_bytes == (2 * 16 * ops.weight_stride(staged) + ops.BF16_RING * ring
                               + 4 * 9 * ops.partial_stride(m))
    assert plan.smem_bytes <= 227 * 1024
    fit = [r for r in sorted(ops.ROWS_BF16)
           if units * -(-height // r) <= ops.BF16_PER_SM * 132]
    assert plan.rows == (fit[0] if fit else max(ops.ROWS_BF16))  # one wave of 2 an SM
    assert 32 * 4 == item_px * plan.block // 8  # an item: 4 copies a lane
    assert ops.partial_stride(m) % 32 == 4 and ops.partial_stride(m) >= -(-m // 16) * 16
    assert ops.weight_stride(staged) // 8 % 8 == 4
    if shape in ("serve w=2", "n_feat 32 serve w=2", "n_feat 40 serve w=2",
                 "n_feat 264 serve w=2"):
        assert (plan.rows, plan.ctas) == (4, 256)
    tiles = -(-m // item_px)  # of an item's pixels
    owned = sorted(t for w in range(warps) for t in range(w, tiles, warps))
    assert owned == list(range(tiles))
    written = np.zeros((units, height, width), np.int64)
    ctas = 0
    for (p, sample, gy, gx, valid), (unit, oy, ox) in _head_bf16_index_map(
            plan, units, height, width, cfg):
        ctas += 1
        np.add.at(written, (unit, oy, ox), 1)
        samples = (unit, unit + units) if cfg else (unit,)
        need = {(sm, y, x) for sm in samples for y in range(oy.min() - 1, oy.max() + 2)
                if 0 <= y < height for x in range(width)}
        loaded = list(zip(sample[valid].tolist(), gy[valid].tolist(), gx[valid].tolist()))
        assert len(loaded) == len(set(loaded)) and set(loaded) == need
    assert ctas == plan.ctas
    assert (written == 1).all()


def test_head_bf16_staged_chunks_hit_eight_bank_groups():
    """An item's pixel pp keeps its 16-byte chunk q at slot q ^ 4 (pp & 1)
    of its 8: one pixel's 8 copies (a quarter warp's writes) and a quarter
    warp's reads (lanes (g, t): rows g of one parity pair, or g + 8, and 4
    chunks of a 32-channel half) each hit 8 distinct bank groups."""
    def slot(pp, q):
        return (pp * 8 + (q ^ ((pp & 1) << 2))) % 8

    for pp in range(sampler_step_ops.BF16_TILE):
        assert len({slot(pp, q) for q in range(8)}) == 8
    for quarter in range(4):  # lanes 8 quarter .. 8 quarter + 7: g = 2 quarter + {0, 1}
        for half in range(2):
            for rows in (0, 8):
                got = {slot(2 * quarter + k + rows, 4 * half + t) for k in range(2)
                       for t in range(4)}
                assert len(got) == 8


@pytest.mark.parametrize("c", [32, 96, 160, 8, 40, 264])
def test_head_bf16_narrow_item_hits_eight_bank_groups(c):
    """The narrow item (32 pixels x 32 channels, 64 bytes a pixel, no
    swizzle): one quarter warp's copies (lanes 8 q .. 8 q + 7: chunk l & 3
    of pixels l / 4 + 8 i, two pixels' 64 contiguous bytes) and its
    A-fragment reads (lanes (g, t), g = 2 q + {0, 1}: chunk t of rows g,
    g + 8, g + 16 and g + 24) each hit 8 distinct bank groups; so do its
    B-fragment reads of
    the weights (taps g and g + 1, chunk t of a 32-channel block), whose
    rows are ``weight_stride`` of the staged channels apart (``c`` rounded
    up to 32 where the last block is masked: 8, 40, 264): 4 mod 8 slots,
    where at c = 32, 96 and 160 the wide item's ``c + 32`` would be 0 mod
    8."""
    def slot(pp, q):  # the item's pixel pp, chunk q: 16-byte slots from the item's start
        return (pp * 4 + q) % 8

    staged = sampler_step_ops.staged_channels(c)
    stride = sampler_step_ops.weight_stride(staged)
    assert stride // 8 % 8 == 4 and stride >= staged >= c
    assert c % 32 or (c + 32) // 8 % 8 == 0
    for quarter in range(4):
        lanes = range(8 * quarter, 8 * quarter + 8)
        for i in range(4):  # the copies: pixel l / 4 + 8 i, chunk l & 3
            assert len({slot(l // 4 + 8 * i, l & 3) for l in lanes}) == 8
        for rows in (0, 8, 16, 24):  # the reads: rows g (+ 8, 16, 24), chunk t
            assert len({slot(l // 4 + rows, l & 3) for l in lanes}) == 8
        for blk in range(staged // 32):  # the weights: tap g, chunk t of block blk
            assert len({((l // 4) * stride // 8 + 4 * blk + (l & 3)) % 8 for l in lanes}) == 8


@pytest.mark.parametrize("c", [8, 24, 40, 96, 264, 520])
def test_head_narrow_masked_block_stages_each_channel_once(c):
    """The narrow item's copies of one pixel over its channel blocks (lane
    l: chunk q = l & 3 of block icb, the 8 channels from icb * 32 + 8 q)
    read only where the chunk starts inside ``c`` (the kernel's
    ``inside``): every channel of the pixel is read once and none past
    ``c`` (the next pixel's), a chunk lies wholly inside ``c`` or wholly
    past it, and the weights are staged as rows of the padded channels,
    zero past ``c``, so the masked products add nothing."""
    ops = sampler_step_ops
    plan = ops.bf16_plan(2, 16, 16, c)
    assert plan.block == ops.BF16_NARROW_BLOCK
    staged = ops.staged_channels(c)
    assert staged % 32 == 0 and 0 <= staged - c < 32
    read = np.zeros(staged, np.int64)
    for icb in range(staged // 32):
        for q in range(4):
            start = icb * 32 + 8 * q
            if start < c:
                assert start + 8 <= c
                read[start:start + 8] += 1
    assert (read[:c] == 1).all() and (read[c:] == 0).all()
    wt = np.arange(1, 9 * c + 1, dtype=np.float64).reshape(9, c)
    rows = np.zeros((16, staged))
    for tap in range(16):  # the staging loop: chunk q of a row, zero past c and taps 9-15
        for q in range(staged // 8):
            if tap < 9 and 8 * q < c:
                rows[tap, 8 * q:8 * q + 8] = wt[tap, 8 * q:8 * q + 8]
    assert (rows[:9, :c] == wt).all() and not rows[:, c:].any() and not rows[9:].any()


def test_bf16_head_routes_take_the_bf16_kernel_at_every_multiple_of_8():
    """K1 in bf16 at every ``c`` a multiple of 8 from 8 to 512, unsharded
    and in the halo mode, at the served, two-map, exact-chain and shard
    shapes: the bf16 kernel under :func:`bf16_plan`, at its wide item where
    64 divides ``c`` and at the narrow item otherwise; never the float
    kernel's bf16 instance."""
    ops = sampler_step_ops
    bf = torch.bfloat16
    for c in range(8, 513, 8):
        wide = c % 64 == 0
        for units, height, width, cfg in ((16, 64, 64, True), (2, 64, 64, True),
                                          (4, 64, 64, False), (16, 32, 64, True)):
            plan = ops.bf16_plan(units, height, width, c, cfg=cfg)
            assert plan.block == (ops.BF16_BLOCK if wide else ops.BF16_NARROW_BLOCK)
            assert ops.route(units, height, width, c, bf, cfg=cfg) == (
                ops.BF16_NAME if wide else ops.BF16_NARROW_NAME, plan)
            assert ops.route(units, height, width, c, bf, cfg=cfg, halo=True) == (
                ops.HALO_NAMES[bf] if wide else ops.HALO_NARROW_NAME, plan)


def test_bf16_head_generic_instance_takes_only_weights_over_shared_memory():
    """The split launch (either mode), which replaced the float kernel's
    bf16 instance there, takes exactly the domain :func:`route` states:
    ``c`` a multiple of 8 whose weights overflow :func:`bf16_plan`'s
    shared memory (from 5608 channels at width 8, 4840 at 16 maps of
    64x64 under CFG), under :func:`split_plan`; every other multiple of 8
    from 8 to 8192 takes the bf16 kernel, and channels not a multiple of
    8 take neither."""
    ops = sampler_step_ops
    bf = torch.bfloat16
    for units, height, width, cfg in ((1, 8, 8, True), (1, 4, 8, True), (4, 64, 64, False),
                                      (16, 64, 64, True)):
        first = None
        for c in range(8, 8193, 8):
            try:
                plan = ops.bf16_plan(units, height, width, c, cfg=cfg)
            except ValueError as e:
                assert "takes no path" in str(e)  # shared memory, nothing else
                first = first or c
                rows = next((r for r in sorted(ops.ROWS_BF16)
                             if units * -(-height // r) <= ops.BF16_PER_SM * 132),
                            max(ops.ROWS_BF16))  # the plan's band
                m = (2 if cfg else 1) * (rows + 2) * width
                assert (32 * ops.weight_stride(ops.staged_channels(c))
                        + 2 * 8 * ops.BF16_RING * ops.BF16_TILE * ops.BF16_BLOCK
                        + 36 * ops.partial_stride(m)) > ops.SMEM_MAX
                split = ops.split_plan(units, height, width, c, cfg=cfg, element_bytes=2)
                for halo in (False, True):
                    assert ops.route(units, height, width, c, bf, cfg=cfg, halo=halo) == (
                        ops.SPLIT_NAMES[bf], split)
                continue
            assert first is None  # the domain is every c from the first refused one up
            assert ops.route(units, height, width, c, bf, cfg=cfg)[1] == plan
        assert first == {(1, 8, 8): 5608, (16, 64, 64): 4840}.get((units, height, width), first)
        for c in (4, 36, 5604):
            with pytest.raises(ValueError, match="channels"):
                ops.route(units, height, width, c, bf, cfg=cfg)


@pytest.mark.parametrize("c", [32, 96, 160, 40, 264])
@pytest.mark.parametrize("maps", [2, 16])
def test_head_narrow_halo_shards_cover_the_map_once(c, maps):
    """Two height shards of a narrow bf16 model's w=2 features (n_feat 32,
    96, 160; 40 and 264 with a masked last block; the narrow item's plan
    for the shard): their bands' staged
    pixels (from ``h``, the halo rows or zero, ``band_source``'s
    arithmetic) are the padded whole map's rows each band needs, and the
    two shards' bands write every output pixel of the whole map once; the
    plan's shared memory fits two CTAs an SM."""
    ops = sampler_step_ops
    units, height, width = maps, 64, 64
    half = height // 2
    plan = ops.bf16_plan(units, half, width, c, cfg=True)
    assert plan.block == ops.BF16_NARROW_BLOCK
    assert 2 * (plan.smem_bytes + 1024) <= ops.SM_SMEM
    cw = 8  # the map's arithmetic at a narrow width
    rs = np.random.RandomState(c + maps)
    h = rs.randn(2 * units, height, width, cw).astype(np.float32) + 5
    padded = np.concatenate([np.zeros_like(h[:, :1]), h, np.zeros_like(h[:, :1])], axis=1)
    written = np.zeros((units, height, width), np.int64)
    for shard, (top, rows, bottom) in enumerate(((None, slice(0, half), h[:, half]),
                                                 (h[:, half - 1], slice(half, height), None))):
        hs = np.ascontiguousarray(h[:, rows])
        for (where, off, sample, gy, gx, real), (unit, oy, ox) in _band_sources(
                plan, units, half, width, cw, True, True, 2 * ops.BF16_TILE):
            np.add.at(written, (unit, oy + shard * half, ox), 1)
            got = _staged(where, off, hs, top, bottom)
            keep = real & (gy >= -1) & (gy <= half)
            gy_whole = np.clip(gy + shard * half + 1, 0, height + 1)
            want = np.where(keep[:, None], padded[sample, gy_whole, gx], 0)
            np.testing.assert_array_equal(got, want)
    assert (written == 1).all()


@pytest.mark.parametrize("kwargs,match", [
    ({"cout": 0}, "one output channel"),
    ({"c": 36}, "channels % 8"),
    ({"aligned": False}, "aligned"),
    ({"width": 4096}, "takes no path"),
])
def test_head_bf16_plan_raises_on_shapes_no_path_takes(kwargs, match):
    args = {"units": 4, "height": 64, "width": 64, "c": 128, **kwargs}
    with pytest.raises(ValueError, match=match):
        sampler_step_ops.bf16_plan(**args)


def _emulate_head_bf16_kernel(plan, h, wt, bias, x, z, c_eps, inv_sqrt_a, sigma, w, cfg,
                              tanh, round_eps):
    """``head_step_bf16_kernel`` in numpy (float64): each 16-pixel tile's
    partials as the warp's m16n8k16 products, built fragment by fragment
    (lane (g, t) loads channels 8t..8t+7 of a 32-channel block for tile
    rows g and g+8; k-step 0 takes 8t, 8t+1 as columns 2t, 2t+1 and 8t+2,
    8t+3 as 2t+8, 2t+9, k-step 1 the next four; the weights' B fragments
    alike, taps 9-15 zero), then the 3x3 gather from the partials with
    the bias, ``round_eps`` (eps's rounding, per branch and in the
    combine), the combine and the step.  Where ``c`` is not a multiple of
    32 the last block is masked: its channels past ``c`` staged as zeros,
    in the features and the weights alike."""
    units, height, width = x.shape[:3]
    c = h.shape[-1]
    cpad = -(-c // 32) * 32
    wpad = np.zeros((16, cpad))
    wpad[:9, :c] = wt
    out = np.full(x.shape[:3], np.nan)
    pb = (plan.rows + 2) * width
    for (p, sample, gy, gx, valid), (unit, oy, ox) in _head_bf16_index_map(
            plan, units, height, width, cfg):
        rows = np.zeros((len(p), cpad))
        rows[:, :c] = np.where(valid[:, None], h[sample, np.clip(gy, 0, height - 1), gx], 0.0)
        part = np.zeros((len(p), 16))
        for tile in range(len(p) // 16):
            a_rows = rows[tile * 16:(tile + 1) * 16]
            for blk in range(cpad // 32):
                for step in range(2):
                    a = np.zeros((16, 16))
                    b = np.zeros((16, 16))
                    for t in range(4):
                        for i in range(2):
                            for col, off in ((2 * t + i, 4 * step + i),
                                             (2 * t + 8 + i, 4 * step + 2 + i)):
                                ch = blk * 32 + 8 * t + off
                                a[:, col] = a_rows[:, ch]
                                b[col, :] = wpad[:, ch]
                    part[tile * 16:(tile + 1) * 16] += a @ b
        r = oy - oy.min()
        eps = []
        for s in range(2 if cfg else 1):
            acc = np.full(r.shape, float(bias[0]))
            for ky in range(3):
                for kx in range(3):
                    col = ox + kx - 1
                    ok = (col >= 0) & (col < width)
                    idx = s * pb + (r + ky) * width + np.clip(col, 0, width - 1)
                    acc += np.where(ok, part[idx, ky * 3 + kx], 0.0)
            e = round_eps(acc)
            eps.append(round_eps(np.tanh(e)) if tanh else e)
        if cfg:
            wu = round_eps(np.float64(w[unit] if isinstance(w, np.ndarray) else w))
            e = round_eps(eps[1] + round_eps(wu * round_eps(eps[0] - eps[1])))
        else:
            e = eps[0]
        v = (x[unit, oy, ox, 0] - e * c_eps) * inv_sqrt_a
        if z is not None:
            v = v + sigma * z[unit, oy, ox, 0]
        out[unit, oy, ox] = v
    return out[..., None]


def _round_bf16(v):
    return torch.tensor(np.asarray(v, np.float32)).bfloat16().double().numpy()


@pytest.mark.parametrize("rows", [None, 1, 2, 8])
@pytest.mark.parametrize("w,tanh", [(None, False), (2.0, False), ("per-sample", True)])
@pytest.mark.parametrize("hw,c", [(12, 64), (8, 128), (12, 32), (8, 96), (12, 40), (8, 24)])
def test_head_bf16_decomposition_matches_plain(monkeypatch, rows, w, tanh, hw, c):
    """The bf16 kernel's decomposition, emulated on the CPU (a matmul of
    each band's staged pixels to 9 tap partials through the MMA fragments'
    channel permutation, then the 3x3 gather with zero rows at the map's
    edge; 40 and 24 channels with the last block masked), on
    bf16 features and weights, against :func:`head_step_plain`: summed in
    float64 against the plain version's fp32 conv, eps may round to the
    neighbouring bf16 value, so 4 bf16 ulps of eps times c_eps / sqrt(a)
    (the card's gate), and exact arithmetic (no rounding of eps) within
    1e-5 of the plain version in float32."""
    cfg = w is not None
    h, kernel, bias, x, z = _head_inputs(hw + c + (rows or 0), cfg, b=3, hw=hw, c=c)
    w_val = np.array([1.5, 3.0, 0.5], np.float32) if w == "per-sample" else w
    w_t = torch.tensor(w_val) if w == "per-sample" else w_val
    if rows is not None:
        monkeypatch.setattr(sampler_step_ops, "ROWS_BF16", (rows,))
    plan = sampler_step_ops.bf16_plan(3, hw, hw, c, cfg=cfg)
    assert rows in (None, plan.rows)
    weight, bias_t = _torch_head(kernel, bias)
    hb, wb, bb = (torch.tensor(h).bfloat16(), weight.bfloat16(), bias_t.bfloat16())
    wt = wb[0].permute(1, 2, 0).reshape(9, c).double().numpy()
    args = (0.02, 1.01, 0.3, w_val, cfg, tanh)
    exact = _emulate_head_bf16_kernel(plan, h.astype(np.float64),
                                      weight[0].permute(1, 2, 0).reshape(9, c).numpy(),
                                      bias, x, z, *args, lambda v: v)
    want32 = head_step_plain(torch.tensor(h), weight, bias_t, torch.tensor(x),
                             torch.tensor(z), 0.02, 1.01, 0.3, w_t, tanh=tanh)
    np.testing.assert_allclose(exact, want32.numpy(), atol=1e-5, rtol=0)
    got = _emulate_head_bf16_kernel(plan, hb.double().numpy(), wt, bb.double().numpy(), x, z,
                                    *args, _round_bf16)
    want = head_step_plain(hb, wb, bb, torch.tensor(x), torch.tensor(z), 0.02, 1.01, 0.3,
                           w_t, tanh=tanh).numpy()
    eps = F.conv2d(hb.permute(0, 3, 1, 2).float(), wb.float(), bb.float(), padding=1)
    ulp = 2.0 ** (np.floor(np.log2(eps.abs().max().item())) - 7)
    diff = np.abs(got - want)
    assert diff.max() <= 4 * 0.02 * 1.01 * ulp
    assert (diff > 1e-5).mean() <= 0.01


# ---- K1's halo mode: the bf16 kernel's and the fp32 halo kernel --------------

def _band_sources(plan, units, height, width, c, cfg, halo, tile):
    """The copy map of ``csrc/head_step.cu::band_of`` / ``band_source``
    under ``plan``: per CTA (unit major, band minor) each band pixel's
    (whole tiles of ``tile``) source of its channel 0, ``where`` (0 zero,
    1 ``h``, 2 the row above the shard, 3 the row below) and the element
    offset into it, computed as the kernel computes them (a base per branch
    plus q * c), its (sample, input row, column), and the output pixels'
    (unit, row, column)."""
    pb = (plan.rows + 2) * width
    m = (2 if cfg else 1) * pb
    p = np.arange(-(-m // tile) * tile)
    s = (p >= pb).astype(np.int64)
    q = p - s * pb
    bands = -(-height // plan.rows)
    for cta in range(units * bands):
        unit, y0 = cta // bands, (cta % bands) * plan.rows
        q_lo = width if y0 == 0 else 0
        q_bottom = (height - y0 + 1) * width
        q_hi, qb_hi = min(pb, q_bottom), min(pb, q_bottom + width)
        sample = unit + s * units if cfg else np.full_like(p, unit)
        base = ((sample * height + y0 - 1) * width) * c
        top = sample * width * c
        bottom = (sample * width - q_bottom) * c
        inside = (p < m) & (q >= q_lo) & (q < q_hi)
        where = np.where(inside, 1, 0)
        off = np.where(inside, base + q * c, 0)
        if halo:
            for code, rows_of, start in ((2, (p < m) & (q < q_lo), top),
                                         (3, (p < m) & (q >= q_hi) & (q < qb_hi), bottom)):
                where[rows_of] = code
                off[rows_of] = (start + q * c)[rows_of]
        o = np.arange(min(plan.rows, height - y0) * width)
        yield (where, off, sample, y0 - 1 + q // width, q % width, p < m), (
            unit, y0 + o // width, o % width)


def _staged(where, off, h, top, bottom):
    """The band pixels' channels as the copies stage them from ``h`` and
    the halo rows ``top`` and ``bottom`` (None: zero-filled)."""
    c = h.shape[-1]
    got = np.zeros((len(where), c), h.dtype)
    for code, src in ((1, h), (2, top), (3, bottom)):
        if src is None:
            continue
        src = src.reshape(-1)
        sel = where == code
        assert (off[sel] >= 0).all() and (off[sel] + c <= src.size).all()
        got[sel] = src[off[sel][:, None] + np.arange(c)]
    return got


HALO_SHAPES = {  # (units, height, width, c, cfg): half of the path's maps and small ones
    "half of serve w=2": (16, 32, 64, 128, True), "half of serve w=0": (16, 32, 64, 128, False),
    "half of the exact chain": (4, 32, 64, 128, False),
    "half of deep": (10, 64, 128, 128, False), "half of deep cfg": (10, 64, 128, 128, True),
    "serve w=2 whole": (16, 64, 64, 128, True), "small ragged": (3, 7, 5, 64, True),
}


@pytest.mark.parametrize("kernel", ["fp32", "bf16"])
@pytest.mark.parametrize("halo", [True, False])
@pytest.mark.parametrize("shape", ["small ragged", "half of serve w=2", "half of serve w=0"])
def test_head_band_copies_stage_the_padded_map(kernel, halo, shape):
    """The copy map of the band kernels (the bf16 kernel in both modes,
    the fp32 halo kernel), modelled in numpy from the kernel's base-plus-
    offset arithmetic: every staged band element comes from ``h``, from a
    halo row or from zero exactly as in the padded map that
    :func:`head_step_plain` builds from ``halo=(top, bottom)`` (rows -1
    and H from the rows, zero for a side at the image's edge; zero without
    ``halo``, beyond the map's rows and past the band), at every band
    height of the plan's choice."""
    units, height, width, c, cfg = HALO_SHAPES[shape]
    c = 16 if shape == "small ragged" else 8  # the map's arithmetic, at a narrow width
    rs = np.random.RandomState(units + height)
    nd = 2 * units if cfg else units
    h = rs.randn(nd, height, width, c).astype(np.float32) + 5
    buf = rs.randn(2, nd, width, c).astype(np.float32) - 5
    top, bottom = (buf[0], None) if halo else (None, None)  # a shard at the image's bottom
    rows = tuple(None if r is None else torch.tensor(r) for r in (top, bottom))
    padded = sampler_step_ops.halo_buffer(torch.tensor(h), rows)
    padded = torch.cat([padded[0][:, None], torch.tensor(h), padded[1][:, None]], dim=1).numpy()
    tile = sampler_step_ops.HALO_TILE if kernel == "fp32" else sampler_step_ops.BF16_TILE
    for band_rows in (1, 2, 4, 8, 3):
        plan = sampler_step_ops.HaloPlan(band_rows, 256, 0, 0)
        written = np.zeros((units, height, width), np.int64)
        for (where, off, sample, gy, gx, real), (unit, oy, ox) in _band_sources(
                plan, units, height, width, c, cfg, halo, tile):
            np.add.at(written, (unit, oy, ox), 1)
            got = _staged(where, off, h, top, bottom)
            keep = real & (gy >= -1) & (gy <= height)
            want = np.where(keep[:, None], padded[sample, np.clip(gy + 1, 0, height + 1), gx], 0)
            np.testing.assert_array_equal(got, want)
        assert (written == 1).all()


def test_head_halo_routes_pick_the_kernels_of_their_own():
    """With ``halo``: fp32 takes the fp32 halo kernel under
    :func:`halo_plan` (channels a multiple of 4), else (weights too wide
    for its shared memory) the split launch; bf16 at channels
    a multiple of 64 the bf16 kernel's halo mode under :func:`bf16_plan`,
    at other multiples of 8 its narrow item's halo mode under the same
    plan (the last block masked where 32 does not divide them), and where
    the weights overflow that plan's shared memory the float kernel's bf16
    halo mode under :func:`launch_plan`; without ``halo`` the routes are
    unchanged."""
    ops = sampler_step_ops
    f32, bf = torch.float32, torch.bfloat16
    for c in (32, 36, 40, 64, 96, 128, 160, 256, 264, 512):
        args = (16, 32, 64, c)
        assert ops.route(*args, f32, halo=True) == (ops.HALO_NAMES[f32], ops.halo_plan(*args))
        if c % 64 == 0:
            assert ops.route(*args, bf, halo=True) == (ops.HALO_NAMES[bf], ops.bf16_plan(*args))
        elif c % 8 == 0:
            assert ops.route(*args, bf, halo=True) == (ops.HALO_NARROW_NAME,
                                                       ops.bf16_plan(*args))
        assert ops.route(*args, f32) == (ops.C_NAME, ops.launch_plan(*args))
    assert ops.route(1, 8, 8, 6000, f32, halo=True) == (
        ops.SPLIT_NAMES[f32], ops.split_plan(1, 8, 8, 6000))
    assert ops.route(1, 8, 8, 6000, bf, halo=True) == (
        ops.SPLIT_NAMES[bf], ops.split_plan(1, 8, 8, 6000, element_bytes=2))
    with pytest.raises(ValueError, match="aligned"):
        ops.route(16, 32, 64, 128, f32, aligned=False, halo=True)


def test_head_halo_plan_takes_every_shape_the_float_kernels_halo_mode_took():
    """Every shard shape of n_feat 4 to 512 (steps of 4) at the path's
    units, heights and widths, under CFG and without, that the float
    kernel's halo mode took, the fp32 halo kernel's plan takes."""
    for n_feat in range(4, 513, 4):
        for units, height, width, cfg in ((16, 32, 64, True), (16, 32, 64, False),
                                          (4, 32, 64, False), (10, 64, 128, False),
                                          (10, 64, 128, True), (1, 8, 16, True)):
            try:
                sampler_step_ops.launch_plan(units, height, width, n_feat, cfg=cfg)
            except ValueError:
                continue
            sampler_step_ops.halo_plan(units, height, width, n_feat, cfg=cfg)


@pytest.mark.parametrize("shape", HALO_SHAPES, ids=list(HALO_SHAPES))
def test_head_halo_plan_at_the_path_shapes(shape):
    """The fp32 halo kernel's plan: the shortest band of ``ROWS_HALO``
    whose grid is one wave of the CTAs 132 SMs hold at once (at most
    ``HALO_PER_SM`` an SM; else the tallest that fits); shared memory (weights, the
    warps' rings, the partials of whole tiles) within 227 KB and room for
    ``HALO_PER_SM`` CTAs an SM; warp w owns tiles w, w + 8, ..., every
    tile once; at half the w=2 serving features: bands of 2 rows, 256
    CTAs; at the whole w=2 map (an unsharded launch, timed for
    information): 4 rows."""
    units, height, width, c, cfg = HALO_SHAPES[shape]
    ops = sampler_step_ops
    plan = ops.halo_plan(units, height, width, c, cfg=cfg, sms=132)
    m = (2 if cfg else 1) * (plan.rows + 2) * width
    tiles = -(-m // ops.HALO_TILE)
    assert plan.smem_bytes == 4 * (9 * -(-c // ops.HALO_CK) * ops.HALO_CK
                                   + 8 * ops.HALO_RING * ops.HALO_TILE * ops.HALO_CK
                                   + 9 * tiles * ops.HALO_TILE)
    assert plan.smem_bytes <= 227 * 1024
    assert plan.ctas == units * -(-height // plan.rows)
    def smem(rows):
        tiles = -(-(2 if cfg else 1) * (rows + 2) * width // ops.HALO_TILE)
        return plan.smem_bytes + 4 * 9 * (tiles * ops.HALO_TILE - pstride)

    pstride = -(-m // ops.HALO_TILE) * ops.HALO_TILE
    fits = [r for r in sorted(ops.ROWS_HALO) if smem(r) <= 227 * 1024]
    wave = [r for r in fits if units * -(-height // r)
            <= 132 * min(ops.HALO_PER_SM, ops.SM_SMEM // (smem(r) + 1024))]
    assert plan.rows == (wave[0] if wave else fits[-1])
    warps = plan.threads // 32
    owned = sorted(t for w in range(warps) for t in range(w, tiles, warps))
    assert owned == list(range(tiles))
    assert ops.HALO_TILE * ops.HALO_CK * 4 // 16 == ops.HALO_TILE // 4 * 32  # copies a lane
    assert ops.HALO_TILE % 8 == 0 and ops.HALO_CK * 4 == 128  # a pixel's whole line an item
    if shape == "half of serve w=2":
        assert (plan.rows, plan.ctas) == (2, 256)
    if shape == "serve w=2 whole":
        assert (plan.rows, plan.ctas) == (4, 256)


def test_head_halo_staged_chunks_hit_eight_bank_groups():
    """The fp32 halo kernel keeps a pixel's 16-byte chunk q (of 8: its
    128-byte line) at slot q ^ (pp & 7): a quarter warp's reads (lanes
    (quarter, l), l < 8: pixel l + 8 i, chunk 2 quarter + j) and writes (one
    pixel's 8 chunks) hit 8 bank groups."""
    def group(pp, q):
        return (pp * 8 + (q ^ (pp & 7))) % 8

    for i in range(sampler_step_ops.HALO_TILE // 8):
        for quarter in range(4):
            for j in range(2):
                assert len({group(pl + 8 * i, 2 * quarter + j) for pl in range(8)}) == 8
    for pp in range(sampler_step_ops.HALO_TILE):
        assert len({group(pp, q) for q in range(8)}) == 8


@pytest.mark.parametrize("rows", [None, 1, 2, 3])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("edge", ["top", "middle", "bottom"])
def test_head_halo_kernel_algorithm_matches_plain(monkeypatch, rows, w, edge):
    """The fp32 halo kernel's staging (:func:`_band_sources`), per-tap
    partials (each tile skipping the tap rows its staged rows feed no
    output through: their partials zero here) and gather, emulated on the
    CPU on a shard at the image's top edge, in its middle and at its bottom
    edge, at every band height (3 leaves a ragged band), against
    :func:`head_step_plain` with the same ``halo``: atol 1e-5."""
    cfg = w is not None
    b, hw, c = 3, 12, 16
    h, kernel, bias, x, z = _head_inputs(hw + (rows or 0), cfg, b=b, hw=hw, c=c)
    rs = np.random.RandomState(7)
    nd = h.shape[0]
    halo = tuple(None if side == edge else torch.tensor(np.maximum(
        rs.randn(nd, hw, c), 0).astype(np.float32)) for side in ("top", "bottom"))
    w_val = np.array([1.5, 3.0, 0.5], np.float32) if w == "per-sample" else w
    weight, bias_t = _torch_head(kernel, bias)
    if rows is not None:
        monkeypatch.setattr(sampler_step_ops, "ROWS_HALO", (rows,))
    plan = sampler_step_ops.halo_plan(b, hw, hw, c, cfg=cfg)
    assert rows in (None, plan.rows)
    rows = [None if r is None else r.numpy().astype(np.float64) for r in halo]
    wt = weight[0].permute(1, 2, 0).reshape(9, c).numpy().astype(np.float64)
    pb = (plan.rows + 2) * hw
    out = np.full((b, hw, hw), np.nan)
    for (where, off, _, _, _, _), (unit, oy, ox) in _band_sources(
            plan, b, hw, hw, c, cfg, True, sampler_step_ops.HALO_TILE):
        part = _staged(where, off, h.astype(np.float64), *rows) @ wt.T
        out_rows = len(np.unique(oy))
        tile = sampler_step_ops.HALO_TILE
        for first in range(0, len(part), tile):  # the kernel's tap rows a tile computes
            last = min(first + tile, 2 * pb if cfg else pb) - 1
            r_lo, r_hi = ((first % pb) // hw, (last % pb) // hw) if first // pb == last // pb \
                else (0, plan.rows + 1)
            for ky in range(3):
                if not max(0, r_lo - out_rows + 1) <= ky <= min(2, r_hi):
                    part[first:first + tile, 3 * ky:3 * ky + 3] = 0.0
        r = oy - oy.min()
        eps = []
        for s in range(2 if cfg else 1):
            acc = np.full(r.shape, float(bias[0]))
            for ky in range(3):
                for kx in range(3):
                    col = ox + kx - 1
                    ok = (col >= 0) & (col < hw)
                    acc += np.where(ok, part[s * pb + (r + ky) * hw + np.clip(col, 0, hw - 1),
                                             ky * 3 + kx], 0.0)
            eps.append(acc)
        wu = w_val[unit] if isinstance(w_val, np.ndarray) else w_val
        e = eps[1] + wu * (eps[0] - eps[1]) if cfg else eps[0]
        out[unit, oy, ox] = (x[unit, oy, ox, 0] - e * 0.02) * 1.01 + 0.3 * z[unit, oy, ox, 0]
    want = head_step_plain(torch.tensor(h), weight, bias_t, torch.tensor(x), torch.tensor(z),
                           0.02, 1.01, 0.3, torch.tensor(w_val) if w == "per-sample" else w_val,
                           halo=halo)
    np.testing.assert_allclose(out[..., None], want.numpy(), atol=1e-5, rtol=0)


# ---- K2 bf16: one read, one merge, whole waves ---------------------------------

GROUPNORM_BF16_SHAPES = {  # (n, hw, c): the shapes the bf16 paths give K2
    "up0_norm serve w=2": (32, 16 * 16, 256), "out_norm serve w=2": (32, 64 * 64, 128),
    "up0_norm serve w=0": (16, 16 * 16, 256), "out_norm serve w=0": (16, 64 * 64, 128),
    "up0_norm exact chain": (4, 16 * 16, 256), "out_norm exact chain": (4, 64 * 64, 128),
    "deep up0_norm": (10, 16 * 16, 512), "big up0_norm": (10, 16 * 16, 1024),
    "deep out_norm": (10, 128 * 128, 128), "big out_norm": (10, 128 * 128, 256),
    "deep out_norm, validation batch": (32, 128 * 128, 128),
    "big out_norm, validation batch": (32, 128 * 128, 256),
    "out_norm, 2 maps": (2, 64 * 64, 128), "up0_norm, 2 maps": (2, 16 * 16, 256),
    # n_feat 192: 24 channels a group, 3 packs, which no warp's lane bits split
    "out_norm n_feat 192 serve w=2": (32, 64 * 64, 192),
    "out_norm n_feat 192 exact chain": (4, 64 * 64, 192),
    "up0_norm n_feat 192 serve w=2": (32, 16 * 16, 384),
}


def _groupnorm_bf16_coverage(plan, hw, cg):
    """How often the bf16 kernel's index map touches each (pixel, channel)
    of one unit (``plan.seg`` groups of ``cg`` channels of a sample) under
    ``plan``: rank r's part, thread t's pack t % vs of its ``packs`` pixels
    ``threads / vs`` apart from t / vs (vs: the unit's packs a pixel)."""
    vs = plan.seg * cg // 8
    counts = np.zeros((hw, plan.seg * cg), np.int64)
    step = plan.threads // vs
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        p1 = min(hw, p0 + plan.part_px)
        for t in range(step * vs):
            j = (t % vs) * 8
            pix = p0 + t // vs + step * np.arange(plan.packs)
            counts[pix[pix < p1], j:j + 8] += 1
    return counts


@pytest.mark.parametrize("shape", GROUPNORM_BF16_SHAPES, ids=list(GROUPNORM_BF16_SHAPES))
def test_groupnorm_bf16_plan_at_the_path_shapes(shape):
    """Every (pixel, channel) of a unit read once by the ranks' parts and
    the threads' packs (a thread keeps one group's 8 channels); a unit's
    slice of a pixel is ``BF16_LINE`` bytes where the groups allow; a part
    fits ``BF16_PART`` bytes (16 packs of 512 threads); the
    cluster stops where the plan's rule stops (a grid of ``BF16_SPREAD``
    CTAs, parts of ``BF16_PART_MIN`` bytes, large parts on half the SMs).
    At the w=2 serving out_norm: units of 2 groups (32 channels),
    clusters of 2 parts of 128 KiB, 256 CTAs."""
    n, hw, c = GROUPNORM_BF16_SHAPES[shape]
    plan = groupnorm_ops.bf16_plan(n, hw, c, 8)
    cg = c // 8
    vs = plan.seg * cg // 8
    part_bytes = plan.part_px * plan.seg * cg * 2
    vpg = cg // 8
    assert plan.packs in groupnorm_ops.BF16_PACKS and 8 % plan.seg == 0
    assert plan.seg == 1 or vpg & (vpg - 1) == 0  # the butterfly's lane bits
    assert plan.seg * cg * 2 >= groupnorm_ops.BF16_LINE or plan.seg == 8 or (
        hw * 2 * plan.seg * cg * 2 > 8 * groupnorm_ops.BF16_PART) or (
        2 * plan.seg * cg > 256) or vpg & (vpg - 1)
    assert plan.threads % 32 == 0 and plan.threads % vs == 0
    assert plan.threads * plan.packs * 16 <= groupnorm_ops.BF16_PART
    assert part_bytes <= groupnorm_ops.BF16_PART
    assert plan.part_px * plan.cluster >= hw > plan.part_px * (plan.cluster - 1)
    ops = groupnorm_ops
    grows = (plan.cluster < 8 and plan.cluster < hw and plan.ctas(n, 8) < ops.BF16_SPREAD
             and part_bytes // 2 >= ops.BF16_PART_MIN
             and (part_bytes <= ops.BF16_PART // 2 or 2 * plan.ctas(n, 8) < 132))
    assert not grows  # the cluster stopped where the plan's rule stops
    assert (_groupnorm_bf16_coverage(plan, hw, cg) == 1).all()
    if shape == "out_norm serve w=2":
        assert tuple(plan) == (2, 2, 512, 16, 2048)
    if shape == "out_norm n_feat 192 serve w=2":
        assert tuple(plan) == (1, 2, 480, 16, 2048)


@pytest.mark.parametrize("shape,aligned", [((4, 64, 24), True), ((4, 64, 128), False),
                                           ((4, 16, 8 * 512), True), ((4, 128 * 4096, 256), True),
                                           ((4, 64 * 64, 8 * 20), True),
                                           ((4, 64 * 64, 192), False)])
def test_groupnorm_bf16_plan_raises_on_shapes_no_path_takes(shape, aligned):
    """Channels per group not a multiple of one 16-byte pack (20), an
    unaligned tensor (also at 24 channels a group), a group of over 256
    channels, or a group over 8 parts of ``BF16_PART`` bytes."""
    with pytest.raises(ValueError):
        groupnorm_ops.bf16_plan(*shape, 8, aligned)


def _merge(a, b):
    """Chan's merge of moments (n, mean, m2) a then b, as the kernel's
    ``merge``: float32 arrays, b.n == 0 leaves a."""
    n = a[0] + b[0]
    f = np.divide(b[0], n, out=np.zeros_like(n), where=n > 0)
    d = b[1] - a[1]
    keep = b[0] == 0
    return tuple(np.where(keep, x, y) for x, y in
                 zip(a, (n, a[1] + d * f, a[2] + b[2] + d * d * a[0] * f)))


def _warp_merge(m, skip=()):
    """The kernel's butterfly over the 32 lanes of each warp (axis -1),
    leaving out the offsets ``skip``."""
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        if off in skip:
            continue
        o = tuple(x[..., lane ^ off] for x in m)
        up = (lane & off) > 0
        lo, hi = _merge(m, o), _merge(o, m)
        m = tuple(np.where(up, h, l) for l, h in zip(lo, hi))
    return m


def _kernel_statistics(x_unit, plan, cg):
    """(mean, var) of each group of one unit ``(hw, seg * cg)`` float32 as
    the bf16 kernel takes them: each thread's packs in its order (a pack's
    centred moments merged with weight 1 / k for the k-th), the warps'
    butterflies over each group's lanes, the block's warps in order, then
    the cluster's CTAs in rank order."""
    f32 = np.float32
    hw = x_unit.shape[0]
    vpg = cg // 8
    vs = plan.seg * vpg
    step = plan.threads // vs
    skip = tuple(off for off in (1, 2, 4, 8, 16) if vpg <= off < vs)
    total = None
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        p1 = min(hw, p0 + plan.part_px)
        m = [np.zeros(plan.threads, f32) for _ in range(3)]
        for t in range(plan.threads):
            j = (t % vs) * 8
            for k, p in enumerate(range(p0 + t // vs, p1, step)[:plan.packs]):
                v = x_unit[p, j:j + 8]
                s = f32(0)
                for e in v:
                    s = f32(s + e)
                pm = f32(s * f32(0.125))
                q = f32(0)
                for e in v:
                    q = f32(q + f32(e - pm) * f32(e - pm))
                f = f32(f32(1) / f32(k + 1))
                d = f32(pm - m[1][t])
                m[1][t] = f32(m[1][t] + d * f)
                m[2][t] = f32(m[2][t] + f32(q + d * d * f32(m[0][t] * f)))
                m[0][t] = f32(m[0][t] + 8)
        wm = _warp_merge(tuple(x.reshape(plan.threads // 32, 32) for x in m), skip)
        warp_moments = {}  # (warp, group): written by lanes l % vpg == 0, l < vs
        for w in range(plan.threads // 32):
            for lane in range(0, min(vs, 32), vpg):
                warp_moments[w, ((w * 32 + lane) % vs) // vpg] = tuple(x[w, lane] for x in wm)
        block = []
        for g in range(plan.seg):
            b = tuple(f32(0) for _ in range(3))
            for w in range(plan.threads // 32):  # every warp wrote every group
                b = _merge(b, warp_moments[w, g])
            block.append(b)
        total = block if total is None else [_merge(a, b) for a, b in zip(total, block)]
    return [(f32(t[1]), f32(f32(t[2]) / f32(t[0]))) for t in total]


@pytest.mark.parametrize("spread", [1, 256])
@pytest.mark.parametrize("c,offset", [(128, 0.0), (128, 100.0), (512, 0.0), (192, 0.0)])
def test_groupnorm_bf16_chan_merge_gives_the_plain_statistics(monkeypatch, spread, c,
                                                              offset):
    """Chan's merge of per-pack moments in the kernel's order (each
    thread's packs, the butterflies over a group's lanes, the block's
    warps, the cluster's ranks: 1 or 8 here), in float32, against the
    plain version's statistics (the mean, then the centred variance) in
    float64: within fp32 rounding, 1e-6 of the mean's scale and 1e-5 of
    the variance, also for maps far from zero (offset 100, where
    E[x^2] - E[x]^2 in fp32 loses five digits), for units of 2 groups
    (c 128: 16 channels a group) and of one (c 512; c 192, whose 3 packs
    a group no lane bits split)."""
    monkeypatch.setattr(groupnorm_ops, "BF16_SPREAD", spread)
    n, hw = 2, 96
    rs = np.random.RandomState(spread + c)
    x = (rs.randn(n, hw, c) * 2 + offset).astype(np.float32)
    x = torch.tensor(x).bfloat16().float().numpy()  # the bf16 values the kernel reads
    plan = groupnorm_ops.bf16_plan(n, hw, c, 8)
    cg = c // 8
    assert plan.seg == (2 if c == 128 else 1)
    assert plan.threads % (plan.seg * cg // 8) == 0
    xg = x.reshape(n, hw, 8, cg).astype(np.float64)
    want_mean = xg.mean(axis=(1, 3))
    want_var = ((xg - want_mean[:, None, :, None]) ** 2).mean(axis=(1, 3))
    for b in range(n):
        for s0 in range(0, 8, plan.seg):
            unit = x[b, :, s0 * cg:(s0 + plan.seg) * cg]
            for gl, (mean, var) in enumerate(_kernel_statistics(unit, plan, cg)):
                g = s0 + gl
                assert abs(mean - want_mean[b, g]) <= 1e-6 * (abs(want_mean[b, g]) + 1)
                assert abs(var - want_var[b, g]) <= 1e-5 * want_var[b, g]

# ---- K2 bf16 where groups are not whole packs: the narrow kernel ---------------

NARROW_SHAPES = {  # (n, hw, c): out_norm of the narrow widths, and small ragged maps
    "n_feat 32 16 maps": (32, 64 * 64, 32), "n_feat 32 2 maps": (4, 64 * 64, 32),
    "n_feat 96 16 maps": (32, 64 * 64, 96), "n_feat 160 16 maps": (32, 64 * 64, 160),
    "n_feat 96 2 maps": (4, 64 * 64, 96), "n_feat 160 2 maps": (4, 64 * 64, 160),
    "3 channels a group": (2, 5 * 7, 24), "3 channels a group, 7x7": (3, 7 * 7, 24),
    "n_feat 16 (2 a group)": (2, 9 * 9, 16), "n_feat 40 (5 a group)": (2, 16 * 16, 40),
    "n_feat 56 (7 a group)": (5, 8 * 8, 56),
}
NARROW_PATH_PLANS = {  # (seg, cluster, threads, packs, part_px, wide) at the path's widths
    "n_feat 32 16 maps": (4, 2, 256, 16, 2048, False),
    "n_feat 32 2 maps": (4, 8, 256, 4, 512, False),
    "n_feat 96 16 maps": (4, 8, 192, 16, 512, False),
    "n_feat 160 16 maps": (4, 8, 480, 16, 512, False),
    "3 channels a group": (8, 1, 192, 4, 35, False),
}


def _narrow_map(plan, hw, cg):
    """The narrow kernel's index map of one unit (``plan.seg`` groups of
    ``cg`` channels) under ``plan``: per (rank, thread) its pack j = t % vs,
    its pixels t / vs + k * (threads / vs) (k < packs) inside its part, and
    the unit's 8 channels it holds."""
    vs = plan.seg * cg // 8
    step = plan.threads // vs
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        p1 = min(hw, p0 + plan.part_px)
        for t in range(plan.threads):
            pix = p0 + t // vs + step * np.arange(plan.packs)
            yield rank, t, pix[pix < p1], (t % vs) * 8 + np.arange(8)


@pytest.mark.parametrize("shape", NARROW_SHAPES, ids=list(NARROW_SHAPES))
def test_groupnorm_narrow_plan_covers_every_pixel_channel_and_group_once(shape):
    """The narrow bf16 K2's plan: a unit is the fewest groups whose slice of
    a pixel is whole 16-byte packs, widened until it is whole
    ``NARROW_SECTOR``-byte sectors where the groups allow (n_feat 32: 4
    groups, 32 bytes; 96: 4 of 12, 6 packs; 160: 4 of 20, 10 packs); the
    block is whole warps and whole pixels of the unit, ``NARROW_THREADS``
    where a cluster of at most 8 then fits, at most 512; the cluster is the
    smallest whose parts fit 16 packs a thread, doubled only while the
    grid is short of ``NARROW_SPREAD`` CTAs and a part keeps
    ``BF16_PART_MIN`` bytes; every (pixel, channel) of a unit is read
    once by the ranks' parts and the threads' packs; every group's
    channels once across the packs that straddle it (a pack's 8 channels
    split over up to 4 groups at 3 channels a group); each warp's lanes 0
    .. vs - 1 hold every pack once, and the shuffle tree (lanes vs, 2 vs,
    4 vs, ... apart) gives each of them every lane of its pack once."""
    n, hw, c = NARROW_SHAPES[shape]
    ops = groupnorm_ops
    plan = ops.narrow_plan(n, hw, c, 8)
    cg = c // 8
    uc = plan.seg * cg
    vs = uc // 8
    assert not plan.wide  # whole warps of whole pixels hold these units
    assert uc % 8 == 0 and cg % 8 and 8 % plan.seg == 0 and uc <= 256
    seg0 = 8 // math.gcd(cg, 8)
    sector = ops.NARROW_SECTOR
    assert plan.seg == seg0 or plan.seg // 2 * cg * 2 % sector  # widened to whole sectors
    assert plan.seg == 8 or plan.seg * cg * 2 % sector == 0 or 2 * plan.seg * cg > 256
    assert plan.threads % 32 == 0 and plan.threads % vs == 0 and plan.threads <= 512
    assert plan.packs in ops.NARROW_PACKS
    assert plan.part_px * plan.cluster >= hw > plan.part_px * (plan.cluster - 1)
    part_bytes = plan.part_px * uc * 2
    spread = plan.cluster // 2 * plan.ctas(n, 8) // plan.cluster < ops.NARROW_SPREAD
    fits_half = plan.cluster > 1 and -(-hw // (plan.cluster // 2)) <= 16 * (plan.threads // vs)
    assert not fits_half or spread  # the smallest cluster that fits, but to spread
    grows = (plan.cluster < 8 and plan.cluster < hw and plan.ctas(n, 8) < ops.NARROW_SPREAD
             and part_bytes // 2 >= ops.BF16_PART_MIN)
    assert not grows
    if shape in NARROW_PATH_PLANS:
        assert tuple(plan) == NARROW_PATH_PLANS[shape]
    counts = np.zeros((hw, uc), np.int64)
    group_elems = np.zeros(plan.seg, np.int64)
    for _, _, pix, chans in _narrow_map(plan, hw, cg):
        counts[np.ix_(pix, chans)] += 1
        np.add.at(group_elems, chans // cg, len(pix))  # the channel -> group map
    assert (counts == 1).all()
    assert (group_elems == hw * cg).all()  # each group's channels, each pixel once
    packs_per_group = [len({ch // 8 for ch in range(g * cg, (g + 1) * cg)})
                       for g in range(plan.seg)]
    assert max(packs_per_group) <= -(-cg // 8) + 1
    for w in range(plan.threads // 32):
        lane = np.arange(32)
        j = (32 * w + lane) % vs
        assert sorted(j[:vs]) == list(range(vs))  # lanes 0 .. vs - 1: every pack once
        held = [{l} for l in range(32)]
        s = 1
        while s * vs < 32:
            off = s * vs
            for l in range(32):
                if (l // vs) % (2 * s) == 0 and l + off < 32:
                    held[l] |= held[l + off]
            s *= 2
        for l in range(vs):
            assert held[l] == {m for m in range(32) if j[m] == j[l]}


def _narrow_kernel_statistics(x_unit, plan, cg):
    """(mean, var) of each group of one unit ``(hw, seg * cg)`` float32 as
    the narrow bf16 kernel takes them: each thread's 8 channels, their
    mean over its pixels then the sums of squares about it; the warps'
    shuffle trees over the lanes of a pack (lanes vs, 2 vs, ... apart,
    lower lane first, Chan's formula); the block's warps in order, a
    channel at a time; a group from its channels (equal counts: the mean
    of their means, their sums of squares plus the spread of their means);
    the cluster's CTAs in rank order."""
    f32 = np.float32
    hw = x_unit.shape[0]
    vs = plan.seg * cg // 8
    step, warps = plan.threads // vs, plan.threads // 32
    total = None
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        npx = min(hw, p0 + plan.part_px) - p0
        t = np.arange(plan.threads)
        j, first = t % vs, t // vs
        cnt = np.zeros(plan.threads, f32)
        mean = np.zeros((plan.threads, 8), f32)
        m2 = np.zeros((plan.threads, 8), f32)
        vals = []
        for k in range(plan.packs):
            p = first + k * step
            ok = p < npx
            v = x_unit[p0 + np.minimum(p, max(npx - 1, 0)), :].reshape(hw and -1, 8 * vs)
            v = np.stack([v[i, 8 * j[i]:8 * j[i] + 8] for i in range(plan.threads)])
            vals.append((ok, v.astype(f32)))
            cnt += ok
            mean = np.where(ok[:, None], (mean + v).astype(f32), mean)
        inv = np.where(cnt > 0, f32(1) / np.maximum(cnt, 1), f32(0)).astype(f32)
        mean = (mean * inv[:, None]).astype(f32)
        for ok, v in vals:
            d = (v - mean).astype(f32)
            m2 = np.where(ok[:, None], (m2 + d * d).astype(f32), m2)
        warp_slots = {}
        for w in range(warps):
            c_, mu, q = (cnt[32 * w:32 * w + 32].copy(), mean[32 * w:32 * w + 32].copy(),
                         m2[32 * w:32 * w + 32].copy())
            s = 1
            while s * vs < 32:
                off = s * vs
                c0, mu0, q0 = c_.copy(), mu.copy(), q.copy()
                for l in range(32):
                    if (l // vs) % (2 * s) == 0 and l + off < 32 and c0[l + off] > 0:
                        tot = f32(c0[l] + c0[l + off])
                        f = f32(c0[l + off] / tot)
                        d = (mu0[l + off] - mu0[l]).astype(f32)
                        mu[l] = (mu0[l] + d * f).astype(f32)
                        q[l] = (q0[l] + q0[l + off] + d * d * f32(c0[l] * f)).astype(f32)
                        c_[l] = tot
                s *= 2
            for l in range(vs):
                warp_slots[w, (32 * w + l) % vs] = (c_[l], mu[l], q[l])
        chan = []
        for ch in range(8 * vs):
            b = (f32(0), f32(0), f32(0))
            for w in range(warps):
                cw_, mw, qw = warp_slots[w, ch // 8]
                b = _merge(b, (cw_, mw[ch % 8], qw[ch % 8]))
            chan.append(b)
        block = []
        for g in range(plan.seg):
            cm = [chan[g * cg + k][1] for k in range(cg)]
            cq = [chan[g * cg + k][2] for k in range(cg)]
            gm = f32(f32(sum(cm, f32(0))) / f32(cg))
            spread = sum((f32(m - gm) * f32(m - gm) for m in cm), f32(0))
            block.append((f32(npx * cg), gm, f32(sum(cq, f32(0)) + f32(npx) * spread)))
        total = block if total is None else [_merge(a, b) for a, b in zip(total, block)]
    return [(f32(t[1]), f32(f32(t[2]) / f32(t[0]))) for t in total]


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("shape", ["3 channels a group", "n_feat 16 (2 a group)",
                                   "n_feat 40 (5 a group)", "n_feat 56 (7 a group)",
                                   "n_feat 32, 4 a group", "n_feat 96, 12 a group",
                                   "n_feat 160, 20 a group"])
def test_groupnorm_narrow_merge_gives_the_plain_statistics(shape, offset):
    """The narrow kernel's statistics in its merge order, in float32 (each
    thread's per-channel moments, the warps' shuffle trees, the block's
    warps, its groups from their channels, the cluster's ranks: 1 to 8
    here), against the plain version's (the mean, then the centred
    variance) in float64: the mean within 1e-6 of its scale and the
    variance within 1e-5, also for maps far from zero (offset 100), at 2
    to 20 channels a group, whose packs straddle groups."""
    n, hw, c = {"n_feat 32, 4 a group": (2, 24 * 24, 32), "n_feat 96, 12 a group": (1, 20 * 20, 96),
                "n_feat 160, 20 a group": (1, 16 * 16, 160)}.get(shape) or NARROW_SHAPES[shape]
    rs = np.random.RandomState(c + int(offset))
    x = (rs.randn(n, hw, c) * 2 + offset).astype(np.float32)
    x = torch.tensor(x).bfloat16().float().numpy()  # the bf16 values the kernel reads
    plan = groupnorm_ops.narrow_plan(n, hw, c, 8)
    cg = c // 8
    xg = x.reshape(n, hw, 8, cg).astype(np.float64)
    want_mean = xg.mean(axis=(1, 3))
    want_var = ((xg - want_mean[:, None, :, None]) ** 2).mean(axis=(1, 3))
    for b in range(n):
        for s0 in range(0, 8, plan.seg):
            unit = x[b, :, s0 * cg:(s0 + plan.seg) * cg]
            for gl, (mean, var) in enumerate(_narrow_kernel_statistics(unit, plan, cg)):
                g = s0 + gl
                assert abs(mean - want_mean[b, g]) <= 1e-6 * (abs(want_mean[b, g]) + 1)
                assert abs(var - want_var[b, g]) <= 1e-5 * want_var[b, g]


@pytest.mark.parametrize("shape,aligned", [((4, 64, 32), False), ((4, 64, 128), True),
                                           ((4, 64, 8 * 257), True), ((4, 64, 8 * 264), True),
                                           ((4, 64, 30), True)])
def test_groupnorm_narrow_plan_raises_on_shapes_it_does_not_take(shape, aligned):
    """An unaligned tensor, channels a group a multiple of 8 that
    :func:`bf16_plan` takes (16 a group), a group of over 256 channels
    (257, not whole packs; 264, whole packs that bf16_plan refuses for
    their width), or channels that do not split into the groups."""
    with pytest.raises(ValueError):
        groupnorm_ops.narrow_plan(*shape, 8, aligned)


# ---- K2 bf16 at units the narrow layout cannot hold: the wide layout -----------

WIDE_SHAPES = {  # (n, hw, c): units over 256 channels, odd packs 17-31, large parts
    "n_feat 264 out_norm 16 maps": (32, 64 * 64, 264),
    "n_feat 264 out_norm 2 maps": (4, 64 * 64, 264),
    "n_feat 264 up0_norm 16 maps": (32, 16 * 16, 528),
    "n_feat 264 up0_norm 2 maps": (4, 16 * 16, 528),
    "n_feat 280 out_norm 16 maps": (32, 64 * 64, 280),
    "n_feat 528 out_norm 2 maps": (4, 64 * 64, 528),
    "n_feat 136 out_norm (17 packs)": (32, 64 * 64, 136),
    "n_feat 40 deep out_norm (parts over 16 packs)": (10, 128 * 128, 40),
    "n_feat 320 deep out_norm (whole packs, parts over bf16_plan's)": (10, 128 * 128, 320),
    "n_feat 544 up0_norm (whole packs, 17 a group)": (4, 16 * 16, 1088),
    "33 a group, 7x7": (3, 7 * 7, 264),
    "255 a group, 5x5": (2, 5 * 5, 8 * 255),
}
WIDE_PATH_PLANS = {  # (seg, cluster, threads, packs, part_px, wide)
    "n_feat 264 out_norm 16 maps": (8, 8, 256, 4, 512, True),
    "n_feat 264 out_norm 2 maps": (8, 8, 384, 16, 512, True),
    "n_feat 264 up0_norm 16 maps": (4, 2, 384, 16, 128, True),
    "n_feat 264 up0_norm 2 maps": (4, 8, 384, 4, 32, True),
}


def _wide_map(plan, hw, uc):
    """The wide kernel's index map of one unit of ``uc`` channels under
    ``plan``: per (rank, thread) its pack j = t % vs, its pixels t / vs +
    k * (threads // vs) inside its part, by rounds of ``plan.packs``
    (none for a lane past the last whole pixel), and its 8 channels."""
    vs = uc // 8
    step = plan.threads // vs
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        npx = min(hw, p0 + plan.part_px) - p0
        for t in range(plan.threads):
            first = t // vs if t < step * vs else npx
            pix = np.arange(first, npx, step)
            rounds = [pix[r:r + plan.packs] for r in range(0, len(pix), plan.packs)]
            yield rank, t, p0, rounds, (t % vs) * 8 + np.arange(8)


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=list(WIDE_SHAPES))
def test_groupnorm_wide_plan_covers_every_pixel_and_channel_once(shape):
    """The wide layout of the narrow bf16 K2 (``narrow_plan``'s ``wide``):
    a unit as the narrow layout's (whole packs, at most 8 groups of at
    most 256 channels; one group where groups are whole packs); a CTA of
    whole warps (:func:`idle_lane_threads` of the unit's packs a pixel up
    to ``BF16_WIDE_THREADS``), the lanes past its last whole pixel holding no
    pixel; the smallest cluster whose parts fit 16 packs a thread, else 8
    (a part in rounds of ``packs``), doubled while the grid is short of
    ``NARROW_SPREAD`` CTAs and a part keeps ``BF16_PART_MIN`` bytes; where
    parts take rounds on a grid of more CTAs than SMs, CTAs of up to
    ``WIDE_SHARED_THREADS`` and ``WIDE_SHARED_PACKS`` a round; every
    (pixel, channel) of a unit read once over the ranks, the threads and
    their rounds; every group's channels once; shared memory within 227
    KiB.  At n_feat 264's out_norm: 384 threads (11 pixels of 33 packs, 21
    lanes idle) at 2 maps, 256 (7 pixels) at 16, clusters of 8, parts of
    512 pixels."""
    n, hw, c = WIDE_SHAPES[shape]
    ops = groupnorm_ops
    plan = ops.narrow_plan(n, hw, c, 8)
    bf = torch.bfloat16
    assert plan.wide and ops.single_route(n, hw, c, 8, bf) == (ops.BF16_NARROW_NAME, plan)
    cg = c // 8
    uc = plan.seg * cg
    vs = uc // 8
    assert uc % 8 == 0 and 8 % plan.seg == 0 and cg <= ops.NARROW_GROUP_CH
    assert plan.seg == 8 // math.gcd(cg, 8) or plan.seg * cg * 2 <= 256
    threads = ops.idle_lane_threads(vs, ops.BF16_WIDE_THREADS)
    shared = plan.part_px > 16 * (threads // vs) and plan.ctas(n, 8) > 132
    if shared:  # rounds on a grid of more CTAs than SMs
        assert plan.threads == ops.idle_lane_threads(vs, max(ops.WIDE_SHARED_THREADS,
                                                             -(-vs // 32) * 32))
        assert plan.packs == ops.WIDE_SHARED_PACKS
    else:
        assert plan.threads == threads
    assert plan.threads % 32 == 0 and vs <= plan.threads <= 512
    step = plan.threads // vs  # pixels a step; csrc/groupnorm.cu::wide_smem_bytes's floats:
    assert 4 * (8 * uc + 2 * step * uc + step * vs) <= 227 * 1024 - 1024  # within the opt-in
    assert plan.packs in ops.NARROW_PACKS
    assert plan.part_px == -(-hw // plan.cluster)  # the last ranks may hold nothing (5x5)
    fits = [cl for cl in (1, 2, 4, 8) if -(-hw // cl) <= 16 * (threads // vs)]
    first = fits[0] if fits and fits[0] < 8 else 8
    assert plan.cluster >= first
    if plan.cluster > first:  # grown only to spread a short grid
        half = plan.cluster // 2
        assert plan.ctas(n, 8) // 2 < ops.NARROW_SPREAD
        assert -(-hw // half) * uc * 2 // 2 >= ops.BF16_PART_MIN
    grows = (plan.cluster < 8 and plan.cluster < hw and plan.ctas(n, 8) < ops.NARROW_SPREAD
             and plan.part_px * uc * 2 // 2 >= ops.BF16_PART_MIN)
    assert not grows
    assert shared or plan.packs == next(
        (k for k in ops.NARROW_PACKS if k * step >= plan.part_px), 16)
    if shape in WIDE_PATH_PLANS:
        assert tuple(plan) == WIDE_PATH_PLANS[shape]
    counts = np.zeros((hw, uc), np.int64)
    group_elems = np.zeros(plan.seg, np.int64)
    for _, t, p0, rounds, chans in _wide_map(plan, hw, uc):
        if t >= step * vs:
            assert not rounds  # an idle lane
        for pix in rounds:
            assert len(pix) <= plan.packs
            counts[np.ix_(p0 + pix, chans)] += 1
            np.add.at(group_elems, chans // cg, len(pix))
    assert (counts == 1).all()
    assert (group_elems == hw * cg).all()


def _wide_kernel_statistics(x_unit, plan, cg):
    """(mean, var) of each group of one unit ``(hw, seg * cg)`` float32 as
    the wide kernel takes them: each thread's rounds (a round's per-channel
    mean, then its centred squares, merged into the thread's by Chan's
    formula with weight m / (count + m)), published once; one thread a
    channel merging the threads' pixel rows in order; a group from its
    channels; the cluster's CTAs in rank order."""
    f32 = np.float32
    hw, uc = x_unit.shape
    vs = uc // 8
    step = plan.threads // vs
    total = None
    for rank in range(plan.cluster):
        p0 = min(hw, rank * plan.part_px)
        npx = min(hw, p0 + plan.part_px) - p0
        cnt = np.zeros(step * vs, f32)
        mean = np.zeros((step * vs, 8), f32)
        m2 = np.zeros((step * vs, 8), f32)
        for t in range(step * vs):
            j, first = t % vs, t // vs
            pix = np.arange(first, npx, step)
            for r in range(0, len(pix), plan.packs):
                v = x_unit[p0 + pix[r:r + plan.packs], 8 * j:8 * j + 8].astype(f32)
                m = len(v)
                rm = np.zeros(8, f32)
                for row in v:
                    rm = (rm + row).astype(f32)
                rm = (rm * f32(f32(1) / f32(m))).astype(f32)
                rq = np.zeros(8, f32)
                for row in v:
                    d = (row - rm).astype(f32)
                    rq = (rq + d * d).astype(f32)
                tot = f32(cnt[t] + m)
                f = f32(f32(m) / tot)
                d = (rm - mean[t]).astype(f32)
                mean[t] = (mean[t] + d * f).astype(f32)
                m2[t] = (m2[t] + (rq + d * d * f32(cnt[t] * f))).astype(f32)
                cnt[t] = tot
        chan = []
        for ch in range(uc):
            b = (f32(0), f32(0), f32(0))
            for r in range(step):
                t = r * vs + ch // 8
                b = _merge(b, (cnt[t], mean[t, ch % 8], m2[t, ch % 8]))
            chan.append(b)
        block = []
        for g in range(plan.seg):
            cm = [chan[g * cg + k][1] for k in range(cg)]
            cq = [chan[g * cg + k][2] for k in range(cg)]
            gm = f32(f32(sum(cm, f32(0))) / f32(cg))
            spread = sum((f32(m - gm) * f32(m - gm) for m in cm), f32(0))
            block.append((f32(npx * cg), gm, f32(sum(cq, f32(0)) + f32(npx) * spread)))
        total = block if total is None else [_merge(a, b) for a, b in zip(total, block)]
    return [(f32(t[1]), f32(f32(t[2]) / f32(t[0]))) for t in total]


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("n,hw,c", [(1, 20 * 20, 264), (1, 12 * 12, 528), (2, 9 * 9, 136),
                                    (1, 48 * 48, 280)])
def test_groupnorm_wide_merge_gives_the_plain_statistics(n, hw, c, offset):
    """The wide kernel's statistics in its merge order, in float32 (each
    thread's rounds, the threads' rows a channel, its groups from their
    channels, the cluster's ranks), against the plain version's (the
    mean, then the centred variance) in float64: the mean within 1e-6 of
    its scale and the variance within 1e-5, also for maps far from zero
    (offset 100), at n_feat 264's heads (33 and 66 channels a group, units
    of 264), 136's out_norm (17) and 280's at 48x48 (parts in two rounds)."""
    rs = np.random.RandomState(c + hw + int(offset))
    x = (rs.randn(n, hw, c) * 2 + offset).astype(np.float32)
    x = torch.tensor(x).bfloat16().float().numpy()  # the bf16 values the kernel reads
    plan = groupnorm_ops.narrow_plan(n, hw, c, 8)
    assert plan.wide
    cg = c // 8
    xg = x.reshape(n, hw, 8, cg).astype(np.float64)
    want_mean = xg.mean(axis=(1, 3))
    want_var = ((xg - want_mean[:, None, :, None]) ** 2).mean(axis=(1, 3))
    for b in range(n):
        for s0 in range(0, 8, plan.seg):
            unit = x[b, :, s0 * cg:(s0 + plan.seg) * cg]
            for gl, (mean, var) in enumerate(_wide_kernel_statistics(unit, plan, cg)):
                g = s0 + gl
                assert abs(mean - want_mean[b, g]) <= 1e-6 * (abs(want_mean[b, g]) + 1)
                assert abs(var - want_var[b, g]) <= 1e-5 * want_var[b, g]


# ---- K2's sharded launches: statistics and apply -------------------------------

SHARDED_SHAPES = {  # (n, hw, c, element bytes, aligned): phase (r1)'s shards and more
    "up0_norm half fp32": (32, 8 * 16, 256, 4, True),
    "out_norm half fp32": (32, 32 * 64, 128, 4, True),
    "deep out_norm half fp32": (10, 64 * 128, 128, 4, True),
    "up0_norm half bf16": (32, 8 * 16, 256, 2, True),
    "out_norm half bf16": (32, 32 * 64, 128, 2, True),
    "deep out_norm half bf16": (10, 64 * 128, 128, 2, True),
    "big up0_norm half bf16": (10, 8 * 16, 1024, 2, True),
    "3 channels a group fp32": (2, 5 * 7, 24, 4, True),
    "3 channels a group bf16": (2, 5 * 7, 24, 2, True),
    "unaligned out_norm half fp32": (4, 32 * 64, 128, 4, False),
    "unaligned up0_norm half bf16": (4, 8 * 16, 256, 2, False),
    "n_feat 32 out_norm bf16 (4 channels a group)": (8, 32 * 64, 32, 2, True),
    # n_feat 136 and 264: 17, 33 and 66 channels a group, whole warps of
    # whole pixels over the launch bounds (lanes past the last pixel idle)
    "n_feat 136 out_norm half fp32": (32, 32 * 64, 136, 4, True),
    "n_feat 136 up0_norm half bf16": (32, 8 * 16, 272, 2, True),
    "n_feat 264 out_norm half bf16": (32, 32 * 64, 264, 2, True),
    "n_feat 264 up0_norm half fp32": (32, 8 * 16, 528, 4, True),
}


def _unit_packs(plan, c, groups=8):
    """``(vs, unit channel 0 of segment sg, (lo, hi) of pack j)`` of the
    statistics kernel under ``plan``: a unit's packs a pixel, where they
    start, and the elements of pack j of segment sg that its unit counts.
    Where packs straddle groups (a group's channels not whole packs) a unit
    is one group and its packs are those that overlap the group
    (``straddle_packs`` threads, ``csrc`` ``packs_of``), each counting the
    group's elements alone (none past the group's packs)."""
    cg = c // groups
    if cg % plan.vec == 0:
        return (plan.seg * cg // plan.vec, lambda sg: sg * plan.seg * cg,
                lambda sg, j: (0, plan.vec))
    assert plan.seg == 1 and cg >= plan.vec
    vs = groupnorm_ops.straddle_packs(groups, cg, plan.vec)

    def start(sg):
        return sg * cg // plan.vec * plan.vec

    def span(sg, j):
        ch = start(sg) + j * plan.vec
        lo = max(0, sg * cg - ch)
        return (lo, min(plan.vec, (sg + 1) * cg - ch)) if ch < (sg + 1) * cg else (lo, lo)

    return vs, start, span


def _stats_coverage(plan, n, hw, c, groups=8):
    """How often the statistics kernel's index map counts each (sample,
    pixel, channel) under ``plan``: unit u = (sample, segment) of CTA
    blockIdx // cluster, its part of rank blockIdx % cluster, thread t's
    pack t % vs of pixels t / vs, + threads / vs, ... of the part (the
    threads past the last whole pixel, t >= (threads / vs) * vs, idle);
    where vs is over the block (one group a unit), packs t, t + threads,
    ... of every pixel of the part; a pack's elements of its unit's groups
    (:func:`_unit_packs`: where packs straddle groups, the elements outside
    the group are read by the pack's other unit)."""
    vs, start, span = _unit_packs(plan, c, groups)
    counts = np.zeros((n, hw, c), np.int64)
    if vs > plan.threads:
        assert plan.seg == 1
        for block in range(plan.ctas(n, groups)):
            unit, rank = divmod(block, plan.cluster)
            nn, sg = divmod(unit, groups)
            p0 = min(hw, rank * plan.part_px)
            p1 = min(hw, p0 + plan.part_px)
            for t in range(plan.threads):
                for j in range(t, vs, plan.threads):
                    lo, hi = span(sg, j)
                    ch = start(sg) + j * plan.vec
                    counts[nn, p0:p1, ch + lo:ch + hi] += 1
        return counts
    step = plan.threads // vs
    t = np.arange(step * vs)
    for block in range(plan.ctas(n, groups)):
        unit, rank = divmod(block, plan.cluster)
        nn, sg = divmod(unit, groups // plan.seg)
        p0 = min(hw, rank * plan.part_px)
        p1 = min(hw, p0 + plan.part_px)
        lo, hi = np.array([span(sg, j) for j in range(vs)]).T
        for k in range(-(-plan.part_px // step)):
            pix = p0 + t // vs + k * step
            for e in range(plan.vec):
                ok = (pix < p1) & (lo[t % vs] <= e) & (e < hi[t % vs])
                ch = start(sg) + (t % vs) * plan.vec + e
                np.add.at(counts[nn], (pix[ok], ch[ok]), 1)
    return counts


def _apply_coverage(plan, n, hw, c):
    """How often the apply kernel's index map reads (and writes) each
    (sample, pixel, channel): CTA b takes sample b // ctas, pixels
    [part_px * (b % ctas), + part_px); thread t the pack t % (c / vec) of
    pixels t // (c / vec), + threads / (c / vec), ... (the threads past the
    last whole pixel idle); where c / vec is over the block, packs t, t +
    threads, ... of every pixel of the part."""
    vpp = c // plan.vec
    counts = np.zeros((n, hw, c), np.int64)
    ctas = -(-hw // plan.part_px)
    if vpp > plan.threads:
        for block in range(plan.ctas(n, hw)):
            nn, r = divmod(block, ctas)
            p0 = r * plan.part_px
            p1 = min(hw, p0 + plan.part_px)
            for t in range(plan.threads):
                for j in range(t, vpp, plan.threads):
                    counts[nn, p0:p1, j * plan.vec:(j + 1) * plan.vec] += 1
        return counts
    step = plan.threads // vpp
    t = np.arange(step * vpp)
    for block in range(plan.ctas(n, hw)):
        nn, r = divmod(block, ctas)
        p0 = r * plan.part_px
        p1 = min(hw, p0 + plan.part_px)
        for k in range(-(-plan.part_px // step)):
            pix = p0 + t // vpp + k * step
            ok = pix < p1
            for e in range(plan.vec):
                np.add.at(counts[nn], (pix[ok], ((t % vpp) * plan.vec + e)[ok]), 1)
    return counts


@pytest.mark.parametrize("shape", SHARDED_SHAPES, ids=list(SHARDED_SHAPES))
def test_groupnorm_sharded_plans_cover_every_pixel_and_channel_once(shape):
    """The statistics and apply launches' plans at phase (r1)'s shard
    shapes, 3 channels a group, unaligned tensors, n_feat 32's out_norm
    and n_feat 136's and 264's heads: every (sample, pixel, channel) read
    once; threads whole warps, whole pixels of a unit (a pack within one
    group) where whole warps of them fit the kernels' launch bounds (else
    whole warps, one group a unit, the lanes past the last whole pixel
    idle) and within the bounds; clusters of 1 to 8, 1 wherever the units
    alone give each of 132 SMs a CTA; a unit of several groups only where
    a group's packs are a power of two (the warp butterfly).  At the
    out_norm half in fp32 the statistics take no cluster: 256 units of one
    group."""
    n, hw, c, eb, aligned = SHARDED_SHAPES[shape]
    cg = c // 8
    sp = groupnorm_ops.stats_plan(n, hw, c, 8, aligned, eb, sms=132)
    wide = 16 // eb
    assert sp.vec == (wide if aligned and c % wide == 0 and cg >= wide else 1)
    vs = _unit_packs(sp, c)[0]
    assert 8 % sp.seg == 0 and (sp.seg == 1 or vs & (vs - 1) == 0)
    idle = math.lcm(32, vs) > groupnorm_ops.STATS_MAX_THREADS
    assert sp.threads % 32 == 0 and sp.threads >= vs
    assert sp.threads % vs == 0 if not idle else sp.seg == 1
    assert sp.threads <= groupnorm_ops.STATS_MAX_THREADS
    assert sp.cluster in (1, 2, 4, 8)
    assert sp.cluster == 1 or n * 8 // sp.seg < 132
    assert sp.part_px * sp.cluster >= hw > sp.part_px * (sp.cluster - 1)
    assert (_stats_coverage(sp, n, hw, c) == 1).all()
    ap = groupnorm_ops.apply_plan(n, hw, c, 8, aligned, eb, sms=132)
    assert ap.vec == sp.vec and c % ap.vec == 0 and cg >= ap.vec
    most = 1024 if ap.vec == 1 else 512
    assert ap.threads % 32 == 0 and ap.threads >= c // ap.vec
    assert ap.threads % (c // ap.vec) == 0 or math.lcm(32, c // ap.vec) > most
    assert ap.threads <= most
    assert (_apply_coverage(ap, n, hw, c) == 1).all()
    if shape == "out_norm half fp32":
        assert tuple(sp) == (4, 1, 1, 256, 2048) and sp.ctas(n, 8) == 256
        assert ap.ctas(n, hw) >= 132
    if shape == "out_norm half bf16":
        assert (sp.seg, sp.cluster) == (2, 2)
    if shape in ("up0_norm half fp32", "up0_norm half bf16"):
        assert ap.part_px == 16 and ap.ctas(n, hw) == 256  # one CTA an SM at least
    if shape == "n_feat 136 out_norm half fp32":  # 17 channels a group: 5 packs, 32 pixels
        assert (sp.vec, sp.seg, sp.threads) == (4, 1, 160)
    if shape == "n_feat 264 up0_norm half fp32":  # 132 packs a pixel: three of 416
        assert (ap.vec, ap.threads) == (4, 416)


@pytest.mark.parametrize("head,eb,aligned", [(head, eb, aligned) for head in ("out_norm", "up0_norm")
                                             for eb in (4, 2) for aligned in (True, False)])
def test_groupnorm_sharded_plans_take_every_shape_the_single_launch_takes(head, eb, aligned):
    """For every n_feat from 8 to 512 in steps of 8, at the out_norm half
    ``(32, 32 * 64, n_feat)`` and the up0_norm half ``(32, 8 * 16, 2 n_feat)``
    of a 1x2 mesh: wherever :func:`launch_plan` takes the shape, the
    statistics and apply plans take it too; where whole warps of whole
    pixels fit the kernels' launch bounds they keep their earlier plans (a
    block of whole pixels), elsewhere their lanes past the last whole pixel idle,
    fewer than an eighth of them."""
    taken = 0
    for n_feat in range(8, 513, 8):
        n, hw, c = (32, 32 * 64, n_feat) if head == "out_norm" else (32, 8 * 16, 2 * n_feat)
        try:
            groupnorm_ops.launch_plan(n, hw, c, 8, aligned, eb)
        except ValueError:
            continue
        taken += 1
        sp = groupnorm_ops.stats_plan(n, hw, c, 8, aligned, eb, sms=132)
        ap = groupnorm_ops.apply_plan(n, hw, c, 8, aligned, eb, sms=132)
        vs = _unit_packs(sp, c)[0]
        vpp = c // ap.vec
        whole = math.lcm(32, vs)
        if whole <= groupnorm_ops.STATS_MAX_THREADS:  # whole warps of whole pixels
            assert sp.threads == min(max(whole, 256 - 256 % whole),
                                     -(-sp.part_px * vs // whole) * whole)
        else:
            assert sp.seg == 1 and sp.threads % vs < sp.threads / 8
        whole = math.lcm(32, vpp)
        if whole <= (1024 if ap.vec == 1 else 512):
            assert ap.threads == max(whole, 256 - 256 % whole)
        else:
            assert ap.threads % vpp < ap.threads / 8
    assert taken == 64


@pytest.mark.parametrize("n,hw,c,eb,aligned", [(2, 64, 30, 4, True), (2, 64, 4100, 4, True),
                                               (2, 64, 6148, 4, False), (2, 64, 8196, 2, True)])
def test_groupnorm_sharded_plans_raise_on_shapes_no_path_takes(n, hw, c, eb, aligned):
    """Only channels that do not split into 8 groups (30, and 4 past the
    widths that once raised for a pixel over the launch bounds: 4096,
    6144 unaligned, 8192 in bf16, which the plans now take,
    :func:`test_groupnorm_pair_plans_cover_pixels_wider_than_a_cta`)."""
    with pytest.raises(ValueError, match="groups"):
        groupnorm_ops.apply_plan(n, hw, c, 8, aligned, eb)
    with pytest.raises(ValueError, match="groups"):
        groupnorm_ops.stats_plan(n, hw, c, 8, aligned, eb)


PAIR_SHAPES = {  # (n, hw, c, element bytes, aligned): pixels or groups over a CTA
    "4096 fp32 (1024 packs a pixel)": (2, 64, 4096, 4, True),
    "6144 fp32 unaligned (768 elements a group)": (2, 64, 6144, 4, False),
    "8192 bf16 (1024 packs a pixel)": (2, 64, 8192, 2, True),
    "n_feat 1032 up0_norm fp32 (2064 elements a pixel)": (4, 16 * 16, 2064, 4, True),
    "n_feat 1032 up0_norm bf16": (4, 16 * 16, 2064, 2, True),
    "n_feat 4104 up0_norm fp32 (1026 elements a group)": (2, 4 * 4, 8208, 4, True),
    "fp32 out_norm of n_feat 512 at 128x128 (a slice over SPILL_MAX)": (1, 128 * 128, 512, 4,
                                                                        True),
}


@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=list(PAIR_SHAPES))
def test_groupnorm_pair_plans_cover_pixels_wider_than_a_cta(shape):
    """The statistics and apply plans where a pixel's accesses outnumber
    the apply kernel's launch bound (512 packs, 1024 elements) or a
    group's the statistics kernel's (512): a thread takes several accesses
    of each pixel in equal rounds of whole warps (of at most 512 threads
    in the statistics, ``APPLY_THREADS`` in the apply), every (sample,
    pixel, channel) read once; elsewhere (the out_norm of n_feat 512) the earlier
    plans.  Where the single launch refuses the shape (all but the
    aligned 4096 and 8192 channels, whose groups are 128 packs),
    :func:`single_route` gives the pair these plans."""
    n, hw, c, eb, aligned = PAIR_SHAPES[shape]
    sp = groupnorm_ops.stats_plan(n, hw, c, 8, aligned, eb, sms=132)
    ap = groupnorm_ops.apply_plan(n, hw, c, 8, aligned, eb, sms=132)
    vs = _unit_packs(sp, c)[0]
    vpp = c // ap.vec
    for plan, width, bound, most in (
            (sp, vs, groupnorm_ops.STATS_MAX_THREADS, groupnorm_ops.STATS_MAX_THREADS),
            (ap, vpp, 1024 if ap.vec == 1 else 512, groupnorm_ops.APPLY_THREADS)):
        assert plan.threads % 32 == 0 and plan.threads <= bound
        if width > bound:  # equal rounds of at most `most`
            rounds = -(-width // most)
            assert plan.threads == -(-(-(-width // rounds)) // 32) * 32
    assert (_stats_coverage(sp, n, hw, c) == 1).all()
    assert (_apply_coverage(ap, n, hw, c) == 1).all()
    dtype = torch.float32 if eb == 4 else torch.bfloat16
    name, plan = groupnorm_ops.single_route(n, hw, c, 8, dtype, aligned)
    if shape.startswith(("4096", "8192")):
        groupnorm_ops.launch_plan(n, hw, c, 8, aligned, eb)
        assert name in (groupnorm_ops.C_NAME, groupnorm_ops.BF16_GENERIC_NAME)
    else:
        with pytest.raises(ValueError):
            groupnorm_ops.launch_plan(n, hw, c, 8, aligned, eb)
        assert (name, plan) == (groupnorm_ops.PAIR_NAMES[dtype], groupnorm_ops.PairPlan(sp, ap))


def _stats_kernel_statistics(x, plan, groups=8):
    """``(n, groups, 3)`` float32 as the statistics kernel takes them from
    ``x`` ``(n, hw, c)`` float32: each thread's packs in order (a pack's
    centred moments merged by Chan's formula), the butterfly over each
    group's lanes, the block's warps in order, the cluster's ranks in
    order."""
    f32 = np.float32
    n, hw, c = x.shape
    cg = c // groups
    vs, start, span = _unit_packs(plan, c, groups)
    vpg = vs // plan.seg
    step = plan.threads // vs
    warps = plan.threads // 32
    skip = tuple(off for off in (1, 2, 4, 8, 16) if vpg <= off < vs)
    t = np.arange(plan.threads)
    out = np.zeros((n, groups, 3), f32)
    for unit in range(n * groups // plan.seg):
        nn, sg = divmod(unit, groups // plan.seg)
        total = None
        for rank in range(plan.cluster):
            p0 = min(hw, rank * plan.part_px)
            p1 = min(hw, p0 + plan.part_px)
            m = tuple(np.zeros(plan.threads, f32) for _ in range(3))
            ch0 = start(sg) + (t % vs) * plan.vec
            lo, hi = np.array([span(sg, j) for j in range(vs)])[t % vs].T
            inside = (lo[:, None] <= np.arange(plan.vec)) & (np.arange(plan.vec) < hi[:, None])
            k_pack = (hi - lo).astype(f32)
            for k in range(-(-plan.part_px // step)):
                pix = p0 + t // vs + k * step
                # The lanes past the last whole pixel idle; a straddling
                # unit's packs past its group count nothing.
                ok = (pix < p1) & (t < step * vs) & (hi > lo)
                v = x[nn, np.minimum(pix, hw - 1)[:, None],
                      np.minimum(ch0[:, None] + np.arange(plan.vec), c - 1)]
                v = np.where(inside, v, f32(0)).astype(f32)
                s = np.zeros(plan.threads, f32)
                for e in range(plan.vec):
                    s = (s + v[:, e]).astype(f32)
                pm = (s * (f32(1) / np.maximum(k_pack, f32(1)))).astype(f32)
                q = np.zeros(plan.threads, f32)
                for e in range(plan.vec):
                    d = np.where(inside[:, e], v[:, e] - pm, f32(0)).astype(f32)
                    q = (q + d * d).astype(f32)
                pack = (np.where(ok, k_pack, f32(0)).astype(f32), pm, q)
                m = _merge(m, pack)
            wm = _warp_merge(tuple(a.reshape(warps, 32) for a in m), skip)
            warp_moments = {}
            for w in range(warps):
                for g in range(plan.seg):
                    warp_moments[w, g] = (f32(0), f32(0), f32(0))
                for lane in range(0, min(vs, 32), vpg):
                    g = ((w * 32 + lane) % vs) // vpg
                    warp_moments[w, g] = tuple(a[w, lane] for a in wm)
            block = []
            for g in range(plan.seg):
                b = (f32(0), f32(0), f32(0))
                for w in range(warps):
                    b = _merge(b, warp_moments[w, g])
                block.append(b)
            total = block if total is None else [_merge(a, b) for a, b in zip(total, block)]
        for gl, b in enumerate(total):
            out[nn, sg * plan.seg + gl] = (hw * cg, b[1], b[2])
    return out


@pytest.mark.parametrize("shape,offset", [((4, 2048, 128, 4), 0.0), ((4, 2048, 128, 2), 100.0),
                                          ((2, 35, 24, 4), 0.0), ((3, 1024, 64, 2), 0.0),
                                          ((2, 64, 1024, 4), 0.0), ((2, 300, 264, 4), 0.0)])
def test_groupnorm_stats_kernel_merge_gives_the_plain_statistics(shape, offset):
    """The statistics kernel's merge order (each thread's packs by Chan's
    formula, the butterfly, the block's warps, the cluster's ranks), in
    float32, against the plain version's statistics in float64: the
    count exact, the mean within 1e-6 of its scale and the centred sum of
    squares within 1e-5, also far from zero (offset 100), under clusters of
    1 to 8, units of 1 and 2 groups, the scalar path (24 channels) and
    idle lanes past the last whole pixel (33 channels a group)."""
    n, hw, c, eb = shape
    rs = np.random.RandomState(hw + c)
    x = (rs.randn(n, hw, c) * 2 + offset).astype(np.float32)
    if eb == 2:
        x = torch.tensor(x).bfloat16().float().numpy()  # the bf16 values the kernel reads
    plan = groupnorm_ops.stats_plan(n, hw, c, 8, True, eb, sms=132)
    got = _stats_kernel_statistics(x, plan)
    want = groupnorm_ops.groupnorm_stats_plain(
        torch.tensor(x, dtype=torch.float64).reshape(n, hw, 1, c), 8).numpy()
    assert np.array_equal(got[..., 0], want[..., 0])
    assert (np.abs(got[..., 1] - want[..., 1]) <= 1e-6 * (np.abs(want[..., 1]) + 1)).all()
    assert (np.abs(got[..., 2] - want[..., 2]) <= 1e-5 * want[..., 2]).all()


def _narrow_model_shapes(n_feat, maps=4, height=64):
    """The shapes a canonical model of ``n_feat`` gives the unsharded
    bf16 K1 and K2 at a served w=2 step of ``maps`` maps: up0_norm (2 n_feat
    channels at height / 4), out_norm (n_feat at height), out_conv2's
    features (n_feat channels, 2 maps a pair under CFG)."""
    n = 2 * maps
    return {"up0_norm": (n, (height // 4) ** 2, 2 * n_feat),
            "out_norm": (n, height * height, n_feat),
            "head_step": (maps, height, height, n_feat)}


def test_narrow_model_shapes_are_the_models():
    model = ContextUnet.canonical(n_feat=32, height=64)
    shapes = _narrow_model_shapes(32)
    assert model.up0_norm.weight.shape[0] == shapes["up0_norm"][2]
    assert model.out_norm.weight.shape[0] == shapes["out_norm"][2]
    assert model.out_conv2.weight.shape[1] == shapes["head_step"][3]


@pytest.mark.parametrize("n_feat", [32, 96, 128, 160, 256])
def test_bf16_routes_give_narrow_models_the_float_kernels_instance(n_feat):
    """The routes of narrow bf16 widths: where a bf16 model's out_norm has
    channels a group not a multiple of 8 and its out_conv2 an odd multiple
    of 32 channels (n_feat 32, 96 and 160), K2 takes the narrow bf16
    kernel under :func:`narrow_plan` and K1 the bf16 kernel's narrow item
    under :func:`bf16_plan` (in the halo mode too); n_feat 128 and 256
    keep the bf16 kernels at their wide items, as do the up0_norm heads (8
    to 64 channels a group).  fp32 takes the float kernels, but for the
    out_norm of n_feat 256 (64 KiB slices), which takes the large-slice
    kernel under :func:`large_plan`.  K2's
    float kernel's bf16 instance is reached by unaligned pointers; K1 at
    channels not a multiple of 32 (24, 40) takes the narrow item with a
    masked last block, not the float kernel's bf16 instance."""
    bf = torch.bfloat16
    shapes = _narrow_model_shapes(n_feat)
    narrow = n_feat in (32, 96, 160)
    name, plan = groupnorm_ops.single_route(*shapes["out_norm"], 8, bf)
    if narrow:
        assert (name, plan) == (groupnorm_ops.BF16_NARROW_NAME,
                                groupnorm_ops.narrow_plan(*shapes["out_norm"], 8))
        with pytest.raises(ValueError):
            groupnorm_ops.bf16_plan(*shapes["out_norm"], 8)
    else:
        assert (name, plan) == (groupnorm_ops.BF16_NAME,
                                groupnorm_ops.bf16_plan(*shapes["out_norm"], 8))
    assert groupnorm_ops.single_route(*shapes["up0_norm"], 8, bf)[0] == groupnorm_ops.BF16_NAME
    for head in ("up0_norm", "out_norm"):
        assert groupnorm_ops.single_route(*shapes[head], 8, torch.float32) == (
            (groupnorm_ops.LARGE_NAME, groupnorm_ops.large_plan(*shapes[head], 8))
            if (head, n_feat) == ("out_norm", 256)
            else (groupnorm_ops.C_NAME, groupnorm_ops.launch_plan(*shapes[head], 8)))
        assert groupnorm_ops.single_route(*shapes[head], 8, bf, aligned=False) == (
            groupnorm_ops.BF16_GENERIC_NAME,
            groupnorm_ops.launch_plan(*shapes[head], 8, False, 2))
    name, plan = sampler_step_ops.route(*shapes["head_step"], bf)
    assert (name, plan) == (
        sampler_step_ops.BF16_NARROW_NAME if narrow else sampler_step_ops.BF16_NAME,
        sampler_step_ops.bf16_plan(*shapes["head_step"]))
    assert plan.block == (sampler_step_ops.BF16_NARROW_BLOCK if narrow
                          else sampler_step_ops.BF16_BLOCK)
    assert sampler_step_ops.route(*shapes["head_step"], torch.float32)[0] == (
        sampler_step_ops.C_NAME)
    assert sampler_step_ops.route(*shapes["head_step"], bf, halo=True)[0] == (
        sampler_step_ops.HALO_NARROW_NAME if narrow else sampler_step_ops.HALO_NAMES[bf])
    units, height, width, _ = shapes["head_step"]
    for c in (24, 40):  # widths no item divides: the narrow item, its last block masked
        for halo in (False, True):
            name, plan = sampler_step_ops.route(units, height, width, c, bf, halo=halo)
            assert name == (sampler_step_ops.HALO_NARROW_NAME if halo
                            else sampler_step_ops.BF16_NARROW_NAME)
            assert plan == sampler_step_ops.bf16_plan(units, height, width, c)


def test_bf16_routes_raise_where_no_kernel_takes_the_shape():
    """An unaligned bf16 feature map, or one of channels not a multiple of
    8, takes no K1 kernel (the split launch neither); K2 raises only where
    the channels do not split into the groups: a group of 258 channels
    (over 256, not whole packs: too wide for the narrow kernels and for
    the float template's threads) takes the pair on one card."""
    bf = torch.bfloat16
    for c in (128, 6000):
        with pytest.raises(ValueError, match="aligned"):
            sampler_step_ops.route(4, 64, 64, c, bf, aligned=False)
    with pytest.raises(ValueError, match="channels"):
        sampler_step_ops.route(4, 64, 64, 36, bf)
    with pytest.raises(ValueError, match="channels"):
        sampler_step_ops.route(1, 8, 8, 6004, bf)
    with pytest.raises(ValueError, match="groups"):
        groupnorm_ops.single_route(2, 64, 8 * 258 + 4, 8, bf)
    assert groupnorm_ops.single_route(2, 64, 8 * 258, 8, bf)[0] == groupnorm_ops.PAIR_NAMES[bf]


@pytest.mark.parametrize("maps", [2, 16])
@pytest.mark.parametrize("n_feat,head", [(264, "out_norm"), (280, "out_norm"),
                                         (528, "out_norm"), (264, "up0_norm")])
def test_bf16_groupnorm_routes_take_the_narrow_kernel_at_units_over_256_channels(
        n_feat, head, maps):
    """The bf16 models' heads whose unit of whole packs is over 256
    channels (n_feat 264, 280 and 528's out_norm: 33, 35 and 66 channels a
    group; n_feat 264's up0_norm: 66) take the narrow bf16 kernel under
    :func:`narrow_plan` in its wide layout, at 2 and 16 maps; the bf16
    kernel's plan refuses them; K1 at their out_conv2 takes the narrow
    item (264, 280: masked last blocks; 528: 64-channel items)."""
    bf = torch.bfloat16
    shapes = _narrow_model_shapes(n_feat, maps)
    n, hw, c = shapes[head]
    with pytest.raises(ValueError):
        groupnorm_ops.bf16_plan(n, hw, c, 8)
    plan = groupnorm_ops.narrow_plan(n, hw, c, 8)
    assert plan.wide and plan.seg * (c // 8) > 256
    assert groupnorm_ops.single_route(n, hw, c, 8, bf) == (groupnorm_ops.BF16_NARROW_NAME, plan)
    name, plan = sampler_step_ops.route(*shapes["head_step"], bf)
    assert name == (sampler_step_ops.BF16_NAME if n_feat % 64 == 0
                    else sampler_step_ops.BF16_NARROW_NAME)


def test_bf16_groupnorm_generic_instance_takes_only_unaligned_and_wide_groups():
    """The float kernel's bf16 instance takes exactly the domain
    :func:`single_route` states, at 8 groups of 1 to 300 channels on the
    heads' maps (and a 7x7 one): an unaligned pointer, or a group of over
    256 channels; every other shape takes the bf16 kernel (groups of whole
    packs it holds) or the narrow kernel (the rest, its wide layout
    included); where the float template too refuses the shape (a group of
    over 256 elements not whole packs), the statistics and apply launches
    on one card.  So no head of the repository's models at widths to 1024
    takes it on aligned tensors."""
    bf = torch.bfloat16
    ops = groupnorm_ops
    for c in range(8, 8 * 300 + 1, 8):
        cg = c // 8
        for n, hw in ((4, 64 * 64), (32, 16 * 16), (4, 16 * 16), (10, 128 * 128), (3, 7 * 7)):
            for aligned in (True, False):
                generic = not aligned or cg > 256
                name, plan = ops.single_route(n, hw, c, 8, bf, aligned)
                if name == ops.PAIR_NAMES[bf]:
                    assert generic
                    with pytest.raises(ValueError):
                        ops.launch_plan(n, hw, c, 8, aligned, 2)
                    continue
                assert (name == ops.BF16_GENERIC_NAME) == generic, (c, n, hw, aligned)
                if name == ops.BF16_NAME:
                    assert cg % 8 == 0
                if name == ops.BF16_NARROW_NAME:
                    assert plan.wide or cg % 8


# ---- wrappers on the CPU ----------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (fused_film.launches, fused_groupnorm_act.launches,
              fused_head_step.launches)
    x = torch.randn(2, 4, 4, 8)
    row = torch.randn(1, 8)
    assert torch.equal(fused_film(x, row, row), film_plain(x, row, row))
    g, b = torch.ones(8), torch.zeros(8)
    assert torch.equal(fused_groupnorm_act(x, g, b), groupnorm_act_plain(x, g, b))
    h, x1 = torch.randn(4, 4, 4, 8), torch.randn(2, 4, 4, 1)
    head = (torch.randn(1, 8, 3, 3), torch.randn(1))
    assert torch.equal(fused_head_step(h, *head, x1, x1, 0.1, 1.1, 0.2, 2.0),
                       head_step_plain(h, *head, x1, x1, 0.1, 1.1, 0.2, 2.0))
    assert (fused_film.launches, fused_groupnorm_act.launches,
            fused_head_step.launches) == before


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 4, 4, 8, device="meta")
    row = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_film(x, row, row)
    with pytest.raises(ValueError, match="device"):
        fused_groupnorm_act(x, torch.empty(8, device="meta"), torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="device"):
        fused_head_step(x, torch.empty(1, 8, 3, 3, device="meta"),
                        torch.empty(1, device="meta"), x[..., :1], x[..., :1], 0.1, 1.0, 0.1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not any(tmp_path.iterdir())
