"""PyTorch port: each kernel's plain version (what its wrapper runs on CPU
tensors) against the JAX Pallas kernel in interpret mode and the JAX XLA
path, on the same numpy inputs; the launch plans' index maps."""

import numpy as np
import pytest
import torch

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
    ({"cout": 2}, "one output channel"),
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
                                            (3, 35, 6, True), (2, 64, 128, False)])
def test_film_launch_plan_covers_every_element_once(n, hw, c, aligned):
    """The kernel's index map (csrc/film.cu) under the plan: each (pixel,
    channel) of a sample once; at most one wave of 132 SMs."""
    plan = film_ops.launch_plan(n, hw, c, aligned, sms=132)
    assert plan.vec == (4 if aligned and c % 4 == 0 else 1)
    per_pixel = c // plan.vec
    pstride = plan.threads // per_pixel
    assert plan.threads % per_pixel == 0 and plan.threads <= film_ops.MAX_THREADS
    counts = np.zeros((hw, c), np.int64)
    for bx in range(plan.blocks_per_sample):
        for t in range(plan.threads):
            j = (t % per_pixel) * plan.vec
            counts[bx * pstride + t // per_pixel::plan.blocks_per_sample * pstride,
                   j:j + plan.vec] += 1
    assert (counts == 1).all()
    assert n * plan.blocks_per_sample <= 132 * film_ops.BLOCKS_PER_SM or plan.blocks_per_sample == 1



@pytest.mark.parametrize("n,hw,c", [(65536, 16, 128), (1, 2**24, 128), (2, 16, 8192)])
def test_film_launch_plan_raises_on_shapes_no_path_takes(n, hw, c):
    """More samples than grid.y holds, a sample of 2**31 floats (the
    kernel's offsets are 32-bit), or a pixel wider than a block."""
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
