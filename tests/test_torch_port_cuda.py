"""PyTorch port on the card: each CUDA kernel against its plain version,
the wrappers' checks and launch counts, and the samplers and likelihood
passes on the GPU against the CPU.

Marked ``cuda``; the card is looked for inside a fixture, so every worker
collects the same tests and they skip on machines without one.  Run them
on the card with ``python -m pytest tests/test_torch_port_cuda.py -m cuda``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from camels_diffusion_model_tpu_torch.diffusion import likelihood
from camels_diffusion_model_tpu_torch.diffusion.ddim import (
    ddim_timesteps,
    posterior_coefficients,
    sample_ddim,
)
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.models.quantize import QuantConv
from camels_diffusion_model_tpu_torch.ops.film import film_plain, fused_film
from camels_diffusion_model_tpu_torch.ops.groupnorm import (
    fused_groupnorm_act,
    groupnorm_act_plain,
    groupnorm_apply,
    groupnorm_apply_plain,
    groupnorm_stats,
    groupnorm_stats_plain,
    bf16_plan,
    launch_plan,
    narrow_plan,
)
from camels_diffusion_model_tpu_torch.ops.sampler_step import (
    fused_head_step,
    guided_eps,
    head_step_plain,
)
from camels_diffusion_model_tpu_torch.training import trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def fp32_convs(monkeypatch):
    """cuDNN convolutions in full fp32: the plain versions' F.conv2d would
    run in TF32 otherwise (three decimal digits)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("b", [16, 4, 2])
def test_head_step_kernel_at_the_path_shapes(dev, fp32_convs, b, with_z, w):
    """Output conv + guidance + step on (2B or B, 64, 64, 128) features,
    the path's shapes at B = 16 (decoder batch 32 under CFG, 16 without)
    and 4, and B = 2; sigma = 0 skips z.  The conv's 1152-term sums are
    taken in another order than cuDNN's: atol 1e-4."""
    cfg = w is not None
    h = _randn(dev, 2 * b if cfg else b, 64, 64, 128, seed=1).relu()
    weight = _randn(dev, 1, 128, 3, 3, seed=2).mul(0.05).contiguous(
        memory_format=torch.channels_last)
    bias = _randn(dev, 1, seed=3)
    x, z = _randn(dev, b, 64, 64, 1, seed=4), _randn(dev, b, 64, 64, 1, seed=5)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    sigma = 0.3 if with_z else 0.0
    args = (h, weight, bias, x, z if with_z else None, 0.02, 1.01, sigma, w)
    before = fused_head_step.launches
    got = fused_head_step(*args)
    assert fused_head_step.launches == before + 1
    torch.testing.assert_close(got, head_step_plain(*args), atol=1e-4, rtol=0)


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(3, 64, 64, 128), (2, 16, 16, 48), (2, 16, 16, 8),
                                   (2, 12, 12, 12)])
def test_head_step_kernel_every_plan(dev, fp32_convs, monkeypatch, rows, shape):
    """Every band height (3 leaves a ragged band) and chunk width (32, 16,
    8 and 4 channels) under CFG and without, an odd batch: atol 1e-4."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    monkeypatch.setattr(sampler_step, "ROWS", (rows,))
    b, hw, _, c = shape
    weight, bias = _randn(dev, 1, c, 3, 3, seed=2) * 0.1, _randn(dev, 1, seed=3)
    for cfg in (True, False):
        h = _randn(dev, 2 * b if cfg else b, hw, hw, c, seed=1).relu()
        x, z = _randn(dev, b, hw, hw, 1, seed=4), _randn(dev, b, hw, hw, 1, seed=5)
        args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, 2.0 if cfg else None)
        torch.testing.assert_close(fused_head_step(*args), head_step_plain(*args),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("act", ["relu", "gelu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [(3, 16, 16, 256), (2, 64, 64, 128), (2, 5, 7, 24)])
def test_groupnorm_kernel_matches_plain(dev, act, shape):
    """Statistics summed in another order, rsqrtf: atol 1e-4."""
    x = _randn(dev, *shape) * 3 + 1
    gamma, beta = _randn(dev, shape[-1], seed=4), _randn(dev, shape[-1], seed=5)
    got = fused_groupnorm_act(x, gamma, beta, 8, 1e-5, act)
    torch.testing.assert_close(got, groupnorm_act_plain(x, gamma, beta, 8, 1e-5, act),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("head", ["up0_norm", "out_norm"])
@pytest.mark.parametrize("n", [32, 16, 4])
def test_groupnorm_kernel_at_the_path_shapes(dev, n, head, film):
    """The decoder's heads at batches 32 (w=2), 16 (w=0) and 4 (exact
    chain), i.e. every cluster size the plan picks there, with and without
    the FiLM epilogue (scale one row per sample, shift one row): atol 1e-4."""
    shape = {"up0_norm": (n, 16, 16, 256), "out_norm": (n, 64, 64, 128)}[head]
    c = shape[-1]
    x = _randn(dev, *shape) * 3 + 1
    args = (x, _randn(dev, c, seed=4), _randn(dev, c, seed=5), 8, 1e-5, "relu")
    rows = (_randn(dev, n, c, seed=6), _randn(dev, 1, c, seed=7)) if film else None
    before = fused_groupnorm_act.launches
    got = fused_groupnorm_act(*args, film=rows)
    assert fused_groupnorm_act.launches == before + 1
    torch.testing.assert_close(got, groupnorm_act_plain(*args, film=rows), atol=1e-4, rtol=0)


def test_groupnorm_kernel_slice_over_48_kb(dev):
    """A group of 128x128x16 floats: 128 KB a CTA even in a cluster of 8,
    so the launch asks for more than the default 48 KB of shared memory."""
    shape = (2, 128, 128, 128)
    assert launch_plan(2, 128 * 128, 128, 8).smem_bytes > 48 * 1024
    x = _randn(dev, *shape) * 3 + 1
    args = (x, _randn(dev, 128, seed=4), _randn(dev, 128, seed=5), 8, 1e-5, "relu")
    torch.testing.assert_close(fused_groupnorm_act(*args), groupnorm_act_plain(*args),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "leaky_relu"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("shape", [(32, 8, 16, 256), (32, 32, 64, 128), (2, 5, 7, 24),
                                   (2, 64, 128, 256), (2, 8, 16, 136), (2, 8, 16, 264),
                                   (2, 4, 8, 528)])
def test_groupnorm_sharded_launches_match_plain(dev, dtype, shape, film, act):
    """K2's sharded mode on four height shards: each statistics launch
    against its plain version (each column within 1e-5 of its largest
    value), each apply launch against its plain version on the shards'
    partials (fp32 1e-4; bf16 two ulps of the output) under every
    activation compiled in, with and without the FiLM epilogue, and the
    shards' outputs together the whole map's GroupNorm; one launch counted
    each.  Also n_feat 136's and 264's out_norm and 264's up0_norm (17, 33
    and 66 channels a group), whose plans leave lanes past the last whole
    pixel idle."""
    n, h, w, c = shape
    x = (_randn(dev, n, 4 * h, w, c) * 3 + 1).to(dtype)
    gamma, beta = _randn(dev, c, seed=4), _randn(dev, c, seed=5)
    rows = (_randn(dev, n, c, seed=6).to(dtype), _randn(dev, 1, c, seed=7).to(dtype)) if film else None
    shards = [s.contiguous() for s in x.chunk(4, dim=1)]  # as the mesh holds them
    count = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = getattr(groupnorm_stats, count), getattr(groupnorm_apply, count)
    parts = torch.stack([groupnorm_stats(s, 8) for s in shards])
    want_parts = torch.stack([groupnorm_stats_plain(s, 8) for s in shards])
    scale = want_parts.abs().flatten(0, -2).amax(0)
    assert ((parts - want_parts).abs().flatten(0, -2).amax(0) <= 1e-5 * scale).all()
    outs = [groupnorm_apply(s, want_parts, gamma, beta, 8, 1e-5, act, rows) for s in shards]
    assert (getattr(groupnorm_stats, count), getattr(groupnorm_apply, count)) == (
        before[0] + 4, before[1] + 4)
    for s, got in zip(shards, outs):
        want = groupnorm_apply_plain(s, want_parts, gamma, beta, 8, 1e-5, act, rows)
        tol = 1e-4 if dtype == torch.float32 else 2 * 2.0 ** -7 * want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    whole = groupnorm_act_plain(x, gamma, beta, 8, 1e-5, act, rows)
    tol = 1e-4 if dtype == torch.float32 else 2 * 2.0 ** -7 * whole.float().abs().max().item()
    torch.testing.assert_close(torch.cat(outs, 1).float(), whole.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [None, 2.0])
@pytest.mark.parametrize("kernel", ["own", "split"])
def test_head_step_halo_mode_matches_plain_and_the_whole_map(dev, fp32_convs, dtype, w, kernel):
    """K1's halo mode on two height shards of the w=2 serving features (and
    without CFG): against its plain version, and the two shards' steps
    together the whole map's step; ``launches_halo`` counted.  The kernels
    of their own at 128 channels (fp32: the halo kernel; bf16: the bf16
    kernel's halo mode); the split launch ("split") where they refuse the
    width (6000 bf16 and 6400 fp32 channels on 8x8 maps, weights over the
    band kernels' shared memory, the whole map's launch split too),
    counted also under ``launches_halo_split``.
    fp32 within 1e-4 (1e-5 against the whole map); bf16 within four bf16
    ulps of eps times the step's ``c_eps * inv_sqrt_a`` (the guidance
    combine's roundings), as ``chip_smoke.py`` holds it, and with the bf16
    kernel's halo mode and the split launch in either type equal to the
    whole map's unsharded launch bit for bit (the same products summed in
    the same order, in ranges that depend on the channels alone)."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    bf16 = dtype == torch.bfloat16
    b, hw, c = (16, 64, 128) if kernel == "own" else (1, 8, 6000 if bf16 else 6400)
    h = _randn(dev, 2 * b if w else b, hw, hw, c).relu().to(dtype)
    weight = (_randn(dev, 1, c, 3, 3, seed=2) / (3 * c**0.5)).to(dtype)
    bias = _randn(dev, 1, seed=3).to(dtype)
    x, z = _randn(dev, b, hw, hw, 1, seed=4), _randn(dev, b, hw, hw, 1, seed=5)
    whole = fused_head_step(h, weight, bias, x, z, 0.3, 1.1, 0.2, w)
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    ulp = 2.0 ** (math.floor(math.log2(eps.abs().max().item())) - 7)
    tol, tol_whole = (4 * 0.33 * ulp,) * 2 if bf16 else (1e-4, 1e-5)
    half = hw // 2
    name = sampler_step.route(b, half, hw, c, dtype, cfg=w is not None, halo=True)[0]
    assert (name in sampler_step.SPLIT_NAMES.values()) == (kernel == "split")
    sfx = "_bf16" if bf16 else ""
    counts = (f"launches_halo{sfx}", f"launches_halo_split{sfx}")
    before = [getattr(fused_head_step, k) for k in counts]
    outs = []
    for top, sl, bottom in ((None, slice(0, half), h[:, half]),
                            (h[:, half - 1], slice(half, hw), None)):
        args = (h[:, sl].contiguous(), weight, bias, x[:, sl].contiguous(),
                z[:, sl].contiguous(), 0.3, 1.1, 0.2, w)
        got = fused_head_step(*args, halo=(top, bottom))
        torch.testing.assert_close(got, head_step_plain(*args, halo=(top, bottom)),
                                   atol=tol, rtol=0)
        outs.append(got)
    assert [getattr(fused_head_step, k) for k in counts] == [
        before[0] + 2, before[1] + (2 if kernel == "split" else 0)]
    diff = (torch.cat(outs, 1) - whole).abs().max().item()
    print(f"{dtype} {kernel} c {c} w {w}: two shards vs the whole map's launch: max abs "
          f"{diff:.3e}")
    assert diff <= (0.0 if bf16 or kernel == "split" else tol_whole)


@pytest.mark.parametrize("rows", [1, 2, 3, 8])
def test_head_step_halo_kernel_every_band(dev, fp32_convs, monkeypatch, rows):
    """The fp32 halo kernel at every band height (3 leaves a ragged band),
    under CFG and without, on 40 channels (the last 32-channel item half
    zero) and an odd width, with the rows above and below from the
    neighbouring shards: atol 1e-4."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    monkeypatch.setattr(sampler_step, "ROWS_HALO", (rows,))
    b, height, width, c = 3, 16, 21, 40
    weight, bias = _randn(dev, 1, c, 3, 3, seed=2) * 0.1, _randn(dev, 1, seed=3)
    for cfg in (True, False):
        n = 2 * b if cfg else b
        h = _randn(dev, n, height, width, c, seed=1).relu()
        halo = (_randn(dev, n, width, c, seed=6), _randn(dev, n, width, c, seed=7))
        x, z = _randn(dev, b, height, width, 1, seed=4), _randn(dev, b, height, width, 1, seed=5)
        args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, 2.0 if cfg else None)
        name, plan = sampler_step.route(b, height, width, c, torch.float32, cfg=cfg, halo=True)
        assert (name, plan.rows) == (sampler_step.HALO_NAMES[torch.float32], rows)
        torch.testing.assert_close(fused_head_step(*args, halo=halo),
                                   head_step_plain(*args, halo=halo), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cin,cout,b", [(256, 256, 4), (8, 16, 2), (1, 3, 2)])
def test_quantconv_on_the_card_equals_the_cpu_bit_for_bit(dev, cin, cout, b):
    """The int8 sums are exact on both (``_int_mm`` on the card, float64 on
    the CPU), and every division is a true one (a Python divisor would be
    a multiplication by its reciprocal on the card)."""
    conv = QuantConv(cin, cout)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=torch.Generator().manual_seed(1)))
        conv.bias.copy_(torch.randn(cout, generator=torch.Generator().manual_seed(2)))
        x = torch.randn((b, cin, 16, 16), generator=torch.Generator().manual_seed(3))
        want = conv(x)
        got = conv.to(dev)(x.to(dev)).cpu()
    assert torch.equal(got, want)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("act", ["relu", "gelu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape,misaligned", [((2, 5, 7, 24), False), ((4, 16, 16, 256), True)])
def test_groupnorm_kernel_scalar_path_with_film(dev, act, shape, misaligned):
    """Channels per group not a multiple of 4, or x at an offset of one
    float: the scalar instance of the kernel, with the epilogue: atol 1e-4."""
    n, c = shape[0], shape[-1]
    x = _randn(dev, *shape) * 3 + 1
    if misaligned:
        x = _misaligned(x)
    gamma, beta = _randn(dev, c, seed=4), _randn(dev, c, seed=5)
    rows = (_randn(dev, n, c, seed=6), _randn(dev, n, c, seed=7))
    got = fused_groupnorm_act(x, gamma, beta, 8, 1e-5, act, film=rows)
    torch.testing.assert_close(got, groupnorm_act_plain(x, gamma, beta, 8, 1e-5, act, film=rows),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("scale_rows,shift_rows", [(4, 1), (1, 4), (4, 4), (1, 1)])
@pytest.mark.parametrize("shape,misaligned", [((4, 32, 32, 128), False), ((4, 16, 16, 256), False),
                                              ((4, 5, 7, 6), False), ((4, 32, 32, 128), True)])
def test_film_kernel_matches_plain(dev, scale_rows, shift_rows, shape, misaligned):
    """The 16-byte path at the stage shapes; the scalar path for C % 4 != 0
    and for x at an offset of one float.  FMA contraction only: atol 1e-5."""
    c = shape[-1]
    x = _randn(dev, *shape)
    if misaligned:
        x = _misaligned(x)
    scale, shift = _randn(dev, scale_rows, c, seed=6), _randn(dev, shift_rows, c, seed=7)
    torch.testing.assert_close(fused_film(x, scale, shift), film_plain(x, scale, shift),
                               atol=1e-5, rtol=0)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _randn(dev, 2, 8, 8, 16)
    row = _randn(dev, 1, 16)
    with pytest.raises(ValueError, match="contiguous"):
        fused_film(x.transpose(1, 2), row, row)
    with pytest.raises(ValueError, match="float32"):
        fused_film(x.double(), row.double(), row.double())
    with pytest.raises(ValueError):
        fused_film(x, _randn(dev, 3, 16), row)
    with pytest.raises(ValueError, match="groups"):
        fused_groupnorm_act(_randn(dev, 2, 4, 4, 12), row[0, :12], row[0, :12])
    weight, bias = _randn(dev, 1, 16, 3, 3), _randn(dev, 1)
    x1 = _randn(dev, 2, 8, 8, 1)
    with pytest.raises(ValueError, match="samples"):
        fused_head_step(x, weight, bias, x1, x1, 0.1, 1.0, 0.1, 2.0)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_head_step(x, weight, bias, x1.cpu(), x1, 0.1, 1.0, 0.1)
    with pytest.raises(ValueError, match="x must be"):  # weights of 2 image channels, x of 1
        fused_head_step(x, _randn(dev, 2, 16, 3, 3), bias, x1, x1, 0.1, 1.0, 0.1)
    x0 = torch.empty(2, 8, 8, 0, device=dev)
    with pytest.raises(ValueError, match="one output channel"):
        fused_head_step(x, _randn(dev, 0, 16, 3, 3), torch.empty(0, device=dev), x0, x0, 0.1,
                        1.0, 0.1)
    with pytest.raises(ValueError, match="aligned"):
        fused_head_step(_misaligned(x), weight, bias, x1, x1, 0.1, 1.0, 0.1)


@pytest.mark.parametrize("guide_w", [0.0, 2.0])
def test_samplers_on_the_card_match_the_cpu(dev, guide_w, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu_model = ContextUnet(n_feat=8, n_cfeat=3, height=16).eval()
    gpu_model = ContextUnet(n_feat=8, n_cfeat=3, height=16).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model = gpu_model.to(dev, memory_format=torch.channels_last)
    x0 = torch.randn(2, 16, 16, 1)
    params = torch.rand(2, 3)
    zs = [torch.randn(2, 16, 16, 1) for _ in range(8)]
    for fn, kw in ((sample_ddpm, {}), (sample_ddim, {"n_steps": 4, "sigma_mode": "beta"})):
        outs = [fn(m, make_schedule(8), torch.Generator(device=d), params=params,
                   guide_w=guide_w, x_init=x0, device=d, z_fn=lambda k, t: zs[k], **kw)
                for m, d in ((cpu_model, "cpu"), (gpu_model, dev))]
        torch.testing.assert_close(outs[1].cpu(), outs[0], atol=1e-4, rtol=0)


def _twin_models(dev):
    """The same narrow model on the CPU and on the card, eval mode."""
    cpu_model = ContextUnet(n_feat=8, n_cfeat=3, height=16).eval()
    gpu_model = ContextUnet(n_feat=8, n_cfeat=3, height=16).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cpu_model, gpu_model.to(dev, memory_format=torch.channels_last)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_posterior_sampler_on_the_card_matches_the_cpu(dev, eta, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    models = _twin_models(dev)
    x0, params = torch.randn(2, 16, 16, 1), torch.rand(2, 3)
    zs = [torch.randn(2, 16, 16, 1) for _ in range(8)]
    outs = [sample_ddim(m, make_schedule(8), torch.Generator(device=d), params=params,
                        guide_w=2.0, x_init=x0, device=d, n_steps=4, eta=eta,
                        z_fn=lambda k, t: zs[k])
            for m, d in zip(models, ("cpu", dev))]
    torch.testing.assert_close(outs[1].cpu(), outs[0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_posterior_coefficients_through_the_head_step_kernel(dev, fp32_convs, eta):
    """Every row of the posterior table of a T=1500, 50-step schedule
    through K1 at the w=2 path shape, against its plain step: atol 1e-4."""
    h = _randn(dev, 32, 64, 64, 128, seed=1).relu()
    weight = _randn(dev, 1, 128, 3, 3, seed=2).mul(0.05)
    bias = _randn(dev, 1, seed=3)
    x, z = _randn(dev, 16, 64, 64, 1, seed=4), _randn(dev, 16, 64, 64, 1, seed=5)
    coefs = posterior_coefficients(make_schedule(1500), ddim_timesteps(1500, 50), eta)
    for c_eps, inv_sqrt_a, sigma in coefs.tolist():
        args = (h, weight, bias, x, z if sigma else None, c_eps, inv_sqrt_a, sigma, 2.0)
        torch.testing.assert_close(fused_head_step(*args), head_step_plain(*args),
                                   atol=1e-4, rtol=0)


def test_elbo_batch_on_the_card_matches_the_cpu(dev):
    """The same noise on both devices; the card runs K2 and K3 in every
    forward and no K1: rel 1e-4."""
    models = _twin_models(dev)
    x, c = torch.randn(3, 16, 16, 1), torch.rand(3, 3)
    noise = [torch.randn(3, 16, 16, 1) for _ in range(10)]
    before = (fused_head_step.launches, fused_groupnorm_act.launches, fused_film.launches)
    outs = [likelihood.elbo_bpd_batch(m, make_schedule(1500), x, c, device=d,
                                      noise_fn=lambda bi, k, t, s: noise[k])
            for m, d in zip(models, ("cpu", dev))]
    after = (fused_head_step.launches, fused_groupnorm_act.launches, fused_film.launches)
    assert [b - a for a, b in zip(before, after)] == [0, 20, 10]
    rel = ((outs[1].cpu() - outs[0]).abs().max() / outs[0].abs().max()).item()
    assert rel <= 1e-4


def test_kernel_path_refuses_a_forward_that_needs_gradients(dev):
    """With grad enabled, the model's kernel path (``train=False``) raises
    instead of returning a tensor cut from the graph; without grad it runs
    the kernels, and ``train=True`` gives every parameter a gradient."""
    model = ContextUnet(n_feat=8, n_cfeat=3, height=16).to(dev)
    x, t, c = (torch.randn(2, 16, 16, 1, device=dev), torch.rand(2, device=dev),
               torch.rand(2, 3, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        model(x, t, c)
    before = fused_groupnorm_act.launches
    with torch.no_grad():
        model(x, t, c)
    assert fused_groupnorm_act.launches == before + 2
    model(x, t, c, train=True).square().mean().backward()
    assert fused_groupnorm_act.launches == before + 2
    assert all(p.grad is not None for p in model.parameters())


def test_train_step_on_the_card_matches_the_cpu(dev, fp32_convs):
    """One step (injected t and noise, 2 masked pad rows) on the card and
    the CPU from the same weights: loss rel 1e-5, the gradients together
    rel 1e-4 in L2, running statistics 1e-5; no kernel launches."""
    cpu_model = ContextUnet(n_feat=8, n_cfeat=3, height=16)
    gpu_model = ContextUnet(n_feat=8, n_cfeat=3, height=16)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev)
    x, c = torch.rand(8, 16, 16, 1), torch.rand(8, 3)
    mask = (torch.arange(8) < 6).float()
    t, noise = torch.randint(1, 9, (8,)), torch.randn(8, 16, 16, 1)
    before = (fused_head_step.launches, fused_groupnorm_act.launches, fused_film.launches)
    losses = []
    for model in (cpu_model, gpu_model):
        state = trainer.create_train_state(model, 1e-3, 4, 2)
        m = trainer.make_train_step(model, 8)(state, x, c, mask, t=t, noise=noise)
        losses.append(float(m["loss"]))
    assert (fused_head_step.launches, fused_groupnorm_act.launches,
            fused_film.launches) == before
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    g_cpu = torch.cat([p.grad.flatten() for p in cpu_model.parameters()])
    g_gpu = torch.cat([p.grad.flatten().cpu() for p in gpu_model.parameters()])
    assert ((g_gpu - g_cpu).norm() / g_cpu.norm()).item() <= 1e-4
    for (name, a), b in zip(cpu_model.named_buffers(), gpu_model.buffers()):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5, msg=name)


# ---- the deep and big variants' shapes --------------------------------------

@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("c", [128, 256])
def test_head_step_kernel_at_the_variant_shapes(dev, fp32_convs, c, w, tanh):
    """K1 on (10 or 20, 128, 128, C) features, C = 128 (deep) and 256
    (big), with the tanh of their output layer per branch: atol 1e-4, as
    at the canonical shapes."""
    b, cfg = 10, w is not None
    h = _randn(dev, 2 * b if cfg else b, 128, 128, c, seed=11).relu()
    weight = _randn(dev, 1, c, 3, 3, seed=12).mul(0.05)
    bias = _randn(dev, 1, seed=13)
    x, z = _randn(dev, b, 128, 128, 1, seed=14), _randn(dev, b, 128, 128, 1, seed=15)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)
    torch.testing.assert_close(fused_head_step(*args, tanh=tanh),
                               head_step_plain(*args, tanh=tanh), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [10, 32])
@pytest.mark.parametrize("shape,act,film", [
    ((128, 128, 128), "leaky_relu", False), ((128, 128, 256), "gelu", False),
    ((16, 16, 512), "leaky_relu", True), ((16, 16, 1024), "gelu", True)])
def test_groupnorm_kernel_at_the_variant_shapes(dev, n, shape, act, film):
    """K2 at the deep and big models' out_norm and up0_norm (with its FiLM
    epilogue); the out_norm takes the large-slice kernel: atol 1e-4."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    x = _randn(dev, n, *shape, seed=21).mul(3).add(1)
    c = shape[-1]
    gamma, beta = _randn(dev, c, seed=22), _randn(dev, c, seed=23)
    rows = (_randn(dev, n, c, seed=24), _randn(dev, 1, c, seed=25)) if film else None
    name = groupnorm.single_route(n, shape[0] * shape[1], c, 8, torch.float32)[0]
    assert (name == groupnorm.LARGE_NAME) == (shape[0] == 128)
    args = (x, gamma, beta, 8, 1e-5, act, rows)
    torch.testing.assert_close(fused_groupnorm_act(*args), groupnorm_act_plain(*args),
                               atol=1e-4, rtol=0)


LARGE_SHAPES = {f"{v} out_norm, {n} maps": (n, 128, c, act)
                for v, c, act in (("deep", 128, "leaky_relu"), ("big", 256, "gelu"))
                for n in (10, 32)}


@pytest.mark.parametrize("shape", list(LARGE_SHAPES))
def test_groupnorm_large_kernel_at_the_variant_out_norm(dev, shape):
    """K2's large-slice kernel at the deep and big out_norm, 10 and 32
    maps: within 1e-4 of its plain version (phase (c)'s fp32 K2 gate), one
    launch counted under ``launches`` and ``launches_large``, and two runs
    bit-identical (a fixed merge order, no atomics)."""
    n, hw, c, act = LARGE_SHAPES[shape]
    x = _randn(dev, n, hw, hw, c, seed=41).mul(3).add(1)
    args = (x, _randn(dev, c, seed=42), _randn(dev, c, seed=43), 8, 1e-5, act)
    before = (fused_groupnorm_act.launches, fused_groupnorm_act.launches_large)
    got = fused_groupnorm_act(*args)
    assert (fused_groupnorm_act.launches, fused_groupnorm_act.launches_large) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, groupnorm_act_plain(*args), atol=1e-4, rtol=0)
    assert torch.equal(got, fused_groupnorm_act(*args))


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "leaky_relu"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 128, 128), (2, 128, 128, 64), (4, 64, 64, 320),
                                   (2, 64, 64, 256)])
def test_groupnorm_large_kernel_every_argument(dev, shape, film, act):
    """Every activation and the FiLM epilogue (scale a row per sample,
    shift one row) at the shapes the route gives the large-slice kernel:
    the deep out_norm, n_feat 64 at 128x128, n_feat 320 (10 packs a group,
    256 threads: 6 lanes idle) and 256 at 64x64: atol 1e-4."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    n, h, w, c = shape
    assert groupnorm.single_route(n, h * w, c, 8, torch.float32)[0] == groupnorm.LARGE_NAME
    x = _randn(dev, *shape, seed=44).mul(3).add(1)
    rows = (_randn(dev, n, c, seed=45), _randn(dev, 1, c, seed=46)) if film else None
    args = (x, _randn(dev, c, seed=47), _randn(dev, c, seed=48), 8, 1e-5, act, rows)
    torch.testing.assert_close(fused_groupnorm_act(*args), groupnorm_act_plain(*args),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,budget_boxes", [((2, 10, 15, 64), 1), ((2, 5, 8, 64), None),
                                                ((3, 10, 15, 32), 2), ((2, 128, 128, 128), 6)])
def test_groupnorm_large_kernel_forced_small_plans(dev, monkeypatch, shape, budget_boxes):
    """Plans forced as ``tests/test_torch_port_variant_kernels.py`` forces
    them: boxes of 8 pixels within a budget of ``budget_boxes`` (the rest in
    registers, a last rank shorter), parts shorter than a box (its threads
    store the box past the part's end), and the deep out_norm at 6 boxes of
    256 pixels, one CTA an SM, every register pack a thread used: atol 1e-4,
    bit-identical reruns."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    n, h, w, c = shape
    if budget_boxes is not None and h * w < 1024:
        monkeypatch.setattr(groupnorm, "LARGE_BOX_PX", 8)
        overhead = 1024 + groupnorm.LARGE_STATIC + 128
        monkeypatch.setattr(groupnorm, "SM_SMEM", 2 * (budget_boxes * 8 * (c // 8) * 4
                                                       + overhead))
    plan = groupnorm.large_plan(n, h * w, c, 8)
    if h * w >= 1024:  # one CTA an SM, 6 boxes: 512 pixels of each part in registers
        plan = plan._replace(boxes=budget_boxes, per_sm=1,
                             smem_bytes=128 + budget_boxes * plan.box_px * c // 8 * 4)
    x = _randn(dev, *shape, seed=49).mul(3).add(1)
    args = (x, _randn(dev, c, seed=50), _randn(dev, c, seed=51), 8, 1e-5, "relu")
    monkeypatch.setattr(groupnorm, "single_route",
                        lambda *a, **k: (groupnorm.LARGE_NAME, plan))
    got = fused_groupnorm_act(*args)
    torch.testing.assert_close(got, groupnorm_act_plain(*args), atol=1e-4, rtol=0)
    assert torch.equal(got, fused_groupnorm_act(*args))


@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("c", [128, 256])
def test_head_step_band_kernel_at_the_variant_shapes(dev, fp32_convs, c, w):
    """K1's band kernel at the deep and big steps (10 maps of 128x128, 20
    under CFG) with tanh, where the route gives it them (all but the big
    step without CFG, which keeps the template): within 1e-4 of
    ``head_step_plain`` (phase (c)'s fp32 K1 gate), counted under
    ``launches`` and ``launches_band``."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    b, cfg = 10, w is not None
    band = sampler_step.route(b, 128, 128, c, torch.float32, cfg=cfg)[0] == (
        sampler_step.F32_BAND_NAME)
    assert band == (cfg or c == 128)
    h = _randn(dev, 2 * b if cfg else b, 128, 128, c, seed=52)
    weight = _randn(dev, 1, c, 3, 3, seed=53).mul(1 / (3 * c**0.5))
    x, z = _randn(dev, b, 128, 128, 1, seed=54), _randn(dev, b, 128, 128, 1, seed=55)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, _randn(dev, 1, seed=56), x, z, 0.02, 1.01, 0.3, w, True)
    before = (fused_head_step.launches, fused_head_step.launches_band)
    got = fused_head_step(*args)
    assert (fused_head_step.launches, fused_head_step.launches_band) == (
        before[0] + 1, before[1] + band)
    torch.testing.assert_close(got, head_step_plain(*args), atol=1e-4, rtol=0)


@pytest.mark.parametrize("rows", [8, 4, 2, 1, 3])
@pytest.mark.parametrize("shape,w", [((3, 12, 12, 40), 2.0), ((2, 16, 18, 36), None),
                                     ((2, 9, 131, 128), None), ((2, 5, 128, 256), 2.0)])
def test_head_step_band_kernel_every_band(dev, fp32_convs, monkeypatch, rows, shape, w):
    """The band kernel at every band height (3 leaves a ragged band), on
    maps narrower than ``BAND_WIDTH`` (forced through it), an odd width
    without CFG and a map shorter than a band: atol 1e-4."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    monkeypatch.setattr(sampler_step, "BAND_ROWS", {True: rows, False: rows})
    monkeypatch.setattr(sampler_step, "BAND_WIDTH", 1)
    b, hh, ww, c = shape
    cfg = w is not None
    assert sampler_step.route(b, hh, ww, c, torch.float32, cfg=cfg)[0] == (
        sampler_step.F32_BAND_NAME)
    h = _randn(dev, 2 * b if cfg else b, hh, ww, c, seed=57).relu()
    weight, bias = _randn(dev, 1, c, 3, 3, seed=58) * 0.1, _randn(dev, 1, seed=59)
    x, z = _randn(dev, b, hh, ww, 1, seed=60), _randn(dev, b, hh, ww, 1, seed=61)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w, True)
    torch.testing.assert_close(fused_head_step(*args), head_step_plain(*args), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("variant", ["deep", "big"])
def test_variant_sampler_steps_at_full_width_take_the_new_kernels(dev, fp32_convs, variant):
    """A deep and a big model at full width (n_feat 128 and 256, 128x128):
    two exact-chain steps on one map on the card against the CPU, atol 1e-4
    (cuDNN's fp32 convs reorder some thirty sums); each step launches K2's
    large-slice kernel once (out_norm), and the deep step K1's band kernel
    once (the big step without CFG keeps the template)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cpu_model = getattr(ContextUnet, variant)().eval()
    gpu_model = getattr(ContextUnet, variant)().eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model = gpu_model.to(dev, memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 128, 128, 1, generator=g)
    c = torch.rand(1, cpu_model.n_cfeat, generator=g)
    zs = [torch.randn(1, 128, 128, 1, generator=g) for _ in range(2)]
    counts = (fused_groupnorm_act.launches_large, fused_head_step.launches_band,
              fused_head_step.launches)
    outs = [sample_ddpm(m, make_schedule(2), torch.Generator(device=d), params=c.numpy(),
                        x_init=x.numpy(), device=d, z_fn=lambda k, t: zs[k]).cpu()
            for m, d in ((gpu_model, dev), (cpu_model, "cpu"))]
    assert (fused_groupnorm_act.launches_large - counts[0],
            fused_head_step.launches_band - counts[1],
            fused_head_step.launches - counts[2]) == (2, 2 if variant == "deep" else 0, 2)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [10, 32])
@pytest.mark.parametrize("c", [256, 512])
def test_film_kernel_at_the_variant_shapes(dev, n, c):
    x = _randn(dev, n, 32, 32, c, seed=31)
    scale, shift = _randn(dev, n, c, seed=32), _randn(dev, 1, c, seed=33)
    torch.testing.assert_close(fused_film(x, scale, shift), film_plain(x, scale, shift),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["deep", "big"])
def test_variant_forward_and_sampler_steps_on_the_card_match_the_cpu(dev, fp32_convs,
                                                                     variant):
    """A narrow deep / big model (n_feat 16, 32x32): the forward and three
    exact-chain steps under injected z on the card against the CPU, atol
    1e-5; each step launches K1 once, K2 twice and K3 once."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cpu_model = getattr(ContextUnet, variant)(n_feat=16, height=32).eval()
    gpu_model = getattr(ContextUnet, variant)(n_feat=16, height=32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model = gpu_model.to(dev, memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 1, generator=g)
    t = torch.rand(2, generator=g)
    c = torch.rand(2, cpu_model.n_cfeat, generator=g)
    with torch.inference_mode():
        want = cpu_model(x, t, c)
        got = gpu_model(x.to(dev), t.to(dev), c.to(dev)).cpu()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    zs = [torch.randn(2, 32, 32, 1, generator=g) for _ in range(3)]
    counts = (fused_head_step.launches, fused_groupnorm_act.launches, fused_film.launches)
    outs = [sample_ddpm(m, make_schedule(3), torch.Generator(device=d), params=c.numpy(),
                        x_init=x.numpy(), device=d, z_fn=lambda k, t: zs[k]).cpu()
            for m, d in ((gpu_model, dev), (cpu_model, "cpu"))]
    assert (fused_head_step.launches - counts[0], fused_groupnorm_act.launches - counts[1],
            fused_film.launches - counts[2]) == (3, 6, 3)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)


# ---- the bf16 instances ------------------------------------------------------

def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 values at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(v, 2.0**-126))) - 7)


def _assert_bf16_close(got, want, atol, share=1e-2, fp32_rounding=0.0):
    """Within ``atol`` everywhere, and within ``fp32_rounding`` on all but
    ``share`` of the elements: the kernel and its plain version round to
    bf16 at the same points, so they differ by more than fp32 rounding only
    where an fp32 sum taken in another order lands on the other side of a
    bf16 rounding boundary."""
    assert got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= atol, (d.max().item(), atol)
    assert (d > fp32_rounding).float().mean().item() <= share


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("b,hw,c", [(16, 64, 128), (4, 64, 128), (10, 128, 128), (10, 128, 256)])
def test_head_step_bf16_kernel_at_the_path_shapes(dev, fp32_convs, b, hw, c, w, tanh):
    """K1's bf16 instance (bf16 features, weights and bias; fp32 x, z and
    step) against its plain version: eps rounds to bf16 per branch, so a
    sum on the other side of a rounding boundary moves x' by ``c_eps /
    sqrt(a)`` times a bf16 ulp of eps, and the CFG combine's three roundings
    by up to four: atol 4 ulp of max |eps| times 0.02 * 1.01.  The fp32
    step itself differs by its FMAs (1e-5, as the fp32 instance's)."""
    cfg = w is not None
    h = _randn(dev, 2 * b if cfg else b, hw, hw, c, seed=41).relu().bfloat16()
    weight = _randn(dev, 1, c, 3, 3, seed=42).mul(0.05).bfloat16()
    bias = _randn(dev, 1, seed=43).bfloat16()
    x, z = _randn(dev, b, hw, hw, 1, seed=44), _randn(dev, b, hw, hw, 1, seed=45)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)
    before = (fused_head_step.launches, fused_head_step.launches_bf16)
    got = fused_head_step(*args, tanh=tanh)
    assert (fused_head_step.launches, fused_head_step.launches_bf16) == (before[0], before[1] + 1)
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    eps = guided_eps(eps.bfloat16(), w, tanh).float()
    _assert_bf16_close(got, head_step_plain(*args, tanh=tanh),
                       4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()), fp32_rounding=1e-5)


@pytest.mark.parametrize("act", ["relu", "gelu", "leaky_relu"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("shape", [(32, 16, 16, 256), (32, 64, 64, 128), (4, 64, 64, 128),
                                   (10, 16, 16, 1024), (10, 128, 128, 256), (2, 5, 7, 24)])
def test_groupnorm_bf16_kernel_matches_plain(dev, shape, film, act):
    """K2's bf16 instance (bf16 I/O, fp32 statistics, affine and activation,
    one rounding; the FiLM epilogue in bf16) against its plain version at
    the heads' shapes, the big out_norm (1 MiB a group in bf16: resident,
    no spill), and a shape the bf16 kernel's plan refuses (3 channels a
    group: the narrow bf16 kernel, counted under both ``.launches_bf16``
    and ``.launches_narrow_bf16``, and no launch of the float kernel's
    instance).  The statistics sum in another order: an output may round
    to the neighbouring bf16 value, and the epilogue's two roundings may
    carry that on: atol 2 ulp of max |out|."""
    n, c = shape[0], shape[-1]
    x = (_randn(dev, *shape, seed=51) * 3 + 1).bfloat16()
    gamma, beta = _randn(dev, c, seed=52), _randn(dev, c, seed=53)
    rows = ((_randn(dev, n, c, seed=54).bfloat16(), _randn(dev, 1, c, seed=55).bfloat16())
            if film else None)
    args = (x, gamma, beta, 8, 1e-5, act, rows)
    narrow = c // 8 % 8 != 0  # the bf16 kernel's plan refuses 3 channels a group
    if narrow:
        with pytest.raises(ValueError, match="multiple of 8"):
            bf16_plan(n, shape[1] * shape[2], c, 8)
        narrow_plan(n, shape[1] * shape[2], c, 8)
    else:
        bf16_plan(n, shape[1] * shape[2], c, 8)  # every part held in shared memory
    counts = ("launches", "launches_bf16", "launches_narrow_bf16", "launches_generic_bf16")
    before = [getattr(fused_groupnorm_act, k) for k in counts]
    got = fused_groupnorm_act(*args)
    assert [getattr(fused_groupnorm_act, k) for k in counts] == [
        before[0], before[1] + 1, before[2] + narrow, before[3]]
    want = groupnorm_act_plain(*args)
    _assert_bf16_close(got, want, 2 * _bf16_ulp(want.float().abs().max().item()))


@pytest.mark.parametrize("scale_rows", [1, 32])
@pytest.mark.parametrize("shape", [(32, 32, 32, 128), (10, 32, 32, 512), (4, 5, 7, 6)])
def test_film_bf16_kernel_matches_plain_exactly(dev, shape, scale_rows):
    """K3's bf16 instance rounds the product and then the sum to bf16, as
    its plain version does, from the same fp32 operations: equal."""
    n, c = shape[0], shape[-1]
    x = _randn(dev, *shape, seed=61).bfloat16()
    scale = _randn(dev, min(scale_rows, n), c, seed=62).bfloat16()
    shift = _randn(dev, 1, c, seed=63).bfloat16()
    before = (fused_film.launches, fused_film.launches_bf16)
    got = fused_film(x, scale, shift)
    assert (fused_film.launches, fused_film.launches_bf16) == (before[0], before[1] + 1)
    assert torch.equal(got, film_plain(x, scale, shift))


def test_wrappers_refuse_dtypes_without_a_kernel(dev):
    """fp16, or a bf16 x with fp32 rows, raises on the card."""
    x = _randn(dev, 2, 8, 8, 16)
    row = _randn(dev, 1, 16)
    with pytest.raises(ValueError, match="no kernel"):
        fused_film(x.half(), row.half(), row.half())
    with pytest.raises(ValueError, match="bfloat16"):
        fused_film(x.bfloat16(), row, row)
    with pytest.raises(ValueError, match="no kernel"):
        fused_groupnorm_act(x.half(), row[0], row[0])
    with pytest.raises(ValueError, match="float32"):
        fused_groupnorm_act(x.bfloat16(), row[0].bfloat16(), row[0].bfloat16())
    x1 = _randn(dev, 2, 8, 8, 1)
    weight, bias = _randn(dev, 1, 16, 3, 3), _randn(dev, 1)
    with pytest.raises(ValueError, match="no kernel"):
        fused_head_step(x.half(), weight.half(), bias.half(), x1, x1, 0.1, 1.0, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_head_step(x.bfloat16(), weight, bias, x1, x1, 0.1, 1.0, 0.1)


@pytest.mark.parametrize("variant", ["canonical", "deep", "big"])
def test_bf16_model_on_the_card_matches_the_cpu(dev, fp32_convs, variant):
    """A narrow bf16 model (n_feat 64, 32x32: the narrowest whose heads the
    bf16 kernels take, 8 channels a group at out_norm and 64 channels at
    out_conv2; see the next test for n_feat 32), folded: its forward and three
    exact-chain steps under injected z on the card against the CPU's bf16,
    within twice the CPU's own distance from its fp32 model (bf16 rounds
    where cuDNN's and the CPU's sums fall on either side of a boundary);
    each step launches the bf16 instances of K1 once, K2 twice and K3
    once, and no fp32 instance."""
    from camels_diffusion_model_tpu_torch.serving import load_model
    from camels_diffusion_model_tpu_torch.utils.weights import to_jax_variables

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        variables = to_jax_variables(
            getattr(ContextUnet, variant)(n_feat=64, height=32).state_dict())
    cpu32, cpu16 = (load_model(variables, "cpu", dtype=d)
                    for d in (torch.float32, torch.bfloat16))
    gpu16 = load_model(variables, dev, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 1, generator=g)
    t = torch.rand(2, generator=g)
    c = torch.rand(2, cpu16.n_cfeat, generator=g)
    with torch.inference_mode():
        want32, want = cpu32(x, t, c), cpu16(x, t, c)
        got = gpu16(x.to(dev), t.to(dev), c.to(dev)).cpu()
    assert got.dtype == want.dtype == torch.bfloat16
    yard = (want.float() - want32).abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2 * yard
    zs = [torch.randn(2, 32, 32, 1, generator=g) for _ in range(3)]
    kernels = (fused_head_step, fused_groupnorm_act, fused_film)
    counts = [(k.launches, k.launches_bf16) for k in kernels]
    outs = [sample_ddpm(m, make_schedule(3), torch.Generator(device=d), params=c.numpy(),
                        x_init=x.numpy(), guide_w=2.0, device=d,
                        z_fn=lambda k, t: zs[k]).cpu()
            for m, d in ((gpu16, dev), (cpu16, "cpu"), (cpu32, "cpu"))]
    assert [(k.launches - a, k.launches_bf16 - b) for k, (a, b) in zip(kernels, counts)] == [
        (0, 3), (0, 6), (0, 3)]
    assert all(o.dtype == torch.float32 for o in outs)
    yard = (outs[1] - outs[2]).abs().max().item()
    assert (outs[0] - outs[1]).abs().max().item() <= 2 * yard


@pytest.mark.parametrize("n_feat", [32, 96, 128, 256, 40, 264])
def test_bf16_narrow_model_on_the_card_runs_through_the_kernels(dev, fp32_convs, n_feat):
    """A canonical bf16 model at n_feat 32 and 96 (32x32, folded):
    out_norm's 4 and 12 channels a group take the narrow bf16 GroupNorm
    kernel, out_conv2's 32 and 96 channels the bf16 step kernel's narrow
    item; at n_feat 40 both heads (5 and 10 channels a group) the narrow
    kernel and out_conv2 the narrow item with a masked last block; at 264
    both heads (33 and 66 channels a group, units of 264) the narrow
    kernel's wide layout and out_conv2 the masked narrow item; its forward
    and four strided w=2 steps under injected z on the
    card against the CPU's bf16, within phase (o)'s yardstick
    (``BF16_FACTOR`` x the CPU's bf16 distance from its fp32), each launch
    counted under ``.launches_bf16``, the narrow ones also under
    ``.launches_narrow_bf16`` (the wide and masked ones also under
    ``.launches_wide_bf16`` and ``.launches_masked_bf16``), and none of
    the float kernels' bf16 instances (``.launches_generic_bf16``) or the
    split K1 and pair K2 launches (``.launches_split_bf16``,
    ``.launches_pair_bf16``).  At
    n_feat 128 and 256 the bf16 kernels take every shape at their wide
    items: no narrow launch (256: the forward only, the CPU's bf16 is
    slow)."""
    from camels_diffusion_model_tpu_torch.serving import load_model
    from camels_diffusion_model_tpu_torch.utils.weights import to_jax_variables

    bf16_factor = 2.0  # chip_smoke.BF16_FACTOR
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        variables = to_jax_variables(ContextUnet.canonical(n_feat=n_feat, height=32).state_dict())
    cpu32, cpu16 = (load_model(variables, "cpu", dtype=d)
                    for d in (torch.float32, torch.bfloat16))
    gpu16 = load_model(variables, dev, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 1, generator=g)
    t = torch.rand(2, generator=g)
    c = torch.rand(2, cpu16.n_cfeat, generator=g)
    kernels = (fused_head_step, fused_groupnorm_act, fused_film)
    counts = ("launches", "launches_bf16", "launches_narrow_bf16", "launches_generic_bf16",
              "launches_masked_bf16", "launches_wide_bf16", "launches_split_bf16",
              "launches_pair_bf16")

    def launched():
        return [tuple(getattr(k, n, 0) for n in counts) for k in kernels]

    # K2's narrow launches a decoder call (up0_norm, out_norm), its wide
    # ones, and whether K1 takes the narrow item, masked.
    k2_narrow = {32: 1, 96: 1, 40: 2, 264: 2}.get(n_feat, 0)
    k2_wide = 2 if n_feat == 264 else 0
    k1_narrow, k1_masked = n_feat % 64 != 0, n_feat % 32 != 0
    before = launched()
    with torch.inference_mode():
        got = gpu16(x.to(dev), t.to(dev), c.to(dev)).cpu()
        want32, want = cpu32(x, t, c), cpu16(x, t, c)
    assert [tuple(a - b for a, b in zip(n, o)) for n, o in zip(launched(), before)] == [
        (0, 0, 0, 0, 0, 0, 0, 0), (0, 2, k2_narrow, 0, 0, k2_wide, 0, 0),
        (0, 1, 0, 0, 0, 0, 0, 0)]
    assert got.dtype == want.dtype == torch.bfloat16
    yard = (want.float() - want32).abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bf16_factor * yard
    if n_feat == 256:
        return
    taus = np.asarray([1, 4, 7, 10])
    zs = [torch.randn(2, 32, 32, 1, generator=g) for _ in taus]
    before = launched()
    outs = [sample_ddim(m, make_schedule(1500), torch.Generator(device=d), params=c.numpy(),
                        guide_w=2.0, x_init=x.numpy(), taus=taus, sigma_mode="beta", device=d,
                        z_fn=lambda k, t: zs[k]).cpu()
            for m, d in ((gpu16, dev), (cpu16, "cpu"), (cpu32, "cpu"))]
    assert [tuple(a - b for a, b in zip(n, o)) for n, o in zip(launched(), before)] == [
        (0, 4, 4 * k1_narrow, 0, 4 * k1_masked, 0, 0, 0),
        (0, 8, 4 * k2_narrow, 0, 0, 4 * k2_wide, 0, 0), (0, 4, 0, 0, 0, 0, 0, 0)]
    yard = (outs[1] - outs[2]).abs().max().item()
    assert (outs[0] - outs[1]).abs().max().item() <= bf16_factor * yard


@pytest.mark.parametrize("rows", [8, 4, 2, 1])
@pytest.mark.parametrize("shape,w,tanh", [((3, 64, 64, 128), 2.0, False),
                                          ((3, 64, 64, 128), None, False),
                                          ((2, 12, 12, 64), "per-sample", True),
                                          ((2, 16, 16, 192), None, True)])
def test_head_step_bf16_kernel_every_band(dev, fp32_convs, monkeypatch, rows, shape, w, tanh):
    """The bf16 K1 at every band height of ``ROWS_BF16`` (ragged last bands
    at height 12), under CFG and without, 64-channel stages 1 to 3 a pixel
    block:
    phase (c)'s gate, 4 bf16 ulps of eps times c_eps / sqrt(a), the step's
    fp32 FMAs on all but 1% of the pixels."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    monkeypatch.setattr(sampler_step, "ROWS_BF16", (rows,))
    b, hw, _, c = shape
    cfg = w is not None
    h = _randn(dev, 2 * b if cfg else b, hw, hw, c, seed=71).relu().bfloat16()
    weight = _randn(dev, 1, c, 3, 3, seed=72).mul(0.05).bfloat16()
    bias = _randn(dev, 1, seed=73).bfloat16()
    x, z = _randn(dev, b, hw, hw, 1, seed=74), _randn(dev, b, hw, hw, 1, seed=75)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)
    assert sampler_step.bf16_plan(b, hw, hw, c, cfg=cfg).rows == rows
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    eps = guided_eps(eps.bfloat16(), w, tanh).float()
    _assert_bf16_close(fused_head_step(*args, tanh=tanh), head_step_plain(*args, tanh=tanh),
                       4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()), fp32_rounding=1e-5)


@pytest.mark.parametrize("line,spread", [(16, 1), (64, 256), (128, 64), (256, 1)])
@pytest.mark.parametrize("shape,film", [((32, 16, 16, 256), True), ((32, 64, 64, 128), False),
                                        ((4, 64, 64, 128), False), ((3, 7, 7, 64), True),
                                        ((10, 16, 16, 1024), True), ((32, 64, 64, 192), False),
                                        ((4, 64, 64, 192), False), ((32, 16, 16, 384), True)])
def test_groupnorm_bf16_kernel_every_plan(dev, monkeypatch, line, spread, shape, film):
    """The bf16 K2 at units of 1 to 8 groups (``BF16_LINE``) and grids of 1
    to 256 CTAs (``BF16_SPREAD``: clusters of 1 to 8, one to 16 packs a
    thread, ragged parts at 7x7), and n_feat 192's heads (24 and 48
    channels a group: units of one group, threads a multiple of 3 packs),
    against its plain version: phase (c)'s gate, 2 bf16 ulps and at most
    1% of the elements differing."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    monkeypatch.setattr(groupnorm, "BF16_LINE", line)
    monkeypatch.setattr(groupnorm, "BF16_SPREAD", spread)
    n, c = shape[0], shape[-1]
    x = (_randn(dev, *shape, seed=81) * 3 + 1).bfloat16()
    gamma, beta = _randn(dev, c, seed=82), _randn(dev, c, seed=83)
    rows = ((_randn(dev, n, c, seed=84).bfloat16(), _randn(dev, 1, c, seed=85).bfloat16())
            if film else None)
    want = groupnorm_act_plain(x, gamma, beta, 8, 1e-5, "gelu", rows)
    _assert_bf16_close(fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "gelu", rows), want,
                       2 * _bf16_ulp(want.float().abs().max().item()))


# ---- the narrow bf16 kernels: K2 where groups are not whole packs, K1 at
# ---- 32-channel items (n_feat 32, 96 and 160) ------------------------------

NARROW_FEATS = (32, 96, 160)


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "leaky_relu"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("n", [4, 32])
@pytest.mark.parametrize("n_feat", NARROW_FEATS)
def test_groupnorm_bf16_narrow_kernel_matches_plain(dev, n_feat, n, film, act):
    """The narrow bf16 K2 at the out_norm of n_feat 32, 96 and 160 (4, 12
    and 20 channels a group: packs straddle groups; 4, 6 and 5 packs a
    unit's pixel) at 2 and 16 maps under CFG, every activation, with and
    without the FiLM epilogue, against its plain version: 2 bf16 ulps of
    max |out| (phase (c)'s gate), at most 1% of the elements differing;
    counted under ``.launches_bf16`` and ``.launches_narrow_bf16``."""
    x = (_randn(dev, n, 64, 64, n_feat, seed=91) * 3 + 1).bfloat16()
    gamma, beta = _randn(dev, n_feat, seed=92), _randn(dev, n_feat, seed=93)
    rows = ((_randn(dev, n, n_feat, seed=94).bfloat16(),
             _randn(dev, 1, n_feat, seed=95).bfloat16()) if film else None)
    args = (x, gamma, beta, 8, 1e-5, act, rows)
    counts = ("launches_bf16", "launches_narrow_bf16", "launches_generic_bf16")
    before = [getattr(fused_groupnorm_act, k) for k in counts]
    got = fused_groupnorm_act(*args)
    assert [getattr(fused_groupnorm_act, k) - b for k, b in zip(counts, before)] == [1, 1, 0]
    want = groupnorm_act_plain(*args)
    _assert_bf16_close(got, want, 2 * _bf16_ulp(want.float().abs().max().item()))


@pytest.mark.parametrize("sector,spread,threads,part_min", [(16, 1, 256, 8192),
                                                            (32, 66, 256, 8192),
                                                            (64, 512, 512, 0), (128, 8, 128, 0)])
@pytest.mark.parametrize("shape,film", [((32, 64, 64, 32), False), ((4, 64, 64, 96), True),
                                        ((8, 32, 32, 160), False), ((3, 7, 7, 24), True),
                                        ((2, 9, 9, 16), False), ((2, 16, 16, 40), True),
                                        ((5, 8, 8, 56), False)])
def test_groupnorm_bf16_narrow_kernel_every_plan(dev, monkeypatch, sector, spread, threads,
                                                  part_min, shape, film):
    """The narrow bf16 K2 under units of the fewest whole packs to 8 groups
    (``NARROW_SECTOR``), clusters of 1 to 8 (``NARROW_SPREAD``,
    ``BF16_PART_MIN``: 4 to 16 packs a thread, ragged parts of a few
    pixels at 7x7 and 9x9) and CTAs of 32 to 512 threads
    (``NARROW_THREADS``), at 2 to 20 channels a group (1 to 20
    packs a unit's pixel), against its plain version (GELU): phase (c)'s
    gate, 2 bf16 ulps and at most 1% of the elements differing."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    monkeypatch.setattr(groupnorm, "NARROW_SECTOR", sector)
    monkeypatch.setattr(groupnorm, "NARROW_SPREAD", spread)
    monkeypatch.setattr(groupnorm, "NARROW_THREADS", threads)
    monkeypatch.setattr(groupnorm, "BF16_PART_MIN", part_min)
    n, c = shape[0], shape[-1]
    assert groupnorm.single_route(n, shape[1] * shape[2], c, 8, torch.bfloat16)[0] == (
        groupnorm.BF16_NARROW_NAME)
    x = (_randn(dev, *shape, seed=96) * 3 + 1).bfloat16()
    gamma, beta = _randn(dev, c, seed=97), _randn(dev, c, seed=98)
    rows = ((_randn(dev, n, c, seed=99).bfloat16(), _randn(dev, 1, c, seed=100).bfloat16())
            if film else None)
    want = groupnorm_act_plain(x, gamma, beta, 8, 1e-5, "gelu", rows)
    _assert_bf16_close(fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "gelu", rows), want,
                       2 * _bf16_ulp(want.float().abs().max().item()))


def test_bf16_generic_instances_take_only_the_shapes_the_kernels_refuse(dev, fp32_convs):
    """The float kernels' bf16 instances still take what every bf16
    kernel refuses, chosen before the launch: K2 on unaligned bf16 maps of
    4 and 12 channels a group (n_feat 96's out_norm at 16 maps: a slice of
    exactly 48 KiB, which needs the shared-memory opt-in with the kernel's
    static arrays) and on groups of 264 channels (over 256: no model's),
    K1 on weights of 6000 channels (over the bf16 kernel's shared memory:
    no model's), each against its plain version under phase (c)'s gates,
    counted under ``.launches_generic_bf16`` and not
    ``.launches_narrow_bf16``.  K1 on weights of 6000 channels (over the
    bf16 kernel's shared memory: no model's), which the float kernel's
    bf16 instance took before, takes the split launch: counted under
    ``.launches_split_bf16``.  K1 at 40 channels (not a multiple of 32)
    takes the narrow item with a masked last block: counted under
    ``.launches_narrow_bf16`` and ``.launches_masked_bf16``, not
    ``.launches_split_bf16``."""
    for n, c, hw, offset in ((4, 32, 64, 1), (32, 96, 64, 1), (4, 8 * 264, 16, 0)):
        buf = (_randn(dev, n * hw * hw * c + 1, seed=101) * 3 + 1).bfloat16()
        x = buf[offset:offset + n * hw * hw * c].view(n, hw, hw, c)  # offset 1: 2 bytes off
        gamma, beta = _randn(dev, c, seed=102), _randn(dev, c, seed=103)
        before = (fused_groupnorm_act.launches_narrow_bf16,
                  fused_groupnorm_act.launches_generic_bf16)
        got = fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "relu")
        assert (fused_groupnorm_act.launches_narrow_bf16,
                fused_groupnorm_act.launches_generic_bf16) == (before[0], before[1] + 1)
        want = groupnorm_act_plain(x, gamma, beta, 8, 1e-5, "relu")
        _assert_bf16_close(got, want, 2 * _bf16_ulp(want.float().abs().max().item()))
    assert launch_plan(32, 64 * 64, 96, 8, False, 2).smem_bytes == 48 * 1024
    for b, hw, c, split in ((4, 64, 40, False), (1, 8, 6000, True)):
        h = _randn(dev, 2 * b, hw, hw, c, seed=104).relu().bfloat16()
        weight = (_randn(dev, 1, c, 3, 3, seed=105) / (3 * c**0.5)).bfloat16()
        bias = _randn(dev, 1, seed=106).bfloat16()
        x1, z = _randn(dev, b, hw, hw, 1, seed=107), _randn(dev, b, hw, hw, 1, seed=108)
        args = (h, weight, bias, x1, z, 0.02, 1.01, 0.3, 2.0)
        counts = ("launches_narrow_bf16", "launches_masked_bf16", "launches_split_bf16")
        before = [getattr(fused_head_step, k) for k in counts]
        got = fused_head_step(*args)
        assert [getattr(fused_head_step, k) - v for k, v in zip(counts, before)] == (
            [0, 0, 1] if split else [1, 1, 0])
        eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
        eps = guided_eps(eps.bfloat16(), 2.0).float()
        _assert_bf16_close(got, head_step_plain(*args),
                           4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()),
                           fp32_rounding=1e-5)


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("b", [2, 16])
@pytest.mark.parametrize("c", NARROW_FEATS)
def test_head_step_bf16_narrow_kernel_matches_plain(dev, fp32_convs, c, b, w, tanh):
    """K1's bf16 kernel at its narrow item (32 pixels x 32 channels) on
    out_norm's features of n_feat 32, 96 and 160 at 2 and 16 maps, under
    CFG (scalar and per-sample w) and without, with and without the tanh:
    ``test_head_step_bf16_kernel_at_the_path_shapes``'s gate (4 bf16 ulps
    of eps times c_eps / sqrt(a), the step's FMAs on all but 1%); counted
    under ``.launches_bf16`` and ``.launches_narrow_bf16``."""
    cfg = w is not None
    h = _randn(dev, 2 * b if cfg else b, 64, 64, c, seed=111).relu().bfloat16()
    weight = (_randn(dev, 1, c, 3, 3, seed=112) / (3 * c**0.5)).bfloat16()
    bias = _randn(dev, 1, seed=113).bfloat16()
    x, z = _randn(dev, b, 64, 64, 1, seed=114), _randn(dev, b, 64, 64, 1, seed=115)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)
    counts = ("launches_bf16", "launches_narrow_bf16", "launches_split_bf16")
    before = [getattr(fused_head_step, k) for k in counts]
    got = fused_head_step(*args, tanh=tanh)
    assert [getattr(fused_head_step, k) - v for k, v in zip(counts, before)] == [1, 1, 0]
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    eps = guided_eps(eps.bfloat16(), w, tanh).float()
    _assert_bf16_close(got, head_step_plain(*args, tanh=tanh),
                       4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()), fp32_rounding=1e-5)


@pytest.mark.parametrize("rows", [8, 4, 2, 1])
@pytest.mark.parametrize("shape,w", [((3, 12, 12, 32), 2.0), ((2, 16, 16, 96), None),
                                     ((2, 9, 8, 160), "per-sample")])
def test_head_step_bf16_narrow_kernel_every_band(dev, fp32_convs, monkeypatch, rows, shape, w):
    """The narrow item at every band height of ``ROWS_BF16`` (ragged last
    bands at heights 12 and 9, a last item of fewer than 32 band pixels),
    one to five channel blocks an item: the same gate."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    monkeypatch.setattr(sampler_step, "ROWS_BF16", (rows,))
    b, height, width, c = shape
    cfg = w is not None
    h = _randn(dev, 2 * b if cfg else b, height, width, c, seed=121).relu().bfloat16()
    weight = (_randn(dev, 1, c, 3, 3, seed=122) / (3 * c**0.5)).bfloat16()
    bias = _randn(dev, 1, seed=123).bfloat16()
    x, z = (_randn(dev, b, height, width, 1, seed=124),
            _randn(dev, b, height, width, 1, seed=125))
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)
    plan = sampler_step.bf16_plan(b, height, width, c, cfg=cfg)
    assert (plan.rows, plan.block) == (rows, sampler_step.BF16_NARROW_BLOCK)
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    eps = guided_eps(eps.bfloat16(), w).float()
    _assert_bf16_close(fused_head_step(*args), head_step_plain(*args),
                       4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()), fp32_rounding=1e-5)


@pytest.mark.parametrize("w", [None, 2.0])
@pytest.mark.parametrize("c", NARROW_FEATS)
def test_head_step_narrow_halo_mode_equals_the_unsharded_step(dev, fp32_convs, c, w):
    """The narrow item's halo mode on two height shards of 16 maps'
    features of n_feat 32, 96 and 160: each shard against its plain
    version (phase (r1)'s gate), and the two shards' steps equal to the
    unsharded narrow launch's step on the whole map bit for bit (each
    pixel's partials are the same products summed in the same order);
    counted under ``.launches_halo_bf16`` and
    ``.launches_halo_narrow_bf16``, none under the split halo count."""
    b, hw = 16, 64
    h = _randn(dev, 2 * b if w else b, hw, hw, c, seed=131).relu().bfloat16()
    weight = (_randn(dev, 1, c, 3, 3, seed=132) / (3 * c**0.5)).bfloat16()
    bias = _randn(dev, 1, seed=133).bfloat16()
    x, z = _randn(dev, b, hw, hw, 1, seed=134), _randn(dev, b, hw, hw, 1, seed=135)
    whole = fused_head_step(h, weight, bias, x, z, 0.3, 1.1, 0.2, w)
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    tol = 4 * 0.33 * _bf16_ulp(eps.abs().max().item())
    counts = ("launches_halo_bf16", "launches_halo_narrow_bf16", "launches_halo_split_bf16")
    before = [getattr(fused_head_step, k) for k in counts]
    half, outs = hw // 2, []
    for top, sl, bottom in ((None, slice(0, half), h[:, half]),
                            (h[:, half - 1], slice(half, hw), None)):
        args = (h[:, sl].contiguous(), weight, bias, x[:, sl].contiguous(),
                z[:, sl].contiguous(), 0.3, 1.1, 0.2, w)
        got = fused_head_step(*args, halo=(top, bottom))
        torch.testing.assert_close(got, head_step_plain(*args, halo=(top, bottom)),
                                   atol=tol, rtol=0)
        outs.append(got)
    assert [getattr(fused_head_step, k) - v for k, v in zip(counts, before)] == [2, 2, 0]
    assert torch.equal(torch.cat(outs, 1), whole)


# ---- K1 with a masked last channel block, K2's wide layout -------------------

MASKED_FEATS = (40, 48, 264, 8)  # K1 widths no 32-channel block divides


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("w", [None, 2.0, "per-sample"])
@pytest.mark.parametrize("b", [2, 16])
@pytest.mark.parametrize("c", MASKED_FEATS)
def test_head_step_bf16_masked_block_matches_plain(dev, fp32_convs, c, b, w, tanh):
    """K1's bf16 kernel at its narrow item with a masked last channel
    block (40, 48, 264 and 8 channels: the last block holds 8, 16, 8 and 8
    of its 32) on features of those widths at 2 and 16 maps, under CFG
    (scalar and per-sample w) and without, with and without the tanh:
    ``test_head_step_bf16_kernel_at_the_path_shapes``'s gate (4 bf16 ulps
    of eps times c_eps / sqrt(a), the step's FMAs on all but 1%); counted
    under ``.launches_bf16``, ``.launches_narrow_bf16`` and
    ``.launches_masked_bf16``, none under the split count."""
    cfg = w is not None
    h = _randn(dev, 2 * b if cfg else b, 64, 64, c, seed=141).relu().bfloat16()
    weight = (_randn(dev, 1, c, 3, 3, seed=142) / (3 * c**0.5)).bfloat16()
    bias = _randn(dev, 1, seed=143).bfloat16()
    x, z = _randn(dev, b, 64, 64, 1, seed=144), _randn(dev, b, 64, 64, 1, seed=145)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)
    counts = ("launches_bf16", "launches_narrow_bf16", "launches_masked_bf16",
              "launches_split_bf16")
    before = [getattr(fused_head_step, k) for k in counts]
    got = fused_head_step(*args, tanh=tanh)
    assert [getattr(fused_head_step, k) - v for k, v in zip(counts, before)] == [1, 1, 1, 0]
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    eps = guided_eps(eps.bfloat16(), w, tanh).float()
    _assert_bf16_close(got, head_step_plain(*args, tanh=tanh),
                       4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()), fp32_rounding=1e-5)


@pytest.mark.parametrize("rows", [8, 4, 2, 1])
@pytest.mark.parametrize("shape,w", [((3, 12, 12, 40), 2.0), ((2, 16, 16, 264), None),
                                     ((2, 9, 8, 8), "per-sample")])
def test_head_step_bf16_masked_block_every_band(dev, fp32_convs, monkeypatch, rows, shape, w):
    """The masked narrow item at every band height of ``ROWS_BF16``
    (ragged last bands at heights 12 and 9): the same gate."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    monkeypatch.setattr(sampler_step, "ROWS_BF16", (rows,))
    b, height, width, c = shape
    cfg = w is not None
    h = _randn(dev, 2 * b if cfg else b, height, width, c, seed=151).relu().bfloat16()
    weight = (_randn(dev, 1, c, 3, 3, seed=152) / (3 * c**0.5)).bfloat16()
    bias = _randn(dev, 1, seed=153).bfloat16()
    x, z = (_randn(dev, b, height, width, 1, seed=154),
            _randn(dev, b, height, width, 1, seed=155))
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, b, device=dev)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)
    plan = sampler_step.bf16_plan(b, height, width, c, cfg=cfg)
    assert (plan.rows, plan.block) == (rows, sampler_step.BF16_NARROW_BLOCK)
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    eps = guided_eps(eps.bfloat16(), w).float()
    _assert_bf16_close(fused_head_step(*args), head_step_plain(*args),
                       4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()), fp32_rounding=1e-5)


@pytest.mark.parametrize("w", [None, 2.0])
@pytest.mark.parametrize("c", MASKED_FEATS)
def test_head_step_masked_halo_mode_equals_the_unsharded_step(dev, fp32_convs, c, w):
    """The masked narrow item's halo mode on two height shards of 16
    maps' features of 40, 48, 264 and 8 channels: each shard against its
    plain version (phase (r1)'s gate), and the two shards' steps equal to
    the unsharded launch's step on the whole map bit for bit (the masked
    products are zeros in both); counted under ``.launches_halo_bf16``,
    ``.launches_halo_narrow_bf16`` and ``.launches_halo_masked_bf16``,
    none under the split halo count."""
    b, hw = 16, 64
    h = _randn(dev, 2 * b if w else b, hw, hw, c, seed=161).relu().bfloat16()
    weight = (_randn(dev, 1, c, 3, 3, seed=162) / (3 * c**0.5)).bfloat16()
    bias = _randn(dev, 1, seed=163).bfloat16()
    x, z = _randn(dev, b, hw, hw, 1, seed=164), _randn(dev, b, hw, hw, 1, seed=165)
    whole = fused_head_step(h, weight, bias, x, z, 0.3, 1.1, 0.2, w)
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    tol = 4 * 0.33 * _bf16_ulp(eps.abs().max().item())
    counts = ("launches_halo_bf16", "launches_halo_narrow_bf16", "launches_halo_masked_bf16",
              "launches_halo_split_bf16")
    before = [getattr(fused_head_step, k) for k in counts]
    half, outs = hw // 2, []
    for top, sl, bottom in ((None, slice(0, half), h[:, half]),
                            (h[:, half - 1], slice(half, hw), None)):
        args = (h[:, sl].contiguous(), weight, bias, x[:, sl].contiguous(),
                z[:, sl].contiguous(), 0.3, 1.1, 0.2, w)
        got = fused_head_step(*args, halo=(top, bottom))
        torch.testing.assert_close(got, head_step_plain(*args, halo=(top, bottom)),
                                   atol=tol, rtol=0)
        outs.append(got)
    assert [getattr(fused_head_step, k) - v for k, v in zip(counts, before)] == [2, 2, 2, 0]
    assert torch.equal(torch.cat(outs, 1), whole)


WIDE_HEADS = {  # (channels, height): n_feat 264's and 280's heads, units over 256 channels
    "n_feat 264 out_norm": (264, 64), "n_feat 264 up0_norm": (528, 16),
    "n_feat 280 out_norm": (280, 64),
}


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "leaky_relu"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("maps", [2, 16])
@pytest.mark.parametrize("head", WIDE_HEADS)
def test_groupnorm_bf16_wide_kernel_matches_plain(dev, head, maps, film, act):
    """The narrow bf16 K2's wide layout at n_feat 264's out_norm (8 groups
    of 33 channels: a unit of 264, 33 packs a pixel) and up0_norm (4 of
    66: 264) and n_feat 280's out_norm (35 packs) at 2 and 16 maps under
    CFG, every activation, with and without the FiLM epilogue, against its
    plain version: 2 bf16 ulps of max |out| (phase (c)'s gate), at most 1%
    of the elements differing; counted under ``.launches_bf16``,
    ``.launches_narrow_bf16`` and ``.launches_wide_bf16``."""
    c, hw = WIDE_HEADS[head]
    n = 2 * maps
    x = (_randn(dev, n, hw, hw, c, seed=171) * 3 + 1).bfloat16()
    gamma, beta = _randn(dev, c, seed=172), _randn(dev, c, seed=173)
    rows = ((_randn(dev, n, c, seed=174).bfloat16(),
             _randn(dev, 1, c, seed=175).bfloat16()) if film else None)
    args = (x, gamma, beta, 8, 1e-5, act, rows)
    assert narrow_plan(n, hw * hw, c, 8).wide
    counts = ("launches_bf16", "launches_narrow_bf16", "launches_wide_bf16",
              "launches_generic_bf16")
    before = [getattr(fused_groupnorm_act, k) for k in counts]
    got = fused_groupnorm_act(*args)
    assert [getattr(fused_groupnorm_act, k) - b for k, b in zip(counts, before)] == [1, 1, 1, 0]
    want = groupnorm_act_plain(*args)
    _assert_bf16_close(got, want, 2 * _bf16_ulp(want.float().abs().max().item()))


@pytest.mark.parametrize("threads,spread,part_min", [(512, 66, 8192), (256, 66, 8192),
                                                     (320, 512, 0), (256, 1, 8192)])
@pytest.mark.parametrize("shape,film", [((4, 64, 64, 264), False), ((8, 16, 16, 528), True),
                                        ((32, 64, 64, 136), False), ((3, 7, 7, 264), True),
                                        ((2, 5, 5, 8 * 255), False),
                                        ((2, 128, 128, 40), True),
                                        ((2, 128, 128, 320), False), ((4, 16, 16, 1088), True)])
def test_groupnorm_bf16_wide_kernel_every_plan(dev, monkeypatch, threads, spread, part_min,
                                               shape, film):
    """The wide layout under CTAs of 256 to 512 threads (``BF16_WIDE_THREADS``;
    17 to 255 packs a pixel, the lanes past the last whole pixel idle) and
    clusters of 1 to 8 (``NARROW_SPREAD``, ``BF16_PART_MIN``: parts of
    one to many rounds, ragged parts at 7x7 and 5x5, where the last ranks
    of a cluster hold no pixel), at units over 256 channels (n_feat 264's
    heads, 255 channels a group), 17 packs (n_feat 136), parts over 16
    packs (n_feat 40 at 128x128), and groups of whole packs that the bf16
    kernel's plan refuses (n_feat 320 at 128x128; 17 packs a group, n_feat
    544's up0_norm), against its plain version (GELU): phase (c)'s gate, 2
    bf16 ulps and at most 1% of the elements differing."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    monkeypatch.setattr(groupnorm, "BF16_WIDE_THREADS", threads)
    monkeypatch.setattr(groupnorm, "NARROW_SPREAD", spread)
    monkeypatch.setattr(groupnorm, "BF16_PART_MIN", part_min)
    n, c = shape[0], shape[-1]
    name, plan = groupnorm.single_route(n, shape[1] * shape[2], c, 8, torch.bfloat16)
    assert name == groupnorm.BF16_NARROW_NAME and plan.wide
    x = (_randn(dev, *shape, seed=176) * 3 + 1).bfloat16()
    gamma, beta = _randn(dev, c, seed=177), _randn(dev, c, seed=178)
    rows = ((_randn(dev, n, c, seed=179).bfloat16(), _randn(dev, 1, c, seed=180).bfloat16())
            if film else None)
    want = groupnorm_act_plain(x, gamma, beta, 8, 1e-5, "gelu", rows)
    _assert_bf16_close(fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "gelu", rows), want,
                       2 * _bf16_ulp(want.float().abs().max().item()))


# ---- every width the JAX package computes: the split K1, the K2 pair, wide K3 ----

SPLIT_SHAPES = {  # (maps, height, width, c, halo): "What the numbers should do" and more
    "bf16 (2,8,8,6000) cfg": (1, 8, 8, 6000, False, torch.bfloat16),
    "bf16 half (2,4,8,6000) cfg": (1, 4, 8, 6000, True, torch.bfloat16),
    "fp32 half (2,4,8,6000) cfg": (1, 4, 8, 6000, True, torch.float32),
    "fp32 (2,8,8,6400) cfg": (1, 8, 8, 6400, False, torch.float32),
    "bf16 16 maps (32,64,64,4840)": (16, 64, 64, 4840, False, torch.bfloat16),
    "fp32 16 maps (32,64,64,3056)": (16, 64, 64, 3056, False, torch.float32),
    "bf16 64-channel items (2,8,8,6016)": (1, 8, 8, 6016, False, torch.bfloat16),
}


def _split_args(dev, maps, height, width, c, dtype, w, seed=201):
    cfg = w is not None
    h = _randn(dev, 2 * maps if cfg else maps, height, width, c, seed=seed).relu().to(dtype)
    weight = (_randn(dev, 1, c, 3, 3, seed=seed + 1) / (3 * c**0.5)).to(dtype)
    bias = _randn(dev, 1, seed=seed + 2).to(dtype)
    x = _randn(dev, maps, height, width, 1, seed=seed + 3)
    z = _randn(dev, maps, height, width, 1, seed=seed + 4)
    if w == "per-sample":
        w = torch.linspace(0.5, 3.0, maps, device=dev)
    return (h, weight, bias, x, z, 0.02, 1.01, 0.3, w)


def _split_route(sampler_step, monkeypatch, maps, height, width, c, dtype, cfg, halo):
    """K1's route for the shape; without CFG the split launch's, forced
    (``route`` patched) where a band kernel takes the shape."""
    name, plan = sampler_step.route(maps, height, width, c, dtype, cfg=cfg, halo=halo)
    if not cfg and name != sampler_step.SPLIT_NAMES[dtype]:
        real = sampler_step.route

        def route(units, height, width, c, dtype, cout=1, cfg=True, aligned=True, halo=False,
                  sms=sampler_step.SMS):
            real(units, height, width, c, dtype, cout, cfg, aligned, halo, sms)  # its checks
            return sampler_step.SPLIT_NAMES[dtype], sampler_step.split_plan(
                units, height, width, c, cout, cfg, aligned, 2 if dtype == torch.bfloat16
                else 4)

        monkeypatch.setattr(sampler_step, "route", route)
        name, plan = route(maps, height, width, c, dtype, cfg=cfg, halo=halo)
    return name, plan


def _split_gate(args, dtype, tanh=False):
    """Phase (c)'s gate: fp32 1e-4 abs; bf16 4 bf16 ulps of the guided eps
    times c_eps / sqrt(a), all but 1% within the step's FMAs."""
    if dtype == torch.float32:
        return dict(atol=1e-4)
    h, weight, bias = args[:3]
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
    eps = guided_eps(eps.bfloat16(), args[8], tanh).float()
    return dict(atol=4 * 0.02 * 1.01 * _bf16_ulp(eps.abs().max().item()), fp32_rounding=1e-5)


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("w", [2.0, None, "per-sample"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=list(SPLIT_SHAPES))
def test_head_step_split_matches_plain(dev, fp32_convs, monkeypatch, shape, w, tanh):
    """The split K1 (the channel sum over CTAs in ranges of 128 channels,
    then the combine and step) where the band kernels' weights outgrow
    shared memory, unsharded and in its halo mode, in both types, against
    :func:`head_step_plain` under phase (c)'s gates and within 1e-5 of
    :func:`head_step_split_plain` in fp32 (the same range sums); counted
    under ``.launches_split[_bf16]`` (``.launches_halo_split[_bf16]``); two
    runs bit-identical (no atomics).  Without CFG the served batches' band
    kernels take these widths, so the split launch is forced there."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    maps, height, width, c, halo, dtype = SPLIT_SHAPES[shape]
    args = _split_args(dev, maps, height, width, c, dtype, w)
    cfg = w is not None
    rows = (tuple(_randn(dev, args[0].shape[0], width, c, seed=209 + k).relu().to(dtype)
                  for k in range(2)) if halo else None)
    name, plan = _split_route(sampler_step, monkeypatch, maps, height, width, c, dtype, cfg,
                              halo)
    assert name == sampler_step.SPLIT_NAMES[dtype]
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    counts = [f"launches{'_halo' if halo else ''}{kind}{sfx}" for kind in ("", "_split")]
    before = [getattr(fused_head_step, k) for k in counts]
    got = fused_head_step(*args, tanh=tanh, halo=rows)
    assert [getattr(fused_head_step, k) - v for k, v in zip(counts, before)] == [1, 1]
    assert torch.equal(got, fused_head_step(*args, tanh=tanh, halo=rows))
    want = head_step_plain(*args, tanh=tanh, halo=rows)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        split = sampler_step.head_step_split_plain(*args, tanh=tanh, halo=rows)
        torch.testing.assert_close(got, split, atol=1e-5, rtol=0)
    else:
        _assert_bf16_close(got, want, **_split_gate(args, dtype, tanh))
    print(f"{shape} w {w} tanh {tanh}: {plan}; max abs vs plain "
          f"{(got - want).abs().max().item():.3e}")


@pytest.mark.parametrize("w", [2.0, None])
@pytest.mark.parametrize("dtype,maps,hw,c", [(torch.float32, 1, 8, 6400),
                                             (torch.float32, 16, 64, 4840),
                                             (torch.bfloat16, 1, 8, 6000),
                                             (torch.bfloat16, 16, 64, 6000)])
def test_head_step_split_shards_equal_the_unsharded_launch(dev, fp32_convs, monkeypatch, dtype,
                                                           w, maps, hw, c):
    """Two height shards' split launches (the halo mode, each shard's rows
    beyond it from the other) equal the unsharded split launch on the
    whole map bit for bit in both types: the ranges depend on ``c``
    alone, and each pixel's range sums are the same products in the same
    order whichever band holds it.  Without CFG the split launch is forced
    where a band kernel takes the shape."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    h, weight, bias, x, z, *coeffs = _split_args(dev, maps, hw, hw, c, dtype, w, seed=221)
    cfg = w is not None
    half = hw // 2
    for height, halo in ((half, True), (hw, False)):  # the unsharded route last: it may force
        assert _split_route(sampler_step, monkeypatch, maps, height, hw, c, dtype, cfg,
                            halo)[0] == sampler_step.SPLIT_NAMES[dtype]
    whole = fused_head_step(h, weight, bias, x, z, *coeffs)
    outs = []
    for top, sl, bottom in ((None, slice(0, half), h[:, half]),
                            (h[:, half - 1], slice(half, hw), None)):
        outs.append(fused_head_step(h[:, sl].contiguous(), weight, bias, x[:, sl].contiguous(),
                                    z[:, sl].contiguous(), *coeffs, halo=(top, bottom)))
    assert torch.equal(torch.cat(outs, 1), whole)


def test_head_step_split_takes_features_of_2_31_elements(dev, fp32_convs):
    """h of 2^31 bf16 elements (32 maps' CFG features at 128x128x4096),
    which the band kernels' 32-bit offsets cannot index: the split launch,
    its 64-bit pixel offsets, against the plain version under phase (c)'s
    gate."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    maps, hw, c = 16, 128, 4096
    args = _split_args(dev, maps, hw, hw, c, torch.bfloat16, 2.0, seed=231)
    assert args[0].numel() == 2**31
    assert sampler_step.route(maps, hw, hw, c, torch.bfloat16)[0] == (
        sampler_step.SPLIT_NAMES[torch.bfloat16])
    h, weight, bias, x, z, *coeffs, w = args
    got = fused_head_step(*args)
    pairs = [(torch.cat([h[k:k + 1], h[maps + k:maps + k + 1]]), weight, bias, x[k:k + 1],
              z[k:k + 1], *coeffs, w) for k in range(maps)]  # one pair at a time (fp32 copies)
    want = torch.cat([head_step_plain(*pair) for pair in pairs])
    atol = max(_split_gate(pair, torch.bfloat16)["atol"] for pair in pairs)
    _assert_bf16_close(got, want, atol, fp32_rounding=1e-5)


PAIR_CASES = {  # (n, height, width, c, act, film, dtype): the single launch refuses
    "fp32 out_norm (10,128,128,512)": (10, 128, 128, 512, "gelu", False, torch.float32),
    "fp32 out_norm (10,128,128,384)": (10, 128, 128, 384, "gelu", False, torch.float32),
    "fp32 out_norm (10,128,128,320)": (10, 128, 128, 320, "gelu", False, torch.float32),
    "fp32 up0_norm + FiLM (32,16,16,2064)": (32, 16, 16, 2064, "relu", True, torch.float32),
    "bf16 up0_norm + FiLM (32,16,16,2064)": (32, 16, 16, 2064, "relu", True, torch.bfloat16),
    "bf16 up0_norm, leaky (4,16,16,8208)": (4, 16, 16, 8208, "leaky_relu", False,
                                            torch.bfloat16),
    "fp32 1026 elements a group, gelu + FiLM (2,16,16,8208)": (2, 16, 16, 8208, "gelu", True,
                                                                torch.float32),
}


@pytest.mark.parametrize("case", PAIR_CASES, ids=list(PAIR_CASES))
def test_groupnorm_pair_on_one_card_matches_plain(dev, case):
    """K2 where the single launches refuse (a group of over 256 accesses, an
    fp32 slice over ``SLICE_MAX`` that the large-slice kernel does not take,
    as n_feat 320 and 384 at 128x128): the statistics and apply
    launches on one card, the one shard's partials fed to the apply launch,
    against :func:`groupnorm_act_plain`: fp32 within 5e-6 of the largest
    value, bf16 a bf16 ulp of it; counted under ``.launches[_bf16]`` and
    ``.launches_pair[_bf16]``, not under the sharded launches' counts."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    n, height, width, c, act, film, dtype = PAIR_CASES[case]
    assert groupnorm.single_route(n, height * width, c, 8, dtype)[0] == groupnorm.PAIR_NAMES[dtype]
    x = (_randn(dev, n, height, width, c, seed=241) * 3 + 1).to(dtype)
    gamma, beta = _randn(dev, c, seed=242), _randn(dev, c, seed=243)
    rows = ((_randn(dev, n, c, seed=244).to(dtype), _randn(dev, 1, c, seed=245).to(dtype))
            if film else None)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    wrappers = ((fused_groupnorm_act, f"launches{sfx}"),
                (fused_groupnorm_act, f"launches_pair{sfx}"),
                (groupnorm_stats, f"launches{sfx}"), (groupnorm_apply, f"launches{sfx}"))
    before = [getattr(f, k) for f, k in wrappers]
    got = fused_groupnorm_act(x, gamma, beta, 8, 1e-5, act, rows)
    assert [getattr(f, k) - v for (f, k), v in zip(wrappers, before)] == [1, 1, 0, 0]
    want = groupnorm_act_plain(x, gamma, beta, 8, 1e-5, act, rows)
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=5e-6 * scale, rtol=0)
    else:
        _assert_bf16_close(got, want, _bf16_ulp(scale))


@pytest.mark.parametrize("dtype,c", [(torch.float32, 8192), (torch.float32, 4104),
                                     (torch.bfloat16, 8200), (torch.float32, 4098)])
def test_film_kernel_at_pixels_over_1024_accesses(dev, dtype, c):
    """K3 where a pixel has over 1024 accesses (fp32 8192 and 4104
    channels, bf16 8200, 4098 fp32 channels on the scalar path): a thread
    several accesses of each pixel, against :func:`film_plain` (fp32
    1e-5, bf16 exact); counted under ``.launches_wide[_bf16]``."""
    x = _randn(dev, 4, 32, 32, c, seed=251).to(dtype)
    scale, shift = _randn(dev, 4, c, seed=252).to(dtype), _randn(dev, 1, c, seed=253).to(dtype)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    before = getattr(fused_film, f"launches_wide{sfx}")
    got = fused_film(x, scale, shift)
    assert getattr(fused_film, f"launches_wide{sfx}") == before + 1
    want = film_plain(x, scale, shift)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=1e-5 if dtype == torch.float32 else 0.0, rtol=0)


# K1 at several output channels (a model of several image channels):
# (maps, height, width, c, CFG, mode), mode the kernel the route must give.
COUT_SHAPES = {
    "fp32 template w=2 (32,64,64,128)": (16, 64, 64, 128, True, "template", torch.float32),
    "fp32 template w=0 (16,64,64,48)": (16, 64, 64, 48, False, "template", torch.float32),
    "fp32 band w=2 (20,128,128,128)": (10, 128, 128, 128, True, "band", torch.float32),
    "fp32 halo w=2 half (32,32,64,128)": (16, 32, 64, 128, True, "halo", torch.float32),
    "fp32 split w=2 (4,8,8,640)": (2, 8, 8, 640, True, "split", torch.float32),
    "bf16 wide w=2 (32,64,64,128)": (16, 64, 64, 128, True, "bf16", torch.bfloat16),
    "bf16 narrow w=0 (16,64,64,32)": (16, 64, 64, 32, False, "narrow", torch.bfloat16),
    "bf16 masked w=2 (4,16,16,40)": (2, 16, 16, 40, True, "masked", torch.bfloat16),
    "bf16 halo w=2 half (32,32,64,128)": (16, 32, 64, 128, True, "halo", torch.bfloat16),
    "bf16 halo narrow w=2 half (4,8,16,40)": (2, 8, 16, 40, True, "halo", torch.bfloat16),
    "bf16 split w=2 (4,8,8,640)": (2, 8, 8, 640, True, "split", torch.bfloat16),
}


@pytest.mark.parametrize("cout", [2, 3, 4, 13])
@pytest.mark.parametrize("shape", COUT_SHAPES, ids=list(COUT_SHAPES))
def test_head_step_every_kernel_at_several_output_channels(dev, fp32_convs, monkeypatch,
                                                           shape, cout):
    """Every K1 kernel at ``cout`` output channels (2-4 in one group of a
    CTA, 13 in four groups of 4, the last masked past 13) against
    :func:`head_step_plain` under phase (c)'s gates (fp32 1e-4 abs; bf16
    four bf16 ulps of the guided eps times c_eps / sqrt(a), all but 1%
    within the step's FMAs): the fp32 template and band kernel, the bf16
    kernel at its wide and narrow items and a masked last block, both halo
    kernels, and the split launch in either type (forced at 640 channels).
    One launch a call whatever ``cout``; two calls bit-identical."""
    from camels_diffusion_model_tpu_torch.ops import sampler_step

    maps, height, width, c, cfg, mode, dtype = COUT_SHAPES[shape]
    h = _randn(dev, 2 * maps if cfg else maps, height, width, c, seed=301).relu().to(dtype)
    weight = (_randn(dev, cout, c, 3, 3, seed=302) / (3 * c**0.5)).to(dtype)
    bias = _randn(dev, cout, seed=303).to(dtype)
    x = _randn(dev, maps, height, width, cout, seed=304)
    z = _randn(dev, maps, height, width, cout, seed=305)
    args = (h, weight, bias, x, z, 0.02, 1.01, 0.3, 2.0 if cfg else None)
    halo = (tuple(_randn(dev, h.shape[0], width, c, seed=306 + k).relu().to(dtype)
                  for k in range(2)) if mode == "halo" else None)
    if mode == "split":  # forced: the band kernels take 640 channels
        real = sampler_step.route

        def route(units, height, width, c, dtype, cout=1, cfg=True, aligned=True, halo=False,
                  sms=sampler_step.SMS):
            real(units, height, width, c, dtype, cout, cfg, aligned, halo, sms)  # its checks
            return sampler_step.SPLIT_NAMES[dtype], sampler_step.split_plan(
                units, height, width, c, cout, cfg, aligned, sampler_step.ELEMENT_BYTES[dtype])

        monkeypatch.setattr(sampler_step, "route", route)
    name = sampler_step.route(maps, height, width, c, dtype, cout, cfg, halo=halo is not None)[0]
    want_name = {"template": sampler_step.C_NAME, "band": sampler_step.F32_BAND_NAME,
                 "halo": sampler_step.HALO_NAMES[dtype] if c % 64 == 0
                 else sampler_step.HALO_NARROW_NAME,
                 "split": sampler_step.SPLIT_NAMES[dtype], "bf16": sampler_step.BF16_NAME,
                 "narrow": sampler_step.BF16_NARROW_NAME,
                 "masked": sampler_step.BF16_NARROW_NAME}[mode]
    assert name == want_name
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    count = f"launches{'_halo' if halo else ''}{sfx}"
    before = getattr(fused_head_step, count)
    got = fused_head_step(*args, halo=halo)
    assert getattr(fused_head_step, count) == before + 1
    assert got.shape == x.shape
    assert torch.equal(got, fused_head_step(*args, halo=halo))
    want = head_step_plain(*args, halo=halo)
    gate = _split_gate(args, dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, **gate)
    else:
        _assert_bf16_close(got, want, **gate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("shape", [(32, 8, 16, 272), (32, 32, 64, 136), (32, 32, 64, 264),
                                   (32, 8, 16, 528), (32, 16, 16, 2064), (4, 5, 7, 40)])
def test_groupnorm_sharded_launches_at_packs_that_straddle_groups(dev, dtype, shape, film):
    """K2's statistics and apply launches where a pixel's channels are
    whole 16-byte packs but a group's are not (n_feat 136's and 264's
    halves, n_feat 1032's up0_norm; 40 channels: 5 a group, packs in fp32,
    the element path in bf16): the plans' packs, and the launches against
    their plain versions as phase (r1) holds them (statistics 1e-5 of each
    column's largest value; apply fp32 1e-4, bf16 two ulps), with the
    partials of two halves merged."""
    from camels_diffusion_model_tpu_torch.ops import groupnorm

    n, hh, ww, c = shape
    eb = 4 if dtype == torch.float32 else 2
    wide = 16 // eb
    vec = groupnorm.stats_plan(n, hh * ww, c, 8, True, eb).vec
    assert vec == groupnorm.apply_plan(n, hh * ww, c, 8, True, eb).vec
    assert vec == (wide if c // 8 >= wide else 1)
    halves = [(_randn(dev, n, hh, ww, c, seed=311 + k) * 3 + 1).to(dtype) for k in range(2)]
    got = groupnorm_stats(halves[0], 8)
    want = groupnorm_stats_plain(halves[0], 8)
    err = ((got - want).abs().flatten(0, -2).amax(0)
           / want.abs().flatten(0, -2).amax(0).clamp_min(1e-30)).max().item()
    assert err <= 1e-5
    parts = torch.stack([groupnorm_stats_plain(x, 8) for x in halves])
    gamma, beta = _randn(dev, c, seed=313), _randn(dev, c, seed=314)
    rows = (_randn(dev, n, c, seed=315).to(dtype), _randn(dev, 1, c, seed=316).to(dtype)) \
        if film else None
    got = groupnorm_apply(halves[0], parts, gamma, beta, 8, 1e-5, "relu", rows)
    want = groupnorm_apply_plain(halves[0], parts, gamma, beta, 8, 1e-5, "relu", rows)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        _assert_bf16_close(got, want, 2 * _bf16_ulp(want.float().abs().max().item()))
