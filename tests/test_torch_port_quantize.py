"""PyTorch port: int8 W8A8 quantization (``models/quantize.py``) and the
last small leftovers of the JAX package -- ``SpectralCalibration.save``
and ``fit_spectral_transfer``, ``bilinear_resize``, ``count_params``,
``fold_inference``, ``log_device_used`` and ``torch_conv_init`` -- against
the JAX package on the same numpy inputs, on the CPU.

Tolerances.  ``quantize_symmetric`` is bit for bit (both round half to
even).  ``QuantConv``'s int32 sums are exact in both packages, so its
output is the fp32 conv of the integer operands rescaled, bit for bit;
against JAX's ``QuantConv`` within one fp32 ulp (XLA's CPU backend may
fuse the rescale's multiply and bias add); against
``dequantized_reference`` (fp32 products of the dequantized operands)
within JAX's own bound for that comparison, 2e-5
(``tests/test_quantize.py:58``).
"""


import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.diffusion import calibration as jax_calibration
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.models.context_unet import count_params as jax_count_params
from camels_diffusion_model_tpu.models.fold_bn import fold_inference as jax_fold_inference
from camels_diffusion_model_tpu.models.quantize import QuantConv as JaxQuantConv
from camels_diffusion_model_tpu.models.quantize import (
    dequantized_reference as jax_dequantized_reference,
)
from camels_diffusion_model_tpu.models.quantize import (
    quantize_symmetric as jax_quantize_symmetric,
)
from camels_diffusion_model_tpu.ops.resize import bilinear_resize as jax_bilinear_resize
from camels_diffusion_model_tpu.utils import run_logging as jax_run_logging
from camels_diffusion_model_tpu_torch.diffusion import calibration
from camels_diffusion_model_tpu_torch.models.blocks import torch_conv_init
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet, count_params
from camels_diffusion_model_tpu_torch.models.fold_bn import fold_inference
from camels_diffusion_model_tpu_torch.models.quantize import (
    QuantConv,
    dequantized_reference,
    int8_conv_sums,
    quantize_symmetric,
)
from camels_diffusion_model_tpu_torch.ops.resize import bilinear_resize
from camels_diffusion_model_tpu_torch.utils.run_logging import log_device_used
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables, to_jax_variables


def _weights(seed, cin, cout, scale=0.1):
    rs = np.random.RandomState(seed)
    kernel = rs.randn(3, 3, cin, cout).astype(np.float32) * scale  # HWIO
    bias = rs.randn(cout).astype(np.float32) * 0.01
    return kernel, bias


# ---- quantize_symmetric -----------------------------------------------------

@pytest.mark.parametrize("axis", [None, (0, 1, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_symmetric_equals_jax_bit_for_bit(axis, seed):
    """Per tensor, and per output channel of an HWIO kernel; values put on
    the rounding's half-way points too (half to even in both)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(3, 3, 8, 12).astype(np.float32) * 3.0
    x.flat[:7] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.0, -3.0], np.float32)
    q, s = quantize_symmetric(torch.tensor(x), axis)
    q_jax, s_jax = jax_quantize_symmetric(jnp.asarray(x), axis)
    assert q.dtype == torch.int8 and tuple(s.shape) == tuple(s_jax.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_jax))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax))


def test_quantize_symmetric_per_channel_of_an_oihw_kernel_is_the_hwio_one():
    w = np.random.RandomState(2).randn(3, 3, 8, 12).astype(np.float32)
    q, s = quantize_symmetric(torch.tensor(w).permute(3, 2, 0, 1), axis=(1, 2, 3))
    q_jax, s_jax = jax_quantize_symmetric(jnp.asarray(w), axis=(0, 1, 2))
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(), np.asarray(q_jax))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax))


# ---- QuantConv ----------------------------------------------------------------

@pytest.mark.parametrize("b,h,cin,cout", [(2, 8, 8, 16), (1, 6, 1, 3), (3, 16, 32, 32)])
def test_int8_sums_are_the_exact_integer_conv(b, h, cin, cout):
    """``torch._int_mm`` over the int8 columns (K, the output channels and
    the rows padded as the card asks) gives the integer convolution."""
    rs = np.random.RandomState(h)
    x_q = torch.tensor(rs.randint(-127, 128, (b, cin, h, h)), dtype=torch.int8)
    w_q = torch.tensor(rs.randint(-127, 128, (cout, cin, 3, 3)), dtype=torch.int8)
    want = F.conv2d(x_q.double(), w_q.double(), padding=1)
    got = int8_conv_sums(x_q, w_q)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int64))


@pytest.mark.parametrize("b,h,cin,cout", [(2, 8, 8, 16), (2, 16, 32, 32)])
def test_quantconv_equals_jax_quantconv(b, h, cin, cout):
    """The JAX tree's kernel and bias loaded (HWIO -> OIHW), the same NHWC
    input: within one fp32 ulp of JAX's ``QuantConv``."""
    kernel, bias = _weights(b + h, cin, cout)
    x = np.random.RandomState(h).randn(b, h, h, cin).astype(np.float32)
    want = np.asarray(JaxQuantConv(features=cout).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, x))
    conv = QuantConv(cin, cout).load_jax_params({"kernel": kernel, "bias": bias})
    with torch.no_grad():
        got = conv(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_quantconv_is_the_rescaled_integer_conv_and_near_dequantized_reference():
    """``acc.float() * (s_x * s_w) + bias`` of the exact integer sums, bit
    for bit; within JAX's bound of :func:`dequantized_reference`, which
    itself is JAX's within 1e-6."""
    kernel, bias = _weights(5, 8, 16)
    x = torch.tensor(np.random.RandomState(2).randn(2, 8, 8, 8).astype(np.float32))
    conv = QuantConv(8, 16).load_jax_params({"kernel": kernel, "bias": bias})
    with torch.no_grad():
        got = conv(x)
        w_q, s_w = quantize_symmetric(conv.weight, axis=(1, 2, 3))
        x_q, s_x = quantize_symmetric(x)
        acc = F.conv2d(x_q.double(), w_q.double(), padding=1).float()
        want = acc * (s_x * s_w)[:, None, None] + conv.bias[:, None, None]
        ref = dequantized_reference(x, conv.weight, conv.bias)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    ref_jax = jax_dequantized_reference(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                        jnp.asarray(kernel), jnp.asarray(bias))
    np.testing.assert_allclose(ref.permute(0, 2, 3, 1).numpy(), np.asarray(ref_jax),
                               atol=1e-6, rtol=0)


def test_quantconv_params_start_at_zero_and_out_dtype():
    conv = QuantConv(4, 6, dtype=torch.bfloat16)
    assert tuple(conv.weight.shape) == (6, 4, 3, 3) and not conv.weight.any()
    with torch.no_grad():
        assert conv(torch.randn(1, 4, 8, 8)).dtype == torch.bfloat16


# ---- SpectralCalibration.save, fit_spectral_transfer ---------------------------

def _spectra(seed):
    rs = np.random.RandomState(seed)
    k = np.linspace(0.0, 3.0, 33)
    ref = np.exp(-k) + 0.1
    fast = ref * (1.0 + 0.05 * np.sin(3 * k) + 0.01 * rs.randn(33))
    counts = rs.randint(4, 200, 33)
    fast[5] = np.nan  # an unpopulated bin
    return k, fast, ref, counts


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("deg", [6, 3])
def test_fit_spectral_transfer_equals_jax(weighted, deg):
    k, fast, ref, counts = _spectra(deg)
    kw = dict(deg=deg, counts=counts if weighted else None, dl=2.0, clip=(0.8, 1.3))
    got = calibration.fit_spectral_transfer(k, fast, ref, **kw)
    want = jax_calibration.fit_spectral_transfer(k, fast, ref, **kw)
    assert got.coeffs == want.coeffs
    assert (got.k_min, got.k_max, got.dl, got.clip) == (want.k_min, want.k_max, want.dl,
                                                        want.clip)


def test_fit_spectral_transfer_refuses_spectra_without_a_usable_bin():
    k = np.zeros(4)
    with pytest.raises(ValueError, match="no valid"):
        calibration.fit_spectral_transfer(k, np.ones(4), np.ones(4))


@pytest.mark.parametrize("binwise", [False, True])
def test_save_files_load_back_equal_in_both_packages(tmp_path, binwise):
    """A calibration saved by either package, with provenance and a binwise
    table, loads back equal in both, its metadata too."""
    k, fast, ref, _ = _spectra(1)
    fit = calibration.fit_spectral_transfer(k, fast, ref)
    bins = tuple(np.linspace(0.9, 1.1, 12)) if binwise else None
    ours = calibration.SpectralCalibration(fit.coeffs, fit.k_min, fit.k_max, 1.0, fit.clip, bins)
    theirs = jax_calibration.SpectralCalibration(fit.coeffs, fit.k_min, fit.k_max, 1.0,
                                                 fit.clip, bins)
    meta = {"checkpoint_fingerprint": "a76d14b5", "n_maps": 4096}
    ours.save(str(tmp_path / "port.npz"), meta=meta)
    theirs.save(str(tmp_path / "jax.npz"), meta=meta)
    for name in ("port.npz", "jax.npz"):
        path = str(tmp_path / name)
        for pkg in (calibration, jax_calibration):
            back = pkg.SpectralCalibration.load(path)
            assert (back.coeffs, back.k_min, back.k_max, back.dl, back.clip,
                    back.bin_ratios) == (fit.coeffs, fit.k_min, fit.k_max, 1.0, fit.clip, bins)
            assert pkg.load_calibration_meta(path) == meta
    with np.load(str(tmp_path / "port.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


# ---- bilinear_resize, count_params, fold_inference, the rest -------------------

@pytest.mark.parametrize("shape,out", [((3, 32, 32), (16, 16)), ((2, 4, 20, 12), (7, 30)),
                                       ((256, 256), (64, 64))])
def test_bilinear_resize_equals_jax(shape, out):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = bilinear_resize(x, *out)
    assert tuple(got.shape) == shape[:-2] + out
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bilinear_resize(x, *out)),
                               atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def deep_variables():
    model = JaxContextUnet.deep(n_feat=8, n_cfeat=3, height=16)
    return model, jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), np.zeros((1, 16, 16, 1), np.float32),
        np.array([0.5], np.float32)))


def test_count_params_equals_jax(deep_variables):
    jax_model, variables = deep_variables
    model = ContextUnet.deep(n_feat=8, n_cfeat=3, height=16)
    model.load_state_dict(from_jax_variables(variables))
    assert count_params(model) == jax_count_params(variables)


def test_fold_inference_equals_jax(deep_variables):
    """The folded model and state hold JAX's folded variables, and a model
    already folded comes back as it is."""
    jax_model, variables = deep_variables
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0 + 0.5, variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    model = ContextUnet.deep(n_feat=8, n_cfeat=3, height=16)
    model.load_state_dict(from_jax_variables(variables))
    folded, state = fold_inference(model)
    _, want = jax_fold_inference(jax_model, variables)
    got = to_jax_variables(state)["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(want["params"]):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-6, atol=1e-7)
    assert fold_inference(folded)[0] is folded


def test_log_device_used_writes_the_reference_line(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    log_device_used("cpu", str(tmp_path / "port.log"))
    jax_run_logging.log_device_used(str(tmp_path / "jax.log"))
    with open(tmp_path / "port.log") as a, open(tmp_path / "jax.log") as b:
        assert a.read() == b.read() == "Device used: CPU\n"


def test_torch_conv_init_draws_torchs_default_bound():
    init = torch_conv_init(16, torch.Generator().manual_seed(0))
    w = init(torch.empty(4000))
    assert w.abs().max() <= 0.25 and w.abs().max() > 0.24
    conv = torch.nn.Conv2d(16, 8, 1)
    assert conv.weight.abs().max() <= 1 / 16 ** 0.5
