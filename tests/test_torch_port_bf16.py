"""PyTorch port: the bf16 compute path against the JAX package's on the CPU.

The JAX modules with ``dtype=jnp.bfloat16`` and the port's with
``dtype=torch.bfloat16``, on the same numpy inputs from a seed: the plain
versions of the kernels' bf16 instances, a ResidualConvBlock, the narrow
canonical, deep and big models folded, four steps of each sampler, one train
step, a bf16 ``run_experiment`` and ``load_model(dtype=torch.bfloat16)``.

Tolerances.  Neither package's bf16 is the other's bit for bit: both round
to bf16 where the JAX program's ops return bf16, but XLA on the CPU rounds
in fewer places than the program says (``xla_allow_excess_precision``), and
fp32 sums are taken in other orders, so a value near a rounding boundary
lands on either side.  Each comparison therefore measures its yardstick,
the distance from JAX's own bf16 result to its fp32 result on the same
inputs (bf16 inputs read exactly as fp32), and gates the port's bf16 at
``FACTOR`` times that distance from JAX's bf16.  Where the two round at the
same points (the kernels' plain versions against the Pallas kernels and
eager JAX), the port must also equal JAX on all but ``SHARE`` of the
elements.  The port's fp32 keeps the gates of the other test files.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from camels_diffusion_model_tpu.diffusion import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.diffusion import sample_ddpm as jax_sample_ddpm
from camels_diffusion_model_tpu.diffusion.ddim import sample_ddim as jax_sample_ddim
from camels_diffusion_model_tpu.diffusion.sampler import _combine_cfg
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.models.blocks import GroupNormAct as JaxGroupNormAct
from camels_diffusion_model_tpu.models.blocks import ResidualConvBlock as JaxResidualConvBlock
from camels_diffusion_model_tpu.models.fold_bn import fold_batchnorm_variables as jax_fold
from camels_diffusion_model_tpu.models.fold_bn import fold_inference
from camels_diffusion_model_tpu.ops.pallas import groupnorm as jax_pallas_groupnorm
from camels_diffusion_model_tpu.ops.pallas.film import film_xla
from camels_diffusion_model_tpu.ops.pallas.film import fused_film as jax_fused_film
from camels_diffusion_model_tpu.ops.pallas.groupnorm import (
    fused_groupnorm_act as jax_fused_groupnorm_act,
)
from camels_diffusion_model_tpu.ops.pallas.sampler_step import (
    fused_p_sample_step as jax_fused_p_sample_step,
)
from camels_diffusion_model_tpu.training import create_train_state as jax_create_train_state
from camels_diffusion_model_tpu.training import make_train_step as jax_make_train_step
from camels_diffusion_model_tpu.training.trainer import _noise_coeff
from camels_diffusion_model_tpu.training.trainer import masked_mean as jax_masked_mean
from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.diffusion.ddim import sample_ddim
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import ddpm_coefficients, make_schedule
from camels_diffusion_model_tpu_torch.models.blocks import ResidualConvBlock
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.models.fold_bn import fold_batchnorm_variables
from camels_diffusion_model_tpu_torch.ops.film import film_plain
from camels_diffusion_model_tpu_torch.ops.groupnorm import groupnorm_act_plain
from camels_diffusion_model_tpu_torch.ops.sampler_step import head_step_plain
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training import trainer
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

FACTOR = 2.0  # the port's bf16 within FACTOR x the yardstick of JAX's bf16
SHARE = 0.01  # ... and, where both round at the same points, equal but for this share
H, NF = 16, 16
NCFEAT = {"canonical": 6, "deep": 5, "big": 10}
BF16 = jnp.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The narrow models gain nothing from threads, and tier-1 runs six
    pytest workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a) -> np.ndarray:
    """A JAX array or torch tensor (bf16 included) as float32 numpy."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def gate(got, jax_bf16, jax_fp32, same_rounding: bool = False) -> float:
    """Assert the port's ``got`` within ``FACTOR`` x the yardstick
    ``|jax_bf16 - jax_fp32|`` (max abs) of ``jax_bf16``; with
    ``same_rounding``, also equal to it on all but ``SHARE`` of the
    elements.  Returns the ratio of the port's distance to the yardstick."""
    got, want, ref = _np(got), _np(jax_bf16), _np(jax_fp32)
    assert got.shape == want.shape == ref.shape
    yard = float(np.abs(want - ref).max())
    dist = float(np.abs(got - want).max())
    assert yard > 0, "the yardstick is 0: bf16 changed nothing"
    assert dist <= FACTOR * yard, f"port bf16 {dist:.3e} from JAX bf16, yardstick {yard:.3e}"
    if same_rounding:
        assert float(np.mean(got != want)) <= SHARE
    return dist / yard


def _bf16(rs, *shape, scale=1.0, shift=0.0) -> np.ndarray:
    """Normal numpy values rounded to bf16 (returned as float32, exact)."""
    x = (rs.randn(*shape) * scale + shift).astype(np.float32)
    return np.asarray(jnp.asarray(x, BF16).astype(jnp.float32))


# ---- the kernels' plain bf16 versions ---------------------------------------

def _pallas_groupnorm(x, gamma, beta, act, film, dtype):
    """The Pallas kernel in interpret mode, then FiLM stage 0 op by op, in
    ``dtype``."""
    u = jax_fused_groupnorm_act(jnp.asarray(x, dtype), gamma, beta, act=act, interpret=True)
    if film is None:
        return u
    scale, shift = (jnp.asarray(r, dtype)[:, None, None, :] for r in film)
    return scale * u + shift


def _xla_groupnorm(x, gamma, beta, act, film, dtype):
    """JAX's XLA GroupNormAct (``pallas_gn=False``) in ``dtype``, then FiLM."""
    gn = JaxGroupNormAct(num_groups=8, act=act, dtype=dtype)
    u = gn.apply({"params": {"scale": gamma, "bias": beta}}, jnp.asarray(x, dtype))
    if film is None:
        return u
    scale, shift = (jnp.asarray(r, dtype)[:, None, None, :] for r in film)
    return scale * u + shift


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu", "leaky_relu"])
def test_groupnorm_act_plain_bf16_matches_jax(act, film):
    """K2's plain bf16 version (activation in fp32, one rounding) against the
    Pallas kernel in interpret mode (same order; the FiLM epilogue op by op
    as context_unet.py:300-307 runs it), and the training forward's order
    (``act_after_rounding``) against JAX's XLA path; each against its
    yardstick, and on equal elements where both round at the same points."""
    rs = np.random.RandomState(0)
    n, c = 3, 64
    x = _bf16(rs, n, 8, 8, c, scale=3.0, shift=1.0)
    gamma, beta = rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)
    rows = (_bf16(rs, n, c), _bf16(rs, 1, c)) if film else None
    port_rows = tuple(torch.tensor(r).bfloat16() for r in rows) if film else None
    args = (torch.tensor(x).bfloat16(), torch.tensor(gamma), torch.tensor(beta), 8, 1e-5, act,
            port_rows)
    got = groupnorm_act_plain(*args)
    assert got.dtype == torch.bfloat16
    gate(got, _pallas_groupnorm(x, gamma, beta, act, rows, BF16),
         _pallas_groupnorm(x, gamma, beta, act, rows, jnp.float32), same_rounding=True)
    xla = [_xla_groupnorm(x, gamma, beta, act, rows, d) for d in (BF16, jnp.float32)]
    # jax.nn.gelu of a bf16 array is four bf16 ops, each rounding, and its
    # leaky ReLU multiplies by 0.2 rounded to bf16 (a weakly typed constant);
    # torch's round once with the fp32 constant: equal elements for ReLU.
    gate(groupnorm_act_plain(*args, act_after_rounding=True), *xla,
         same_rounding=act == "relu")
    gate(got, *xla)


@pytest.mark.parametrize("scale_rows", [3, 1])
def test_film_plain_bf16_matches_jax(scale_rows):
    """K3's plain bf16 version (product rounded, then the sum) against the
    Pallas kernel in interpret mode and the XLA form, with (B, C) and
    (1, C) rows."""
    rs = np.random.RandomState(1)
    n, c = 3, 32
    x = _bf16(rs, n, 8, 8, c)
    scale, shift = _bf16(rs, scale_rows, c), _bf16(rs, 1, c)
    got = film_plain(*(torch.tensor(a).bfloat16() for a in (x, scale, shift)))
    assert got.dtype == torch.bfloat16

    def jax_film(fn, dtype):
        return fn(jnp.asarray(x, dtype), jnp.asarray(scale, dtype)[:, None, None, :],
                  jnp.asarray(shift, dtype)[:, None, None, :])

    gate(got, jax_film(functools.partial(jax_fused_film, interpret=True), BF16),
         jax_film(functools.partial(jax_fused_film, interpret=True), jnp.float32),
         same_rounding=True)
    gate(got, jax_film(film_xla, BF16), jax_film(film_xla, jnp.float32), same_rounding=True)


def _jax_head_step(h, kernel, bias, x, z, t, w, tanh, dtype, schedule):
    """eps = the bf16 (or fp32) out_conv2 of ``h`` (flax ``nn.Conv``), its
    tanh, the CFG combine, then the Pallas step in interpret mode on fp32
    x, z and eps (``sampler.py:264-276``)."""
    conv = fnn.Conv(1, (3, 3), padding="SAME", dtype=dtype)
    eps = conv.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(h, dtype))
    if tanh:
        eps = jnp.tanh(eps)
    if w is not None:
        eps = _combine_cfg(*jnp.split(eps, 2), w)
    return jax_fused_p_sample_step(schedule.beta, schedule.alpha, schedule.alpha_bar,
                                   jnp.asarray(x), t, eps.astype(jnp.float32),
                                   jnp.asarray(z), interpret=True)


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("w", [None, 2.0])
def test_head_step_plain_bf16_matches_jax(w, tanh):
    """K1's plain bf16 version (bf16 features and weights, the conv summed
    in fp32 and rounded with its bias, tanh and the combine in bf16, the
    step in fp32) against flax's bf16 conv, JAX's combine and the Pallas
    step in interpret mode, at w=0 and w=2, with and without tanh."""
    rs = np.random.RandomState(2)
    b, c, t, T = 2, 32, 7, 20
    h = np.maximum(_bf16(rs, 2 * b if w else b, 8, 8, c), 0.0)
    kernel = (rs.randn(3, 3, c, 1) * 0.1).astype(np.float32)
    bias = rs.randn(1).astype(np.float32)
    x, z = rs.randn(b, 8, 8, 1).astype(np.float32), rs.randn(b, 8, 8, 1).astype(np.float32)
    schedule = jax_make_schedule(T)
    want = [_jax_head_step(h, kernel, bias, x, z, t, w, tanh, d, schedule)
            for d in (BF16, jnp.float32)]
    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(make_schedule(T), torch.tensor([t]))[0].tolist()
    weight = torch.tensor(kernel).permute(3, 2, 0, 1).bfloat16()
    got = head_step_plain(torch.tensor(h).bfloat16(), weight, torch.tensor(bias).bfloat16(),
                          torch.tensor(x), torch.tensor(z), c_eps, inv_sqrt_a, sigma, w, tanh)
    assert got.dtype == torch.float32
    gate(got, *want)


# ---- a block ------------------------------------------------------------------

def _random_stats(variables, seed):
    rs = np.random.RandomState(seed)
    variables = jax.device_get(variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((rs.randn(*leaf.shape) * 0.1).astype(np.float32)
                            if "mean" in jax.tree_util.keystr(path)
                            else (rs.rand(*leaf.shape) + 0.5).astype(np.float32)),
        variables["batch_stats"])
    return variables


@pytest.mark.parametrize("fold_bn", [False, True])
def test_residual_block_bf16_matches_jax(fold_bn):
    """``ResidualConvBlock(is_res=True)`` with the learned shortcut, bf16:
    unfolded, a stage returns fp32 (BatchNorm's ``dtype=float32``) and the
    residual sum of the bf16 shortcut and the fp32 stage promotes to fp32,
    as in JAX (``blocks.py:184-191,236``); folded, everything stays bf16."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    jm = JaxResidualConvBlock(16, is_res=True)
    variables = _random_stats(jm.init(jax.random.PRNGKey(0), x), 4)
    if fold_bn:
        jm, variables = jm.clone(fold_bn=True), jax_fold(variables)
    want = [jm.clone(dtype=d).apply(variables, x) for d in (BF16, jnp.float32)]
    port = ResidualConvBlock(4, 16, is_res=True, fold_bn=fold_bn, compute_dtype=torch.bfloat16)
    port.load_state_dict(from_jax_variables(variables))
    port.eval()
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        stage = port._stage(xt, "conv1", False)
        got = port(xt)
    expected = jnp.bfloat16 if fold_bn else jnp.float32
    assert stage.dtype == (torch.bfloat16 if fold_bn else torch.float32)
    assert want[0].dtype == expected
    assert got.dtype == (torch.bfloat16 if fold_bn else torch.float32)
    gate(got.permute(0, 2, 3, 1), *want)


# ---- the narrow models ----------------------------------------------------------

def _jax_model(name, **kw):
    return getattr(JaxContextUnet, name)(n_feat=NF, height=H, n_cfeat=NCFEAT[name], **kw)


@pytest.fixture(scope="module")
def narrow():
    """Per variant: the JAX module, its variables with non-trivial BatchNorm
    running statistics, and both packages' folded models in bf16 and fp32."""
    out = {}
    for i, name in enumerate(NCFEAT):
        model = _jax_model(name)
        variables = _random_stats(jax.jit(model.init)(
            jax.random.PRNGKey(i), np.zeros((1, H, H, 1), np.float32),
            np.array([0.5], np.float32)), 10 + i)
        # The port's kernel path applies the activation before rounding, as
        # the Pallas GroupNorm does: JAX's models take that kernel here.
        folded = {d: fold_inference(model.clone(dtype=d, pallas_gn=True), variables)
                  for d in (BF16, jnp.float32)}
        out[name] = (variables, folded, load_model(variables, "cpu", dtype=torch.bfloat16))
    return out


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX models' Pallas GroupNorm in interpret mode (no TPU here)."""
    monkeypatch.setattr(jax_pallas_groupnorm, "fused_groupnorm_act",
                        functools.partial(jax_fused_groupnorm_act, interpret=True))


def _model_inputs(name, seed=5, b=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, H, H, 1).astype(np.float32), rs.rand(b).astype(np.float32),
            rs.rand(b, NCFEAT[name]).astype(np.float32))


@pytest.mark.parametrize("name", list(NCFEAT))
def test_narrow_model_bf16_eps_and_cfg_pair_match_jax(narrow, pallas_interpret, name):
    """The folded canonical, deep and big models at n_feat 16, 16x16 in
    bf16: eps of a forward, and the guided pair ``[cond; uncond]`` of one
    encoder pass and one decoder pass on the doubled batch with the FiLM
    rows of the embeddings (the samplers' form)."""
    _, folded, port = narrow[name]
    x, t, c = _model_inputs(name)
    c2, t2 = np.concatenate([c, np.zeros_like(c)]), np.concatenate([t, t])

    def jax_pair(model, fv):
        enc = model.apply(fv, x, method="encode")
        enc2 = jax.tree_util.tree_map(lambda a: jnp.concatenate([a, a]), enc)
        cemb1, cemb2 = model.apply(fv, c2, method="context_embed")
        temb1, temb2 = model.apply(fv, t2.reshape(-1, 1), method="time_embed")
        return model.apply(fv, enc2, film=(cemb1, temb1, cemb2, temb2), method="decode")

    want = [m.apply(fv, x, t, c) for m, fv in (folded[BF16], folded[jnp.float32])]
    pair = [jax_pair(*folded[d]) for d in (BF16, jnp.float32)]
    assert want[0].dtype == pair[0].dtype == jnp.bfloat16
    with torch.no_grad():
        xt, tt, ct = torch.tensor(x), torch.tensor(t), torch.tensor(c)
        got = port(xt, tt, ct)
        enc = port.encode(xt).doubled()
        cemb1, cemb2 = port.context_embed(torch.tensor(c2))
        temb1, temb2 = port.time_embed(torch.tensor(t2).reshape(-1, 1))
        got_pair = port.decode(enc, film=(cemb1, temb1, cemb2, temb2))
    assert got.dtype == got_pair.dtype == torch.bfloat16
    gate(got, *want)
    gate(got_pair, *pair)


@pytest.mark.parametrize("n_feat", [32, 96, 40, 264])
def test_narrow_bf16_widths_forward_matches_jax(pallas_interpret, n_feat):
    """The folded canonical model at n_feat 32 and 96 (16x16) in bf16, the
    widths whose out_norm groups (4 and 12 channels) are not whole 16-byte
    packs and whose out_conv2 (32 and 96 channels) is an odd multiple of
    32, and at n_feat 40 and 264, whose out_conv2 (40, 264 channels) is no
    multiple of 32 (the narrow item's masked last block) and whose heads'
    units of whole packs are 40 channels and, at 264, over 256 (out_norm's
    8 groups of 33, up0_norm's 4 of 66: the narrow kernel's wide layout),
    as the narrow bf16 kernels take them on the card: eps of a forward
    on the port's plain path against JAX's bf16 ``ContextUnet`` (its
    Pallas GroupNorm in interpret mode), within ``FACTOR`` x JAX's own
    bf16-vs-fp32 distance on the same inputs (the module's gate)."""
    model = JaxContextUnet.canonical(n_feat=n_feat, height=H, n_cfeat=NCFEAT["canonical"])
    variables = _random_stats(jax.jit(model.init)(
        jax.random.PRNGKey(n_feat), np.zeros((1, H, H, 1), np.float32),
        np.array([0.5], np.float32)), n_feat)
    folded = [fold_inference(model.clone(dtype=d, pallas_gn=True), variables)
              for d in (BF16, jnp.float32)]
    port = load_model(variables, "cpu", dtype=torch.bfloat16)
    assert port.out_norm.weight.shape[0] == port.out_conv2.weight.shape[1] == n_feat
    x, t, c = _model_inputs("canonical", seed=n_feat)
    want = [m.apply(fv, x, t, c) for m, fv in folded]
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t), torch.tensor(c))
    assert got.dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    gate(got, *want)


def _z_chain(key, n_steps, shape):
    """``key, zkey, skey = split(key, 3)`` a step, ``z = normal(zkey)`` in
    x's dtype, fp32 (``tests/test_trajectory_parity.py:55-69``)."""
    zs = []
    for _ in range(n_steps):
        key, zkey, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(zkey, shape, jnp.float32)))
    return zs


@pytest.mark.parametrize("sampler,guide_w", [("ddpm", 0.0), ("ddpm", 2.0), ("beta", 2.0),
                                             ("posterior", 2.0)])
def test_four_sampler_steps_with_a_bf16_model_match_jax(narrow, sampler, guide_w):
    """Four reverse steps of ``sample_ddpm`` (T 4) and of ``sample_ddim``
    in its "beta" and "posterior" (eta 1) modes (T 20, 4 strided steps)
    with the folded canonical bf16 model, same x_init, contexts and z: the
    state stays fp32, eps is bf16 (K1's plain bf16 version here).  Its heads
    are ReLU, where JAX's XLA GroupNorm rounds as the Pallas one does."""
    variables, _, port = narrow["canonical"]
    folded = {d: fold_inference(_jax_model("canonical", dtype=d), variables)
              for d in (BF16, jnp.float32)}
    rs = np.random.RandomState(6)
    x0 = rs.randn(2, H, H, 1).astype(np.float32)
    params = rs.rand(2, NCFEAT["canonical"]).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    T = 4 if sampler == "ddpm" else 20
    taus = np.array([1, 7, 14, 20])
    want = []
    for d in (BF16, jnp.float32):
        model, fv = folded[d]
        if sampler == "ddpm":
            out = jax_sample_ddpm(model, fv, jax_make_schedule(T), rng, params=params,
                                  guide_w=guide_w, x_init=jnp.asarray(x0))
        else:
            out = jax_sample_ddim(model, fv, jax_make_schedule(T), rng, params=params,
                                  guide_w=guide_w, x_init=jnp.asarray(x0), taus=taus,
                                  eta=1.0, sigma_mode=sampler)
        want.append(out.x)
    key = jax.random.split(rng, 3)[0]
    if sampler == "ddpm":
        zs = _z_chain(key, T, x0.shape)
        got = sample_ddpm(port, make_schedule(T), torch.Generator(), params=params,
                          guide_w=guide_w, x_init=x0, device="cpu",
                          z_fn=lambda k, t: torch.tensor(zs[k]))
    else:
        zs = _z_chain(key, len(taus), x0.shape)
        got = sample_ddim(port, make_schedule(T), torch.Generator(), params=params,
                          guide_w=guide_w, x_init=x0, taus=taus, eta=1.0, sigma_mode=sampler,
                          device="cpu", z_fn=lambda k, t: torch.tensor(zs[k]))
    assert got.dtype == torch.float32 and want[0].dtype == jnp.float32
    gate(got, *want)


# ---- one train step -------------------------------------------------------------

def test_bf16_train_step_matches_jax(narrow):
    """One step of the unfolded canonical model in bf16 (batch 8, 2
    wrap-padded rows masked, T 8; t and the noise replayed from JAX's
    ``split(rng, 3)``): the per-sample MSE and the loss, the gradients
    (against ``jax.value_and_grad`` of the step's loss, in L2, together and
    each leaf) and the updated parameters (against ``make_train_step``, in
    L2 over all leaves), each against its yardstick; the parameters, Adam's
    moments and the loss stay fp32."""
    variables, _, _ = narrow["canonical"]
    T, B, REAL = 8, 8, 6
    rs = np.random.RandomState(8)
    idx = np.arange(B) % REAL
    x = rs.rand(REAL, H, H, 1).astype(np.float32)[idx]
    c = rs.rand(REAL, NCFEAT["canonical"]).astype(np.float32)[idx]
    mask = (np.arange(B) < REAL).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    tkey, nkey, _ = jax.random.split(rng, 3)
    t = np.asarray(jax.random.randint(tkey, (B,), 1, T + 1))
    noise = np.asarray(jax.random.normal(nkey, x.shape, jnp.float32))
    alpha_bar = jax_make_schedule(T).alpha_bar
    losses, per_sample, grads, params = [], [], [], []
    for d in (BF16, jnp.float32):
        model = _jax_model("canonical", dtype=d)

        def loss_fn(p):
            ab = alpha_bar[t][:, None, None, None]
            x_pert = jnp.sqrt(ab) * x + _noise_coeff(ab, "reference") * noise
            out, _ = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                 x_pert, (t / T).astype(jnp.float32), c, train=True,
                                 mutable=["batch_stats"])
            return jax_masked_mean(jnp.mean(jnp.square(out - noise), axis=(1, 2, 3)), mask)[1]

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
        losses.append(float(loss))
        grads.append(jax.device_get(g))
        state = jax_create_train_state(model, variables, 1e-3, 4, 2)
        state, m = jax_make_train_step(model, T)(state, x, c, rng, mask)
        assert float(m["loss"]) == pytest.approx(losses[-1], rel=1e-6)
        per_sample.append(np.asarray(m["per_sample_mse"]))
        params.append(jax.device_get(state.params))
    port = ContextUnet.canonical(n_feat=NF, height=H, dtype=torch.bfloat16)
    port.load_state_dict(from_jax_variables(variables))
    state = trainer.create_train_state(port, 1e-3, 4, 2)
    m = trainer.make_train_step(port, T)(state, x, c, mask, t=torch.tensor(t),
                                         noise=torch.tensor(noise))
    assert m["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.dim() > 0)
    # The loss is a mean in which the samples' rounding errors may cancel:
    # its yardstick is the largest sample's, as the per-sample MSE's.
    yard = np.abs(per_sample[0] - per_sample[1]).max()
    assert np.abs(m["per_sample_mse"].numpy() - per_sample[0]).max() <= FACTOR * yard
    assert abs(float(m["loss"]) - losses[0]) <= FACTOR * yard

    def by_leaf(tree):
        return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    got_g = by_leaf(to_jax_variables({n: p.grad for n, p in port.named_parameters()})["params"])
    got_p = by_leaf(to_jax_variables(dict(port.named_parameters()))["params"])
    want_g, want_p = [by_leaf(g) for g in grads], [by_leaf(p) for p in params]
    assert set(got_g) == set(want_g[0]) == set(got_p)
    def flat(tree):
        return np.concatenate([np.ravel(tree[k]) for k in sorted(got_g)])

    # All gradients together (0.98-1.13 of the yardstick over seeds 20-25);
    # then each leaf, whose yardstick is its own bf16 distance but no less
    # than the whole gradient's relative one applied to the leaf: a leaf of
    # 16 or 32 elements may round luckily close to fp32 in one package.
    rho = _l2_gate(flat(got_g), flat(want_g[0]), flat(want_g[1]), "gradients together")
    for k in got_g:
        _l2_gate(got_g[k], want_g[0][k], want_g[1][k], f"gradient {k}", rho)
    # Adam's first step moves each element by the rate times the sign of its
    # gradient, so an element whose gradient is zero but for rounding steps
    # either way in any two runs: the updated parameters are held together.
    _l2_gate(flat(got_p), flat(want_p[0]), flat(want_p[1]), "updated parameters")


def _l2_gate(got, jax_bf16, jax_fp32, label, rel_floor=0.0) -> float:
    """The L2 distance to JAX's bf16 within ``FACTOR`` x the L2 yardstick,
    itself at least ``rel_floor`` x the fp32 value's norm; returns the
    yardstick relative to that norm."""
    got, want, ref = (np.asarray(a, np.float64) for a in (got, jax_bf16, jax_fp32))
    yard = max(np.linalg.norm(want - ref), rel_floor * np.linalg.norm(ref))
    dist = np.linalg.norm(got - want)
    assert dist <= FACTOR * yard, f"{label}: {dist:.3e} from JAX bf16, yardstick {yard:.3e}"
    return yard / np.linalg.norm(ref)


# ---- the entry points -------------------------------------------------------------

def test_run_experiment_bf16_end_to_end(tmp_path):
    """``run_experiment(ExperimentConfig(mode="paper", dtype="bfloat16"))``
    at the tiny size: training, the validation MSE, ELBO/BPD and NLL, the
    reconstruction with its post metrics, the parameter grid, the guidance
    sweep and the sensitivity rows, all in bf16, with the fp32 run's
    artifacts and finite numbers."""
    tiny = dict(lrate=1e-3, n_epoch=1, timesteps=4, num_params=3, n_feat=8, height=16,
                data_size=32, synthetic_param_sets=4, batch_size=8, n_eval_images=2,
                eval_batch_size=8, nll_subset=8, elbo_subset=8)
    runs = {d: experiment.run_experiment(
        ExperimentConfig(mode="paper", output_root=str(tmp_path / d), dtype=d, **tiny),
        device="cpu") for d in ("bfloat16", "float32")}
    res = runs["bfloat16"]

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    assert files(res["output_dir"]) == files(runs["float32"]["output_dir"])
    assert set(res) == set(runs["float32"])
    metrics = [res["recon_metrics"], res["grid_metrics"], *res["guidance_metrics"]]
    assert all(np.isfinite([m["elbo"], m["bpd"], m["nll"]]).all() for m in metrics)
    assert np.isfinite(res["loss_log"] + res["val_loss_log"]).all()
    assert res["loss_log"] != runs["float32"]["loss_log"]  # it did compute in bf16
    weights = load_variables(os.path.join(res["output_dir"], "weights", "train_state.msgpack"))
    assert all(np.asarray(v).dtype == np.float32
               for v in jax.tree_util.tree_leaves(weights))


def test_load_model_bf16_keeps_fp32_where_it_must(narrow):
    """``load_model(..., dtype=torch.bfloat16)``: unfolded, every parameter
    and running statistic stays fp32 (training's masters); folded, the conv
    and dense weights are bf16 copies and the GroupNorms' stay fp32 (K2
    takes them so), and the model computes what a folded bf16 model on fp32
    parameters computes, exactly."""
    variables, _, folded = narrow["canonical"]
    unfolded = load_model(variables, "cpu", fold_bn=False, dtype=torch.bfloat16)
    assert unfolded.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in unfolded.state_dict().values()
               if t.is_floating_point())
    dtypes = {n: p.dtype for n, p in folded.named_parameters()}
    assert {d for n, d in dtypes.items() if "_norm." in n} == {torch.float32}
    assert {d for n, d in dtypes.items() if "_norm." not in n} == {torch.bfloat16}
    cast_at_use = ContextUnet.canonical(n_feat=NF, height=H, fold_bn=True,
                                        dtype=torch.bfloat16).eval()
    cast_at_use.load_state_dict(from_jax_variables(fold_batchnorm_variables(variables)))
    x, t, c = (torch.tensor(a) for a in _model_inputs("canonical"))
    with torch.no_grad():
        assert torch.equal(folded(x, t, c), cast_at_use(x, t, c))
    with pytest.raises(ValueError, match="bfloat16"):
        ContextUnet(dtype=torch.float16)


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_port_golden.npz")
GOLDEN_BF16 = GOLDEN.replace(".npz", "_bf16.npz")
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts",
                    "certification", "model", "train_state.msgpack")


@pytest.mark.parametrize("which", ["eps", "eps_uncond", "cfg_pair"])
def test_full_width_bf16_forward_matches_the_bf16_golden(which):
    """The committed checkpoint folded in bf16 at full width on the CPU,
    against JAX's folded bf16 of ``torch_port_golden_bf16.npz``, gated by
    that file's own yardstick (JAX's bf16 against its fp32: 2.4e-2)."""
    d, g = np.load(GOLDEN), np.load(GOLDEN_BF16)
    model = load_model(load_variables(CKPT), "cpu", dtype=torch.bfloat16)
    x, t, c = (torch.tensor(d[k]) for k in ("x", "t", "c"))
    with torch.no_grad():
        if which == "cfg_pair":
            enc = model.encode(x).doubled()
            cemb1, cemb2 = model.context_embed(torch.cat([c, torch.zeros_like(c)]))
            temb1, temb2 = model.time_embed(torch.cat([t, t]))
            got = model.decode(enc, film=(cemb1, temb1, cemb2, temb2))
            want = [np.concatenate([g[f"eps_{k}"], g[f"eps_uncond_{k}"]]) for k in ("bf16", "fp32")]
        else:
            got = model(x, t, c if which == "eps" else torch.zeros_like(c))
            want = [g[f"{which}_{k}"] for k in ("bf16", "fp32")]
    assert got.dtype == torch.bfloat16
    gate(got, *want)


def test_bf16_out_conv2_rounds_once_as_the_step_kernel_does():
    """In bf16, ``out_conv2`` sums the exact products of its bf16 operands
    in fp32 and rounds once with its bias, as K1's plain version does: the
    likelihood passes' eps is the samplers' eps, exactly."""
    from camels_diffusion_model_tpu_torch.models.blocks import OutputConv2d

    g = torch.Generator().manual_seed(12)
    conv = OutputConv2d(16, 1, 3, padding=1, compute_dtype=torch.bfloat16)
    h = torch.randn(2, 16, 8, 8, generator=g)
    with torch.no_grad():
        eps = conv(h)
    x, z = torch.randn(2, 8, 8, 1, generator=g), torch.randn(2, 8, 8, 1, generator=g)
    weight, bias = conv.weight.detach().bfloat16(), conv.bias.detach().bfloat16()
    want = head_step_plain(h.permute(0, 2, 3, 1).bfloat16(), weight, bias, x, z, 0.3, 1.1, 0.2)
    assert eps.dtype == torch.bfloat16
    assert torch.equal((x - eps.permute(0, 2, 3, 1).float() * 0.3) * 1.1 + 0.2 * z, want)
