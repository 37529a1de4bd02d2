"""Reverse-step kernel K1: output conv + CFG combine + ancestral/strided
update.

Wraps ``csrc/head_step.cu``, the counterpart of the Pallas
``fused_p_sample_step`` (``camels_diffusion_model_tpu/ops/pallas/
sampler_step.py:34``) with the decoder's last layer folded in: the kernel
takes out_norm's features and the 3x3 ``out_conv2`` weights, so eps is
computed in registers and never goes to device memory.  One launch per
reverse step of ``sample_ddpm`` and of ``sample_ddim``.  With ``tanh=True``
(the deep and big variants, ``context_unet.py:315-316``) eps is the tanh of
the conv, per branch before the guidance combine.
:func:`launch_plan` chooses the kernel's geometry.

On a height shard of a spatial mesh ``out_conv2`` reads one row beyond
the shard on each side: ``halo=(top, bottom)`` gives those rows of ``h``
(None for a side at the image's edge, which stays zero padding), and the
kernel's halo mode copies a band's row -1 or H from them (counts
``.launches_halo`` and ``.launches_halo_bf16``).  The halo mode is the
bf16 kernel's in bf16 (``c`` a multiple of 8; its narrow item counted
also under ``.launches_halo_narrow_bf16``, and where its last channel
block is masked also under ``.launches_halo_masked_bf16``), and in fp32 a
kernel of its own (``csrc/head_step.cu``, ``head_step_halo_f32_kernel``: the bf16
kernel's warp-private rings, the taps on the CUDA cores in fp32) under
:func:`halo_plan`; other widths take the float kernel's halo mode
(:func:`route`), counted also under ``.launches_halo_generic`` and
``.launches_halo_generic_bf16``.

Two instances by the features' dtype: float32, and bfloat16 for the bf16
model (``h``, the weights and the bias in bf16, eps rounded to bf16 as the
JAX program rounds it; ``x``, ``z`` and the step fp32), each with its own
launch count (``fused_head_step.launches`` and ``.launches_bf16``).  The
bf16 unsharded launch is a kernel of its own (``csrc/head_step.cu``,
``head_step_bf16_kernel``): the nine per-tap partials of a band as one
product on the tensor cores (``mma.sync`` m16n8k16, bf16 in, fp32 sums),
each warp streaming its tiles of ``h`` through a ring of its own in
shared memory; :func:`bf16_plan` chooses its band height.  Where ``c``
is a multiple of 8 but not of 64 (n_feat 8-56, 72, 96, 160, 264, ...)
the same kernel runs at its narrow item, 32 channels
(``BF16_NARROW_NAME``, counted under ``.launches_bf16`` and also under
``.launches_narrow_bf16``); where ``c`` is not a multiple of 32 its last
channel block is masked past ``c`` (counted also under
``.launches_masked_bf16``).  Where that plan refuses a shape (weights
over its shared memory, ``c`` in the thousands), the bf16 unsharded
launch takes the float kernel's bf16 instance instead (:func:`route`),
counted also under ``.launches_generic_bf16``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_CTAS = 128  # about one per SM
SM_SMEM = 228 * 1024  # shared memory of one SM; each CTA also takes 1 KB
MAX_THREADS = 384  # a CTA: at the kernel's most registers (164 a thread,
#                    32-channel chunks) 384 threads fill an SM's 64K
SMEM_MAX = 227 * 1024  # the dynamic shared memory a CTA may ask for
ROWS = (4, 2, 1)  # band heights, tallest (least halo) first
CHUNKS = (32, 16, 8, 4)  # fp32 channels per staged chunk, widest first;
#                          below 16 only when nothing wider divides C:
#                          narrower chunks read slower at every path batch,
#                          even with more CTAs resident.  A bf16 chunk
#                          holds twice the channels in the same bytes.
STAGES = (3, 2)  # depths of the ring of shared-memory stages
ROWS_BF16 = (8, 4, 2, 1)  # band heights of the bf16 kernel
BF16_RING = 3  # slots of each warp's ring in the bf16 kernel (csrc RING)
BF16_PER_SM = 2  # CTAs of the bf16 kernel an SM runs at once
BF16_THREADS = 256  # a CTA of the bf16 kernel: 8 warps
BF16_TILE = 16  # pixels of a warp's item (the MMA's 16 rows)
BF16_BLOCK = 64  # channels of an item: 128 bytes a pixel, 8 copies of 16
BF16_NARROW_BLOCK = 32  # the narrow item's (c not a multiple of 64): 32 pixels of 64 bytes
ROWS_HALO = (8, 4, 2, 1)  # band heights of the fp32 halo kernel
HALO_THREADS = 256  # a CTA of the fp32 halo kernel: 8 warps
HALO_TILE = 32  # pixels of a warp's tile: four a lane, 8 channels of each an item
HALO_CK = 32  # fp32 channels of an item: a pixel's 128-byte line, 8 copies of 16
HALO_RING = 2  # slots of each warp's ring (csrc F32_RING)
HALO_PER_SM = 2  # CTAs of the fp32 halo kernel an SM runs at once
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}  # the instances' feature types
C_NAME = "camels_head_step"  # the float unsharded launch
BF16_NAME = "camels_head_step_bf16"  # the bf16 unsharded launch (bf16_plan)
BF16_NARROW_NAME = "camels_head_step_bf16_narrow"  # ... at the narrow item
BF16_GENERIC_NAME = "camels_head_step_bf16_generic"  # the float kernel's bf16 instance
HALO_NAMES = {torch.float32: "camels_head_step_halo",  # halo_plan
              torch.bfloat16: "camels_head_step_halo_bf16"}  # bf16_plan
HALO_NARROW_NAME = "camels_head_step_halo_bf16_narrow"  # bf16_plan at the narrow item
# The float kernel's halo mode (launch_plan), where the kernels above refuse.
HALO_GENERIC_NAMES = {torch.float32: "camels_head_step_halo_generic",
                      torch.bfloat16: "camels_head_step_halo_generic_bf16"}

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
)
_HALO_ARGTYPES = _ARGTYPES[:1] + (ctypes.c_void_p,) * 2 + _ARGTYPES[1:]  # top, bottom after h
_BF16_ARGTYPES = _ARGTYPES[:14] + _ARGTYPES[16:]  # no ck, stages
_BAND_HALO_ARGTYPES = _HALO_ARGTYPES[:16] + _HALO_ARGTYPES[18:]  # halo_plan's, bf16_plan's


def guided_eps(eps, guide_w, tanh: bool = False):
    """The model's eps in its dtype: with ``tanh`` its tanh, then, when
    ``guide_w`` (a float or a ``(B,)`` tensor) is given, the combine
    ``eps_u + w * (eps_c - eps_u)`` of the stacked ``[cond; uncond]`` halves
    with ``w`` cast to eps's dtype (``sampler.py:137-141``): in bf16 each
    operation rounds."""
    if tanh:
        eps = torch.tanh(eps)
    if guide_w is None:
        return eps
    eps_c, eps_u = eps.chunk(2)
    if torch.is_tensor(guide_w):
        w = guide_w.to(eps.dtype).reshape((-1,) + (1,) * (eps.dim() - 1))
    else:  # a Python number stays on the host
        w = torch.tensor(float(guide_w), dtype=torch.float32).to(eps.dtype).item()
    return eps_u + w * (eps_c - eps_u)


def sampler_step_plain(x, eps, z, c_eps, inv_sqrt_a, sigma, guide_w=None,
                       tanh: bool = False):
    """The step in plain PyTorch, the counterpart of the JAX
    ``fused_p_sample_step`` / ``p_sample_step`` with the guidance combine.

    ``eps`` is ``(B, ...)``, or ``(2B, ...)`` stacked ``[cond; uncond]`` when
    ``guide_w`` (a float or a ``(B,)`` tensor) is given: :func:`guided_eps`
    in eps's dtype, then cast to ``x``'s (``sampler.py:264-276``).
    ``tanh`` takes the tanh of ``eps`` first (the model's output layer).
    ``z`` may be None only when ``sigma`` is 0.
    """
    if z is None and sigma != 0.0:
        raise ValueError("z may be omitted only when sigma == 0")
    eps = guided_eps(eps, guide_w, tanh).to(x.dtype)
    out = (x - eps * c_eps) * inv_sqrt_a
    if z is not None:
        out = out + sigma * z
    return out


def halo_buffer(h, halo):
    """``(2, N, W, C)`` in ``h``'s dtype: the rows above and below the
    shard ``h`` ``(N, H, W, C)`` from ``halo=(top, bottom)`` (each ``(N,
    W, C)`` or ``(N, 1, W, C)``; None: zeros)."""
    n, _, w, c = h.shape
    rows = [h.new_zeros((n, w, c)) if r is None else r.reshape(n, w, c) for r in halo]
    return torch.stack(rows).to(h.dtype).contiguous()


def head_step_plain(h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, guide_w=None,
                    tanh: bool = False, halo=None):
    """The kernel's function in plain PyTorch: eps = the 3x3 conv
    (``weight`` ``(1, C, 3, 3)``, ``bias`` ``(1,)``, zero padding) of the
    NHWC features ``h``, then :func:`sampler_step_plain`.  In bf16 the conv
    sums the exact products of its bf16 operands in fp32 and rounds once,
    with the bias, to bf16, as the kernel does.  ``halo=(top, bottom)``:
    the rows beyond the shard ``h`` take the place of the zero padding
    above and below it (:func:`halo_buffer`)."""
    padding = 1
    if halo is not None:
        rows = halo_buffer(h, halo)
        h = torch.cat([rows[0][:, None], h, rows[1][:, None]], dim=1)
        padding = (0, 1)
    eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(),
                   padding=padding).to(h.dtype).permute(0, 2, 3, 1)
    return sampler_step_plain(x, eps, z, c_eps, inv_sqrt_a, sigma, guide_w, tanh)


class Plan(NamedTuple):
    """The kernel's launch geometry for one input shape."""

    rows: int  # output rows of a CTA's band
    threads: int  # per CTA: two staged pixels each
    ck: int  # channels per staged chunk
    stages: int  # depth of the ring
    ctas: int
    smem_bytes: int  # dynamic shared memory per CTA


def staged_stride(ck: int, element_bytes: int = 4) -> int:
    """Elements between two staged pixels: an odd number of 16-byte slots,
    so 8 threads on 8 pixels hit 8 bank groups."""
    per_slot = 16 // element_bytes
    v = ck // per_slot
    return per_slot * (v + (1 if v % 2 == 0 else 2))


def launch_plan(units: int, height: int, width: int, c: int, cout: int = 1,
                cfg: bool = True, aligned: bool = True, sms: int = SMS,
                element_bytes: int = 4) -> Plan:
    """Geometry of :func:`fused_head_step` for ``units`` CTA units (sample
    pairs under ``cfg``, else samples) of ``height`` x ``width`` pixels of
    ``c`` channels of ``element_bytes`` each (4 fp32, 2 bf16) on a card of
    ``sms`` SMs.

    A CTA stages its band's ``rows + 2`` rows, two pixels a thread, in
    chunks of ``ck`` channels (``CHUNKS``, or twice them in bf16: the same
    bytes).  The band is the tallest of ``ROWS`` within
    ``MAX_THREADS`` threads whose grid still has ``MIN_CTAS`` CTAs (else
    the shortest; under CFG at width 128, one row).  The chunk is the one
    dividing ``c`` (64 bytes or more where ``c`` allows)
    that lets the most of the CTAs an SM has to run be resident at once,
    the widest on a tie; the ring the deepest of ``STAGES`` that fits in
    shared memory.  Raises ``ValueError`` for a
    shape no path takes: ``cout != 1``, ``c`` not a multiple of one 16-byte
    copy (4 fp32, 8 bf16), a pointer off a
    16-byte boundary (``aligned``), an odd ``width`` without CFG, or a band
    over ``MAX_THREADS`` threads or shared memory.
    """
    if cout != 1:
        raise ValueError(f"the head kernel computes one output channel, not {cout}")
    per_copy = 16 // element_bytes
    if c <= 0 or c % per_copy:
        raise ValueError(f"the head kernel needs channels % {per_copy} == 0, got {c}")
    if not aligned:
        raise ValueError("the head kernel needs 16-byte aligned features")
    if not cfg and width % 2:
        raise ValueError(f"without CFG the head kernel needs an even width, got {width}")
    def band_threads(r):
        return (r + 2) * width // (1 if cfg else 2)

    fits = [r for r in ROWS if band_threads(r) <= MAX_THREADS] or ROWS[-1:]
    rows = next((r for r in fits if units * -(-height // r) >= MIN_CTAS), fits[-1])
    threads = band_threads(rows)
    ctas = units * -(-height // rows)
    widths = [ck * 4 // element_bytes for ck in CHUNKS if c % (ck * 4 // element_bytes) == 0]
    best, best_resident = None, 0
    for ck in [ck for ck in widths if ck * element_bytes >= 64] or widths[:1]:
        for stages in STAGES:
            smem = 4 * 9 * c + element_bytes * stages * 2 * threads * staged_stride(
                ck, element_bytes)
            if smem <= SMEM_MAX:
                resident = min(SM_SMEM // (smem + 1024), -(-ctas // sms))
                if resident > best_resident:
                    best, best_resident = Plan(rows, threads, ck, stages, ctas, smem), resident
                break
    if threads > MAX_THREADS or best is None:
        raise ValueError(f"a band of {rows} x {width} pixels x {c} channels takes no path")
    return best


class Bf16Plan(NamedTuple):
    """The bf16 kernel's launch geometry for one input shape."""

    rows: int  # output rows of a CTA's band
    threads: int  # per CTA
    ctas: int
    smem_bytes: int  # dynamic shared memory per CTA: weights, rings, partials
    block: int = BF16_BLOCK  # channels of an item: BF16_BLOCK or BF16_NARROW_BLOCK


def weight_stride(c: int) -> int:
    """bf16 elements between two taps' weight rows in the bf16 kernel's
    shared memory: 4 mod 8 16-byte slots, so a quarter warp's 2 taps x 4
    chunks hit 8 bank groups, for the ``c`` staged channels, a multiple of
    32 (:func:`staged_channels`): ``c + 32`` where ``c`` is a multiple of
    64, ``c`` where it is an odd multiple of 32 (``c / 8`` is then 4 mod 8
    slots)."""
    return c + 32 if c % 64 == 0 else c


def staged_channels(c: int) -> int:
    """The channels the bf16 kernel stages a pixel: ``c`` where it is a
    multiple of 64 (the wide item), else ``c`` rounded up to the narrow
    item's 32-channel blocks, the last one masked past ``c``."""
    return c if c % BF16_BLOCK == 0 else -(-c // BF16_NARROW_BLOCK) * BF16_NARROW_BLOCK


def partial_stride(m: int) -> int:
    """Floats between two taps' partials of ``m`` band pixels: 4 mod 32, so
    the 4 taps a warp stores at once sit 4 banks apart."""
    return -(-m // 32) * 32 + 4


def bf16_plan(units: int, height: int, width: int, c: int, cout: int = 1,
              cfg: bool = True, aligned: bool = True, sms: int = SMS) -> Bf16Plan:
    """Geometry of the bf16 :func:`fused_head_step` for ``units`` CTA units
    (sample pairs under ``cfg``, else samples) of ``height`` x ``width``
    pixels of ``c`` channels on a card of ``sms`` SMs.

    A CTA takes a band of ``rows`` output rows and multiplies its ``rows +
    2`` rows of ``h`` (each branch's) by the weights, each warp its
    ``BF16_TILE``-pixel tiles ``BF16_BLOCK`` channels an item through a
    ring of its own, ``BF16_RING`` deep; where ``c`` is not a multiple of
    64 (n_feat 32, 96, 160; 40, 264, ...) the narrow item, two tiles of
    ``BF16_NARROW_BLOCK`` channels (the same 2 KiB), ``ceil(c / 32)``
    blocks a pixel, the last masked past ``c`` where ``c`` is not a
    multiple of 32 (its weights staged as rows of :func:`staged_channels`
    channels, zero past ``c``).  The band is the shortest of ``ROWS_BF16`` whose grid still fits
    ``BF16_PER_SM`` CTAs an SM, so the grid is one wave and each SM
    streams for two CTAs (one's gather over the other's copies), else the
    tallest.  Raises ``ValueError`` for a shape no path takes: ``cout !=
    1``, ``c`` not a multiple of 8 (one 16-byte copy), a pointer off a
    16-byte boundary (``aligned``), or a band over shared memory (weights
    of over ~5600 channels).
    """
    if cout != 1:
        raise ValueError(f"the head kernel computes one output channel, not {cout}")
    if c <= 0 or c % 8:
        raise ValueError(f"the bf16 head kernel needs channels % 8 == 0, got {c}")
    if not aligned:
        raise ValueError("the head kernel needs 16-byte aligned features")
    block = BF16_BLOCK if c % BF16_BLOCK == 0 else BF16_NARROW_BLOCK

    def smem(rows):  # an item is 2 KiB at either width
        m = (2 if cfg else 1) * (rows + 2) * width
        return (2 * 16 * weight_stride(staged_channels(c)) + 2 * BF16_THREADS // 32 * BF16_RING
                * BF16_TILE * BF16_BLOCK + 4 * 9 * partial_stride(m))

    ordered = sorted(ROWS_BF16)  # shortest first
    rows = next((r for r in ordered if units * -(-height // r) <= BF16_PER_SM * sms),
                ordered[-1])
    if smem(rows) > SMEM_MAX:
        raise ValueError(f"a band of {rows} x {width} pixels x {c} channels takes no path")
    return Bf16Plan(rows, BF16_THREADS, units * -(-height // rows), smem(rows), block)


class HaloPlan(NamedTuple):
    """The fp32 halo kernel's launch geometry for one input shape."""

    rows: int  # output rows of a CTA's band
    threads: int  # per CTA
    ctas: int
    smem_bytes: int  # dynamic shared memory per CTA: weights, rings, partials


def halo_plan(units: int, height: int, width: int, c: int, cout: int = 1,
              cfg: bool = True, aligned: bool = True, sms: int = SMS) -> HaloPlan:
    """Geometry of the fp32 :func:`fused_head_step` with ``halo`` for
    ``units`` CTA units (sample pairs under ``cfg``, else samples) of
    ``height`` x ``width`` pixels of ``c`` channels on a card of ``sms``
    SMs.

    A CTA of ``HALO_THREADS`` threads takes a band of ``rows`` output rows
    and reduces its ``rows + 2`` rows of ``h`` (each branch's), each warp
    its ``HALO_TILE``-pixel tiles ``HALO_CK`` channels (a pixel's 128-byte
    line) an item through a ring of its own, ``HALO_RING`` deep; its shared
    memory holds the weights (rows of ``c`` rounded up to ``HALO_CK``), the
    rings and the band's partials.  The band is the shortest of
    ``ROWS_HALO`` whose grid is one wave of the CTAs an SM holds (at most
    ``HALO_PER_SM``: one CTA's gather runs beside another's copies), else
    the tallest that fits.  Raises ``ValueError`` for a shape it does not take:
    ``cout != 1``, ``c`` not a multiple of one 16-byte copy (4), a pointer
    off a 16-byte boundary (``aligned``), or no band whose shared memory
    fits (weights of over ~3700 channels).
    """
    if cout != 1:
        raise ValueError(f"the head kernel computes one output channel, not {cout}")
    if c <= 0 or c % 4:
        raise ValueError(f"the fp32 halo kernel needs channels % 4 == 0, got {c}")
    if not aligned:
        raise ValueError("the head kernel needs 16-byte aligned features")

    def smem(rows):
        m = (2 if cfg else 1) * (rows + 2) * width
        return 4 * (9 * -(-c // HALO_CK) * HALO_CK
                    + HALO_THREADS // 32 * HALO_RING * HALO_TILE * HALO_CK
                    + 9 * -(-m // HALO_TILE) * HALO_TILE)

    fits = [r for r in sorted(ROWS_HALO) if smem(r) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"a band of {width} pixels x {c} channels takes no fp32 halo plan")
    rows = next((r for r in fits if units * -(-height // r) <= sms * min(
        HALO_PER_SM, SM_SMEM // (smem(r) + 1024))), fits[-1])
    return HaloPlan(rows, HALO_THREADS, units * -(-height // rows), smem(rows))


def route(units: int, height: int, width: int, c: int, dtype, cout: int = 1,
          cfg: bool = True, aligned: bool = True, halo: bool = False,
          sms: int = SMS) -> tuple:
    """``(C name, plan)`` of :func:`fused_head_step`'s launch for features
    of ``dtype`` (arguments as :func:`launch_plan`'s): for float32 the
    float kernel, with ``halo`` the fp32 halo kernel under
    :func:`halo_plan`; for bfloat16 the bf16 kernel (with ``halo`` its
    halo mode) under :func:`bf16_plan`, at the narrow item where ``c`` is
    a multiple of 8 but not of 64 (``BF16_NARROW_NAME``,
    ``HALO_NARROW_NAME``).  Where that plan refuses the shape, the float
    kernel's instance of ``dtype`` under :func:`launch_plan`
    (``BF16_GENERIC_NAME``, with ``halo`` ``HALO_GENERIC_NAMES``): in bf16
    exactly the shapes whose weights overflow :func:`bf16_plan`'s shared
    memory and fit :func:`launch_plan`'s (``c`` a multiple of 8 from about
    5600 channels at width 8; no model's), in fp32 with ``halo`` those
    over :func:`halo_plan`'s (from about 3700).  An unaligned pointer, a
    ``c`` not a multiple of one 16-byte copy or ``cout != 1`` take no
    kernel.  A function of the shape, the dtype and the alignment alone,
    chosen before the launch; raises ``ValueError`` where no kernel takes
    the shape."""
    args = (units, height, width, c, cout, cfg, aligned, sms)
    if dtype != torch.bfloat16 and not halo:
        return C_NAME, launch_plan(*args)
    own, generic = ((HALO_NAMES[dtype], HALO_GENERIC_NAMES[dtype]) if halo
                    else (BF16_NAME, BF16_GENERIC_NAME))
    try:
        plan = (bf16_plan if dtype == torch.bfloat16 else halo_plan)(*args)
    except ValueError:
        return generic, launch_plan(*args, ELEMENT_BYTES[dtype])
    if isinstance(plan, Bf16Plan) and plan.block == BF16_NARROW_BLOCK:
        return (HALO_NARROW_NAME if halo else BF16_NARROW_NAME), plan
    return own, plan


def fused_head_step(h, weight, bias, x, z, c_eps: float, inv_sqrt_a: float,
                    sigma: float, guide_w=None, tanh: bool = False, halo=None):
    """``(x - c_eps*e)*inv_sqrt_a + sigma*z`` with ``e`` the (guided) output
    of the 3x3 conv ``weight`` ``(1, C, 3, 3)``, ``bias`` ``(1,)`` over the
    NHWC features ``h`` (its tanh per branch with ``tanh=True``):
    ``(B, H, W, C)``, or ``(2B, H, W, C)`` stacked ``[cond; uncond]`` when
    ``guide_w`` (a float or a ``(B,)`` tensor) is given.  ``h``, ``weight``
    and ``bias`` are float32, or all bfloat16 (the bf16 model); ``x``,
    ``z`` ``(B, H, W, 1)`` and a per-sample ``guide_w`` float32; ``z`` may
    be None only when ``sigma`` is 0.  ``halo=(top, bottom)``: the rows of
    the neighbouring height shards (module docstring), ``(N, W, C)`` or
    ``(N, 1, W, C)`` of ``h``'s dtype, None at the image's edge.

    On CUDA tensors this launches the kernel of ``h``'s dtype, and raises
    for another dtype or where autograd would record the call
    (:func:`_build.refuse_autograd`); on CPU tensors it runs
    :func:`head_step_plain`.
    """
    if z is None and sigma != 0.0:
        raise ValueError("z may be omitted only when sigma == 0")
    if h.device.type == "cpu":
        return head_step_plain(h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, guide_w,
                               tanh, halo)
    if h.device.type != "cuda":
        raise ValueError(f"fused_head_step: unsupported device {h.device}")
    if h.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"h must be NHWC and weight (1, C, 3, 3), got "
                         f"{tuple(h.shape)} and {tuple(weight.shape)}")
    cfg = guide_w is not None
    b = x.shape[0]
    nd, height, width, c = h.shape
    if tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"weight must be (1, {c}, 3, 3), got {tuple(weight.shape)}")
    # Tap-major (9, C) weights: a view of the channels_last weight the model
    # holds, a small copy otherwise.
    wt = weight[0].permute(1, 2, 0).reshape(9, c).contiguous()
    tensors = {"h": h, "bias": bias, "x": x, "weight": wt}
    if halo is not None:
        for side, r in zip(("top", "bottom"), halo):
            if r is None:
                continue
            if r.numel() != nd * width * c:
                raise ValueError(f"fused_head_step: a halo row must be ({nd}, {width}, {c}) "
                                 f"of {_build.type_name(h.dtype)} on {h.device}")
            tensors[side] = r.reshape(nd, width, c).contiguous()  # no copy: halo_rows gives views
    if z is not None:
        tensors["z"] = z
    w_vec = None
    if cfg and torch.is_tensor(guide_w):
        w_vec = guide_w
        tensors["guide_w"] = w_vec
        if tuple(w_vec.shape) != (b,):
            raise ValueError(f"per-sample guide_w must be ({b},), got {tuple(w_vec.shape)}")
    if h.dtype not in ELEMENT_BYTES:
        raise ValueError(f"fused_head_step: no kernel for {h.dtype}; float32 or bfloat16")
    for name, t in tensors.items():
        dtype = h.dtype if name in ("h", "bias", "weight", "top", "bottom") else torch.float32
        if t.device != h.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"fused_head_step: {name} must be a contiguous {_build.type_name(dtype)} "
                f"tensor on {h.device}"
            )
    if h.numel() >= 2**31:  # the kernel's offsets into h are 32-bit
        raise ValueError(f"h of {h.numel()} elements is too large for the head kernel")
    if nd != (2 * b if cfg else b):
        raise ValueError(f"h must hold {2 * b if cfg else b} samples, got {nd}")
    if tuple(x.shape) != (b, height, width, 1) or bias.shape != (1,):
        raise ValueError(f"x must be {(b, height, width, 1)} and bias (1,), got "
                         f"{tuple(x.shape)} and {tuple(bias.shape)}")
    if z is not None and z.shape != x.shape:
        raise ValueError(f"z must be {tuple(x.shape)}, got {tuple(z.shape)}")
    _build.refuse_autograd("fused_head_step", h, weight, *tensors.values())
    aligned = all(tensors[k].data_ptr() % 16 == 0 for k in ("h", "weight", "top", "bottom")
                  if k in tensors)
    name, plan = route(b, height, width, c, h.dtype, weight.shape[0], cfg, aligned,
                       halo is not None,
                       torch.cuda.get_device_properties(h.device).multi_processor_count)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    band = not isinstance(plan, Plan)  # a kernel of its own: no ck, stages
    fn = _build.kernel(name, (_BAND_HALO_ARGTYPES if band else _HALO_ARGTYPES)
                       if halo is not None else _BF16_ARGTYPES if band else _ARGTYPES)
    geometry = (plan.threads,) if band else (plan.ck, plan.stages, plan.threads)
    rows = (tuple(tensors[k].data_ptr() if k in tensors else None for k in ("top", "bottom"))
            if halo is not None else ())
    err = fn(
        h.data_ptr(), *rows, wt.data_ptr(), bias.data_ptr(), x.data_ptr(),
        z.data_ptr() if z is not None else None,
        w_vec.data_ptr() if w_vec is not None else None,
        float(guide_w) if cfg and w_vec is None else 0.0,
        out.data_ptr(), b, height, width, c, plan.rows, int(cfg), *geometry,
        plan.smem_bytes, float(c_eps), float(inv_sqrt_a), float(sigma), int(tanh),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, name)
    mode = "_halo" if halo is not None else ""
    suffix = "_bf16" if h.dtype == torch.bfloat16 else ""
    count = f"launches{mode}{suffix}"
    setattr(fused_head_step, count, getattr(fused_head_step, count) + 1)
    kinds = (["_generic"] if name == BF16_GENERIC_NAME or name in HALO_GENERIC_NAMES.values()
             else ["_narrow"] + (["_masked"] if c % BF16_NARROW_BLOCK else [])
             if name in (BF16_NARROW_NAME, HALO_NARROW_NAME) else [])
    for kind in kinds:
        count = f"launches{mode}{kind}{suffix}"
        setattr(fused_head_step, count, getattr(fused_head_step, count) + 1)
    return out


fused_head_step.launches = 0
fused_head_step.launches_bf16 = 0  # every bf16 unsharded launch
fused_head_step.launches_narrow_bf16 = 0  # those of them that took BF16_NARROW_NAME
fused_head_step.launches_masked_bf16 = 0  # ... with a last channel block masked past c
fused_head_step.launches_generic_bf16 = 0  # those of them that took BF16_GENERIC_NAME
fused_head_step.launches_halo = 0  # every fp32 halo launch
fused_head_step.launches_halo_generic = 0  # those of them that took the float kernel
fused_head_step.launches_halo_bf16 = 0  # every bf16 halo launch
fused_head_step.launches_halo_narrow_bf16 = 0  # those of them that took HALO_NARROW_NAME
fused_head_step.launches_halo_masked_bf16 = 0  # ... with a last channel block masked past c
fused_head_step.launches_halo_generic_bf16 = 0  # those of them that took the float kernel
