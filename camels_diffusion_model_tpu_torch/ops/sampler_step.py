"""Reverse-step kernel K1: output conv + CFG combine + ancestral/strided
update.

Wraps ``csrc/head_step.cuh`` (built by ``csrc/head_step.cu`` and
``csrc/head_step_cout<N>.cu``), the counterpart of the Pallas
``fused_p_sample_step`` (``camels_diffusion_model_tpu/ops/pallas/
sampler_step.py:34``) with the decoder's last layer folded in: the kernel
takes out_norm's features and the 3x3 ``out_conv2`` weights, so eps is
computed in registers and never goes to device memory.  One launch per
reverse step of ``sample_ddpm`` and of ``sample_ddim``.  With ``tanh=True``
(the deep and big variants, ``context_unet.py:315-316``) eps is the tanh of
the conv, per branch before the guidance combine.
:func:`launch_plan` chooses the kernel's geometry.

The conv goes to ``cout`` output channels, the model's ``in_channels``
(``x``, ``z`` and the step ``(B, H, W, cout)``): every kernel takes the
output channels of a group (:func:`out_groups`: at most ``COUT_MAX``,
compiled in) per CTA and reduces ``h`` once for all of them; more
channels go in equal groups over the grid.  Every plan takes ``cout`` and
sizes its weights and partials by the group.

On a height shard of a spatial mesh ``out_conv2`` reads one row beyond
the shard on each side: ``halo=(top, bottom)`` gives those rows of ``h``
(None for a side at the image's edge, which stays zero padding), and the
kernel's halo mode copies a band's row -1 or H from them (counts
``.launches_halo`` and ``.launches_halo_bf16``).  The halo mode is the
bf16 kernel's in bf16 (``c`` a multiple of 8; its narrow item counted
also under ``.launches_halo_narrow_bf16``, and where its last channel
block is masked also under ``.launches_halo_masked_bf16``), and in fp32 a
kernel of its own (``csrc/head_step.cuh``, ``head_step_halo_f32_kernel``: the bf16
kernel's warp-private rings, the taps on the CUDA cores in fp32) under
:func:`halo_plan`.

Two instances by the features' dtype: float32, and bfloat16 for the bf16
model (``h``, the weights and the bias in bf16, eps rounded to bf16 as the
JAX program rounds it; ``x``, ``z`` and the step fp32), each with its own
launch count (``fused_head_step.launches`` and ``.launches_bf16``).  The
bf16 unsharded launch is a kernel of its own (``csrc/head_step.cuh``,
``head_step_bf16_kernel``): the nine per-tap partials of a band as one
product on the tensor cores (``mma.sync`` m16n8k16, bf16 in, fp32 sums),
each warp streaming its tiles of ``h`` through a ring of its own in
shared memory; :func:`bf16_plan` chooses its band height.  Where ``c``
is a multiple of 8 but not of 64 (n_feat 8-56, 72, 96, 160, 264, ...)
the same kernel runs at its narrow item, 32 channels
(``BF16_NARROW_NAME``, counted under ``.launches_bf16`` and also under
``.launches_narrow_bf16``); where ``c`` is not a multiple of 32 its last
channel block is masked past ``c`` (counted also under
``.launches_masked_bf16``).

The fp32 unsharded launch at widths from ``BAND_WIDTH`` (the deep and big
variants' 128x128 maps) under CFG, or at up to ``BAND_NARROW_C`` channels
without, is a kernel of its own (``csrc/head_step.cuh``,
``head_step_f32_band_kernel``: the fp32 halo kernel's body with rows
outside the map zero, under :func:`halo_plan`), counted under
``.launches`` and also under ``.launches_band``.

Where a band kernel's plan refuses a shape (weights over its shared
memory, ``c`` in the thousands) or ``h`` has ``2**31`` elements or more,
either type and mode takes the split launch (:func:`route`,
:func:`split_plan`): the channel sum split over CTAs in ranges of
``SPLIT_SPAN`` channels, each writing its fp32 range sums to a workspace,
then a launch that sums them in range order, adds the bias and steps
(:func:`head_step_split_plain` is its arithmetic), counted also under
``.launches_split``, ``.launches_split_bf16``, ``.launches_halo_split``
and ``.launches_halo_split_bf16``.  Every launch at several output
channels is counted also under ``.launches_cout`` (``.launches_cout_bf16``,
``.launches_halo_cout``, ``.launches_halo_cout_bf16``).
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
MULTI_THREADS = 256  # ... at several output channels (csrc MULTI_THREADS: 18
#                      accumulators a channel, up to 255 registers)
COUT_MAX = 4  # output channels a CTA computes at most (csrc COUT_MAX)
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
SPLIT_SPAN = 128  # channels of a split launch's range (split_plan): a fixed
#                  number, so the ranges depend on c alone
SPLIT_PER_SM = 2  # CTAs of a split launch an SM runs at once
# Rows of a split launch's band by element bytes (bf16 4, fp32 2: the
# fastest of scripts/compare_torch_kernels.py --wide's sweep at 16 maps of
# 64x64; at 8x8 maps within 3% of it, where taller bands' 47-188 CTAs beat
# one-row bands' 188-376: a CTA's fixed cost holds those launches, and fp32
# bands of 2 rows skip half the taps).
SPLIT_ROWS = {2: 4, 4: 2}
C_NAME = "camels_head_step"  # the float unsharded launch
F32_BAND_NAME = "camels_head_step_f32_band"  # ... at widths from BAND_WIDTH (halo_plan)
BAND_WIDTH = 128  # where the template's band under CFG fits MAX_THREADS at one row only
# The band kernel's rows (scripts/compare_torch_kernels.py --variants' sweep at
# the deep and big steps, 10 maps): 2 at up to BAND_NARROW_C channels, 4 over
# them, where a band's rows staged again from L2 cost more than the CTAs
# two-row bands add (big under CFG: 0.2215 ms at 4 rows, 0.2462 at 2).
BAND_ROWS = {True: 2, False: 4}  # keyed by c <= BAND_NARROW_C
BAND_NARROW_C = 128
BF16_NAME = "camels_head_step_bf16"  # the bf16 unsharded launch (bf16_plan)
BF16_NARROW_NAME = "camels_head_step_bf16_narrow"  # ... at the narrow item
HALO_NAMES = {torch.float32: "camels_head_step_halo",  # halo_plan
              torch.bfloat16: "camels_head_step_halo_bf16"}  # bf16_plan
HALO_NARROW_NAME = "camels_head_step_halo_bf16_narrow"  # bf16_plan at the narrow item
# The split launch (split_plan), both modes, where the kernels above refuse.
SPLIT_NAMES = {torch.float32: "camels_head_step_split",
               torch.bfloat16: "camels_head_step_split_bf16"}

# h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, cout,
# rows, cfg, ck, stages, threads, smem_bytes, c_eps, inv_sqrt_a, sigma,
# tanh_out, the stream.
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
)
_BF16_ARGTYPES = _ARGTYPES[:15] + _ARGTYPES[17:]  # no ck, stages
# halo_plan's and bf16_plan's halo launches: top and bottom after h.
_BAND_HALO_ARGTYPES = _BF16_ARGTYPES[:1] + (ctypes.c_void_p,) * 2 + _BF16_ARGTYPES[1:]
# The split launch: h, top, bottom, wt, bias, x, z, w_per_sample, w, out,
# partials, batch, height, width, c, cout, rows, cfg, span, splits,
# threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, the stream.
_SPLIT_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_float,) + (ctypes.c_void_p,) * 2
                   + (ctypes.c_int,) * 11 + (ctypes.c_float,) * 3 + (ctypes.c_int, ctypes.c_void_p))


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


def _padded(h, halo):
    """``(h as NCHW fp32, padding)`` for the conv of :func:`head_step_plain`:
    with ``halo`` the rows beyond the shard stacked above and below ``h``
    and no padding of the height."""
    padding = 1
    if halo is not None:
        rows = halo_buffer(h, halo)
        h = torch.cat([rows[0][:, None], h, rows[1][:, None]], dim=1)
        padding = (0, 1)
    return h.permute(0, 3, 1, 2).float(), padding


def head_step_plain(h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, guide_w=None,
                    tanh: bool = False, halo=None):
    """The kernel's function in plain PyTorch: eps = the 3x3 conv
    (``weight`` ``(cout, C, 3, 3)``, ``bias`` ``(cout,)``, zero padding) of the
    NHWC features ``h``, then :func:`sampler_step_plain`.  In bf16 the conv
    sums the exact products of its bf16 operands in fp32 and rounds once,
    with the bias, to bf16, as the kernel does.  ``halo=(top, bottom)``:
    the rows beyond the shard ``h`` take the place of the zero padding
    above and below it (:func:`halo_buffer`)."""
    hf, padding = _padded(h, halo)
    eps = F.conv2d(hf, weight.float(), bias.float(),
                   padding=padding).to(h.dtype).permute(0, 2, 3, 1)
    return sampler_step_plain(x, eps, z, c_eps, inv_sqrt_a, sigma, guide_w, tanh)


def split_ranges(c: int) -> list:
    """The split launch's channel ranges ``[(c0, cs), ...]`` of ``c``
    channels: ``SPLIT_SPAN`` each, the last one shorter.  A function of
    ``c`` alone (never of the shard or the band), so two shards' launches
    sum each pixel's channels in the ranges of the whole map's."""
    return [(c0, min(SPLIT_SPAN, c - c0)) for c0 in range(0, c, SPLIT_SPAN)]


def head_step_split_plain(h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, guide_w=None,
                          tanh: bool = False, halo=None):
    """The split launch's arithmetic in plain PyTorch, arguments as
    :func:`head_step_plain`'s: each range of :func:`split_ranges`
    convolved without the bias in fp32 (in bf16 the exact products of the
    bf16 operands), the ranges' sums added in range order, then the bias,
    eps rounded to ``h``'s dtype, and :func:`sampler_step_plain`."""
    hf, padding = _padded(h, halo)
    wf = weight.float()
    total = None
    for c0, cs in split_ranges(h.shape[-1]):
        part = F.conv2d(hf[:, c0:c0 + cs], wf[:, c0:c0 + cs], padding=padding)
        total = part if total is None else total + part
    eps = (total + bias.float()[None, :, None, None]).to(h.dtype).permute(0, 2, 3, 1)
    return sampler_step_plain(x, eps, z, c_eps, inv_sqrt_a, sigma, guide_w, tanh)


def out_groups(cout: int) -> tuple:
    """``(groups, channels of a group)`` of the kernels' ``cout`` output
    channels: the fewest equal groups of at most ``COUT_MAX`` (a CTA's
    group, its template instance), the last one masked past ``cout``; 13
    channels go in 4 groups of 4.  Raises ``ValueError`` for ``cout < 1``."""
    if cout < 1:
        raise ValueError(f"the head kernel computes at least one output channel, not {cout}")
    groups = -(-cout // COUT_MAX)
    return groups, -(-cout // groups)


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
    ``c`` channels of ``element_bytes`` each (4 fp32, 2 bf16) to ``cout``
    output channels on a card of ``sms`` SMs.

    A CTA stages its band's ``rows + 2`` rows, two pixels a thread, in
    chunks of ``ck`` channels (``CHUNKS``, or twice them in bf16: the same
    bytes), for one group of :func:`out_groups` (the grid holds every
    band's groups).  The band is the tallest of ``ROWS`` within
    ``MAX_THREADS`` threads (``MULTI_THREADS`` at a group of several
    channels) whose grid still has ``MIN_CTAS`` CTAs (else
    the shortest; under CFG at width 128, one row).  The chunk is the one
    dividing ``c`` (64 bytes or more where ``c`` allows)
    that lets the most of the CTAs an SM has to run be resident at once,
    the widest on a tie (at several channels 64 bytes at most: their
    accumulators leave no registers for wider chunks); the ring the
    deepest of ``STAGES`` (2 at several channels) that fits in shared
    memory with the weights, and large enough to hold the partials.  Raises ``ValueError`` for a
    shape no path takes: ``cout < 1``, ``c`` not a multiple of one 16-byte
    copy (4 fp32, 8 bf16), a pointer off a
    16-byte boundary (``aligned``), an odd ``width`` without CFG, or a band
    over ``MAX_THREADS`` threads or shared memory.
    """
    groups, g = out_groups(cout)
    per_copy = 16 // element_bytes
    if c <= 0 or c % per_copy:
        raise ValueError(f"the head kernel needs channels % {per_copy} == 0, got {c}")
    if not aligned:
        raise ValueError("the head kernel needs 16-byte aligned features")
    if not cfg and width % 2:
        raise ValueError(f"without CFG the head kernel needs an even width, got {width}")
    def band_threads(r):
        return (r + 2) * width // (1 if cfg else 2)

    most = MAX_THREADS if g == 1 else MULTI_THREADS
    fits = [r for r in ROWS if band_threads(r) <= most] or ROWS[-1:]
    rows = next((r for r in fits if units * groups * -(-height // r) >= MIN_CTAS), fits[-1])
    threads = band_threads(rows)
    ctas = units * -(-height // rows) * groups
    widths = [ck * 4 // element_bytes for ck in (CHUNKS if g == 1 else CHUNKS[1:])
              if c % (ck * 4 // element_bytes) == 0]
    best, best_resident = None, 0
    for ck in [ck for ck in widths if ck * element_bytes >= 64] or widths[:1]:
        for stages in STAGES if g == 1 else STAGES[-1:]:
            # The ring, which the partials [9 * g][2 * threads] reuse at the end.
            ring = max(element_bytes * stages * 2 * threads * staged_stride(ck, element_bytes),
                       4 * 9 * g * 2 * threads)
            smem = 4 * 9 * g * c + ring
            if smem <= SMEM_MAX:
                resident = min(SM_SMEM // (smem + 1024), -(-ctas // sms))
                if resident > best_resident:
                    best, best_resident = Plan(rows, threads, ck, stages, ctas, smem), resident
                break
    if threads > most or best is None:
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


def b_columns(g: int) -> int:
    """Columns of the bf16 kernels' B operand at ``g`` output channels a
    CTA: the ``9 g`` taps padded to whole tiles of 8 (16 at one channel,
    24 at two, 32 at three, 40 at four), each a weight row in shared
    memory."""
    return -(-9 * g // 8) * 8


def partial_stride(m: int) -> int:
    """Floats between two taps' partials of ``m`` band pixels: 4 mod 32, so
    the 4 taps a warp stores at once sit 4 banks apart."""
    return -(-m // 32) * 32 + 4


def bf16_plan(units: int, height: int, width: int, c: int, cout: int = 1,
              cfg: bool = True, aligned: bool = True, sms: int = SMS) -> Bf16Plan:
    """Geometry of the bf16 :func:`fused_head_step` for ``units`` CTA units
    (sample pairs under ``cfg``, else samples) of ``height`` x ``width``
    pixels of ``c`` channels to ``cout`` output channels on a card of
    ``sms`` SMs.  At a group of ``g`` output channels (:func:`out_groups`)
    the weights are :func:`b_columns` rows and the partials ``9 g``.

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
    tallest; at a group of several output channels, where that band's
    partials outgrow shared memory, the tallest shorter one that fits.  Raises ``ValueError`` for a shape no path takes: ``cout <
    1``, ``c`` not a multiple of 8 (one 16-byte copy), a pointer off a
    16-byte boundary (``aligned``), or a band over shared memory (weights
    of over ~5600 channels at one output channel).
    """
    groups, g = out_groups(cout)
    if c <= 0 or c % 8:
        raise ValueError(f"the bf16 head kernel needs channels % 8 == 0, got {c}")
    if not aligned:
        raise ValueError("the head kernel needs 16-byte aligned features")
    block = BF16_BLOCK if c % BF16_BLOCK == 0 else BF16_NARROW_BLOCK

    def smem(rows):  # an item is 2 KiB at either width
        m = (2 if cfg else 1) * (rows + 2) * width
        return (2 * b_columns(g) * weight_stride(staged_channels(c)) + 2 * BF16_THREADS // 32
                * BF16_RING * BF16_TILE * BF16_BLOCK + 4 * 9 * g * partial_stride(m))

    ordered = sorted(ROWS_BF16)  # shortest first
    rows = next((r for r in ordered if units * groups * -(-height // r) <= BF16_PER_SM * sms),
                ordered[-1])
    if g > 1 and smem(rows) > SMEM_MAX:  # the 9 g partials' rows: a shorter band
        rows = max((r for r in ordered if r < rows and smem(r) <= SMEM_MAX), default=rows)
    if smem(rows) > SMEM_MAX:
        raise ValueError(f"a band of {rows} x {width} pixels x {c} channels takes no path")
    return Bf16Plan(rows, BF16_THREADS, units * -(-height // rows) * groups, smem(rows), block)


class HaloPlan(NamedTuple):
    """The fp32 halo kernel's launch geometry for one input shape."""

    rows: int  # output rows of a CTA's band
    threads: int  # per CTA
    ctas: int
    smem_bytes: int  # dynamic shared memory per CTA: weights, rings, partials


def halo_plan(units: int, height: int, width: int, c: int, cout: int = 1,
              cfg: bool = True, aligned: bool = True, sms: int = SMS,
              rows: int | None = None) -> HaloPlan:
    """Geometry of the fp32 :func:`fused_head_step` with ``halo`` for
    ``units`` CTA units (sample pairs under ``cfg``, else samples) of
    ``height`` x ``width`` pixels of ``c`` channels to ``cout`` output
    channels (weights and partials ``9 g`` rows at a group of ``g``,
    :func:`out_groups`) on a card of ``sms`` SMs.

    A CTA of ``HALO_THREADS`` threads takes a band of ``rows`` output rows
    and reduces its ``rows + 2`` rows of ``h`` (each branch's), each warp
    its ``HALO_TILE``-pixel tiles ``HALO_CK`` channels (a pixel's 128-byte
    line) an item through a ring of its own, ``HALO_RING`` deep; its shared
    memory holds the weights (rows of ``c`` rounded up to ``HALO_CK``), the
    rings and the band's partials.  The band is the shortest of
    ``ROWS_HALO`` whose grid is one wave of the CTAs an SM holds (at most
    ``HALO_PER_SM``: one CTA's gather runs beside another's copies), else
    the tallest that fits; ``rows`` (the band kernel's ``BAND_ROWS``) fixes
    the band where its shared memory fits.  Raises ``ValueError`` for a
    shape it does not take:
    ``cout < 1``, ``c`` not a multiple of one 16-byte copy (4), a pointer
    off a 16-byte boundary (``aligned``), or no band whose shared memory
    fits (weights of over ~3700 channels at one output channel).
    """
    groups, g = out_groups(cout)
    if c <= 0 or c % 4:
        raise ValueError(f"the fp32 halo kernel needs channels % 4 == 0, got {c}")
    if not aligned:
        raise ValueError("the head kernel needs 16-byte aligned features")

    def smem(rows):
        m = (2 if cfg else 1) * (rows + 2) * width
        return 4 * (9 * g * -(-c // HALO_CK) * HALO_CK
                    + HALO_THREADS // 32 * HALO_RING * HALO_TILE * HALO_CK
                    + 9 * g * -(-m // HALO_TILE) * HALO_TILE)

    fits = [r for r in sorted(ROWS_HALO) if smem(r) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"a band of {width} pixels x {c} channels takes no fp32 halo plan")
    if rows is None or smem(rows) > SMEM_MAX:
        rows = next((r for r in fits if units * groups * -(-height // r) <= sms * min(
            HALO_PER_SM, SM_SMEM // (smem(r) + 1024))), fits[-1])
    return HaloPlan(rows, HALO_THREADS, units * -(-height // rows) * groups, smem(rows))


class SplitPlan(NamedTuple):
    """The split launch's geometry for one input shape."""

    rows: int  # output rows of a CTA's band
    threads: int  # per CTA
    span: int  # channels of a range (SPLIT_SPAN; the last range shorter)
    splits: int  # ranges: grid.y
    ctas: int  # bands x ranges
    smem_bytes: int  # dynamic shared memory per CTA: a range's weights, rings, partials
    block: int  # channels of an item: BF16_BLOCK or BF16_NARROW_BLOCK in bf16, HALO_CK in fp32


def split_plan(units: int, height: int, width: int, c: int, cout: int = 1,
               cfg: bool = True, aligned: bool = True, element_bytes: int = 4) -> SplitPlan:
    """Geometry of the split :func:`fused_head_step` (either mode) for
    ``units`` CTA units (sample pairs under ``cfg``, else samples) of
    ``height`` x ``width`` pixels of ``c`` channels of ``element_bytes``
    each to ``cout`` output channels.

    The grid is (band x output group, range): a CTA runs the band kernels'
    body for a group of :func:`out_groups` (bf16:
    :func:`bf16_plan`'s items, 64 channels where 64 divides ``c``, else 32
    with a range's last block masked; fp32: :func:`halo_plan`'s) on one of
    :func:`split_ranges`' ranges of its band, so its shared memory holds
    one range's weights, the warps' rings and the band's partials.  The
    band is ``SPLIT_ROWS`` rows (4 in bf16, 2 in fp32), or the tallest
    shorter one, whose shared memory lets ``SPLIT_PER_SM`` CTAs share an
    SM, else one row: at (2,8,8,6000) in bf16 under CFG bands of 4 rows,
    94 CTAs; at (32,64,64,4840) 9728.
    Raises ``ValueError`` for a shape no path takes: ``cout < 1``, ``c``
    not a multiple of one 16-byte copy (4 fp32, 8 bf16), a pointer off a
    16-byte boundary (``aligned``), or a band of one row over shared
    memory (a width of thousands of pixels)."""
    groups, g = out_groups(cout)
    per_copy = 16 // element_bytes
    if c <= 0 or c % per_copy:
        raise ValueError(f"the head kernel needs channels % {per_copy} == 0, got {c}")
    if not aligned:
        raise ValueError("the head kernel needs 16-byte aligned features")
    splits = len(split_ranges(c))
    if element_bytes == 2:
        block = BF16_BLOCK if c % BF16_BLOCK == 0 else BF16_NARROW_BLOCK

        def smem(rows):
            m = (2 if cfg else 1) * (rows + 2) * width
            return (2 * b_columns(g) * weight_stride(staged_channels(SPLIT_SPAN))
                    + 2 * BF16_THREADS // 32 * BF16_RING * BF16_TILE * BF16_BLOCK
                    + 4 * 9 * g * partial_stride(m))
    else:
        block = HALO_CK

        def smem(rows):
            m = (2 if cfg else 1) * (rows + 2) * width
            return 4 * (9 * g * SPLIT_SPAN
                        + HALO_THREADS // 32 * HALO_RING * HALO_TILE * HALO_CK
                        + 9 * g * -(-m // HALO_TILE) * HALO_TILE)

    def ctas(rows):
        return units * -(-height // rows) * groups * splits

    fits = ([r for r in ROWS_BF16 if r <= SPLIT_ROWS[element_bytes]  # tallest first
             and SPLIT_PER_SM * (smem(r) + 1024) <= SM_SMEM]
            or [r for r in ROWS_BF16[-1:] if smem(r) <= SMEM_MAX])
    if not fits:
        raise ValueError(f"a band of one row of {width} pixels takes no split plan")
    rows = fits[0]
    return SplitPlan(rows, BF16_THREADS if element_bytes == 2 else HALO_THREADS, SPLIT_SPAN,
                     splits, ctas(rows), smem(rows), block)


def route(units: int, height: int, width: int, c: int, dtype, cout: int = 1,
          cfg: bool = True, aligned: bool = True, halo: bool = False,
          sms: int = SMS) -> tuple:
    """``(C name, plan)`` of :func:`fused_head_step`'s launch for features
    of ``dtype`` (arguments as :func:`launch_plan`'s): for float32 the
    float kernel, at widths from ``BAND_WIDTH`` the fp32 band kernel
    (``F32_BAND_NAME``, bands of ``BAND_ROWS``; without CFG only at up to
    ``BAND_NARROW_C`` channels: at the big step's 256 the template's band
    of 4 rows of 128 pixel pairs ran 0.09300 ms against the band kernel's
    best 0.11048, at 3 rows, ``scripts/compare_torch_kernels.py
    --variants``) and with ``halo`` the fp32 halo kernel, both under
    :func:`halo_plan`; for
    bfloat16 the bf16 kernel (with ``halo`` its halo mode) under
    :func:`bf16_plan`, at the narrow item where ``c`` is
    a multiple of 8 but not of 64 (``BF16_NARROW_NAME``,
    ``HALO_NARROW_NAME``).  Where that plan refuses the shape, or the
    features hold ``2**31`` elements or more (the band kernels' offsets
    are 32-bit), the split launch of ``dtype`` (``SPLIT_NAMES``, either
    mode) under :func:`split_plan`: exactly the shapes whose weights
    overflow the band kernel's shared memory (in bf16 ``c`` from 4840 at
    16 maps of 64x64 under CFG, from 5608 at width 8; in fp32 from 3056
    unsharded and 4240 on a 16-map half; no committed model's), the fp32
    unsharded launch's odd widths without CFG where the template takes
    it, and the largest features.  Every ``cout`` takes the kernels
    above, in groups of :func:`out_groups` (the weights' and partials'
    shared memory grow with the group, so the split launch takes over at a
    narrower ``c``); an unaligned pointer, a ``c`` not a multiple of one
    16-byte copy or ``cout < 1`` take no kernel.  A function of the
    shape, the dtype and the alignment alone, chosen before the launch;
    raises ``ValueError`` where no kernel takes the shape."""
    args = (units, height, width, c, cout, cfg, aligned, sms)

    def split():
        return SPLIT_NAMES[dtype], split_plan(units, height, width, c, cout, cfg, aligned,
                                              ELEMENT_BYTES[dtype])

    if (2 if cfg else 1) * units * height * width * c >= 2**31:
        return split()
    try:
        narrow = c <= BAND_NARROW_C
        band = width >= BAND_WIDTH and (cfg or narrow)
        if dtype != torch.bfloat16 and not halo and not band:
            return C_NAME, launch_plan(*args)
        if dtype != torch.bfloat16 and not halo:
            return F32_BAND_NAME, halo_plan(*args, rows=BAND_ROWS[narrow])
        plan = (bf16_plan if dtype == torch.bfloat16 else halo_plan)(*args)
    except ValueError:
        return split()
    if isinstance(plan, Bf16Plan) and plan.block == BF16_NARROW_BLOCK:
        return (HALO_NARROW_NAME if halo else BF16_NARROW_NAME), plan
    return (HALO_NAMES[dtype] if halo else BF16_NAME), plan


def fused_head_step(h, weight, bias, x, z, c_eps: float, inv_sqrt_a: float,
                    sigma: float, guide_w=None, tanh: bool = False, halo=None):
    """``(x - c_eps*e)*inv_sqrt_a + sigma*z`` with ``e`` the (guided) output
    of the 3x3 conv ``weight`` ``(cout, C, 3, 3)``, ``bias`` ``(cout,)``
    over the NHWC features ``h`` (its tanh per branch with ``tanh=True``):
    ``(B, H, W, C)``, or ``(2B, H, W, C)`` stacked ``[cond; uncond]`` when
    ``guide_w`` (a float or a ``(B,)`` tensor) is given.  ``h``, ``weight``
    and ``bias`` are float32, or all bfloat16 (the bf16 model); ``x``,
    ``z`` ``(B, H, W, cout)`` and a per-sample ``guide_w`` float32; ``z``
    may be None only when ``sigma`` is 0.  ``halo=(top, bottom)``: the rows of
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
        raise ValueError(f"h must be NHWC and weight (cout, C, 3, 3), got "
                         f"{tuple(h.shape)} and {tuple(weight.shape)}")
    cfg = guide_w is not None
    b = x.shape[0]
    nd, height, width, c = h.shape
    cout = weight.shape[0]
    if tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"weight must be (cout, {c}, 3, 3), got {tuple(weight.shape)}")
    # Tap-major (cout * 9, C) weights, row o * 9 + tap: a view of the
    # channels_last weight the model holds, a small copy otherwise.
    wt = weight.permute(0, 2, 3, 1).reshape(cout * 9, c).contiguous()
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
    if nd != (2 * b if cfg else b):
        raise ValueError(f"h must hold {2 * b if cfg else b} samples, got {nd}")
    if tuple(x.shape) != (b, height, width, cout) or bias.shape != (cout,):
        raise ValueError(f"x must be {(b, height, width, cout)} and bias ({cout},), got "
                         f"{tuple(x.shape)} and {tuple(bias.shape)}")
    if z is not None and z.shape != x.shape:
        raise ValueError(f"z must be {tuple(x.shape)}, got {tuple(z.shape)}")
    _build.refuse_autograd("fused_head_step", h, weight, *tensors.values())
    aligned = all(tensors[k].data_ptr() % 16 == 0 for k in ("h", "weight", "top", "bottom")
                  if k in tensors)
    name, plan = route(b, height, width, c, h.dtype, cout, cfg, aligned,
                       halo is not None,
                       torch.cuda.get_device_properties(h.device).multi_processor_count)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    split = isinstance(plan, SplitPlan)  # both modes: null rows are zero
    rows = (tuple(tensors[k].data_ptr() if k in tensors else None for k in ("top", "bottom"))
            if halo is not None or split else ())
    head = (h.data_ptr(), *rows, wt.data_ptr(), bias.data_ptr(), x.data_ptr(),
            z.data_ptr() if z is not None else None,
            w_vec.data_ptr() if w_vec is not None else None,
            float(guide_w) if cfg and w_vec is None else 0.0, out.data_ptr())
    tail = (float(c_eps), float(inv_sqrt_a), float(sigma), int(tanh),
            torch.cuda.current_stream(h.device).cuda_stream)
    if split:
        partials = torch.empty((plan.splits, 2 if cfg else 1, cout, b * height * width),
                               dtype=torch.float32, device=h.device)
        err = _build.kernel(name, _SPLIT_ARGTYPES)(
            *head, partials.data_ptr(), b, height, width, c, cout, plan.rows, int(cfg),
            plan.span, plan.splits, plan.threads, plan.smem_bytes, *tail)
    else:
        band = not isinstance(plan, Plan)  # a kernel of its own: no ck, stages
        fn = _build.kernel(name, _BAND_HALO_ARGTYPES if halo is not None
                           else _BF16_ARGTYPES if band else _ARGTYPES)
        geometry = (plan.threads,) if band else (plan.ck, plan.stages, plan.threads)
        err = fn(*head, b, height, width, c, cout, plan.rows, int(cfg), *geometry,
                 plan.smem_bytes, *tail)
    _build.check(err, name)
    mode = "_halo" if halo is not None else ""
    suffix = "_bf16" if h.dtype == torch.bfloat16 else ""
    count = f"launches{mode}{suffix}"
    setattr(fused_head_step, count, getattr(fused_head_step, count) + 1)
    kinds = (["_split"] if split else ["_band"] if name == F32_BAND_NAME
             else ["_narrow"] + (["_masked"] if c % BF16_NARROW_BLOCK else [])
             if name in (BF16_NARROW_NAME, HALO_NARROW_NAME) else [])
    for kind in kinds + (["_cout"] if cout > 1 else []):
        count = f"launches{mode}{kind}{suffix}"
        setattr(fused_head_step, count, getattr(fused_head_step, count) + 1)
    return out


fused_head_step.launches = 0  # every fp32 unsharded launch
fused_head_step.launches_split = 0  # those of them that took the split launch
fused_head_step.launches_band = 0  # those of them that took F32_BAND_NAME
fused_head_step.launches_bf16 = 0  # every bf16 unsharded launch
fused_head_step.launches_narrow_bf16 = 0  # those of them that took BF16_NARROW_NAME
fused_head_step.launches_masked_bf16 = 0  # ... with a last channel block masked past c
fused_head_step.launches_split_bf16 = 0  # those of them that took the split launch
fused_head_step.launches_halo = 0  # every fp32 halo launch
fused_head_step.launches_halo_split = 0  # those of them that took the split launch
fused_head_step.launches_halo_bf16 = 0  # every bf16 halo launch
fused_head_step.launches_halo_narrow_bf16 = 0  # those of them that took HALO_NARROW_NAME
fused_head_step.launches_halo_masked_bf16 = 0  # ... with a last channel block masked past c
fused_head_step.launches_halo_split_bf16 = 0  # those of them that took the split launch
# Of each of the four, the launches at several output channels (cout > 1).
fused_head_step.launches_cout = 0
fused_head_step.launches_cout_bf16 = 0
fused_head_step.launches_halo_cout = 0
fused_head_step.launches_halo_cout_bf16 = 0
