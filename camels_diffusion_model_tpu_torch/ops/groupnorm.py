"""GroupNorm + affine + activation kernel K2 (NHWC), with an optional FiLM
epilogue.

Wraps ``csrc/groupnorm.cu`` (with ``groupnorm_narrow.cu`` and
``groupnorm_sharded.cu``, sharing ``groupnorm.cuh``), the counterpart of the Pallas
``fused_groupnorm_act`` (``camels_diffusion_model_tpu/ops/pallas/
groupnorm.py:65``).  The decoder runs it at ``up0_norm``, with FiLM stage 0
as its epilogue, and at ``out_norm``: two launches per decoder call, at
``(N, 16, 16, 256)`` and ``(N, 64, 64, 128)`` in the canonical model,
``(N, 16, 16, 512)`` and ``(N, 128, 128, 128)`` in the deep one,
``(N, 16, 16, 1024)`` and ``(N, 128, 128, 256)`` in the big one.
:func:`launch_plan` chooses the kernel's geometry.

On a height shard of a spatial mesh the statistics span every shard
(:func:`fused_groupnorm_act_sharded`): a statistics launch
(:func:`groupnorm_stats`) writes each (sample, group)'s count, local mean
and local centred sum of squares in fp32, the space axis gathers them with
one all-reduce of a zeroed buffer, and an apply launch
(:func:`groupnorm_apply`) merges them by Chan's formula in its prologue,
then normalises, applies gamma/beta, the activation and the FiLM epilogue
as the single launch does.  Each has its own launch counts and its own
kernel in both instances (``csrc/groupnorm_sharded.cu``, ``groupnorm_stats_kernel``:
each thread's packs in registers from one burst of loads, Chan's merge per
thread, warp and block, no cluster barrier where the grid is wide enough;
``groupnorm_apply_kernel``: a streaming pass over whole pixels, no
cluster), planned by :func:`stats_plan` and :func:`apply_plan`.

Two instances: float32 and bfloat16 I/O (the bf16 model's heads), each
with its own launch count (``fused_groupnorm_act.launches`` and
``.launches_bf16``).  Both compute the statistics, the affine and the
activation in fp32 and round once to the I/O type, as the Pallas kernel
does; the bf16 FiLM epilogue rounds as the JAX program does
(:func:`groupnorm_act_plain`).  The bf16 single launch is a kernel of its
own (``csrc/groupnorm.cu``, ``groupnorm_bf16_kernel``): a unit of a few
groups of a sample (64 bytes of a pixel at least), its pixels split over
a cluster, each CTA's part held in registers from one burst of loads; the
statistics in one merge by Chan's formula (one cluster barrier);
:func:`bf16_plan` chooses its geometry.  Where a group's channels are not
a multiple of 8 (the out_norm of n_feat 32, 96 and 160), the bf16 single
launch takes the narrow bf16 kernel (``groupnorm_bf16_narrow_kernel``:
units of groups whose slice of a pixel is whole packs, the statistics
merged per channel and grouped last; :func:`narrow_plan`), counted under
``.launches_bf16`` and also under ``.launches_narrow_bf16``; where that
kernel's layout cannot hold a unit (over 256 channels, as n_feat 264's
heads, or 17-31 packs a pixel, or a part over its registers) its wide
layout (``groupnorm_bf16_wide_kernel``: whole warps with idle lanes,
parts in rounds, the per-channel merge through shared memory), counted
also under ``.launches_wide_bf16``.  Where both plans refuse a shape (an
unaligned pointer, a group of over 256 channels) the float kernel's bf16
instance (:func:`single_route`), counted also under
``.launches_generic_bf16``.  Where the single launch of either type
refuses a shape (a group of over 256 accesses, or a slice over
``SLICE_MAX`` that the fp32 large-slice kernel below does not take:
widths the JAX package computes, no committed model's), the statistics
and apply launches run on one card, the one
shard's partials feeding the apply launch with no collective: they stream
their pixels and take every width, counted under ``.launches`` or
``.launches_bf16`` and also under ``.launches_pair`` or
``.launches_pair_bf16``.

The fp32 single launch where the template's slice is over ``SLICE_TARGET``
and groups are whole 32-byte sectors (the deep and big models' out_norm:
groups of 1 and 2 MiB) is a kernel of its own too
(``groupnorm_f32_large_kernel``: a CTA's part of its group on chip whole,
tensor copies into shared memory plus register packs, all requested at
once; one merge by Chan's formula; each box normalised in place and
written back by a tensor store; :func:`large_plan`), counted under
``.launches`` and also under ``.launches_large``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .film import check_rows, film_plain, rounds_threads
from ..parallel.mesh import all_reduce, all_reduce_sum

ACTS = {"none": 0, "relu": 1, "gelu": 2, "leaky_relu": 3}

THREADS = 256  # a CTA; a multiple of 32 for the warp-shuffle sums
# The template's CTA where its slice is over SLICE_TARGET
# (scripts/compare_torch_kernels.py --variants and --template, in turns;
# H100 80GB HBM3): LARGE_SLICE_THREADS where the slice leaves its SM no room
# for a second CTA (over SLICE_MAX // 2: 512 ran 1.05-1.11x 384 at the deep
# out_norm's 128 KiB, 1.02x at n_feat 224's 224 KiB at 128x128),
# SHARED_SLICE_THREADS where it does (384 ran 1.16-1.26x 512 at n_feat 224's
# 56 KiB slices of 64x64 maps, 1.05x at n_feat 256's 64 KiB).
LARGE_SLICE_THREADS = 512
SHARED_SLICE_THREADS = 384
MIN_CTAS = 256  # about two per SM on the 132 SMs of an H100
MAX_CLUSTER = 8  # the largest portable thread-block cluster
SLICE_TARGET = 48 * 1024  # bytes of a CTA's slice that still leave room
#                           for several CTAs on one SM (228 KB of shared memory)
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}  # the instances' I/O types
C_NAME = "camels_groupnorm_act"  # the float single launch
BF16_NAME = "camels_groupnorm_act_bf16"  # the bf16 single launch (bf16_plan)
BF16_NARROW_NAME = "camels_groupnorm_act_bf16_narrow"  # groups not whole packs (narrow_plan)
BF16_GENERIC_NAME = "camels_groupnorm_act_bf16_generic"  # the float kernel's bf16 instance
LARGE_NAME = "camels_groupnorm_act_large"  # the fp32 single launch at large slices (large_plan)
STATS_NAMES = {torch.float32: "camels_groupnorm_stats",
               torch.bfloat16: "camels_groupnorm_stats_bf16"}
APPLY_NAMES = {torch.float32: "camels_groupnorm_apply",
               torch.bfloat16: "camels_groupnorm_apply_bf16"}
# The single launch where the single kernels refuse: the pair on one card.
PAIR_NAMES = {dt: (STATS_NAMES[dt], APPLY_NAMES[dt]) for dt in STATS_NAMES}
SLICE_MAX = 227 * 1024 - 1024  # the dynamic shared memory a CTA may ask for,
#                                less room for the kernel's static arrays

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)
# The statistics launch: x, stats, n, hw, c, groups, vec, seg, cluster,
# threads, part_px, the stream.
_STATS_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
# The apply launch: x, partials, gamma, beta, scale, shift, out, n_parts, n,
# hw, c, groups, the row strides, eps, act, vec, threads, part_px, the
# stream.
_APPLY_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7 + (ctypes.c_float,)
                   + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
# The bf16 launch: x, gamma, beta, scale, shift, out, n, hw, c, groups, the
# row strides, eps, act, then seg, cluster, threads, packs, part_px and
# the stream.
_BF16_ARGTYPES = _ARGTYPES[:14] + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_NARROW_ARGTYPES = _BF16_ARGTYPES[:-1] + (ctypes.c_int, ctypes.c_void_p)  # then wide
# The large-slice launch: the float launch's arguments up to act, then
# cluster, threads, part_px, boxes, box_px, box_ch, smem_bytes and the
# stream.
_LARGE_ARGTYPES = _ARGTYPES[:14] + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)

# bf16_plan's choices.
BF16_LINE = 64  # bytes of a pixel's slice of a unit at least (two sectors)
BF16_MAX_SEG = 8  # groups of a unit at most
BF16_THREADS = 512  # a CTA at most (the kernel's launch bound)
BF16_PART = 128 * 1024  # bytes of a CTA's part at most: 16 packs of 512 threads
BF16_PACKS = (1, 2, 4, 8, 16)  # 16-byte packs a thread may hold (kernel instances)
BF16_SPREAD = 256  # CTAs a launch should reach: a small batch's units split further
BF16_PART_MIN = 8 * 1024  # bytes a part keeps when it is split for the grid's sake
# narrow_plan's choices (scripts/compare_torch_kernels.py --narrow: at 16
# maps small clusters of large parts beat clusters of 8 by 1.35x).
NARROW_PACKS = (4, 8, 16)  # packs a thread of the narrow bf16 kernel may hold
NARROW_SECTOR = 32  # bytes a unit's slice of a pixel is a multiple of, where the groups allow
NARROW_THREADS = 256  # a CTA's threads aimed at (whole warps and pixels)
NARROW_SPREAD = 66  # CTAs a launch should reach (half the SMs): small batches split further
NARROW_GROUP_CH = 256  # channels of a group the narrow kernels take at most
# The wide layout's CTAs (whole warps, lanes past the last whole pixel idle;
# scripts/compare_torch_kernels.py --generic, n_feat 264's heads at 2 and
# 16 maps): of at most BF16_WIDE_THREADS where its CTAs have an SM each (384 ran
# 1.05-1.10x 512); where a part takes rounds and the grid holds more CTAs
# than SMs, of WIDE_SHARED_THREADS with WIDE_SHARED_PACKS a round (about 80
# registers: three CTAs share an SM, the grid one wave; 1.2x 512 threads of
# 16 packs at n_feat 264's 16-map out_norm).
BF16_WIDE_THREADS = 384
WIDE_SHARED_THREADS = 256
WIDE_SHARED_PACKS = 4

# large_plan's choices (groupnorm_f32_large_kernel).
LARGE_THREADS = 512  # a CTA (the kernel's launch bound)
LARGE_SMALL_PART = 512  # pixels of a part at most that takes half the threads
#                         (a 64x64 map over 8 CTAs: 256 threads ran 1.17x 512 at
#                         n_feat 256's 32-map out_norm, compare_torch_kernels.py --variants)
LARGE_BOX_PX = 256  # pixels of a tensor copy's box at most (a box dimension's limit)
LARGE_MAX_BOXES = 16  # boxes of a part at most (the kernel's mbarriers)
LARGE_PACKS = 4  # register packs a thread at most (csrc's: two CTAs an SM's registers)
LARGE_PER_SM = (2, 1)  # CTAs an SM, the first whose budget holds the part
LARGE_STATIC = 512  # bytes of the kernel's static shared memory at most
SM_SMEM = 228 * 1024  # shared memory of an SM; each CTA also takes 1 KiB

# stats_plan's and apply_plan's choices (the sharded launches).
STATS_LINE = 64  # bytes of a pixel's slice of a unit at least (two sectors)
STATS_THREADS = 256  # a CTA, in whole warps and whole pixels
STATS_MAX_THREADS = 512  # the statistics kernel's launch bound
STATS_PART_MIN = 16 * 1024  # bytes a part keeps when a unit splits over a cluster
# Where a CTA of packs leaves lanes idle: at most this many threads, so two
# CTAs share an SM (57-84 registers; 384 threads held one): at n_feat 1032's
# bf16 up0_norm 320 threads ran 1.39x 512, fp32 288 1.04x 480
# (scripts/compare_torch_kernels.py --cout's sweep).
STATS_IDLE_THREADS = 320
APPLY_THREADS = 256  # a CTA, in whole warps and whole pixels
APPLY_PACKS = 16  # packs a thread takes at most: four rounds of the kernel's four loads


class Plan(NamedTuple):
    """The kernel's launch geometry for one input shape."""

    vec: int  # elements per access: 16 bytes (4 floats, 8 bf16) or 1
    cluster: int  # CTAs that share one (sample, group)
    threads: int  # per CTA
    pixels_per_cta: int  # a CTA's run of pixels of its group
    smem_bytes: int  # dynamic shared memory per CTA: its slice


def launch_plan(n: int, hw: int, c: int, groups: int, aligned: bool = True,
                element_bytes: int = 4) -> Plan:
    """Geometry of :func:`fused_groupnorm_act` for ``n`` samples of ``hw``
    pixels and ``c`` channels in ``groups`` groups, of ``element_bytes``
    each (4 fp32, 2 bf16).

    The 16-byte path needs ``c / groups`` to be a multiple of one access's
    elements and ``aligned`` pointers; other shapes take the scalar path.
    The cluster is the smallest of 1, 2, 4, 8 whose per-CTA slice is at most
    ``SLICE_TARGET`` bytes and whose grid reaches ``MIN_CTAS``; it stops
    growing once it reaches ``hw``.  A slice over ``SLICE_TARGET`` takes a
    CTA of ``SHARED_SLICE_THREADS`` threads, or of ``LARGE_SLICE_THREADS``
    where it is over half of ``SLICE_MAX`` (its SM holds no second CTA).
    Raises ``ValueError`` for a shape the kernel does not take: a group
    wider than a CTA's threads, or a slice over ``SLICE_MAX`` bytes even in
    a cluster of 8 (a group of over 1.8 MB, as the big model's fp32
    ``out_norm``: 2 MiB; in bf16 it is 1 MiB and fits), which
    :func:`single_route` gives the large-slice kernel or the pair.
    """
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    cg = c // groups
    wide = 16 // element_bytes
    vec = wide if aligned and cg % wide == 0 else 1
    if cg // vec > THREADS:
        raise ValueError(f"a group of {cg} channels is wider than {THREADS} threads")

    def slice_bytes(cluster):
        return -(-hw // cluster) * cg * element_bytes

    cluster = 1
    while (cluster < MAX_CLUSTER and cluster < hw
           and (slice_bytes(cluster) > SLICE_TARGET or n * groups * cluster < MIN_CTAS)):
        cluster *= 2
    if slice_bytes(cluster) > SLICE_MAX:
        raise ValueError(
            f"a group of {hw} x {cg} elements needs {slice_bytes(cluster)} bytes "
            f"per CTA even in a cluster of {cluster}, over {SLICE_MAX}"
        )
    threads = (THREADS if slice_bytes(cluster) <= SLICE_TARGET
               else SHARED_SLICE_THREADS if slice_bytes(cluster) <= SLICE_MAX // 2
               else LARGE_SLICE_THREADS)
    return Plan(vec, cluster, threads, -(-hw // cluster), slice_bytes(cluster))


class Bf16Plan(NamedTuple):
    """The bf16 kernel's launch geometry for one input shape."""

    seg: int  # groups of a unit (a pixel's slice of them at least BF16_LINE bytes)
    cluster: int  # CTAs that share one unit
    threads: int  # per CTA
    packs: int  # 16-byte packs a thread holds in registers
    part_px: int  # a CTA's run of pixels of its unit

    def ctas(self, n: int, groups: int) -> int:
        return n * groups // self.seg * self.cluster


def bf16_plan(n: int, hw: int, c: int, groups: int, aligned: bool = True,
              sms: int = 132) -> Bf16Plan:
    """Geometry of the bf16 :func:`fused_groupnorm_act` for ``n`` samples
    of ``hw`` pixels and ``c`` channels in ``groups`` groups on a card of
    ``sms`` SMs.

    A unit is ``seg`` consecutive groups of a sample: the fewest whose
    slice of a pixel is ``BF16_LINE`` bytes, within ``BF16_MAX_SEG`` and
    256 channels, and fewer where the unit would not fit 8 parts of
    ``BF16_PART`` bytes; one group where the channels per group are not
    8 times a power of two (the kernel's warp butterfly splits a warp's
    lanes by their bits).  The cluster (the unit's pixels split over it, a
    part a CTA) is the smallest of 1, 2, 4, 8 whose part fits 16 packs of
    ``BF16_THREADS`` threads, doubled while the grid is short of
    ``BF16_SPREAD`` CTAs and a part would keep ``BF16_PART_MIN`` bytes,
    for parts of at most half ``BF16_PART`` (small launches wait on
    latency: more, shorter CTAs) or grids short of half the SMs.  A part
    over 32 KiB takes 512 threads, else 256 (fewer for one pack a thread;
    a multiple of both 32 and the unit's packs a pixel), and the fewest
    packs of ``BF16_PACKS`` that cover it.  Raises ``ValueError`` for a
    shape no plan takes: channels per group not a multiple of 8 (one
    16-byte pack), an unaligned pointer, a group over 32 packs (256
    channels), or a group over 16 packs of 512 threads a CTA even in a
    cluster of 8.
    """
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    cg = c // groups
    if cg % 8 or not aligned:
        raise ValueError(f"the bf16 GroupNorm kernel needs 16-byte aligned tensors and "
                         f"channels per group a multiple of 8, got {cg}")
    if cg > 256:
        raise ValueError(f"a group of {cg} channels is wider than the bf16 kernel takes")
    vpg = cg // 8  # 16-byte packs a group
    seg = 1
    while (seg < BF16_MAX_SEG and seg * cg * 2 < BF16_LINE and groups % (2 * seg) == 0
           and 2 * seg * cg <= 256 and hw * 2 * seg * cg * 2 <= 8 * BF16_PART
           and vpg & (vpg - 1) == 0):  # the warp butterfly's lane bits (groupnorm.cu)
        seg *= 2
    units = n * groups // seg
    vs = seg * vpg
    whole = math.lcm(32, vs)  # threads in whole warps and whole pixels
    # pixels a CTA holds at most: BF16_PACKS[-1] packs of BF16_THREADS threads
    most = BF16_PACKS[-1] * ((BF16_THREADS - BF16_THREADS % whole) // vs)

    def part_bytes_of(cluster):
        return -(-hw // cluster) * seg * cg * 2

    cluster = next((cl for cl in (1, 2, 4, 8) if -(-hw // cl) <= most), None)
    if cluster is None:
        raise ValueError(f"a group of {hw} x {cg} bf16 elements takes no plan: over "
                         f"{most} pixels a CTA even in a cluster of 8")
    while cluster < 8 and cluster < hw and units * cluster < BF16_SPREAD and (
            part_bytes_of(cluster) // 2 >= BF16_PART_MIN) and (
            part_bytes_of(cluster) <= BF16_PART // 2 or 2 * units * cluster < sms):
        cluster *= 2
    part = -(-hw // cluster)
    threads = BF16_THREADS if part_bytes_of(cluster) > 32 * 1024 else BF16_THREADS // 2
    threads = max(whole, threads - threads % whole)  # whole: at most BF16_THREADS here
    packs = next(k for k in BF16_PACKS if k * (threads // vs) >= part)
    if packs == 1:  # fewer threads for a small part
        threads = min(threads, -(-part * vs // whole) * whole)
    return Bf16Plan(seg, cluster, threads, packs, part)


class NarrowPlan(NamedTuple):
    """The narrow bf16 kernels' launch geometry for one input shape."""

    seg: int  # groups of a unit (its slice of a pixel whole 16-byte packs)
    cluster: int  # CTAs that share one unit
    threads: int  # per CTA
    packs: int  # 16-byte packs a thread holds in registers (the wide layout: a round's)
    part_px: int  # a CTA's run of pixels of its unit
    wide: bool = False  # groupnorm_bf16_wide_kernel: idle lanes, rounds, shared-memory merge

    def ctas(self, n: int, groups: int) -> int:
        return n * groups // self.seg * self.cluster


def narrow_plan(n: int, hw: int, c: int, groups: int, aligned: bool = True,
                sms: int = 132) -> NarrowPlan:
    """Geometry of the bf16 :func:`fused_groupnorm_act` where a group's
    channels are not a multiple of 8 (``csrc/groupnorm_narrow.cu``,
    ``groupnorm_bf16_narrow_kernel`` and ``groupnorm_bf16_wide_kernel``):
    the shapes :func:`bf16_plan` refuses for that reason, as the out_norm
    of n_feat 32, 96 and 160 (4, 12 and 20 channels a group) and n_feat
    264's heads (33 and 66).

    A unit is ``seg`` consecutive groups of a sample whose slice of a
    pixel is whole 16-byte packs (``seg * cg`` a multiple of 8: ``seg = 8
    / gcd(cg, 8)``), doubled while that slice is not whole
    ``NARROW_SECTOR``-byte sectors and the groups allow (at most
    ``BF16_MAX_SEG`` groups and 256 channels): n_feat 32's 4 groups (32
    bytes), 96's 4 of 12 (96 bytes), 160's 4 of 20 (160 bytes), 264's 8
    of 33 (out_norm) and 4 of 66 (up0_norm), 264 channels.  A CTA
    is ``NARROW_THREADS`` threads in whole warps and whole pixels of the
    unit (at least one of each; up to 512 where a unit's pixels would
    need a cluster over 8), each thread the most packs of
    ``NARROW_PACKS``, so the cluster (1, 2, 4 or 8 CTAs a unit) is the
    smallest whose parts fit: fewer, larger parts, and fewer CTAs in each
    cluster barrier.  While the grid is short of ``NARROW_SPREAD`` CTAs
    the cluster doubles (a small batch: more, shorter CTAs) if a part
    keeps ``BF16_PART_MIN`` bytes.  Packs are
    the fewest that cover a part, threads the fewest whole warps that do
    where that is one pack's worth.  At n_feat 32, 16 maps: units of 4
    groups in clusters of 2, 256 threads of 16 packs, 128 CTAs.

    Where that layout cannot hold the unit (over 256 channels, whole
    warps of whole pixels over 512 threads as at 17-31 packs a pixel, or
    parts over 16 packs a thread even in a cluster of 8), and for the
    groups of whole packs that :func:`bf16_plan` refuses but for their
    width or alignment (parts over its registers, as n_feat 320's out_norm
    at 128x128; 17 packs a group and more, as n_feat 544's up0_norm), the
    wide layout (``wide``): a CTA of whole warps of at most
    ``BF16_WIDE_THREADS``, the lanes past its last whole pixel idle
    (:func:`idle_lane_threads`), and the same cluster and part rules, a
    part over 16 packs a thread taken in rounds (the cluster then 8);
    where it does and the grid has more CTAs than the card has SMs, CTAs
    of at most ``WIDE_SHARED_THREADS`` and ``WIDE_SHARED_PACKS`` packs a
    round, so several share an SM.  At n_feat 264's 2-map out_norm: 384
    threads (11 pixels of 33 packs, 21 lanes idle), clusters of 8, parts
    of 512 pixels in 3 rounds of 16; at 16 maps 256 threads (7 pixels),
    19 rounds of 4.  Raises ``ValueError`` for a shape it does not take:
    an unaligned pointer, channels a group a multiple of 8 that
    :func:`bf16_plan` takes, a group of over ``NARROW_GROUP_CH`` channels,
    or groups that a unit of whole packs does not divide."""
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    cg = c // groups
    if not aligned:
        raise ValueError("the narrow bf16 GroupNorm kernel needs 16-byte aligned tensors")
    if cg % 8 == 0:
        try:
            bf16_plan(n, hw, c, groups, aligned, sms)
        except ValueError:
            pass  # whole packs bf16_plan's layout cannot hold: the wide layout's
        else:
            raise ValueError(f"{cg} channels a group are whole packs: bf16_plan's shape")
    if cg > NARROW_GROUP_CH:
        raise ValueError(f"a group of {cg} channels is wider than the narrow kernels take")
    seg = 8 // math.gcd(cg, 8)
    if groups % seg:
        raise ValueError(f"{groups} groups of {cg} channels split into no units of whole "
                         f"16-byte packs")
    while (seg < BF16_MAX_SEG and seg * cg * 2 % NARROW_SECTOR and groups % (2 * seg) == 0
           and 2 * seg * cg <= 256):
        seg *= 2
    vs = seg * cg // 8  # packs of a unit's pixel
    whole = math.lcm(32, vs)
    units = n * groups // seg
    most, cluster, wide = NARROW_PACKS[-1], None, seg * cg > 256
    for budget in (() if wide else (NARROW_THREADS, BF16_THREADS)):
        threads = max(whole, budget - budget % whole)
        if threads > BF16_THREADS:
            break
        cluster = next((cl for cl in (1, 2, 4, 8)
                        if -(-hw // cl) <= most * (threads // vs)), None)
        if cluster is not None:
            break
    if cluster is None:  # the wide layout
        wide, threads = True, idle_lane_threads(vs, BF16_WIDE_THREADS)
        cluster = next((cl for cl in (1, 2, 4) if -(-hw // cl) <= most * (threads // vs)), 8)
    while (cluster < 8 and cluster < hw and units * cluster < NARROW_SPREAD
           and -(-hw // cluster) * seg * cg * 2 // 2 >= BF16_PART_MIN):
        cluster *= 2
    part = -(-hw // cluster)
    if wide and part > most * (threads // vs) and units * cluster > sms:  # CTAs share SMs
        threads = idle_lane_threads(vs, max(WIDE_SHARED_THREADS, -(-vs // 32) * 32))
        return NarrowPlan(seg, cluster, threads, WIDE_SHARED_PACKS, part, wide)
    packs = next((k for k in NARROW_PACKS if k * (threads // vs) >= part), most)
    if packs == NARROW_PACKS[0] and not wide:  # fewer threads for a small part
        threads = min(threads, -(-part * vs // whole) * whole)
    return NarrowPlan(seg, cluster, threads, packs, part, wide)


class LargePlan(NamedTuple):
    """The large-slice fp32 kernel's launch geometry for one input shape."""

    cluster: int  # CTAs that share one (sample, group)
    threads: int  # per CTA
    part_px: int  # a CTA's run of pixels of its group
    boxes: int  # tensor-copy boxes of the part in shared memory
    box_px: int  # pixels of a box
    box_ch: int  # channels of a box's row: the group's, or a divisor of them
    smem_bytes: int  # dynamic shared memory per CTA: 128 bytes of alignment, then the boxes
    per_sm: int  # CTAs an SM whose shared-memory budget the boxes were cut to


def large_plan(n: int, hw: int, c: int, groups: int, aligned: bool = True) -> LargePlan:
    """Geometry of the fp32 :func:`fused_groupnorm_act` at the shapes
    :func:`single_route` gives ``groupnorm_f32_large_kernel`` (``csrc/
    groupnorm.cu``) for ``n`` samples of ``hw`` pixels and ``c`` channels
    in ``groups`` groups.

    A (sample, group) splits over a cluster of ``MAX_CLUSTER`` CTAs of
    ``LARGE_THREADS`` threads (half as many for a part of at most
    ``LARGE_SMALL_PART`` pixels), a part of ``ceil(hw / 8)`` pixels each,
    held on chip whole: boxes of ``box_px`` pixels (at most
    ``LARGE_BOX_PX``) in shared memory, as many as the budget of ``per_sm``
    CTAs an SM holds (228 KiB an SM, less 1 KiB a CTA, the static arrays
    and 128 bytes of alignment), then at most ``LARGE_PACKS`` 16-byte packs
    a thread in registers: ``per_sm`` the first of ``LARGE_PER_SM`` whose
    boxes and packs hold the part.  The deep out_norm (1 MiB a group): 7
    boxes of 256 pixels (112 KiB) and 2 packs of the 4, two CTAs an SM;
    the big one (2 MiB): 7 boxes of 32 KiB and 4 packs, one CTA an SM.  A
    box's rows are the group's channels (``box_ch``; a divisor of at most
    256 of them where a group is wider).  Raises ``ValueError`` for a shape it does not take:
    channels a group not a multiple of 4 (one 16-byte pack), an unaligned
    pointer, or a part over the largest budget (a group of over ~2 MiB,
    which the pair then takes)."""
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    cg = c // groups
    if cg % 4 or not aligned:
        raise ValueError(f"the large-slice kernel needs 16-byte aligned tensors and channels "
                         f"per group a multiple of 4, got {cg}")
    vpg = cg // 4
    part = -(-hw // MAX_CLUSTER)
    threads = LARGE_THREADS // (2 if part <= LARGE_SMALL_PART else 1)
    if vpg > threads:
        raise ValueError(f"a group of {cg} channels is wider than {threads} threads")
    box_ch = max(k for k in range(4, min(cg, 256) + 1, 4) if cg % k == 0)
    pstride = threads // vpg  # pixels the block covers per step
    px = cg * 4  # bytes of a pixel of the group
    for per_sm in LARGE_PER_SM:
        budget = SM_SMEM // per_sm - 1024 - LARGE_STATIC - 128
        box_px = min(LARGE_BOX_PX, -(-part // 8) * 8, budget // px // 8 * 8)
        if box_px < 8:
            continue
        boxes = min(-(-part // box_px), budget // (box_px * px), LARGE_MAX_BOXES)
        if part - boxes * box_px <= LARGE_PACKS * pstride:
            return LargePlan(MAX_CLUSTER, threads, part, boxes, box_px, box_ch,
                             128 + boxes * box_px * px, per_sm)
    raise ValueError(f"a part of {part} x {cg} floats is over the large-slice kernel's "
                     f"shared memory and registers")


class PairPlan(NamedTuple):
    """The statistics and apply launches of :func:`fused_groupnorm_act` on
    one card (no collective): each launch's geometry."""

    stats: "StatsPlan"
    apply: "ApplyPlan"


def single_route(n: int, hw: int, c: int, groups: int, dtype, aligned: bool = True,
                 sms: int = 132) -> tuple:
    """``(C name, plan)`` of :func:`fused_groupnorm_act`'s launch for a
    ``dtype`` input: for float32 the float kernel under :func:`launch_plan`,
    and where that plan's slice is over ``SLICE_TARGET`` in groups of whole
    32-byte sectors the large-slice kernel under :func:`large_plan`
    (``LARGE_NAME``: the deep and big out_norm, the 128x128 family's
    out_norm at n_feat 64, 128, 192 and 256, the canonical one from n_feat
    256 in steps of 64) unless the part is over its budget (groups of over
    ~2 MiB take the pair; groups of 4 mod 8 channels keep the template:
    at n_feat 224's 28 channels, rows of 112 bytes, the large kernel's
    best plan ran 0.95x the template's 384 threads,
    ``scripts/compare_torch_kernels.py --variants``); for bfloat16
    the bf16 kernel under :func:`bf16_plan`, where that plan refuses the
    shape the narrow bf16 kernels under
    :func:`narrow_plan` (``BF16_NARROW_NAME``: groups not whole packs, in
    its wide layout where a unit is over 256 channels), and where both
    refuse it the float kernel's bf16 instance (``BF16_GENERIC_NAME``)
    under :func:`launch_plan`: exactly an unaligned pointer, a group of
    over ``NARROW_GROUP_CH`` channels, or groups that a unit of whole
    packs does not divide (not at 8 groups).  Where the single launch of
    ``dtype`` refuses the shape, the statistics and apply launches on one
    card (``PAIR_NAMES``, a :class:`PairPlan` of :func:`stats_plan` and
    :func:`apply_plan`, which take every width): exactly a group of over
    ``THREADS`` accesses (fp32: over 1024 channels where they are whole
    16-byte packs and the pointers aligned, else over 256; bf16: over 2048
    in packs, else over 256, as n_feat 1032's up0_norm: 258) or a slice
    over ``SLICE_MAX`` bytes even in a cluster of 8 that the large-slice
    kernel does not take (fp32: a group of over 1.77 MiB, as the out_norm
    at 128x128 from n_feat 264; bf16, where the generic instance takes the
    shape: a group of over 0.9 Mi elements).  At 320-384 KiB slices
    the pair ran 1.28-1.38x faster than the template's former spill path
    (``scripts/compare_torch_kernels.py --template``).  A function of the
    shape, the dtype and the alignment alone, chosen before the launch;
    raises ``ValueError`` only where the channels do not split into the
    groups."""
    try:
        if dtype != torch.bfloat16:
            cg = c // groups if groups > 0 and c % groups == 0 else 0
            if aligned and cg and cg % 8 == 0 and -(-hw // MAX_CLUSTER) * cg * 4 > SLICE_TARGET:
                try:
                    return LARGE_NAME, large_plan(n, hw, c, groups, aligned)
                except ValueError:
                    pass  # over the large kernel's budget: the pair
            return C_NAME, launch_plan(n, hw, c, groups, aligned)
        for name, plan in ((BF16_NAME, bf16_plan), (BF16_NARROW_NAME, narrow_plan)):
            try:
                return name, plan(n, hw, c, groups, aligned, sms)
            except ValueError:
                pass
        return BF16_GENERIC_NAME, launch_plan(n, hw, c, groups, aligned, 2)
    except ValueError:
        if groups <= 0 or c % groups:
            raise
    eb = ELEMENT_BYTES[dtype]
    return PAIR_NAMES[dtype], PairPlan(stats_plan(n, hw, c, groups, aligned, eb, sms),
                                       apply_plan(n, hw, c, groups, aligned, eb, sms))


def idle_lane_threads(width: int, most: int) -> int:
    """Threads of a CTA of whole warps that covers whole slices of
    ``width`` threads, the lanes past its last whole slice idle: the
    multiple of 32 from ``STATS_THREADS`` (at least ``width``) up to
    ``most`` that leaves the smallest share idle, the fewest on a tie."""
    return min(range(max(STATS_THREADS, -(-width // 32) * 32), most + 1, 32),
               key=lambda t: (t % width / t, t))


def pack_elements(c: int, groups: int, aligned: bool, element_bytes: int) -> int:
    """Elements a thread of the statistics and apply launches accesses at
    once: a 16-byte pack (4 fp32, 8 bf16) where a pixel's ``c`` channels
    are whole packs, the pointers ``aligned`` and a group at least a pack
    wide (a pack then spans at most two groups), else one element: odd
    channel counts, unaligned pointers, and groups narrower than a pack
    (n_feat 40's 5 channels a group in bf16)."""
    wide = 16 // element_bytes
    return wide if aligned and c % wide == 0 and c // groups >= wide else 1


def straddle_packs(groups: int, cg: int, vec: int) -> int:
    """The most packs of ``vec`` elements (aligned to the pixel) that
    overlap one of ``groups`` groups of ``cg`` channels: the threads of a
    statistics unit where packs straddle groups (csrc ``packs_of``)."""
    return max(((g + 1) * cg - 1) // vec - g * cg // vec + 1 for g in range(groups))


class StatsPlan(NamedTuple):
    """The statistics launch's geometry for one shard shape."""

    vec: int  # elements per access: a 16-byte pack (4 floats, 8 bf16) or 1
    seg: int  # groups of a unit
    cluster: int  # CTAs that share one unit (1: no cluster, no barrier)
    threads: int  # per CTA
    part_px: int  # a CTA's run of pixels of its unit

    def ctas(self, n: int, groups: int) -> int:
        return n * groups // self.seg * self.cluster


def stats_plan(n: int, hw: int, c: int, groups: int, aligned: bool = True,
               element_bytes: int = 4, sms: int = 132) -> StatsPlan:
    """Geometry of :func:`groupnorm_stats` (and of the statistics launch of
    the pair on one card, :func:`single_route`) for ``n`` samples of ``hw``
    pixels and ``c`` channels in ``groups`` groups, of ``element_bytes``
    each (4 fp32, 2 bf16), on a card of ``sms`` SMs.

    A thread reads one 16-byte pack of a pixel (:func:`pack_elements`; or
    one element).  A unit is
    ``seg`` consecutive groups of a sample: the fewest whose slice of a
    pixel is ``STATS_LINE`` bytes, within ``BF16_MAX_SEG`` (one group where
    the packs of a group are not a power of two: the kernel's warp
    butterfly splits a warp's lanes by their bits).  Where a group's
    channels are not whole packs (packs that straddle groups: n_feat
    1032's up0_norm, n_feat 136's and 264's heads) a unit is one group and
    its threads take the :func:`straddle_packs` packs that overlap a group,
    each masking the channels outside it.  The units' pixels
    split over a cluster, doubled from 1 while the grid has fewer CTAs
    than the card has SMs and a part would keep ``STATS_PART_MIN`` bytes:
    a cluster of 1 takes no barrier.  ``STATS_THREADS`` threads in whole
    warps and whole pixels of the unit, fewer where a part fills fewer.
    Where whole warps of whole pixels exceed ``STATS_MAX_THREADS`` (a
    unit of one group of an odd number of accesses over 16, as n_feat
    136's 17 channels a group on the element path, or 33 straddling packs
    at n_feat 1032's bf16 up0_norm), the lanes past the CTA's last whole
    pixel idle (:func:`idle_lane_threads`; of packs, CTAs of at most
    ``STATS_IDLE_THREADS``): every lane of the unit's one group merges
    in the butterfly, the idle ones empty.  Where a group's accesses
    outnumber ``STATS_MAX_THREADS`` (a group of over 512 packs or, where
    its channels are not whole packs, elements), a thread takes several
    accesses of each pixel, merging each by Chan's formula: the fewest
    whole warps that take them in equal rounds.  Raises ``ValueError``
    only where the channels do not split into the groups."""
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    cg = c // groups
    vec = pack_elements(c, groups, aligned, element_bytes)
    straddle = cg % vec != 0
    vpg = straddle_packs(groups, cg, vec) if straddle else cg // vec  # packs a group
    seg = 1
    while (seg < BF16_MAX_SEG and groups % (2 * seg) == 0 and not straddle
           and seg * cg * element_bytes < STATS_LINE and vpg & (vpg - 1) == 0):
        seg *= 2
    vs = seg * vpg
    whole = math.lcm(32, vs)  # threads in whole warps and whole pixels
    units = n * groups // seg

    def part_bytes(cluster):
        return -(-hw // cluster) * seg * cg * element_bytes

    cluster = 1
    while (cluster < MAX_CLUSTER and cluster < hw and units * cluster < sms
           and part_bytes(cluster) // 2 >= STATS_PART_MIN):
        cluster *= 2
    part = max(1, -(-hw // cluster))
    if vs > STATS_MAX_THREADS:  # seg is 1: several accesses of a pixel a thread
        return StatsPlan(vec, seg, cluster, rounds_threads(vs, STATS_MAX_THREADS), part)
    if whole > STATS_MAX_THREADS:  # seg is 1: a unit of several groups is 2^k packs
        most = STATS_MAX_THREADS if vec == 1 else max(STATS_IDLE_THREADS, -(-vs // 32) * 32)
        threads = idle_lane_threads(vs, most)
        return StatsPlan(vec, seg, cluster, min(threads, -(-part * vs // 32) * 32), part)
    threads = max(whole, STATS_THREADS - STATS_THREADS % whole)
    threads = min(threads, -(-part * vs // whole) * whole)
    return StatsPlan(vec, seg, cluster, threads, part)


class ApplyPlan(NamedTuple):
    """The apply launch's geometry for one shard shape."""

    vec: int  # elements per access: a 16-byte pack (4 floats, 8 bf16) or 1
    threads: int  # per CTA
    part_px: int  # a CTA's run of whole pixels of one sample

    def ctas(self, n: int, hw: int) -> int:
        return n * -(-hw // self.part_px)


def apply_plan(n: int, hw: int, c: int, groups: int, aligned: bool = True,
               element_bytes: int = 4, sms: int = 132) -> ApplyPlan:
    """Geometry of :func:`groupnorm_apply` (and of the apply launch of the
    pair on one card, :func:`single_route`) for ``n`` samples of ``hw``
    pixels and ``c`` channels in ``groups`` groups, of ``element_bytes``
    each, on a card of ``sms`` SMs.

    A CTA takes whole pixels of one sample, a thread the same 16-byte pack
    (or element, :func:`pack_elements`) of each: ``APPLY_THREADS`` threads
    in whole warps and whole pixels; a pack that straddles two groups
    takes each element's own group's statistics.  Where whole warps of whole pixels
    exceed the kernel's launch bound (512 threads of packs, 1024 of
    elements; n_feat 264's out_norm: 264 elements a pixel, 1056 threads),
    the lanes past the CTA's last whole pixel idle
    (:func:`idle_lane_threads`).  A thread takes ``APPLY_PACKS``
    pixels, halved while the grid has fewer CTAs than the card has SMs
    (at phase (r1)'s shapes two CTAs an SM ran no faster, and the
    up0_norm's 8-pixel parts slower: ``scripts/compare_torch_kernels.py
    --sharded``).  Where a pixel's accesses outnumber the launch bound (as
    n_feat 1032's up0_norm: 2064 elements), a thread takes several of
    each pixel: the fewest whole warps that take them in equal rounds of
    at most ``APPLY_THREADS`` (at n_feat 1032's 16-map up0_norm 256
    threads ran 1.08x 704 in fp32, 1.24x in bf16: more CTAs an SM,
    ``scripts/compare_torch_kernels.py --wide``), and ``APPLY_PACKS``
    pixels a CTA, halved likewise.  Raises ``ValueError`` only where the
    channels do not split into the groups."""
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    vec = pack_elements(c, groups, aligned, element_bytes)
    vpp = c // vec  # packs a pixel
    whole = math.lcm(32, vpp)
    most = 1024 if vec == 1 else 512
    if vpp > most:  # several accesses of a pixel a thread
        threads = rounds_threads(vpp, APPLY_THREADS)
    elif whole > most:
        threads = idle_lane_threads(vpp, most)
    else:
        threads = max(whole, APPLY_THREADS - APPLY_THREADS % whole)
    step = max(1, threads // vpp)  # pixels a CTA covers per step
    packs = APPLY_PACKS
    while packs > 1 and n * -(-hw // (step * packs)) < sms:
        packs //= 2
    return ApplyPlan(vec, threads, step * packs)


def activation(y, act: str):
    """The activations of the JAX package (``context_unet.py:54-61``)."""
    if act == "relu":
        return F.relu(y)
    if act == "gelu":
        return F.gelu(y, approximate="none")
    if act == "leaky_relu":
        return F.leaky_relu(y, 0.2)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def groupnorm_act_plain(x, gamma, beta, num_groups: int = 8,
                        eps: float = 1e-5, act: str = "relu", film=None,
                        act_after_rounding: bool = False):
    """Two-pass fp32 GroupNorm + affine + act over NHWC ``x``, rounded to
    ``x``'s dtype; then, with ``film=(scale, shift)``, :func:`film_plain` in
    that dtype.

    The statistics and the affine are fp32 whatever ``x``'s dtype, as both
    JAX paths compute them.  By default the activation is fp32 too and the
    result rounds once, as the Pallas kernel does
    (``ops/pallas/groupnorm.py:52-57``) and kernel K2 does.
    ``act_after_rounding`` takes the JAX XLA path's order instead
    (``models/blocks.py:322-330``): round to ``x``'s dtype, then the
    activation in it, the training forward's GroupNorm (JAX trains with
    ``pallas_gn=False``).  For fp32, and for ReLU, the two agree."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    return _normalise(x, xg, mean, var, gamma, beta, eps, act, film, act_after_rounding)


def _normalise(x, xg, mean, var, gamma, beta, eps, act, film, act_after_rounding):
    """:func:`groupnorm_act_plain` from the statistics ``mean``/``var``
    ``(B, 1, G, 1)`` of the grouped fp32 view ``xg`` of ``x``."""
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * gamma + beta
    if act_after_rounding:
        y = activation(y.to(x.dtype), act)
    else:
        y = activation(y, act).to(x.dtype)
    return y if film is None else film_plain(y, *film)


def groupnorm_stats_plain(x, num_groups: int = 8) -> torch.Tensor:
    """``(B, G, 3)`` fp32: each (sample, group)'s element count, mean and
    centred sum of squares over the NHWC shard ``x`` (the mean first, then
    the squares about it)."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3))
    m2 = (xg - mean[:, None, :, None]).square().sum(dim=(1, 3))
    return torch.stack([torch.full_like(mean, float(h * w * (c // num_groups))), mean, m2],
                       dim=-1)


def merge_stats(partials: torch.Tensor) -> tuple:
    """``(mean, var)``, each ``(B, G)``, of the whole image from the
    ``(n_parts, B, G, 3)`` partials of its shards, merged in shard order by
    Chan's formula in fp32, in the operation order kernel K2's apply
    launch uses."""
    cnt, mean, m2 = partials[0].unbind(-1)
    for k in range(1, partials.shape[0]):
        nb, mb, m2b = partials[k].unbind(-1)
        nab = cnt + nb
        delta = mb - mean
        mean = mean + delta * (nb / nab)
        m2 = m2 + m2b + delta * delta * (cnt * nb / nab)
        cnt = nab
    return mean, m2 / cnt


def groupnorm_apply_plain(x, partials, gamma, beta, num_groups: int = 8,
                          eps: float = 1e-5, act: str = "relu", film=None):
    """:func:`groupnorm_act_plain` of the shard ``x`` with the statistics
    merged from ``partials`` (:func:`merge_stats`)."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean, var = merge_stats(partials.float())
    return _normalise(x, xg, mean[:, None, :, None], var[:, None, :, None], gamma, beta,
                      eps, act, film, False)


def groupnorm_act_plain_sharded(space, x, gamma, beta, num_groups: int = 8,
                                eps: float = 1e-5, act: str = "relu", film=None,
                                act_after_rounding: bool = False):
    """:func:`groupnorm_act_plain` of the height shard ``x`` with
    statistics over every shard of the space axis ``space``, under
    autograd (the training forward): the mean from the shards' summed fp32
    sums, then the variance from their summed centred squares, each sum
    one differentiable all-reduce."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    count = float(h * w * (c // num_groups) * space.world_size)
    mean = all_reduce_sum(space, xg.sum(dim=(1, 3), keepdim=True)) / count
    var = all_reduce_sum(space, (xg - mean).square().sum(dim=(1, 3), keepdim=True)) / count
    return _normalise(x, xg, mean, var, gamma, beta, eps, act, film, act_after_rounding)


def _check(name, x, gamma, beta, film):
    """Validate a launch's tensors; returns them by name."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if x.dtype not in ELEMENT_BYTES:
        raise ValueError(f"{name}: no kernel for {x.dtype}; float32 or bfloat16")
    tensors = {"x": x}
    if gamma is not None:
        tensors["gamma"], tensors["beta"] = gamma, beta
    if film is not None:
        tensors["scale"], tensors["shift"] = film
    for key, t in tensors.items():
        dtype = torch.float32 if key in ("gamma", "beta") else x.dtype
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {_build.type_name(dtype)} "
                f"tensor on {x.device}"
            )
    if gamma is not None and (gamma.shape != (c,) or beta.shape != (c,)):
        raise ValueError(f"gamma/beta must be ({c},)")
    if film is not None:
        check_rows(film, b, c)
    _build.refuse_autograd(name, *tensors.values())
    return tensors


def _count(fn, x) -> None:
    if x.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _launch_stats(x, out, plan: StatsPlan, num_groups: int) -> None:
    """The statistics kernel of ``x``'s dtype into ``out`` under ``plan``."""
    b, h, w, c = x.shape
    err = _build.kernel(STATS_NAMES[x.dtype], _STATS_ARGTYPES)(
        x.data_ptr(), out.data_ptr(), b, h * w, c, num_groups, *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, STATS_NAMES[x.dtype])


def _launch_apply(x, partials, gamma, beta, film, out, plan: ApplyPlan, num_groups: int,
                  eps: float, act: str) -> None:
    """The apply kernel of ``x``'s dtype into ``out`` under ``plan``."""
    b, h, w, c = x.shape
    rows, strides = (None, None), (0, 0)
    if film is not None:  # a row stride of 0 broadcasts the one row
        rows = tuple(t.data_ptr() for t in film)
        strides = tuple(c if t.shape[0] > 1 else 0 for t in film)
    err = _build.kernel(APPLY_NAMES[x.dtype], _APPLY_ARGTYPES)(
        x.data_ptr(), partials.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *rows,
        out.data_ptr(), partials.shape[0], b, h * w, c, num_groups, *strides, float(eps),
        ACTS[act], *plan, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, APPLY_NAMES[x.dtype])


def groupnorm_stats(x, num_groups: int = 8) -> torch.Tensor:
    """The statistics launch of the sharded mode: :func:`groupnorm_stats_plain`
    of the NHWC shard ``x`` (float32 or bfloat16), in one read of ``x``.
    On CUDA tensors it launches K2's statistics kernel under
    :func:`stats_plan` (raising for another dtype or where autograd would
    record the call); on CPU tensors it runs the plain version."""
    if x.device.type == "cpu":
        return groupnorm_stats_plain(x, num_groups)
    _check("groupnorm_stats", x, None, None, None)
    b, h, w, c = x.shape
    out = torch.empty((b, num_groups, 3), dtype=torch.float32, device=x.device)
    plan = stats_plan(b, h * w, c, num_groups, x.data_ptr() % 16 == 0,
                      ELEMENT_BYTES[x.dtype], _sms(x))
    if out.numel() == 0:
        return out
    _launch_stats(x, out, plan, num_groups)
    _count(groupnorm_stats, x)
    return out


groupnorm_stats.launches = 0
groupnorm_stats.launches_bf16 = 0


def groupnorm_apply(x, partials, gamma, beta, num_groups: int = 8, eps: float = 1e-5,
                    act: str = "relu", film=None):
    """The apply launch of the sharded mode: :func:`groupnorm_apply_plain`,
    the ``(n_parts, B, G, 3)`` fp32 ``partials`` merged by Chan's formula in
    the kernel's prologue, then the shard ``x`` normalised as
    :func:`fused_groupnorm_act` does (arguments as there).  On CUDA tensors
    it launches K2's apply kernel under :func:`apply_plan`; on CPU tensors
    it runs the plain version."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return groupnorm_apply_plain(x, partials, gamma, beta, num_groups, eps, act, film)
    tensors = _check("groupnorm_apply", x, gamma, beta, film)
    b, h, w, c = x.shape
    if (partials.device != x.device or partials.dtype != torch.float32
            or not partials.is_contiguous() or partials.dim() != 4
            or tuple(partials.shape[1:]) != (b, num_groups, 3)):
        raise ValueError(f"partials must be a contiguous float32 (n_parts, {b}, "
                         f"{num_groups}, 3) tensor on {x.device}")
    out = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (out, *tensors.values()))
    plan = apply_plan(b, h * w, c, num_groups, aligned, ELEMENT_BYTES[x.dtype], _sms(x))
    if out.numel() == 0:
        return out
    _launch_apply(x, partials, gamma, beta, film, out, plan, num_groups, eps, act)
    _count(groupnorm_apply, x)
    return out


groupnorm_apply.launches = 0
groupnorm_apply.launches_bf16 = 0


def gather_stats(space, stats: torch.Tensor) -> torch.Tensor:
    """``(n_space, B, G, 3)``: every shard's statistics of the space axis
    ``space``, in shard order (a zeroed buffer summed)."""
    full = stats.new_zeros((space.world_size,) + tuple(stats.shape))
    full[space.rank] = stats
    return all_reduce(space, full)


def fused_groupnorm_act_sharded(space, x, gamma, beta, num_groups: int = 8,
                                eps: float = 1e-5, act: str = "relu", film=None):
    """:func:`fused_groupnorm_act` of the height shard ``x`` with the
    statistics of the whole image over the space axis ``space``: the
    statistics launch, the all-reduce of the shards' partials, the apply
    launch (module docstring).  No arithmetic runs between the launches
    but the collective."""
    stats = groupnorm_stats(x, num_groups)
    return groupnorm_apply(x, gather_stats(space, stats), gamma, beta, num_groups, eps,
                           act, film)


def fused_groupnorm_act(x, gamma, beta, num_groups: int = 8,
                        eps: float = 1e-5, act: str = "relu", film=None):
    """GroupNorm(num_groups) + ``gamma``/``beta`` + act of NHWC ``x``, then
    ``y * scale + shift`` when ``film=(scale, shift)`` is given, with rows
    ``(N, C)`` or ``(1, C)`` (broadcast over the batch).  ``x``, ``out`` and
    the rows are float32 or bfloat16 (one type); ``gamma``/``beta`` float32.

    On CUDA tensors this launches the kernel of ``x``'s dtype, and raises
    for another dtype or where autograd would record the call
    (:func:`_build.refuse_autograd`); on CPU tensors it runs
    :func:`groupnorm_act_plain`.
    """
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return groupnorm_act_plain(x, gamma, beta, num_groups, eps, act, film)
    tensors = _check("fused_groupnorm_act", x, gamma, beta, film)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (out, *tensors.values()))
    name, plan = single_route(b, h * w, c, num_groups, x.dtype, aligned, _sms(x))
    if out.numel() == 0:
        return out
    if isinstance(plan, PairPlan):  # the statistics of one shard: the whole map
        stats = torch.empty((1, b, num_groups, 3), dtype=torch.float32, device=x.device)
        _launch_stats(x, stats, plan.stats, num_groups)
        _launch_apply(x, stats, gamma, beta, film, out, plan.apply, num_groups, eps, act)
        _count(fused_groupnorm_act, x)
        if x.dtype == torch.bfloat16:
            fused_groupnorm_act.launches_pair_bf16 += 1
        else:
            fused_groupnorm_act.launches_pair += 1
        return out
    rows, strides = (None, None), (0, 0)
    if film is not None:  # a row stride of 0 broadcasts the one row
        rows = tuple(t.data_ptr() for t in film)
        strides = tuple(c if t.shape[0] > 1 else 0 for t in film)
    head = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *rows, out.data_ptr(), b, h * w,
            c, num_groups, *strides, float(eps), ACTS[act])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name in (BF16_NAME, BF16_NARROW_NAME):
        argtypes = _NARROW_ARGTYPES if name == BF16_NARROW_NAME else _BF16_ARGTYPES
        err = _build.kernel(name, argtypes)(*head, *plan, stream)
    elif name == LARGE_NAME:
        err = _build.kernel(name, _LARGE_ARGTYPES)(*head, *plan[:-1], stream)
    else:
        err = _build.kernel(name, _ARGTYPES)(
            *head, *plan, stream)
    _build.check(err, name)
    _count(fused_groupnorm_act, x)
    if name == BF16_NARROW_NAME:
        fused_groupnorm_act.launches_narrow_bf16 += 1
        fused_groupnorm_act.launches_wide_bf16 += plan.wide
    if name == BF16_GENERIC_NAME:
        fused_groupnorm_act.launches_generic_bf16 += 1
    fused_groupnorm_act.launches_large += name == LARGE_NAME
    return out


fused_groupnorm_act.launches = 0  # every fp32 launch
fused_groupnorm_act.launches_pair = 0  # those of them that took the pair on one card
fused_groupnorm_act.launches_large = 0  # those of them that took LARGE_NAME
fused_groupnorm_act.launches_bf16 = 0  # every bf16 launch
fused_groupnorm_act.launches_narrow_bf16 = 0  # those of them that took BF16_NARROW_NAME
fused_groupnorm_act.launches_wide_bf16 = 0  # ... in its wide layout
fused_groupnorm_act.launches_generic_bf16 = 0  # those of them that took BF16_GENERIC_NAME
fused_groupnorm_act.launches_pair_bf16 = 0  # those of them that took the pair on one card
