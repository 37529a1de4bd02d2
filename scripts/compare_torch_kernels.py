"""Time an earlier revision of the port's step (K1), GroupNorm (K2) and
FiLM (K3) kernels against the checkout's, in one process on one card.

    mkdir -p build/old
    git archive <rev> camels_diffusion_model_tpu_torch | tar -x -C build/old
    python scripts/compare_torch_kernels.py --old build/old

Both versions are called through their own wrappers, with the arguments
every revision takes (``fused_groupnorm_act(x, gamma, beta, groups, eps,
act)``, ``fused_film(x, scale, shift)``): the earlier package is imported
under another name and builds its own kernels with its own
``ops/_build.py`` (under ``DIR/build/``), so no C interface is assumed.
Where the earlier K2 takes no ``film`` argument, K2 with the FiLM epilogue
is compared with the earlier K2 followed by its K3.  Where the earlier K1
takes eps (``fused_sampler_step``), the checkout's K1, which applies the
output conv itself (``fused_head_step``), is compared with ``F.conv2d``
followed by the earlier K1, at decoder batches 32 (CFG), 16 and 4; the
checkout's K1 is also timed at every band height of its launch plan.  Each version's sources
are also compiled once with ``-Xptxas -v`` (registers, shared memory and
spills per kernel).  Each case is checked against the checkout's plain
version, then timed old, new, new, old with ``chip_smoke.time_ms`` (device
ms per launch, data in device memory), with TF32 off as the port serves.

``--dtype bfloat16`` compares the bf16 instances instead (K1 and K2 at the
w=2 and w=0 serving shapes, the exact chain's, and the deep and big
models' at 10 maps), each held to its plain version under
``chip_smoke.tolerance`` and ``BF16_SHARE``, and times the checkout's bf16
K1 at every band height of ``ROWS_BF16``, and its bf16 K2 under every
plan its kernel takes (:func:`k2_bf16_candidates`: units of 1 to 8
groups, clusters of 1 to 8, 256 or 512 threads).  Each bf16 case is
timed five ways: cold (``chip_smoke.time_ms``: inputs in device memory),
warm (one copy of the inputs, left in L2 by the last call), lone
(:func:`lone_ms`: each launch alone after a synchronize, as a host-bound
served step launches it), and lone right after a cuDNN bf16 conv of the
served out_conv1's shape ("after conv", as the served out_norm runs) or
after a tiny elementwise kernel ("after add"); the plans cold and after
the conv.

``--sharded`` compares K2's sharded launches instead (``groupnorm_stats``
and ``groupnorm_apply``), fp32 and bf16, at ``chip_smoke.py`` phase
(r1)'s shard shapes: half of the w=2 serving heads' maps (up0_norm with
the FiLM epilogue, out_norm) and half of the deep model's out_norm (leaky
ReLU, 10 maps).  Each launch is held to the checkout's plain version
(statistics: each column within 1e-5 of its largest value; apply:
``chip_smoke.tolerance``), then timed old, new, new, old cold and lone
right after a cuDNN conv of the preceding layer's shape (``up0_conv``'s
transposed conv, ``out_conv1``; CUDA events around the one launch),
beside the bound, a one-element add in
the same graph (the floor a launch shows) and a clone of the shard (its
bytes read and written); then the new launches under every plan their
kernels take.  It prints the SASS instruction count of each instance of
the new kernels (``cuobjdump -sass``).

``--halo`` compares K1's halo mode instead (``fused_head_step`` with
``halo=(top, bottom)``), fp32 and bf16, at ``chip_smoke.py`` phase (r1)'s
shape: half of the w=2 serving features, ``h (32, 32, 64, 128)``, its
rows above and below from the other half.  Each launch is held to the
checkout's plain version (fp32 1e-4, bf16 ``chip_smoke.tolerance``), then
timed old, new, new, old cold and right after a cuDNN conv of
``out_conv1``'s shard shape (256 to 128 channels at 32x64, as
``--sharded`` times), beside the bound, and the kernel alone (the
profiler's device time of the step kernel, without the earlier wrapper's
copy of the halo rows into one buffer); the same three timings of the
checkout's float template's halo mode (the rows as two pointers) against
the new kernels, in turns; then the new kernels at every
band height of their plans (``ROWS_HALO``, ``ROWS_BF16``), and, for
information, the fp32 halo kernel on the whole w=2 map (zero halo rows)
against the unsharded fp32 launch in turns.  It prints the SASS
instruction count of the new halo kernels.

``--narrow`` compares the narrow bf16 kernels instead, at the narrow
models' shapes (n_feat 32 at 2 and 16 maps under CFG, 96 and 160 at 16):
K2 where groups are not whole packs (``groupnorm_bf16_narrow_kernel``,
out_norm) and K1 at its narrow item (``fused_head_step``'s 32-channel
items), each against the float kernels' bf16 instance it replaces (K2's
the checkout's, K1's the ``--old`` package's, which must have one: PRs
15-18; forced through the routes: the earlier package's template
refused n_feat 96's out_norm, whose 48 KiB slice launched without the
shared-memory opt-in), held to the checkout's plain version under
``chip_smoke.tolerance``, then timed old, new, new, old cold, right after
a cuDNN bf16 conv of out_conv1's shape (2 n_feat to n_feat channels at
64x64, :func:`after`) and the kernel alone (the profiler), beside the
bound and the library call (``F.group_norm``, ``F.conv2d`` in bf16, cold);
K1's narrow halo mode likewise at half of n_feat 32's 16-map features.
Then the new kernels' sweeps (K1: every band height of ``ROWS_BF16`` at
every band height; K2: every plan the narrow kernel
takes, :func:`narrow_candidates`), cold and after the conv; and the
served 64-channel bf16 K1, unsharded at w=2 and in its halo mode at phase
(r1)'s shape, old and new in turns, three rounds, with the SASS
instruction counts of both bf16 step kernels' instances.

``--generic`` compares the designs that took over the float kernels'
bf16 instances' last model shapes: K1's narrow item with a masked last
channel block (40 and 264 channels at 2 and 16 maps, 48 and 8 at 16; the
halo mode at half of 40's and 264's 16 maps) and K2's wide layout
(``groupnorm_bf16_wide_kernel``: n_feat 264's out_norm and up0_norm with
the FiLM epilogue at 2 and 16 maps, 280's and 136's out_norm at 16),
each against the float-kernel bf16 instance (forced through the routes;
K2's the checkout's, K1's the ``--old`` package's, PRs 15-18: the
checkout has none) as ``--narrow`` does (cold, after a cuDNN bf16 conv of the
layer before, the kernel alone; bound and library call); then K1's band
heights and every plan of the wide layout (:func:`wide_candidates`),
cold and after the conv, the picked one marked; then the existing bf16
kernels (the served w=2 K1 unsharded and in its halo mode, the served K2
heads, the narrow K1 and K2 at n_feat 32, 96 and 160) against the
``--old`` package in turns, three rounds; with the SASS instruction
counts of the bf16 step kernels and of the narrow and wide K2.

``--wide`` compares the launches that take the model widths past the
earlier kernels' limits, both types: K1's split launch (the channel sum
over CTAs, then the combine and step) at 6000 channels on 8x8 maps under
CFG and its halo mode at half of them, against the ``--old`` package's
float-template instances there (PRs 15-18), and at 16 maps of 64x64 past
the band kernels' shared memory (bf16 4840, fp32 3056 channels), where
the earlier package raises; K2's statistics and apply launches on one
card (the fp32 out_norm (10,128,128,512); n_feat 1032's up0_norm with
the FiLM epilogue at 16 maps in both types) and K3 at (4,32,32,8192)
fp32 and 8200 bf16 channels, where it raises too.  Each is held to the
checkout's plain version under ``chip_smoke.tolerance``, then timed old,
new, new, old cold (new, new where the earlier package raises) beside the
bound and the library call (``F.conv2d``, ``F.group_norm``,
``torch.addcmul``), with the split launch's two kernels alone (the
profiler) and its sweep of range widths (``SPLIT_SPAN``) and band heights
at each K1 shape; then every kernel a committed model runs against the
``--old`` package in turns, three rounds (the served w=2 K1, K2 and K3 in
both types, K1's halo and K2's sharded launches at phase (r1)'s shapes,
the narrow and wide bf16 kernels at n_feat 32, 264 and 280), and the
SASS instruction counts of the bf16 step kernels of both packages.

``--variants`` times the fp32 designs of the deep and big variants' heads:
K2's large-slice kernel (``groupnorm_f32_large_kernel``) at their out_norm,
(10|32, 128, 128, 128) leaky ReLU and (10|32, 128, 128, 256) GELU, at the
smaller slices the route also gives it (n_feat 64 at 128x128, 256 at
64x64) and at n_feat 224's (64x64), which it leaves on the template, in
turns against the ``--old`` package's float template (6ca23e3: the
template with its spill path, whose large-slice CTA took 384 threads)
forced at 384 and at 512 threads, and the statistics and apply pair on one
card; two runs of the new kernel must be bit-identical; then its plans
(CTAs of 256 or 512 threads, two CTAs an SM or one, boxes of 256 or 128
pixels).  K1 with tanh at
(10|20, 128, 128, 128|256) (no CFG, CFG w=2): the ``--old`` package's
launch and the checkout's template forced against the band kernel
(``head_step_f32_band_kernel``) in turns, then the band kernel at every
band height of ``ROWS_HALO``.  Each beside its bound and library call,
with the new kernels' ptxas lines and SASS instruction counts (the fp32
halo kernel's must not move), then every kernel a committed model runs,
the variants' up0_norm and K3 stage 1 among them, against the ``--old``
package in turns, three rounds.

``--template`` times the ``--old`` package's (6ca23e3) fp32 float
template at large slices, at CTAs of 384 and 512 threads, against the
checkout's statistics and apply pair on one card, in turns, two rounds:
its former spill path at (10|32, 128, 128, 320|384) (slices of 320 and
384 KiB, which the checkout gives the pair) and the slices at n_feat 224
that the checkout's template still takes (groups of 4 mod 8 channels: 224
KiB at 128x128, 56 KiB at 64x64); then the checkout's template (no spill
loop) against that one under the same plan, three rounds in turns, at
the shapes the route still gives it (the served out_norm and up0_norm +
FiLM, the variants' up0_norm + FiLM, n_feat 224).
``--cout`` times the slice of several output channels (a model of
several image channels): the served one-channel K1 launches (fp32 and bf16
at w=2 and w=0, the exact chain's, both halo kernels at phase (r1)'s
shape, the fp32 band kernel at the deep model's step) against the
``--old`` package, bit for bit, old, new, new, old three rounds, with the
SASS instruction counts of every K1 kernel instance of both; then K1 at
2, 3, 4 and 13 output channels at the served w=2 shape in both types (and
13 at the deep model's step in fp32), held to the plain version, cold,
beside the bound and ``F.conv2d`` to as many channels; then K2's
statistics and apply launches where packs straddle groups (n_feat 1032's
up0_norm with the FiLM epilogue as the pair on one card, with the sweep of
its launches' plans, n_feat 136's and 264's heads on a 1x2 mesh's half)
against the ``--old`` package's element path, old, new, new, old.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import importlib
import importlib.util
import inspect
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "compare_torch_kernels")
PACKAGE = "camels_diffusion_model_tpu_torch"
SPIN_CYCLES = 1_000_000  # about 0.6 ms of an H100's clock: longer than the host's enqueue


def load_package(root: str, name: str):
    """The port package under ``root``, imported as ``name``."""
    init = os.path.join(root, PACKAGE, "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def ptxas_report(build, label: str) -> subprocess.Popen:
    """Start one nvcc build of a version's ``csrc/*.cu`` with -Xptxas -v."""
    lib = os.path.join(OUT, label, "libptxas.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    sources = sorted(map(str, build.CSRC.glob("*.cu")))
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                             "-o", lib, *sources],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help=f"directory holding an earlier revision's {PACKAGE}/")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the instances compared (default float32)")
    ap.add_argument("--sharded", action="store_true",
                    help="K2's sharded statistics and apply launches, both dtypes")
    ap.add_argument("--halo", action="store_true", help="K1's halo mode, both dtypes")
    ap.add_argument("--narrow", action="store_true",
                    help="the narrow bf16 kernels (n_feat 32, 96, 160) and the served bf16 K1")
    ap.add_argument("--generic", action="store_true",
                    help="K1's masked narrow item and K2's wide layout against the checkout's "
                         "generic instances, and the existing bf16 kernels against --old")
    ap.add_argument("--wide", action="store_true",
                    help="the split K1, the K2 pair on one card and K3 at wide pixels, and "
                         "every kernel a committed model runs against --old in turns")
    ap.add_argument("--variants", action="store_true",
                    help="the large-slice fp32 K2 and the band fp32 K1 at the deep and big "
                         "variants' shapes, and every kernel a committed model runs against --old")
    ap.add_argument("--template", action="store_true",
                    help="the float K2 template at the large slices it still takes, at 384 and "
                         "512 threads, against the pair on one card")
    ap.add_argument("--cout", action="store_true",
                    help="K1 at several output channels and the served one-channel K1 against "
                         "--old; K2's statistics and apply launches at straddling packs")
    ap.add_argument("--prev", help="with --narrow: a revision's package dir that has the narrow "
                                   "kernels, timed against the checkout's in turns")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    import torch.nn.functional as F

    from camels_diffusion_model_tpu_torch.diffusion.schedule import (
        ddpm_coefficients,
        make_schedule,
    )
    from camels_diffusion_model_tpu_torch.ops import _build, film, groupnorm, sampler_step

    if not torch.cuda.is_available():
        print("compare_torch_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    load_package(args.old, "old_port")
    old_build = importlib.import_module("old_port.ops._build")
    old_gn = importlib.import_module("old_port.ops.groupnorm")
    old_film = importlib.import_module("old_port.ops.film")
    old_step = importlib.import_module("old_port.ops.sampler_step")
    reports = {label: ptxas_report(b, label) for label, b in (("old", old_build),
                                                               ("new", _build))}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # the wrappers' libraries
        list(pool.map(lambda b: b.build(), (old_build, _build)))
    for label, proc in reports.items():
        text, _ = proc.communicate()
        print(f"-- nvcc -Xptxas -v, {label} sources:\n{text.strip()}", flush=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {label} sources")

    if "film" in inspect.signature(old_gn.fused_groupnorm_act).parameters:
        def gn_film_old(x, gamma, beta, rows):
            return old_gn.fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "relu", rows)
    else:
        def gn_film_old(x, gamma, beta, rows):
            return old_film.fused_film(
                old_gn.fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "relu"), *rows)

    def gn(module):
        return lambda x, gamma, beta: module.fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "relu")

    def gn_plain(x, gamma, beta):
        return groupnorm.groupnorm_act_plain(x, gamma, beta, 8, 1e-5, "relu")

    def gn_film_new(x, gamma, beta, rows):
        return groupnorm.fused_groupnorm_act(x, gamma, beta, 8, 1e-5, "relu", rows)

    def gn_film_plain(x, gamma, beta, rows):
        return groupnorm.groupnorm_act_plain(x, gamma, beta, 8, 1e-5, "relu", rows)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    if args.cout:
        return compare_cout(randn, (old_build, old_gn, old_step), chip_smoke,
                            (groupnorm, sampler_step))
    if args.sharded:
        return compare_sharded(randn, old_gn, chip_smoke, groupnorm)
    if args.halo:
        return compare_halo(randn, old_step, chip_smoke, sampler_step)
    if args.generic:
        return compare_generic(randn, old_gn, old_step, chip_smoke, groupnorm, sampler_step)
    if args.template:
        return compare_template(randn, chip_smoke, old_gn, groupnorm)
    if args.variants:
        return compare_variants(randn, (old_gn, old_step, old_film), chip_smoke,
                                (groupnorm, sampler_step, film))
    if args.wide:
        return compare_wide(randn, old_build, (old_gn, old_step, old_film), chip_smoke,
                            (groupnorm, sampler_step, film))
    if args.narrow:
        prev = None
        if args.prev:
            load_package(args.prev, "prev_port")
            prev = tuple(importlib.import_module(f"prev_port.ops.{m}")
                         for m in ("groupnorm", "sampler_step"))
        return compare_narrow(randn, old_gn, old_step, chip_smoke, groupnorm, sampler_step,
                              prev)
    if args.dtype == "bfloat16":
        return compare_bf16(randn, old_gn, old_step, chip_smoke, groupnorm, sampler_step)
    cases = []  # (label, old fn, new fn, plain fn, args, tolerance)
    for n in (32, 16, 4):
        for head, hw, c in (("up0_norm", 16, 256), ("out_norm", 64, 128)):
            a = (randn(n, hw, hw, c), randn(c), randn(c))
            cases.append((f"K2 {head} ({n},{hw},{hw},{c})", gn(old_gn), gn(groupnorm),
                          gn_plain, a, 1e-4))
            if head == "up0_norm":
                cases.append((f"up0_norm + FiLM stage 0 ({n},{hw},{hw},{c})", gn_film_old,
                               gn_film_new, gn_film_plain,
                               (*a, (randn(n, c), randn(1, c))), 1e-4))
        for stage, hw, c in (("stage 0", 16, 256), ("stage 1", 32, 128)):
            cases.append((f"K3 {stage} ({n},{hw},{hw},{c})", old_film.fused_film,
                          film.fused_film, film.film_plain,
                          (randn(n, hw, hw, c), randn(n, c), randn(1, c)), 1e-5))

    if hasattr(old_step, "fused_sampler_step"):
        def k1_old(h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, w):
            eps = F.conv2d(h.permute(0, 3, 1, 2), weight, bias, padding=1)
            return old_step.fused_sampler_step(x, eps.permute(0, 2, 3, 1).contiguous(), z,
                                               c_eps, inv_sqrt_a, sigma, w)
    else:
        k1_old = old_step.fused_head_step
    coefs = ddpm_coefficients(make_schedule(1500), torch.tensor([750]))[0].tolist()
    weight = (randn(1, 128, 3, 3) * 0.05).contiguous(memory_format=torch.channels_last)
    k1_cases = []
    for n, cfg in ((32, True), (16, False), (4, False)):
        b = n // 2 if cfg else n
        a = (randn(n, 64, 64, 128).relu(), weight, randn(1), randn(b, 64, 64, 1),
             randn(b, 64, 64, 1), *coefs, 2.0 if cfg else None)
        k1_cases.append((n, a))
        cases.insert(0, (f"K1 (F.conv2d + old K1 / new K1) h({n},64,64,128)", k1_old,
                         sampler_step.fused_head_step, sampler_step.head_step_plain, a,
                         1e-4))

    # The new K1 at each band height and chunk width its plan chooses from,
    # forced through the plan's module constants.
    rows_all, chunks_all = sampler_step.ROWS, sampler_step.CHUNKS
    for n, a in k1_cases:
        picked = sampler_step.launch_plan(a[3].shape[0], 64, 64, 128, cfg=a[-1] is not None)
        times = {}
        for ck in chunks_all:
            for rows in rows_all:
                sampler_step.ROWS, sampler_step.CHUNKS = (rows,), (ck,)
                err = (sampler_step.fused_head_step(*a)
                       - sampler_step.head_step_plain(*a)).abs().max().item()
                if not err <= 1e-4:
                    raise SystemExit(f"K1 rows={rows} ck={ck} at {n}: max abs err {err}")
                times[(rows, ck)] = chip_smoke.time_ms(sampler_step.fused_head_step, a)
        sampler_step.ROWS, sampler_step.CHUNKS = rows_all, chunks_all
        print(f"new K1 by (rows, channels per chunk) at decoder batch {n}: "
              + ", ".join(f"{k}: {t:.5f} ms" for k, t in times.items())
              + f" (the plan picks {picked})", flush=True)

    for label, f_old, f_new, f_plain, a, tol in cases:
        want = f_plain(*a)
        errs = [(f(*a) - want).abs().max().item() for f in (f_old, f_new)]
        if not max(errs) <= tol:
            raise SystemExit(f"{label}: max abs err old {errs[0]} new {errs[1]} > {tol}")
        t = [chip_smoke.time_ms(f, a) for f in (f_old, f_new, f_new, f_old)]
        o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"{label}: old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} {t[2]:.5f} ms "
              f"(mean old {o:.5f}, new {nw:.5f}, old/new {o / nw:.2f}); "
              f"max abs err old {errs[0]:.2e} new {errs[1]:.2e}", flush=True)
    return 0


def lone_ms(fn, args, before=None, n: int = 20, tries: int = 3) -> float:
    """Device ms per call of ``fn(*args)``'s own kernels with each call
    launched alone after a synchronize, as a host-bound served step
    launches a kernel, from the profiler's kernel times (host and device
    activity traced, as ``profile_torch_serving.py`` does); with
    ``before``, each call comes right after ``before()`` (another layer's
    kernel, as in the step), whose kernels are not counted.  A trace that
    holds none of ``fn``'s kernels is taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def kernels(calls: int, first=None, call=True) -> dict:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if first is not None:
                    first()
                if call:
                    fn(*args)
                torch.cuda.synchronize()
        return {e.key: float(getattr(e, "self_device_time_total", 0.0))
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    for _ in range(tries):
        names = {key for key, us in kernels(n).items() if us > 0}
        if before is not None:
            names -= set(kernels(2, before, call=False))
        us = sum(t for key, t in kernels(n, before).items() if key in names) if names else 0.0
        if us > 0:
            return us / n / 1e3
    raise SystemExit(f"lone_ms: no kernel time in {tries} traces")


def k2_bf16_candidates(groupnorm, n: int, hw: int, c: int, groups: int = 8) -> list:
    """Every launch plan the bf16 K2 takes for ``n`` samples of ``hw``
    pixels and ``c`` channels: units of 1, 2, 4 or 8 groups (one where the
    warp butterfly cannot split a group's packs), clusters of 1 to 8, and
    256 or 512 threads (whole warps and pixels) with the fewest packs of
    ``BF16_PACKS`` that cover a part."""
    cg = c // groups
    vpg = cg // 8
    plans = []
    for seg in (1, 2, 4, 8):
        if groups % seg or seg * cg > 256 or (seg > 1 and vpg & (vpg - 1)):
            continue
        vs = seg * vpg
        whole = math.lcm(32, vs)
        for cluster in (1, 2, 4, 8):
            part = -(-hw // cluster)
            if cluster > hw:
                continue
            for threads in (256, 512):
                threads -= threads % whole
                packs = next((k for k in groupnorm.BF16_PACKS if k * (threads // vs) >= part),
                             None)
                if packs is None:
                    continue
                if packs == 1:
                    threads = min(threads, -(-part * vs // whole) * whole)
                plan = groupnorm.Bf16Plan(seg, cluster, threads, packs, part)
                if plan not in plans:
                    plans.append(plan)
    return plans


@contextlib.contextmanager
def forced_plan(groupnorm, plan, shape=None):
    """The bf16 K2 launches under ``plan``: at every shape, or only at
    ``shape`` ``(n, hw, c)`` (its own plan elsewhere)."""
    real = groupnorm.bf16_plan

    def forced(n, hw, c, *args, **kwargs):
        return plan if shape in (None, (n, hw, c)) else real(n, hw, c, *args, **kwargs)

    groupnorm.bf16_plan = forced
    try:
        yield
    finally:
        groupnorm.bf16_plan = real


def hold(chip_smoke, name: str, label: str, fn, plain, args) -> float:
    """``fn(*args)`` against ``plain(*args)`` under phase (c)'s gate
    (``chip_smoke.tolerance``; in bf16 also ``BF16_SHARE``); returns the max
    abs error."""
    got, want = fn(*args), plain(*args)
    diff = (got.float() - want.float()).abs()
    tol, fp32_rounding = chip_smoke.tolerance(name, args, want)
    err, share = diff.max().item(), (diff > fp32_rounding).float().mean().item()
    if not name.endswith("_bf16"):
        share = 0.0  # fp32: the tolerance alone
    if not (err <= tol and share <= chip_smoke.BF16_SHARE):
        raise SystemExit(f"{label}: max abs err {err} (tol {tol}), {share} of the elements "
                         f"differ beyond {fp32_rounding}")
    return err


def compare_bf16(randn, old_gn, old_step, chip_smoke, groupnorm, sampler_step) -> int:
    """The bf16 instances: old vs new in turns, then the new plans' sweeps."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    c_eps, inv_sqrt_a, sigma = 0.019, 1.0004, 0.011  # a mid-chain step's scale
    k1, k2 = [], []  # (label, args)
    for label, b, hw, c, cfg, tanh in (("serve w=2", 16, 64, 128, True, False),
                                       ("serve w=0", 16, 64, 128, False, False),
                                       ("exact chain", 4, 64, 128, False, False),
                                       ("deep, tanh", 10, 128, 128, False, True),
                                       ("big, tanh", 10, 128, 256, False, True)):
        h = randn(2 * b if cfg else b, hw, hw, c).relu().to(bf)
        weight = randn(1, c, 3, 3).mul(1 / (3 * c**0.5)).to(bf)
        k1.append((f"K1 bf16 {label} h{tuple(h.shape)}",
                   (h, weight, randn(1).to(bf), randn(b, hw, hw, 1), randn(b, hw, hw, 1),
                    c_eps, inv_sqrt_a, sigma, 2.0 if cfg else None, tanh)))
    for label, n, hw, c, act, film in (("up0_norm + FiLM, serve w=2", 32, 16, 256, "relu", True),
                                       ("out_norm, serve w=2", 32, 64, 128, "relu", False),
                                       ("up0_norm + FiLM, serve w=0", 16, 16, 256, "relu", True),
                                       ("out_norm, serve w=0", 16, 64, 128, "relu", False),
                                       ("up0_norm + FiLM, exact chain", 4, 16, 256, "relu", True),
                                       ("out_norm, exact chain", 4, 64, 128, "relu", False),
                                       ("deep up0_norm + FiLM", 10, 16, 512, "leaky_relu", True),
                                       ("big up0_norm + FiLM", 10, 16, 1024, "gelu", True),
                                       ("deep out_norm", 10, 128, 128, "leaky_relu", False),
                                       ("big out_norm", 10, 128, 256, "gelu", False)):
        rows = (randn(n, c).to(bf), randn(1, c).to(bf)) if film else None
        k2.append((f"K2 bf16 {label} {(n, hw, hw, c)}",
                   ((randn(n, hw, hw, c) * 3 + 1).to(bf), randn(c), randn(c), 8, 1e-5, act,
                    rows)))

    def gn_old(x, gamma, beta, groups, eps, act, rows):
        return old_gn.fused_groupnorm_act(x, gamma, beta, groups, eps, act, rows)

    # The layer before out_norm in the served step (out_conv1: a cuDNN bf16
    # conv of 256 to 128 channels at 64x64, decoder batch 32), and a tiny
    # elementwise kernel, each launched before a timed call.
    u = randn(32, 256, 64, 64).to(bf).contiguous(memory_format=torch.channels_last)
    w_conv = randn(128, 256, 3, 3).mul(0.02).to(bf).contiguous(
        memory_format=torch.channels_last)
    tiny = u.new_zeros(1024)
    timers = {"cold": chip_smoke.time_ms,
              "warm": functools.partial(chip_smoke.time_ms, warm=True), "lone": lone_ms,
              "after conv": functools.partial(
                  lone_ms, before=lambda: F.conv2d(u, w_conv, padding=1)),
              "after add": functools.partial(lone_ms, before=lambda: tiny.add_(1))}

    for kernel, cases, f_old, f_new, f_plain in (
            ("head_step_bf16", k1, old_step.fused_head_step, sampler_step.fused_head_step,
             sampler_step.head_step_plain),
            ("groupnorm_act_bf16", k2, gn_old, groupnorm.fused_groupnorm_act,
             groupnorm.groupnorm_act_plain)):
        for label, a in cases:
            errs = [hold(chip_smoke, kernel, label, f, f_plain, a) for f in (f_old, f_new)]
            for how, timer in timers.items():
                t = [timer(f, a) for f in (f_old, f_new, f_new, f_old)]
                o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                print(f"{label} [{how}]: old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} {t[2]:.5f} "
                      f"ms (mean old {o:.5f}, new {nw:.5f}, old/new {o / nw:.2f}); "
                      f"max abs err old {errs[0]:.2e} new {errs[1]:.2e}", flush=True)

    # The new designs at each band height and cluster size their plans
    # choose from, forced through the plans' module constants.
    rows_all = sampler_step.ROWS_BF16
    for label, a in k1:
        b, hw, c = a[3].shape[0], a[3].shape[1], a[0].shape[-1]
        picked = sampler_step.bf16_plan(b, hw, hw, c, cfg=a[8] is not None)
        times = {}
        for rows in rows_all:
            sampler_step.ROWS_BF16 = (rows,)
            try:
                sampler_step.bf16_plan(b, hw, hw, c, cfg=a[8] is not None)
            except ValueError:
                continue
            hold(chip_smoke, "head_step_bf16", f"{label} rows={rows}",
                 sampler_step.fused_head_step, sampler_step.head_step_plain, a)
            times[rows] = chip_smoke.time_ms(sampler_step.fused_head_step, a)
        sampler_step.ROWS_BF16 = rows_all
        print(f"new {label} by band rows: "
              + ", ".join(f"{k}: {v:.5f} ms" for k, v in times.items())
              + f" (the plan picks {tuple(picked)})", flush=True)
    for label, a in k2:
        n, hw, c = a[0].shape[0], a[0].shape[1] * a[0].shape[2], a[0].shape[-1]
        picked = groupnorm.bf16_plan(n, hw, c, 8)
        print(f"new {label} by plan (seg, cluster, threads, packs, part_px), ms cold / "
              f"after conv; the plan picks {tuple(picked)}:", flush=True)
        for plan in k2_bf16_candidates(groupnorm, n, hw, c):
            with forced_plan(groupnorm, plan):
                hold(chip_smoke, "groupnorm_act_bf16", f"{label} plan={tuple(plan)}",
                     groupnorm.fused_groupnorm_act, groupnorm.groupnorm_act_plain, a)
                t = [timers[how](groupnorm.fused_groupnorm_act, a)
                     for how in ("cold", "after conv")]
            print(f"  {tuple(plan)} ctas {plan.ctas(n, 8)}: {t[0]:.5f} / {t[1]:.5f}"
                  + (" <- picked" if plan == picked else ""), flush=True)
    return 0


def sharded_candidates(groupnorm, n: int, hw: int, c: int, eb: int, groups: int = 8):
    """Every plan the statistics and apply kernels take for ``n`` samples
    of ``hw`` pixels and ``c`` channels of ``eb`` bytes: statistics units
    of 1 to 8 groups (one where the butterfly cannot split a group's
    packs) and clusters of 1 to 8 at 256 and 512 threads; apply 1 to 16
    packs a thread at 256 and 512 threads."""
    cg = c // groups
    vec = 16 // eb
    vpg = cg // vec
    stats, apply = [], []
    for seg in (1, 2, 4, 8):
        vs = seg * vpg
        if groups % seg or (seg > 1 and vs & (vs - 1)) or math.lcm(32, vs) > 512:
            continue
        for cluster in (1, 2, 4, 8):
            if cluster > hw:
                continue
            part = -(-hw // cluster)
            whole = math.lcm(32, vs)
            for threads in (256, 512):
                threads = min(max(whole, threads - threads % whole),
                              -(-part * vs // whole) * whole)
                plan = groupnorm.StatsPlan(vec, seg, cluster, threads, part)
                if plan not in stats:
                    stats.append(plan)
    vpp = c // vec
    for threads in (256, 512):
        if threads % math.lcm(32, vpp):
            continue
        for packs in (1, 2, 4, 8, 16):
            apply.append(groupnorm.ApplyPlan(vec, threads, threads // vpp * packs))
    return stats, apply


@contextlib.contextmanager
def forced(module, name: str, plan):
    """``module.name`` (a plan function) returns ``plan`` inside."""
    real = getattr(module, name)
    setattr(module, name, lambda *a, **k: plan)
    try:
        yield
    finally:
        setattr(module, name, real)


def sass_counts(build, names) -> dict:
    """SASS instructions of each kernel of the checkout's library whose
    (mangled) name holds one of ``names``, from ``cuobjdump -sass``."""
    import re

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(build.build())], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1) if any(n in m.group(1) for n in names) else None
            if current:
                counts[current] = 0
        elif current and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[current] += 1
    return counts


def after(fn, args, before, n: int = 20) -> float:
    """Device ms of one ``fn(*args)`` right after ``before()``: CUDA
    events around the call, the median of ``n``.  A spin kernel first
    keeps the card busy while the host enqueues the conv, the events and
    the call, so no host gap is timed (no profiler: its traces of these
    launches after a large conv can hold no kernel)."""
    import torch

    fn(*args)
    before()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        before()
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def kernel_alone_ms(chip_smoke, fn, args, key: str, n: int = 24) -> float:
    """Device ms of the kernels whose name holds ``key`` per call of
    ``fn(*args)``, from the profiler (host activity traced too), each call
    on its own copy of the tensors, the copies more than the L2's bytes:
    the kernel's own time, without the other launches ``fn`` makes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    copies = -(-chip_smoke.FLUSH_BYTES // chip_smoke.nbytes(*args))
    sets = [chip_smoke.copy_args(args) for _ in range(copies)]
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*sets[i % copies])
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key)
    if not us > 0:
        raise SystemExit(f"kernel_alone_ms: no {key} kernel in the trace")
    return us / n / 1e3


def compare_halo(randn, old_step, chip_smoke, sampler_step) -> int:
    """K1's halo mode: old vs new in turns, the new plans' band heights,
    and the fp32 halo kernel on the whole w=2 map."""
    import torch
    import torch.nn.functional as F

    from camels_diffusion_model_tpu_torch.ops import _build

    for name, n in sass_counts(_build, ("head_step_halo_f32_kernel", "head_step_bf16_kernel",
                                        "head_step_bf16_halo_kernel")).items():
        print(f"SASS {n} instructions: {name}", flush=True)
    c_eps, inv_sqrt_a, sigma = 0.019, 1.0004, 0.011  # a mid-chain step's scale
    b = 16

    def template_route(units, height, width, c, dtype, cout=1, cfg=True, aligned=True,
                       halo=False, sms=sampler_step.SMS):
        return sampler_step.HALO_GENERIC_NAMES[dtype], sampler_step.launch_plan(
            units, height, width, c, cout, cfg, aligned, sms, sampler_step.ELEMENT_BYTES[dtype])

    def template_step(*a):
        """The halo launch through the float template whatever the shape."""
        real = sampler_step.route
        sampler_step.route = template_route
        try:
            return sampler_step.fused_head_step(*a)
        finally:
            sampler_step.route = real

    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        u = randn(2 * b, 256, 32, 64).to(dtype).contiguous(memory_format=torch.channels_last)
        w_conv = randn(128, 256, 3, 3).mul(0.02).to(dtype).contiguous(
            memory_format=torch.channels_last)

        def before(u=u, w_conv=w_conv):
            return F.conv2d(u, w_conv, padding=1)

        weight = randn(1, 128, 3, 3).mul(1 / (3 * 128**0.5)).to(dtype).contiguous(
            memory_format=torch.channels_last)  # as the model holds it: no copy a launch
        bias = randn(1).to(dtype)
        h = randn(2 * b, 32, 64, 128).relu().to(dtype)
        halo = tuple(randn(2 * b, 64, 128).relu().to(dtype) for _ in range(2))
        x, z = randn(b, 32, 64, 1), randn(b, 32, 64, 1)
        a = (h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, 2.0, False, halo)
        name = f"head_step_halo{sfx}"
        label = f"K1 halo {dtype} half of the w=2 features h{tuple(h.shape)}"
        out = sampler_step.fused_head_step(*a)
        nb = chip_smoke.nbytes(*a, out)
        peak = chip_smoke.BF16_FLOPS if sfx else chip_smoke.FP32_FLOPS
        bound = max(nb / chip_smoke.HBM_BYTES_PER_S, (h.numel() * 18 + x.numel() * 8) / peak) * 1e3

        def held(fn, title, a=a):
            got, want = fn(*a), sampler_step.head_step_plain(*a)
            err = (got - want).abs().max().item()
            tol = chip_smoke.tolerance(name, a, want)[0]
            if not err <= tol:
                raise SystemExit(f"{title}: max abs err {err} > {tol}")
            return err

        errs = [held(f, label) for f in (old_step.fused_head_step, sampler_step.fused_head_step)]
        for how, timer in (("cold", chip_smoke.time_ms),
                           ("after conv", functools.partial(after, before=before))):
            t = [timer(f, a) for f in (old_step.fused_head_step, sampler_step.fused_head_step,
                                       sampler_step.fused_head_step, old_step.fused_head_step)]
            o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"{label} [{how}]: old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} {t[2]:.5f} ms "
                  f"(mean old {o:.5f}, new {nw:.5f}, old/new {o / nw:.2f}); bound {bound:.6f} "
                  f"ms ({nb} bytes): share old {bound / o:.3f} new {bound / nw:.3f}; max err "
                  f"old {errs[0]:.2e} new {errs[1]:.2e}", flush=True)
        alone = [kernel_alone_ms(chip_smoke, f, a, "head_step")
                 for f in (old_step.fused_head_step, sampler_step.fused_head_step,
                           sampler_step.fused_head_step, old_step.fused_head_step)]
        o, nw = (alone[0] + alone[3]) / 2, (alone[1] + alone[2]) / 2
        print(f"{label} [kernel alone, profiler]: old {alone[0]:.5f} {alone[3]:.5f} new "
              f"{alone[1]:.5f} {alone[2]:.5f} ms (mean old {o:.5f}, new {nw:.5f}, old/new "
              f"{o / nw:.2f}); share old {bound / o:.3f} new {bound / nw:.3f}", flush=True)
        # The checkout's float template's halo mode (the halo rows as two
        # pointers, as the new kernels take them) against the new kernel:
        # the kernel each forks from, without the earlier wrapper's row copy.
        errs = [held(f, label) for f in (template_step, sampler_step.fused_head_step)]
        for how, timer in (("cold", chip_smoke.time_ms),
                           ("after conv", functools.partial(after, before=before)),
                           ("kernel alone, profiler",
                            functools.partial(kernel_alone_ms, chip_smoke, key="head_step"))):
            t = [timer(f, a) for f in (template_step, sampler_step.fused_head_step,
                                       sampler_step.fused_head_step, template_step)]
            o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"{label} [template vs new, {how}]: template {t[0]:.5f} {t[3]:.5f} new "
                  f"{t[1]:.5f} {t[2]:.5f} ms (mean template {o:.5f}, new {nw:.5f}, "
                  f"template/new {o / nw:.2f}); share template {bound / o:.3f} new "
                  f"{bound / nw:.3f}; max err template {errs[0]:.2e} new {errs[1]:.2e}",
                  flush=True)
        rows_name = "ROWS_BF16" if sfx else "ROWS_HALO"
        plan_fn = sampler_step.bf16_plan if sfx else sampler_step.halo_plan
        rows_all = getattr(sampler_step, rows_name)
        picked = plan_fn(b, 32, 64, 128)
        times = {}
        for rows in rows_all:
            setattr(sampler_step, rows_name, (rows,))
            try:
                plan = plan_fn(b, 32, 64, 128)
                held(sampler_step.fused_head_step, f"{label} rows={rows}")
                times[rows] = (plan.ctas, chip_smoke.time_ms(sampler_step.fused_head_step, a),
                               after(sampler_step.fused_head_step, a, before))
            except ValueError:
                pass
            finally:
                setattr(sampler_step, rows_name, rows_all)
        print(f"new {label} by band rows (CTAs, ms cold, ms after conv): "
              + ", ".join(f"{k}: {v[0]}, {v[1]:.5f}, {v[2]:.5f}" for k, v in times.items())
              + f" (the plan picks {tuple(picked)})", flush=True)

    # The unsharded bf16 launch at the w=2 serving shape, old and new in
    # turns: the bf16 kernel serves both modes.
    h = randn(2 * b, 64, 64, 128).relu().bfloat16()
    weight = randn(1, 128, 3, 3).mul(1 / (3 * 128**0.5)).bfloat16().contiguous(
        memory_format=torch.channels_last)
    x, z = randn(b, 64, 64, 1), randn(b, 64, 64, 1)
    a = (h, weight, randn(1).bfloat16(), x, z, c_eps, inv_sqrt_a, sigma, 2.0)
    t = [chip_smoke.time_ms(f, a) for f in (old_step.fused_head_step, sampler_step.fused_head_step,
                                           sampler_step.fused_head_step, old_step.fused_head_step)]
    print(f"unsharded bf16 launch, w=2 h{tuple(h.shape)}: old {t[0]:.5f} {t[3]:.5f} new "
          f"{t[1]:.5f} {t[2]:.5f} ms (old/new {(t[0] + t[3]) / (t[1] + t[2]):.2f})", flush=True)

    # Information: the fp32 halo kernel on the whole w=2 map (its halo
    # rows zero: the unsharded step) against the unsharded fp32 launch.
    h = randn(2 * b, 64, 64, 128).relu()
    weight = randn(1, 128, 3, 3).mul(1 / (3 * 128**0.5)).contiguous(
        memory_format=torch.channels_last)
    x, z = randn(b, 64, 64, 1), randn(b, 64, 64, 1)
    a = (h, weight, randn(1), x, z, c_eps, inv_sqrt_a, sigma, 2.0)

    def as_halo(*a):
        return sampler_step.fused_head_step(*a, halo=(None, None))

    want = sampler_step.head_step_plain(*a)
    errs = [(f(*a) - want).abs().max().item() for f in (sampler_step.fused_head_step, as_halo)]
    nb = chip_smoke.nbytes(*a, want)
    t = [chip_smoke.time_ms(f, a) for f in (sampler_step.fused_head_step, as_halo, as_halo,
                                           sampler_step.fused_head_step)]
    print(f"whole w=2 map h{tuple(h.shape)}: unsharded fp32 launch {t[0]:.5f} {t[3]:.5f}, "
          f"fp32 halo kernel with zero halo rows {t[1]:.5f} {t[2]:.5f} ms (plan "
          f"{tuple(sampler_step.halo_plan(b, 64, 64, 128))}); bound "
          f"{nb / chip_smoke.HBM_BYTES_PER_S * 1e3:.6f} ms; max err {errs[0]:.2e} "
          f"{errs[1]:.2e}", flush=True)
    return 0


def narrow_candidates(groupnorm, n: int, hw: int, c: int, groups: int = 8) -> list:
    """Every launch plan the narrow bf16 K2 takes for ``n`` samples of
    ``hw`` pixels and ``c`` channels: units of the fewest groups whose
    slice of a pixel is whole packs, doubled up to 8 groups and 256
    channels, clusters of 1 to 8, 256 or 512 threads (whole warps and
    pixels) with the fewest packs of ``NARROW_PACKS`` that cover a part."""
    cg = c // groups
    plans = []
    seg = 8 // math.gcd(cg, 8)
    while seg <= 8 and groups % seg == 0 and seg * cg <= 256:
        vs = seg * cg // 8
        whole = math.lcm(32, vs)
        for cluster in (1, 2, 4, 8):
            part = -(-hw // cluster)
            for threads in (256, 512):
                threads -= threads % whole
                if threads == 0:
                    continue
                packs = next((k for k in groupnorm.NARROW_PACKS
                              if k * (threads // vs) >= part), None)
                if packs is None:
                    continue
                if packs == groupnorm.NARROW_PACKS[0]:
                    threads = min(threads, -(-part * vs // whole) * whole)
                plan = groupnorm.NarrowPlan(seg, cluster, threads, packs, part)
                if plan not in plans:
                    plans.append(plan)
        seg *= 2
    return plans


def route_generic_gn(groupnorm, *a):
    """K2 through the float kernel's bf16 instance whatever the shape."""
    real = groupnorm.single_route
    groupnorm.single_route = lambda n, hw, c, groups, dtype, aligned=True, sms=132: (
        groupnorm.BF16_GENERIC_NAME, groupnorm.launch_plan(n, hw, c, groups, aligned, 2))
    try:
        return groupnorm.fused_groupnorm_act(*a)
    finally:
        groupnorm.single_route = real


def route_generic_step(sampler_step, *a):
    """K1 (either mode) through the float kernel's bf16 instance of
    ``sampler_step``: an earlier revision's (``--old``, PRs 15-18), since
    the checkout's split launch took over its last shapes."""
    real = sampler_step.route

    def route(units, height, width, c, dtype, cout=1, cfg=True, aligned=True, halo=False,
              sms=sampler_step.SMS):
        return ((sampler_step.HALO_GENERIC_NAMES[dtype] if halo
                 else sampler_step.BF16_GENERIC_NAME),
                sampler_step.launch_plan(units, height, width, c, cout, cfg, aligned, sms, 2))

    sampler_step.route = route
    try:
        return sampler_step.fused_head_step(*a)
    finally:
        sampler_step.route = real


def gn_lib(x, gamma, beta, *_):
    """The library call beside K2: ``F.group_norm`` in x's dtype."""
    import torch.nn.functional as F

    return F.group_norm(x.permute(0, 3, 1, 2), 8, gamma.to(x.dtype), beta.to(x.dtype), 1e-5)


def conv_lib(h, weight, bias, *_):
    """The library call beside K1: the output conv, ``F.conv2d``."""
    import torch.nn.functional as F

    return F.conv2d(h.permute(0, 3, 1, 2), weight, bias, padding=1)


def generic_turns(chip_smoke, label, name, old, new, plain, lib, args, flops, before, key):
    """Hold both, then time old (the generic instance), new, new, old
    three ways (cold, right after ``before()``, the kernel alone), beside
    the bound and the library call ``lib`` cold."""
    errs = [hold(chip_smoke, name, label, f, plain, args) for f in (old, new)]
    nb = chip_smoke.nbytes(*args, plain(*args))
    b = max(nb / chip_smoke.HBM_BYTES_PER_S, flops / chip_smoke.BF16_FLOPS) * 1e3
    lib_ms = chip_smoke.time_ms(lib, args)
    for how, timer in (("cold", chip_smoke.time_ms),
                       ("after conv", functools.partial(after, before=before)),
                       ("kernel alone, profiler",
                        functools.partial(kernel_alone_ms, chip_smoke, key=key))):
        t = [timer(f, args) for f in (old, new, new, old)]
        o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"{label} [{how}]: generic {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} {t[2]:.5f} "
              f"ms (mean generic {o:.5f}, new {nw:.5f}, generic/new {o / nw:.2f}); bound "
              f"{b:.6f} ms ({nb} bytes): share generic {b / o:.3f} new {b / nw:.3f}; "
              f"library {lib_ms:.5f} ms (library/new {lib_ms / nw:.2f}); max err generic "
              f"{errs[0]:.2e} new {errs[1]:.2e}", flush=True)


def compare_narrow(randn, old_gn, old_step, chip_smoke, groupnorm, sampler_step,
                   prev=None) -> int:
    """The narrow bf16 kernels: the generic instances vs new in turns at
    the narrow models' shapes, their sweeps, and the served 64-channel bf16
    K1 in turns; with ``prev`` (an earlier revision's groupnorm and
    sampler_step modules that have the narrow kernels), that revision's
    narrow launches vs the checkout's in turns, cold and after the conv."""
    import torch
    import torch.nn.functional as F

    from camels_diffusion_model_tpu_torch.ops import _build

    for name, n in sass_counts(_build, ("head_step_bf16_kernel", "head_step_bf16_halo_kernel",
                                        "groupnorm_bf16_narrow_kernel")).items():
        print(f"SASS {n} instructions: {name}", flush=True)
    bf = torch.bfloat16
    c_eps, inv_sqrt_a, sigma = 0.019, 1.0004, 0.011  # a mid-chain step's scale
    cl = torch.channels_last
    turns = functools.partial(generic_turns, chip_smoke)
    generic_gn = functools.partial(route_generic_gn, groupnorm)
    generic_step = functools.partial(route_generic_step, old_step)

    k1, k2 = [], []  # (label, args, before)
    for n_feat, maps in ((32, 2), (32, 16), (96, 16), (160, 16)):
        n = 2 * maps
        u = randn(n, 2 * n_feat, 64, 64).to(bf).contiguous(memory_format=cl)
        w_conv = randn(n_feat, 2 * n_feat, 3, 3).mul(0.02).to(bf).contiguous(memory_format=cl)

        def before(u=u, w_conv=w_conv):  # out_conv1: 2 n_feat to n_feat channels
            return F.conv2d(u, w_conv, padding=1)

        k2.append((f"K2 narrow, out_norm n_feat {n_feat}, {maps} maps {(n, 64, 64, n_feat)}",
                   ((randn(n, 64, 64, n_feat) * 3 + 1).to(bf), randn(n_feat), randn(n_feat), 8,
                    1e-5, "relu", None), before))
        h = randn(n, 64, 64, n_feat).relu().to(bf)
        weight = randn(1, n_feat, 3, 3).mul(1 / (3 * n_feat**0.5)).to(bf).contiguous(
            memory_format=cl)
        k1.append((f"K1 narrow, n_feat {n_feat}, {maps} maps h{tuple(h.shape)}",
                   (h, weight, randn(1).to(bf), randn(maps, 64, 64, 1), randn(maps, 64, 64, 1),
                    c_eps, inv_sqrt_a, sigma, 2.0, False), before))
    for label, a, before in k2:
        turns(label, "groupnorm_act_narrow_bf16", generic_gn, groupnorm.fused_groupnorm_act,
              groupnorm.groupnorm_act_plain, gn_lib, a, a[0].numel() * 10, before, "groupnorm")
    for label, a, before in k1:
        turns(label, "head_step_narrow_bf16", generic_step, sampler_step.fused_head_step, sampler_step.head_step_plain, conv_lib, a,
              a[0].numel() * 18 + a[3].numel() * 8, before, "head_step")
    if prev is not None:  # an earlier revision's narrow kernels, in turns
        for kernel, cases, f_prev, f_new in (
                ("groupnorm_act_narrow_bf16", k2, prev[0].fused_groupnorm_act,
                 groupnorm.fused_groupnorm_act),
                ("head_step_narrow_bf16", k1, prev[1].fused_head_step,
                 sampler_step.fused_head_step)):
            plain = (groupnorm.groupnorm_act_plain if kernel.startswith("groupnorm")
                     else sampler_step.head_step_plain)
            for label, a, before in cases:
                for f in (f_prev, f_new):
                    hold(chip_smoke, kernel, label, f, plain, a)
                for how, timer in (("cold", chip_smoke.time_ms),
                                   ("after conv", functools.partial(after, before=before))):
                    t = [timer(f, a) for f in (f_prev, f_new, f_new, f_prev)]
                    print(f"{label} [prev vs new, {how}]: prev {t[0]:.5f} {t[3]:.5f} new "
                          f"{t[1]:.5f} {t[2]:.5f} ms (prev/new "
                          f"{(t[0] + t[3]) / (t[1] + t[2]):.3f})", flush=True)
    # K1's narrow halo mode at half of n_feat 32's 16-map features.
    h = randn(32, 32, 64, 32).relu().to(bf)
    halo = tuple(randn(32, 64, 32).relu().to(bf) for _ in range(2))
    a = (h, k1[1][1][1], k1[1][1][2], randn(16, 32, 64, 1), randn(16, 32, 64, 1), c_eps,
         inv_sqrt_a, sigma, 2.0, False, halo)
    turns(f"K1 narrow halo, half of n_feat 32's 16 maps h{tuple(h.shape)}",
          "head_step_halo_narrow_bf16", generic_step, sampler_step.fused_head_step,
          sampler_step.head_step_plain, conv_lib, a, h.numel() * 18 + a[3].numel() * 8,
          k1[1][2], "head_step")

    # The new designs under every band height and ring (K1) and plan (K2).
    rows_all = sampler_step.ROWS_BF16
    for label, a, before in k1:
        b, c = a[3].shape[0], a[0].shape[-1]
        picked = sampler_step.bf16_plan(b, 64, 64, c)
        print(f"new {label} by band rows: ms cold / after conv; the plan picks "
              f"{tuple(picked)}:", flush=True)
        for rows in rows_all:
            sampler_step.ROWS_BF16 = (rows,)
            try:
                plan = sampler_step.bf16_plan(b, 64, 64, c)
                hold(chip_smoke, "head_step_narrow_bf16", f"{label} rows={rows}",
                     sampler_step.fused_head_step, sampler_step.head_step_plain, a)
                t = (chip_smoke.time_ms(sampler_step.fused_head_step, a),
                     after(sampler_step.fused_head_step, a, before))
            except ValueError:
                continue
            finally:
                sampler_step.ROWS_BF16 = rows_all
            print(f"  rows {rows} ctas {plan.ctas}: {t[0]:.5f} / {t[1]:.5f}"
                  + (" <- picked" if plan == picked else ""), flush=True)
    for label, a, before in k2:
        n, hw, c = a[0].shape[0], a[0].shape[1] * a[0].shape[2], a[0].shape[-1]
        picked = groupnorm.narrow_plan(n, hw, c, 8)
        print(f"new {label} by plan (seg, cluster, threads, packs, part_px), ms cold / "
              f"after conv; the plan picks {tuple(picked)}:", flush=True)
        for plan in narrow_candidates(groupnorm, n, hw, c):
            with forced(groupnorm, "narrow_plan", plan):
                hold(chip_smoke, "groupnorm_act_narrow_bf16", f"{label} plan={tuple(plan)}",
                     groupnorm.fused_groupnorm_act, groupnorm.groupnorm_act_plain, a)
                t = (chip_smoke.time_ms(groupnorm.fused_groupnorm_act, a),
                     after(groupnorm.fused_groupnorm_act, a, before))
            print(f"  {tuple(plan)} ctas {plan.ctas(n, 8)}: {t[0]:.5f} / {t[1]:.5f}"
                  + (" <- picked" if plan == picked else ""), flush=True)

    # The served 64-channel bf16 K1, which now shares its body with the
    # narrow item: unsharded at w=2, and its halo mode at phase (r1)'s shape.
    weight = randn(1, 128, 3, 3).mul(1 / (3 * 128**0.5)).bfloat16().contiguous(memory_format=cl)
    bias = randn(1).bfloat16()
    h = randn(32, 64, 64, 128).relu().bfloat16()
    served = [("unsharded, w=2 h(32,64,64,128)", (h, weight, bias, randn(16, 64, 64, 1),
                                                   randn(16, 64, 64, 1), c_eps, inv_sqrt_a,
                                                   sigma, 2.0, False))]
    h = randn(32, 32, 64, 128).relu().bfloat16()
    halo = tuple(randn(32, 64, 128).relu().bfloat16() for _ in range(2))
    served.append(("halo, half of the w=2 features h(32,32,64,128)",
                   (h, weight, bias, randn(16, 32, 64, 1), randn(16, 32, 64, 1), c_eps,
                    inv_sqrt_a, sigma, 2.0, False, halo)))
    for label, a in served:
        name = "head_step_halo_bf16" if len(a) > 10 else "head_step_bf16"
        errs = [hold(chip_smoke, name, label, f, sampler_step.head_step_plain, a)
                for f in (old_step.fused_head_step, sampler_step.fused_head_step)]
        ratios = []
        for _ in range(3):
            t = [chip_smoke.time_ms(f, a) for f in (old_step.fused_head_step,
                                                   sampler_step.fused_head_step,
                                                   sampler_step.fused_head_step,
                                                   old_step.fused_head_step)]
            ratios.append((t[0] + t[3]) / (t[1] + t[2]))
            print(f"served bf16 K1 {label}: old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} "
                  f"{t[2]:.5f} ms (old/new {ratios[-1]:.3f}); max err old {errs[0]:.2e} new "
                  f"{errs[1]:.2e}", flush=True)
        print(f"served bf16 K1 {label}: old/new by round "
              + ", ".join(f"{r:.3f}" for r in ratios), flush=True)
    return 0


def wide_candidates(groupnorm, n: int, hw: int, c: int, groups: int = 8) -> list:
    """Every launch plan the wide layout of the narrow bf16 K2 takes for
    ``n`` samples of ``hw`` pixels and ``c`` channels: ``narrow_plan``'s
    unit, CTAs of whole warps of 256 to 512 threads (the fewest idle lanes
    under each bound, :func:`idle_lane_threads`), clusters of 1 to 8 and
    4, 8 or 16 packs a round."""
    picked = groupnorm.narrow_plan(n, hw, c, groups)
    vs = picked.seg * (c // groups) // 8
    plans = []
    for threads in sorted({groupnorm.idle_lane_threads(vs, t) for t in (256, 384, 512)}):
        for cluster in (1, 2, 4, 8):
            if cluster > hw:
                continue
            for packs in groupnorm.NARROW_PACKS:
                plan = groupnorm.NarrowPlan(picked.seg, cluster, threads, packs,
                                            -(-hw // cluster), True)
                if plan not in plans:
                    plans.append(plan)
    return plans


def compare_generic(randn, old_gn, old_step, chip_smoke, groupnorm, sampler_step) -> int:
    """K1's narrow item with a masked last block and K2's wide layout: the
    checkout's generic instances vs new in turns at 2 and 16 maps, their
    sweeps, and the existing bf16 kernels (served w=2, the narrow widths)
    against the earlier package in turns."""
    import torch
    import torch.nn.functional as F

    from camels_diffusion_model_tpu_torch.ops import _build

    for name, n in sass_counts(_build, ("head_step_bf16_kernel", "head_step_bf16_halo_kernel",
                                        "groupnorm_bf16_narrow_kernel",
                                        "groupnorm_bf16_wide_kernel")).items():
        print(f"SASS {n} instructions: {name}", flush=True)
    bf = torch.bfloat16
    c_eps, inv_sqrt_a, sigma = 0.019, 1.0004, 0.011  # a mid-chain step's scale
    cl = torch.channels_last
    turns = functools.partial(generic_turns, chip_smoke)
    generic_gn = functools.partial(route_generic_gn, groupnorm)
    generic_step = functools.partial(route_generic_step, old_step)

    def conv_before(n, cin, cout, hw):  # the layer before a head: a conv to its channels
        u = randn(n, cin, hw, hw).to(bf).contiguous(memory_format=cl)
        w_conv = randn(cout, cin, 3, 3).mul(0.02).to(bf).contiguous(memory_format=cl)
        return lambda: F.conv2d(u, w_conv, padding=1)

    def k1_args(n_feat, maps, height=64, halo=False):
        h = randn(2 * maps, height, 64, n_feat).relu().to(bf)
        weight = randn(1, n_feat, 3, 3).mul(1 / (3 * n_feat**0.5)).to(bf).contiguous(
            memory_format=cl)
        rows = (tuple(randn(2 * maps, 64, n_feat).relu().to(bf) for _ in range(2)),) if halo \
            else ()
        return (h, weight, randn(1).to(bf), randn(maps, height, 64, 1),
                randn(maps, height, 64, 1), c_eps, inv_sqrt_a, sigma, 2.0, False, *rows)

    def k2_args(c, n, hw, film):
        rows = (randn(n, c).to(bf), randn(1, c).to(bf)) if film else None
        return ((randn(n, hw, hw, c) * 3 + 1).to(bf), randn(c), randn(c), 8, 1e-5, "relu", rows)

    k1 = [(f"K1 masked, n_feat {nf}, {maps} maps", k1_args(nf, maps),
           conv_before(2 * maps, 2 * nf, nf, 64))
          for nf, maps in ((40, 2), (40, 16), (264, 2), (264, 16), (48, 16), (8, 16))]
    k1 += [(f"K1 masked halo, half of n_feat {nf}'s {maps} maps", k1_args(nf, maps, 32, True),
            conv_before(2 * maps, 2 * nf, nf, 32)) for nf, maps in ((40, 16), (264, 16))]
    k2 = []
    for head, nf, maps in (("out_norm", 264, 2), ("out_norm", 264, 16), ("up0_norm", 264, 2),
                           ("up0_norm", 264, 16), ("out_norm", 280, 16), ("out_norm", 136, 16)):
        up0 = head == "up0_norm"
        c, hw = (2 * nf, 16) if up0 else (nf, 64)
        k2.append((f"K2 wide, {head}" + (" + FiLM" if up0 else "") + f" n_feat {nf}, "
                   f"{maps} maps {(2 * maps, hw, hw, c)}", k2_args(c, 2 * maps, hw, up0),
                   conv_before(2 * maps, c, c, hw)))
    for label, a, before in k2:
        flops = a[0].numel() * (12 if a[6] is not None else 10)
        turns(label, "groupnorm_act_wide_bf16", generic_gn, groupnorm.fused_groupnorm_act,
              groupnorm.groupnorm_act_plain, gn_lib, a, flops, before, "groupnorm")
    for label, a, before in k1:
        name = "head_step_halo_masked_bf16" if len(a) > 10 else "head_step_masked_bf16"
        turns(label, name, generic_step, sampler_step.fused_head_step,
              sampler_step.head_step_plain, conv_lib, a, a[0].numel() * 18 + a[3].numel() * 8,
              before, "head_step")

    # The new designs under every band height (K1) and plan (K2).
    rows_all = sampler_step.ROWS_BF16
    for label, a, before in k1:
        if len(a) > 10 or a[3].shape[0] != 16:
            continue
        b, c = a[3].shape[0], a[0].shape[-1]
        picked = sampler_step.bf16_plan(b, 64, 64, c)
        print(f"new {label} by band rows: ms cold / after conv; the plan picks "
              f"{tuple(picked)}:", flush=True)
        for rows in rows_all:
            sampler_step.ROWS_BF16 = (rows,)
            try:
                plan = sampler_step.bf16_plan(b, 64, 64, c)
                hold(chip_smoke, "head_step_masked_bf16", f"{label} rows={rows}",
                     sampler_step.fused_head_step, sampler_step.head_step_plain, a)
                t = (chip_smoke.time_ms(sampler_step.fused_head_step, a),
                     after(sampler_step.fused_head_step, a, before))
            finally:
                sampler_step.ROWS_BF16 = rows_all
            print(f"  rows {rows} ctas {plan.ctas}: {t[0]:.5f} / {t[1]:.5f}"
                  + (" <- picked" if plan == picked else ""), flush=True)
    for label, a, before in k2:
        n, hw, c = a[0].shape[0], a[0].shape[1] * a[0].shape[2], a[0].shape[-1]
        picked = groupnorm.narrow_plan(n, hw, c, 8)
        print(f"new {label} by plan (seg, cluster, threads, packs, part_px, wide), ms cold / "
              f"after conv; the plan picks {tuple(picked)}:", flush=True)
        for plan in wide_candidates(groupnorm, n, hw, c):
            with forced(groupnorm, "narrow_plan", plan):
                hold(chip_smoke, "groupnorm_act_wide_bf16", f"{label} plan={tuple(plan)}",
                     groupnorm.fused_groupnorm_act, groupnorm.groupnorm_act_plain, a)
                t = (chip_smoke.time_ms(groupnorm.fused_groupnorm_act, a),
                     after(groupnorm.fused_groupnorm_act, a, before))
            print(f"  {tuple(plan)} ctas {plan.ctas(n, 8)}: {t[0]:.5f} / {t[1]:.5f}"
                  + (" <- picked" if plan == picked else ""), flush=True)

    # The existing bf16 kernels against the earlier package, three rounds
    # in turns: the served w=2 K1 (unsharded, and its halo mode at phase
    # (r1)'s shape) and K2 heads, and the narrow kernels at n_feat 32, 96
    # and 160 (16 maps).
    existing = [("served K1 w=2 h(32,64,64,128)", "head_step_bf16", k1_args(128, 16)),
                ("served K1 halo, half of the w=2 features", "head_step_halo_bf16",
                 k1_args(128, 16, 32, True)),
                ("served K2 out_norm (32,64,64,128)", "groupnorm_act_bf16",
                 k2_args(128, 32, 64, False)),
                ("served K2 up0_norm + FiLM (32,16,16,256)", "groupnorm_act_bf16",
                 k2_args(256, 32, 16, True))]
    for nf in (32, 96, 160):
        existing += [(f"narrow K1 n_feat {nf}, 16 maps", "head_step_narrow_bf16",
                      k1_args(nf, 16)),
                     (f"narrow K2 out_norm n_feat {nf}, 16 maps", "groupnorm_act_narrow_bf16",
                      k2_args(nf, 32, 64, False))]
    for label, name, a in existing:
        mods = ((old_gn, groupnorm) if name.startswith("groupnorm")
                else (old_step, sampler_step))
        fns = [m.fused_groupnorm_act if name.startswith("groupnorm") else m.fused_head_step
               for m in mods]
        plain = (groupnorm.groupnorm_act_plain if name.startswith("groupnorm")
                 else sampler_step.head_step_plain)
        errs = [hold(chip_smoke, name, label, f, plain, a) for f in fns]
        ratios = []
        for _ in range(3):
            t = [chip_smoke.time_ms(f, a) for f in (fns[0], fns[1], fns[1], fns[0])]
            ratios.append((t[0] + t[3]) / (t[1] + t[2]))
            print(f"existing {label}: old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} {t[2]:.5f} ms "
                  f"(old/new {ratios[-1]:.3f}); max err old {errs[0]:.2e} new {errs[1]:.2e}",
                  flush=True)
        print(f"existing {label}: old/new by round " + ", ".join(f"{r:.3f}" for r in ratios),
              flush=True)
    return 0


def wide_turns(chip_smoke, label, name, old, new, plain, lib, args, flops):
    """Hold ``new`` (and ``old``, unless it raises for the shape) to
    ``plain``, then time old, new, new, old cold (new, new where old
    raises) beside the bound and the library call ``lib`` cold."""
    import torch

    err = hold(chip_smoke, name, label, new, plain, args)
    try:
        hold(chip_smoke, name, label, old, plain, args)
    except ValueError as e:
        old = None
        print(f"{label}: the --old package raises: {e}", flush=True)
    nb = chip_smoke.nbytes(*args, plain(*args))
    peak = chip_smoke.BF16_FLOPS if name.endswith("_bf16") else chip_smoke.FP32_FLOPS
    b = max(nb / chip_smoke.HBM_BYTES_PER_S, flops / peak) * 1e3
    lib_ms = chip_smoke.time_ms(lib, args)
    if old is not None:
        t = [chip_smoke.time_ms(f, args) for f in (old, new, new, old)]
        o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        times = (f"old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} {t[2]:.5f} ms (mean old {o:.5f}, "
                 f"new {nw:.5f}, old/new {o / nw:.2f})")
    else:
        t = [chip_smoke.time_ms(new, args) for _ in range(2)]
        nw = (t[0] + t[1]) / 2
        times = f"old raises; new {t[0]:.5f} {t[1]:.5f} ms (mean {nw:.5f})"
    print(f"{label}: {times}; bound {b:.6f} ms ({nb} bytes, {flops} operations): share "
          f"{b / nw:.3f}; library {lib_ms:.5f} ms (library/new {lib_ms / nw:.2f}); max err "
          f"{err:.2e}; card {torch.cuda.get_device_name(0)}", flush=True)
    return nw


def pair_sweep(chip_smoke, groupnorm, label, a) -> None:
    """K2's statistics and apply launches of the pair on one card, each
    alone (``groupnorm_stats``, ``groupnorm_apply`` with the one shard's
    partials), cold, under their picked plans and others: CTAs of 256 to
    1024 threads and (statistics) clusters of 1 to 8, (apply) parts of 4
    to 32 pixels."""
    import torch

    x, gamma, beta, groups, eps, act, rows = a
    n, hw, c = x.shape[0], x.shape[1] * x.shape[2], x.shape[-1]
    eb = x.element_size()
    sp, ap = groupnorm.stats_plan(n, hw, c, groups, True, eb), groupnorm.apply_plan(
        n, hw, c, groups, True, eb)
    parts = groupnorm.groupnorm_stats(x, groups)[None]
    cg = c // groups
    vs = (groupnorm.straddle_packs(groups, cg, sp.vec) if cg % sp.vec  # packs straddle groups
          else sp.seg * cg // sp.vec)
    vpp = c // ap.vec
    most = 1024 if ap.vec == 1 else 512
    stats_plans = {sp._replace(threads=t, cluster=cl, part_px=-(-hw // cl))
                   for t in {sp.threads, 256, 288, 320, 384, 512}
                   for cl in {sp.cluster, 1, 2, 4, 8}
                   if t <= groupnorm.STATS_MAX_THREADS and (t >= vs or vs > 512)
                   and (sp.seg == 1 or t % vs == 0)}
    threads = {ap.threads} | ({groupnorm.rounds_threads(vpp, m) for m in (256, 512, most)}
                              if vpp > most else set())
    apply_plans = {ap._replace(threads=t, part_px=p)
                   for t in threads for p in {ap.part_px, 4, 8, 16, 32}}
    for what, fn, fargs, name, plans, picked in (
            ("statistics", groupnorm.groupnorm_stats, (x, groups), "stats_plan", stats_plans, sp),
            ("apply", groupnorm.groupnorm_apply, (x, parts, gamma, beta, groups, eps, act, rows),
             "apply_plan", apply_plans, ap)):
        print(f"  {label}: the {what} launch by plan, ms cold; the plan picks {tuple(picked)}:",
              flush=True)
        for plan in sorted(plans):
            with forced(groupnorm, name, plan):
                fn(*fargs)
                torch.cuda.synchronize()
                ms = chip_smoke.time_ms(fn, fargs)
            print(f"    {tuple(plan)}: {ms:.5f}" + (" <- picked" if plan == picked else ""),
                  flush=True)


def arg_makers(randn):
    """``(k1_args, k2_args, k3_args)``: each kernel's arguments at a shape,
    drawn with ``randn`` (K1 at a mid-chain step's scale, out_conv2's init
    scale for the weights; K2's x at 3 x N(0, 1) + 1)."""
    c_eps, inv_sqrt_a, sigma = 0.019, 1.0004, 0.011  # a mid-chain step's scale

    def k1_args(dt, maps, height, width, c, halo=False, w=2.0, tanh=False):
        h = randn((2 if w is not None else 1) * maps, height, width, c).relu().to(dt)
        weight = randn(1, c, 3, 3).mul(1 / (3 * c**0.5)).to(dt)
        rows = (tuple(randn(h.shape[0], width, c).relu().to(dt) for _ in range(2)),) if halo \
            else ()
        return (h, weight, randn(1).to(dt), randn(maps, height, width, 1),
                randn(maps, height, width, 1), c_eps, inv_sqrt_a, sigma, w, tanh, *rows)

    def k2_args(dt, n, hw, c, act="relu", film_rows=False):
        rows = (randn(n, c).to(dt), randn(1, c).to(dt)) if film_rows else None
        return ((randn(n, hw, hw, c) * 3 + 1).to(dt), randn(c), randn(c), 8, 1e-5, act, rows)

    def k3_args(dt, n, hw, c):
        return randn(n, hw, hw, c).to(dt), randn(n, c).to(dt), randn(1, c).to(dt)

    return k1_args, k2_args, k3_args


def compare_wide(randn, old_build, old, chip_smoke, new) -> int:
    """The split K1, the K2 pair on one card and K3 at wide pixels against
    the earlier package where it takes the shapes, their sweeps, and the
    existing kernels against it in turns (module docstring, ``--wide``)."""
    import torch

    from camels_diffusion_model_tpu_torch.ops import _build

    old_gn, old_step, old_film = old
    groupnorm, sampler_step, film = new
    for label, build in (("old", old_build), ("new", _build)):
        for name, n in sass_counts(build, ("head_step_bf16_kernel", "head_step_bf16_halo_kernel",
                                           "head_step_halo_f32_kernel",
                                           "head_step_bf16_split_kernel",
                                           "head_step_f32_split_kernel")).items():
            print(f"SASS {label} {n} instructions: {name}", flush=True)
    k1_args, k2_args, k3_args = arg_makers(randn)
    f32, bf = torch.float32, torch.bfloat16
    sfx = {f32: "", bf: "_bf16"}
    k1 = [("split K1 bf16 h(2,8,8,6000), cfg w=2", bf, (1, 8, 8, 6000, False))]
    k1 += [(f"split K1 halo {dt_name}, half (2,4,8,6000), cfg w=2", dt, (1, 4, 8, 6000, True))
           for dt, dt_name in ((bf, "bf16"), (f32, "fp32"))]
    k1 += [("split K1 bf16 h(32,64,64,4840), cfg w=2", bf, (16, 64, 64, 4840, False)),
           ("split K1 fp32 h(32,64,64,3056), cfg w=2", f32, (16, 64, 64, 3056, False))]
    for label, dt, (maps, height, width, c, halo) in k1:
        a = k1_args(dt, maps, height, width, c, halo)
        name = f"head_step{'_halo' if halo else ''}_split{sfx[dt]}"
        wide_turns(chip_smoke, label, name, old_step.fused_head_step,
                   sampler_step.fused_head_step, sampler_step.head_step_plain, conv_lib, a,
                   a[0].numel() * 18 + a[3].numel() * 8)
        for key in ("head_step_bf16_split_kernel" if dt == bf else "head_step_f32_split_kernel",
                    "head_step_combine_kernel"):
            print(f"  {label}: {key} alone (profiler) "
                  f"{kernel_alone_ms(chip_smoke, sampler_step.fused_head_step, a, key):.5f} ms",
                  flush=True)
        span_all, rows_all = sampler_step.SPLIT_SPAN, sampler_step.ROWS_BF16
        picked = sampler_step.route(maps, height, width, c, dt, halo=halo)[1]
        print(f"  {label} by (range channels, band rows), ms cold; the plan picks "
              f"({picked.span}, {picked.rows}):", flush=True)
        try:
            for span in (64, 128, 256):
                for rows in rows_all:
                    sampler_step.SPLIT_SPAN, sampler_step.ROWS_BF16 = span, (rows,)
                    try:
                        plan = sampler_step.split_plan(maps, height, width, c,
                                                       element_bytes=a[0].element_size())
                    except ValueError:
                        continue
                    with forced(sampler_step, "route", (sampler_step.SPLIT_NAMES[dt], plan)):
                        hold(chip_smoke, name, f"{label} span {span} rows {rows}",
                             sampler_step.fused_head_step, sampler_step.head_step_plain, a)
                        ms = chip_smoke.time_ms(sampler_step.fused_head_step, a)
                    print(f"    ({span}, {rows}) ctas {plan.ctas}: {ms:.5f}", flush=True)
        finally:
            sampler_step.SPLIT_SPAN, sampler_step.ROWS_BF16 = span_all, rows_all
    for label, dt, (n, hw, c, act, film_rows) in (
            ("K2 pair fp32 out_norm (10,128,128,512), gelu", f32, (10, 128, 512, "gelu", False)),
            ("K2 pair fp32 up0_norm + FiLM (32,16,16,2064)", f32, (32, 16, 2064, "relu", True)),
            ("K2 pair bf16 up0_norm + FiLM (32,16,16,2064)", bf, (32, 16, 2064, "relu", True))):
        a = k2_args(dt, n, hw, c, act, film_rows)
        wide_turns(chip_smoke, label, f"groupnorm_act_pair{sfx[dt]}",
                   old_gn.fused_groupnorm_act, groupnorm.fused_groupnorm_act,
                   groupnorm.groupnorm_act_plain, gn_lib, a,
                   a[0].numel() * (12 if film_rows else 10))
        pair_sweep(chip_smoke, groupnorm, label, a)
    for label, dt, (n, hw, c) in (("K3 fp32 (4,32,32,8192)", f32, (4, 32, 8192)),
                                  ("K3 bf16 (4,32,32,8200)", bf, (4, 32, 8200))):
        a = k3_args(dt, n, hw, c)
        wide_turns(chip_smoke, label, f"film_wide{sfx[dt]}", old_film.fused_film,
                   film.fused_film, film.film_plain,
                   lambda x, scale, shift: torch.addcmul(shift[:, None, None, :], x,
                                                         scale[:, None, None, :]),
                   a, a[0].numel() * 2)

    existing_turns(randn, old, new, chip_smoke, k1_args, k2_args, k3_args)
    return 0


def forced_template(groupnorm, threads):
    """K2 on ``groupnorm``'s float template forced at every shape it
    plans, its CTA at a slice over ``SLICE_TARGET`` of ``threads``.  The
    ``--old`` package's (6ca23e3) template also plans the slices over
    ``SLICE_MAX`` that it spilled, which the checkout's refuses."""
    def fn(x, gamma, beta, groups, eps, act, rows):
        n, h, w, c = x.shape
        plan = groupnorm.launch_plan(n, h * w, c, groups)
        if plan.threads != groupnorm.THREADS:
            plan = plan._replace(threads=threads)
        with forced(groupnorm, "single_route", (groupnorm.C_NAME, plan)):
            return groupnorm.fused_groupnorm_act(x, gamma, beta, groups, eps, act, rows)
    return fn


def forced_pair(groupnorm, x, gamma, beta, groups, eps, act, rows):
    """K2 on the statistics and apply launches on one card, at any shape."""
    n, h, w, c = x.shape
    plan = groupnorm.PairPlan(groupnorm.stats_plan(n, h * w, c, groups),
                              groupnorm.apply_plan(n, h * w, c, groups))
    with forced(groupnorm, "single_route", (groupnorm.PAIR_NAMES[x.dtype], plan)):
        return groupnorm.fused_groupnorm_act(x, gamma, beta, groups, eps, act, rows)


def compare_template(randn, chip_smoke, old_gn, groupnorm) -> int:
    """The ``--old`` package's float template at large slices, at 384 and
    512 threads a CTA, against the checkout's pair on one card in turns
    (module docstring, ``--template``)."""
    import torch

    _, k2_args, _ = arg_makers(randn)
    card = torch.cuda.get_device_name(0)
    fns = {"template 384": forced_template(old_gn, 384),
           "template 512": forced_template(old_gn, 512),
           "pair": functools.partial(forced_pair, groupnorm)}
    for n, hw, c in ((10, 128, 320), (32, 128, 320), (10, 128, 384), (32, 128, 384),
                     (10, 128, 224), (10, 64, 224), (32, 64, 224)):
        label = f"({n},{hw},{hw},{c}), gelu"
        a = k2_args(torch.float32, n, hw, c, "gelu")
        name, plan = groupnorm.single_route(n, hw * hw, c, 8, torch.float32)
        for k, f in fns.items():
            hold(chip_smoke, "groupnorm_act", f"{label} {k}", f, groupnorm.groupnorm_act_plain, a)
        times = {k: [] for k in fns}
        for k in (list(fns) + list(fns)[::-1]) * 2:
            times[k].append(chip_smoke.time_ms(fns[k], a))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        b = chip_smoke.nbytes(*a, a[0]) / chip_smoke.HBM_BYTES_PER_S * 1e3
        print(f"K2 template {label}: route {name} {tuple(plan)}; in turns "
              + "; ".join(f"{k} {' '.join(f'{t:.5f}' for t in times[k])} (mean {mean[k]:.5f}, "
                          f"share {b / mean[k]:.3f})" for k in fns)
              + f"; 384/512 {mean['template 384'] / mean['template 512']:.3f}, pair/512 "
              f"{mean['pair'] / mean['template 512']:.3f}; bound {b:.6f} ms; library "
              f"{chip_smoke.time_ms(gn_lib, a):.5f} ms; card {card}", flush=True)
    # The checkout's template (no spill loop) against --old's under the same
    # plan, at the shapes the route still gives it, three rounds in turns.
    for n, hw, c, act, film in ((32, 64, 128, "relu", False), (32, 16, 256, "relu", True),
                                (10, 16, 512, "leaky_relu", True), (10, 16, 1024, "gelu", True),
                                (32, 64, 224, "gelu", False), (10, 128, 224, "gelu", False)):
        label = f"({n},{hw},{hw},{c}), {act}" + (" + FiLM" if film else "")
        a = k2_args(torch.float32, n, hw, c, act, film)
        name, plan = groupnorm.single_route(n, hw * hw, c, 8, torch.float32)
        if name != groupnorm.C_NAME:
            raise SystemExit(f"{label}: the route gives {name}, not the template")
        pair = {"old": forced_template(old_gn, plan.threads), "new": groupnorm.fused_groupnorm_act}
        for k, f in pair.items():
            hold(chip_smoke, "groupnorm_act", f"{label} {k}", f, groupnorm.groupnorm_act_plain, a)
        times = {k: [] for k in pair}
        for k in ("old", "new", "new", "old") * 3:
            times[k].append(chip_smoke.time_ms(pair[k], a))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        print(f"K2 template {label} against --old's, {plan.threads} threads, in turns: "
              + "; ".join(f"{k} {' '.join(f'{t:.5f}' for t in times[k])} (mean {mean[k]:.5f})"
                          for k in pair)
              + f"; old/new {mean['old'] / mean['new']:.3f}; card {card}", flush=True)
    return 0


def compare_variants(randn, old, chip_smoke, new) -> int:
    """The large-slice fp32 K2 and the fp32 band K1 at the deep and big
    variants' shapes against the template (repaired and as it was), the
    pair on one card and the earlier package, their sweeps, and the
    existing kernels against the earlier package (module docstring,
    ``--variants``)."""
    import torch

    from camels_diffusion_model_tpu_torch.ops import _build

    old_gn, old_step, old_film = old
    groupnorm, sampler_step, film = new
    k1_args, k2_args, k3_args = arg_makers(randn)
    f32 = torch.float32
    lib = _build.build()
    keys = ("groupnorm_f32_large_kernel", "head_step_f32_band_kernel",
            "head_step_halo_f32_kernel", "groupnorm_act_kernel")
    for line in _build.ptxas_report(lib, keys):
        print(f"ptxas {line}", flush=True)
    for name, n in sass_counts(_build, keys).items():
        print(f"SASS new {n} instructions: {name}", flush=True)

    template = functools.partial(forced_template, old_gn)
    pair = functools.partial(forced_pair, groupnorm)
    def bound(a, nb_extra=0):
        return (chip_smoke.nbytes(*a, a[0]) + nb_extra) / chip_smoke.HBM_BYTES_PER_S * 1e3

    card = torch.cuda.get_device_name(0)
    k2_shapes = [(f"{v} out_norm ({n},128,128,{c}), {act}", (n, 128, c, act))
                 for v, c, act in (("deep", 128, "leaky_relu"), ("big", 256, "gelu"))
                 for n in (10, 32)]
    k2_shapes += [("n_feat 64 out_norm (10,128,128,64), relu", (10, 128, 64, "relu")),
                  ("n_feat 224 out_norm (32,64,64,224), relu", (32, 64, 224, "relu")),
                  ("n_feat 256 out_norm (32,64,64,256), relu", (32, 64, 256, "relu"))]
    for label, (n, hw, c, act) in k2_shapes:
        a = k2_args(f32, n, hw, c, act)
        name, plan = groupnorm.single_route(n, hw * hw, c, 8, f32)
        fns = {"template 384": template(384), "template 512": template(512), "pair": pair,
               "new": groupnorm.fused_groupnorm_act}
        errs = {k: hold(chip_smoke, "groupnorm_act", f"{label} {k}", f,
                        groupnorm.groupnorm_act_plain, a) for k, f in fns.items()}
        first, again = groupnorm.fused_groupnorm_act(*a), groupnorm.fused_groupnorm_act(*a)
        if not torch.equal(first, again):
            raise SystemExit(f"{label}: two runs of the new kernel differ")
        order = list(fns) + list(fns)[::-1]
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(chip_smoke.time_ms(fns[k], a))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        b = bound(a)
        lib_ms = chip_smoke.time_ms(gn_lib, a)
        print(f"K2 {label}: route {name} {tuple(plan)}; in turns "
              + "; ".join(f"{k} {' '.join(f'{t:.5f}' for t in times[k])} (mean {mean[k]:.5f}, "
                          f"share {b / mean[k]:.3f})" for k in fns)
              + f"; new vs template 512 {mean['template 512'] / mean['new']:.3f}x, vs pair "
              f"{mean['pair'] / mean['new']:.3f}x, 384/512 "
              f"{mean['template 384'] / mean['template 512']:.3f}; bound {b:.6f} ms; library "
              f"{lib_ms:.5f} ms; max err new {errs['new']:.2e}; reruns bit-identical; "
              f"card {card}", flush=True)
        saved = groupnorm.LARGE_PER_SM, groupnorm.LARGE_BOX_PX, groupnorm.LARGE_SMALL_PART
        tried = set()
        try:
            for small in (0, 4096):  # 512 threads, or 256 at parts of up to 4096 pixels
                for per_sm in ((2, 1), (1,)):
                    for box in (256, 128):
                        groupnorm.LARGE_SMALL_PART, groupnorm.LARGE_PER_SM = small, per_sm
                        groupnorm.LARGE_BOX_PX = box
                        try:
                            p = groupnorm.large_plan(n, hw * hw, c, 8)
                        except ValueError:
                            continue
                        if p in tried:
                            continue
                        tried.add(p)
                        with forced(groupnorm, "single_route", (groupnorm.LARGE_NAME, p)):
                            hold(chip_smoke, "groupnorm_act", f"{label} {tuple(p)}",
                                 groupnorm.fused_groupnorm_act, groupnorm.groupnorm_act_plain, a)
                            ms = chip_smoke.time_ms(groupnorm.fused_groupnorm_act, a)
                        print(f"  K2 {label} plan {tuple(p)}: {ms:.5f} ms (share {b / ms:.3f})"
                              + (" <- picked" if p == plan else ""), flush=True)
        finally:
            groupnorm.LARGE_PER_SM, groupnorm.LARGE_BOX_PX, groupnorm.LARGE_SMALL_PART = saved

    def k1_template(*a):
        h = a[0]
        units = a[3].shape[0]
        cfg = a[8] is not None
        plan = sampler_step.launch_plan(units, h.shape[1], h.shape[2], h.shape[3], cfg=cfg)
        with forced(sampler_step, "route", (sampler_step.C_NAME, plan)):
            return sampler_step.fused_head_step(*a)

    for label, (maps, c, w) in (("deep, tanh, no cfg (10,128,128,128)", (10, 128, None)),
                                ("big, tanh, no cfg (10,128,128,256)", (10, 256, None)),
                                ("deep, tanh, cfg w=2 (20,128,128,128)", (10, 128, 2.0)),
                                ("big, tanh, cfg w=2 (20,128,128,256)", (10, 256, 2.0))):
        a = k1_args(f32, maps, 128, 128, c, w=w, tanh=True)
        name, plan = sampler_step.route(maps, 128, 128, c, f32, cfg=w is not None)
        fns = {"old": old_step.fused_head_step, "template": k1_template,
               "new": sampler_step.fused_head_step}
        errs = {k: hold(chip_smoke, "head_step", f"{label} {k}", f,
                        sampler_step.head_step_plain, a) for k, f in fns.items()}
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k].append(chip_smoke.time_ms(fns[k], a))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        nb = chip_smoke.nbytes(*a, a[3])
        b = max(nb / chip_smoke.HBM_BYTES_PER_S,
                (a[0].numel() * 18 + a[3].numel() * (8 if w else 5)) / chip_smoke.FP32_FLOPS) * 1e3
        lib_ms = chip_smoke.time_ms(
            lambda h, weight, bias, *_: torch.tanh(conv_lib(h, weight, bias)), a)
        print(f"K1 {label}: route {name} {tuple(plan)}; in turns "
              + "; ".join(f"{k} {' '.join(f'{t:.5f}' for t in times[k])} (mean {mean[k]:.5f}, "
                          f"share {b / mean[k]:.3f})" for k in fns)
              + f"; old/new {mean['old'] / mean['new']:.3f}; bound {b:.6f} ms; library "
              f"{lib_ms:.5f} ms; max err new {errs['new']:.2e}; card {card}", flush=True)
        rows_all = sampler_step.ROWS_HALO
        try:
            for rows in rows_all + (3,):
                sampler_step.ROWS_HALO = (rows,)
                p = sampler_step.halo_plan(maps, 128, 128, c, cfg=w is not None)
                with forced(sampler_step, "route", (sampler_step.F32_BAND_NAME, p)):
                    hold(chip_smoke, "head_step", f"{label} rows {rows}",
                         sampler_step.fused_head_step, sampler_step.head_step_plain, a)
                    ms = chip_smoke.time_ms(sampler_step.fused_head_step, a)
                print(f"  K1 band {label} rows {rows} ctas {p.ctas} smem {p.smem_bytes}: "
                      f"{ms:.5f} ms (share {b / ms:.3f})", flush=True)
        finally:
            sampler_step.ROWS_HALO = rows_all

    extra = [(f"{v} up0_norm + FiLM (10,16,16,{c})", "groupnorm_act", f32,
              k2_args(f32, 10, 16, c, act, True))
             for v, c, act in (("deep", 512, "leaky_relu"), ("big", 1024, "gelu"))]
    extra += [(f"{v} K3 stage 1 (10,32,32,{c})", "film", f32, k3_args(f32, 10, 32, c))
              for v, c in (("deep", 256), ("big", 512))]
    existing_turns(randn, old, new, chip_smoke, k1_args, k2_args, k3_args, extra)
    return 0


def existing_turns(randn, old, new, chip_smoke, k1_args, k2_args, k3_args,
                   extra=()) -> None:
    """Every kernel a committed model runs (and ``extra``: ``(label, kind,
    dtype, args)``), the checkout's against the earlier package's, three
    rounds in turns: the served w=2 K1, K2 and K3 in both types, K1's halo
    and K2's sharded launches at phase (r1)'s shapes, the narrow and wide
    bf16 kernels at n_feat 32, 264 and 280."""
    import torch

    old_gn, old_step, old_film = old
    groupnorm, sampler_step, film = new
    f32, bf = torch.float32, torch.bfloat16
    sfx = {f32: "", bf: "_bf16"}

    def halves(dt, n, hw, c, film_rows):
        x = (randn(n, *hw, c) * 3 + 1).to(dt)
        parts = torch.stack([groupnorm.groupnorm_stats_plain(x, 8),
                             groupnorm.groupnorm_stats_plain((randn(n, *hw, c) * 3 + 1).to(dt),
                                                             8)])
        rows = (randn(n, c).to(dt), randn(1, c).to(dt)) if film_rows else None
        return x, parts, randn(c), randn(c), 8, 1e-5, "relu", rows

    existing = []
    for dt in (f32, bf):
        existing += [
            (f"served K1 w=2 h(32,64,64,128)", "head_step", dt, k1_args(dt, 16, 64, 64, 128)),
            (f"served K1 halo, half of the w=2 features", "head_step_halo", dt,
             k1_args(dt, 16, 32, 64, 128, True)),
            (f"served K2 out_norm (32,64,64,128)", "groupnorm_act", dt,
             k2_args(dt, 32, 64, 128)),
            (f"served K2 up0_norm + FiLM (32,16,16,256)", "groupnorm_act", dt,
             k2_args(dt, 32, 16, 256, "relu", True)),
            (f"served K3 stage 1 (32,32,32,128)", "film", dt, k3_args(dt, 32, 32, 128)),
            (f"K2 statistics, out_norm half (32,32,64,128)", "groupnorm_stats", dt,
             ((randn(32, 32, 64, 128) * 3 + 1).to(dt), 8)),
            (f"K2 statistics, up0_norm half (32,8,16,256)", "groupnorm_stats", dt,
             ((randn(32, 8, 16, 256) * 3 + 1).to(dt), 8)),
            (f"K2 apply, out_norm half", "groupnorm_apply", dt,
             halves(dt, 32, (32, 64), 128, False)),
            (f"K2 apply + FiLM, up0_norm half", "groupnorm_apply", dt,
             halves(dt, 32, (8, 16), 256, True))]
    for nf in (32, 264, 280):
        existing += [(f"narrow K1 n_feat {nf}, 16 maps", "head_step", bf,
                      k1_args(bf, 16, 64, 64, nf)),
                     (f"narrow K2 out_norm n_feat {nf}, 16 maps", "groupnorm_act", bf,
                      k2_args(bf, 32, 64, nf))]
    existing.append(("wide K2 up0_norm + FiLM n_feat 264, 16 maps", "groupnorm_act", bf,
                     k2_args(bf, 32, 16, 528, "relu", True)))
    fns = {"head_step": "fused_head_step", "head_step_halo": "fused_head_step",
           "groupnorm_act": "fused_groupnorm_act", "groupnorm_stats": "groupnorm_stats",
           "groupnorm_apply": "groupnorm_apply", "film": "fused_film"}
    plains = {"head_step": sampler_step.head_step_plain,
              "head_step_halo": sampler_step.head_step_plain,
              "groupnorm_act": groupnorm.groupnorm_act_plain,
              "groupnorm_stats": groupnorm.groupnorm_stats_plain,
              "groupnorm_apply": groupnorm.groupnorm_apply_plain, "film": film.film_plain}
    for label, kind, dt, a in existing + list(extra):
        mods = ((old_step, sampler_step) if kind.startswith("head_step")
                else (old_film, film) if kind == "film" else (old_gn, groupnorm))
        pair = [getattr(m, fns[kind]) for m in mods]
        name = kind + sfx[dt]
        if kind == "groupnorm_stats":
            for f in pair:
                got, want = f(*a), plains[kind](*a)
                if not chip_smoke.stats_error(got, want) <= 1e-5:
                    raise SystemExit(f"{label}: statistics beyond 1e-5")
        else:
            for f in pair:
                hold(chip_smoke, name, label, f, plains[kind], a)
        ratios = []
        for _ in range(3):
            t = [chip_smoke.time_ms(f, a) for f in (pair[0], pair[1], pair[1], pair[0])]
            ratios.append((t[0] + t[3]) / (t[1] + t[2]))
            print(f"existing {label} {dt}: old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} {t[2]:.5f} "
                  f"ms (old/new {ratios[-1]:.3f})", flush=True)
        print(f"existing {label} {dt}: old/new by round "
              + ", ".join(f"{r:.3f}" for r in ratios), flush=True)




def compare_sharded(randn, old_gn, chip_smoke, groupnorm) -> int:
    """K2's sharded launches: old vs new in turns, then the new plans."""
    import torch
    import torch.nn.functional as F

    from camels_diffusion_model_tpu_torch.ops import _build

    for name, n in sass_counts(_build, ("groupnorm_stats_kernel",
                                        "groupnorm_apply_kernel")).items():
        print(f"SASS {n} instructions: {name}", flush=True)

    def stats_new(x):
        return groupnorm.groupnorm_stats(x, 8)

    def stats_old(x):
        return old_gn.groupnorm_stats(x, 8)

    def stats_plain(x):
        return groupnorm.groupnorm_stats_plain(x, 8)

    def hold_stats(label, fn, x):
        err = chip_smoke.stats_error(fn(x), stats_plain(x))
        if not err <= chip_smoke.TOL["groupnorm_stats"]:
            raise SystemExit(f"{label}: statistics off by {err} of a column's largest value")
        return err

    def hold_apply(name, label, fn, a):
        got, want = fn(*a), groupnorm.groupnorm_apply_plain(*a)
        diff = (got.float() - want.float()).abs()
        tol, fp32_rounding = chip_smoke.tolerance(name, a, want)
        err, share = diff.max().item(), (diff > fp32_rounding).float().mean().item()
        if not (err <= tol and (not name.endswith("_bf16") or share <= chip_smoke.BF16_SHARE)):
            raise SystemExit(f"{label}: max abs err {err} (tol {tol}), {share} beyond "
                             f"{fp32_rounding}")
        return err

    tiny = torch.zeros(1, device="cuda")
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        eb = 4 if dtype == torch.float32 else 2
        for label, n, hw, c, act, film, conv in (
                ("up0_norm half + FiLM (32,8,16,256)", 32, (8, 16), 256, "relu", True,
                 ("transposed", (32, 256, 4, 4), (256, 256, 4, 4))),
                ("out_norm half (32,32,64,128)", 32, (32, 64), 128, "relu", False,
                 ("conv", (32, 256, 32, 64), (128, 256, 3, 3))),
                ("deep out_norm half, leaky (10,64,128,128)", 10, (64, 128), 128, "leaky_relu",
                 False, ("conv", (10, 256, 64, 128), (128, 256, 3, 3)))):
            kind, ushape, wshape = conv
            u = randn(*ushape).to(dtype).contiguous(memory_format=torch.channels_last)
            w_conv = randn(*wshape).mul(0.02).to(dtype).contiguous(
                memory_format=torch.channels_last)
            if kind == "conv":
                def before(u=u, w_conv=w_conv):
                    return F.conv2d(u, w_conv, padding=1)
            else:
                def before(u=u, w_conv=w_conv):
                    return F.conv_transpose2d(u, w_conv, stride=4)
            halves = [(randn(n, *hw, c) * 3 + 1).to(dtype) for _ in range(2)]
            x = halves[0]
            parts = torch.stack([stats_plain(h) for h in halves])
            rows = (randn(n, c).to(dtype), randn(1, c).to(dtype)) if film else None
            a = (x, parts, randn(c), randn(c), 8, 1e-5, act, rows)
            nb_stats = x.numel() * eb + n * 8 * 3 * 4
            nb_apply = chip_smoke.nbytes(*a, x)
            floors = {"one-element add": chip_smoke.time_ms(lambda t: t.add_(1), (tiny,),
                                                            warm=True),
                      "clone of x": chip_smoke.time_ms(lambda t: t.clone(), (x,))}
            for kernel, f_old, f_new, args, nb in (
                    ("groupnorm_stats" + sfx, stats_old, stats_new, (x,), nb_stats),
                    ("groupnorm_apply" + sfx,
                     lambda *a: old_gn.groupnorm_apply(*a), groupnorm.groupnorm_apply, a,
                     nb_apply)):
                title = f"{kernel} {label}"
                if kernel.startswith("groupnorm_stats"):
                    errs = [hold_stats(title, f, x) for f in (f_old, f_new)]
                else:
                    errs = [hold_apply(kernel, title, f, a) for f in (f_old, f_new)]
                bound = nb / chip_smoke.HBM_BYTES_PER_S * 1e3
                for how, timer in (("cold", chip_smoke.time_ms),
                                   ("after conv", functools.partial(after, before=before))):
                    t = [timer(f, args) for f in (f_old, f_new, f_new, f_old)]
                    o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                    print(f"{title} [{how}]: old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} "
                          f"{t[2]:.5f} ms (mean old {o:.5f}, new {nw:.5f}, old/new "
                          f"{o / nw:.2f}); bound {bound:.6f} ms ({nb} bytes): share old "
                          f"{bound / o:.3f} new {bound / nw:.3f}; max err old {errs[0]:.2e} "
                          f"new {errs[1]:.2e}", flush=True)
                print(f"{title} floors: "
                      + ", ".join(f"{k} {v:.5f} ms" for k, v in floors.items()), flush=True)
            spec = (n, hw[0] * hw[1], c, 8, True, eb)
            sp, ap_ = groupnorm.stats_plan(*spec), groupnorm.apply_plan(*spec)
            stats_plans, apply_plans = sharded_candidates(groupnorm, n, hw[0] * hw[1], c, eb)
            for name, plans, picked, fn, args, hold in (
                    ("stats_plan", stats_plans, sp, stats_new, (x,),
                     lambda: hold_stats(label, stats_new, x)),
                    ("apply_plan", apply_plans, ap_, groupnorm.groupnorm_apply, a,
                     lambda: hold_apply("groupnorm_apply" + sfx, label,
                                        groupnorm.groupnorm_apply, a))):
                print(f"new {label} {dtype} by {name}, ms cold / after conv; the plan picks "
                      f"{tuple(picked)}:", flush=True)
                for plan in plans:
                    with forced(groupnorm, name, plan):
                        hold()
                        t = [chip_smoke.time_ms(fn, args), after(fn, args, before)]
                    print(f"  {tuple(plan)}: {t[0]:.5f} / {t[1]:.5f}"
                          + (" <- picked" if plan == picked else ""), flush=True)
    return 0


def compare_cout(randn, old, chip_smoke, new) -> int:
    """K1's one-channel launches against the earlier package, K1 at several
    output channels, K2's straddling statistics and apply launches against
    the earlier element path (module docstring, ``--cout``)."""
    import torch
    import torch.nn.functional as F

    from camels_diffusion_model_tpu_torch.ops import _build

    old_build, old_gn, old_step = old
    groupnorm, sampler_step = new
    card = torch.cuda.get_device_name(0)
    k1_names = ("head_step_kernel", "head_step_cout_kernel", "head_step_bf16_kernel",
                "head_step_bf16_halo_kernel", "head_step_halo_f32_kernel",
                "head_step_f32_band_kernel", "head_step_bf16_split_kernel",
                "head_step_f32_split_kernel")
    for label, build in (("old", old_build), ("new", _build)):
        for name, n in sass_counts(build, k1_names).items():
            print(f"SASS {label} {n} instructions: {name}", flush=True)
    k1_args, k2_args, _ = arg_makers(randn)
    f32, bf = torch.float32, torch.bfloat16
    sfx = {f32: "", bf: "_bf16"}
    # The served one-channel launches: (label, dtype, (maps, height, width, c, halo), w, tanh).
    served = (("K1 fp32 serve w=2 h(32,64,64,128)", f32, (16, 64, 64, 128, False), 2.0, False),
              ("K1 fp32 serve w=0 h(16,64,64,128)", f32, (16, 64, 64, 128, False), None, False),
              ("K1 fp32 exact chain h(4,64,64,128)", f32, (4, 64, 64, 128, False), None, False),
              ("K1 bf16 serve w=2 h(32,64,64,128)", bf, (16, 64, 64, 128, False), 2.0, False),
              ("K1 bf16 serve w=0 h(16,64,64,128)", bf, (16, 64, 64, 128, False), None, False),
              ("K1 fp32 halo, half of h(32,64,64,128)", f32, (16, 32, 64, 128, True), 2.0, False),
              ("K1 bf16 halo, half of h(32,64,64,128)", bf, (16, 32, 64, 128, True), 2.0, False),
              ("K1 fp32 band, deep tanh w=2 h(20,128,128,128)", f32, (10, 128, 128, 128, False),
               2.0, True))
    for label, dt, (maps, height, width, c, halo), w, tanh in served:
        a = k1_args(dt, maps, height, width, c, halo, w, tanh)
        name = f"head_step{'_halo' if halo else ''}{sfx[dt]}"
        hold(chip_smoke, name, label, sampler_step.fused_head_step, sampler_step.head_step_plain,
             a)
        same = torch.equal(old_step.fused_head_step(*a), sampler_step.fused_head_step(*a))
        if not same:
            raise SystemExit(f"{label}: the checkout's output differs from --old's")
        olds, news = [], []
        for _ in range(3):
            t = [chip_smoke.time_ms(f, a) for f in (old_step.fused_head_step,
                                                    sampler_step.fused_head_step,
                                                    sampler_step.fused_head_step,
                                                    old_step.fused_head_step)]
            olds += [t[0], t[3]]
            news += [t[1], t[2]]
            print(f"  {label}: old {t[0]:.5f} new {t[1]:.5f} new {t[2]:.5f} old {t[3]:.5f} ms",
                  flush=True)
        o, nw = sum(olds) / len(olds), sum(news) / len(news)
        print(f"{label}: bit for bit as --old; mean old {o:.5f} new {nw:.5f} ms, new/old "
              f"{nw / o:.4f}; card {card}", flush=True)

    # K1 at several output channels (new only: the earlier package takes one).
    for cout in (2, 3, 4, 13):
        for label, dt, (maps, height, width, c), w, tanh in (
                ("serve w=2 h(32,64,64,128)", f32, (16, 64, 64, 128), 2.0, False),
                ("serve w=2 h(32,64,64,128)", bf, (16, 64, 64, 128), 2.0, False),
                ("deep tanh w=2 h(20,128,128,128)", f32, (10, 128, 128, 128), 2.0, True)):
            if dt == f32 and height == 128 and cout != 13:
                continue
            a = list(k1_args(dt, maps, height, width, c, False, w, tanh))
            a[1] = randn(cout, c, 3, 3).mul(1 / (3 * c**0.5)).to(dt)
            a[2] = randn(cout).to(dt)
            a[3], a[4] = randn(maps, height, width, cout), randn(maps, height, width, cout)
            a = tuple(a)
            lbl = f"K1 cout {cout} {'fp32' if dt == f32 else 'bf16'} {label}"
            route = sampler_step.route(maps, height, width, c, dt, cout, w is not None)
            err = hold(chip_smoke, f"head_step{sfx[dt]}", lbl, sampler_step.fused_head_step,
                       sampler_step.head_step_plain, a)
            out = sampler_step.fused_head_step(*a)
            nb = chip_smoke.nbytes(*a, out)
            peak = chip_smoke.BF16_FLOPS if dt == bf else chip_smoke.FP32_FLOPS
            b = max(nb / chip_smoke.HBM_BYTES_PER_S,
                    (a[0].numel() * 18 * cout + a[3].numel() * 8) / peak) * 1e3
            ms = chip_smoke.time_ms(sampler_step.fused_head_step, a)
            plain_ms = chip_smoke.time_ms(sampler_step.head_step_plain, a)
            lib_ms = chip_smoke.time_ms(conv_lib, a)
            print(f"{lbl}: {route[0]} {route[1]}; {ms:.5f} ms, bound {b:.6f} ms ({nb} bytes, "
                  f"share {b / ms:.3f}), plain {plain_ms:.5f} ms, F.conv2d to {cout} channels "
                  f"{lib_ms:.5f} ms (library/kernel {lib_ms / ms:.2f}); max err {err:.2e}; "
                  f"card {card}", flush=True)

    # K2 where packs straddle groups: the earlier package's element path in turns.
    for dt in (f32, bf):
        a = k2_args(dt, 32, 16, 2064, "relu", True)
        wide_turns(chip_smoke, f"K2 pair {'fp32' if dt == f32 else 'bf16'} n_feat 1032 "
                   "up0_norm + FiLM (32,16,16,2064)", f"groupnorm_act_pair{sfx[dt]}",
                   old_gn.fused_groupnorm_act, groupnorm.fused_groupnorm_act,
                   groupnorm.groupnorm_act_plain,
                   lambda x, gamma, beta, *_: F.group_norm(
                       x.permute(0, 3, 1, 2), 8, gamma.to(x.dtype), beta.to(x.dtype), 1e-5),
                   a, a[0].numel() * 12)
        pair_sweep(chip_smoke, groupnorm, f"K2 pair {'fp32' if dt == f32 else 'bf16'} n_feat "
                   "1032 up0_norm + FiLM", a)
        for label, (n, hh, ww, c), rows in (
                ("n_feat 1032 up0_norm (the pair's launches)", (32, 16, 16, 2064), True),
                ("n_feat 136 out_norm, half of (32,64,64,136)", (32, 32, 64, 136), False),
                ("n_feat 136 up0_norm, half of (32,16,16,272)", (32, 8, 16, 272), True),
                ("n_feat 264 out_norm, half of (32,64,64,264)", (32, 32, 64, 264), False),
                ("n_feat 264 up0_norm, half of (32,16,16,528)", (32, 8, 16, 528), True)):
            x = (randn(n, hh, ww, c) * 3 + 1).to(dt)
            lbl = f"{'fp32' if dt == f32 else 'bf16'} {label}"
            want = groupnorm.groupnorm_stats_plain(x, 8)
            errs = [chip_smoke.stats_error(f(x, 8), want)
                    for f in (old_gn.groupnorm_stats, groupnorm.groupnorm_stats)]
            if not max(errs) <= chip_smoke.TOL["groupnorm_stats"]:
                raise SystemExit(f"K2 statistics {lbl}: off by {errs} of a column's largest")
            eb = x.element_size()
            plan = groupnorm.stats_plan(n, hh * ww, c, 8, True, eb)
            t = [chip_smoke.time_ms(f, (x, 8)) for f in (
                old_gn.groupnorm_stats, groupnorm.groupnorm_stats, groupnorm.groupnorm_stats,
                old_gn.groupnorm_stats)]
            o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            b = (x.numel() * eb + n * 8 * 3 * 4) / chip_smoke.HBM_BYTES_PER_S * 1e3
            lib = chip_smoke.time_ms(lambda x, g: torch.var_mean(
                x.reshape(x.shape[0], -1, g, x.shape[-1] // g).float(), dim=(1, 3),
                correction=0), (x, 8))
            print(f"K2 statistics {lbl}: {plan}; old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} "
                  f"{t[2]:.5f} ms (mean old {o:.5f}, new {nw:.5f}, old/new {o / nw:.2f}); bound "
                  f"{b:.6f} ms: share old {b / o:.3f} new {b / nw:.3f}; torch.var_mean "
                  f"{lib:.5f} ms; errors old {errs[0]:.2e} new {errs[1]:.2e}; card {card}",
                  flush=True)
            parts = groupnorm.groupnorm_stats_plain(x, 8)[None]
            film_rows = (randn(n, c).to(dt), randn(1, c).to(dt)) if rows else None
            aa = (x, parts, randn(c), randn(c), 8, 1e-5, "relu", film_rows)
            name = f"groupnorm_apply{sfx[dt]}"
            errs = [hold(chip_smoke, name, f"K2 apply {lbl}", f, groupnorm.groupnorm_apply_plain,
                         aa) for f in (old_gn.groupnorm_apply, groupnorm.groupnorm_apply)]
            plan = groupnorm.apply_plan(n, hh * ww, c, 8, True, eb)
            t = [chip_smoke.time_ms(f, aa) for f in (
                old_gn.groupnorm_apply, groupnorm.groupnorm_apply, groupnorm.groupnorm_apply,
                old_gn.groupnorm_apply)]
            o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            b = chip_smoke.nbytes(*aa, x) / chip_smoke.HBM_BYTES_PER_S * 1e3
            print(f"K2 apply {lbl}: {plan}; old {t[0]:.5f} {t[3]:.5f} new {t[1]:.5f} "
                  f"{t[2]:.5f} ms (mean old {o:.5f}, new {nw:.5f}, old/new {o / nw:.2f}); bound "
                  f"{b:.6f} ms: share old {b / o:.3f} new {b / nw:.3f}; errors old "
                  f"{errs[0]:.2e} new {errs[1]:.2e}; card {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
