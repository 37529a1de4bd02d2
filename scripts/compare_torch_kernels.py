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
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import importlib.util
import inspect
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "compare_torch_kernels")
PACKAGE = "camels_diffusion_model_tpu_torch"


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


if __name__ == "__main__":
    raise SystemExit(main())
