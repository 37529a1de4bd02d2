"""Where a served batch's time goes on the card, for the PyTorch port.

    python scripts/profile_torch_serving.py [--steps 40] [--batch 16] [--nll-batch 4] \
        [--dtype bfloat16]

Loads the certified checkpoint, folded, computing in ``--dtype`` (float32
by default, or bfloat16), then profiles under ``torch.profiler`` (CPU
and CUDA activity), each after one unprofiled warm-up pass:

* for w=2 and w=0, ``--steps`` strided-DDPM steps of the certified row's
  schedule at ``--batch`` maps (on the first of the certification's
  test-split contexts);
* ``--steps`` steps of posterior DDIM (eta 0, 50-step schedule, w=2) at
  ``--batch`` maps;
* ``--steps`` timesteps (t = 1, 2, ...) of the NLL sweep at ``--nll-batch``
  maps, with the device time of the model's output conv to one channel
  (``out_conv2``: a cuDNN conv in fp32; in bf16 an fp32 conv of the bf16
  operands, rounded once) marked.

Prints per row: wall ms per step, device-busy ms per step (sum of kernel
times), the idle share, and the kernels by device time, with this port's
three kernels marked, and K2's two launches a decoder call (``up0_norm``
with the FiLM epilogue, ``out_norm``) by device ms a step.

With ``--dtype bfloat16 --k2-plans``, the w=2, w=0 and NLL rows are
profiled again under each launch plan the bf16 K2 takes at one head (the
other on its own plan; ``scripts/compare_torch_kernels.py::
k2_bf16_candidates``), and with ``--old DIR`` (an earlier revision's
package, as that script takes it; repeatable) under the earlier K2, old,
new, new, old.  Needs a CUDA card; TF32 off,
as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's kernels by name: K1 and K2 (the float design, and the bf16
# single launch's own kernel), K3.
OURS = ("head_step_kernel", "head_step_bf16_kernel",
        "head_step_bf16_halo_kernel",
        "head_step_halo_f32_kernel", "head_step_bf16_split_kernel",
        "head_step_f32_split_kernel", "head_step_combine_kernel", "head_step_f32_band_kernel",
        "head_step_os_kernel",
        "groupnorm_act_kernel", "groupnorm_f32_large_kernel",
        "groupnorm_bf16_kernel", "groupnorm_bf16_narrow_kernel", "groupnorm_bf16_wide_kernel",
        "groupnorm_stats_kernel",
        "groupnorm_apply_kernel",
        "film_kernel")
# Ranges whose device time a row reports: the conv to one channel, and
# K2's launch at each head.
RANGES = ("out_conv2", "K2 up0_norm", "K2 out_norm")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_row(label: str, run, n: int, top: int = 12) -> dict:
    """Profile ``run()`` (``n`` steps) after one warm-up call and print its
    row with its ``top`` kernels; returns device ms per step of the port's
    kernels and of the ``RANGES`` that ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up: cuDNN plans, allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows, marked = [], dict.fromkeys(RANGES, 0.0)
    for evt in prof.key_averages():
        if evt.key in marked:
            marked[evt.key] = max(marked[evt.key], float(getattr(
                evt, "device_time_total", getattr(evt, "cuda_time_total", 0.0))))
            continue
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    if not rows:
        raise SystemExit("the profiler recorded no device time")
    busy = sum(us for us, _, _ in rows) / 1e6
    print(f"{label}: {n} steps: wall {wall / n * 1e3:.3f} ms/step, device busy "
          f"{busy / n * 1e3:.3f} ms/step, idle share {1 - busy / wall:.3f}")
    for us, key, count in rows[:top]:
        mark = " <- port kernel" if any(k in key for k in OURS) else ""
        print(f"  {us / busy / 1e4:6.2f}%  {us / n / 1e3:8.4f} ms/step  "
              f"x{count:<6d} {key[:90]}{mark}")
    ours = {k: sum(us for us, key, _ in rows if k in key) / n / 1e3 for k in OURS}
    print("  port kernels ms/step: " + json.dumps(ours))
    for name, us in marked.items():
        if us:
            print(f"  {name}: {us / n / 1e3:.5f} ms/step, {us / busy / 1e4:.2f}% of device busy")
    return {**ours, **{name: us / n / 1e3 for name, us in marked.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--nll-batch", type=int, default=4)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the model's compute dtype")
    ap.add_argument("--k2-plans", action="store_true",
                    help="bf16: the w=2 row again under every plan of the bf16 K2 at each head")
    ap.add_argument("--old", action="append",
                    help="bf16: the rows under this earlier package's K2 too (repeatable)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import record_function

    from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
    from camels_diffusion_model_tpu_torch.diffusion.likelihood import nll_batch
    from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
    from camels_diffusion_model_tpu_torch.models import blocks
    from camels_diffusion_model_tpu_torch.ops import groupnorm
    from camels_diffusion_model_tpu_torch.serving import (
        certification_contexts,
        load_model,
        resolve_serving_config,
    )
    from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables

    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; model in {args.dtype}")
    schedule = make_schedule(1500)
    model = load_model(load_variables(resolve_serving_config(2).model_path), dev,
                       dtype=getattr(torch, args.dtype))
    head_forward = model.out_conv2.forward

    def marked_head(*a, **kw):
        with record_function("out_conv2"):
            return head_forward(*a, **kw)

    model.out_conv2.forward = marked_head
    k2 = {"impl": blocks.fused_groupnorm_act}  # the K2 the decoder calls

    def marked_k2(x, gamma, beta, groups, eps, act, film=None):
        with record_function("K2 up0_norm" if film is not None else "K2 out_norm"):
            return k2["impl"](x, gamma, beta, groups, eps, act, film)

    blocks.fused_groupnorm_act = marked_k2

    def sampler(taus, w, mode):
        def run():
            out = sample_ddim(model, schedule, torch.Generator(device=dev).manual_seed(0),
                              n_sample=args.batch, guide_w=w, taus=taus,
                              params=certification_contexts(args.batch),
                              sigma_mode=mode, device=dev)
            torch.cuda.synchronize()
            return out
        return run

    rows = []  # (label, run, steps, decoder batch): the rows --k2-plans and --old redo
    for w in (2, 0):
        cfg = resolve_serving_config(w)
        taus = ddim_timesteps(1500, cfg.steps)[-(args.steps + 1):]
        label = f"w={w} ({cfg.config}) at batch {args.batch}"
        run = sampler(taus, cfg.guide_w, "beta")
        profile_row(label, run, len(taus))
        rows.append((f"w={w}", run, len(taus), (2 if cfg.guide_w else 1) * args.batch))
    taus = ddim_timesteps(1500, 50)[-(args.steps + 1):]
    profile_row(f"posterior DDIM w=2, eta 0, 50-step schedule, at batch {args.batch}",
                sampler(taus, 2.0, "posterior"), len(taus))

    x = torch.randn(args.nll_batch, 64, 64, 1, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    c = certification_contexts(args.nll_batch)

    def sweep():
        out = nll_batch(model, schedule, x, c, torch.Generator(device=dev).manual_seed(2),
                        ts=range(1, args.steps + 1), device=dev)
        torch.cuda.synchronize()
        return out

    profile_row(f"NLL sweep at batch {args.nll_batch}", sweep, args.steps)
    rows.append(("NLL sweep", sweep, args.steps, args.nll_batch))
    if args.dtype == "bfloat16" and (args.k2_plans or args.old):
        for row in rows:
            compare_k2(args, *row, groupnorm, k2)
    return 0


def compare_k2(args, name: str, run, steps: int, n: int, groupnorm, k2) -> None:
    """The bf16 row ``run`` (``steps`` steps, decoder batch ``n``) under
    each earlier package's K2 (``--old``), old, new, new, old, and under
    each plan of the bf16 K2 at each head (``--k2-plans``): K2's device ms
    a step at each head."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import compare_torch_kernels as ck

    def row(label):
        out = profile_row(f"{name}, {label}", run, steps, top=0)
        return out["K2 up0_norm"], out["K2 out_norm"]

    new_impl = k2["impl"]
    for k, old in enumerate(args.old or ()):
        package = f"old_port_{k}"
        if package not in sys.modules:
            ck.load_package(old, package)
        old_gn = importlib.import_module(f"{package}.ops.groupnorm")
        times = {}
        for side in ("old", "new", "new", "old"):
            k2["impl"] = old_gn.fused_groupnorm_act if side == "old" else new_impl
            source = old if side == "old" else "checkout"
            times.setdefault(side, []).append(row(f"K2 {side} ({source})"))
        k2["impl"] = new_impl
        for head, i in (("up0_norm", 0), ("out_norm", 1)):
            o, nw = (sum(t[i] for t in times[s]) / 2 for s in ("old", "new"))
            print(f"served K2 {head}, bf16 {name}: old ({old}) {o:.5f} new {nw:.5f} ms/step "
                  f"(old/new {o / nw:.2f})", flush=True)
    if args.k2_plans:
        for head, (hw, c) in (("up0_norm", (256, 256)), ("out_norm", (4096, 128))):
            picked = groupnorm.bf16_plan(n, hw, c, 8)
            for plan in ck.k2_bf16_candidates(groupnorm, n, hw, c):
                with ck.forced_plan(groupnorm, plan, (n, hw, c)):
                    t = row(f"{head} plan {tuple(plan)}")
                print(f"served K2 {head}, bf16 {name}, plan {tuple(plan)}: "
                      f"{t[0] if head == 'up0_norm' else t[1]:.5f} ms/step"
                      + (" <- picked" if plan == picked else ""), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
