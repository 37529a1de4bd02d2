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
three kernels marked.  Needs a CUDA card; TF32 off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OURS = ("head_step_kernel", "groupnorm_act_kernel", "film_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_row(label: str, run, n: int) -> dict:
    """Profile ``run()`` (``n`` steps) after one warm-up call and print its
    row; returns device ms per step of the port's kernels and of the
    ``out_conv2`` range, if it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up: cuDNN plans, allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows, head_us = [], 0.0
    for evt in prof.key_averages():
        if evt.key == "out_conv2":
            head_us = max(head_us, float(getattr(evt, "device_time_total",
                                                 getattr(evt, "cuda_time_total", 0.0))))
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
    for us, key, count in rows[:12]:
        mark = " <- port kernel" if any(k in key for k in OURS) else ""
        print(f"  {us / busy / 1e4:6.2f}%  {us / n / 1e3:8.4f} ms/step  "
              f"x{count:<6d} {key[:90]}{mark}")
    ours = {k: sum(us for us, key, _ in rows if k in key) / n / 1e3 for k in OURS}
    print("  port kernels ms/step: " + json.dumps(ours))
    if head_us:
        print(f"  out_conv2 (the conv to one channel): {head_us / n / 1e3:.4f} ms/step, "
              f"{head_us / busy / 1e4:.2f}% of device busy")
    return {**ours, "out_conv2": head_us / n / 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--nll-batch", type=int, default=4)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the model's compute dtype")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import record_function

    from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
    from camels_diffusion_model_tpu_torch.diffusion.likelihood import nll_batch
    from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
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

    def marked_head(x):
        with record_function("out_conv2"):
            return head_forward(x)

    model.out_conv2.forward = marked_head

    def sampler(taus, w, mode):
        def run():
            out = sample_ddim(model, schedule, torch.Generator(device=dev).manual_seed(0),
                              n_sample=args.batch, guide_w=w, taus=taus,
                              params=certification_contexts(args.batch),
                              sigma_mode=mode, device=dev)
            torch.cuda.synchronize()
            return out
        return run

    for w in (2, 0):
        cfg = resolve_serving_config(w)
        taus = ddim_timesteps(1500, cfg.steps)[-(args.steps + 1):]
        profile_row(f"w={w} ({cfg.config}) at batch {args.batch}",
                    sampler(taus, cfg.guide_w, "beta"), len(taus))
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
