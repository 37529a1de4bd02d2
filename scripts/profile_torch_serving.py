"""Where a served batch's time goes on the card, for the PyTorch port.

    python scripts/profile_torch_serving.py [--steps 40] [--batch 16]

Loads the certified checkpoint, then for w=2 and w=0 runs ``--steps``
strided-DDPM steps of the certified row's schedule at ``--batch`` maps (on
the first of the certification's test-split contexts) under
``torch.profiler`` (CPU and CUDA activity), after one unprofiled warm-up
pass.  Prints per row: wall ms per step, device-busy ms per step (sum of
kernel times), the idle share, and the kernels by device time, with this
port's three kernels marked.  Needs a CUDA card; TF32 off, as in
``chip_smoke.py``.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
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
    print(f"card: {smi}; torch {torch.__version__}")
    schedule = make_schedule(1500)
    model = None
    for w in (2, 0):
        cfg = resolve_serving_config(w)
        if model is None:
            model = load_model(load_variables(cfg.model_path), dev)
        taus = ddim_timesteps(1500, cfg.steps)[-(args.steps + 1):]

        def run():
            out = sample_ddim(model, schedule, torch.Generator(device=dev).manual_seed(0),
                              n_sample=args.batch, guide_w=cfg.guide_w, taus=taus,
                              params=certification_contexts(args.batch), device=dev)
            torch.cuda.synchronize()
            return out

        run()  # warm-up: cuDNN plans, allocator
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        n = len(taus)
        rows = []
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((us, evt.key, evt.count))
        rows.sort(reverse=True)
        if not rows:
            raise SystemExit("the profiler recorded no device time")
        busy = sum(us for us, _, _ in rows) / 1e6
        print(f"w={w} ({cfg.config}): {n} steps at batch {args.batch}: "
              f"wall {wall / n * 1e3:.3f} ms/step, device busy "
              f"{busy / n * 1e3:.3f} ms/step, idle share {1 - busy / wall:.3f}")
        for us, key, count in rows[:12]:
            mark = " <- port kernel" if any(k in key for k in OURS) else ""
            print(f"  {us / busy / 1e4:6.2f}%  {us / n / 1e3:8.4f} ms/step  "
                  f"x{count:<6d} {key[:90]}{mark}")
        ours = {k: sum(us for us, key, _ in rows if k in key) / n / 1e3 for k in OURS}
        print("  port kernels ms/step: " + json.dumps(ours))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
