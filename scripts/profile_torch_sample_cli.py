"""Why a reverse step of the power-spectrum comparison CLI costs what it
does on the card: the batch size, the weights, the values, or cuDNN's
choice of algorithms.

    python scripts/profile_torch_sample_cli.py [--steps 20] [--sweep 1 32]

Times ``--steps`` reverse steps of the exact chain's last timesteps (the
strided sampler at stride 1, w 0, the CLI's path) of the committed
checkpoint folded as the CLI serves it, in fp32 with TF32 off, at 4, 15
and 16 maps; the same at 15 and 16 maps from maps 1e4 times larger (the
scale of the maps that the ``.pth`` export of the committed checkpoint
draws, whose learned shortcut the import re-seeds); and at 15 maps with
``torch.backends.cudnn.benchmark`` on.  Host clock around synchronized
runs after a warm-up; then one profile of the 15-map step
(``profile_torch_serving.profile_row``).  ``--sweep LO HI`` instead times
every batch size from LO to HI maps (unit scale, benchmark off).  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--sweep", type=int, nargs=2, default=None, metavar=("LO", "HI"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    from camels_diffusion_model_tpu_torch import fp32_math
    from camels_diffusion_model_tpu_torch.diffusion.ddim import sample_ddim
    from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
    from camels_diffusion_model_tpu_torch.serving import (
        certification_contexts,
        load_model,
        resolve_serving_config,
    )
    from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables
    from profile_torch_serving import profile_row

    if not torch.cuda.is_available():
        print("profile_torch_sample_cli: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    model = load_model(load_variables(resolve_serving_config(0).model_path), dev)
    schedule = make_schedule(1500)
    taus = np.arange(1, args.steps + 1)

    def run_of(n: int, scale: float):
        x0 = np.random.RandomState(0).randn(n, 64, 64, 1).astype(np.float32) * scale
        params = certification_contexts(n)

        def run():
            out = sample_ddim(model, schedule, torch.Generator(device=dev).manual_seed(0),
                              params=params, guide_w=0.0, x_init=x0, taus=taus,
                              sigma_mode="beta", device=dev)
            torch.cuda.synchronize()
            return out
        return run

    def timed(label: str, run) -> float:
        run()  # warm-up: cuDNN plans, allocator
        t0 = time.perf_counter()
        run()
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        print(f"{label}: {ms:.3f} ms a step", flush=True)
        return ms

    with fp32_math():
        if args.sweep:
            for n in range(args.sweep[0], args.sweep[1] + 1):
                timed(f"{n} maps, unit scale, benchmark off", run_of(n, 1.0))
            return 0
        for n in (4, 15, 16):
            timed(f"{n} maps, unit scale, benchmark off", run_of(n, 1.0))
        for n in (15, 16):
            timed(f"{n} maps, x 1e4, benchmark off", run_of(n, 1e4))
        torch.backends.cudnn.benchmark = True
        timed("15 maps, unit scale, benchmark on", run_of(15, 1.0))
        torch.backends.cudnn.benchmark = False
        profile_row("15 maps, unit scale, benchmark off", run_of(15, 1.0), args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
