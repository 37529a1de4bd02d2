"""Where a sampler step of the deep and big models goes on the card, and
whether cuDNN's benchmark mode (its timed choice of algorithms) moves it.

    python scripts/profile_torch_variants.py [--steps 10] [--batch 10]

For ``ContextUnet.deep()`` and ``ContextUnet.big()`` at full width (128x128)
from a seeded init: ``--steps`` strided steps of the exact chain's sigma at
``--batch`` maps with a zero context and no guidance, the sampler path of
modes ``initial`` and ``main``.  Times the pass (host clock, synchronized,
after a warm-up) with ``torch.backends.cudnn.benchmark`` off, on, and off
again, then profiles one pass with it off (``profile_row`` of
``profile_torch_serving.py``: wall and busy ms per step, idle share, the
kernels by device time).  Needs a CUDA card; TF32 off, as in
``chip_smoke.py``.
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
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
    from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
    from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
    from profile_torch_serving import profile_row

    if not torch.cuda.is_available():
        print("profile_torch_variants: needs a CUDA card", file=sys.stderr)
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
    taus = ddim_timesteps(1500, args.steps)
    for name in ("deep", "big"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = getattr(ContextUnet, name)()
        model = model.to(device=dev, memory_format=torch.channels_last).eval()

        def run():
            out = sample_ddim(model, schedule, torch.Generator(device=dev).manual_seed(4),
                              n_sample=args.batch, size=model.height,
                              params=np.zeros((args.batch, model.n_cfeat), np.float32),
                              taus=taus, sigma_mode="beta", device=dev)
            torch.cuda.synchronize()
            return out

        times = []
        for benchmark in (False, True, False):
            torch.backends.cudnn.benchmark = benchmark
            run()  # warm-up: cuDNN plans (and, in benchmark mode, its trials)
            t0 = time.perf_counter()
            run()
            times.append((benchmark, (time.perf_counter() - t0) / len(taus) * 1e3))
        torch.backends.cudnn.benchmark = False
        print(f"{name} sampler step at {args.batch} maps, {len(taus)} steps: " + ", ".join(
            f"cudnn.benchmark {b}: {ms:.3f} ms" for b, ms in times))
        profile_row(f"{name} sampler, cudnn.benchmark off, at batch {args.batch}", run,
                    len(taus))
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
