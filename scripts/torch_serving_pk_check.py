"""Served P(k) of the PyTorch port against the exact-chain references.

    python scripts/torch_serving_pk_check.py --guide-w 2 --n 64 [--first-seed 100]

Serves ``--n`` maps of the certified row through ``cli.serve`` in fp32
(batches of 32, seeds ``--first-seed``, +1, ...) on the first ``--n`` of
the certification's test-split contexts (``serving.certification_contexts``),
the contexts the references were sampled on, and prints the mean P(k) over
the reference's P(k) per linear bin, against the N=16384 exact chain of
seed A under ``artifacts/certification/n16k/``, and its mean over three
bands of bins.  A diagnostic on the card, not the statistical hold
(ROADMAP section 1, item 3).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from camels_diffusion_model_tpu_torch.cli.serve import serve  # noqa: E402
from camels_diffusion_model_tpu_torch.serving import certification_contexts  # noqa: E402

REFS = os.path.join(REPO, "artifacts", "certification", "n16k")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--guide-w", type=float, required=True)
    ap.add_argument("--n", type=int, default=64, help="maps, a multiple of 32")
    ap.add_argument("--first-seed", type=int, default=100,
                    help="seed of the first batch; batch i uses first-seed + i")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = int(args.guide_w)
    contexts = certification_contexts(args.n)
    pk = np.concatenate([
        serve(w, 32, os.path.join(REPO, "build", "pk_check"), seed=args.first_seed + s,
              params=contexts[32 * s:32 * (s + 1)])["pk"]
        for s in range(args.n // 32)
    ])
    ref = np.load(os.path.join(REFS, f"w{w}", "DDPM_1500_seed_A.npz"))["pk"]
    ratio = pk.mean(0)[1:] / np.where(ref[1:] > 0, ref[1:], np.nan)
    print(f"w={w} fp32 N={pk.shape[0]}")
    print("  P/P_ref, bins 1-46: " + " ".join(f"{r:.3f}" for r in ratio))
    for lo, hi in ((1, 9), (9, 18), (18, 46)):
        print(f"  bins {lo}-{hi - 1}: mean ratio {np.nanmean(ratio[lo - 1:hi - 1]):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
