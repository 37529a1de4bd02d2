"""Certified map serving on the card.

    python -m camels_diffusion_model_tpu_torch.cli.serve --guide-w 2 --n 16 --out DIR \
        [--params P1 P2 P3 P4 P5 P6]

Resolves the certified row for the guidance weight (``serving.py``), loads
the md5-checked committed checkpoint with its BatchNorms folded, samples
``n`` maps with the strided DDPM of that row on one normalised context
(``--params``; by default the parameter set the JAX serving CLI picks),
applies the row's spectral calibration, computes the linear- and log-bin
P(k), and writes them to one small ``.npz`` under ``DIR``.  The port of
``sample_power_spectra.py --serving`` without its plot.  Runs on CUDA
unless ``--device cpu``.

Precision: the CLI serves in fp32, as the JAX serving CLI has no dtype
option.  The library call ``serve(..., dtype=torch.bfloat16)`` serves the
rows in the precision they were certified in (``bench.py`` and
``scripts/certify_fast_sampler.py`` run the JAX model in bf16): the folded
model computes in bf16 and the sampler's state stays fp32.  ``serve`` turns
TF32 off for cuDNN's convolutions and cuBLAS's matmuls, and reduced-precision
sums off for bf16 matmuls, while it runs and restores the caller's settings
after it (``fp32_math``); torch's default would let the fp32 convolutions
run in TF32, which is not what the certified rows were checked against on
the card.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np
import torch

from .. import fp32_math, resolve_device
from ..diffusion.calibration import SpectralCalibration, apply_spectral_calibration
from ..diffusion.ddim import sample_ddim
from ..data.synthetic import synthetic_params
from ..diffusion.schedule import make_schedule
from ..ops.spectrum import calculate_power_spectrum_2d_batch, power_spectrum_batch
from ..serving import load_model, resolve_serving_config
from ..training.checkpoints import load_variables

TIMESTEPS = 1500  # training T of the certified checkpoint and its calibrations


def default_params(seed: int = 0) -> np.ndarray:
    """``(6,)`` float32: the context ``camels_diffusion_model_tpu/cli/
    sample.py:101-116`` serves when the CAMELS data files are absent: the
    synthetic stand-in's 8 parameter sets (seed ``seed or 0``), min-max
    normalised over those 8, and the set ``random.Random(seed).randint(0,
    7)``."""
    p = synthetic_params(8, seed=seed or 0)
    norm = (p - p.min(axis=0)) / (p.max(axis=0) - p.min(axis=0) + 1e-8)
    return norm[random.Random(seed).randint(0, len(norm) - 1)].astype(np.float32)


def serving_params(params, n: int, seed: int = 0, n_cfeat: int = 6) -> np.ndarray:
    """``(n, n_cfeat)`` float32 contexts: one context ``(n_cfeat,)`` tiled
    to ``n`` (as ``cli/sample.py:127``), ``(n, n_cfeat)`` as given, or the
    first ``n_cfeat`` entries of :func:`default_params` tiled when
    ``params`` is None."""
    if params is None:
        params = default_params(seed)[:n_cfeat]
    p = np.asarray(params, np.float32)
    if p.ndim == 1:
        p = np.tile(p[None, :], (n, 1))
    if p.shape != (n, n_cfeat):
        raise ValueError(f"params must be ({n_cfeat},) or ({n}, {n_cfeat}), got {p.shape}")
    return p


@fp32_math()
def serve(guide_w: float, n: int, out_dir: str, seed: int = 0,
          device=None, art_dir=None, params=None,
          dtype: torch.dtype = torch.float32) -> dict:
    """Serve ``n`` calibrated maps of the certified row for ``guide_w`` on
    the normalised contexts ``params``: one ``(6,)``, tiled, or one per map
    ``(n, 6)``; None serves :func:`default_params` of ``seed``.

    The model computes in ``dtype`` (float32 or bfloat16), inside
    :func:`fp32_math`.  Returns the maps
    ``(n, 64, 64, 1)`` (a tensor on ``device``), their spectra, the
    contexts, the row and the wall seconds of sampling through P(k); writes
    everything but the maps to ``out_dir/serve_w{w}_n{n}.npz``.
    """
    device = resolve_device(device)
    cfg = resolve_serving_config(guide_w, art_dir)
    model = load_model(load_variables(cfg.model_path), device, dtype=dtype)
    params = serving_params(params, n, seed, model.n_cfeat)
    calib = SpectralCalibration.load(cfg.calibration_path)
    generator = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    maps = sample_ddim(
        model, make_schedule(TIMESTEPS), generator, n_sample=n,
        size=model.height, params=params, guide_w=cfg.guide_w, n_steps=cfg.steps,
        sigma_mode="beta", device=device,
    )
    maps = apply_spectral_calibration(maps, calib)
    k, pk = power_spectrum_batch(maps[..., 0])
    k_log, pk_log = calculate_power_spectrum_2d_batch(maps[..., 0])
    pk, pk_log = pk.cpu().numpy(), pk_log.cpu().numpy()  # waits for the card
    seconds = time.perf_counter() - t0
    result = {
        "guide_w": cfg.guide_w, "steps": cfg.steps, "config": cfg.config,
        "checkpoint_fingerprint": cfg.checkpoint_fingerprint, "seed": seed,
        "dtype": str(dtype).split(".")[-1],
        "params": params,
        "k": k, "pk": pk, "k_log": k_log, "pk_log": pk_log,
        "seconds": seconds,
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"serve_w{int(cfg.guide_w)}_n{n}.npz")
    np.savez(path, **result)
    return {**result, "maps": maps, "path": path}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Precision: fp32; TF32 is off for the convolutions and "
               "matmuls while the maps are served.")
    ap.add_argument("--guide-w", type=float, required=True,
                    help="guidance weight of a certified row (0 or 2)")
    ap.add_argument("--n", type=int, default=16, help="maps to serve")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--params", type=float, nargs=6, default=None,
                    metavar="P", help="one min-max-normalised context for "
                    "every map (default: the JAX serving CLI's)")
    args = ap.parse_args(argv)
    r = serve(args.guide_w, args.n, args.out, args.seed, args.device,
              params=args.params)
    print(f"served {args.n} maps: {r['config']} (guide_w={r['guide_w']:g}) "
          f"in {r['seconds']:.3f} s -> {r['path']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
