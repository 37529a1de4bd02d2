"""The power-spectrum comparison of the reference's own workflow on the card
(counterpart of ``camels_diffusion_model_tpu/cli/sample.py`` and of the
root ``sample_power_spectra.py``'s command line).

    python -m camels_diffusion_model_tpu_torch.cli.sample [model_path] [timesteps] [output_dir] \
        [--serving [w]] [--device cpu]

Loads trained weights -- a reference-format ``.pth`` (``torch.save`` of the
reference's ``state_dict``, through ``utils/torch_interop.py``) or a
``.msgpack`` checkpoint of either package -- folds the BatchNorms, samples
``n_maps`` maps on one parameter set picked by ``random.Random(seed)``,
and compares their log-binned P(k) with the CAMELS maps of that set
(``sample_power_spectra.py:167-358``): two figures and
``power_spectrum_results.npy`` under ``output_dir``, and the JAX CLI's
printed lines and ``results`` keys.  The data files are read when present;
else the synthetic stand-ins, as in the JAX CLI.  The default sampler is
the exact ``timesteps``-step chain at ``guide_w`` 0; ``--serving [w]``
serves the certified strided-DDPM row of the committed checkpoint with its
spectral calibration (``serving.resolve_serving_config``) and refuses any
other ``model_path``.  It runs on CUDA unless ``--device cpu``, inside
:func:`fp32_math` (TF32 off).  Without matplotlib (the card's machine)
each figure prints that it was skipped.
"""

from __future__ import annotations

import os
import random
import sys
from typing import Dict, Optional

import numpy as np
import torch

from .. import fp32_math, resolve_device
from ..data.pipeline import normalize_maps, resize_maps_np
from ..data.synthetic import synthetic_camels
from ..diffusion.calibration import SpectralCalibration, apply_spectral_calibration
from ..diffusion.ddim import sample_ddim
from ..diffusion.sampler import sample_ddpm
from ..diffusion.schedule import make_schedule
from ..models.context_unet import ContextUnet
from ..ops.spectrum import calculate_power_spectrum_2d_batch
from ..serving import load_model, resolve_serving_config
from ..training.checkpoints import load_variables
from ..utils import viz
from ..utils.torch_interop import load_torch_checkpoint
from ..utils.weights import to_jax_variables

DEFAULT_MODEL = ("outputs/paper_lr_1e-05_epochs_100_timesteps_1500_params_6/"
                 "weights/model_epoch_100.msgpack")
# The cosmological parameters of the figure's subtitle (sample_power_spectra.py:361-377).
SELECTED_PARAMS = {
    "Ωm": 0.21940,
    "σ8": 0.90020,
    "ASN1": 3.88523,
    "AAGN1": 0.29895,
    "ASN2": 1.61664,
    "AAGN2": 1.48968,
}


def _variables(model_path: str, n_feat: int, n_cfeat: int, height: int) -> dict:
    """The flax-layout variables of ``model_path`` (``cli/sample.py:
    52-84``): a ``.pth`` through the interop import, a ``.msgpack`` as it
    is, or with ``CAMELS_ALLOW_FRESH_WEIGHTS=1`` a fresh init."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        template = to_jax_variables(ContextUnet(n_feat=n_feat, n_cfeat=n_cfeat,
                                                height=height).state_dict())
    if model_path.endswith(".pth"):
        if not os.path.exists(model_path):
            raise FileNotFoundError(model_path)
        return load_torch_checkpoint(template, model_path)
    if os.path.exists(model_path):
        return load_variables(model_path)
    if os.environ.get("CAMELS_ALLOW_FRESH_WEIGHTS") == "1":
        print(f"  WARNING: checkpoint {model_path} not found — using freshly "
              "initialized weights (CAMELS_ALLOW_FRESH_WEIGHTS=1 demo mode; "
              "spectra will not match)")
        return template
    raise FileNotFoundError(
        f"checkpoint not found: {model_path} (pass a trained .msgpack or "
        "reference .pth; set CAMELS_ALLOW_FRESH_WEIGHTS=1 to run the "
        "plumbing with fresh random weights)")


@fp32_math()
def generate_comparison_plot(
    model_path: str,
    camels_data_path: str,
    params_path: str,
    output_dir: str,
    selected_params_dict: Dict[str, float],
    n_maps: int = 15,
    timesteps: int = 1500,
    n_feat: int = 128,
    n_cfeat: int = 6,
    height: int = 64,
    seed: Optional[int] = None,
    serving_steps: Optional[int] = None,
    calibration_path: Optional[str] = None,
    guide_w: float = 0.0,
    device=None,
) -> Dict[str, np.ndarray]:
    """The JAX CLI's function (same arguments, lines, files and
    ``results``) on ``device`` (default ``cuda``).  ``serving_steps`` /
    ``calibration_path`` default to ``CAMELS_SERVING_STEPS`` /
    ``CAMELS_CALIBRATION``; unset, the exact chain and no calibration."""
    device = resolve_device(device)
    print(f"Loading trained model... (platform: {device.type})")
    variables = _variables(model_path, n_feat, n_cfeat, height)
    model = load_model(variables, device)  # BatchNorms folded (cli/sample.py:89-93)
    schedule = make_schedule(timesteps)

    print("Loading CAMELS data...")
    if os.path.exists(camels_data_path) and os.path.exists(params_path):
        camels_data, param_data = np.load(camels_data_path), np.load(params_path)
    else:
        print("  (data files absent — using synthetic CAMELS stand-ins)")
        camels_data, param_data = synthetic_camels(n_param_sets=8, maps_per_set=15,
                                                   size=128, seed=seed or 0)
    # The training recipe on the numpy path, as the JAX CLI (:107-108).
    camels_norm = normalize_maps(camels_data, style="code").astype(np.float32)
    camels_resized = resize_maps_np(camels_norm, height)

    # The parameters' min-max without the x15 expansion (:110-113).
    pmin, pmax = param_data.min(axis=0), param_data.max(axis=0)
    params_normalized = (param_data - pmin) / (pmax - pmin + 1e-8)
    random_param_idx = random.Random(seed).randint(0, len(params_normalized) - 1)
    selected = params_normalized[random_param_idx: random_param_idx + 1]
    print(f"Selected parameter set {random_param_idx}:")
    for key, value in selected_params_dict.items():
        print(f"  {key}: {value}")
    start = random_param_idx * 15
    camels_maps = camels_resized[start: start + n_maps]
    print(f"Using CAMELS maps {start} to {start + n_maps - 1}")

    print(f"Generating {n_maps} HI-CDM maps...")
    sel = np.tile(selected.astype(np.float32)[:, :n_cfeat], (n_maps, 1))
    if serving_steps is None:
        serving_steps = int(os.environ.get("CAMELS_SERVING_STEPS", "0"))
    generator = torch.Generator(device=device).manual_seed(seed if seed is not None else 0)
    if serving_steps:
        print(f"  (serving fast path: strided DDPM, {serving_steps} steps, "
              f"guide_w={guide_w})")
        x = sample_ddim(model, schedule, generator, n_sample=n_maps, size=height, params=sel,
                        guide_w=guide_w, n_steps=serving_steps, sigma_mode="beta",
                        device=device)
    else:
        x = sample_ddpm(model, schedule, generator, n_sample=n_maps, size=height, params=sel,
                        guide_w=guide_w, device=device)
    calib_path = (calibration_path if calibration_path is not None
                  else os.environ.get("CAMELS_CALIBRATION"))
    if calib_path:
        print(f"  (spectral calibration: {calib_path})")
        x = apply_spectral_calibration(x, SpectralCalibration.load(calib_path))

    print("Calculating power spectra...")
    k, camels_pk = calculate_power_spectrum_2d_batch(torch.as_tensor(camels_maps))
    _, hicdm_pk = calculate_power_spectrum_2d_batch(x[..., 0])
    hicdm_maps = x[..., 0].cpu().numpy()
    camels_pk, hicdm_pk = camels_pk.numpy(), hicdm_pk.cpu().numpy()
    camels_pk_mean, camels_pk_std = camels_pk.mean(0), camels_pk.std(0)
    hicdm_pk_mean, hicdm_pk_std = hicdm_pk.mean(0), hicdm_pk.std(0)

    os.makedirs(output_dir, exist_ok=True)
    viz.plot_log_spectrum_comparison(
        k, camels_pk_mean, camels_pk_std, hicdm_pk_mean, hicdm_pk_std,
        selected_params_dict, os.path.join(output_dir, "power_spectrum_comparison.png"))
    viz.plot_example_maps_comparison(
        camels_maps, hicdm_maps, os.path.join(output_dir, "example_maps_comparison.png"))

    ratio = hicdm_pk_mean / camels_pk_mean
    print("\nPower Spectrum Statistics:")
    print(f"Mean P(k) ratio (HI-CDM/CAMELS): {np.mean(ratio):.4f} ± {np.std(ratio):.4f}")
    results = {
        "k": k,
        "camels_pk_mean": camels_pk_mean,
        "camels_pk_std": camels_pk_std,
        "hicdm_pk_mean": hicdm_pk_mean,
        "hicdm_pk_std": hicdm_pk_std,
        "parameters": selected_params_dict,
    }
    path = os.path.join(output_dir, "power_spectrum_results.npy")
    np.save(path, results)
    print("Numerical results saved to: " + path)
    return results


def main(argv=None) -> Dict[str, np.ndarray]:
    """``sample_power_spectra.py``'s contract: ``[model_path] [timesteps]
    [output_dir]``, ``--serving [w]`` (default w 0), and ``--device``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value (cuda or cpu)")
        device = argv[i + 1]
        del argv[i:i + 2]
    serving = None
    if "--serving" in argv:
        i = argv.index("--serving")
        argv.pop(i)
        w = 0.0
        if i < len(argv):
            try:
                w = float(argv[i])
                argv.pop(i)
            except ValueError:
                pass  # the next token is a positional, not the guidance
        serving = resolve_serving_config(w)
        print(f"Certified serving config (guide_w={w:g}): {serving.config} — "
              f"{serving.expected_maps_per_min} maps/min/chip certified (on a TPU v5e) at "
              f"{serving.max_err_vs_indep_pct}% max P(k) error "
              f"(checkpoint {serving.checkpoint_fingerprint[:8]}…)")
    model_path = argv[0] if argv else (serving.model_path if serving is not None
                                       else DEFAULT_MODEL)
    if serving is not None and model_path != serving.model_path:
        raise SystemExit(
            f"--serving uses the committed certified checkpoint ({serving.model_path}); "
            f"a different model_path ({model_path}) cannot be paired with the certified "
            "calibration (calibrations are model-specific — "
            "scripts/calibration_transfer_diff.py)")
    timesteps = int(argv[1]) if len(argv) > 1 else 1500
    output_dir = argv[2] if len(argv) > 2 else "power_spectrum_comparison_output"
    return generate_comparison_plot(
        model_path=model_path,
        camels_data_path=os.environ.get("CAMELS_MAPS_PATH",
                                        "../data/Maps_HI_IllustrisTNG_LH_z=0.00.npy"),
        params_path=os.environ.get("CAMELS_PARAMS_PATH", "../data/params.npy"),
        output_dir=output_dir,
        selected_params_dict=dict(SELECTED_PARAMS),
        n_maps=int(os.environ.get("CAMELS_SAMPLE_N_MAPS", "15")),
        timesteps=timesteps,
        serving_steps=serving.steps if serving is not None else None,
        calibration_path=serving.calibration_path if serving is not None else None,
        guide_w=serving.guide_w if serving is not None else 0.0,
        device=device,
    )


if __name__ == "__main__":
    main()
