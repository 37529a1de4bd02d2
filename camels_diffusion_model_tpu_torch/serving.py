"""Certified-serving configuration resolver and model loader.

``resolve_serving_config`` is a copy of
``camels_diffusion_model_tpu/serving.py:66-154``: among the independently
certified rows of ``artifacts/certification/validation_w{w}_calibrated.indep
.json`` the highest-throughput one wins, and every pairing (validation
artifact, calibration sidecar) must carry the md5 of the committed
checkpoint, or it raises.  ``expected_maps_per_min`` is the throughput the
JAX package was certified at on a TPU v5e chip; it is not a figure of this
port.  ``certification_contexts`` gives the contexts the committed exact-chain
references were sampled on.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .data.pipeline import normalize_params, train_test_split
from .data.synthetic import synthetic_params
from .diffusion.calibration import load_calibration_meta
from .models.blocks import Conv2d, ConvTranspose2d, Linear
from .models.context_unet import VARIANTS, ContextUnet
from .models.fold_bn import fold_batchnorm_variables
from .training.checkpoints import md5
from .utils.weights import from_jax_variables


class ServingConfigError(RuntimeError):
    """A certified serving configuration could not be resolved safely."""


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One certified fast-serving row, resolved to runnable pieces."""

    guide_w: float
    steps: int                     # strided-DDPM step count
    model_path: str                # committed certification checkpoint
    calibration_path: str          # matching spectral-calibration npz
    config: str                    # row label from the validation artifact
    expected_maps_per_min: float   # certified throughput on a TPU v5e chip
    max_err_vs_indep_pct: float    # certified spectral error vs indep ref
    checkpoint_fingerprint: str    # md5 the whole chain is stamped with


def default_artifact_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "artifacts", "certification",
    )


def resolve_serving_config(
    guide_w: float, art_dir: Optional[str] = None
) -> ServingConfig:
    """Resolve the committed certified serving row for ``guide_w``.

    Raises :class:`ServingConfigError` when no artifact exists for this
    guidance, when a fingerprint does not match the committed checkpoint, or
    when the row's calibration sidecar is missing.
    """
    if float(guide_w) != int(guide_w):
        raise ServingConfigError(
            f"no certified serving row exists for guide_w={guide_w}: "
            "certification artifacts are per integer guidance setting "
            "(committed: w=0 and w=2)"
        )
    w = int(guide_w)
    art_dir = art_dir or default_artifact_dir()
    val_path = os.path.join(art_dir, f"validation_w{w}_calibrated.indep.json")
    if not os.path.exists(val_path):
        raise ServingConfigError(
            f"no certification artifact for guide_w={w}: {val_path} not found"
        )
    model_path = os.path.join(art_dir, "model", "train_state.msgpack")
    if not os.path.exists(model_path):
        raise ServingConfigError(
            f"committed certification checkpoint missing: {model_path}"
        )
    ckpt_md5 = md5(model_path)

    with open(val_path) as f:
        d = json.load(f)
    fp = d.get("checkpoint_fingerprint")
    if fp != ckpt_md5:
        raise ServingConfigError(
            f"certification artifact {val_path} is stamped for checkpoint "
            f"{fp!r} but the committed checkpoint is {ckpt_md5!r} — the "
            "certified rows were produced by a different model"
        )
    certified = set(d.get("certified_configs_independent") or [])
    rows = [r for r in d.get("rows", []) if r["config"] in certified]
    if not rows:
        raise ServingConfigError(
            f"{val_path} carries no independently-certified rows for "
            f"guide_w={w}"
        )
    best = max(rows, key=lambda r: r["maps_per_min"])
    m = re.search(r"strided DDPM (\d+)", best["config"])
    steps = int(best.get("steps") or (m and m.group(1)) or 0)
    if steps <= 0:
        raise ServingConfigError(
            f"cannot determine the step count of certified row "
            f"{best['config']!r} in {val_path}"
        )
    calib_path = os.path.join(art_dir, f"calib_w{w}_{steps}.npz")
    if not os.path.exists(calib_path):
        raise ServingConfigError(
            f"certified row {best['config']!r} needs the spectral "
            f"calibration sidecar {calib_path}, which is missing"
        )
    calib_fp = load_calibration_meta(calib_path).get("checkpoint_fingerprint")
    if calib_fp is not None and calib_fp != ckpt_md5:
        raise ServingConfigError(
            f"calibration {calib_path} is stamped for checkpoint "
            f"{calib_fp!r}, not the committed one ({ckpt_md5!r}) — "
            "calibrations are model-specific"
        )
    return ServingConfig(
        guide_w=float(w),
        steps=steps,
        model_path=model_path,
        calibration_path=calib_path,
        config=best["config"],
        expected_maps_per_min=float(best["maps_per_min"]),
        max_err_vs_indep_pct=float(best["max_err_vs_indep_pct"]),
        checkpoint_fingerprint=ckpt_md5,
    )


def certification_contexts(n: int, param_sets: int = 1000) -> np.ndarray:
    """``(n, 6)`` float32: the certification's test-split contexts tiled to
    ``n``, as ``scripts/certify_fast_sampler.py:154-160,253-255`` builds
    them (``synthetic_camels(param_sets, 15, ..., seed=42)``, each set
    expanded 15 times and min-max normalised, a test split of
    ``max(param_sets * 15 // 10, 15)`` maps at seed 42).  The committed
    exact-chain references used ``param_sets=1000``
    (``scripts/run_n16k_confirmation.sh:47``)."""
    n_maps = param_sets * 15
    cond, _, _ = normalize_params(synthetic_params(param_sets, seed=42), n_maps, 6)
    _, test_idx, _ = train_test_split(n_maps, max(n_maps // 10, 15), seed=42)
    test_c = cond[test_idx]
    return np.tile(test_c, (n // test_c.shape[0] + 1, 1))[:n]


def load_model(variables: dict, device=None, fold_bn: bool = True,
               dtype: torch.dtype = torch.float32) -> ContextUnet:
    """A ContextUnet holding flax ``variables`` (numpy tree from
    ``load_variables``; widths and variant read from it: a ``down3`` makes
    it three-level, deep or, with ``out_conv_extra``, big), BatchNorms
    folded by default, computing in ``dtype`` (float32 or bfloat16: the JAX
    package's ``ContextUnet(dtype=...)`` plus ``fold_inference``), in eval
    mode on ``device`` with channels_last weights.

    The BatchNorms fold in fp32 (``models/fold_bn.py``).  A folded bf16
    model keeps its conv and dense weights as bf16 copies, the cast each
    use would make; its GroupNorm parameters stay fp32, as kernel K2 takes
    them.  An unfolded one keeps every parameter and statistic fp32."""
    device = resolve_device(device)
    if fold_bn:
        variables = fold_batchnorm_variables(variables)
    p = variables["params"]
    variant = VARIANTS["big" if "out_conv_extra" in p else "deep" if "down3" in p
                       else "canonical"]
    model = ContextUnet(
        in_channels=p["init_conv"]["conv1"]["conv"]["kernel"].shape[2],
        n_feat=p["init_conv"]["conv1"]["conv"]["kernel"].shape[3],
        n_cfeat=p["contextembed1"]["fc1"]["kernel"].shape[0],
        height=p["up0_conv"]["kernel"].shape[0] * 2 ** variant["levels"],
        fold_bn=fold_bn, dtype=dtype, **variant,
    )
    model.load_state_dict(from_jax_variables(variables))
    model.requires_grad_(False)
    if fold_bn and dtype != torch.float32:
        for m in model.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
                m.to(dtype)
    return model.eval().to(device=device, memory_format=torch.channels_last)
