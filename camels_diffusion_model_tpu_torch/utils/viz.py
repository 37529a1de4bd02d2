"""The two figures of the power-spectrum comparison CLI (counterpart of
``camels_diffusion_model_tpu/utils/viz.py:459-508``): the 2x5 example maps
and the log-binned P(k) comparison (``sample_power_spectra.py:286-336``).

matplotlib is imported inside each function, never with the package: the
card's machine has none, and there each figure prints one line saying it
was skipped and returns False, and the run goes on.  The run figures of
the JAX module (training curves, grids, sensitivity) are not ported.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _pyplot(output_path: str):
    """matplotlib's pyplot on the Agg backend, or None (after one line
    saying ``output_path`` was skipped) when matplotlib is absent."""
    try:
        import matplotlib
    except ImportError:
        print(f"skipped {os.path.basename(output_path)}: matplotlib is not installed")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _to_bhw(images) -> np.ndarray:
    images = np.asarray(images)
    return images[..., 0] if images.ndim == 4 else images


def plot_example_maps_comparison(camels_maps, model_maps, output_path: str,
                                 top_label: str = "CAMELS",
                                 bottom_label: str = "HI-CDM") -> bool:
    """The first five maps of each set, one row each, viridis; True when
    written."""
    plt = _pyplot(output_path)
    if plt is None:
        return False
    camels_maps, model_maps = _to_bhw(camels_maps), _to_bhw(model_maps)
    fig, axes = plt.subplots(2, 5, figsize=(15, 6))
    for i in range(5):
        for row, (maps, label) in enumerate(((camels_maps, top_label),
                                             (model_maps, bottom_label))):
            axes[row, i].imshow(maps[i], cmap="viridis")
            axes[row, i].set_title(f"{label} {i + 1}")
            axes[row, i].axis("off")
    plt.tight_layout()
    plt.savefig(output_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_log_spectrum_comparison(k, camels_mean, camels_std, model_mean, model_std,
                                 params_dict: Dict[str, float], output_path: str) -> bool:
    """Mean P(k) with a one-sigma band for CAMELS (red) and the model
    (blue) on log axes, the parameters in the title; True when written."""
    plt = _pyplot(output_path)
    if plt is None:
        return False
    plt.figure(figsize=(10, 8))
    plt.plot(k, camels_mean, "r-", linewidth=2, label="CAMELS", alpha=0.8)
    plt.fill_between(k, camels_mean - camels_std, camels_mean + camels_std,
                     color="red", alpha=0.3)
    plt.plot(k, model_mean, "b-", linewidth=2, label="Model", alpha=0.8)
    plt.fill_between(k, model_mean - model_std, model_mean + model_std,
                     color="blue", alpha=0.3)
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel("k", fontsize=14)
    plt.ylabel("P(k)", fontsize=14)
    plt.legend(fontsize=12)
    plt.grid(True, alpha=0.3)
    param_text = ", ".join(f"{name}={v}" for name, v in params_dict.items())
    plt.title(f"Power Spectrum Comparison\n{param_text}", fontsize=12)
    plt.savefig(output_path, dpi=300, bbox_inches="tight")
    plt.close()
    return True
