"""The PNG figures of a run and of the power-spectrum comparison CLI
(counterpart of ``camels_diffusion_model_tpu/utils/viz.py``): image grids
(torchvision's ``save_image`` layout), the viridis sample and
reconstruction figures, the training-metrics and loss figures, the
pixel-PDF and P(k) comparisons, the guidance, parameter-metrics and
sensitivity figures, the per-image-normalised grid and the denoising GIF,
and the CLI's 2x5 example maps and log-binned P(k) comparison.  Each
draws what the JAX writer of the same name draws, with the same
matplotlib calls, so the PNGs are the same pixels.

matplotlib is imported inside each function, never with the package: the
card's machine has none, and there each figure prints one line saying it
was skipped and returns a false value (None or False), and the run goes
on.  Each writer returns the path written (the CLI's two: True).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .image_norm import norm_all, norm_batch


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


def save_image_grid(images, path: str, nrow: int = 8, padding: int = 2) -> Optional[str]:
    """torchvision ``save_image``'s layout: a row-major grid with 2-pixel
    padding, values clamped to [0, 1], a grayscale PNG (``viz.py:34-52``)."""
    plt = _pyplot(path)
    if plt is None:
        return None
    imgs = np.clip(_to_bhw(images), 0.0, 1.0)
    b, h, w = imgs.shape
    ncol = min(nrow, b)
    nrows = -(-b // ncol)
    grid = np.zeros((nrows * h + (nrows + 1) * padding, ncol * w + (ncol + 1) * padding),
                    np.float32)
    for idx in range(b):
        r, c = divmod(idx, ncol)
        y = r * h + (r + 1) * padding
        x = c * w + (c + 1) * padding
        grid[y:y + h, x:x + w] = imgs[idx]
    plt.imsave(path, grid, cmap="gray", vmin=0.0, vmax=1.0)
    return path


def _viridis_panel_grid(plt, nrows: int, ncols: int, scale: float = 3.0):
    """Axes grid for viridis map panels, all frames and ticks off."""
    fig, axes = plt.subplots(nrows, ncols, figsize=(scale * ncols, scale * nrows))
    axes = np.atleast_1d(axes).reshape(nrows, ncols)
    for ax in axes.flat:
        ax.set_axis_off()
    return fig, axes


def visualize_viridis_style(samples, output_path: str, nrow: int = 5,
                            title: str = "CAMELS") -> Optional[str]:
    """The viridis sample grid (at most 25 maps) with a rotated label on
    its side (``viz.py:64-87``)."""
    plt = _pyplot(output_path)
    if plt is None:
        return None
    maps = _to_bhw(samples)[:25]
    nrows = -(-len(maps) // nrow)
    fig, axes = _viridis_panel_grid(plt, nrows, nrow)
    for ax, img in zip(axes.flat, maps):
        ax.imshow(img, cmap="viridis")
    fig.subplots_adjust(left=0.1)
    fig.text(0.05, 0.5, title, rotation="vertical", va="center", fontsize=16,
             fontweight="bold")
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


def visualize_reconstruction_comparison(original, reconstructed,
                                        output_path: str) -> Optional[str]:
    """Two rows of five viridis maps, originals over reconstructions, each
    row labelled over its middle panel (``viz.py:90-107``)."""
    plt = _pyplot(output_path)
    if plt is None:
        return None
    rows = [("Original Images", _to_bhw(original)[:5]),
            ("Reconstructed Images", _to_bhw(reconstructed)[:5])]
    fig, axes = _viridis_panel_grid(plt, 2, 5)
    for r, (label, maps) in enumerate(rows):
        for ax, img in zip(axes[r], maps):
            ax.imshow(img, cmap="viridis")
        axes[r, 2].set_title(label, fontsize=16, fontweight="bold", pad=20)
    fig.tight_layout()
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


# Figure-font styles (viz.py:110-120): "default" is the paper mode's,
# "paper1" its large-font publication variant.
PLOT_STYLES = {
    "default": dict(label_fs=14, legend_fs=16, title_fs=18, weight="bold",
                    series_suffix=True, dist_legend_fs=16, tick_fs=None),
    "paper1": dict(label_fs=25, legend_fs=25, title_fs=28, weight="normal",
                   series_suffix=False, dist_legend_fs=22, tick_fs=16),
}


def _eval_x(n_epoch: int, eval_every: int) -> List[int]:
    """The 1-based epochs of the evaluation points: every ``eval_every``-th
    and the last."""
    epochs = list(range(0, n_epoch, eval_every))
    if (n_epoch - 1) % eval_every != 0:
        epochs.append(n_epoch - 1)
    return [e + 1 for e in epochs]


def plot_training_metrics(output_dir: str, n_epoch: int, loss_log: Sequence[float],
                          val_loss_log: Sequence[float], likelihood_log: Sequence[float],
                          val_likelihood_log: Sequence[float], elbo_log: Sequence[float],
                          val_elbo_log: Sequence[float], bpd_log: Sequence[float],
                          val_bpd_log: Sequence[float], eval_every: int = 5,
                          elbo_per_epoch: bool = False,
                          style: str = "default") -> Optional[str]:
    """``training_metrics.png``: log loss, NLL, ELBO and BPD over the
    epochs, training and validation (``viz.py:123-236``); ``elbo_per_epoch``
    draws the training ELBO/BPD of every epoch, ``style`` a
    :data:`PLOT_STYLES` key."""
    path = os.path.join(output_dir, "training_metrics.png")
    plt = _pyplot(path)
    if plt is None:
        return None
    st = PLOT_STYLES[style]

    def lab(series, metric):
        return f"{series} {metric}" if st["series_suffix"] else series

    def trim(xs, ys):  # a resumed run's evaluation logs may be shorter
        n = min(len(xs), len(ys))
        return xs[:n], ys[:n]

    def finish(ylabel, title):
        plt.xlabel("Epoch", fontsize=st["label_fs"])
        plt.ylabel(ylabel, fontsize=st["label_fs"])
        plt.legend(fontsize=st["legend_fs"])
        plt.grid(True, alpha=0.7)
        plt.title(title, fontsize=st["title_fs"], fontweight=st["weight"])

    plt.figure(figsize=(15, 10))
    eval_x = _eval_x(n_epoch, eval_every)
    plt.subplot(2, 2, 1)
    plt.plot(range(1, n_epoch + 1), np.log(loss_log), color="orange",
             label=lab("Training", "Loss"), linewidth=2)
    if val_loss_log:
        xs, ys = trim(eval_x, val_loss_log)
        plt.plot(xs, np.log(ys), "o-", color="blue", label=lab("Validation", "Loss"),
                 linewidth=2, markersize=6)
    plt.xlabel("Epoch", fontsize=st["label_fs"])
    plt.ylabel("Log Loss", fontsize=st["label_fs"])
    plt.legend(fontsize=st["legend_fs"])
    plt.grid(True, alpha=0.7)
    plt.title("Training Metrics", fontsize=st["title_fs"], fontweight=st["weight"])

    plt.subplot(2, 2, 2)
    if likelihood_log:
        xs, ys = trim(eval_x, likelihood_log)
        plt.plot(xs, ys, "o-", color="orange", label=lab("Training", "NLL"), linewidth=2,
                 markersize=6)
    if val_likelihood_log:
        xs, ys = trim(eval_x, val_likelihood_log)
        plt.plot(xs, ys, "o-", color="blue", label=lab("Validation", "NLL"), linewidth=2,
                 markersize=6)
    finish("NLL", "Negative Log Likelihood Evolution")

    for panel, (train_log, val_log, metric, ylabel, title) in enumerate((
            (elbo_log, val_elbo_log, "ELBO", "ELBO", "ELBO Evolution"),
            (bpd_log, val_bpd_log, "BPD", "Bits Per Dimension (BPD)", "BPD Evolution"))):
        plt.subplot(2, 2, 3 + panel)
        if train_log:
            if elbo_per_epoch:
                xs, ys = range(1, len(train_log) + 1), train_log
            else:
                xs, ys = trim(eval_x, train_log)
            plt.plot(xs, ys, color="orange", label=lab("Training", metric), linewidth=2)
        if val_log:
            xs, ys = trim(eval_x, val_log)
            plt.plot(xs, ys, "o-", color="blue", label=lab("Validation", metric),
                     linewidth=2, markersize=6)
        finish(ylabel, title)

    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


def plot_loss_curve(output_dir: str, loss_log: Sequence[float],
                    val_loss_log: Sequence[float] = (), eval_every: int = 5,
                    title: str = "") -> Optional[str]:
    """``loss_evolution.png``: the log training loss, with the validation
    loss at its evaluation points when there is one (``viz.py:239-271``)."""
    path = os.path.join(output_dir, "loss_evolution.png")
    plt = _pyplot(path)
    if plt is None:
        return None
    n_epoch = len(loss_log)
    plt.figure(figsize=(10, 5) if val_loss_log else None)
    plt.plot(np.arange(1, n_epoch + 1), np.log(np.asarray(loss_log)), label="Training Loss")
    if val_loss_log:
        xs = _eval_x(n_epoch, eval_every)[:len(val_loss_log)]
        plt.plot(xs, np.log(np.asarray(val_loss_log[:len(xs)])), "o-",
                 label="Validation Loss")
        plt.legend()
    plt.xlabel("Epoch")
    plt.ylabel("Log Loss")
    plt.grid(True, alpha=0.7)
    if title:
        plt.title(title)
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    return path


def plot_distribution_comparison(bin_mid, orig_mean, orig_std, gen_mean, gen_std,
                                 output_dir: str,
                                 filename: str = "distribution_comparison.png",
                                 styled: bool = True,
                                 style: str = "default") -> Optional[str]:
    """The mean and standard deviation of the pixel PDF, originals against
    the model's maps, in two panels (``viz.py:274-315``)."""
    path = os.path.join(output_dir, filename)
    plt = _pyplot(path)
    if plt is None:
        return None
    st = PLOT_STYLES[style]
    fig, ax = plt.subplots(1, 2, figsize=(14, 4))
    ax[0].plot(bin_mid, orig_mean, color="blue", linewidth=2, label="Original")
    ax[0].plot(bin_mid, gen_mean, color="red", linewidth=2, linestyle="--", label="Model")
    ax[0].set_ylabel(r"$\mu(\rm PDF)$", fontsize=st["label_fs"])
    ax[0].legend(fontsize=st["dist_legend_fs"])
    ax[1].plot(bin_mid, orig_std, color="blue", linewidth=2)
    ax[1].plot(bin_mid, gen_std, color="red", linewidth=2, linestyle="--")
    ax[1].set_ylabel(r"$\sigma(\rm PDF)$", fontsize=st["label_fs"])
    for i in range(2):
        ax[i].set_xlabel(r"$N_{\rm HI}$", fontsize=st["label_fs"])
        if st["tick_fs"]:
            ax[i].tick_params(axis="both", which="major", labelsize=st["tick_fs"])
        ax[i].grid(True, alpha=0.7)
    if styled:
        fig.suptitle("Probability Distribution", fontsize=st["title_fs"],
                     fontweight=st["weight"])
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


def plot_power_spectrum_comparison(k, orig_mean, orig_std, gen_mean, gen_std,
                                   output_dir: str,
                                   title: str = "Power Spectrum Comparison",
                                   filename: str = "power_spectrum_comparison.png",
                                   skip_first: bool = True) -> Optional[str]:
    """Linear-bin P(k) on log axes with one-sigma bands, originals (blue)
    against the model (red) (``viz.py:318-347``)."""
    path = os.path.join(output_dir, filename)
    plt = _pyplot(path)
    if plt is None:
        return None
    s = 1 if skip_first else 0
    plt.figure(figsize=(10, 6))
    plt.loglog(k[s:], orig_mean[s:], "b-", label="Original")
    plt.fill_between(k[s:], orig_mean[s:] - orig_std[s:], orig_mean[s:] + orig_std[s:],
                     alpha=0.3, color="b")
    plt.loglog(k[s:], gen_mean[s:], "r-", label="Diffusion Model")
    plt.fill_between(k[s:], gen_mean[s:] - gen_std[s:], gen_mean[s:] + gen_std[s:],
                     alpha=0.3, color="r")
    plt.xlabel("k")
    plt.ylabel("P(k)")
    plt.title(title)
    plt.legend()
    plt.grid(True, which="both", ls="-", alpha=0.2)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()
    return path


def _three_panels(plt, metrics, xkey: str, panels, xlabel: str, path: str) -> str:
    """One row of three line plots of ``metrics`` against ``xkey``."""
    plt.figure(figsize=(15, 5))
    for i, (key, ylabel, title) in enumerate(panels):
        plt.subplot(1, 3, i + 1)
        plt.plot([m[xkey] for m in metrics], [m[key] for m in metrics], "o-", linewidth=2,
                 markersize=8)
        plt.xlabel(xlabel, fontsize=14)
        plt.ylabel(ylabel, fontsize=14)
        plt.grid(True, alpha=0.7)
        plt.title(title, fontsize=16, fontweight="bold")
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


def plot_guidance_metrics(metrics: List[Dict[str, float]], output_dir: str) -> Optional[str]:
    """``guidance_metrics.png``: guidance strength against ELBO, BPD and NLL
    (``viz.py:350-370``)."""
    path = os.path.join(output_dir, "guidance_metrics.png")
    plt = _pyplot(path)
    if plt is None:
        return None
    return _three_panels(plt, metrics, "guidance", (
        ("elbo", "ELBO", "Guidance Strength vs. ELBO"),
        ("bpd", "Bits Per Dimension (BPD)", "Guidance Strength vs. BPD"),
        ("nll", "Negative Log Likelihood (NLL)", "Guidance Strength vs. NLL")),
        "Guidance Strength", path)


def plot_parameter_metrics(metrics: List[Dict[str, float]], param_idx: int,
                           output_dir: str) -> Optional[str]:
    """``parameter_<i>_metrics.png``: one parameter's value against ELBO,
    BPD and NLL (``viz.py:373-396``)."""
    path = os.path.join(output_dir, f"parameter_{param_idx + 1}_metrics.png")
    plt = _pyplot(path)
    if plt is None:
        return None
    panels = [(key, ylabel, f"Parameter {param_idx + 1} Value vs. {ylabel.split(' ')[0]}")
              for key, ylabel in (("elbo", "ELBO"), ("bpd", "Bits Per Dimension (BPD)"),
                                  ("nll", "Negative Log Likelihood (NLL)"))]
    return _three_panels(plt, metrics, "param_value", panels,
                         f"Parameter {param_idx + 1} Value", path)


def plot_sensitivity_grid(images, param_values, output_dir: str,
                          suptitle: str = "Power Spectrum") -> Optional[str]:
    """``parameter_sensitivity.png``: ``(num_params, 5, H, W)`` maps, one
    row a parameter, one column a value (``viz.py:399-420``; the
    reference's own "Power Spectrum" title)."""
    path = os.path.join(output_dir, "parameter_sensitivity.png")
    plt = _pyplot(path)
    if plt is None:
        return None
    num_params = images.shape[0]
    fig, axs = plt.subplots(num_params, 5, figsize=(15, 3 * num_params))
    axs = np.atleast_2d(axs)
    for p in range(num_params):
        for i in range(5):
            axs[p, i].imshow(images[p, i], cmap="viridis")
            axs[p, i].set_title(f"Param {p + 1} = {param_values[i]:.2f}", fontsize=12)
            axs[p, i].axis("off")
    fig.suptitle(suptitle, fontsize=18, fontweight="bold")
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


def plot_grid(x, n_sample: int, n_rows: int, save_dir: str, w) -> Optional[str]:
    """``run_image_w<w>.png``: the maps, each normalised to [0, 1], in a
    grid of ``n_rows`` rows (``viz.py:423-428``)."""
    return save_image_grid(norm_batch(_to_bhw(x)[..., None]),
                           os.path.join(save_dir, f"run_image_w{w}.png"),
                           nrow=n_sample // n_rows)


def plot_sample_gif(x_gen_store, n_sample: int, nrows: int, save_dir: str, fn: str, w,
                    save: bool = False):
    """The denoising trajectory ``(T, S, H, W[, C])`` as a FuncAnimation,
    written to ``<fn>_w<w>.gif`` with ``save`` (``viz.py:431-473``);
    returns the animation (None where matplotlib is absent)."""
    plt = _pyplot(os.path.join(save_dir, f"{fn}_w{w}.gif"))
    if plt is None:
        return None
    from matplotlib.animation import FuncAnimation, PillowWriter

    store = np.asarray(x_gen_store)
    if store.ndim == 4:
        store = store[..., None]
    ncols = n_sample // nrows
    nstore = norm_all(store, store.shape[0], n_sample)
    fig, axs = plt.subplots(nrows=nrows, ncols=ncols, sharex=True, sharey=True,
                            figsize=(ncols, nrows))
    axs = np.atleast_2d(axs)

    def animate_diff(i, store_):
        plots = []
        for row in range(nrows):
            for col in range(ncols):
                axs[row, col].clear()
                axs[row, col].set_xticks([])
                axs[row, col].set_yticks([])
                plots.append(axs[row, col].imshow(store_[i, (row * ncols) + col, ..., 0]))
        return plots

    ani = FuncAnimation(fig, animate_diff, fargs=[nstore], interval=200, blit=False,
                        repeat=True, frames=nstore.shape[0])
    plt.close()
    if save:
        ani.save(os.path.join(save_dir, f"{fn}_w{w}.gif"), dpi=100,
                 writer=PillowWriter(fps=5))
    return ani


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
