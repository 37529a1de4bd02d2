"""PyTorch port: the figure writers of ``utils/viz.py`` against the JAX
package's on the same numpy inputs, on the CPU: each PNG read back with
``matplotlib.image.imread`` is the JAX writer's pixel for pixel (the GIF
frame for frame), and each writer returns its path.  Without matplotlib
each prints that it skipped its file and returns a false value."""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("matplotlib")

import matplotlib.image as mpimg  # noqa: E402
from PIL import Image  # noqa: E402

from camels_diffusion_model_tpu.utils import viz as jax_viz  # noqa: E402
from camels_diffusion_model_tpu_torch.utils import viz  # noqa: E402

RS = np.random.RandomState(0)
MAPS = RS.rand(6, 16, 16, 1).astype(np.float32)
LOSS = list(np.exp(-np.linspace(0, 2, 7)) + 0.1)
EVAL = [0.9, 0.5]
METRICS = [{"guidance": w, "param_value": w / 5, "elbo": -100.0 - 3 * w, "bpd": 1.0 + w / 10,
            "nll": 50.0 - w} for w in (0.0, 1.0, 2.0, 3.0, 5.0)]
K = np.linspace(0.0, 3.0, 12)
BAND = (K, np.exp(-K) + 0.1, 0.01 + K / 100, np.exp(-K) + 0.12, 0.02 + K / 100)
BINS = (np.linspace(-3, 3, 30), RS.rand(30), RS.rand(30) / 10, RS.rand(30), RS.rand(30) / 10)

# name -> (writer name, file written, args after the path or output_dir, keyword arguments)
CASES = {
    "grid": ("save_image_grid", "grid.png", "path", (MAPS,), dict(nrow=3)),
    "grid_clamped": ("save_image_grid", "grid2.png", "path", (MAPS * 3 - 1,), {}),
    "viridis": ("visualize_viridis_style", "viridis.png", "path", (MAPS,), {}),
    "reconstruction": ("visualize_reconstruction_comparison", "recon.png", "path_last",
                       (MAPS, MAPS[::-1]), {}),
    "training_metrics": ("plot_training_metrics", "training_metrics.png", "dir",
                         (7, LOSS, EVAL, [3.0, 2.5], [3.1, 2.4], [-9.0, -8.0], [-9.5, -8.5],
                          [1.2, 1.1], [1.3, 1.0]), dict(eval_every=5)),
    "training_metrics_paper1_per_epoch": (
        "plot_training_metrics", "training_metrics.png", "dir",
        (7, LOSS, EVAL, [3.0, 2.5], [3.1, 2.4], list(np.linspace(-9, -8, 7)), [-9.5, -8.5],
         list(np.linspace(1.2, 1.1, 7)), [1.3, 1.0]),
        dict(eval_every=5, elbo_per_epoch=True, style="paper1")),
    "loss_curve": ("plot_loss_curve", "loss_evolution.png", "dir", (LOSS,), {}),
    "loss_curve_val": ("plot_loss_curve", "loss_evolution.png", "dir", (LOSS, EVAL),
                       dict(eval_every=5, title="Loss Evolution with 3 conditioning parameters")),
    "distribution": ("plot_distribution_comparison", "distribution_comparison.png", "dir_kw",
                     BINS, {}),
    "distribution_paper1": ("plot_distribution_comparison", "distribution_comparison.png",
                            "dir_kw", BINS, dict(style="paper1")),
    "distribution_plain": ("plot_distribution_comparison", "distribution_comparison.png",
                           "dir_kw", BINS, dict(styled=False)),
    "power_spectrum": ("plot_power_spectrum_comparison", "power_spectrum_comparison.png",
                       "dir_after", BAND, dict(title="Power Spectrum conditioning on Parameter 2")),
    "guidance": ("plot_guidance_metrics", "guidance_metrics.png", "dir_after", (METRICS,), {}),
    "parameter": ("plot_parameter_metrics", "parameter_2_metrics.png", "dir_after",
                  (METRICS, 1), {}),
    "sensitivity": ("plot_sensitivity_grid", "parameter_sensitivity.png", "dir_after",
                    (RS.rand(2, 5, 16, 16), np.linspace(0, 1, 5)), {}),
    "run_grid": ("plot_grid", "run_image_w2.png", "grid_dir", (MAPS, 6, 2), {}),
    "example_maps": ("plot_example_maps_comparison", "example.png", "path_last",
                     (MAPS, MAPS[::-1]), {}),
    "log_spectrum": ("plot_log_spectrum_comparison", "log_spectrum.png", "path_last",
                     tuple(b[1:] for b in BAND) + ({"Omega_m": 0.3, "sigma_8": 0.8},), {}),
}


def _call(module, case, root):
    name, filename, where, args, kw = CASES[case]
    writer = getattr(module, name)
    path = os.path.join(root, filename)
    if where == "path":
        return writer(args[0], path, *args[1:], **kw), path
    if where == "path_last":
        return writer(*args, path, **kw), path
    if where == "dir":
        return writer(root, *args, **kw), path
    if where == "dir_kw":
        return writer(*args, output_dir=root, **kw), path
    if where == "dir_after":
        return writer(*args, root, **kw), path
    if where == "grid_dir":  # plot_grid(x, n_sample, n_rows, save_dir, w)
        return writer(*args, root, 2, **kw), path
    raise ValueError(where)


@pytest.mark.parametrize("case", list(CASES))
def test_figure_is_the_jax_writers_pixel_for_pixel(tmp_path, case):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got, path = _call(viz, case, str(tmp_path / "port"))
    _, want_path = _call(jax_viz, case, str(tmp_path / "jax"))
    assert got and os.path.exists(path)
    a, b = mpimg.imread(path), mpimg.imread(want_path)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_denoising_gif_is_the_jax_writers_frame_for_frame(tmp_path):
    store = RS.rand(4, 6, 8, 8).astype(np.float32)
    for module, sub in ((viz, "port"), (jax_viz, "jax")):
        (tmp_path / sub).mkdir()
        assert module.plot_sample_gif(store, 6, 2, str(tmp_path / sub), "ani", 2,
                                      save=True) is not None
    frames = []
    for sub in ("port", "jax"):
        with Image.open(tmp_path / sub / "ani_w2.gif") as im:
            frames.append([np.asarray(im.seek(i) or im.convert("RGB"))
                           for i in range(im.n_frames)])
    assert len(frames[0]) == len(frames[1]) == 4
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)


def test_writers_skip_without_matplotlib(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for case in ("grid", "training_metrics", "distribution", "sensitivity"):
        result, path = _call(viz, case, str(tmp_path))
        assert not result
    assert not os.listdir(tmp_path)
    assert capsys.readouterr().out.splitlines() == [
        f"skipped {name}: matplotlib is not installed"
        for name in ("grid.png", "training_metrics.png", "distribution_comparison.png",
                     "parameter_sensitivity.png")]
