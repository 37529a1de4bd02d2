"""PyTorch port: ``run_experiment`` at the tiny size on the CPU -- the JAX
runner's artifact names and log-line formats, a resume that reproduces the
unbroken run, the deep and big variants' modes end to end, a bf16 run, the
figures written (and, without matplotlib, skipped and listed), and
``mesh_devices`` beyond the process group raising; the run logger's lines
against the JAX package's.
Values differ from the JAX runner's (torch generators, not threefry), so
formats are compared with the numbers masked."""

import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from camels_diffusion_model_tpu.data.pipeline import load_camels_dataset as jax_load_dataset
from camels_diffusion_model_tpu.training.checkpoints import (
    weights_checkpoint_plan as jax_weights_checkpoint_plan,
)
from camels_diffusion_model_tpu.utils.run_logging import RunLogger as JaxRunLogger
from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.data.synthetic import synthetic_camels
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables
from camels_diffusion_model_tpu_torch.utils.run_logging import RunLogger

TINY = dict(lrate=1e-3, n_epoch=2, timesteps=8, num_params=3, n_feat=8, height=16,
            data_size=32, synthetic_param_sets=4, batch_size=8, n_eval_images=2,
            eval_batch_size=8, nll_subset=8, elbo_subset=8)
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")
# The figures of a ``condition`` run at TINY (8 saved states: every 5th),
# the JAX runner's (tests/test_torch_port_stochastic.py compares the names).
CONDITION_PNGS = ["distribution_comparison.png", "guidance_strength_samples.png",
                  "intermediate_step_0.png", "intermediate_step_5.png", "loss_evolution.png",
                  "parameter_grid_samples_3params.png", "parameter_sensitivity.png",
                  "reconstructed_images.png", "test_images.png"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The narrow model's ops gain nothing from threads, and tier-1 runs six
    pytest workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_condition_run_writes_the_jax_artifacts_and_resumes(tmp_path, monkeypatch):
    """Mode ``condition`` (2 epochs, T 8, a train checkpoint every epoch):
    the JAX runner's files (its PNGs by name), its sidecars byte for byte,
    its ``results`` keys; then a run resumed from the epoch-1 train
    checkpoint ends with the unbroken run's train state, bit for bit."""
    snapshots = tmp_path / "snapshots"
    snapshots.mkdir()
    save = experiment.save_train_checkpoint

    def save_and_keep(state, epoch, path):
        save(state, epoch, path)
        shutil.copy(path, snapshots / f"epoch_{epoch}.msgpack")

    monkeypatch.setattr(experiment, "save_train_checkpoint", save_and_keep)
    cfg = ExperimentConfig(mode="condition", output_root=str(tmp_path / "a"), ckpt_every=1,
                           **TINY)
    res = experiment.run_experiment(cfg, device="cpu")
    out = res["output_dir"]
    weights = [f"weights/{jax_weights_checkpoint_plan('plus1', ep, 2, 1)[1]}" for ep in range(2)]
    assert _files(out) == sorted(["dataset_info.txt", "output.log", "param_max.npy",
                                  "param_min.npy", "selected_params.txt",
                                  "weights/train_state.msgpack", *weights, *CONDITION_PNGS])
    assert {"output_dir", "data_source", "loss_log", "val_loss_log", "total_training_time",
            "epoch_times", "n_train", "means"} <= set(res)
    assert res["data_source"] == "synthetic" and res["n_train"] == 54
    assert len(res["loss_log"]) == len(res["val_loss_log"]) == 2
    assert np.isfinite(res["loss_log"] + res["val_loss_log"]).all()
    assert res["not_ported"] == [] and res["figures_skipped"] == []
    assert _read(os.path.join(out, "output.log")) == b"Device used: CPU\n" * 2

    maps, params = synthetic_camels(4, 15, 32, seed=cfg.seed)
    ds = jax_load_dataset(maps, params, num_params=3, height=16, test_size=6, seed=cfg.seed)
    jax_log = JaxRunLogger(str(tmp_path / "jax"))
    jax_log.dataset_info(ds.info)
    sel = np.random.default_rng(cfg.seed + 1).choice(ds.n_test, size=2, replace=False)
    jax_log.selected_params(ds.test_c[sel])
    for name in ("dataset_info.txt", "selected_params.txt"):
        assert _read(os.path.join(out, name)) == _read(str(tmp_path / "jax" / name))
    np.testing.assert_array_equal(np.load(os.path.join(out, "param_min.npy")), ds.param_min)

    resumed = ExperimentConfig(mode="condition", output_root=str(tmp_path / "b"),
                               ckpt_every=1, resume=True, **TINY)
    os.makedirs(os.path.join(resumed.output_dir(), "weights"))
    shutil.copy(snapshots / "epoch_1.msgpack",
                os.path.join(resumed.output_dir(), "weights", "train_state.msgpack"))
    res_b = experiment.run_experiment(resumed, device="cpu")
    assert len(res_b["loss_log"]) == 1
    assert res_b["loss_log"][0] == res["loss_log"][1]
    for name in ("weights/train_state.msgpack", "weights/model_epoch_2.msgpack"):
        assert _read(os.path.join(res_b["output_dir"], name)) == _read(os.path.join(out, name))


def test_paper_run_writes_the_jax_timing_log_lines(tmp_path):
    """Mode ``paper``: every line of ``timing_and_performance.log``, numbers
    masked, is the line the JAX runner's logger writes at that point, the
    parameter grid, guidance sweep and sensitivity included."""
    res = experiment.run_experiment(
        ExperimentConfig(mode="paper", output_root=str(tmp_path), **TINY), device="cpu")
    assert set(res["recon_metrics"]) == {"elbo", "bpd", "nll"}
    assert [m["guidance"] for m in res["guidance_metrics"]] == [0.0, 1.0, 2.0, 3.0, 5.0]
    jax_log = JaxRunLogger(str(tmp_path / "jax"))
    jax_log.write_header(1e-3, 2, 8, 3)
    for ep in range(2):
        jax_log.epoch(ep, 2, 0.1, 0.1)
        jax_log.eval_metrics(*[0.1] * 8)
    jax_log.training_complete(1.0, [0.1, 0.1], *[0.1] * 6)
    jax_log.sampling_header()
    jax_log.reconstruction_perf(2, 0.1, 0.1, 8)
    jax_log.sample_metrics("reconstructed images", 0.1, 0.1, 0.1)
    jax_log.grid_perf(25, 0.1)
    jax_log.sample_metrics("parameter grid samples", 0.1, 0.1, 0.1)
    for w in (0.0, 1.0, 2.0, 3.0, 5.0):
        jax_log.guidance_metrics(w, 0.1, 0.1, 0.1)
    for p_idx in range(3):
        jax_log.sensitivity_header(p_idx)
        for v in np.linspace(0.0, 1.0, 5):
            jax_log.sensitivity_value(float(v), 0.1, 0.1, 0.1)

    def masked(path):
        with open(path) as f:
            return [NUMBER.sub("#", line) for line in f]

    assert (masked(os.path.join(res["output_dir"], "timing_and_performance.log"))
            == masked(jax_log.timing_log_path))


def test_run_logger_writes_the_jax_packages_lines(tmp_path):
    calls = [
        ("write_header", (1e-5, 100, 1500, 6)), ("write_header", (1e-5, 100, 1500, None)),
        ("epoch", (0, 100, 53.09, 0.150735)),
        ("eval_metrics", (0.076976, 0.000132, 0.0, 0.000132, 0.0, 96116.96, 95264.62, 364.0)),
        ("training_complete", (12994.66, [53.0, 53.1], 0.053193, 0.076976, 0.002437,
                               0.003714, 87657.895, 87000.0)),
        ("training_complete", (1.0, [1.0], 0.5)),
        ("sampling_header", ()), ("reconstruction_perf", (10, 19.38, 0.0125, 1500)),
        ("sample_metrics", ("reconstructed images", 0.1, 0.01, 100.0)),
        ("grid_perf", (25, 31.416)),
        ("guidance_metrics", (2.0, 0.123456789, 0.0015, 612.5)),
        ("guidance_metrics", (0.0, 1.0, 2.0, 3.0)),
        ("sensitivity_header", (0,)), ("sensitivity_header", (5,)),
        ("sensitivity_value", (0.25, 0.1, 0.0007, 600.25)),
        ("sensitivity_value", (1.0, 2.0, 3.0, 4.0)),
        ("dataset_info", ({"total": 480, "train": 432, "test": 48, "num_params": 6,
                           "original_param_shape": (32, 6), "expanded_param_shape": (480, 6),
                           "final_param_shape": (480, 6)},)),
        ("selected_params", (np.array([[0.1, 0.25], [0.5, 1.0]]),)),
        ("device_line", ()),
    ]
    ours, theirs = RunLogger(str(tmp_path / "port"), "cpu"), JaxRunLogger(str(tmp_path / "jax"))
    for name, args in calls:
        getattr(ours, name)(*args)
        getattr(theirs, name)(*args)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for name in _files(tmp_path / "jax"):
        assert _read(str(tmp_path / "port" / name)) == _read(str(tmp_path / "jax" / name)), name


@pytest.mark.parametrize("mode,skipped", [
    ("condition", []),
    ("nov26", []),
])
def test_parts_not_ported_are_skipped_and_listed(tmp_path, capsys, monkeypatch, mode, skipped):
    """The port runs every part of a run (``results["not_ported"]`` is
    empty and no line names a part not run); where matplotlib is absent,
    as on the card's machine, each figure prints that it was skipped and
    is listed in ``results["figures_skipped"]``, the run writes no PNG and
    the stages after the reconstruction run."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = ExperimentConfig(mode=mode, output_root=str(tmp_path), **TINY)
    res = experiment.run_experiment(cfg, device="cpu")
    assert res["not_ported"] == skipped
    out = capsys.readouterr().out.splitlines()
    assert not any(line.startswith("Not run by the port") for line in out)
    assert res["figures_skipped"] and not any(name.endswith(".png") for name in _files(tmp_path))
    assert [f"skipped {name}: matplotlib is not installed" for name in res["figures_skipped"]
            ] == [line for line in out if line.startswith("skipped ")]
    assert (f"Figures skipped (matplotlib is not installed): "
            f"{', '.join(res['figures_skipped'])}") in out
    if mode == "condition":
        assert sorted(set(res["figures_skipped"])) == CONDITION_PNGS


def test_bf16_run_trains_and_evaluates_in_bf16(tmp_path, monkeypatch):
    """``dtype="bfloat16"``, which raised until the port had the bf16 path:
    mode ``condition`` runs to its end with the fp32 run's files; the model
    computes in bf16 on fp32 parameters, the folded inference copy in bf16,
    and the weights file holds fp32 arrays, as JAX writes for a bf16 run."""
    seen = []
    load_model = experiment.load_model

    def spy(*args, **kw):
        seen.append(load_model(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(experiment, "load_model", spy)
    cfg = ExperimentConfig(mode="condition", output_root=str(tmp_path), dtype="bfloat16",
                           **TINY)
    res = experiment.run_experiment(cfg, device="cpu")
    assert np.isfinite(res["loss_log"] + res["val_loss_log"]).all()
    assert np.isfinite(res["means"]["reconstructed"])
    assert seen and all(m.dtype == torch.bfloat16 for m in seen)
    weights = load_variables(
        os.path.join(res["output_dir"], "weights", "train_state.msgpack"))
    leaves = [v for tree in weights.values() for v in _leaves(tree)]
    assert leaves and all(v.dtype == np.float32 for v in leaves)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (np.asarray(v),)


@pytest.mark.parametrize("mode,overrides,item", [
    ("condition", {"mesh_devices": 2}, "multi-device"),
])
def test_parts_not_ported_raise(tmp_path, mode, overrides, item):
    """``mesh_devices=2`` without a process group of two (the mesh path runs
    under one, ``tests/test_torch_port_parallel.py``) raises before the run
    writes anything; it never trains on one process instead."""
    cfg = ExperimentConfig(mode=mode, output_root=str(tmp_path), **{**TINY, **overrides})
    with pytest.raises(RuntimeError, match=item):
        experiment.run_experiment(cfg, device="cpu")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("mode,variant", [("initial", "deep"), ("main", "big")])
def test_variant_modes_run_end_to_end(tmp_path, capsys, monkeypatch, mode, variant):
    """Modes ``initial`` (the deep model) and ``main`` (the big one, standard
    q-scaling, maps sampled from pure noise) at n_feat 8, 16x16: the JAX
    runner's files but its PNGs (weights on its ``mod0`` cadence, the
    train checkpoint, the device lines), its ``results`` keys, finite
    losses and maps of the selected images' count, and its PNGs: every
    saved state of the unconditional chain, the [0, 1] display of the tanh
    variants' maps."""
    cfg = ExperimentConfig(mode=mode, output_root=str(tmp_path), **TINY)
    assert cfg.spec.model_variant == variant and cfg.n_cfeat == {"deep": 5, "big": 10}[variant]
    seen = []
    factory = getattr(experiment.ContextUnet, variant)

    def spy(*args, **kw):
        model = factory(*args, **kw)
        seen.append(model)
        return model

    monkeypatch.setattr(experiment.ContextUnet, variant, spy)
    res = experiment.run_experiment(cfg, device="cpu")
    model, = seen
    assert model.final_tanh and model.levels == 3
    assert hasattr(model, "out_conv_extra") == (variant == "big")
    out = res["output_dir"]
    weights = sorted({f"weights/{jax_weights_checkpoint_plan('mod0', ep, 2, 4)[1]}"
                      for ep in range(2) if jax_weights_checkpoint_plan('mod0', ep, 2, 4)[0]})
    pngs = [f for f in _files(out) if f.endswith(".png")]
    assert _files(out) == sorted(["output.log", "weights/train_state.msgpack", *weights,
                                  *pngs])
    assert sorted(pngs) == sorted(["distribution_comparison.png", "loss_evolution.png",
                                   "processed_images.png", "reconstructed_images.png"]
                                  + [f"intermediate_step_{i}.png" for i in range(8)])
    assert {"output_dir", "data_source", "loss_log", "val_loss_log", "total_training_time",
            "epoch_times", "n_train", "means"} <= set(res)
    assert res["not_ported"] == [] and len(res["loss_log"]) == 2
    assert np.isfinite(res["loss_log"]).all() and np.isfinite(res["means"]["reconstructed"])
    assert "Training and evaluation completed." in capsys.readouterr().out
