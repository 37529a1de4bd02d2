"""PyTorch port: ``utils/profiling.py`` (``torch.profiler`` in place of
``jax.profiler``) and ``CAMELS_PROFILE`` around the experiment runner's
second epoch, on the CPU (the card adds its kernels to the same trace)."""

import json
import os

import torch

from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.utils import profiling

TINY = dict(lrate=1e-3, n_epoch=2, timesteps=8, num_params=3, n_feat=8, height=16,
            data_size=32, synthetic_param_sets=4, batch_size=8, n_eval_images=2,
            eval_batch_size=8, nll_subset=8, elbo_subset=8)


def _events(log_dir):
    names = [n for n in os.listdir(log_dir) if n.endswith(".json")]
    assert len(names) == 1, names
    with open(os.path.join(log_dir, names[0])) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as path:
        with profiling.annotate("camels_test_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == str(tmp_path / "trace") and os.path.exists(path)
    names = {e.get("name") for e in _events(tmp_path / "trace")}
    assert "camels_test_range" in names and any("mm" in str(n) for n in names)


def test_maybe_trace_is_a_noop_when_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("CAMELS_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace():
        torch.ones(4) + 1
    assert not os.listdir(tmp_path)


def test_maybe_trace_writes_where_the_variable_says(tmp_path, monkeypatch):
    monkeypatch.setenv("CAMELS_TEST_PROFILE", str(tmp_path / "p"))
    with profiling.maybe_trace("CAMELS_TEST_PROFILE"):
        torch.ones(4) + 1
    assert _events(tmp_path / "p")


def test_run_experiment_traces_its_second_epoch(tmp_path, monkeypatch):
    """``CAMELS_PROFILE=<dir>``: one trace, of the second epoch's train
    steps (the experiment runner's ``experiment.py:325-334``)."""
    monkeypatch.setenv("CAMELS_PROFILE", str(tmp_path / "profile"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = ExperimentConfig(mode="nov26", output_root=str(tmp_path / "out"), **TINY)
        res = experiment.run_experiment(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(res["loss_log"]) == 2
    names = {str(e.get("name")) for e in _events(tmp_path / "profile")}
    assert any("convolution" in n for n in names)
