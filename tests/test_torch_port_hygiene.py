"""PyTorch port: it imports no JAX, flax, msgpack, matplotlib or JAX-package
module; its entry points run on CUDA unless told otherwise; chip_smoke.py
refuses to run without a card or without the rest of the repository."""

import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from camels_diffusion_model_tpu_torch import resolve_device
from camels_diffusion_model_tpu_torch.cli import experiment as experiment_cli
from camels_diffusion_model_tpu_torch.cli import sample as sample_cli
from camels_diffusion_model_tpu_torch.cli import serve as serve_cli
from camels_diffusion_model_tpu_torch.ops import _build
from camels_diffusion_model_tpu_torch.diffusion.ddim import sample_ddim
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "camels_diffusion_model_tpu_torch",
    "camels_diffusion_model_tpu_torch._msgpack",
    "camels_diffusion_model_tpu_torch.training.checkpoints",
    "camels_diffusion_model_tpu_torch.utils.weights",
    "camels_diffusion_model_tpu_torch.models.fold_bn",
    "camels_diffusion_model_tpu_torch.models.blocks",
    "camels_diffusion_model_tpu_torch.models.context_unet",
    "camels_diffusion_model_tpu_torch.diffusion.schedule",
    "camels_diffusion_model_tpu_torch.diffusion.sampler",
    "camels_diffusion_model_tpu_torch.diffusion.ddim",
    "camels_diffusion_model_tpu_torch.diffusion.calibration",
    "camels_diffusion_model_tpu_torch.diffusion.likelihood",
    "camels_diffusion_model_tpu_torch.ops._build",
    "camels_diffusion_model_tpu_torch.ops.sampler_step",
    "camels_diffusion_model_tpu_torch.ops.groupnorm",
    "camels_diffusion_model_tpu_torch.ops.film",
    "camels_diffusion_model_tpu_torch.ops.spectrum",
    "camels_diffusion_model_tpu_torch.ops.stats",
    "camels_diffusion_model_tpu_torch.serving",
    "camels_diffusion_model_tpu_torch.cli.serve",
    "camels_diffusion_model_tpu_torch.cli.experiment",
    "camels_diffusion_model_tpu_torch.data.pipeline",
    "camels_diffusion_model_tpu_torch.data.synthetic",
    "camels_diffusion_model_tpu_torch.data.prefetch",
    "camels_diffusion_model_tpu_torch.ops.resize",
    "camels_diffusion_model_tpu_torch.training.trainer",
    "camels_diffusion_model_tpu_torch.config",
    "camels_diffusion_model_tpu_torch.utils.run_logging",
    "camels_diffusion_model_tpu_torch.data.native_prep",
    "camels_diffusion_model_tpu_torch.data.map_dataset",
    "camels_diffusion_model_tpu_torch.utils.threefry",
    "camels_diffusion_model_tpu_torch.utils.torch_interop",
    "camels_diffusion_model_tpu_torch.utils.image_norm",
    "camels_diffusion_model_tpu_torch.utils.viz",
    "camels_diffusion_model_tpu_torch.cli.sample",
    "chip_smoke",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "matplotlib", "camels_diffusion_model_tpu")


def test_port_and_chip_smoke_import_no_jax_flax_msgpack():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_without_device_raises_instead_of_running_on_cpu(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.serve(2, 1, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--guide-w", "2", "--n", "1", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_experiment_without_device_raises_before_writing(no_cuda, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        experiment_cli.main(["condition", "1e-4", "2", "8", "6"])
    assert not any(tmp_path.iterdir())


def test_sample_cli_without_device_raises_before_writing(no_cuda, tmp_path, monkeypatch):
    """``python -m camels_diffusion_model_tpu_torch.cli.sample`` runs on
    the card unless ``--device cpu``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CAMELS_ALLOW_FRESH_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_cli.main(["none.msgpack", "4", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_cli.generate_comparison_plot("none.msgpack", "a.npy", "b.npy",
                                            str(tmp_path / "out"), {})
    assert not any(tmp_path.iterdir())


def test_kernels_refuse_tensors_autograd_would_record():
    """The guard each wrapper runs on CUDA tensors before a launch: a
    kernel's output, written through a pointer, would have no grad_fn."""
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_autograd("fused_film", torch.ones(3), w, None)
    with torch.no_grad():
        _build.refuse_autograd("fused_film", torch.ones(3), w, None)
    with torch.inference_mode():
        _build.refuse_autograd("fused_film", w)
    _build.refuse_autograd("fused_film", torch.ones(3), w.detach(), None)


@pytest.mark.parametrize("sampler", [sample_ddpm, sample_ddim])
def test_samplers_without_device_raise(no_cuda, sampler):
    model = ContextUnet(n_feat=8, n_cfeat=3, height=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sampler(model, make_schedule(4), torch.Generator(), n_sample=1, size=16)


def test_sampler_refuses_a_model_on_another_device():
    model = ContextUnet(n_feat=8, n_cfeat=3, height=16).to(device="meta")
    with pytest.raises(ValueError, match="not on cpu"):
        sample_ddpm(model, make_schedule(4), torch.Generator(), n_sample=1,
                    size=16, device="cpu")


def test_chip_smoke_exits_nonzero_without_cuda(no_cuda, capsys):
    assert chip_smoke.main() == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "CUDA is not available" in out.err


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_kernel_table_names_existing_sources():
    for name, (source, replaces) in chip_smoke.SOURCES.items():
        assert os.path.exists(os.path.join(REPO, source)), source
        path, line = replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith("def fused_")
        assert name in chip_smoke.WRAPPERS and name in chip_smoke.TOL


def test_golden_fixture_is_small_and_fp32():
    path = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
    assert os.path.getsize(path) < 200_000
    d = np.load(path)
    assert d["x"].shape == d["eps"].shape == d["eps_uncond"].shape == (2, 64, 64, 1)
    assert all(d[k].dtype == np.float32 for k in ("x", "t", "c", "eps", "eps_uncond"))


def test_profile_script_names_the_port_kernels():
    """``scripts/profile_torch_serving.py`` marks the port's kernels by a
    substring of their names: each must name a ``__global__`` kernel of
    ``csrc/``, and every such kernel must be marked."""
    spec = importlib.util.spec_from_file_location(
        "profile_torch_serving", os.path.join(REPO, "scripts", "profile_torch_serving.py"))
    profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile)
    csrc = os.path.join(REPO, "camels_diffusion_model_tpu_torch", "csrc")
    kernels = set()
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            kernels |= set(re.findall(r"__global__ void (\w+)", f.read()))
    assert kernels and all(any(k in name for name in kernels) for k in profile.OURS)
    assert all(any(k in name for k in profile.OURS) for name in kernels)


def test_bf16_golden_is_what_its_script_writes():
    """``tests/data/torch_port_golden_bf16.npz`` holds the arrays
    ``scripts/make_torch_port_golden.py`` names (``BF16_KEYS``) and the
    checkpoint's md5, each of the fp32 golden's shape, as float32, under
    200 KB; its bf16 arrays are bf16 values."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden", os.path.join(REPO, "scripts", "make_torch_port_golden.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert os.path.getsize(script.OUT_BF16) < 200_000
    d, fp32 = np.load(script.OUT_BF16), np.load(script.OUT)
    assert set(d.files) == {*script.BF16_KEYS, "checkpoint_md5"}
    assert str(d["checkpoint_md5"]) == str(fp32["checkpoint_md5"])
    for key in script.BF16_KEYS:
        assert d[key].shape == fp32["eps"].shape and d[key].dtype == np.float32
    for key in ("eps_bf16", "eps_uncond_bf16"):
        assert np.array_equal(torch.tensor(d[key]).bfloat16().float().numpy(), d[key])


def test_no_module_of_the_port_calls_autocast():
    """The bf16 path casts at the JAX package's cast points; torch.autocast
    would keep its own op list in fp32 and pick its own output types."""
    root = os.path.join(REPO, "camels_diffusion_model_tpu_torch")
    sources = [os.path.join(d, f) for d, _, names in os.walk(root) for f in names
               if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    for path in sources:
        with open(path) as f:
            assert "autocast" not in f.read(), path
