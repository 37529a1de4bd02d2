"""The cases of ``tests/test_torch_port_parallel.py``, run alike in one
process (``mesh=None``) and in each rank of a two-process gloo mesh
(``parallel.launch.spawn``): the same calls, the same generators, only the
mesh differs.  This module imports torch and the port only, so the spawned
ranks start without JAX."""

import contextlib
import os

import numpy as np
import torch

from camels_diffusion_model_tpu_torch import _msgpack
from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.diffusion.ddim import sample_ddim
from camels_diffusion_model_tpu_torch.diffusion.dpm_solver import sample_dpm2m
from camels_diffusion_model_tpu_torch.diffusion.sampler import (
    sample_ddpm,
    sample_ddpm_from_noise,
)
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.parallel.mesh import shard_batch
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training import trainer
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables

H, NC, T, B = 16, 3, 8, 8
N_MAPS = 5  # uneven over two ranks: 3 + 2 real rows, one pad row
# The tiny run of run_experiment (tests/test_torch_port_experiment.py's
# TINY); its batch of 8 splits 4 + 4.
TINY = dict(lrate=1e-3, n_epoch=2, timesteps=8, num_params=3, n_feat=8, height=16,
            data_size=32, synthetic_param_sets=4, batch_size=8, n_eval_images=2,
            eval_batch_size=8, nll_subset=8, elbo_subset=8)


def train_batch(real: int, seed: int):
    """``B`` rows, the last ``B - real`` wrapped from the first, the mask of
    the real rows, and the global batch's t and noise."""
    rs = np.random.RandomState(seed)
    idx = np.arange(B) % real
    x = rs.rand(real, H, H, 1).astype(np.float32)[idx]
    c = rs.rand(real, NC).astype(np.float32)[idx]
    mask = (np.arange(B) < real).astype(np.float32)
    t = rs.randint(1, T + 1, B)
    noise = rs.randn(B, H, H, 1).astype(np.float32)
    return x, c, mask, t, noise


def _rows(mesh, *arrays):
    return arrays if mesh is None else shard_batch(mesh, *arrays)


def _step_result(model, metrics) -> dict:
    return {
        "loss": metrics["loss"].clone(),
        "per_sample": metrics["per_sample_mse"].clone(),
        "t": metrics["t"].clone(),
        "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
        "stats": {n: b.clone() for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))},
        "params": {n: p.detach().clone() for n, p in model.named_parameters()},
    }


def _model(variables) -> ContextUnet:
    model = ContextUnet(n_feat=8, n_cfeat=NC, height=H)
    model.load_state_dict(from_jax_variables(variables))
    return model


def train_cases(mesh, variables) -> dict:
    """One train step on a full batch and one on a masked partial batch
    (t and noise injected), one step drawing its own, and the eval step,
    each from ``variables``."""
    out = {}
    for name, real, inject in (("full", B, True), ("masked", 6, True), ("drawn", 6, False)):
        model = _model(variables)
        state = trainer.create_train_state(model, 1e-3, 4, 2, seed=3)
        step = trainer.make_train_step(model, T, mesh=mesh)
        x, c, mask, t, noise = train_batch(real, seed=len(out))
        draws = dict(t=torch.tensor(t), noise=torch.tensor(noise)) if inject else {}
        out[name] = _step_result(model, step(state, *_rows(mesh, x, c, mask), **draws))
    eval_step = trainer.make_eval_step(_model(variables), T, mesh=mesh)
    x, c, mask, _, _ = train_batch(6, seed=9)
    em = eval_step(*_rows(mesh, x, c, mask),
                   generator=torch.Generator().manual_seed(5))
    out["eval"] = {k: em[k].clone() for k in ("loss", "per_sample_mse", "t")}
    return out


def sampler_cases(mesh, variables) -> dict:
    """Each sampler on ``N_MAPS`` maps, its draws from a seeded generator."""
    model = load_model(variables, "cpu")
    schedule = make_schedule(T)
    rs = np.random.RandomState(4)
    params = rs.rand(N_MAPS, NC).astype(np.float32)
    noisy = rs.randn(N_MAPS, H, H, 1).astype(np.float32)
    per_sample = np.array([1.5, 3.0, 2.0, 0.5, 4.0], np.float32)

    def gen():
        return torch.Generator().manual_seed(17)

    common = dict(n_sample=N_MAPS, size=H, params=params, device="cpu", mesh=mesh)
    out = {
        "ddpm_w2": sample_ddpm(model, schedule, gen(), guide_w=2.0, **common),
        "ddpm_w0_drawn_params": sample_ddpm(model, schedule, gen(), n_sample=N_MAPS,
                                            size=H, device="cpu", mesh=mesh),
        "ddpm_per_sample_w": sample_ddpm(model, schedule, gen(), guide_w=per_sample,
                                         **common),
        "ddim_posterior_w2_eta": sample_ddim(model, schedule, gen(), guide_w=2.0,
                                             n_steps=4, eta=0.5, **common),
        "ddim_beta_per_sample_w": sample_ddim(model, schedule, gen(), guide_w=per_sample,
                                              n_steps=4, sigma_mode="beta", **common),
        "dpm2m_w2": sample_dpm2m(model, schedule, gen(), guide_w=2.0, n_steps=4, **common),
        "dpm2m_per_sample_w": sample_dpm2m(model, schedule, gen(), guide_w=per_sample,
                                           n_steps=4, **common),
        "dpm2m_w0": sample_dpm2m(model, schedule, gen(), n_steps=4, **common),
    }
    recon = sample_ddpm_from_noise(model, schedule, gen(), noisy, params=params,
                                   guide_w=2.0, save_rate=4, device="cpu", mesh=mesh)
    out["from_noise_x"], out["from_noise_intermediate"] = recon.x, recon.intermediate
    return out


def all_cases(mesh, variables) -> dict:
    torch.set_num_threads(1)
    return {**train_cases(mesh, variables), **sampler_cases(mesh, variables)}


def _plant(fault: str) -> None:
    """Break this process's data-parallel step on purpose, for the test
    that shows the run-level check catching it: ``"averaged_gradients"``
    divides the summed gradients by the world size (what
    ``DistributedDataParallel`` would do), ``"per_rank_statistics"`` leaves
    each rank's BatchNorm with its own rows' statistics."""
    if fault == "averaged_gradients":
        gather = trainer._Noising.gather_metrics

        def averaged(self, per_sample, loss, extra=()):
            out = gather(self, per_sample, loss, extra)
            for e in extra:
                e.div_(self.mesh.world_size)
            return out

        trainer._Noising.gather_metrics = averaged
    elif fault == "per_rank_statistics":
        trainer.global_batch_stats = lambda model, mesh: contextlib.nullcontext()
    else:
        raise ValueError(fault)


def run_tiny_experiment(mesh, root: str, mode: str, fault=None) -> dict:
    """``run_experiment`` of ``mode`` at the tiny size with ``mesh_devices``
    of the mesh (None: no mesh), with the planted ``fault`` if one is named
    (:func:`_plant`); returns its loss logs, the files written and the train
    state."""
    torch.set_num_threads(1)
    if fault is not None:
        _plant(fault)
    cfg = ExperimentConfig(mode=mode, output_root=root,
                           mesh_devices=None if mesh is None else mesh.world_size, **TINY)
    res = experiment.run_experiment(cfg, device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, names in os.walk(root) for f in names)
    return {"loss_log": res["loss_log"], "val_loss_log": res["val_loss_log"],
            "recon_mean": res["means"]["reconstructed"], "files": files,
            "state": _msgpack.unpackb(open(os.path.join(
                res["output_dir"], "weights", "train_state.msgpack"), "rb").read())}
