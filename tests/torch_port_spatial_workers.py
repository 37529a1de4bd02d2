"""The cases of ``tests/test_torch_port_spatial.py``, run alike in one
process (``mesh=None``) and in each of four gloo ranks
(``parallel.launch.spawn``) on the 2-D meshes ``make_mesh_2d(2, 2)`` (the
narrow canonical model) and ``make_mesh_2d(1, 4)`` (the narrow deep model,
whose bottleneck level no longer splits over four rows and is gathered).
This module imports torch and the port only, so the spawned ranks start
without JAX."""

import numpy as np
import torch

from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.models.blocks import global_batch_stats
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.parallel.mesh import (
    gather_blocks,
    halo_rows,
    make_mesh_2d,
    shard_batch_spatial,
)
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training import trainer
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables

H, NC, T = 16, 3, 8
MESHES = {"canonical": (2, 2), "deep": (1, 4)}
N_FORWARD, N_TRAIN, N_MAPS = 4, 8, 3  # the maps split 2 + 1 real rows on 2x2


def inputs(seed: int, n: int):
    """``n`` maps, their normalised times and contexts, t and noise."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, H, H, 1).astype(np.float32)
    t_norm = rs.rand(n).astype(np.float32)
    c = rs.rand(n, NC).astype(np.float32)
    t = rs.randint(1, T + 1, n)
    noise = rs.randn(n, H, H, 1).astype(np.float32)
    return x, t_norm, c, t, noise


def unfolded(variables, variant: str) -> ContextUnet:
    model = getattr(ContextUnet, variant)(n_feat=8, n_cfeat=NC, height=H)
    model.load_state_dict(from_jax_variables(variables))
    return model


def _blocks(mesh, x, *rest):
    """This process's blocks (``shard_batch_spatial``), or all of it."""
    if mesh is None:
        return (torch.as_tensor(x),) + tuple(torch.as_tensor(a) for a in rest)
    return shard_batch_spatial(mesh, x, *rest)


def _whole(mesh, y, n):
    return y if mesh is None else gather_blocks(mesh, y, n)


def model_cases(mesh, variables, variant: str) -> dict:
    """The folded forward (kernel K2's sharded path: its plain version on
    the CPU), the training forward (plain GroupNorm under autograd,
    BatchNorm over the world), a train step with t and noise injected,
    the eval step, and the spatial DDPM chain at w=2, on ``mesh`` or in one
    process."""
    out = {}
    x, t_norm, c, _, _ = inputs(0, N_FORWARD)
    xs, ts, cs = _blocks(mesh, x, t_norm, c)
    space = None if mesh is None else mesh.space
    with torch.no_grad():
        for name, dtype in (("forward", torch.float32), ("forward_bf16", torch.bfloat16)):
            out[name] = _whole(mesh, load_model(variables, "cpu", dtype=dtype)(
                xs, ts, cs, space=space), N_FORWARD)
        model = unfolded(variables, variant)
        with global_batch_stats(model, None if mesh is None else mesh.world):
            out["forward_train"] = _whole(mesh, model(xs, ts, cs, train=True, space=space),
                                          N_FORWARD)

    x, _, c, t, noise = inputs(1, N_TRAIN)
    mask = (np.arange(N_TRAIN) < N_TRAIN - 2).astype(np.float32)
    model = unfolded(variables, variant)
    state = trainer.create_train_state(model, 1e-3, 4, 2, seed=3)
    step = trainer.make_train_step(model, T, mesh=mesh)
    m = step(state, *_blocks(mesh, x, c, mask), t=torch.tensor(t), noise=torch.tensor(noise))
    out["train"] = {
        "loss": m["loss"].clone(), "per_sample": m["per_sample_mse"].clone(),
        "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
        "stats": {n: b.clone() for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))},
    }
    em = trainer.make_eval_step(unfolded(variables, variant), T, mesh=mesh)(
        *_blocks(mesh, x, c, mask), t=torch.tensor(t), noise=torch.tensor(noise))
    out["eval"] = {k: em[k].clone() for k in ("loss", "per_sample_mse")}

    rs = np.random.RandomState(4)
    params = rs.rand(N_MAPS, NC).astype(np.float32)
    out["ddpm_w2"] = sample_ddpm(load_model(variables, "cpu"), make_schedule(T),
                                 torch.Generator().manual_seed(17), n_sample=N_MAPS, size=H,
                                 params=params, guide_w=2.0, device="cpu", mesh=mesh,
                                 spatial=mesh is not None)
    return out


def halo_case(mesh, seed: int = 5) -> dict:
    """A 3x3 conv on each height shard with its halo rows against the loss
    ``sum(conv * g)``: this shard's output and its input's gradient."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 3, H, 5).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32)
    g = rs.randn(2, 4, H, 5).astype(np.float32)
    rows = H // mesh.space.world_size
    sl = slice(mesh.space.rank * rows, (mesh.space.rank + 1) * rows)
    xs = torch.tensor(x[:, :, sl]).requires_grad_(True)
    top, bottom = halo_rows(mesh.space, xs, 2)
    y = torch.nn.functional.conv2d(torch.cat([top, xs, bottom], 2), torch.tensor(w),
                                   padding=(0, 1))
    (y * torch.tensor(g[:, :, sl])).sum().backward()
    return {"y": y.detach(), "grad": xs.grad.clone(), "rows": (sl.start, sl.stop)}


def spatial_cases(world_mesh, variables: dict) -> dict:
    """Every case on its 2-D mesh, in one of the four ranks."""
    torch.set_num_threads(1)
    meshes = {name: make_mesh_2d(*shape, device=world_mesh.device)
              for name, shape in MESHES.items()}
    out = {name: model_cases(meshes[name], variables[name], name) for name in MESHES}
    out["halo"] = halo_case(meshes["deep"])
    return out
