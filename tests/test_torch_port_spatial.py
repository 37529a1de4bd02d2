"""PyTorch port: the spatial (data x space) mesh on the CPU, against one
process, against JAX's spatially sharded programs
(``tests/test_spatial_sharding.py``) and against the whole map.

Four ranks run in spawned processes joined by gloo through a ``FileStore``
under ``tmp_path`` (``parallel.launch.spawn``), once for the module, each
running the cases of ``tests/torch_port_spatial_workers.py`` on
``make_mesh_2d(2, 2)`` (the narrow canonical model: n_feat 8, 16x16,
n_cfeat 3) and ``make_mesh_2d(1, 4)`` (the narrow deep model at height 16,
JAX's own case: its bottleneck level, 2 rows, no longer splits over 4 and
is gathered); this process runs the same cases without a mesh.  Weights
from the JAX ``model.init``.

Tolerances.  A forward on height shards sums its convolutions' windows
and its norms' statistics in other orders than one process does: within
``FWD_TOL`` = 1e-5 abs (JAX's own, ``test_spatial_sharding.py:66``; seen:
1.8e-7 folded, 1.7e-6 and 4.7e-6 in the training forward).  A train step:
each process's partial gradient is rounded before the world's sum, as in
the data-parallel step, and its convolutions and GroupNorm statistics see
height shards; all gradients together were 1.14e-6 (canonical) and
1.79e-6 (deep) from one process, beyond the data-parallel step's
``GRAD_REL`` 1e-6, so they are held at ``SPATIAL_GRAD_REL`` = 4e-6 (2.2x the
worst seen); each leaf at ``LEAF_REL`` 1e-5 unless its gradient is zero up
to rounding (``LEAF_ABS`` 1e-6 abs), as in ``test_torch_port_parallel.py``.
The spatial chain at T 8 within ``MAP_TOL`` 5e-6 of one process's.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from camels_diffusion_model_tpu.parallel import replicate as jax_replicate
from camels_diffusion_model_tpu.parallel import shard_batch_spatial as jax_shard_batch_spatial
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm
from camels_diffusion_model_tpu_torch.diffusion.schedule import make_schedule
from camels_diffusion_model_tpu_torch.models.context_unet import space_levels
from camels_diffusion_model_tpu_torch.ops.groupnorm import (
    groupnorm_act_plain,
    groupnorm_apply,
    groupnorm_stats,
    merge_stats,
)
from camels_diffusion_model_tpu_torch.ops.sampler_step import fused_head_step
from camels_diffusion_model_tpu_torch.parallel import mesh as port_mesh
from camels_diffusion_model_tpu_torch.parallel.launch import spawn
from camels_diffusion_model_tpu_torch.serving import load_model

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_spatial_workers as workers  # noqa: E402

H, NC, T = workers.H, workers.NC, workers.T
FWD_TOL = 1e-5
SPATIAL_GRAD_REL = 4e-6
LEAF_REL = 1e-5
LEAF_ABS = 1e-6
ROUNDING = 1e-6  # a leaf's gradient norm below this share of all gradients'
MAP_TOL = 5e-6
TIMEOUT = 300  # seconds the four ranks may take
VARIANTS = list(workers.MESHES)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    out = {}
    for variant in VARIANTS:
        model = getattr(JaxContextUnet, variant)(n_feat=8, n_cfeat=NC, height=H)
        out[variant] = jax.device_get(jax.jit(model.init)(
            jax.random.PRNGKey(0), np.zeros((1, H, H, 1), np.float32),
            np.array([0.5], np.float32)))
    return out


@pytest.fixture(scope="module")
def cases(variables, tmp_path_factory):
    """``(one process, [rank 0 .. rank 3])``."""
    ranks = spawn(workers.spatial_cases, 4, (variables,),
                  store_dir=str(tmp_path_factory.mktemp("spatial_store")), device="cpu",
                  timeout=TIMEOUT)
    one = {v: workers.model_cases(None, variables[v], v) for v in VARIANTS}
    return one, ranks


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).norm() / b.norm()).item()


def _mesh2d(n_data, n_space, rank):
    """A 2-D mesh's layout for ``rank`` without a process group."""
    d, s = divmod(rank, n_space)
    dev = torch.device("cpu")
    return port_mesh.Mesh2D(n_data, n_space, rank, dev, port_mesh.Mesh(n_data * n_space, rank, dev),
                            port_mesh.Mesh(n_data, d, dev), port_mesh.Mesh(n_space, s, dev))


# ---- the mesh and its layout ------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 4), (2, 4)])
def test_blocks_are_jax_spatial_shardings(shape):
    """Rank r holds the (batch, height) block device r holds under JAX's
    ``spatial_sharding`` of ``make_mesh_2d`` (``devices.reshape(n_data,
    n_space)``, row-major), and the contexts of its batch rows."""
    x = np.random.RandomState(0).randn(8, 16, 16, 1).astype(np.float32)
    c = np.random.RandomState(1).rand(8, 3).astype(np.float32)
    xs, cs = jax_shard_batch_spatial(jax_make_mesh_2d(*shape), x, c)
    by_device = [{s.device.id: np.asarray(s.data) for s in a.addressable_shards}
                 for a in (xs, cs)]
    devices = [d.id for d in jax.devices()[:shape[0] * shape[1]]]
    for rank in range(shape[0] * shape[1]):
        got = port_mesh.shard_batch_spatial(_mesh2d(*shape, rank), x, c)
        for g, want in zip(got, by_device):
            np.testing.assert_array_equal(g.numpy(), want[devices[rank]])


def test_mesh_2d_refuses_a_mesh_the_group_does_not_hold(monkeypatch):
    for v in ("CAMELS_DISTRIBUTED", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="requested 2x1 mesh but only 1"):
        port_mesh.make_mesh_2d(2, 1, device="cpu")
    mesh = port_mesh.make_mesh_2d(1, 1, device="cpu")
    assert (mesh.world_size, mesh.collective, mesh.space.collective) == (1, False, False)
    with pytest.raises(ValueError, match="2-D mesh"):
        port_mesh.spatial_sharding(port_mesh.make_mesh(1, device="cpu"))


def test_spatial_on_a_one_dimensional_mesh_raises(variables, monkeypatch):
    """JAX's ``ValueError`` (``sampler.py:436-437``)."""
    for v in ("CAMELS_DISTRIBUTED", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="spatial=True requires a 2-D mesh"):
        sample_ddpm(load_model(variables["canonical"], "cpu"), make_schedule(T),
                    torch.Generator(), n_sample=2, size=H, device="cpu",
                    mesh=port_mesh.make_mesh(1, device="cpu"), spatial=True)


@pytest.mark.parametrize("height,levels,n_space,want", [
    (64, 2, 2, (True, True, True)),  # the canonical model on two shards
    (16, 3, 4, (True, True, True, False)),  # JAX's deep case: the bottleneck gathered
    (16, 2, 16, (True, False, False)),
    (16, 2, 1, (True, True, True)),
])
def test_space_levels(height, levels, n_space, want):
    assert space_levels(height, levels, n_space) == want


def test_space_levels_refuse_a_height_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        space_levels(10, 2, 4)


# ---- the halo exchange and the kernels' plain sharded paths -----------------

def test_halo_exchange_gradient_equals_autograd_through_the_whole_map(cases):
    """A 3x3 conv on each of four height shards with its halo rows: its
    rows of the whole map's output, and its input's gradient under
    ``sum(conv * g)`` that of autograd through the whole map."""
    _, ranks = cases
    rs = np.random.RandomState(5)
    x = torch.tensor(rs.randn(2, 3, H, 5).astype(np.float32), requires_grad=True)
    w = torch.tensor(rs.randn(4, 3, 3, 3).astype(np.float32))
    g = torch.tensor(rs.randn(2, 4, H, 5).astype(np.float32))
    y = F.conv2d(x, w, padding=1)
    (y * g).sum().backward()
    for r in ranks:
        lo, hi = r["halo"]["rows"]
        np.testing.assert_allclose(r["halo"]["y"].numpy(), y.detach()[:, :, lo:hi].numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["halo"]["grad"].numpy(), x.grad[:, :, lo:hi].numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,film", [("relu", True), ("gelu", False), ("leaky_relu", True)])
@pytest.mark.parametrize("n_space", [2, 4])
def test_sharded_groupnorm_equals_the_whole_map(dtype, act, film, n_space):
    """K2's sharded mode on the CPU (its plain versions): each shard's
    statistics, merged by Chan's formula, normalise the shard as the
    whole map's GroupNorm does (fp32 within 2e-6; bf16 within one ulp of
    the output), and the merged mean and variance are the whole map's."""
    rs = np.random.RandomState(n_space)
    x = torch.tensor(rs.randn(3, 16, 8, 32).astype(np.float32) * 2 + 0.5).to(dtype)
    gamma, beta = (torch.tensor(rs.randn(32).astype(np.float32)) for _ in range(2))
    rows = (tuple(torch.tensor(rs.randn(n, 32).astype(np.float32)).to(dtype) for n in (3, 1))
            if film else None)
    want = groupnorm_act_plain(x, gamma, beta, 8, 1e-5, act, rows)
    shards = x.chunk(n_space, dim=1)
    parts = torch.stack([groupnorm_stats(s, 8) for s in shards])
    mean, var = merge_stats(parts)
    xg = x.float().reshape(3, -1, 8, 4)
    np.testing.assert_allclose(mean.numpy(), xg.mean(dim=(1, 3)).numpy(), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), xg.var(dim=(1, 3), unbiased=False).numpy(),
                               rtol=1e-5)
    got = torch.cat([groupnorm_apply(s, parts, gamma, beta, 8, 1e-5, act, rows)
                     for s in shards], dim=1)
    top = max(1.0, want.float().abs().max().item())
    tol = 2e-6 * top if dtype == torch.float32 else 2.0 ** -7 * top
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("guide_w", [None, 2.0])
@pytest.mark.parametrize("n_space", [2, 4])
def test_head_step_halo_rows_equal_the_whole_map(guide_w, n_space):
    """K1's halo mode on the CPU (its plain version): each shard's step,
    with the rows above and below it (zeros at the image's edges), is its
    rows of the whole map's step."""
    rs = np.random.RandomState(7)
    b = 2
    h = torch.tensor(rs.randn(2 * b if guide_w else b, H, H, 8).astype(np.float32))
    weight = torch.tensor(rs.randn(1, 8, 3, 3).astype(np.float32) * 0.2)
    bias = torch.tensor(rs.randn(1).astype(np.float32))
    x, z = (torch.tensor(rs.randn(b, H, H, 1).astype(np.float32)) for _ in range(2))
    want = fused_head_step(h, weight, bias, x, z, 0.3, 1.1, 0.2, guide_w)
    rows = H // n_space
    for s in range(n_space):
        sl = slice(s * rows, (s + 1) * rows)
        halo = (h[:, sl.start - 1] if s else None, h[:, sl.stop] if s < n_space - 1 else None)
        got = fused_head_step(h[:, sl], weight, bias, x[:, sl], z[:, sl], 0.3, 1.1, 0.2,
                              guide_w, halo=halo)
        np.testing.assert_allclose(got.numpy(), want[:, sl].numpy(), atol=1e-6, rtol=0)


# ---- the model, the steps and the chain on the 2-D meshes -------------------

@pytest.mark.parametrize("case", ["forward", "forward_train"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_forward_equals_one_process(cases, variant, case):
    """The folded forward (K2's sharded path) and the training forward
    (plain sharded GroupNorm, BatchNorm over the world), gathered: every
    rank the same maps, within ``FWD_TOL`` of one process."""
    one, ranks = cases
    want = one[variant][case].numpy()
    for r in ranks:
        np.testing.assert_allclose(r[variant][case].numpy(), want, atol=FWD_TOL, rtol=0)
        assert torch.equal(r[variant][case], ranks[0][variant][case])


@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_bf16_forward_within_the_bf16_yardstick(cases, variant):
    """The bf16 model on height shards (its halo rows and gathers summed in
    fp32 through gloo): within twice one process's own bf16-vs-fp32
    distance of one process's bf16 forward, as ``test_torch_port_bf16.py``
    holds the bf16 path."""
    one, ranks = cases
    want = one[variant]["forward_bf16"].float()
    yard = (want - one[variant]["forward"].float()).abs().max().item()
    assert yard > 0
    for r in ranks:
        got = r[variant]["forward_bf16"]
        assert got.dtype == torch.bfloat16
        assert (got.float() - want).abs().max().item() <= 2 * yard


@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_forward_equals_jax_spatial_forward(cases, variables, variant):
    """The port's sharded forward against the JAX package's on the same 2-D
    mesh shape, within ``FWD_TOL`` (``test_spatial_sharding.py:66``)."""
    _, ranks = cases
    model = getattr(JaxContextUnet, variant)(n_feat=8, n_cfeat=NC, height=H)
    x, t_norm, c, _, _ = workers.inputs(0, workers.N_FORWARD)
    mesh = jax_make_mesh_2d(*workers.MESHES[variant])
    xs, cs = jax_shard_batch_spatial(mesh, x, c)
    want = np.asarray(jax.jit(lambda v, x, t, c: model.apply(v, x, t, c))(
        jax_replicate(mesh, variables[variant]), xs, t_norm, cs))
    for r in ranks:
        np.testing.assert_allclose(r[variant]["forward"].numpy(), want, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_train_step_equals_one_process(cases, variant):
    """A masked batch of 8 with t and noise injected: the loss and the
    per-sample MSE (rel 1e-6), the gradients (module docstring), the same
    on every rank, and the running statistics 1e-6 abs.  (Adam's first
    step, ``lr * g / (|g| + eps)``, turns an element's gradient near zero
    into a step of either sign, so the updated parameters are held through
    their gradients, as in ``test_torch_port_parallel.py``.)"""
    one, ranks = cases
    want = one[variant]["train"]
    total = torch.cat([g.double().flatten() for g in want["grads"].values()])
    for r in ranks:
        got = r[variant]["train"]
        assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= 1e-6
        np.testing.assert_allclose(got["per_sample"].numpy(), want["per_sample"].numpy(),
                                   rtol=1e-6, atol=1e-7)
        assert _rel(torch.cat([got["grads"][n].double().flatten() for n in want["grads"]]),
                    total) <= SPATIAL_GRAD_REL
        for name, g in want["grads"].items():
            if g.double().norm() <= ROUNDING * total.norm():
                assert (got["grads"][name] - g).abs().max() <= LEAF_ABS, name
            else:
                assert _rel(got["grads"][name], g) <= LEAF_REL, name
            assert torch.equal(got["grads"][name], ranks[0][variant]["train"]["grads"][name])
        for name, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][name].numpy(), v.numpy(), atol=1e-6,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_eval_step_equals_one_process(cases, variant):
    one, ranks = cases
    want = one[variant]["eval"]
    for r in ranks:
        assert abs(float(r[variant]["eval"]["loss"]) / float(want["loss"]) - 1) <= 1e-6
        np.testing.assert_allclose(r[variant]["eval"]["per_sample_mse"].numpy(),
                                   want["per_sample_mse"].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_ddpm_equals_one_process(cases, variant):
    """``sample_ddpm(spatial=True)`` at w=2, T 8, 3 maps (2 + 1 real rows
    and a pad row on the 2x2 mesh): every rank gets the global maps, one
    process's under the same generator, within ``MAP_TOL``."""
    one, ranks = cases
    want = one[variant]["ddpm_w2"].numpy()
    assert want.shape == (workers.N_MAPS, H, H, 1)
    for r in ranks:
        np.testing.assert_allclose(r[variant]["ddpm_w2"].numpy(), want, atol=MAP_TOL, rtol=0)
        assert torch.equal(r[variant]["ddpm_w2"], ranks[0][variant]["ddpm_w2"])
