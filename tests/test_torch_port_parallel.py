"""PyTorch port: data parallelism over a ``torch.distributed`` mesh on the
CPU, against one process and against the JAX package's mesh.

Two ranks run in spawned processes joined by gloo through a ``FileStore``
under ``tmp_path`` (``parallel.launch.spawn``, with a join timeout of its
own), each running the cases of ``tests/torch_port_mesh_workers.py`` with
the mesh; this process runs the same cases without it.  The narrow model
(n_feat 8, 16x16, n_cfeat 3, T 8) from the JAX ``model.init``.

Tolerances.  A two-rank fp32 train step sums each weight gradient in
another order than one process does (each rank's partial gradient is
rounded to fp32 before the all-reduce); BatchNorm's statistics are float64
sums in both (``models/blocks.py``), so they agree to fp32 rounding.  On
these batches the two-rank step is 8.8e-7 to 9.3e-7 (relative L2 over all
gradients) from the one-process step, itself 1.2e-6 from a float64 step:
the gradients are held at ``GRAD_REL`` = 1e-6 together, each leaf at
``LEAF_REL`` = 1e-5 (a leaf's share of the rounding is larger than the
whole's; the worst seen 2.6e-6) unless its gradient is zero up to rounding
(the conv biases ahead of a norm: ``LEAF_ABS`` 1e-6 abs).  The samplers'
maps move by an ulp or two of conv sums whose batch differs (3 rows, not
5): ``MAP_TOL`` 5e-6 abs.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from camels_diffusion_model_tpu.models import blocks as jax_blocks
from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.parallel import make_mesh as jax_make_mesh
from camels_diffusion_model_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from camels_diffusion_model_tpu.parallel import shard_batch as jax_shard_batch
from camels_diffusion_model_tpu.training.trainer import _noise_coeff
from camels_diffusion_model_tpu.training.trainer import masked_mean as jax_masked_mean
from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.parallel import mesh as port_mesh
from camels_diffusion_model_tpu_torch.parallel.launch import spawn
from camels_diffusion_model_tpu_torch.utils.weights import to_jax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_mesh_workers as workers  # noqa: E402

H, NC, T, B = workers.H, workers.NC, workers.T, workers.B
GRAD_REL = 1e-6
LEAF_REL = 1e-5
LEAF_ABS = 1e-6
ROUNDING = 1e-6  # a leaf's gradient norm below this share of all gradients'
MAP_TOL = 5e-6
TIMEOUT = 300  # seconds a spawned pair may take


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    model = JaxContextUnet(in_channels=1, n_feat=8, n_cfeat=NC, height=H, levels=2)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), np.zeros((1, H, H, 1), np.float32),
        np.array([0.5], np.float32)))


@pytest.fixture(scope="module")
def cases(variables, tmp_path_factory):
    """``(one process, [rank 0, rank 1])``: every case of the workers."""
    store = str(tmp_path_factory.mktemp("mesh_cases"))
    ranks = spawn(workers.all_cases, 2, (variables,), store_dir=store, device="cpu",
                  timeout=TIMEOUT)
    return workers.all_cases(None, variables), ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``run_experiment`` ("nov26", tiny): ``(mesh-less, [rank 0, rank 1])``."""
    root = tmp_path_factory.mktemp("mesh_runs")
    ranks = spawn(workers.run_tiny_experiment, 2, (str(root / "mesh"), "nov26"),
                  store_dir=str(root / "store"), device="cpu", timeout=TIMEOUT)
    return workers.run_tiny_experiment(None, str(root / "single"), "nov26"), ranks


# ---- init_distributed, make_mesh, the row layout ---------------------------

@pytest.fixture
def unconfigured(monkeypatch):
    for v in ("CAMELS_DISTRIBUTED", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)


def test_init_distributed_is_a_noop_when_unconfigured(unconfigured):
    assert port_mesh.init_distributed() == 1
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("how", ["env", "kwargs"])
def test_init_distributed_raises_when_configured_and_failing(unconfigured, monkeypatch,
                                                              tmp_path, how):
    """A configured launch that cannot join its group raises; it never
    trains on one process instead (``tests/test_parallel.py:228-240``)."""
    import datetime

    if how == "env":  # CAMELS_DISTRIBUTED without torchrun's MASTER_ADDR, RANK, ...
        monkeypatch.setenv("CAMELS_DISTRIBUTED", "1")
        kwargs = {}
    else:  # a group of two whose second rank never comes
        kwargs = dict(backend="gloo", rank=0, world_size=2,
                      store=torch.distributed.FileStore(str(tmp_path / "store"), 2),
                      timeout=datetime.timedelta(seconds=1))
    with pytest.raises((ValueError, RuntimeError)):
        port_mesh.init_distributed(**kwargs)
    assert not torch.distributed.is_initialized()


def test_make_mesh_refuses_more_devices_than_the_group(unconfigured):
    with pytest.raises(ValueError, match="requested 2 devices but only 1 present"):
        port_mesh.make_mesh(2, device="cpu")
    for n in (None, 1):
        mesh = port_mesh.make_mesh(n, device="cpu")
        assert (mesh.world_size, mesh.rank, mesh.group, mesh.collective) == (1, 0, None, False)


@pytest.mark.parametrize("shape,multiple", [((10, 3), 8), ((16, 2), 8), ((5, 4, 4, 1), 2),
                                            ((1, 3), 4)])
def test_pad_to_multiple_equals_jax(shape, multiple):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, n = port_mesh.pad_to_multiple(x, multiple)
    want, n_jax = jax_pad_to_multiple(x, multiple)
    assert n == n_jax and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_rows_are_named_shardings(world):
    """Rank r holds the rows device r holds under ``NamedSharding(P("data"))``."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    placed = jax_shard_batch(jax_make_mesh(world), x)
    by_device = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    devices = [d.id for d in jax.devices()[:world]]
    for rank in range(world):
        mesh = port_mesh.Mesh(world, rank, torch.device("cpu"))
        np.testing.assert_array_equal(port_mesh.shard_batch(mesh, x).numpy(),
                                      by_device[devices[rank]])
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.shard_batch(port_mesh.Mesh(world, 0, torch.device("cpu")), x[:7])


def test_local_rows_pad_and_a_mesh_of_one_runs_no_collective():
    x = torch.arange(5.0)
    two = [port_mesh.Mesh(2, r, torch.device("cpu")) for r in range(2)]
    assert port_mesh.local_rows(two[0], x).tolist() == [0.0, 1.0, 2.0]
    assert port_mesh.local_rows(two[1], x, fill=1.0).tolist() == [3.0, 4.0, 1.0]
    one = port_mesh.Mesh(1, 0, torch.device("cpu"))
    assert port_mesh.local_rows(one, x) is not None
    assert port_mesh.gather_batch(one, x, 4).tolist() == [0.0, 1.0, 2.0, 3.0]
    assert port_mesh.all_reduce_sum(one, x) is x  # no process group exists here


# ---- the train and eval steps ----------------------------------------------

def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).norm() / b.norm()).item()


STEPS = {"full": (B, 0), "masked": (6, 1), "drawn": (6, 2)}  # real rows, seed


def _hold_gradients(got: dict, want: dict):
    """All gradients together within ``GRAD_REL``; each leaf within
    ``LEAF_REL``, or at rounding level within ``LEAF_ABS``."""
    total = torch.cat([g.double().flatten() for g in want.values()])
    assert _rel(torch.cat([got[n].double().flatten() for n in want]), total) <= GRAD_REL
    for name, g in want.items():
        if g.double().norm() <= ROUNDING * total.norm():
            assert (got[name] - g).abs().max() <= LEAF_ABS, name
        else:
            assert _rel(got[name], g) <= LEAF_REL, name


@pytest.mark.parametrize("case", STEPS)
def test_two_rank_step_loss_and_draws_equal_one_process(cases, case):
    """The global loss (rel 1e-6), per-sample MSE and t of the global batch;
    the masked rows' MSE zero.  ``drawn``: t and the noise from the step's
    generator, the global batch's on every rank."""
    one, ranks = cases
    want = one[case]
    for r in ranks:
        assert abs(float(r[case]["loss"]) / float(want["loss"]) - 1) <= 1e-6
        np.testing.assert_array_equal(r[case]["t"].numpy(), want["t"].numpy())
        np.testing.assert_allclose(r[case]["per_sample"].numpy(),
                                   want["per_sample"].numpy(), rtol=1e-6, atol=1e-7)
    if case != "full":
        assert np.all(ranks[0][case]["per_sample"].numpy()[6:] == 0.0)


@pytest.mark.parametrize("case", STEPS)
def test_two_rank_step_gradients_equal_one_process(cases, case):
    one, ranks = cases
    _hold_gradients(ranks[0][case]["grads"], one[case]["grads"])
    for name, g in ranks[0][case]["grads"].items():  # summed: one value everywhere
        assert torch.equal(ranks[1][case]["grads"][name], g), name


@pytest.mark.parametrize("case", STEPS)
def test_two_rank_batchnorm_running_stats_equal_one_process(cases, case):
    """The global batch's statistics, staged alike on both ranks: 1e-6 abs."""
    one, ranks = cases
    for name, v in one[case]["stats"].items():
        np.testing.assert_allclose(ranks[0][case]["stats"][name].numpy(), v.numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
        assert torch.equal(ranks[1][case]["stats"][name], ranks[0][case]["stats"][name])


def test_two_rank_eval_step_equals_one_process(cases):
    one, ranks = cases
    for r in ranks:
        assert abs(float(r["eval"]["loss"]) / float(one["eval"]["loss"]) - 1) <= 1e-6
        np.testing.assert_array_equal(r["eval"]["t"].numpy(), one["eval"]["t"].numpy())
        np.testing.assert_allclose(r["eval"]["per_sample_mse"].numpy(),
                                   one["eval"]["per_sample_mse"].numpy(), rtol=1e-6,
                                   atol=1e-7)


def _jax_mesh_step(variables, x, c, mask, t, noise):
    """Loss, gradients and batch statistics of the JAX package's step on
    its 2-device mesh (the conftest's virtual CPU devices), in float64 as
    ``tests/test_torch_port_training.py`` runs it: x64 on, the norms'
    hard-coded float32 read as float64."""

    class Float64Numpy:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    alpha_bar = jax_make_schedule(T).alpha_bar
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_blocks, "jnp", Float64Numpy())
        model = JaxContextUnet(in_channels=1, n_feat=8, n_cfeat=NC, height=H, levels=2,
                               dtype=jnp.float64)

        def loss_fn(params, batch_stats, x, c, t, noise, mask):
            ab = alpha_bar[t][:, None, None, None]
            x_pert = jnp.sqrt(ab) * x + _noise_coeff(ab, "reference") * noise
            out, mutated = model.apply({"params": params, "batch_stats": batch_stats},
                                       x_pert, (t / T).astype(jnp.float32), c, train=True,
                                       mutable=["batch_stats"])
            per_sample = jnp.mean(jnp.square(out - noise), axis=(1, 2, 3))
            return jax_masked_mean(per_sample, mask)[1], mutated["batch_stats"]

        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        sharded = jax_shard_batch(jax_make_mesh(2), x, c, t, noise, mask)
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v["params"], v["batch_stats"], *sharded)
        return float(loss), jax.device_get(grads), jax.device_get(stats)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


@pytest.mark.parametrize("case,real,seed", [("full", B, 0), ("masked", 6, 1)])
def test_two_rank_step_matches_jax_mesh_step(cases, variables, case, real, seed):
    """Against the JAX package's 2-device mesh step under the training
    tests' tolerance (``tests/test_torch_port_training.py``): loss rtol
    1e-5, every gradient leaf rtol 1e-4 / atol 1e-6, the staged running
    statistics (flax's updated ``batch_stats``) 1e-5 abs."""
    _, ranks = cases
    x, c, mask, t, noise = workers.train_batch(real, seed)
    loss, grads, stats = _jax_mesh_step(variables, x, c, mask, t, noise)
    got = ranks[0][case]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    port_grads = dict(_leaves(to_jax_variables(got["grads"])["params"]))
    for name, g in _leaves(grads):
        np.testing.assert_allclose(port_grads[name], g, rtol=1e-4, atol=1e-6, err_msg=name)
    port_stats = dict(_leaves(to_jax_variables(got["stats"])["batch_stats"]))
    for name, s in _leaves(stats):
        np.testing.assert_allclose(port_stats[name], s, atol=1e-5, rtol=0, err_msg=name)


# ---- the samplers ------------------------------------------------------------

SAMPLERS = ["ddpm_w2", "ddpm_w0_drawn_params", "ddpm_per_sample_w", "ddim_posterior_w2_eta",
            "ddim_beta_per_sample_w", "dpm2m_w2", "dpm2m_per_sample_w", "dpm2m_w0",
            "from_noise_x", "from_noise_intermediate"]


@pytest.mark.parametrize("name", SAMPLERS)
def test_sharded_sampler_equals_one_process(cases, name):
    """5 maps over two ranks (3 + 2 real rows and a pad row): every rank
    gets the global maps, those of one process under the same generator."""
    one, ranks = cases
    want = one[name].numpy()
    assert want.shape[-4:] == (workers.N_MAPS, H, H, 1)
    for r in ranks:
        assert r[name].shape == one[name].shape
        np.testing.assert_allclose(r[name].numpy(), want, atol=MAP_TOL, rtol=0)
    assert torch.equal(ranks[0][name], ranks[1][name])


# ---- run_experiment ----------------------------------------------------------

# Held within STATE_REL (relative L2 over the group): the parameters but
# ROUNDING_LEAVES and the BatchNorm running variances; Adam's moments within
# MOMENT_REL.  ROUNDING_LEAVES, the conv biases ahead of a norm, have a
# gradient of rounding noise, which Adam turns into steps of up to about the
# rate either way; the running means of the norms after them carry those
# biases.  Both are held only to what Adam can move them in the run.
STATE_REL, MOMENT_REL = 1e-6, 1e-5
ROUNDING_LEAVES = ("/conv1/conv/bias", "/conv2/conv/bias", "/out_conv1/bias")


def _run_distances(want: dict, got: dict) -> dict:
    """``{what: (distance, bound)}`` of the two-rank run's state from the
    mesh-less run's, with the epoch losses."""
    lr, steps = workers.TINY["lrate"], int(want["/step"])
    adam_reach = 2 * lr * steps * 0.1 / np.sqrt(1 - 0.999)  # Kingma & Ba's bound, both runs

    def group(select, relative=True):
        keys = sorted(k for k in want if select(k))
        a = np.concatenate([want[k].ravel().astype(np.float64) for k in keys])
        b = np.concatenate([got[k].ravel().astype(np.float64) for k in keys])
        return float(np.linalg.norm(a - b) / np.linalg.norm(a)) if relative else \
            float(np.abs(a - b).max())

    def rounding(k):
        return k.startswith("/params/") and k.endswith(ROUNDING_LEAVES)

    return {
        "params": (group(lambda k: k.startswith("/params/") and not rounding(k)), STATE_REL),
        "running variances": (group(lambda k: k.startswith("/batch_stats/")
                                    and k.endswith("/var")), STATE_REL),
        "Adam mu": (group(lambda k: k.startswith("/opt_state/0/mu/")), MOMENT_REL),
        "Adam nu": (group(lambda k: k.startswith("/opt_state/0/nu/")), MOMENT_REL),
        "rounding leaves (max abs)": (group(rounding, relative=False), adam_reach),
        "running means (max abs)": (group(lambda k: k.startswith("/batch_stats/")
                                          and k.endswith("/mean"), relative=False),
                                    adam_reach),
    }


def _run_failures(one: dict, rank: dict) -> list:
    """What of the two-rank run is beyond its bound: the epoch losses (rel
    ``STATE_REL``), the reconstruction's mean (1e-4 abs), the train state
    (:func:`_run_distances`), the step and Adam's counts (equal)."""
    want, got = dict(_leaves(one["state"])), dict(_leaves(rank["state"]))
    assert set(got) == set(want) and int(want["/step"]) == 14
    failures = [name for name in ("/step", "/epoch", "/opt_state/0/count",
                                  "/opt_state/1/count")
                if not np.array_equal(got[name], want[name])]
    losses = np.abs(np.asarray(rank["loss_log"]) / np.asarray(one["loss_log"]) - 1).max()
    if not losses <= STATE_REL:
        failures.append(f"epoch losses {losses:.3e}")
    if not abs(rank["recon_mean"] - one["recon_mean"]) <= 1e-4:
        failures.append(f"reconstruction mean {rank['recon_mean']} / {one['recon_mean']}")
    failures += [f"{what} {d:.3e} > {bound:.3e}"
                 for what, (d, bound) in _run_distances(want, got).items() if not d <= bound]
    return failures


def test_two_rank_run_losses_equal_the_mesh_less_run(runs):
    """The loss of each epoch (the mean over the global batches) rel
    ``STATE_REL`` (measured: equal), and the reconstruction's mean 1e-4 abs
    (it samples through the running means, :data:`ROUNDING_LEAVES`)."""
    one, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["loss_log"], one["loss_log"], rtol=STATE_REL)
        assert abs(r["recon_mean"] - one["recon_mean"]) <= 1e-4


def test_two_rank_run_train_state_equals_the_mesh_less_run(runs):
    """After 2 epochs of 7 steps at lr 1e-3 the two-rank run's losses and
    train state are the mesh-less run's to fp32 rounding (measured: losses
    equal, parameters 6.9e-8, running variances 6.4e-8, Adam's moments
    9.3e-7 and 6.7e-7), on both ranks alike."""
    one, ranks = runs
    assert _run_failures(one, ranks[0]) == []
    for name, v in _leaves(ranks[1]["state"]):
        np.testing.assert_array_equal(v, dict(_leaves(ranks[0]["state"]))[name], err_msg=name)


@pytest.mark.parametrize("fault", ["averaged_gradients", "per_rank_statistics"])
def test_two_rank_run_check_catches_a_planted_fault(runs, tmp_path, fault):
    """The run-level check above fails a two-rank run with a planted fault
    (``torch_port_mesh_workers._plant``): gradients averaged over the ranks
    instead of summed, or BatchNorm statistics of each rank's rows only."""
    one, _ = runs
    ranks = spawn(workers.run_tiny_experiment, 2, (str(tmp_path / "mesh"), "nov26", fault),
                  store_dir=str(tmp_path / "store"), device="cpu", timeout=TIMEOUT)
    assert _run_failures(one, ranks[0])


def test_two_rank_run_writes_on_rank_zero_only(runs):
    """Rank 0 writes the mesh-less run's files; rank 1 wrote none of its own
    (the two share the run's directory)."""
    one, ranks = runs
    assert ranks[0]["files"] == one["files"]
    assert ranks[1]["files"] == one["files"]


def test_mesh_of_one_process_equals_the_mesh_less_run(tmp_path):
    """``mesh_devices=1`` without a group takes the mesh path on a mesh of
    one process, which runs no collective: the mesh-less run bit for bit."""
    runs = {name: workers.run_tiny_experiment(
        port_mesh.make_mesh(1, device="cpu") if name == "mesh" else None,
        str(tmp_path / name), "nov26") for name in ("mesh", "single")}
    assert runs["mesh"]["loss_log"] == runs["single"]["loss_log"]
    want = dict(_leaves(runs["single"]["state"]))
    for name, v in _leaves(runs["mesh"]["state"]):
        np.testing.assert_array_equal(v, want[name], err_msg=name)


def test_mesh_devices_beyond_the_group_raises(tmp_path):
    cfg = ExperimentConfig(mode="nov26", output_root=str(tmp_path), mesh_devices=2,
                           **workers.TINY)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        experiment.run_experiment(cfg, device="cpu")
