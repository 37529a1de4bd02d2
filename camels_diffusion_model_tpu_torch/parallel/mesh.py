"""Data parallelism over a ``torch.distributed`` process group (counterpart
of the batch half of ``camels_diffusion_model_tpu/parallel/mesh.py``).

A mesh here is one process per card, launched by ``torchrun`` (or by
:func:`camels_diffusion_model_tpu_torch.parallel.launch.spawn`): parameters,
BatchNorm statistics and Adam state are replicated, each process holds a
contiguous slice of the global batch, the trainer sums parameter gradients
over the processes and BatchNorm takes its statistics over the global batch
(``models/blocks.py``, ``training/trainer.py``), and the samplers gather
their maps.  A mesh of one process exists too; it runs no collective.

Only ``all_reduce`` and ``broadcast`` are used: they are the collectives
that both backends implement on CUDA tensors (gloo has no CUDA
``all_gather``), so the same code runs under NCCL on a multi-card machine,
under gloo on the CPU, and under gloo with two processes on one card (NCCL
refuses two ranks on one device).

The spatial (data x space) mesh of the JAX package (``make_mesh_2d``,
``spatial_sharding``) is not ported (ROADMAP section 1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# Any of these set means a multi-process launch was configured (by the user
# or torchrun): then a failure to join the group raises instead of running
# on one process.
_DIST_ENV_VARS = ("CAMELS_DISTRIBUTED", "MASTER_ADDR")


def _configured(kwargs) -> bool:
    return (bool(kwargs) or any(os.environ.get(v) for v in _DIST_ENV_VARS)
            or bool(os.environ.get("WORLD_SIZE") and os.environ.get("RANK")))


def world_size() -> int:
    """The size of the initialised default group, or 1."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(**kwargs) -> int:
    """Join the process group once per process; returns the world size
    (JAX: ``mesh.py:40-64``).

    * Not configured -- no kwargs, and none of ``CAMELS_DISTRIBUTED``,
      ``MASTER_ADDR``, or ``WORLD_SIZE`` with ``RANK`` set: a no-op that
      returns 1.
    * Configured: ``torch.distributed.init_process_group(**kwargs)`` (the
      ``env://`` rendezvous of torchrun unless ``init_method`` or ``store``
      is given) and any failure raises.  ``backend`` defaults to ``nccl``
      where CUDA is available and ``gloo`` elsewhere; under NCCL the
      process takes the card ``LOCAL_RANK`` names (rank modulo the cards).
      A repeat call on an initialised group returns its size.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if not _configured(kwargs):
        return 1
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    if kwargs["backend"] == "nccl":
        rank = int(kwargs.get("rank", os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(**kwargs)
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``world_size`` processes, this one's
    ``rank`` and ``device``, and the process ``group`` (None for a mesh of
    one process, which runs no collective)."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def collective(self) -> bool:
        return self.world_size > 1


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the initialised group (``mesh.py:67-77``):
    ``n_devices=None`` takes the group's size, or 1 without a group.  A
    request for more processes than the group has raises (so ``make_mesh(2)``
    in an unconfigured process raises; it never runs on one process
    instead), as does one for fewer: a process outside the mesh would have
    no part of the batch.  ``device`` as :func:`resolve_device` (the card
    this process was given by default)."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} present "
                         "(launch one process per device, e.g. with torchrun)")
    if n != world:
        raise ValueError(f"a mesh of {n} of the group's {world} processes: launch {n}")
    rank = dist.get_rank() if world > 1 else 0
    return Mesh(world, rank, resolve_device(device),
                dist.group.WORLD if world > 1 else None)


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Zero-pad the leading axis to a multiple (``mesh.py:140-150``);
    returns ``(padded, n_real)``."""
    n = x.shape[0]
    rem = n % multiple
    if rem == 0:
        return x, n
    pad = multiple - rem
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]), n


def shard_rows(mesh: Mesh, n_global: int) -> tuple:
    """``(start, rows)``: rank ``r`` of ``R`` holds rows ``[r*b, (r+1)*b)``
    of a global batch of ``n_global`` rows padded to a multiple of ``R``
    (``b`` of them), the order of ``NamedSharding(P("data"))``."""
    rows = -(-n_global // mesh.world_size)
    return mesh.rank * rows, rows


def local_rows(mesh: Mesh, a, n_global: Optional[int] = None, fill: float = 0.0):
    """This rank's rows of the global batch ``a`` (a tensor), the rows past
    its end (the padding to a multiple of the world size) ``fill``."""
    n_global = a.shape[0] if n_global is None else n_global
    start, rows = shard_rows(mesh, n_global)
    part = a[start:start + rows]
    if part.shape[0] < rows:
        part = torch.cat([part, part.new_full((rows - part.shape[0],) + tuple(a.shape[1:]),
                                              fill)])
    return part


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous slice of each global batch array (numpy or
    tensor) as a tensor on the rank's device (``mesh.py:153-158``).  The
    leading axis must divide by the world size (:func:`pad_to_multiple`)."""
    out = []
    for a in arrays:
        if a.shape[0] % mesh.world_size:
            raise ValueError(f"a batch of {a.shape[0]} rows does not divide over "
                             f"{mesh.world_size} processes")
        start, rows = shard_rows(mesh, a.shape[0])
        out.append(torch.as_tensor(a[start:start + rows]).to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def all_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the mesh's processes (in place), a no-op on a
    mesh of one."""
    if mesh.collective:
        dist.all_reduce(x, group=mesh.group)
    return x


def gather_batch(mesh: Mesh, x: torch.Tensor, n_real: int) -> torch.Tensor:
    """The global batch on every rank from each rank's rows ``x``, cut to
    ``n_real`` rows: the inverse of :func:`shard_batch`.  Each rank writes
    its rows into a zeroed global buffer and the buffers are summed (gloo
    has no CUDA ``all_gather``)."""
    if not mesh.collective:
        return x[:n_real]
    rows = x.shape[0]
    full = x.new_zeros((rows * mesh.world_size,) + tuple(x.shape[1:]))
    full[mesh.rank * rows:(mesh.rank + 1) * rows] = x
    return all_reduce(mesh, full)[:n_real]


class _AllReduceSum(torch.autograd.Function):
    """The sum over the processes, differentiable: the gradient of each
    process's input is the sum of the gradients of the sum on every
    process."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(mesh, x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(ctx.mesh, grad.contiguous().clone()), None


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce` under autograd (the BatchNorm statistics); ``x``
    itself without a mesh or on a mesh of one."""
    return _AllReduceSum.apply(x, mesh) if mesh is not None and mesh.collective else x


def replicate(mesh: Mesh, module_or_state):
    """Broadcast the parameters and buffers of a module (or of a train
    state's model) from rank 0 (``mesh.py:160-163``); returns its argument."""
    module = getattr(module_or_state, "model", module_or_state)
    if mesh.collective:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dense = t.detach().contiguous()  # a channels_last weight is not
                dist.broadcast(dense, src=0, group=mesh.group)
                t.copy_(dense)
    return module_or_state
