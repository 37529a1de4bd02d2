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

The spatial (data x space) mesh (``mesh.py:86-135``): :func:`make_mesh_2d`
places rank ``r`` at ``(r // n_space, r % n_space)``, the row-major layout
of JAX's ``devices.reshape(n_data, n_space)``, and holds the world group, a
data group per space index and a space group per data index.  A process
holds a block of the batch (over ``data``) and of the image height (over
``space``).  What XLA's SPMD partitioner writes in JAX is written here by
hand with the same two collectives: the 3x3 convolutions' halo rows
(:func:`halo_rows`, one all-reduce of a zeroed buffer over the space
group, differentiable), the cross-shard sums of the norm statistics and of
the bottleneck's global mean (:func:`all_reduce_sum` over a group), and
the gather of a level whose height no longer splits (:func:`gather_rows`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

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

    # A 1-D mesh is its own data axis and world, with a space axis of one.
    @property
    def data(self) -> "Mesh":
        return self

    @property
    def world(self) -> "Mesh":
        return self

    @property
    def space(self) -> "Mesh":
        return Mesh(1, 0, self.device)

    @property
    def n_space(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D (data x space) mesh of ``n_data * n_space`` processes
    (:func:`make_mesh_2d`): this process's global ``rank`` and ``device``,
    and its three axes as 1-D meshes: ``world`` (every process), ``data``
    (the processes of its space index, which hold the other rows of the
    batch) and ``space`` (those of its data index, which hold the other
    rows of the image)."""

    n_data: int
    n_space: int
    rank: int
    device: torch.device
    world: Mesh
    data: Mesh
    space: Mesh

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_space

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


def make_mesh_2d(n_data: int, n_space: int, device=None) -> Mesh2D:
    """The 2-D (data x space) mesh over the initialised group
    (``mesh.py:86-111``): rank ``r`` at ``(r // n_space, r % n_space)``.
    The group must hold exactly ``n_data * n_space`` processes (more
    requested raises as JAX does; fewer raises too, as :func:`make_mesh`).
    Every process creates every data and space group, in one order, as
    ``torch.distributed.new_group`` requires."""
    n_data, n_space = int(n_data), int(n_space)
    if n_data < 1 or n_space < 1:
        raise ValueError(f"a {n_data}x{n_space} mesh")
    world = make_mesh(None, device=device)
    need = n_data * n_space
    if need > world.world_size:
        raise ValueError(f"requested {n_data}x{n_space} mesh but only "
                         f"{world.world_size} devices present")
    if need != world.world_size:
        raise ValueError(f"a {n_data}x{n_space} mesh of the group's {world.world_size} "
                         f"processes: launch {need}")
    d, s = divmod(world.rank, n_space)

    def axis(members: list, index: int) -> Mesh:
        if len(members) == 1:
            return Mesh(1, 0, world.device)
        return Mesh(len(members), index, world.device, groups[tuple(members)])

    groups = {}
    if world.collective:
        for ranks in ([[dd * n_space + ss for dd in range(n_data)] for ss in range(n_space)]
                      + [[dd * n_space + ss for ss in range(n_space)] for dd in range(n_data)]):
            if len(ranks) > 1 and tuple(ranks) not in groups:
                groups[tuple(ranks)] = dist.new_group(ranks)
    return Mesh2D(n_data, n_space, world.rank, world.device, world,
                  axis([dd * n_space + s for dd in range(n_data)], d),
                  axis([d * n_space + ss for ss in range(n_space)], s))


class Sharding(NamedTuple):
    """How an array is laid out over a mesh (a ``NamedSharding``'s
    counterpart): ``spec`` names, for each leading axis, the mesh axis it
    is split over (``"data"``, ``"space"``) or None (whole); this process
    holds the contiguous block its ranks on those axes give it."""

    mesh: object
    spec: tuple

    def block(self, a):
        """This process's block of the global array ``a`` (numpy or
        tensor; a view), each split axis a multiple of its mesh axis."""
        index = []
        for dim, name in enumerate(self.spec):
            if name is None:
                index.append(slice(None))
                continue
            axis = getattr(self.mesh, name)
            if a.shape[dim] % axis.world_size:
                raise ValueError(f"axis {dim} of {a.shape[dim]} does not divide over the "
                                 f"{axis.world_size} processes of the {name} axis")
            rows = a.shape[dim] // axis.world_size
            index.append(slice(axis.rank * rows, (axis.rank + 1) * rows))
        return a[tuple(index)]

    def local(self, a) -> torch.Tensor:
        """:meth:`block` as a contiguous tensor on the mesh's device."""
        return torch.as_tensor(self.block(a)).contiguous().to(self.mesh.device)


def batch_sharding(mesh, ndim: int = 1) -> Sharding:
    """The leading (batch) axis split over the data axis (``mesh.py:80-83``)."""
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


def spatial_sharding(mesh, ndim: int = 4) -> Sharding:
    """NHWC activations on a 2-D mesh: the batch over the data axis, the
    image height (axis 1) over the space axis (``mesh.py:114-123``)."""
    if not isinstance(mesh, Mesh2D):
        raise ValueError("spatial_sharding needs a 2-D mesh (make_mesh_2d)")
    return Sharding(mesh, ("data", "space") + (None,) * (ndim - 2))


def replicated_sharding(mesh) -> Sharding:
    """Every process holds the whole array (``mesh.py:136-137``)."""
    return Sharding(mesh, ())


def shard_batch_spatial(mesh: Mesh2D, x, *rest):
    """This process's (batch, height) block of the NHWC batch ``x`` and its
    batch rows of each array of ``rest`` (contexts, masks), as tensors on
    its device (``mesh.py:126-133``)."""
    xs = spatial_sharding(mesh, np.ndim(x)).local(x)
    others = tuple(batch_sharding(mesh, np.ndim(a)).local(a) for a in rest)
    return (xs, *others) if others else xs


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
    mesh of one.  A bf16 tensor is summed in fp32 and rounded once (gloo
    has no bf16 sum; the halo rows and gathers a bf16 model sends are one
    value and zeros, exact either way)."""
    if mesh.collective:
        if x.dtype == torch.bfloat16:
            wide = x.float()
            dist.all_reduce(wide, group=mesh.group)
            x.copy_(wide)
        else:
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


class _HaloRows(torch.autograd.Function):
    """The rows beyond this shard's first and last along ``dim``: the
    previous shard's last row and the next shard's first, zero at the
    image's edges.  Each process writes its two edge rows into its slot of
    a zeroed ``(n_space, 2, ...)`` buffer and the space group sums it.  The
    backward pass sends each halo row's gradient back to the shard that
    owns the row, through the same kind of all-reduce."""

    @staticmethod
    def forward(ctx, x, space, dim):
        ctx.space, ctx.dim, ctx.shape = space, dim, x.shape
        n, s = space.world_size, space.rank
        first, last = x.select(dim, 0), x.select(dim, -1)
        buf = x.new_zeros((n, 2) + tuple(first.shape))
        buf[s, 0], buf[s, 1] = first, last
        all_reduce(space, buf)
        top = buf[s - 1, 1] if s > 0 else torch.zeros_like(first)
        bottom = buf[s + 1, 0] if s < n - 1 else torch.zeros_like(first)
        return top.unsqueeze(dim), bottom.unsqueeze(dim)

    @staticmethod
    def backward(ctx, grad_top, grad_bottom):
        space, dim = ctx.space, ctx.dim
        n, s = space.world_size, space.rank
        g_top, g_bottom = grad_top.squeeze(dim), grad_bottom.squeeze(dim)
        buf = g_top.new_zeros((n, 2) + tuple(g_top.shape))
        if s > 0:
            buf[s - 1, 1] = g_top  # the previous shard's last row
        if s < n - 1:
            buf[s + 1, 0] = g_bottom  # the next shard's first row
        all_reduce(space, buf)
        grad = g_top.new_zeros(ctx.shape)
        grad.select(dim, 0).add_(buf[s, 0])
        grad.select(dim, -1).add_(buf[s, 1])
        return grad, None, None


def halo_rows(space: Mesh, x: torch.Tensor, dim: int) -> tuple:
    """``(top, bottom)``: the rows of the neighbouring height shards of the
    space axis ``space`` that a 3x3 window of this shard ``x`` reads, each
    with ``dim`` of size 1, zeros at the image's edges (the convolution's
    SAME padding); differentiable (:class:`_HaloRows`)."""
    return _HaloRows.apply(x, space, dim)


def with_halo(space: Optional[Mesh], x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with its halo rows (:func:`halo_rows`) before and after it
    along ``dim``; ``x`` itself without a collective space axis."""
    if space is None or not space.collective:
        return x
    top, bottom = halo_rows(space, x, dim)
    out = torch.cat([top, x, bottom], dim=dim)
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def gather_rows(space: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole image along ``dim`` on every process of ``space`` from each
    one's rows ``x`` (a zeroed buffer summed; differentiable: the gradient
    of this process's rows is the sum of every process's gradient of
    them)."""
    if not space.collective:
        return x
    rows, n, s = x.shape[dim], space.world_size, space.rank
    parts = [x]
    if s:
        parts.insert(0, x.new_zeros(x.shape[:dim] + (s * rows,) + x.shape[dim + 1:]))
    if s < n - 1:
        parts.append(x.new_zeros(x.shape[:dim] + ((n - 1 - s) * rows,) + x.shape[dim + 1:]))
    return all_reduce_sum(space, torch.cat(parts, dim=dim))


def local_rows_of(space: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This process's block of the whole image ``x`` along ``dim`` (a view)."""
    if not space.collective:
        return x
    rows = x.shape[dim] // space.world_size
    return x.narrow(dim, space.rank * rows, rows)


def gather_blocks(mesh: Mesh2D, x: torch.Tensor, n_real: int) -> torch.Tensor:
    """The global NHWC batch on every process from each one's (batch,
    height) block ``x``, cut to ``n_real`` rows: the inverse of
    :func:`spatial_sharding`'s blocks (one all-reduce over the world)."""
    b, h = x.shape[0], x.shape[1]
    full = x.new_zeros((b * mesh.n_data, h * mesh.n_space) + tuple(x.shape[2:]))
    d, s = mesh.data.rank, mesh.space.rank
    full[d * b:(d + 1) * b, s * h:(s + 1) * h] = x
    return all_reduce(mesh.world, full)[:n_real]


def replicate(mesh: Mesh, module_or_state):
    """Broadcast the parameters and buffers of a module (or of a train
    state's model) from rank 0 (``mesh.py:160-163``); returns its argument.
    A 2-D mesh broadcasts over its world."""
    mesh = mesh.world
    module = getattr(module_or_state, "model", module_or_state)
    if mesh.collective:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dense = t.detach().contiguous()  # a channels_last weight is not
                dist.broadcast(dense, src=0, group=mesh.group)
                t.copy_(dense)
    return module_or_state
