"""Run a function in a few local processes joined into one group, without
``torchrun``: the CPU tests' two gloo ranks, and two gloo ranks sharing one
card (NCCL refuses two ranks on one device).

    results = spawn(fn, 2, args, store_dir=tmp, backend="gloo", device="cpu")

Each process joins the group through a ``FileStore`` under ``store_dir`` (no
TCP port, so concurrent runs cannot collide), calls ``fn(mesh, *args)`` and
writes what it returns; ``spawn`` returns the results by rank.  A process
that raises, or does not finish within ``timeout`` seconds, makes ``spawn``
raise with the failure; every process is ended before it returns.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback

import torch


def _run(rank: int, world: int, fn, args, store_dir: str, backend: str, device,
         timeout: float) -> None:
    import torch.distributed as dist

    from .mesh import init_distributed, make_mesh

    out = os.path.join(store_dir, f"rank{rank}")
    try:
        init_distributed(backend=backend, rank=rank, world_size=world,
                         store=dist.FileStore(os.path.join(store_dir, "store"), world),
                         timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(make_mesh(world, device=device), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, args=(), *, store_dir: str, backend: str = "gloo",
          device=None, timeout: float = 300.0) -> list:
    """``[fn(mesh, *args) on rank r for r in range(world)]`` (module
    docstring); ``fn`` must be importable by name (a module-level function)
    and its result loadable by ``torch.load``."""
    os.makedirs(store_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_run, args=(r, world, fn, args, store_dir, backend,
                                            device, timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(store_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif r in hung:
            errors.append(f"rank {r}: no result within {timeout} s")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    return [torch.load(os.path.join(store_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
