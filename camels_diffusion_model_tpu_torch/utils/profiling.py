"""Device tracing hooks (counterpart of
``camels_diffusion_model_tpu/utils/profiling.py``).

* ``trace(log_dir)``: a ``torch.profiler`` window over a region, the CPU's
  activity and, where CUDA is available, the card's kernels, written to
  ``log_dir`` as a Chrome trace (``chrome://tracing``, Perfetto).
* ``maybe_trace()``: the same when ``CAMELS_PROFILE=<dir>`` is set, else
  nothing; the experiment runner wraps its second epoch in it (the first
  pays the cuDNN and kernel set-up), so one variable captures a trace of a
  production run with no code change.
* ``annotate(name)``: a named range in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def trace_path(log_dir: str) -> str:
    """A new trace file's path in ``log_dir``: process id and time in its
    name, so that the ranks of a mesh and later windows write their own."""
    return os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block and write its Chrome trace into ``log_dir``;
    yields the file's path (written when the block exits)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = trace_path(log_dir)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def maybe_trace(env_var: str = "CAMELS_PROFILE") -> Iterator[None]:
    """:func:`trace` into the directory ``env_var`` names, if it is set."""
    log_dir = os.environ.get(env_var)
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield


def annotate(name: str):
    """A named range of the trace timeline."""
    return record_function(name)
