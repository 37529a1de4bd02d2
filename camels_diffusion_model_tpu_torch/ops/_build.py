"""Build the hand-written CUDA kernels and load them with ctypes.

One ``nvcc`` process a source, all started together, compiles every
``csrc/*.cu`` (with the ``*.cuh`` headers they include) for Hopper
(``sm_90a``); one more links the objects into a shared library with a
plain C interface, under ``build/torch_kernels/<hash of sources and
flags>/`` at the repository root.
Nothing includes PyTorch's headers, so the build takes seconds.  Each C
function takes device pointers and the CUDA stream as ``c_void_p`` and
returns its ``cudaError_t``.  ``ptxas`` reports each kernel's registers,
shared memory and spills (``-Xptxas -v``) into ``nvcc.log`` beside the
library (:func:`ptxas_report`), after one line a source of the seconds
from the start of the build to its compiler's exit (:func:`build_seconds`).

The build runs at the first launch, never at import: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)  # a source to an object
LIB_NAME = "libcamels_torch_kernels.so"
LOG_NAME = "nvcc.log"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile ``csrc/*.cu`` once per source hash; returns the library path."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    compiles = [[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
                for src, obj in zip(sources, objects)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]

    def finish(proc):  # the compiler's log and the seconds until it exited
        log = proc.communicate()[0]
        return log, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(finish, procs))
    logs = [log for log, _ in done]
    seconds = "".join(f"nvcc seconds {src.name}: {t:.1f}\n"
                      for src, (_, t) in zip(sources, done))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]
    for cmd, proc, log in zip(compiles, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    proc = subprocess.run(link, capture_output=True, text=True)
    for obj in objects:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    (out_dir / LOG_NAME).write_text(seconds + "".join(logs) + proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def ptxas_report(lib: Path, names=()) -> list:
    """``ptxas``'s lines for each kernel of the build of ``lib`` whose
    (mangled) name holds one of ``names`` (all kernels if none): one
    string a kernel, its name, registers, shared memory and spills."""
    lines = (lib.parent / LOG_NAME).read_text().splitlines()
    report, current = {}, None
    for line in lines:
        if "Compiling entry function" in line:
            current = line.split("'")[1]
            if names and not any(n in current for n in names):
                current = None
            else:
                report[current] = []
        elif current and ("Used" in line or "stack frame" in line):
            report[current].append(line.split(":", 1)[-1].strip())
    return [f"{k}: {'; '.join(v)}" for k, v in report.items()]


def build_seconds(lib: Path) -> list:
    """``"<source>: <seconds>"`` of each source of the build of ``lib``:
    from the start of the build to its ``nvcc``'s exit."""
    return [line.removeprefix("nvcc seconds ")
            for line in (lib.parent / LOG_NAME).read_text().splitlines()
            if line.startswith("nvcc seconds ")]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


@functools.lru_cache(maxsize=None)
def kernel(name: str, argtypes: tuple):
    """The C entry point ``name`` with its argument types declared."""
    fn = getattr(_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd would record a call of kernel ``name``.

    A kernel writes its output through a pointer, outside autograd: the
    output would have no ``grad_fn``, and a backward pass would give every
    parameter before it no gradient without a word.  The kernels have no
    backward (nor have the Pallas kernels they port), so a forward that
    needs gradients takes the plain versions: the model's ``train=True``
    path.  ``tensors`` may hold None.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and a tensor it was "
            "given requires grad; run the forward under torch.no_grad() or "
            "torch.inference_mode(), or with train=True (the plain path)"
        )


def type_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, for the wrappers' messages."""
    return str(dtype).removeprefix("torch.")


def check(err: int, name: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
