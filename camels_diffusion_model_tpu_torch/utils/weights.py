"""Carry flax variables across into this package's ``state_dict`` layout,
and back (:func:`to_jax_variables`).

The port's modules mirror the flax module tree, so a parameter's name is its
flax path joined with dots; only the leaf names and layouts change:

* Conv kernel HWIO -> OIHW.
* ConvTranspose kernel HWIO -> IOHW with the spatial axes flipped (torch's
  transposed conv scatters the kernel, flax's correlates with it;
  ``camels_diffusion_model_tpu/utils/torch_interop.py:134-152``).  The two
  ConvTranspose modules of the ContextUnet are named ``upconv`` and
  ``up0_conv``.
* Dense kernel (I, O) -> Linear weight (O, I).
* Norm ``scale`` -> ``weight``; BatchNorm ``mean``/``var`` ->
  ``running_mean``/``running_var`` (plus torch's ``num_batches_tracked``).

Every leaf is carried, ``params/init_conv/shortcut/{kernel,bias}`` (the
learned 1x1 projection) included; ``torch_interop``'s export drops it.
The maps are permutations, so the Adam moments of a parameter go through
them as the parameter does.
"""

from __future__ import annotations

import numpy as np
import torch

_CONV_TRANSPOSE = ("upconv", "up0_conv")


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _param(path, arr):
    *mods, leaf = path
    if leaf == "kernel" and arr.ndim == 4:
        if mods[-1] in _CONV_TRANSPOSE:
            arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
        else:
            arr = np.transpose(arr, (3, 2, 0, 1))
        leaf = "weight"
    elif leaf == "kernel" and arr.ndim == 2:
        arr, leaf = arr.T, "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf != "bias":
        raise ValueError(f"unexpected parameter {'/'.join(path)}")
    return ".".join(mods + [leaf]), arr


def from_jax_variables(variables: dict) -> dict:
    """flax ``{"params", "batch_stats"}`` (numpy) -> torch ``state_dict``."""
    sd = {}
    for path, arr in _leaves(variables["params"]):
        name, arr = _param(path, arr)
        sd[name] = arr
    for path, arr in _leaves(variables.get("batch_stats") or {}):
        *mods, leaf = path
        if leaf not in ("mean", "var"):
            raise ValueError(f"unexpected batch stat {'/'.join(path)}")
        sd[".".join(mods + ["running_" + leaf])] = arr
        sd[".".join(mods + ["num_batches_tracked"])] = np.asarray(0, np.int64)
    return {
        k: torch.from_numpy(np.array(v))
        for k, v in sd.items()
    }


def _leaf(name: str, arr: np.ndarray):
    """Inverse of :func:`_param`: a ``state_dict`` entry -> its flax path
    and value (None for ``num_batches_tracked``) and its collection."""
    *mods, leaf = name.split(".")
    if leaf == "num_batches_tracked":
        return None
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", tuple(mods) + (leaf[len("running_"):],), arr
    if leaf == "weight" and arr.ndim == 4:
        if mods[-1] in _CONV_TRANSPOSE:
            arr = np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
        else:
            arr = np.transpose(arr, (2, 3, 1, 0))
        leaf = "kernel"
    elif leaf == "weight" and arr.ndim == 2:
        arr, leaf = arr.T, "kernel"
    elif leaf == "weight" and arr.ndim == 1:
        leaf = "scale"
    elif leaf != "bias":
        raise ValueError(f"unexpected state_dict entry {name}")
    return "params", tuple(mods) + (leaf,), arr


def to_jax_variables(state_dict) -> dict:
    """torch ``state_dict`` (or any map of its names to tensors, such as
    the Adam moments) -> flax ``{"params", "batch_stats"}`` of contiguous
    numpy arrays; the inverse of :func:`from_jax_variables`
    (``num_batches_tracked`` is dropped: flax keeps no count).  Each tree's
    keys are sorted, as a tree that went through ``jax.jit`` holds them, so
    a file written from it is the JAX package's byte for byte."""
    out = {"params": {}, "batch_stats": {}}
    for name, value in state_dict.items():
        entry = _leaf(name, value.detach().cpu().numpy())
        if entry is None:
            continue
        col, path, arr = entry
        node = out[col]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {col: _sorted(tree) for col, tree in out.items()}


def _sorted(tree):
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}
