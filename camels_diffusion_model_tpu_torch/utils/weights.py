"""Carry flax variables across into this package's ``state_dict`` layout.

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
