"""Read the JAX package's flax msgpack checkpoints without flax or msgpack.

Counterpart of ``camels_diffusion_model_tpu/training/checkpoints.py``
(``load_model_weights``) and of the md5 stamp in ``serving.py:51-56``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import _msgpack


def md5(path: str) -> str:
    """Hex md5 of a file, read in 1 MiB chunks (the checkpoint stamp)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _copy_tree(node):
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    return np.array(node)


def load_variables(path: str) -> dict:
    """``{"params", "batch_stats"}`` of a training or weights checkpoint.

    Numpy trees with flax's module names and layouts (HWIO conv kernels).
    A training checkpoint's ``opt_state``, ``step``, ``epoch`` and ``rng``
    are dropped.  The arrays are copies, so the file buffer is freed.
    """
    with open(path, "rb") as f:
        state = _msgpack.unpackb(f.read())
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError(f"{path}: not a flax checkpoint with 'params'")
    return {
        "params": _copy_tree(state["params"]),
        "batch_stats": _copy_tree(state.get("batch_stats") or {}),
    }
