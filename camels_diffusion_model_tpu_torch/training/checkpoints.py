"""Weights files and resumable training checkpoints in flax's msgpack
format, without flax or msgpack.

Counterpart of ``camels_diffusion_model_tpu/training/checkpoints.py`` and of
the md5 stamp in ``serving.py:51-56``.  The files are the JAX package's,
byte for byte in layout: ``{"params", "batch_stats"}`` in flax's names and
layouts (HWIO kernels), written by ``_msgpack.packb``, so either package
reads the other's weights files and train checkpoints.

A train checkpoint holds ``params``, ``batch_stats``, ``opt_state``,
``step``, ``epoch`` and ``rng``.  ``opt_state`` is optax's
``adam(schedule)`` state as flax's ``to_state_dict`` writes it:
``{"0": {"count", "mu", "nu"}, "1": {"count"}}`` (scale_by_adam, then
scale_by_schedule), ``mu``/``nu`` the Adam moments in the params' layout,
``count`` int32 scalars equal to ``step``.  ``rng`` is uint32 ``(2,)``: in
the JAX package the training key after the run's splits so far; here the
run seed as ``[seed >> 32, seed & 0xffffffff]``, the layout of
``jax.random.PRNGKey(seed)``, from which each step's generator is seeded
with the step count (``trainer.seeded_generator``).  A port run resumed from
a JAX checkpoint takes that key's two words as its seed; a JAX run resumed
from a port checkpoint continues from ``PRNGKey(seed)``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from .. import _msgpack
from ..utils.weights import from_jax_variables, to_jax_variables


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


def weights_checkpoint_plan(style: str, ep: int, n_epoch: int, every: int) -> tuple:
    """``(save, filename)`` of the weights file after 0-based epoch ``ep``
    (``checkpoints.py:25-50``): "plus1" every ``every`` epochs and the last,
    named ``model_epoch_{ep+1}``; "list25" at ``(ep+1)`` in ``every`` x
    {1, 2, 3, 4} only, named ``model_epoch_{ep}`` (the reference's own
    off-by-one); "mod0" at ``ep % every == 0`` and the last, named
    ``model_epoch_{ep}``."""
    last = ep == n_epoch - 1
    if style == "mod0":
        return (ep % every == 0 or last), f"model_epoch_{ep}.msgpack"
    if style == "list25":
        in_list = (ep + 1) in {every, 2 * every, 3 * every, 4 * every}
        return in_list, f"model_epoch_{ep}.msgpack"
    if style == "plus1":
        return ((ep + 1) % every == 0 or last), f"model_epoch_{ep + 1}.msgpack"
    raise ValueError(f"unknown ckpt_style {style!r}")


def _write(payload: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_msgpack.packb(payload))


def save_model_weights(model, path: str) -> None:
    """The model's ``{"params", "batch_stats"}`` as a flax weights file."""
    _write(to_jax_variables(model.state_dict()), path)


def load_model_weights(model, path: str):
    """Load a weights (or train) checkpoint into ``model`` (strict names
    and shapes); returns the model."""
    model.load_state_dict(from_jax_variables(load_variables(path)))
    return model


def save_train_checkpoint(state, epoch: int, path: str) -> None:
    """The resumable state (module docstring) after ``epoch`` epochs."""
    params = dict(state.model.named_parameters())
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    for name, p in params.items():
        st = state.optimizer.state.get(p, {})
        for key in moments:
            moments[key][name] = st.get(key, torch.zeros_like(p))
    count = np.asarray(state.step, np.int32)
    variables = to_jax_variables(state.model.state_dict())
    _write({
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": {
            "0": {"count": count,
                  "mu": to_jax_variables(moments["exp_avg"])["params"],
                  "nu": to_jax_variables(moments["exp_avg_sq"])["params"]},
            "1": {"count": count},
        },
        "step": int(state.step),
        "epoch": int(epoch),
        "rng": np.array([state.seed >> 32, state.seed & 0xFFFFFFFF], np.uint32),
    }, path)


def load_train_checkpoint(state, path: str):
    """Restore ``state`` (model, Adam moments and count, step, seed) from a
    train checkpoint of either package; returns ``(state, epoch, rng)``."""
    with open(path, "rb") as f:
        ckpt = _msgpack.unpackb(f.read())
    missing = {"params", "opt_state", "step", "epoch", "rng"} - set(ckpt)
    if missing:
        raise ValueError(f"{path}: not a train checkpoint (no {sorted(missing)})")
    model = state.model  # from_jax_variables copies out of the file's buffer
    model.load_state_dict(from_jax_variables(ckpt))
    adam = ckpt["opt_state"]["0"]
    mu = from_jax_variables({"params": adam["mu"]})
    nu = from_jax_variables({"params": adam["nu"]})
    count = int(adam["count"])
    params = dict(model.named_parameters())
    if set(mu) != set(params) or set(nu) != set(params):
        raise ValueError(f"{path}: the Adam moments do not match the model's parameters")
    state.optimizer.state.clear()
    for name, p in params.items():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device),
        }
    rng = np.array(ckpt["rng"], np.uint32)
    state.step = int(ckpt["step"])
    state.seed = (int(rng[0]) << 32) | int(rng[1])
    return state, int(ckpt["epoch"]), rng
