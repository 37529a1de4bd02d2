"""Reference-format ``.pth`` checkpoints: import and export (counterpart of
``camels_diffusion_model_tpu/utils/torch_interop.py``).

The reference saves ``torch.save(model.state_dict())``
(``train_diffusion_paper.py:477``) with the module names of its
ContextUnet (``init_conv``, ``down1``/``down2``, ``timeembed*``,
``contextembed*``, ``up0``, ``up1``/``up2``, ``out``).  These functions map
such a state dict to and from the flax-layout numpy variables tree that
the port reads and writes everywhere else
(``training/checkpoints.py::load_variables``, ``utils/weights.py``), so
``serving.load_model`` serves an imported ``.pth`` unchanged.

Layouts (reference <-> flax tree):

* Conv2d ``(O, I, kh, kw)`` <-> Conv kernel ``(kh, kw, I, O)``.
* ConvTranspose2d ``(I, O, kh, kw)`` <-> ConvTranspose kernel ``(kh, kw,
  I, O)`` with the spatial axes flipped (torch's transposed conv scatters
  the kernel, flax's correlates with it).
* Linear ``(O, I)`` <-> Dense kernel ``(I, O)``.
* BatchNorm2d ``weight``/``bias``/``running_mean``/``running_var`` <->
  ``scale``/``bias`` and the ``batch_stats`` ``mean``/``var``; GroupNorm
  ``weight``/``bias`` <-> ``scale``/``bias``.

The reference's ``init_conv`` has no shortcut parameter: it draws a fresh
1x1 conv each forward (``diffusion_utilities.py:54``).  Export leaves the
learned shortcut out; import re-seeds it with one Kaiming-uniform draw
from ``split(PRNGKey(shortcut_seed))``, as the JAX package does, drawn by
``utils/threefry.py`` so the imported tree is the JAX package's bit for
bit without jax.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from . import threefry


def _res_block(flax_prefix, torch_prefix, out):
    """A ResidualConvBlock: ``convN`` -> ``Sequential(Conv2d, BatchNorm2d,
    ReLU)``."""
    for stage in ("conv1", "conv2"):
        conv, bn = flax_prefix + (stage, "conv"), flax_prefix + (f"{stage}_bn",)
        out += [
            ((conv, "kernel"), f"{torch_prefix}.{stage}.0.weight", "conv"),
            ((conv, "bias"), f"{torch_prefix}.{stage}.0.bias", "vec"),
            ((bn, "scale"), f"{torch_prefix}.{stage}.1.weight", "vec"),
            ((bn, "bias"), f"{torch_prefix}.{stage}.1.bias", "vec"),
            ((bn, "mean"), f"{torch_prefix}.{stage}.1.running_mean", "bstat"),
            ((bn, "var"), f"{torch_prefix}.{stage}.1.running_var", "bstat"),
        ]


def _embed(flax_name, torch_name, out):
    out += [
        (((flax_name, "fc1"), "kernel"), f"{torch_name}.model.0.weight", "linear"),
        (((flax_name, "fc1"), "bias"), f"{torch_name}.model.0.bias", "vec"),
        (((flax_name, "fc2"), "kernel"), f"{torch_name}.model.2.weight", "linear"),
        (((flax_name, "fc2"), "bias"), f"{torch_name}.model.2.bias", "vec"),
    ]


def canonical_name_map(levels: int = 2):
    """``[(flax_path, torch_name, kind)]`` of the canonical ContextUnet
    (``torch_interop.py:93-131``): ``flax_path`` is ``((module, ...),
    leaf)``, ``kind`` the layout conversion; ``"bstat"`` entries live in
    ``batch_stats``."""
    out = []
    _res_block(("init_conv",), "init_conv", out)
    for lv in range(1, levels + 1):
        for tidx, blk in enumerate(("block1", "block2")):
            _res_block((f"down{lv}", blk), f"down{lv}.model.{tidx}", out)
    for name in ("timeembed1", "timeembed2", "contextembed1", "contextembed2"):
        _embed(name, name, out)
    out += [
        ((("up0_conv",), "kernel"), "up0.0.weight", "convT"),
        ((("up0_conv",), "bias"), "up0.0.bias", "vec"),
        ((("up0_norm",), "scale"), "up0.1.weight", "vec"),
        ((("up0_norm",), "bias"), "up0.1.bias", "vec"),
    ]
    for lv in range(1, levels + 1):
        out += [
            (((f"up{lv}", "upconv"), "kernel"), f"up{lv}.model.0.weight", "convT"),
            (((f"up{lv}", "upconv"), "bias"), f"up{lv}.model.0.bias", "vec"),
        ]
        for tidx, blk in ((1, "block1"), (2, "block2")):
            _res_block((f"up{lv}", blk), f"up{lv}.model.{tidx}", out)
    out += [
        ((("out_conv1",), "kernel"), "out.0.weight", "conv"),
        ((("out_conv1",), "bias"), "out.0.bias", "vec"),
        ((("out_norm",), "scale"), "out.1.weight", "vec"),
        ((("out_norm",), "bias"), "out.1.bias", "vec"),
        ((("out_conv2",), "kernel"), "out.3.weight", "conv"),
        ((("out_conv2",), "bias"), "out.3.bias", "vec"),
    ]
    return out


def _to_flax(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
    if kind == "convT":
        return np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]  # IOHW -> HWIO, flipped
    if kind == "linear":
        return np.transpose(arr)
    return arr


def _to_torch(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "convT":
        return np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
    if kind == "linear":
        return np.transpose(arr)
    return arr


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def export_to_torch_state_dict(variables: Dict[str, Any], levels: int = 2) -> dict:
    """flax-layout variables -> a reference-format state dict of numpy
    arrays (``torch_interop.py:174-195``): every BatchNorm's
    ``num_batches_tracked`` 0, no learned shortcut."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    sd = {}
    for (path, leaf), torch_name, kind in canonical_name_map(levels):
        tree = batch_stats if kind == "bstat" else params
        sd[torch_name] = _to_torch(np.asarray(_get(tree, path)[leaf]).astype(np.float32), kind)
    for key in [k for k in sd if k.endswith("running_mean")]:
        sd[key.replace("running_mean", "num_batches_tracked")] = np.asarray(0, np.int64)
    return sd


def shortcut_seed_draw(kernel_shape, bias_shape, shortcut_seed: int = 0):
    """The learned shortcut's import draw (``torch_interop.py:238-251``):
    kernel and bias uniform in +-1/sqrt(I) of a ``(1, 1, I, O)`` kernel,
    from ``split(PRNGKey(shortcut_seed))``, float32."""
    bound = 1.0 / float(np.sqrt(kernel_shape[2]))
    kkey, bkey = threefry.split(threefry.PRNGKey(shortcut_seed))
    return (threefry.uniform(kkey, kernel_shape, -bound, bound),
            threefry.uniform(bkey, bias_shape, -bound, bound))


def import_from_torch_state_dict(template_variables: Dict[str, Any], state_dict,
                                 levels: int = 2, shortcut_seed: int = 0) -> dict:
    """A reference-format state dict (tensors or arrays) -> flax-layout
    variables shaped as the numpy tree ``template_variables``
    (``torch_interop.py:198-255``); a learned shortcut in the template is
    re-seeded by
    :func:`shortcut_seed_draw`, so two imports of one ``.pth`` are the
    same model whatever the template held."""
    params = copy.deepcopy(template_variables["params"])
    batch_stats = copy.deepcopy(template_variables.get("batch_stats") or {})
    for (path, leaf), torch_name, kind in canonical_name_map(levels):
        if torch_name not in state_dict:
            raise KeyError(f"reference checkpoint missing {torch_name}")
        value = state_dict[torch_name]
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        arr = _to_flax(np.asarray(value).astype(np.float32), kind)
        node = _get(batch_stats if kind == "bstat" else params, path)
        want = np.asarray(node[leaf]).shape
        if arr.shape != want:
            raise ValueError(f"{torch_name}: shape {arr.shape} != expected {want}")
        node[leaf] = arr
    shortcut = params.get("init_conv", {}).get("shortcut")
    if shortcut is not None:
        shortcut["kernel"], shortcut["bias"] = shortcut_seed_draw(
            np.shape(shortcut["kernel"]), np.shape(shortcut["bias"]), shortcut_seed)
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def save_torch_checkpoint(variables: Dict[str, Any], path: str, levels: int = 2) -> None:
    """Write a reference-loadable ``.pth`` of ``variables``."""
    sd = export_to_torch_state_dict(variables, levels)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) if np.ndim(v) else torch.tensor(v)
                for k, v in sd.items()}, path)


def load_reference_state_dict(path: str) -> dict:
    """A ``torch.save(state_dict)`` file as ``{name: tensor}``, read with
    ``torch.load(..., weights_only=True)``: tensors only, no code run."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_checkpoint(template_variables: Dict[str, Any], path: str,
                          levels: int = 2) -> dict:
    """A reference ``.pth`` -> flax-layout variables shaped as
    ``template_variables``."""
    return import_from_torch_state_dict(template_variables,
                                        load_reference_state_dict(path), levels)
