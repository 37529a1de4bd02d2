"""Fold BatchNorm running statistics into the preceding convolutions.

Counterpart of ``camels_diffusion_model_tpu/models/fold_bn.py:35-80``, on the
numpy variables tree (flax names and HWIO layout), before
``utils.weights.from_jax_variables``:

    kernel' = kernel * f        with  f = scale / sqrt(var + eps)
    bias'   = (bias - mean) * f + bn_bias

The result loads into ``ContextUnet(fold_bn=True)``.  GroupNorms are
data-dependent and stay.  The fold is fp32 whatever the model's compute
dtype, as JAX folds the fp32 variables (``models/fold_bn.py:60-87``); a
bf16 model casts the folded kernels where it uses them.
"""

from __future__ import annotations

import numpy as np

BN_EPS = 1e-5  # must match blocks.ResidualConvBlock's BatchNorm epsilon


def fold_batchnorm_variables(variables: dict) -> dict:
    """A params-only variables tree with every ``<stage>_bn`` folded into
    its sibling ``<stage>`` conv."""
    stats = variables.get("batch_stats") or {}

    def walk(p: dict, s: dict) -> dict:
        out = {}
        for name, value in p.items():
            if name.endswith("_bn"):
                continue  # consumed by its conv sibling below
            bn_name = f"{name}_bn"
            if bn_name in p:
                kernel = np.asarray(value["conv"]["kernel"], np.float32)
                bias = np.asarray(value["conv"]["bias"], np.float32)
                scale = np.asarray(p[bn_name]["scale"], np.float32)
                bn_bias = np.asarray(p[bn_name]["bias"], np.float32)
                mean = np.asarray(s[bn_name]["mean"], np.float32)
                var = np.asarray(s[bn_name]["var"], np.float32)
                f = scale / np.sqrt(var + BN_EPS)
                out[name] = {
                    "conv": {
                        "kernel": kernel * f,  # HWIO: f broadcasts over O
                        "bias": (bias - mean) * f + bn_bias,
                    }
                }
            elif isinstance(value, dict):
                out[name] = walk(value, s.get(name, {}))
            else:
                out[name] = value
        return out

    return {"params": walk(variables["params"], stats)}


def fold_inference(model):
    """``(folded model, its state_dict)``: the BatchNorm-free inference copy
    of the port's ``ContextUnet`` ``model``, on its device and in its
    compute dtype (``fold_bn.py:81-87`` of the JAX package, which returns
    the folded module and variables); ``model`` itself when it holds no
    BatchNorm."""
    from ..serving import load_model
    from ..utils.weights import to_jax_variables
    from .blocks import BatchNorm

    if not any(isinstance(m, BatchNorm) for m in model.modules()):
        return model, model.state_dict()
    folded = load_model(to_jax_variables(model.state_dict()),
                        next(model.parameters()).device, dtype=model.dtype)
    return folded, folded.state_dict()
