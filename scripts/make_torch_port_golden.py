"""Write ``tests/data/torch_port_golden.npz``: the JAX ContextUnet's eps on
the committed certification checkpoint, for the PyTorch port to match.

Runs the JAX package on the CPU, in fp32:

    python scripts/make_torch_port_golden.py

Inputs from numpy seed 0: x ``(2, 64, 64, 1)``, normalised times t ``(2,)``
and contexts c ``(2, 6)``.  Outputs: ``eps = apply(x, t, c)`` and the
unconditional half of a guidance pair, ``eps_uncond = apply(x, t, 0)``.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
CKPT = os.path.join(REPO, "artifacts", "certification", "model", "train_state.msgpack")


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from camels_diffusion_model_tpu.models import ContextUnet
    from camels_diffusion_model_tpu.serving import _md5
    from camels_diffusion_model_tpu.training import load_model_weights

    model = ContextUnet(in_channels=1, n_feat=128, n_cfeat=6, height=64, levels=2)
    template = model.init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 1), np.float32),
        np.array([0.5], np.float32),
    )
    variables = load_model_weights(template, CKPT)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 64, 64, 1).astype(np.float32)
    t = np.array([0.05, 0.8], np.float32)
    c = rs.rand(2, 6).astype(np.float32)
    eps = np.asarray(model.apply(variables, x, t, c), np.float32)
    eps_uncond = np.asarray(
        model.apply(variables, x, t, np.zeros_like(c)), np.float32
    )
    np.savez(OUT, x=x, t=t, c=c, eps=eps, eps_uncond=eps_uncond,
             checkpoint_md5=np.asarray(_md5(CKPT)))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
