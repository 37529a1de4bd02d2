"""Write the goldens the PyTorch port is held to: the JAX ContextUnet's eps
on the committed certification checkpoint.

Runs the JAX package on the CPU:

    python scripts/make_torch_port_golden.py

``tests/data/torch_port_golden.npz`` (fp32): inputs from numpy seed 0, x
``(2, 64, 64, 1)``, normalised times t ``(2,)`` and contexts c ``(2, 6)``;
outputs ``eps = apply(x, t, c)`` and the unconditional half of a guidance
pair, ``eps_uncond = apply(x, t, 0)``, of the unfolded model.

``tests/data/torch_port_golden_bf16.npz``: on the same inputs, the
BatchNorm-folded model (``fold_inference``, as the port serves it) computing
in bf16 and in fp32: ``eps`` and ``eps_uncond`` of each (``BF16_KEYS``), the
bf16 ones stored as float32 (exact).  The distance between the two is the
yardstick the port's bf16 forward is gated by (``chip_smoke.py`` phase o).
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
OUT_BF16 = os.path.join(REPO, "tests", "data", "torch_port_golden_bf16.npz")
CKPT = os.path.join(REPO, "artifacts", "certification", "model", "train_state.msgpack")
# The bf16 golden's arrays: eps and eps_uncond of the folded model per dtype.
BF16_KEYS = ("eps_bf16", "eps_uncond_bf16", "eps_fp32", "eps_uncond_fp32")


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from camels_diffusion_model_tpu.models import ContextUnet
    from camels_diffusion_model_tpu.models.fold_bn import fold_inference
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

    def eps_pair(m, v):
        return (np.asarray(m.apply(v, x, t, c), np.float32),
                np.asarray(m.apply(v, x, t, np.zeros_like(c)), np.float32))

    eps, eps_uncond = eps_pair(model, variables)
    md5 = np.asarray(_md5(CKPT))
    np.savez(OUT, x=x, t=t, c=c, eps=eps, eps_uncond=eps_uncond, checkpoint_md5=md5)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    arrays = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        arrays[f"eps_{name}"], arrays[f"eps_uncond_{name}"] = eps_pair(
            *fold_inference(model.clone(dtype=dtype), variables))
    np.savez(OUT_BF16, **{k: arrays[k] for k in BF16_KEYS}, checkpoint_md5=md5)
    print(f"wrote {OUT_BF16} ({os.path.getsize(OUT_BF16)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
