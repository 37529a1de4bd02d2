"""How far one train step's fp32 gradients sit from float64, with the
model's kinks free and pinned.

    python scripts/variant_kink_check.py [--model deep] [--n-feat 64] [--height 64]

Builds ``ContextUnet.<model>`` at ``--n-feat`` and ``--height`` from
``torch.manual_seed(0)`` and one batch of 2 (``chip_smoke.variant_batch``,
seed 2), on the CPU.  Takes the step's gradients (``chip_smoke.witness_grads``)
in float64, recording the side of each ReLU, leaky-ReLU and max-pool kink
its inputs take (``chip_smoke.kink_sides``); then in fp32 three ways: as
it stands, with the BatchNorm and GroupNorm statistics and normalisation
computed in float64, and with every kink pinned to the float64 step's
side.  Prints each fp32 step's relative L2 distance to float64 over all
leaves, and how many of the recorded sides the fp32 forward leaves.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("canonical", "deep", "big"), default="deep")
    ap.add_argument("--n-feat", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from camels_diffusion_model_tpu_torch.models import blocks
    from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
    from camels_diffusion_model_tpu_torch.ops.groupnorm import activation

    torch.manual_seed(0)
    base = getattr(ContextUnet, args.model)(n_feat=args.n_feat, height=args.height)
    base = base.to(memory_format=torch.channels_last)
    scaling = "standard" if args.model == "big" else "reference"
    batch = chip_smoke.variant_batch(base, 2, 2)
    cpu = torch.device("cpu")

    def make(device):
        return copy.deepcopy(base).to(device=device, memory_format=torch.channels_last)

    def grads(dtype):
        return chip_smoke.witness_grads(make, cpu, *batch, scaling, dtype, True)

    @contextlib.contextmanager
    def float64_norms():
        """BatchNorm's batch statistics and the plain GroupNorm in float64."""
        bn_forward, gn_plain = blocks.BatchNorm.forward, blocks.groupnorm_act_plain

        def bn(self, h, train=False):
            hd = h.double()
            dims = (0, 2, 3)
            mean = hd.mean(dim=dims)
            var = torch.clamp((hd * hd).mean(dim=dims) - mean * mean, min=0.0)
            mul = torch.rsqrt(var + self.eps) * self.weight.double()
            y = (hd - mean[:, None, None]) * mul[:, None, None] + self.bias.double()[:, None, None]
            return y.to(h.dtype)

        def gn(x, gamma, beta, num_groups=8, eps=1e-5, act="relu", film=None):
            b, h, w, c = x.shape
            xg = x.double().reshape(b, h * w, num_groups, c // num_groups)
            mean = xg.mean(dim=(1, 3), keepdim=True)
            var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
            y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
            y = activation(y * gamma.double() + beta.double(), act).to(x.dtype)
            return y if film is None else chip_smoke.film_plain(y, *film)

        blocks.BatchNorm.forward, blocks.groupnorm_act_plain = bn, gn
        try:
            yield
        finally:
            blocks.BatchNorm.forward, blocks.groupnorm_act_plain = bn_forward, gn_plain

    sides = []
    with chip_smoke.kink_sides(sides, replay=False):
        ref = grads(torch.float64)
    flat_ref = torch.cat([g.flatten() for g in ref.values()])

    def rel(tree):
        flat = torch.cat([tree[n].flatten() for n in ref])
        return ((flat - flat_ref).norm() / flat_ref.norm()).item()

    print(f"{args.model}, n_feat {args.n_feat}, {args.height}x{args.height}, batch 2, CPU: "
          f"fp32 gradients vs float64, relative L2 over all {len(ref)} leaves")
    print(f"  fp32 as it stands: {rel(grads(torch.float32)):.3e}")
    with float64_norms():
        print(f"  fp32, norm statistics in float64: {rel(grads(torch.float32)):.3e}")
    with chip_smoke.kink_sides(sides, replay=True) as flips:
        pinned = grads(torch.float32)
    print(f"  fp32, kinks pinned to float64's sides: {rel(pinned):.3e} "
          f"({flips[0]} of {flips[1]} sides differ from fp32's own)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
