"""Building blocks of the ContextUnet (counterpart of
``camels_diffusion_model_tpu/models/blocks.py``).

Module and parameter names mirror the flax tree, so
``utils.weights.from_jax_variables`` only renames leaves.  Activations are
NCHW tensors in ``torch.channels_last`` memory; ``GroupNormAct`` hands the
kernel the free NHWC view.  Inference only: BatchNorm runs on its running
statistics, or is folded away (``fold_bn=True``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import fused_groupnorm_act


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> contiguous NHWC; no copy when x is
    channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


class Conv3x3(nn.Module):
    """3x3 same-padding conv; the flax ``Conv3x3`` holds it as ``conv``."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, 3, padding=1)

    def forward(self, x):
        return self.conv(x)


class ResidualConvBlock(nn.Module):
    """Two (3x3 conv -> BatchNorm -> ReLU) stages, with the residual add of
    ``is_res`` blocks: identity when the widths match, else the learned 1x1
    ``shortcut`` (``blocks.py:163-236``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 is_res: bool = False, fold_bn: bool = False):
        super().__init__()
        self.is_res = is_res
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.conv2 = Conv3x3(out_channels, out_channels)
        if not fold_bn:
            self.conv1_bn = nn.BatchNorm2d(out_channels, eps=1e-5)
            self.conv2_bn = nn.BatchNorm2d(out_channels, eps=1e-5)
        if is_res and in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def _stage(self, h, name: str):
        h = getattr(self, name)(h)
        bn = getattr(self, f"{name}_bn", None)
        if bn is not None:
            h = bn(h)
        return F.relu(h)

    def forward(self, x):
        x2 = self._stage(self._stage(x, "conv1"), "conv2")
        if not self.is_res:
            return x2
        if hasattr(self, "shortcut"):
            return self.shortcut(x) + x2
        return x + x2


class UnetDown(nn.Module):
    """Two ResidualConvBlocks then a 2x2 max-pool."""

    def __init__(self, in_channels: int, out_channels: int, fold_bn: bool = False):
        super().__init__()
        self.block1 = ResidualConvBlock(in_channels, out_channels, fold_bn=fold_bn)
        self.block2 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn)

    def forward(self, x):
        return F.max_pool2d(self.block2(self.block1(x)), 2)


class UnetUp(nn.Module):
    """Concat skip -> 2x2 stride-2 transposed conv -> two ResidualConvBlocks."""

    def __init__(self, in_channels: int, out_channels: int, fold_bn: bool = False):
        super().__init__()
        self.upconv = nn.ConvTranspose2d(in_channels, out_channels, 2, stride=2)
        self.block1 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn)
        self.block2 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn)

    def forward(self, x, skip):
        x = self.upconv(torch.cat([x, skip], dim=1))
        return self.block2(self.block1(x))


class GroupNormAct(nn.Module):
    """GroupNorm(8, eps 1e-5) + affine + act through kernel K2; with
    ``film=(scale, shift)`` rows, K2's FiLM epilogue follows the act."""

    def __init__(self, channels: int, act: str = "relu",
                 num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.act, self.num_groups, self.eps = act, num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, film=None):
        y = fused_groupnorm_act(
            to_nhwc(x), self.weight, self.bias, self.num_groups, self.eps,
            self.act, film,
        )
        return to_nchw(y)


class EmbedFC(nn.Module):
    """Linear -> erf-GELU -> Linear on the input flattened to
    ``(-1, input_dim)`` (``blocks.py:333-364``)."""

    def __init__(self, input_dim: int, emb_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.fc1 = nn.Linear(input_dim, emb_dim)
        self.fc2 = nn.Linear(emb_dim, emb_dim)

    def forward(self, x):
        x = x.reshape(-1, self.input_dim).float()
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))
