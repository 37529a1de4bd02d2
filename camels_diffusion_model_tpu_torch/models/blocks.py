"""Building blocks of the ContextUnet (counterpart of
``camels_diffusion_model_tpu/models/blocks.py``).

Module and parameter names mirror the flax tree, so
``utils.weights.from_jax_variables`` only renames leaves.  Activations are
NCHW tensors in ``torch.channels_last`` memory; ``GroupNormAct`` hands the
kernel the free NHWC view.

Every block takes ``train``, as the flax blocks do.  With ``train=False``
BatchNorm runs on its running statistics (or is folded away,
``fold_bn=True``) and the GroupNorm heads launch kernel K2.  With
``train=True`` BatchNorm normalises with flax's batch statistics and stages
their running averages (:class:`BatchNorm`), and the heads take the plain
GroupNorm under autograd: the kernels have no backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import fused_groupnorm_act, groupnorm_act_plain


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


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW
    (``blocks.py:181-190``), in fp32.

    ``train=False`` normalises with the running statistics, whatever the
    module's ``training`` flag.  ``train=True`` normalises with the batch
    mean and flax's biased variance ``E[x^2] - E[x]^2`` (clamped at 0, as
    ``use_fast_variance`` computes it) over batch and pixels, pad rows
    included, and stages ``0.9 * running + 0.1 * batch`` in
    :attr:`staged`, with that same biased variance (``nn.BatchNorm2d``
    would update with the unbiased one).  :func:`commit_batch_stats`
    copies the staged values into the buffers: flax's
    ``mutable=["batch_stats"]``, so that a forward run again by
    ``torch.utils.checkpoint`` stages the same values instead of applying
    the update twice.  ``num_batches_tracked`` stays 0: flax keeps no
    count.
    """

    momentum_flax = 0.9

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)
        self.staged = None

    def forward(self, h, train: bool = False):
        if not train:
            return F.batch_norm(h, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        mean = h.mean(dim=dims)
        var = torch.clamp((h * h).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum_flax
            self.staged = (m * self.running_mean + (1.0 - m) * mean,
                           m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (h - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def commit_batch_stats(model: nn.Module) -> None:
    """Copy each :class:`BatchNorm`'s staged running statistics into its
    buffers (the update of the last ``train=True`` forward)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm) and m.staged is not None:
                m.running_mean.copy_(m.staged[0])
                m.running_var.copy_(m.staged[1])
                m.staged = None


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
            self.conv1_bn = BatchNorm(out_channels)
            self.conv2_bn = BatchNorm(out_channels)
        if is_res and in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def _stage(self, h, name: str, train: bool):
        h = getattr(self, name)(h)
        bn = getattr(self, f"{name}_bn", None)
        if bn is not None:
            h = bn(h, train)
        return F.relu(h)

    def forward(self, x, train: bool = False):
        x2 = self._stage(self._stage(x, "conv1", train), "conv2", train)
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

    def forward(self, x, train: bool = False):
        return F.max_pool2d(self.block2(self.block1(x, train), train), 2)


class UnetUp(nn.Module):
    """Concat skip -> 2x2 stride-2 transposed conv -> two ResidualConvBlocks."""

    def __init__(self, in_channels: int, out_channels: int, fold_bn: bool = False):
        super().__init__()
        self.upconv = nn.ConvTranspose2d(in_channels, out_channels, 2, stride=2)
        self.block1 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn)
        self.block2 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn)

    def forward(self, x, skip, train: bool = False):
        x = self.upconv(torch.cat([x, skip], dim=1))
        return self.block2(self.block1(x, train), train)


class GroupNormAct(nn.Module):
    """GroupNorm(8, eps 1e-5) + affine + act through kernel K2; with
    ``film=(scale, shift)`` rows, K2's FiLM epilogue follows the act.
    ``train=True`` runs the plain version under autograd instead."""

    def __init__(self, channels: int, act: str = "relu",
                 num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.act, self.num_groups, self.eps = act, num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, film=None, train: bool = False):
        fn = groupnorm_act_plain if train else fused_groupnorm_act
        y = fn(to_nhwc(x), self.weight, self.bias, self.num_groups, self.eps,
               self.act, film)
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
        x = x.reshape(-1, self.input_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))
