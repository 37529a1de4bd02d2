"""The canonical ContextUnet (counterpart of
``camels_diffusion_model_tpu/models/context_unet.py``).

64x64 maps, ``n_feat`` 128, ``n_cfeat`` 6, two levels and ReLU heads by
default; ``n_feat``, ``n_cfeat`` and ``height`` are free so the tests can
build a narrow one.  The forward splits into a condition-free ``encode`` and
a FiLM-conditioned ``decode`` (``context_unet.py:227-317``), so that
classifier-free guidance runs the encoder once and the decoder on the doubled
``[cond, uncond]`` batch.

Layout: public inputs and outputs are NHWC ``(B, H, W, C)`` as in the JAX
package; inside, activations are NCHW tensors in ``torch.channels_last``
memory.  The two GroupNorm heads go through kernel K2, which applies FiLM
stage 0 as the epilogue of ``up0_norm``; FiLM stage 1 goes through K3.
The samplers stop at :meth:`ContextUnet.decode_features` and hand
``out_conv2`` to the step kernel K1.

``train=True`` (the training step's forward) normalises the BatchNorms with
batch statistics and runs the decoder's GroupNorm and FiLM in plain PyTorch
under autograd, as the JAX package trains without its Pallas kernels
(``pallas_gn=False``); with ``train=False`` the kernels run.  Parameters
start at torch's defaults, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
convolutions and dense layers as the JAX package's ``torch_conv_init``
(``blocks.py:77-87``), ones and zeros for the norms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.film import film_plain, fused_film
from .blocks import (
    EmbedFC,
    GroupNormAct,
    ResidualConvBlock,
    UnetDown,
    UnetUp,
    to_nchw,
    to_nhwc,
)


class EncoderState(NamedTuple):
    """Condition-independent activations of :meth:`ContextUnet.encode`."""

    x0: torch.Tensor  # init_conv output
    downs: tuple  # down-path outputs, shallowest first
    hiddenvec: torch.Tensor  # pooled bottleneck, (B, Cb, 1, 1)

    def doubled(self) -> "EncoderState":
        """The same state twice along the batch, for the [cond, uncond]
        decoder batch of classifier-free guidance."""
        def cat(a):
            return torch.cat([a, a], dim=0)
        return EncoderState(cat(self.x0), tuple(cat(d) for d in self.downs),
                            cat(self.hiddenvec))


class ContextUnet(nn.Module):
    """Parameter-conditional U-Net denoiser, canonical two-level variant."""

    levels = 2

    def __init__(self, in_channels: int = 1, n_feat: int = 128,
                 n_cfeat: int = 6, height: int = 64, fold_bn: bool = False):
        super().__init__()
        self.in_channels, self.n_feat, self.n_cfeat = in_channels, n_feat, n_cfeat
        self.height = height
        n = n_feat
        cb = self.bottleneck_feat
        self.init_conv = ResidualConvBlock(in_channels, n, is_res=True, fold_bn=fold_bn)
        self.down1 = UnetDown(n, n, fold_bn=fold_bn)
        self.down2 = UnetDown(n, 2 * n, fold_bn=fold_bn)
        self.timeembed1 = EmbedFC(1, cb)
        self.timeembed2 = EmbedFC(1, cb // 2)
        self.contextembed1 = EmbedFC(n_cfeat, cb)
        self.contextembed2 = EmbedFC(n_cfeat, cb // 2)
        bottom = height // 2**self.levels
        self.up0_conv = nn.ConvTranspose2d(cb, cb, bottom, stride=bottom)
        self.up0_norm = GroupNormAct(cb, act="relu")
        self.up1 = UnetUp(2 * cb, n, fold_bn=fold_bn)
        self.up2 = UnetUp(2 * n, n, fold_bn=fold_bn)
        self.out_conv1 = nn.Conv2d(2 * n, n, 3, padding=1)
        self.out_norm = GroupNormAct(n, act="relu")
        self.out_conv2 = nn.Conv2d(n, in_channels, 3, padding=1)

    @property
    def bottleneck_feat(self) -> int:
        return self.n_feat * 2 ** (self.levels - 1)

    def encode(self, x: torch.Tensor, train: bool = False) -> EncoderState:
        """init_conv + down path + pooled bottleneck of NHWC ``x``."""
        x = to_nchw(x).contiguous(memory_format=torch.channels_last)
        x0 = self.init_conv(x, train)
        d1 = self.down1(x0, train)
        d2 = self.down2(d1, train)
        # AvgPool over the whole bottleneck map is a global mean; then GELU.
        hidden = F.gelu(d2.mean(dim=(2, 3), keepdim=True), approximate="none")
        return EncoderState(x0, (d1, d2), hidden)

    def time_embed(self, t: torch.Tensor):
        """Both time MLPs for normalised timesteps: ``((N, cb), (N, cb//2))``."""
        return self.timeembed1(t), self.timeembed2(t)

    def context_embed(self, c: torch.Tensor):
        """Both context MLPs: ``((N, cb), (N, cb//2))``."""
        return self.contextembed1(c), self.contextembed2(c)

    def decode_features(self, enc: EncoderState, t: Optional[torch.Tensor] = None,
                        c: Optional[torch.Tensor] = None, *, film=None,
                        train: bool = False) -> torch.Tensor:
        """FiLM-conditioned decoder up to and including ``out_norm``: the
        features ``out_conv2`` takes, NCHW in channels_last memory.

        Pass ``t``/``c`` (normalised time, context; ``c=None`` is the zero
        context) or ``film=(cemb1, temb1, cemb2, temb2)`` as ``(N, C)`` or
        ``(1, C)`` rows precomputed by :meth:`context_embed` and
        :meth:`time_embed`, the sampler's hot path.
        """
        if film is None:
            if c is None:
                c = torch.zeros(enc.x0.shape[0], self.n_cfeat,
                                device=enc.x0.device)
            cemb1, cemb2 = self.context_embed(c)
            temb1, temb2 = self.time_embed(t)
        else:
            cemb1, temb1, cemb2, temb2 = film
        u = self.up0_norm(self.up0_conv(enc.hiddenvec),
                          film=(cemb1.contiguous(), temb1.contiguous()), train=train)
        u = self.up1(u, enc.downs[1], train)
        film1 = film_plain if train else fused_film
        u = to_nchw(film1(to_nhwc(u), cemb2.contiguous(), temb2.contiguous()))
        u = self.up2(u, enc.downs[0], train)
        return self.out_norm(self.out_conv1(torch.cat([u, enc.x0], dim=1)), train=train)

    def decode(self, enc: EncoderState, t: Optional[torch.Tensor] = None,
               c: Optional[torch.Tensor] = None, *, film=None,
               train: bool = False) -> torch.Tensor:
        """FiLM-conditioned decoder -> NHWC eps: ``out_conv2`` of
        :meth:`decode_features` (same arguments).  The samplers run
        ``out_conv2`` inside the step kernel instead."""
        h = self.decode_features(enc, t, c, film=film, train=train)
        return to_nhwc(self.out_conv2(h))

    def forward(self, x, t, c=None, train: bool = False):
        """eps for NHWC ``x`` at normalised time ``t`` ((1,) or (B,)) and
        context ``c`` ((B, n_cfeat) or None); ``train=True`` is the training
        forward (module docstring)."""
        return self.decode(self.encode(x, train), t, c, train=train)
