"""The ContextUnet family (counterpart of
``camels_diffusion_model_tpu/models/context_unet.py``).

Three variants, built by the factories of the JAX package
(``context_unet.py:100-136``): :meth:`ContextUnet.canonical` (64x64,
``n_feat`` 128, ``n_cfeat`` 6, two levels, ReLU heads),
:meth:`ContextUnet.deep` (128x128, ``n_cfeat`` 5, three levels, leaky-ReLU
heads, tanh output) and :meth:`ContextUnet.big` (``n_feat`` 256, ``n_cfeat``
10, 128x128, three levels, GELU heads, tanh output, an extra output
conv).  ``n_feat``, ``n_cfeat`` and ``height`` are free so the tests can
build a narrow one.  The forward splits into a condition-free ``encode`` and
a FiLM-conditioned ``decode`` (``context_unet.py:227-317``), so that
classifier-free guidance runs the encoder once and the decoder on the
doubled ``[cond, uncond]`` batch.

Layout: public inputs and outputs are NHWC ``(B, H, W, C)`` as in the JAX
package; inside, activations are NCHW tensors in ``torch.channels_last``
memory.  The two GroupNorm heads go through kernel K2, which applies FiLM
stage 0 as the epilogue of ``up0_norm``; FiLM stage 1 goes through K3.
The samplers stop at :meth:`ContextUnet.decode_features` and hand
``out_conv2`` (and the tanh of the deep and big variants) to the step
kernel K1.

``train=True`` (the training step's forward) normalises the BatchNorms with
batch statistics and runs the decoder's GroupNorm and FiLM in plain PyTorch
under autograd, as the JAX package trains without its Pallas kernels
(``pallas_gn=False``); with ``train=False`` the kernels run.

``dtype`` is the compute dtype, ``torch.float32`` or ``torch.bfloat16``
(the JAX module's ``dtype``): parameters, norm statistics and the samplers'
state stay fp32, each conv and dense layer computes in ``dtype``
(``blocks.py``), the input is cast at :meth:`ContextUnet.encode`, a zero
context is made in ``dtype`` and the FiLM rows are cast to it
(``context_unet.py:229,251,294``).  eps comes out in ``dtype``.  Parameters
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
    COMPUTE_DTYPES,
    Conv2d,
    ConvTranspose2d,
    EmbedFC,
    GroupNormAct,
    OutputConv2d,
    ResidualConvBlock,
    UnetDown,
    UnetUp,
    to_compute,
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


# The JAX factories' settings by variant name (``context_unet.py:100-136``).
VARIANTS = {
    "canonical": dict(levels=2),
    "deep": dict(levels=3, up0_act="leaky_relu", out_act="leaky_relu", final_tanh=True),
    "big": dict(levels=3, up0_act="gelu", out_act="gelu", final_tanh=True,
                extra_out_conv=True),
}


class ContextUnet(nn.Module):
    """Parameter-conditional U-Net denoiser (the JAX module's arguments;
    ``dtype`` as in the module docstring).

    ``shortcut``: ``"learned"`` (the default: ``init_conv`` has a 1x1
    ``shortcut`` conv) or ``"stochastic"``, the reference's fresh random
    1x1 projection in ``init_conv`` on every forward
    (``diffusion_utilities.py:54``; ``context_unet.py:77-80``).  A
    stochastic model holds no ``init_conv.shortcut`` parameter; each
    :meth:`encode` (and so each forward) takes the draw as
    ``shortcut=(kernel, bias)``, drawn by :meth:`draw_shortcut`.  The samplers, the likelihood passes and the
    trainer draw one per model evaluation from their generator, or take
    it from their ``shortcut_fn`` / ``shortcut=`` hooks.
    """

    def __init__(self, in_channels: int = 1, n_feat: int = 128,
                 n_cfeat: int = 6, height: int = 64, levels: int = 2,
                 up0_act: str = "relu", out_act: str = "relu",
                 final_tanh: bool = False, extra_out_conv: bool = False,
                 fold_bn: bool = False, dtype: torch.dtype = torch.float32,
                 shortcut: str = "learned"):
        super().__init__()
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        self.in_channels, self.n_feat, self.n_cfeat = in_channels, n_feat, n_cfeat
        self.height, self.levels = height, levels
        self.final_tanh, self.dtype, self.shortcut = final_tanh, dtype, shortcut
        n = n_feat
        cb = self.bottleneck_feat
        d = dict(compute_dtype=dtype)
        self.init_conv = ResidualConvBlock(in_channels, n, is_res=True, fold_bn=fold_bn,
                                           shortcut=shortcut, **d)
        # Down-path widths [n, 2n] (two levels) or [n, 2n, 4n] (three).
        skip_feats = [n, n] + [n * 2**i for i in range(1, levels)]  # x0, then downs
        for i in range(levels):
            self.add_module(f"down{i + 1}", UnetDown(skip_feats[i], skip_feats[i + 1],
                                                     fold_bn=fold_bn, **d))
        self.timeembed1 = EmbedFC(1, cb, **d)
        self.timeembed2 = EmbedFC(1, cb // 2, **d)
        self.contextembed1 = EmbedFC(n_cfeat, cb, **d)
        self.contextembed2 = EmbedFC(n_cfeat, cb // 2, **d)
        bottom = height // 2**levels
        self.up0_conv = ConvTranspose2d(cb, cb, bottom, stride=bottom, **d)
        self.up0_norm = GroupNormAct(cb, act=up0_act)
        # Up-path widths: n, n (two levels); 2n, n, n (three).
        width = cb
        for i in range(levels):
            out = max(n, cb // 2 ** (i + 1))
            self.add_module(f"up{i + 1}", UnetUp(width + skip_feats[levels - i], out,
                                                 fold_bn=fold_bn, **d))
            width = out
        self.out_conv1 = Conv2d(width + n, n, 3, padding=1, **d)
        if extra_out_conv:
            self.out_conv_extra = Conv2d(n, n, 3, padding=1, **d)
        self.out_norm = GroupNormAct(n, act=out_act)
        self.out_conv2 = OutputConv2d(n, in_channels, 3, padding=1, **d)

    @classmethod
    def canonical(cls, n_cfeat: int = 6, n_feat: int = 128, height: int = 64, **kw):
        """The canonical 64x64 two-level model."""
        return cls(n_feat=n_feat, n_cfeat=n_cfeat, height=height, **VARIANTS["canonical"], **kw)

    @classmethod
    def deep(cls, n_cfeat: int = 5, n_feat: int = 128, height: int = 128, **kw):
        """The 128x128 three-level leaky-ReLU/tanh variant (``initial.py``)."""
        return cls(n_feat=n_feat, n_cfeat=n_cfeat, height=height, **VARIANTS["deep"], **kw)

    @classmethod
    def big(cls, n_cfeat: int = 10, n_feat: int = 256, height: int = 128, **kw):
        """The ``n_feat`` 256, 128x128 three-level GELU/tanh variant with the
        extra output conv (``main.py``)."""
        return cls(n_feat=n_feat, n_cfeat=n_cfeat, height=height, **VARIANTS["big"], **kw)

    @property
    def bottleneck_feat(self) -> int:
        return self.n_feat * 2 ** (self.levels - 1)

    @property
    def stochastic(self) -> bool:
        """Whether ``init_conv`` draws a fresh projection each forward."""
        return self.shortcut == "stochastic"

    def draw_shortcut(self, generator: torch.Generator) -> tuple:
        """One draw of the stochastic projection from ``generator``, on its
        device, fp32: ``kernel (n_feat, in_channels, 1, 1)``, then ``bias
        (n_feat,)``, each uniform in +-1/sqrt(in_channels), torch's
        ``Conv2d`` init (``blocks.py:212-222``)."""
        bound = 1.0 / self.in_channels ** 0.5
        dev = generator.device
        kernel = torch.empty((self.n_feat, self.in_channels, 1, 1), device=dev)
        bias = torch.empty((self.n_feat,), device=dev)
        return (kernel.uniform_(-bound, bound, generator=generator),
                bias.uniform_(-bound, bound, generator=generator))

    def encode(self, x: torch.Tensor, train: bool = False, shortcut=None) -> EncoderState:
        """init_conv + down path + pooled bottleneck of NHWC ``x``, cast to
        the compute dtype first.  ``shortcut``: a stochastic model's
        projection ``(kernel, bias)`` (:meth:`draw_shortcut`); a
        learned-shortcut model takes none."""
        x = to_compute(to_nchw(x).contiguous(memory_format=torch.channels_last), self.dtype)
        if shortcut is not None and not self.stochastic:
            raise ValueError("a learned-shortcut model takes no shortcut draw")
        x0 = self.init_conv(x, train, proj=shortcut)
        downs = []
        h = x0
        for i in range(self.levels):
            h = getattr(self, f"down{i + 1}")(h, train)
            downs.append(h)
        # AvgPool over the whole bottleneck map is a global mean; then GELU.
        hidden = F.gelu(h.mean(dim=(2, 3), keepdim=True), approximate="none")
        return EncoderState(x0, tuple(downs), hidden)

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
        :meth:`time_embed`, the sampler's hot path; the rows are cast to the
        compute dtype.  FiLM stage 1 runs in ``u``'s dtype (fp32 in the
        unfolded bf16 model, whose blocks return fp32: the bf16 rows promote,
        as in JAX).
        """
        if film is None:
            if c is None:
                c = torch.zeros(enc.x0.shape[0], self.n_cfeat, dtype=self.dtype,
                                device=enc.x0.device)
            cemb1, cemb2 = self.context_embed(c)
            temb1, temb2 = self.time_embed(t)
        else:
            cemb1, temb1, cemb2, temb2 = (to_compute(a, self.dtype) for a in film)
        u = self.up0_norm(self.up0_conv(enc.hiddenvec),
                          film=(cemb1.contiguous(), temb1.contiguous()), train=train)
        skips = (enc.x0,) + enc.downs  # shallowest first
        for i in range(self.levels):
            if i == 1:  # FiLM stage 1; stage 0 was up0_norm's epilogue
                film1 = film_plain if train else fused_film
                u = to_nchw(film1(to_nhwc(u), cemb2.to(u.dtype).contiguous(),
                                  temb2.to(u.dtype).contiguous()))
            u = getattr(self, f"up{i + 1}")(u, skips[self.levels - i], train)
        h = self.out_conv1(torch.cat([u, enc.x0], dim=1))
        if hasattr(self, "out_conv_extra"):
            h = self.out_conv_extra(h)
        return self.out_norm(h, train=train)

    def decode(self, enc: EncoderState, t: Optional[torch.Tensor] = None,
               c: Optional[torch.Tensor] = None, *, film=None,
               train: bool = False) -> torch.Tensor:
        """FiLM-conditioned decoder -> NHWC eps in the compute dtype:
        ``out_conv2`` of :meth:`decode_features` (same arguments), then tanh
        where ``final_tanh`` is set.  The samplers run both inside the step
        kernel instead."""
        eps = self.out_conv2(self.decode_features(enc, t, c, film=film, train=train))
        return to_nhwc(torch.tanh(eps) if self.final_tanh else eps)

    def forward(self, x, t, c=None, train: bool = False, shortcut=None):
        """eps for NHWC ``x`` at normalised time ``t`` ((1,) or (B,)) and
        context ``c`` ((B, n_cfeat) or None); ``train=True`` is the training
        forward (module docstring); ``shortcut`` as :meth:`encode`."""
        return self.decode(self.encode(x, train, shortcut), t, c, train=train)
