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

On a height shard of a spatial mesh (``space``, the space axis of
``parallel.mesh.make_mesh_2d``; None elsewhere) each 3x3 convolution reads
its halo rows from the neighbouring shards (``parallel.mesh.with_halo``)
and pads only the width, the GroupNorm heads take their statistics over
the space axis, and BatchNorm its training statistics over the mesh's
world (:func:`global_batch_stats`); max-pool and the transposed
convolutions stay local.

Compute dtype (the flax modules' ``dtype``): the parameters stay as they
are (fp32) and each conv and dense layer casts its input, kernel and bias
to the compute dtype where it uses them (:class:`Conv2d`,
:class:`ConvTranspose2d`, :class:`Linear`), as flax does; autograd carries
the gradient through the cast to the fp32 parameters.  In bf16 a layer
adds its bias after the conv or matmul, each rounding to nearest, as the
flax layers' ``y = conv(x) + bias`` does.  torch's own bf16 conv fuses
the bias on the CPU (one rounding) and adds it after cuDNN's output on the
card (two): the two roundings run 0.118 ulp toward zero at the canonical
widths, so the devices' BatchNorm statistics drifted apart (PERF.md
Findings PR 10).  Done here, both devices round as the JAX program does.
BatchNorm computes in fp32 and returns fp32 (``blocks.py:184-191``), so in
the unfolded bf16 model a stage's ReLU runs in fp32 and its residual sum
promotes to fp32, as JAX's does.  ``torch.float32`` casts nothing: the
fp32 model computes in its parameters' dtype (a copy moved to float64
computes in float64).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import (
    fused_groupnorm_act,
    fused_groupnorm_act_sharded,
    groupnorm_act_plain,
    groupnorm_act_plain_sharded,
)
from ..parallel.mesh import all_reduce_sum, gather_rows, with_halo


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> contiguous NHWC; no copy when x is
    channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def to_compute(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` cast to the compute dtype ``dtype`` (no copy when it is
    already); ``torch.float32`` leaves ``t`` as it is (module docstring)."""
    return t if dtype == torch.float32 else t.to(dtype)


def torch_conv_init(fan_in: int, generator=None):
    """An initialiser ``init(tensor)`` that fills a tensor in place from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default for the weights and
    biases of ``Conv2d`` and ``Linear`` (the JAX package's
    ``torch_conv_init``, ``blocks.py:77-87``, which the port's layers get
    from torch itself)."""
    bound = 1.0 / fan_in ** 0.5

    def init(tensor: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return tensor.uniform_(-bound, bound, generator=generator)

    return init


def with_bias(op, x, weight, bias, dtype: torch.dtype):
    """``op(x, weight, bias)`` in the compute dtype: in fp32 one call; in
    bf16 ``op(x, weight, None)`` then ``+ bias`` (channel dim 1), each
    rounded to nearest (module docstring)."""
    x, weight, bias = (to_compute(t, dtype) for t in (x, weight, bias))
    if dtype == torch.float32:
        return op(x, weight, bias)
    y = op(x, weight, None)
    return y + bias.reshape((1, -1) + (1,) * (y.dim() - 2))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` (flax ``nn.Conv``
    with ``dtype``; :func:`with_bias`)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def conv_op(self, x, space=None):
        """``(x, op)``: ``x`` with its halo rows on a height shard of the
        space axis ``space`` and the convolution that pads the width only,
        else ``x`` and ``self._conv_forward``."""
        if space is None or not space.collective:
            return x, self._conv_forward
        x = with_halo(space, x, 2)
        return x, lambda x, w, b: F.conv2d(x, w, b, self.stride, (0, self.padding[1]),
                                           self.dilation, self.groups)

    def forward(self, x, space=None):
        x, op = self.conv_op(x, space)
        return with_bias(op, x, self.weight, self.bias, self.compute_dtype)


class OutputConv2d(Conv2d):
    """The decoder's last conv (``out_conv2``, to the image channels).  In
    bf16 it sums the exact fp32 products of its bf16 operands and its bias
    in fp32 and rounds once, as kernel K1 computes eps on the samplers'
    path, so the likelihood passes' eps is the samplers'.  (Rounded twice,
    as torch's bf16 conv and its bias are on the card, eps was 0.80 ulp
    from the exact sum at full width against 0.49, and the battery's ELBO
    of 2 maps 0.5% off the CPU's: PERF.md Findings PR 10.)"""

    def forward(self, x, space=None):
        d = self.compute_dtype
        if d == torch.float32:
            return super().forward(x, space)
        x, op = self.conv_op(x, space)
        return op(x.to(d).float(), self.weight.to(d).float(), self.bias.to(d).float()).to(d)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype`` (flax
    ``nn.ConvTranspose`` with ``dtype``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        def op(x, weight, bias):
            return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                      self.output_padding, self.groups, self.dilation)

        return with_bias(op, x, self.weight, self.bias, self.compute_dtype)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (flax ``nn.Dense``
    with ``dtype``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return with_bias(F.linear, x, self.weight, self.bias, self.compute_dtype)


class Conv3x3(nn.Module):
    """3x3 same-padding conv; the flax ``Conv3x3`` holds it as ``conv``."""

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 3, padding=1, compute_dtype=compute_dtype)

    def forward(self, x, space=None):
        return self.conv(x, space)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    NCHW (``blocks.py:181-190``): a bf16 input is promoted, and the output
    is fp32 (float64 in a float64 copy).

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

    The statistics are float64 sums of ``(x, x^2, n)`` over batch and
    pixels, through a differentiable all-reduce (:func:`all_reduce_sum`,
    whose backward all-reduces the gradient); the mean and clamped
    ``E[x^2] - E[x]^2`` follow in float64 and are rounded to the input's
    precision.  Off a mesh the all-reduce is a no-op.  On a data-parallel
    mesh (:func:`global_batch_stats`, set by the trainer) it sums over the
    processes, so ``train=True`` takes the statistics of the global batch,
    as XLA's collectives give them in JAX, and the staged running
    statistics are the global ones, the same on every process.  One
    arithmetic serves both: the sums are float64 because the subtraction
    cancels most of their digits, and an fp32 sum split over processes
    rounds once more before it (on the canonical model's maps that put a
    two-process weight gradient 1.3e-4 from a float64 step, where one
    process's fp32 step is 1.2e-5 from it).
    """

    momentum_flax = 0.9

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)
        self.staged = None
        self.mesh = None  # a collective mesh while global_batch_stats is active

    def forward(self, h, train: bool = False):
        h = h.to(torch.promote_types(h.dtype, torch.float32))
        if not train:
            return F.batch_norm(h, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        dims, c = (0, 2, 3), h.shape[1]
        wide = torch.promote_types(h.dtype, torch.float64)
        sums = all_reduce_sum(self.mesh, torch.cat([
            h.sum(dim=dims, dtype=wide), (h * h).sum(dim=dims, dtype=wide),
            torch.full((1,), h.numel() // c, dtype=wide, device=h.device)]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        mean, var = mean.to(h.dtype), var.to(h.dtype)
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


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, mesh):
    """While active, ``model``'s :class:`BatchNorm` layers take their
    training statistics over the global batch of ``mesh`` (a no-op for
    None or a mesh of one process)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    active = mesh if mesh is not None and mesh.collective else None
    for m in norms:
        m.mesh = active
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None


SHORTCUTS = ("learned", "stochastic")


class ResidualConvBlock(nn.Module):
    """Two (3x3 conv -> BatchNorm -> ReLU) stages, with the residual add of
    ``is_res`` blocks: identity when the widths match, else a 1x1
    projection (``blocks.py:163-236``): the learned ``shortcut`` conv, or
    with ``shortcut="stochastic"`` the reference's fresh random projection
    of each forward (``diffusion_utilities.py:54``, ``blocks.py:212-233``),
    which the caller draws and passes as ``proj=(kernel (O, I, 1, 1),
    bias (O,))`` in fp32 (:meth:`ContextUnet.draw_shortcut`); the block
    holds no parameter for it.  Either projection computes in the compute
    dtype, its kernel and bias cast to it, as JAX casts the draws.  With
    BatchNorm unfolded a stage returns fp32 and the residual sum (a bf16
    projection plus an fp32 stage) promotes to fp32, as in JAX
    (``blocks.py:201,236``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 is_res: bool = False, fold_bn: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 shortcut: str = "learned"):
        super().__init__()
        if shortcut not in SHORTCUTS:
            raise ValueError(f"unknown shortcut mode: {shortcut!r}")
        self.is_res, self.compute_dtype = is_res, compute_dtype
        self.conv1 = Conv3x3(in_channels, out_channels, compute_dtype)
        self.conv2 = Conv3x3(out_channels, out_channels, compute_dtype)
        if not fold_bn:
            self.conv1_bn = BatchNorm(out_channels)
            self.conv2_bn = BatchNorm(out_channels)
        self.stochastic = (is_res and in_channels != out_channels
                           and shortcut == "stochastic")
        if is_res and in_channels != out_channels and not self.stochastic:
            self.shortcut = Conv2d(in_channels, out_channels, 1, compute_dtype=compute_dtype)

    def _stage(self, h, name: str, train: bool, space=None):
        h = getattr(self, name)(h, space)
        bn = getattr(self, f"{name}_bn", None)
        if bn is not None:
            h = bn(h, train)
        return F.relu(h)

    def forward(self, x, train: bool = False, proj=None, space=None):
        x2 = self._stage(self._stage(x, "conv1", train, space), "conv2", train, space)
        if not self.is_res:
            return x2
        if self.stochastic:
            if proj is None:
                raise ValueError("a stochastic shortcut needs its draw: proj=(kernel, bias)")
            # fp32 keeps x's dtype (a float64 copy computes in float64)
            d = x.dtype if self.compute_dtype == torch.float32 else self.compute_dtype
            kernel, bias = (p.to(device=x.device, dtype=d) for p in proj)
            return with_bias(F.conv2d, x, kernel, bias, self.compute_dtype) + x2
        if hasattr(self, "shortcut"):
            return self.shortcut(x) + x2
        return x + x2


class UnetDown(nn.Module):
    """Two ResidualConvBlocks then a 2x2 max-pool."""

    def __init__(self, in_channels: int, out_channels: int, fold_bn: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block1 = ResidualConvBlock(in_channels, out_channels, fold_bn=fold_bn,
                                        compute_dtype=compute_dtype)
        self.block2 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn,
                                        compute_dtype=compute_dtype)

    def forward(self, x, train: bool = False, space=None, gather=None):
        """``gather``: the space axis to gather the height over before the
        pool, where the pooled level no longer splits over it."""
        x = self.block2(self.block1(x, train, space=space), train, space=space)
        if gather is not None:
            x = gather_rows(gather, x, 2)
        return F.max_pool2d(x, 2)


class UnetUp(nn.Module):
    """Concat skip -> 2x2 stride-2 transposed conv -> two ResidualConvBlocks.
    The concat promotes as ``jnp.concatenate`` does (a bf16 input and an
    fp32 skip give fp32); the transposed conv casts back."""

    def __init__(self, in_channels: int, out_channels: int, fold_bn: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upconv = ConvTranspose2d(in_channels, out_channels, 2, stride=2,
                                      compute_dtype=compute_dtype)
        self.block1 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn,
                                        compute_dtype=compute_dtype)
        self.block2 = ResidualConvBlock(out_channels, out_channels, fold_bn=fold_bn,
                                        compute_dtype=compute_dtype)

    def forward(self, x, skip, train: bool = False, space=None):
        x = self.upconv(torch.cat([x, skip], dim=1))
        return self.block2(self.block1(x, train, space=space), train, space=space)


class GroupNormAct(nn.Module):
    """GroupNorm(8, eps 1e-5) + affine + act through kernel K2; with
    ``film=(scale, shift)`` rows, K2's FiLM epilogue follows the act.
    ``train=True`` runs the plain version under autograd instead.  Output in
    the input's dtype (the compute dtype); ``gamma``/``beta`` and the
    statistics fp32.  K2 and its plain version apply the activation before
    rounding, as the Pallas kernel does; the training forward rounds first,
    as JAX's XLA path (``pallas_gn=False``) does."""

    def __init__(self, channels: int, act: str = "relu",
                 num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.act, self.num_groups, self.eps = act, num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, film=None, train: bool = False, space=None):
        """``space``: the statistics over the height shards of that space
        axis (the plain sharded GroupNorm under autograd with ``train``,
        K2's sharded launches without)."""
        if space is not None and space.collective:
            if train:
                y = groupnorm_act_plain_sharded(
                    space, to_nhwc(x), self.weight, self.bias, self.num_groups, self.eps,
                    self.act, film, act_after_rounding=True)
            else:
                y = fused_groupnorm_act_sharded(space, to_nhwc(x), self.weight, self.bias,
                                                self.num_groups, self.eps, self.act, film)
        elif train:
            y = groupnorm_act_plain(to_nhwc(x), self.weight, self.bias, self.num_groups,
                                    self.eps, self.act, film, act_after_rounding=True)
        else:
            y = fused_groupnorm_act(to_nhwc(x), self.weight, self.bias, self.num_groups,
                                    self.eps, self.act, film)
        return to_nchw(y)


class EmbedFC(nn.Module):
    """Linear -> erf-GELU -> Linear on the input flattened to
    ``(-1, input_dim)`` (``blocks.py:333-364``), in the compute dtype (the
    input, a normalised time or a context, is cast to it first)."""

    def __init__(self, input_dim: int, emb_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim = input_dim
        self.fc1 = Linear(input_dim, emb_dim, compute_dtype=compute_dtype)
        self.fc2 = Linear(emb_dim, emb_dim, compute_dtype=compute_dtype)

    def forward(self, x):
        x = x.reshape(-1, self.input_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))
