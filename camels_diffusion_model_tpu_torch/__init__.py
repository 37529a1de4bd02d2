"""PyTorch/CUDA port of ``camels_diffusion_model_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package imports
``torch``, numpy and the standard library only.  Module names mirror the JAX
package.  Public functions keep its NHWC layout ``(B, H, W, C)``; inside the
model, activations are NCHW tensors in ``torch.channels_last`` memory, so the
NHWC view that the hand-written kernels take is free.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``, and
raise when CUDA is absent.  Those that run the model (``cli.serve``, the
likelihood passes, the trainer) run it inside :func:`fp32_math`: whatever
stays fp32 without TF32, and bf16 matmuls summed in fp32.  The model
computes in fp32, or in bf16 with ``ContextUnet(dtype=torch.bfloat16)``
(``models/context_unet.py``).  On a CPU tensor each kernel wrapper runs
its plain PyTorch version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises RuntimeError when CUDA is requested (or defaulted to) and absent;
    the CPU is used only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; this entry point runs on the GPU unless "
            "the caller passes device='cpu'"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def fp32_math():
    """Run the block with fp32 sums: cuDNN convolutions and cuBLAS matmuls
    with TF32 off (torch lets cuDNN use TF32 by default, about three decimal
    digits), and cuBLAS's bf16 matmuls without reduced-precision reductions
    (on by default; the JAX package's bf16 dense layers sum in fp32).
    Restores the caller's three flags on exit; usable as a decorator."""
    matmul = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved
