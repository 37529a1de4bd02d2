"""Reverse-step kernel K1: CFG combine + ancestral/strided update.

Wraps ``csrc/sampler_step.cu``, the counterpart of the Pallas
``fused_p_sample_step`` (``camels_diffusion_model_tpu/ops/pallas/
sampler_step.py:34``).  One launch per reverse step of ``sample_ddpm`` and
of ``sample_ddim(sigma_mode="beta")``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,
)


def sampler_step_plain(x, eps, z, c_eps, inv_sqrt_a, sigma, guide_w=None):
    """The kernel's function in plain PyTorch.

    ``eps`` is ``(B, ...)``, or ``(2B, ...)`` stacked ``[cond; uncond]`` when
    ``guide_w`` (a float or a ``(B,)`` tensor) is given; then the guided
    ``eps_u + w * (eps_c - eps_u)`` is used (``sampler.py:137-141``).
    ``z`` may be None only when ``sigma`` is 0.
    """
    if guide_w is not None:
        eps_c, eps_u = eps.chunk(2)
        w = guide_w
        if torch.is_tensor(w):
            w = w.reshape((-1,) + (1,) * (x.dim() - 1))
        eps = eps_u + w * (eps_c - eps_u)
    out = (x - eps * c_eps) * inv_sqrt_a
    if z is not None:
        out = out + sigma * z
    return out


def fused_sampler_step(x, eps, z, c_eps: float, inv_sqrt_a: float,
                       sigma: float, guide_w=None):
    """``(x - c_eps*e)*inv_sqrt_a + sigma*z`` with ``e`` the (guided) eps.

    On CUDA tensors this launches the kernel; on CPU tensors it runs
    :func:`sampler_step_plain`.
    """
    if z is None and sigma != 0.0:
        raise ValueError("z may be omitted only when sigma == 0")
    if x.device.type == "cpu":
        return sampler_step_plain(x, eps, z, c_eps, inv_sqrt_a, sigma, guide_w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_sampler_step: unsupported device {x.device}")
    cfg = guide_w is not None
    b = x.shape[0]
    want_eps = (2 * b,) + tuple(x.shape[1:]) if cfg else tuple(x.shape)
    tensors = {"x": x, "eps": eps}
    if z is not None:
        tensors["z"] = z
    w_vec = None
    if cfg and torch.is_tensor(guide_w):
        w_vec = guide_w
        tensors["guide_w"] = w_vec
        if tuple(w_vec.shape) != (b,):
            raise ValueError(f"per-sample guide_w must be ({b},), got {tuple(w_vec.shape)}")
    for name, t in tensors.items():
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"fused_sampler_step: {name} must be a contiguous float32 "
                f"tensor on {x.device}"
            )
    if tuple(eps.shape) != want_eps:
        raise ValueError(f"eps must be {want_eps}, got {tuple(eps.shape)}")
    if z is not None and z.shape != x.shape:
        raise ValueError(f"z must be {tuple(x.shape)}, got {tuple(z.shape)}")
    out = torch.empty_like(x)
    n = x.numel()
    fn = _build.kernel("camels_sampler_step", _ARGTYPES)
    err = fn(
        x.data_ptr(), eps.data_ptr(),
        z.data_ptr() if z is not None else None,
        w_vec.data_ptr() if w_vec is not None else None,
        float(guide_w) if cfg and w_vec is None else 0.0,
        out.data_ptr(), n, n // b if b else 1, int(cfg),
        float(c_eps), float(inv_sqrt_a), float(sigma),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "camels_sampler_step")
    fused_sampler_step.launches += 1
    return out


fused_sampler_step.launches = 0
