"""Row LayerNorm, forward and backward: the hand-written Hopper kernels and their plain versions.

``layernorm`` launches the forward kernel of ``csrc/layernorm.cu`` (the port of
the TPU kernel ``valor_tpu/ops/pallas/layernorm.py:_fwd_kernel``) for a CUDA
tensor, and computes ``layernorm_plain`` for a CPU tensor.  When a gradient is
needed it goes through ``LayerNormFunction``, whose backward launches the
backward kernel (the port of ``_bwd_kernel``) on the card and computes
``layernorm_bwd_plain`` on the CPU.  Like the TPU kernel, the backward
recomputes the row statistics from ``x``: the forward saves ``x`` and ``w``
only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# kernel launches made by ``layernorm`` (forward) and ``layernorm_bwd`` in this process
LAUNCHES = 0
LAUNCHES_BWD = 0

MAX_COLS = 4096
_DTYPES = (torch.float32, torch.bfloat16)
_FN = None
_BWD = None


def layernorm_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float, out_dtype: torch.dtype
) -> torch.Tensor:
    """fp32 two-pass statistics over the last dim, cast to ``out_dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(out_dtype)


def layernorm_bwd_plain(
    x: torch.Tensor, w: torch.Tensor, eps: float, dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in ``x.dtype``, dw, db in fp32) by the TPU kernel's formula, in fp32:
    ``dx = rstd * (dy*w - mean(dy*w) - xhat * mean(dy*w*xhat))``,
    ``dw = sum(dy * xhat)``, ``db = sum(dy)`` over every row."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    g = dy.float().reshape(-1, c)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    gw = g * w.float()
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    dx = rstd * (gw - m1 - xhat * m2)
    return dx.to(x.dtype).reshape(x.shape), (g * xhat).sum(0), g.sum(0)


def _check(x, w, b, out_dtype) -> None:
    c = x.shape[-1] if x.dim() else 0
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"layernorm: last dim {c} is outside [1, {MAX_COLS}]")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"layernorm: x {x.dtype} -> {out_dtype}; takes float32 or bfloat16")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != torch.float32 or t.shape != (c,):
            raise TypeError(f"layernorm: {name} must be float32 [{c}], got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"layernorm: {name} on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("layernorm: x, w and b must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layernorm: no kernel for device {x.device}")


def _kernel():
    global _FN
    if _FN is None:
        from valor_tpu_torch.ops.kernels._build import load_library

        fn = load_library("layernorm").valor_layernorm_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_kernel():
    """(valor_layernorm_bwd_parts, valor_layernorm_bwd) of the built library."""
    global _BWD
    if _BWD is None:
        from valor_tpu_torch.ops.kernels._build import load_library

        lib = load_library("layernorm")
        parts = lib.valor_layernorm_bwd_parts
        parts.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        parts.restype = ctypes.c_int64
        fn = lib.valor_layernorm_bwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _BWD = parts, fn
    return _BWD


def _fwd(x, w, b, eps, out_dtype) -> torch.Tensor:
    global LAUNCHES
    if x.device.type == "cpu":
        return layernorm_plain(x, w, b, eps, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    c = x.shape[-1]
    n = x.numel() // c
    if n == 0:
        return y
    err = _kernel()(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, c, float(eps),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"layernorm: kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return y


def layernorm_bwd(
    x: torch.Tensor, w: torch.Tensor, eps: float, dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) of the LayerNorm of ``x`` with weight ``w`` for the output
    gradient ``dy`` (same shape as ``x``, float32 or bfloat16, contiguous).

    A CUDA tensor goes through the backward kernel on the current stream,
    without synchronising; a CPU tensor through :func:`layernorm_bwd_plain`."""
    global LAUNCHES_BWD
    _check(x, w, w, x.dtype)
    if dy.shape != x.shape or dy.dtype not in _DTYPES or dy.device != x.device:
        raise TypeError(f"layernorm_bwd: dy {dy.dtype} {tuple(dy.shape)} on {dy.device} "
                        f"for x {tuple(x.shape)} on {x.device}")
    if not dy.is_contiguous():
        raise ValueError("layernorm_bwd: dy must be contiguous")
    if x.device.type == "cpu":
        return layernorm_bwd_plain(x, w, eps, dy)
    c = x.shape[-1]
    n = x.numel() // c
    dx = torch.empty_like(x)
    dw = torch.empty(c, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    if n == 0:
        return dx, dw.zero_(), db.zero_()
    parts_fn, fn = _bwd_kernel()
    x_bf16, dy_bf16 = int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16)
    parts = parts_fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, x_bf16, dy_bf16)
    if parts <= 0:
        raise RuntimeError("layernorm_bwd: the occupancy query of the kernel failed")
    partials = torch.empty((2, parts, c), dtype=torch.float32, device=x.device)
    err = fn(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        partials.data_ptr(), n, c, float(eps), x_bf16, dy_bf16, parts,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"layernorm_bwd: kernel launch failed with CUDA error {err}")
    LAUNCHES_BWD += 1
    return dx, dw, db


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with the forward kernel forward and the backward kernel backward
    (their plain versions on the CPU).  Saves ``x`` and ``w`` only."""

    @staticmethod
    def forward(ctx, x, w, b, eps, out_dtype):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _fwd(x, w, b, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, db = layernorm_bwd(x, w, ctx.eps, dy.contiguous())
        return dx, dw, db, None, None


def layernorm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float, out_dtype: torch.dtype
) -> torch.Tensor:
    """LayerNorm over the last dim of ``x`` (float32 or bfloat16) with float32
    ``w`` and ``b``; the result has dtype ``out_dtype``.

    A CUDA tensor goes through the CUDA kernels on the current stream, without
    synchronising; a CPU tensor through the plain versions.  Where autograd
    records the call, the backward is :func:`layernorm_bwd`."""
    _check(x, w, b, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return LayerNormFunction.apply(x, w, b, eps, out_dtype)
    return _fwd(x, w, b, eps, out_dtype)
