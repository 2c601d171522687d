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
_F32, _BF16 = torch.float32, torch.bfloat16
_DTYPES = (_F32, _BF16)
_DEVICES = ("cpu", "cuda")
_FN = None
_BWD = None
_STREAM = None
_BWD_INFO = {}  # (device, cols, x bf16, dy bf16, pointers aligned) -> bwd_info
_BWD_GRID = {}  # (device, rows, cols, x bf16, dy bf16, pointers aligned) -> _bwd_grid_for


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


def _reject(x, w, b, out_dtype) -> None:
    """Raise the error that names what of ``x``, ``w``, ``b`` and ``out_dtype``
    the kernels do not take; returns where nothing is wrong."""
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


def _check(x, w, b, out_dtype) -> None:
    """What ``_reject`` checks, as one expression over the tensors' attributes:
    a call that passes costs no loop and builds no message."""
    c = x.shape[-1] if x.ndim else 0
    dev = x.device
    if not (
        0 < c <= MAX_COLS and x.dtype in _DTYPES and out_dtype in _DTYPES
        and w.dtype is _F32 and b.dtype is _F32 and w.shape == b.shape == (c,)
        and w.device == dev and b.device == dev and dev.type in _DEVICES
        and x.is_contiguous() and w.is_contiguous() and b.is_contiguous()
    ):
        _reject(x, w, b, out_dtype)


def _raw_stream(x) -> int:
    """The current CUDA stream of ``x``'s device as an int, without building a
    ``torch.cuda.Stream``."""
    global _STREAM
    if _STREAM is None:
        _STREAM = torch._C._cuda_getCurrentRawStream
    return _STREAM(x.get_device())


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


def _bwd_lib():
    """(valor_layernorm_bwd_info, valor_layernorm_bwd) of the built library."""
    global _BWD
    if _BWD is None:
        from valor_tpu_torch.ops.kernels._build import load_library

        lib = load_library("layernorm")
        info = lib.valor_layernorm_bwd_info
        info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int64)]
        info.restype = ctypes.c_int
        fn = lib.valor_layernorm_bwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _BWD = info, fn
    return _BWD


def bwd_info(
    device: int, cols: int, x_bf16: int, dy_bf16: int, aligned: bool
) -> Tuple[int, int, int]:
    """(row groups a block, blocks resident at once, launches a call) of the
    backward kernel for this device, width, types and alignment, from the
    library; asked once a key and cached, so that a call inside a CUDA graph
    capture asks the runtime nothing."""
    key = (device, cols, x_bf16, dy_bf16, aligned)
    got = _BWD_INFO.get(key)
    if got is None:
        out = (ctypes.c_int64 * 3)()
        with torch.cuda.device(device):
            err = _bwd_lib()[0](cols, x_bf16, dy_bf16, int(aligned), out)
        if err:
            raise RuntimeError(f"layernorm_bwd: the occupancy query failed with CUDA error {err}")
        got = _BWD_INFO[key] = (out[0], out[1], out[2])
    return got


def _aligned(*ptrs: int) -> bool:
    """Every pointer 16-byte aligned: with C, what ``valor_layernorm_bwd`` picks
    its kernel's vector width by."""
    return not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15


def bwd_grid(n_rows: int, groups: int, wave: int) -> Tuple[int, int]:
    """(blocks, steps) of the backward's grid for ``n_rows`` rows: each of a
    block's ``groups`` row groups takes ``steps`` rows, the fewest that keep the
    grid within one wave of ``wave`` blocks, and the blocks are as many as cover
    the rows, so none is empty.  Block b owns rows
    [b * groups * steps, (b + 1) * groups * steps)."""
    steps = -(-n_rows // (groups * wave))
    return -(-n_rows // (groups * steps)), steps


def _bwd_grid_for(dev, n, c, x_bf16, dy_bf16, aligned) -> Tuple[int, int, int]:
    """(blocks, steps, floats of dw, db and the partials) of a call, memoised by
    its key."""
    key = (dev, n, c, x_bf16, dy_bf16, aligned)
    got = _BWD_GRID.get(key)
    if got is None:
        groups, wave, _ = bwd_info(dev, c, x_bf16, dy_bf16, aligned)
        blocks, steps = bwd_grid(n, groups, wave)
        if len(_BWD_GRID) >= 4096:  # many row counts (ragged batches): start again
            _BWD_GRID.clear()
        got = _BWD_GRID[key] = (blocks, steps, (1 + blocks) * 2 * c)
    return got


def bwd_plan(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> dict:
    """The grid ``layernorm_bwd`` launches for these CUDA tensors: row groups a
    block, the wave, blocks, rows a group, partials (one [2, C] partial a block;
    none where one block is the grid) and launches."""
    c, dev = x.shape[-1], x.get_device()
    x_bf16, dy_bf16 = x.dtype is _BF16, dy.dtype is _BF16
    aligned = _aligned(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr())
    blocks, steps, _ = _bwd_grid_for(dev, x.numel() // c, c, x_bf16, dy_bf16, aligned)
    groups, wave, launches = bwd_info(dev, c, x_bf16, dy_bf16, aligned)
    return {"groups": groups, "wave": wave, "blocks": blocks, "steps": steps,
            "partials": 0 if blocks == 1 else blocks, "launches": launches}


def _fwd(x, w, b, eps, out_dtype) -> torch.Tensor:
    global LAUNCHES
    if not x.is_cuda:
        return layernorm_plain(x, w, b, eps, out_dtype)
    y = torch.empty_like(x, dtype=out_dtype)
    c = x.shape[-1]
    n = x.numel() // c
    if n == 0:
        return y
    err = (_FN or _kernel())(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, c, eps,
        x.dtype is _BF16, out_dtype is _BF16, _raw_stream(x),
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

    A CUDA tensor goes through the backward kernel on the current stream, one
    launch a call, without synchronising; a CPU tensor through
    :func:`layernorm_bwd_plain`."""
    global LAUNCHES_BWD
    _check(x, w, w, x.dtype)
    if dy.shape != x.shape or dy.dtype not in _DTYPES or dy.device != x.device:
        raise TypeError(f"layernorm_bwd: dy {dy.dtype} {tuple(dy.shape)} on {dy.device} "
                        f"for x {tuple(x.shape)} on {x.device}")
    if not dy.is_contiguous():
        raise ValueError("layernorm_bwd: dy must be contiguous")
    if not x.is_cuda:
        return layernorm_bwd_plain(x, w, eps, dy)
    c = x.shape[-1]
    n = x.numel() // c
    dx = torch.empty_like(x)
    if n == 0:
        return dx, w.new_zeros(c), w.new_zeros(c)
    xp, wp, gp, dxp = x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr()
    x_bf16, dy_bf16 = x.dtype is _BF16, dy.dtype is _BF16
    aligned = _aligned(xp, wp, gp, dxp)
    dev = x.get_device()
    blocks, steps, floats = _BWD_GRID.get((dev, n, c, x_bf16, dy_bf16, aligned)) or \
        _bwd_grid_for(dev, n, c, x_bf16, dy_bf16, aligned)
    out = w.new_empty(floats)  # dw, db, then the partials
    op = out.data_ptr()
    err = (_BWD or _bwd_lib())[1](
        xp, wp, gp, dxp, op, op + 4 * c, op + 8 * c, n, c, eps, x_bf16, dy_bf16, blocks, steps,
        _raw_stream(x),
    )
    if err:
        raise RuntimeError(f"layernorm_bwd: kernel launch failed with CUDA error {err}")
    LAUNCHES_BWD += 1
    return dx, out[:c], out[c:2 * c]


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
