"""Fused fine-grained retrieval score: the hand-written Hopper kernel and its plain version.

``fine_score_fused`` launches the kernel of ``csrc/fine_score.cu`` (the port of the
TPU kernel ``valor_tpu/ops/pallas/fine_score.py:_make_kernel``) for CUDA tensors,
and computes ``fine_score_fused_plain`` for CPU tensors.  Both compute what the
JAX ``fine_score_fused`` computes: the token weights softmaxed over the valid
tokens (``masked_softmax``, which ``tasks/losses.fine_score`` uses too: ``NEG_INF``
on the masked ones, as the JAX ``tasks/losses.py``, so a row with no valid token
gets a uniform softmax, not NaN), masked tokens adding a literal 0 to both maxes
(the kernel zeroes their features, the plain version their dot products), every token pair's dot product
accumulated in fp32, the max over each side's tokens, the weighted sums, and
their average.  Neither ever holds the whole [A, B, T, V] logits tensor.  The
kernel is forward-only, as the TPU kernel is.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches made by ``fine_score_fused`` in this process
LAUNCHES = 0

NEG_INF = -1e9
MAX_TOKENS = 128
MAX_DIM = 4096
_FEAT_DTYPES = (torch.float32, torch.bfloat16)
_PLAIN_LOGITS = 1 << 26  # logits a chunk of the plain version holds (256 MB in fp32)
_FN = None


def masked_softmax(weight: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fp32 softmax over the last dim of ``weight`` where ``mask > 0``."""
    mask = mask.float()
    return torch.softmax(torch.where(mask > 0, weight.float(), torch.full_like(mask, NEG_INF)), -1)


def _check(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b) -> None:
    if feat_a.dim() != 3 or feat_b.dim() != 3 or feat_a.shape[2] != feat_b.shape[2]:
        raise ValueError(f"fine_score: features must be [A, T, D] and [B, V, D], got "
                         f"{tuple(feat_a.shape)} and {tuple(feat_b.shape)}")
    a_n, t_n, d = feat_a.shape
    b_n, v_n, _ = feat_b.shape
    if not (1 <= t_n <= MAX_TOKENS and 1 <= v_n <= MAX_TOKENS and 1 <= d <= MAX_DIM):
        raise ValueError(f"fine_score: T {t_n}, V {v_n} must be in [1, {MAX_TOKENS}] and "
                         f"D {d} in [1, {MAX_DIM}]")
    if feat_a.dtype not in _FEAT_DTYPES or feat_b.dtype != feat_a.dtype:
        raise TypeError(f"fine_score: features {feat_a.dtype} and {feat_b.dtype}; takes both "
                        "float32 or both bfloat16")
    for name, t, shape in (("mask_a", mask_a, (a_n, t_n)), ("mask_b", mask_b, (b_n, v_n)),
                           ("weight_a", weight_a, (a_n, t_n)), ("weight_b", weight_b, (b_n, v_n))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"fine_score: {name} must be float32 {list(shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    args = (feat_a, feat_b, mask_a, mask_b, weight_a, weight_b)
    if any(t.device != feat_a.device for t in args):
        raise ValueError("fine_score: every input must be on one device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("fine_score: every input must be contiguous")
    if feat_a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fine_score: no kernel for device {feat_a.device}")


def fine_score_fused_plain(
    feat_a: torch.Tensor,  # [A, T, D]
    feat_b: torch.Tensor,  # [B, V, D]
    mask_a: torch.Tensor,  # [A, T] {0, 1}
    mask_b: torch.Tensor,  # [B, V]
    weight_a: torch.Tensor,  # [A, T] raw logits
    weight_b: torch.Tensor,  # [B, V]
) -> torch.Tensor:
    """The kernel's function in plain torch: ``tasks/losses.fine_score_chunked``
    in fp32, over chunks of A small enough that a chunk's [rows, B, T, V]
    logits stay under 2**26 values -> [A, B] f32."""
    from valor_tpu_torch.tasks.losses import fine_score_chunked

    _check(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b)
    a_n, t_n, _ = feat_a.shape
    b_n, v_n, _ = feat_b.shape
    chunk = max(1, min(a_n, _PLAIN_LOGITS // max(1, b_n * t_n * v_n)))
    return fine_score_chunked(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b, chunk)


def _kernel():
    global _FN
    if _FN is None:
        from valor_tpu_torch.ops.kernels._build import load_library

        fn = load_library("fine_score").valor_fine_score
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fine_score_fused(
    feat_a: torch.Tensor,  # [A, T, D] float32 or bfloat16
    feat_b: torch.Tensor,  # [B, V, D] the same dtype
    mask_a: torch.Tensor,  # [A, T] float32 {0, 1}
    mask_b: torch.Tensor,  # [B, V] float32
    weight_a: torch.Tensor,  # [A, T] float32 raw logits
    weight_b: torch.Tensor,  # [B, V] float32
) -> torch.Tensor:
    """The fine score [A, B] in fp32 (``valor_tpu/ops/pallas/fine_score.py:fine_score_fused``).

    CUDA tensors go through the kernel on the current stream, without
    synchronising; CPU tensors through :func:`fine_score_fused_plain`.  Takes
    1 <= T, V <= 128 and 1 <= D <= 4096; A or B = 0 gives an empty result."""
    global LAUNCHES
    _check(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b)
    if feat_a.device.type == "cpu":
        return fine_score_fused_plain(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b)
    a_n, t_n, d = feat_a.shape
    b_n, v_n, _ = feat_b.shape
    out = torch.empty((a_n, b_n), dtype=torch.float32, device=feat_a.device)
    if a_n == 0 or b_n == 0:
        return out
    wa, wb = masked_softmax(weight_a, mask_a), masked_softmax(weight_b, mask_b)
    fa = feat_a * mask_a.to(feat_a.dtype)[:, :, None]
    fb = feat_b * mask_b.to(feat_b.dtype)[:, :, None]
    err = _kernel()(
        fa.data_ptr(), fb.data_ptr(), wa.data_ptr(), wb.data_ptr(), out.data_ptr(),
        a_n, b_n, t_n, v_n, d, int(feat_a.dtype == torch.bfloat16),
        torch.cuda.current_stream(feat_a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fine_score: kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
