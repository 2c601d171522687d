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

The kernel runs on the tensor cores: bf16 features as bf16 products, fp32
features as 3xTF32 (``tf32_split``).  ``fine_score_3xtf32_emulated`` is that
arithmetic in plain torch, beside the plain version: it shows on the CPU why
three TF32 products hold the 1e-5 tolerance and one does not, and nothing on
the main path calls it.
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
_LAYOUT_KEYS = ("ta", "tb", "rows", "cols", "a_tiles", "b_tiles", "d_pad", "scratch_bytes", "read_bytes")
_LIB = None


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


def layout(a_n: int, b_n: int, t_n: int, v_n: int, d: int, bf16: bool) -> dict:
    """The kernel's tiles and its scratch, from the kernel's own source
    (``valor_fine_score_layout``; builds it on first use): ``ta`` whole query
    items and ``tb`` whole gallery items a tile, the ``rows`` and ``cols``
    they fill, the tiles along A and B, D padded (``d_pad``), the bytes of the
    packed operands (``scratch_bytes``) and the bytes that the product's tiles
    copy from them in all (``read_bytes``)."""
    out = (ctypes.c_longlong * len(_LAYOUT_KEYS))()
    err = _library().valor_fine_score_layout(a_n, b_n, t_n, v_n, d, int(bool(bf16)), out)
    if err:
        raise ValueError(f"fine_score: no layout for A {a_n}, B {b_n}, T {t_n}, V {v_n}, D {d}")
    return dict(zip(_LAYOUT_KEYS, out))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest even,
    on its int32 view; inf and NaN as they are: the pack's rounding."""
    u = x.float().contiguous().view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    r = torch.where(finite, (u + 0xFFF + ((u >> 13) & 1)) & -8192, u)
    return r.view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` with hi = tf32(x) and lo = tf32(x - hi): x = hi + lo to
    about 2**-22 relative, each part exact in a TF32 product."""
    hi = tf32_round(x)
    return hi, torch.where(torch.isfinite(hi), tf32_round(x.float() - hi), torch.zeros_like(hi))


def fine_score_3xtf32_emulated(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b,
                               terms: int = 3) -> torch.Tensor:
    """The kernel's fp32 arithmetic in plain torch: masked features split by
    :func:`tf32_split`, logits hi.hi + hi.lo + lo.hi (``terms=3``) or hi.hi
    alone (``terms=1``, a single TF32 product), each product exact in fp32 and
    summed in fp32, then the plain version's maxes and weighted sums -> [A, B]."""
    _check(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b)
    wa, wb = masked_softmax(weight_a, mask_a), masked_softmax(weight_b, mask_b)
    ha, la = tf32_split(feat_a.float() * mask_a[:, :, None])
    hb, lb = tf32_split(feat_b.float() * mask_b[:, :, None])
    pairs = [(ha, hb), (ha, lb), (la, hb)][:terms]
    logits = sum(torch.einsum("atd,bvd->abtv", x, y) for x, y in pairs)
    a2b = torch.einsum("abt,at->ab", torch.amax(logits, dim=-1), wa)
    b2a = torch.einsum("abv,bv->ab", torch.amax(logits, dim=-2), wb)
    return 0.5 * (a2b + b2a)


def _library():
    global _LIB
    if _LIB is None:
        from valor_tpu_torch.ops.kernels._build import load_library

        lib = load_library("fine_score")
        lib.valor_fine_score.argtypes = [
            *[ctypes.c_void_p] * 8, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.valor_fine_score.restype = ctypes.c_int
        lib.valor_fine_score_layout.argtypes = [*[ctypes.c_int] * 6, ctypes.POINTER(ctypes.c_longlong)]
        lib.valor_fine_score_layout.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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
    synchronising (the pack of both sides into a scratch tensor, then the
    product; one count of ``LAUNCHES`` a call); CPU tensors through
    :func:`fine_score_fused_plain`.  Takes 1 <= T, V <= 128 and
    1 <= D <= 4096; A or B = 0 gives an empty result."""
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
    bf16 = feat_a.dtype == torch.bfloat16
    nbytes = layout(a_n, b_n, t_n, v_n, d, bf16)["scratch_bytes"]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=feat_a.device)
    err = _library().valor_fine_score(
        feat_a.data_ptr(), feat_b.data_ptr(), mask_a.data_ptr(), mask_b.data_ptr(),
        wa.data_ptr(), wb.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes,
        a_n, b_n, t_n, v_n, d, int(bf16), torch.cuda.current_stream(feat_a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fine_score: kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
