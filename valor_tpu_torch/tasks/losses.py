"""Task losses and contrastive scores (counterpart of ``valor_tpu/tasks/losses.py``).

``labels == -1`` marks ignored positions.  The reductions run in fp32 on
whatever dtype the logits and features come in, as the JAX functions do with
``preferred_element_type=float32``.  Retrieval evaluation scores its gallery
with ``fine_score_gallery``: the hand-written fine-score kernel on the card,
``fine_score_chunked`` on the CPU; training scores its batch with
``fine_score``, which autograd differentiates (the kernel is forward-only).
The caption and QA losses are plain ops: no Pallas kernel computes them in
the JAX package either.  In a training step across ranks their normalisers are
global (``parallel/collectives.py:sharded_mean``) and the contrastive loss takes
this rank's rows and columns of the global score matrix
(``sharded_contrastive_loss``), as the JAX package computes each over the global
batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from valor_tpu_torch.ops.kernels import fine_score as K2
from valor_tpu_torch.parallel import collectives as C


def masked_cross_entropy(
    logits: torch.Tensor,  # [..., V]
    labels: torch.Tensor,  # [...], -1 = ignore
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean CE over the positions where labels != -1 (a scalar); with label
    smoothing, the KL against (1 - eps) one-hot + eps / (V - 1) off-target,
    without its constant entropy terms."""
    vocab = logits.shape[-1]
    valid = (labels != -1).float()
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - tgt.float()
    if label_smoothing > 0.0:
        smooth = label_smoothing / (vocab - 1)
        mean_logp = logits.float().sum(-1) - vocab * lse
        nll = (1.0 - label_smoothing) * nll - smooth * (mean_logp + nll)
    return C.sharded_mean((nll * valid).sum(), valid.sum())


def qa_weighted_cross_entropy(
    logits: torch.Tensor,  # [B, N, V]
    labels: torch.Tensor,  # [B, N], -1 = ignore
    answer_weights: Optional[torch.Tensor] = None,  # [B]
    n_questions: Optional[int] = None,
) -> torch.Tensor:
    """Each row's mean CE over its valid tokens; with ``answer_weights`` (tiled
    multi-answer rows) the weighted sum over rows divided by the question
    count (``n_questions``, or the row count when it is not given), else the
    plain mean over rows."""
    valid = (labels != -1).float()
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - tgt.float()
    per_row = (nll * valid).sum(-1) / valid.sum(-1).clamp_min(1.0)
    if answer_weights is not None:
        denom = float(n_questions) if n_questions else per_row.shape[0]
        return C.sharded_mean((per_row * answer_weights.float()).sum(), denom)
    return C.sharded_mean(per_row.sum(), per_row.shape[0])


def contrastive_loss(score_matrix: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Bidirectional InfoNCE over the diagonal of ``score_matrix / temp``."""
    s = score_matrix.float() / temp
    loss1 = -torch.diagonal(torch.log_softmax(s, dim=1))
    loss2 = -torch.diagonal(torch.log_softmax(s, dim=0))
    return 0.5 * (loss1.mean() + loss2.mean())


def sharded_contrastive_loss(rows: torch.Tensor, cols: torch.Tensor, temp: torch.Tensor,
                             offset: int) -> torch.Tensor:
    """:func:`contrastive_loss` of a data-parallel step, as this rank's
    share: ``rows`` [n, N] scores this rank's n queries against the N items of
    the gathered batch, ``cols`` [N, n] every query against this rank's items,
    whose pairs sit at ``offset`` in the gathered batch.  The mean of the
    data ranks' shares is the loss over the global score matrix."""
    n, n_all = rows.shape
    i = torch.arange(n, device=rows.device)
    loss1 = -torch.log_softmax(rows.float() / temp, dim=1)[i, i + offset]
    loss2 = -torch.log_softmax(cols.float() / temp, dim=0)[i + offset, i]
    return C.axis_size() * 0.5 * (loss1.sum() + loss2.sum()) / n_all


def coarse_score(feat_a: torch.Tensor, feat_b: torch.Tensor) -> torch.Tensor:
    """[A, D] x [B, D] -> [A, B] in fp32 (features pre-normalised)."""
    return torch.matmul(feat_a.float(), feat_b.float().t())


def fine_score(
    feat_a: torch.Tensor,  # [A, T, D]
    feat_b: torch.Tensor,  # [B, V, D]
    mask_a: torch.Tensor,  # [A, T] {0, 1}
    mask_b: torch.Tensor,  # [B, V]
    weight_a: torch.Tensor,  # [A, T] raw logits
    weight_b: torch.Tensor,  # [B, V]
) -> torch.Tensor:
    """Token-wise fine-grained similarity [A, B]: token weights softmaxed over
    the valid tokens, all token pairs' dot products (masked), the max over
    each side's tokens, then the weighted sums averaged."""
    mask_a = mask_a.float()
    mask_b = mask_b.float()
    wa, wb = K2.masked_softmax(weight_a, mask_a), K2.masked_softmax(weight_b, mask_b)
    logits = torch.einsum("atd,bvd->abtv", feat_a.float(), feat_b.float())
    logits = logits * mask_a[:, None, :, None] * mask_b[None, :, None, :]
    a2b = torch.einsum("abt,at->ab", torch.amax(logits, dim=-1), wa)
    b2a = torch.einsum("abv,bv->ab", torch.amax(logits, dim=-2), wb)
    return 0.5 * (a2b + b2a)


def fine_score_chunked(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b,
                       chunk: int = 100) -> torch.Tensor:
    """:func:`fine_score` over chunks of ``chunk`` rows of A, which bounds the
    [chunk, B, T, V] logits; A is padded with masked zero rows up to a multiple
    of ``chunk`` and the result sliced back, as the JAX ``lax.map`` does."""
    a = feat_a.shape[0]
    pad = (-a) % chunk
    if pad:
        feat_a = torch.cat([feat_a, feat_a.new_zeros((pad,) + tuple(feat_a.shape[1:]))])
        mask_a = torch.cat([mask_a, mask_a.new_zeros((pad, mask_a.shape[1]))])
        weight_a = torch.cat([weight_a, weight_a.new_zeros((pad, weight_a.shape[1]))])
    out = [fine_score(feat_a[i : i + chunk], feat_b, mask_a[i : i + chunk], mask_b,
                      weight_a[i : i + chunk], weight_b)
           for i in range(0, feat_a.shape[0], chunk)]
    if not out:
        return torch.zeros((0, feat_b.shape[0]), dtype=torch.float32, device=feat_b.device)
    return torch.cat(out)[:a]


def fine_score_gallery(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b,
                       chunk: int = 100) -> torch.Tensor:
    """The evaluation gallery's fine score: CUDA tensors go through the fused
    kernel (``ops/kernels/fine_score.py``), which never holds the [A, B, T, V]
    logits, so the gallery needs no slicing; CPU tensors through
    :func:`fine_score_chunked`."""
    if feat_a.device.type == "cuda":
        return K2.fine_score_fused(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b)
    return fine_score_chunked(feat_a, feat_b, mask_a, mask_b, weight_a, weight_b, chunk)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
