"""Task losses and contrastive scores (counterpart of ``valor_tpu/tasks/losses.py``).

``labels == -1`` marks ignored positions.  The reductions run in fp32 on
whatever dtype the logits and features come in, as the JAX functions do with
``preferred_element_type=float32``.  ``fine_score_chunked`` and
``fine_score_gallery`` (the retrieval-evaluation path and its kernel) and the
QA-weighted cross entropy are not ported yet.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


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
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def contrastive_loss(score_matrix: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Bidirectional InfoNCE over the diagonal of ``score_matrix / temp``."""
    s = score_matrix.float() / temp
    loss1 = -torch.diagonal(torch.log_softmax(s, dim=1))
    loss2 = -torch.diagonal(torch.log_softmax(s, dim=0))
    return 0.5 * (loss1.mean() + loss2.mean())


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
    wa = torch.softmax(torch.where(mask_a > 0, weight_a.float(), torch.full_like(mask_a, NEG_INF)), -1)
    wb = torch.softmax(torch.where(mask_b > 0, weight_b.float(), torch.full_like(mask_b, NEG_INF)), -1)
    logits = torch.einsum("atd,bvd->abtv", feat_a.float(), feat_b.float())
    logits = logits * mask_a[:, None, :, None] * mask_b[None, :, None, :]
    a2b = torch.einsum("abt,at->ab", torch.amax(logits, dim=-1), wa)
    b2a = torch.einsum("abv,bv->ab", torch.amax(logits, dim=-2), wb)
    return 0.5 * (a2b + b2a)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
