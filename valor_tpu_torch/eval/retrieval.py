"""Retrieval evaluation: score matrix -> recall / median / mean ranks.

The port's own copy of ``valor_tpu/eval/retrieval.py`` (numpy only).
reference: test.py:249-318 (validate_ret) + test.py:685-775
(compute_metric_ret + dual-softmax rescoring).  Conventions reproduced:

  * the primary ("forward") direction ranks the gallery per text query;
    `forward_ravg` = (R1+R5+R10)/3 over the forward direction only,
  * the backward (gallery -> best text) direction is reported only when
    `evaluate_ret_text` is set (test.py:740-766),
  * dual-softmax rescoring multiplies the score matrix by a
    temperature-scaled softmax over the opposing axis times its length
    (test.py:685-712), using the model's contrastive temperature.

The score matrix is computed on the device (fp32); ranking happens in numpy
on the host: O(n^2 log n) on a few thousand items, small next to encoding.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def dual_softmax_forward(score: np.ndarray, temp: float) -> np.ndarray:
    s = np.asarray(score, np.float64)
    e = np.exp((s - s.max(axis=0, keepdims=True)) / temp)
    return np.asarray(s * (e / e.sum(axis=0, keepdims=True)) * s.shape[0], np.float32)


def dual_softmax_backward(score: np.ndarray, temp: float) -> np.ndarray:
    s = np.asarray(score, np.float64)
    e = np.exp((s - s.max(axis=1, keepdims=True)) / temp)
    return np.asarray(s * (e / e.sum(axis=1, keepdims=True)) * s.shape[1], np.float32)


def _forward_ranks(score: np.ndarray, ids: Sequence, ids_txt: Sequence) -> np.ndarray:
    gal_index = {g: i for i, g in enumerate(ids)}
    order = np.argsort(-score, axis=1)
    ranks = np.empty(score.shape[0], np.int64)
    for t in range(score.shape[0]):
        correct = gal_index[ids_txt[t]]
        ranks[t] = int(np.where(order[t] == correct)[0][0])
    return ranks


def _backward_ranks(score: np.ndarray, ids: Sequence, ids_txt: Sequence) -> np.ndarray:
    order = np.argsort(-score, axis=0)  # rank texts per gallery item
    ranks: List[int] = []
    for g, gid in enumerate(ids):
        gt = [t for t, tid in enumerate(ids_txt) if tid == gid]
        if not gt:
            continue
        pos = {t: r for r, t in enumerate(order[:, g])}
        ranks.append(min(pos[t] for t in gt))
    return np.asarray(ranks, np.int64)


def _stats(ranks: np.ndarray, prefix: str) -> Dict[str, float]:
    n = max(len(ranks), 1)
    r1 = 100.0 * float((ranks < 1).sum()) / n
    r5 = 100.0 * float((ranks < 5).sum()) / n
    r10 = 100.0 * float((ranks < 10).sum()) / n
    # medianR follows torch.median semantics (reference test.py:735):
    # the LOWER of the two middle ranks for even-length vectors, where
    # np.median would average them (a 0.5 medianR divergence on every
    # even-sized gallery otherwise).
    median = float(np.sort(ranks)[(len(ranks) - 1) // 2] + 1) if len(ranks) else float("nan")
    return {
        f"{prefix}_r1": round(r1, 1),
        f"{prefix}_r5": round(r5, 1),
        f"{prefix}_r10": round(r10, 1),
        f"{prefix}_ravg": round((r1 + r5 + r10) / 3, 1),
        f"{prefix}_medianR": median,
        f"{prefix}_meanR": float(ranks.mean() + 1) if len(ranks) else float("nan"),
    }


def retrieval_report(
    score: np.ndarray,  # [n_txt, n_gallery]
    ids: Sequence,
    ids_txt: Sequence,
    dual_softmax: bool = False,
    temp: float = 0.07,
    evaluate_ret_text: bool = False,
) -> Dict[str, float]:
    score = np.asarray(score, np.float32)
    fwd_score = dual_softmax_forward(score, temp) if dual_softmax else score
    out = _stats(_forward_ranks(fwd_score, ids, ids_txt), "forward")
    out["ravg"] = out["forward_ravg"]
    if evaluate_ret_text:
        bwd_score = dual_softmax_backward(score, temp) if dual_softmax else score
        out.update(_stats(_backward_ranks(bwd_score, ids, ids_txt), "backward"))
    return out


# kept for symmetric reporting / tests
def rank_metrics(score, ids, ids_txt, direction="t2v") -> Dict[str, float]:
    score = np.asarray(score, np.float32)
    if direction == "t2v":
        ranks = _forward_ranks(score, ids, ids_txt)
    else:
        ranks = _backward_ranks(score, ids, ids_txt)
    s = _stats(ranks, "x")
    return {
        "r1": s["x_r1"],
        "r5": s["x_r5"],
        "r10": s["x_r10"],
        "medianR": s["x_medianR"],
        "meanR": s["x_meanR"],
    }


def qa_accuracy(predictions: Sequence[str], answers: Sequence) -> float:
    """Exact-match accuracy; multi-reference answers count any match
    (reference: test.py:44-133 validate_qa)."""
    hit = 0
    for pred, ans in zip(predictions, answers):
        if isinstance(ans, (list, tuple)):
            hit += int(any(pred == a for a in ans))
        else:
            hit += int(pred == ans)
    return round(100.0 * hit / max(len(predictions), 1), 2)
