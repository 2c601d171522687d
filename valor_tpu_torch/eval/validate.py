"""Evaluation of the port (counterpart of part of ``valor_tpu/eval/validate.py``).

Retrieval (``validate_ret``): collect the contrastive features of every
evaluation batch through ``eval_step``, keep them on the device in fp32, score
the whole gallery of each modality group (``retrieval_scores``: the fine groups
through ``tasks.losses.fine_score_gallery``, which on the card is the fused
fine-score kernel), and rank on the host (``eval/retrieval.py``).  This slice
runs in one process: ``_gather_eval_features`` concatenates, and the
cross-process gather waits for the multi-GPU slice.  ``validate_cap``,
``validate_qa`` and ``validate_pt`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from valor_tpu_torch.core.tasks import TaskSpec
from valor_tpu_torch.eval.retrieval import retrieval_report
from valor_tpu_torch.models.valor import EOS_TOKEN
from valor_tpu_torch.tasks import losses as L

# query/gallery modality split per group (reference test.py:290-377: rows x
# columns of each score matrix; a side of several modalities concatenates their
# features along the token axis)
_GROUP_SIDES = {
    "tv": ("t", "v"),
    "ta": ("t", "a"),
    "tva": ("t", "va"),
    "va": ("v", "a"),
    "vta": ("v", "ta"),
    "atv": ("a", "tv"),
}

_FEATURE_KEYS = ("feat_t", "feat_v", "feat_a", "txt_tokens")


def decode_sequence(tokenizer, seq: np.ndarray, eos: int = EOS_TOKEN) -> str:
    """ids -> sentence, stopping at EOS, merging wordpieces."""
    toks: List[int] = []
    for t in seq.tolist():
        if t == eos:
            break
        toks.append(int(t))
    return tokenizer.decode(toks)


@torch.no_grad()
def retrieval_scores(model, feats: Dict[str, Any], group: str, contra_type: str) -> torch.Tensor:
    """The whole gallery's score matrix of one modality group, fp32 on the
    features' device.

    Fine mode takes every group the task grammar accepts, the audio<->video
    directions included (va / vta / atv); coarse mode takes tv / ta / tva, the
    groups the reference's coarse branch implements (test.py:379-401)."""
    ft, fv, fa = feats.get("feat_t"), feats.get("feat_v"), feats.get("feat_a")
    txt = feats.get("txt_tokens")
    if contra_type == "coarse":
        if group == "tv":
            return L.coarse_score(ft, fv)
        if group == "ta":
            return L.coarse_score(ft, fa)
        if group == "tva":
            if model.cfg.late_fusion:
                return L.coarse_score(ft, fv) + L.coarse_score(ft, fa)
            # early fusion: the learned va_fusion over the concatenated features
            return L.coarse_score(ft, L.l2_normalize(model.va_fusion(torch.cat([fv, fa], -1))))
        raise ValueError(f"coarse retrieval does not support group {group!r} "
                         "(reference test.py coarse branch: tv/ta/tva only)")

    def part(name: str):
        if name == "t":
            return ft, (txt != 0).float(), model.text_fine_weight(ft).float()
        f, weight = (fv, model.video_fine_weight) if name == "v" else (fa, model.audio_fine_weight)
        return f, torch.ones(f.shape[:2], device=f.device), weight(f).float()

    def side(names: str):
        ps = [part(n) for n in names]
        if len(ps) == 1:
            return ps[0]
        return tuple(torch.cat([p[i] for p in ps], dim=1) for i in range(3))

    if group not in _GROUP_SIDES:
        raise ValueError(group)
    if group == "tva" and model.cfg.late_fusion:
        # reference test.py:300-309: late fusion sums the per-modality fine
        # scores with unit weights
        t, v, a = part("t"), part("v"), part("a")
        ones = lambda p: torch.ones_like(p[2])  # noqa: E731
        return (L.fine_score_gallery(t[0], v[0], t[1], v[1], ones(t), ones(v))
                + L.fine_score_gallery(t[0], a[0], t[1], a[1], ones(t), ones(a)))
    qn, gn = _GROUP_SIDES[group]
    if len(gn) > 1 and "t" in gn:
        # a concatenated text+media gallery (vta/atv) needs one caption per
        # item (the reference's torch.cat has the same constraint, test.py:355/364)
        sizes = {n: feats[f"feat_{n}"].shape[0] for n in gn}
        if len(set(sizes.values())) > 1:
            raise ValueError(f"group {group!r} needs aligned per-item features, got rows {sizes}")
    q, g = side(qn), side(gn)
    if group == "tva" and model.cfg.fineweight_type == "none":
        # reference test.py:315-318: unit weights on both sides
        q = (q[0], q[1], torch.ones_like(q[2]))
        g = (g[0], g[1], torch.ones_like(g[2]))
    return L.fine_score_gallery(q[0], g[0], q[1], g[1], q[2], g[2])


def _gather_eval_features(
    feats_all: Dict[str, List[torch.Tensor]], ids: List, ids_txt: List
) -> Tuple[Dict[str, Optional[torch.Tensor]], List, List]:
    """The per-batch features of each key concatenated (None where no batch
    had them), and the id lists.

    One process holds the whole gallery here.  The JAX package also merges
    the shards of every process (ragged arrays, id lists, and one agreed key
    set so that a process with an empty shard enters every collective); that
    cross-process gather comes with the multi-GPU slice."""
    feats = {k: (torch.cat(v) if v else None) for k, v in feats_all.items()}
    return feats, list(ids), list(ids_txt)


def validate_ret(
    model, eval_step, loader, task: TaskSpec, contra_type: str,
    dual_softmax: bool = False, evaluate_ret_text: bool = False,
) -> Dict[str, float]:
    """Retrieval report of ``task``'s groups over the batches of ``loader``
    (collate-layout dicts with ``ids`` and, for text queries, ``ids_txt``):
    ``{group}_forward_r1`` ... ``{group}_forward_meanR`` per group, and
    ``ravg``, the first group's.  ``eval_step(model, batch, task)`` gives each
    batch's features (``train/step.py:eval_step``)."""
    feats_all: Dict[str, List[torch.Tensor]] = {k: [] for k in _FEATURE_KEYS}
    ids: List = []
    ids_txt: List = []
    for batch in loader:
        batch = dict(batch)
        batch_ids = batch.pop("ids", None)
        batch_ids_txt = batch.pop("ids_txt", None)
        batch.pop("sample_num", None)
        out = eval_step(model, batch, task)
        for k in _FEATURE_KEYS:
            if out.get(k) is not None:
                feats_all[k].append(out[k] if k == "txt_tokens" else out[k].float())
        if batch_ids is not None:
            ids.extend(batch_ids)
        if batch_ids_txt is not None:
            ids_txt.extend(batch_ids_txt)
    feats, ids, ids_txt = _gather_eval_features(feats_all, ids, ids_txt)
    temp = float(model.temperature().detach())
    report: Dict[str, float] = {}
    for g in task.contra_groups:
        score = retrieval_scores(model, feats, g, contra_type).cpu().numpy()
        # text-query groups rank the item gallery per caption row; the
        # audio/video-query groups (va/vta/atv) are item -> item, so rows carry
        # item ids (reference test.py:341-377)
        row_ids = (ids_txt or ids) if g[0] == "t" else ids
        r = retrieval_report(score, ids, row_ids, dual_softmax, temp, evaluate_ret_text)
        report.update({f"{g}_{k}": v for k, v in r.items()})
    if task.contra_groups:
        report["ravg"] = report[f"{task.contra_groups[0]}_ravg"]
    return report


def best_metric_name(task: TaskSpec) -> Optional[str]:
    return {"ret": "ravg", "cap": "CIDEr", "qa": "accuracy", "pt": None}[task.family]
