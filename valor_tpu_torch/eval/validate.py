"""Evaluation of the port (counterpart of part of ``valor_tpu/eval/validate.py``).

Retrieval (``validate_ret``): collect the contrastive features of every
evaluation batch through ``eval_step``, keep them on the device in fp32, score
the whole gallery of each modality group (``retrieval_scores``: the fine groups
through ``tasks.losses.fine_score_gallery``, which on the card is the fused
fine-score kernel), and rank on the host (``eval/retrieval.py``).  Across
processes every rank extracts its shard and ``_gather_eval_features`` merges the
shards (ragged, an empty one included), so every rank scores the whole gallery.

Captions (``validate_cap``) and answers (``validate_qa``): generate every
batch through ``eval/generate.py:Generator``, decode to text on the host and
score the whole merged set in one call (CIDEr-D's document frequencies are
those of the set), writing the JAX package's dump files.  The ranks' shards are
merged before scoring, and rank 0 writes the dumps.  On a (data, model, pipe)
mesh the shards and merges are the batch axis's (``parallel/mesh.py``): the
model ranks of one data rank run the same batches (tensor parallelism's
all-reduces) and decode the same tokens; ``fsdp``'s parameters are gathered
once for a whole validation.  Every evaluation forward and every decode runs
the fusion stack whole on every rank, pipeline stages or not (the pipeline
engages in a training step's forward only, ``parallel/pipeline.py``): the pipe
ranks of one data rank may hold different numbers of evaluation batches, and a
pipelined forward would wait on a rank that has none.  Every rank holds every
layer, so the reports equal the JAX package's, whose evaluation forward does
pipeline (ROADMAP Queue 3, F12: a difference of schedule kept on purpose).

Pretraining (``validate_pt``): masked-token accuracies of the caption and MLM
objectives through ``eval_step``, and a retrieval recall per contrastive group;
the ranks' counters are merged.  Its masks are drawn at the shape of one
process's batch (``parallel.mesh.sampler_shard``), so every report of W ranks
equals one process's on the same data.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from valor_tpu_torch.core.logging import is_main_process
from valor_tpu_torch.core.tasks import TaskSpec
from valor_tpu_torch.eval.caption_metrics import caption_eval
from valor_tpu_torch.eval.generate import Generator
from valor_tpu_torch.eval.retrieval import qa_accuracy, retrieval_report
from valor_tpu_torch.models.valor import EOS_TOKEN
from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel.fsdp import unsharded
from valor_tpu_torch.parallel.mesh import batch_shard, sampler_shard
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


def _whole_params(fn):
    """``fn(model, ...)`` with ``fsdp``'s blocks of ``model`` gathered once
    for the whole validation (``parallel/fsdp.py:unsharded``): data ranks may
    hold different numbers of batches, so no forward gathers."""
    @functools.wraps(fn)
    def run(model, *a, **kw):
        with unsharded(model):
            return fn(model, *a, **kw)

    return run


def _gather_eval_features(
    feats_all: Dict[str, List[torch.Tensor]], ids: List, ids_txt: List, device
) -> Tuple[Dict[str, Optional[torch.Tensor]], List, List]:
    """The per-batch features of each key concatenated and merged across
    ranks (None where no rank had them), and the id lists merged, all in rank
    order (the JAX package's ``_gather_eval_features``).

    Which keys exist is agreed first, in one object gather that every rank
    runs: a rank whose shard is empty has no features, and if it skipped the
    ragged gathers that the others enter, the collectives would deadlock.  It
    enters them with zero-row tensors of the agreed shape and dtype, on
    ``device``, instead.  One process: concatenation only."""
    local = {k: (torch.cat(v) if v else None) for k, v in feats_all.items()}
    meta: Dict[str, Any] = {}
    for m in C.all_gather_objects({k: (tuple(v.shape[1:]), str(v.dtype).split(".")[-1])
                                   for k, v in local.items() if v is not None}):
        meta.update(m)
    feats: Dict[str, Optional[torch.Tensor]] = {}
    for k in feats_all:  # a fixed key order on every rank
        if k not in meta:
            feats[k] = None
            continue
        a = local[k]
        if a is None:
            shape, dtype = meta[k]
            a = torch.zeros((0,) + shape, dtype=getattr(torch, dtype), device=device)
        feats[k] = C.all_gather_ragged(a)
    return feats, C.all_gather_lists(ids), C.all_gather_lists(ids_txt)


@_whole_params
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
    feats, ids, ids_txt = _gather_eval_features(feats_all, ids, ids_txt, model.device)
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


@contextlib.contextmanager
def eval_mode(model):
    """The model in eval mode (no dropout) inside the block, its training
    mode restored after: a trainer validates the model it trains."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def _dump(path: str, payload) -> None:
    with open(path, "w") as f:
        json.dump(payload, f)


@_whole_params
def validate_cap(
    model, loader, task: TaskSpec, tokenizer, annotations: Dict[str, List[str]], *,
    caption_type: str = "unimlm", max_len: int = 30, beam_size: int = 1,
    result_dir: Optional[str] = None, step: int = 0,
    submit_format: Optional[str] = None,  # 'coco' | 'nocaps' | 'vatex'
) -> Dict[str, float]:
    """Caption report of every caption group over the batches of ``loader``
    (reference test.py:136-236): the first group's metrics under flat keys
    (``CIDEr``, ``Bleu_4``, ...: what best-checkpoint tracking reads), later
    groups' prefixed ``{g}_``.  With ``result_dir`` it writes a
    ``step_{step}_{g}.json`` dump a group, or with ``submit_format`` one
    ``submission.json`` of the first group and returns ``{}``."""
    groups = list(task.caption_groups)
    group_hyps: Dict[str, Dict[str, str]] = {g: {} for g in groups}
    generator = Generator(model)
    for batch in loader:
        ids = batch.pop("ids")
        batch.pop("ids_txt", None)
        batch.pop("sample_num", None)
        with eval_mode(model):
            out = generator.generate(batch, task.caption_groups, caption_type=caption_type,
                                     max_len=max_len, beam_size=beam_size)
        for g in groups:
            seqs = out[f"generated_sequences_{g}"].cpu().numpy()
            for id_, seq in zip(ids, seqs):
                group_hyps[g][str(id_)] = decode_sequence(tokenizer, seq)
    # merge the ranks' disjoint shards before scoring: every rank reports the
    # dataset's metrics (its best-checkpoint tracking reads them)
    for g in groups:
        merged: Dict[str, str] = {}
        for chunk in C.all_gather_objects(group_hyps[g]):
            merged.update(chunk)
        group_hyps[g] = merged
    hyps = group_hyps[groups[0]]
    if result_dir and is_main_process():
        os.makedirs(result_dir, exist_ok=True)
        submission = os.path.join(result_dir, "submission.json")
        if submit_format == "coco":
            _dump(submission, [{"image_id": int(str(i).split("_")[-1]), "caption": c}
                               for i, c in hyps.items()])
        elif submit_format == "nocaps":
            _dump(submission, [{"image_id": int(i), "caption": c} for i, c in hyps.items()])
        elif submit_format == "vatex":
            _dump(submission, dict(hyps))
        else:
            for g in groups:
                _dump(os.path.join(result_dir, f"step_{step}_{g}.json"),
                      [{"video_id": i, "caption": c} for i, c in group_hyps[g].items()])
    if submit_format:
        return {}
    report: Dict[str, float] = {}
    for gi, g in enumerate(groups):
        hy = group_hyps[g]
        scores = caption_eval(hy, {str(i): annotations[str(i)] for i in hy})
        report.update(scores if gi == 0 else {f"{g}_{k}": v for k, v in scores.items()})
    return report


@_whole_params
def validate_qa(
    model, loader, task: TaskSpec, tokenizer, answers: Optional[Dict[str, Any]] = None, *,
    caption_type: str = "unimlm", max_len: int = 10, beam_size: int = 1,
    result_dir: Optional[str] = None, step: int = 0, dset_name: str = "",
) -> Dict[str, float]:
    """Exact-match QA accuracy over the batches of ``loader`` (reference
    test.py:44-133): ``accuracy`` of the first group, ``{g}_accuracy`` of
    later ones.  Ground truths ride the batch (the QA test collate's
    ``answers``); ``answers`` ({id: ...}) is the fallback for other collates.
    With ``result_dir`` it writes ``step{N}_gt.json``, ``step{N}_{g}_pred.json``
    and, where the dataset carries question ids,
    ``step{N}_{g}_pred_submited_{dset_name}.json``."""
    groups = list(task.caption_groups)
    group_preds: Dict[str, List[str]] = {g: [] for g in groups}
    gts: List[Any] = []
    submit: List[Dict[str, Any]] = []
    generator = Generator(model)
    for batch in loader:
        ids = batch.pop("ids")
        batch_answers = batch.pop("answers", None)
        question_ids = batch.pop("question_ids", None)
        batch.pop("ids_txt", None)
        batch.pop("sample_num", None)
        # each generated row's source id, read before generate tiles the media
        tile = batch.get("tile_index")
        row_to_id = [ids[int(t)] for t in np.asarray(tile)] if tile is not None else ids
        with eval_mode(model):
            out = generator.generate(batch, task.caption_groups, caption_type=caption_type,
                                     max_len=max_len, beam_size=beam_size)
        for gi, g in enumerate(groups):
            seqs = out[f"generated_sequences_{g}"].cpu().numpy()
            for j, seq in enumerate(seqs):
                text = decode_sequence(tokenizer, seq)
                group_preds[g].append(text)
                if gi > 0:
                    continue  # the ground truths are the groups' own
                if question_ids:
                    submit.append({"question_id": question_ids[j], "answer": text})
                if batch_answers is not None:
                    gts.append(batch_answers[j])
                else:
                    # a mismatch means the collate and the generator disagree
                    # about the tiling: fail rather than score against the
                    # wrong answers
                    if j >= len(row_to_id):
                        raise ValueError(
                            f"generated {len(seqs)} rows but only {len(row_to_id)} id rows; carry "
                            "'answers' in the batch (QA test collate) or pass tile_index")
                    gts.append(answers[str(row_to_id[j])])
    # merge the ranks' shards before scoring; the submit gather runs on every
    # rank, whatever its own list holds, so that no rank skips a collective
    gts = C.all_gather_lists(gts)
    for g in groups:
        group_preds[g] = C.all_gather_lists(group_preds[g])
    submit = C.all_gather_lists(submit)
    preds = group_preds[groups[0]]
    if result_dir and is_main_process():
        os.makedirs(result_dir, exist_ok=True)
        _dump(os.path.join(result_dir, f"step{step}_gt.json"), gts)
        for g in groups:
            _dump(os.path.join(result_dir, f"step{step}_{g}_pred.json"), group_preds[g])
        if submit:
            name = f"step{step}_{groups[0]}_pred_submited_{dset_name or 'qa'}.json"
            _dump(os.path.join(result_dir, name), submit)
    report = {"accuracy": qa_accuracy(preds, gts)}
    for g in groups[1:]:
        report[f"{g}_accuracy"] = qa_accuracy(group_preds[g], gts)
    return report


@_whole_params
def validate_pt(model, eval_step, loader, task: TaskSpec, contra_type: str = "fine") -> Dict[str, float]:
    """Pretraining proxy metrics over the batches of ``loader`` (reference
    test.py:415-665, as the JAX package reports them): per group, the
    caption and MLM token accuracies on the masked positions, with one
    masked-token denominator per objective shared by its groups (test.py:
    464/482), the aggregates ``caption_token_acc`` and ``mlm_token_acc``, in
    percent rounded to 2 decimals; and ``contra_recall_{g}``, the forward R@1
    of every contrastive group over the whole set (``retrieval_scores``: the
    fine groups through the fused fine-score kernel on the card).  The hit
    counts stay on the device until the end, then the ranks' are summed.
    ``loader``'s ``sampler`` (a ``ShardedBatchSampler``) says which rows of
    one process's batch each evaluation batch holds."""
    objectives = {"caption": task.caption_groups, "mlm": task.mlm_groups}
    hits = {kind: {g: 0 for g in groups} for kind, groups in objectives.items()}
    totals = {kind: 0 for kind in objectives}
    feats_all: Dict[str, List[torch.Tensor]] = {k: [] for k in _FEATURE_KEYS}
    ids: List = []
    ids_txt: List = []
    sampler = getattr(loader, "sampler", None)
    for k, batch in enumerate(loader):
        batch = dict(batch)
        batch_ids = batch.pop("ids", None)
        batch_ids_txt = batch.pop("ids_txt", None)
        batch.pop("sample_num", None)
        with batch_shard(sampler_shard(sampler, k)):
            out = eval_step(model, batch, task)
        for kind, groups in objectives.items():
            lab = out.get(f"txt_labels_{kind}")
            if not groups or lab is None:
                continue
            m = lab != -1
            totals[kind] = totals[kind] + m.sum()
            for g in groups:
                scores = out.get(f"{kind}_scores_{g}")
                if scores is not None:
                    hits[kind][g] = hits[kind][g] + ((scores.argmax(-1) == lab) & m).sum()
        if task.contra_groups:
            for k in _FEATURE_KEYS:
                if out.get(k) is not None:
                    feats_all[k].append(out[k] if k == "txt_tokens" else out[k].float())
            if batch_ids is not None:
                ids.extend(batch_ids)
            if batch_ids_txt is not None:
                ids_txt.extend(batch_ids_txt)
    # the ranks' counters merged before dividing, in one gather that every rank runs
    merged = C.all_gather_objects(({kind: {g: int(v) for g, v in h.items()} for kind, h in hits.items()},
                                   {kind: int(v) for kind, v in totals.items()}))
    report: Dict[str, float] = {}
    for kind, groups in objectives.items():
        total = sum(m[1][kind] for m in merged)
        if not total:
            continue
        hit = {g: sum(m[0][kind][g] for m in merged) for g in groups}
        for g in groups:
            report[f"{kind}_acc_{g}"] = round(100.0 * hit[g] / total, 2)
        report[f"{kind}_token_acc"] = round(100.0 * sum(hit.values()) / (total * len(hit)), 2)
    if task.contra_groups:
        feats, ids, ids_txt = _gather_eval_features(feats_all, ids, ids_txt, model.device)
        if feats.get("feat_t") is not None and feats["feat_t"].shape[0] > 0:
            for g in task.contra_groups:
                score = retrieval_scores(model, feats, g, contra_type).cpu().numpy()
                row_ids = (ids_txt or ids) if g[0] == "t" else ids
                report[f"contra_recall_{g}"] = retrieval_report(score, ids, row_ids)["forward_r1"]
    return report


def best_metric_name(task: TaskSpec) -> Optional[str]:
    return {"ret": "ravg", "cap": "CIDEr", "qa": "accuracy", "pt": None}[task.family]
