"""Open-ended / multi-answer / multiple-choice QA dataset layer.

reference: data/vqa.py:22-217.  Behaviour reproduced:
  * train: one random (question, answer) pair per id; video QA has one
    string answer (max_len 5), image QA a weighted answer list
    (answer_weights), multiple-choice an int index + choice texts,
  * test: all pairs, carrying question_ids and raw answers for scoring,
  * collate: answers tiled flat with per-row weights and a `tile_index`
    mapping each tiled row back to its source media row, in place of the
    reference's in-forward feature tiling (model/pretrain.py:1241-1262):
    each video is encoded exactly once, and ``forward_qa`` gathers the
    fused media rows by ``tile_index`` on the device.

The PyTorch port's own copy of ``valor_tpu/data/vqa.py``.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from valor_tpu_torch.core.logging import LOGGER
from valor_tpu_torch.data.pipeline import TxtMapper, VALORDataset, collate_audio

ANSWER_MAX_LEN = 5  # reference: data/vqa.py:47
CHOICE_MAX_LEN = 10  # reference: data/vqa.py:60


class QATxtMapper(TxtMapper):
    """{id: [{question, answer, answer_weights?, choice?, question_id?}]}"""

    def __getitem__(self, id_):
        pairs = self.json_dict[id_]
        if self.training:
            if not pairs:
                return None
            sample = random.choice(pairs)
            question = self.tokenize_one(sample["question"])
            answer = sample["answer"]
            out: Dict[str, Any] = {"question": question}
            if isinstance(answer, str):
                out["answer"] = [self.tokenize_one_short(answer, ANSWER_MAX_LEN)]
                out["answer_weights"] = [1.0]
            elif isinstance(answer, list):
                out["answer"] = [self.tokenize_one_short(a, ANSWER_MAX_LEN) for a in answer]
                out["answer_weights"] = list(sample["answer_weights"])
            elif isinstance(answer, int):
                out["answer_index"] = answer
            if "choice" in sample:
                out["choices"] = [
                    self.tokenize_one_short(c, CHOICE_MAX_LEN) for c in sample["choice"]
                ]
            return out
        out = {"questions": [], "answers": [], "question_ids": [], "choices": []}
        for sample in pairs:
            out["questions"].append(self.tokenize_one(sample["question"]))
            out["answers"].append(sample["answer"])
            if "question_id" in sample:
                out["question_ids"].append(sample["question_id"])
            if "choice" in sample:
                out["choices"].extend(
                    self.tokenize_one_short(c, CHOICE_MAX_LEN) for c in sample["choice"]
                )
        return out

    def tokenize_one_short(self, text: str, max_len: int) -> Dict[str, np.ndarray]:
        # thread-safe: max_len rides the call, never mutates shared state
        # (worker threads share this mapper — see TxtMapper.tokenize_one)
        return self.tokenize_one(text, max_len=max_len)


class VALORQADataset(VALORDataset):
    def __getitem__(self, i: int) -> Dict[str, Any]:
        id_ = self.ids[i]
        qa = self.txt_mapper[id_]
        if qa is None and self.training:
            j = random.randrange(len(self.ids))
            LOGGER.info(f"sample {id_} has no QA pairs; resampling {self.ids[j]}")
            return self[j]
        video = self.video_mapper[id_] if self.video_mapper is not None else None
        if video is None and self.video_mapper is not None and self.training:
            j = random.randrange(len(self.ids))
            return self[j]
        audio = self.audio_mapper[id_] if self.audio_mapper is not None else None
        if audio is None and self.audio_mapper is not None and self.training:
            j = random.randrange(len(self.ids))
            return self[j]
        return {"id": id_, "qa": qa, "video": video, "audio": audio}


def _stack_tok(dicts: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def valorqa_collate_train(
    samples: Sequence[Dict[str, Any]], pad_multiple: int = 8
) -> Dict[str, Any]:
    """Train batch with flat answer tiling + tile_index.

    Multi-answer batches pad the tiled rows up to a multiple of
    ``pad_multiple`` with zero-weight copies of row 0, so the step sees a
    small number of shapes instead of one shape per batch (VQAv2 answer
    counts vary per question)."""
    ids = [s["id"] for s in samples]
    questions: List[Dict[str, np.ndarray]] = []
    answers: List[Dict[str, np.ndarray]] = []
    weights: List[float] = []
    tile_index: List[int] = []
    for qi, s in enumerate(samples):
        qa = s["qa"]
        if "answer" not in qa:
            # multiple-choice sample (int answer_index + choices).  The
            # reference's collate builds a batch of int txt_tokens that
            # no model path consumes (choice_tokens has zero consumers
            # and no shipped config uses MC — DIVERGENCES.md); training
            # generatively needs a textual target, so fail with the fix
            # instead of a KeyError deep in zip().
            raise ValueError(
                "multiple-choice QA sample has no textual answer to "
                "train on (answer_index only); supply answer strings "
                "(the reference trains every shipped QA config "
                "generatively) or use the eval collate"
            )
        for a, w in zip(qa["answer"], qa["answer_weights"]):
            answers.append(a)
            weights.append(w)
            questions.append(qa["question"])
            tile_index.append(qi)
    uniform = all(len(s["qa"]["answer"]) == 1 for s in samples)
    if not uniform:
        pad = (-len(answers)) % pad_multiple
        for _ in range(pad):
            answers.append(answers[0])
            questions.append(questions[0])
            weights.append(0.0)  # zero weight -> no gradient contribution
            tile_index.append(0)
    batch: Dict[str, Any] = {"ids": ids}
    ans = _stack_tok(answers)
    q = _stack_tok(questions)
    batch["bert_tokens"] = ans.get("bert_tokens")
    if "clip_tokens" in ans:
        batch["clip_tokens"] = ans["clip_tokens"]
    batch["question_prompt"] = q.get("bert_tokens")
    if not uniform:
        batch["answer_weights"] = np.asarray(weights, np.float32)
        batch["tile_index"] = np.asarray(tile_index, np.int32)
    if samples[0]["video"] is not None:
        batch["video_pixels"] = np.stack([s["video"] for s in samples])
    collate_audio(batch, [s["audio"] for s in samples])
    return batch


def valorqa_collate_test(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    ids = [s["id"] for s in samples]
    questions: List[Dict[str, np.ndarray]] = []
    answers: List[Any] = []
    question_ids: List[Any] = []
    tile_index: List[int] = []
    for qi, s in enumerate(samples):
        qa = s["qa"]
        for j, q in enumerate(qa["questions"]):
            questions.append(q)
            answers.append(qa["answers"][j])
            tile_index.append(qi)
        question_ids.extend(qa.get("question_ids") or [])
    q = _stack_tok(questions)
    batch: Dict[str, Any] = {
        "ids": ids,
        "question_prompt": q.get("bert_tokens"),
        "answers": answers,
        "question_ids": question_ids or None,
        "tile_index": np.asarray(tile_index, np.int32),
    }
    # multiple-choice pass-through, mirroring the reference collate's
    # choice_tokens key (data/vqa.py:160-166 — which nothing downstream
    # consumes there either; carried for custom eval consumers)
    choices = [c for s in samples for c in s["qa"].get("choices", [])]
    if choices:
        batch["choice_tokens"] = _stack_tok(choices).get("bert_tokens")
    if samples[0]["video"] is not None:
        batch["video_pixels"] = np.stack([s["video"] for s in samples])
    collate_audio(batch, [s["audio"] for s in samples])
    return batch
