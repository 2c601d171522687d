"""SCST training-time reward (counterpart of ``valor_tpu/eval/scorer.py``).

reference: scorer/scorer.py:31-147 — the reward of a sample is CIDEr (with
document frequencies fitted on the *training* annotations) plus sentence
BLEU-4 against the sample's reference captions; it is computed on the host
between the greedy (baseline) and sampled rollouts.  ``AdaptiveAlpha`` is the
self-critical baseline's coefficient.
"""

from __future__ import annotations

import json
import string
from typing import Dict, List, Sequence

import numpy as np

from valor_tpu_torch.eval.caption_metrics import CiderScorer, bleu_sentence


class Scorer:
    def __init__(self, annotation_file: str, ids: Sequence[str], tokenizer):
        """``annotation_file``: ``{id: caption or [captions]}`` JSON (the train
        text mapper's); ``ids``: the training ids; ``tokenizer``: a
        ``BertTokenizer`` (``tokenize``, ``convert_ids_to_tokens``)."""
        with open(annotation_file) as f:
            raw = json.load(f)
        self.refs: Dict[str, List[List[str]]] = {}
        for id_ in ids:
            caps = raw[id_]
            if isinstance(caps, str):
                caps = [caps]
            self.refs[id_] = [tokenizer.tokenize(_clean(c)) for c in caps]
        self.cider = CiderScorer().fit_df(self.refs.values())
        self.tokenizer = tokenizer

    def __call__(self, ids: Sequence[str], hyp_token_ids: Sequence[Sequence[int]]) -> np.ndarray:
        """The reward (CIDEr + BLEU-4) of each generated id list (EOS stripped)
        against the references of its sample id."""
        hyps = [self.tokenizer.convert_ids_to_tokens([int(t) for t in h]) for h in hyp_token_ids]
        refs = [self.refs[i] for i in ids]
        cider = self.cider.score(hyps, refs)
        bleu = np.asarray([bleu_sentence(h, r) for h, r in zip(hyps, refs)], np.float32)
        return cider + bleu


def _clean(text: str) -> str:
    text = " ".join(w for w in text.split(" ") if w).lower()
    for p in string.punctuation:
        text = text.replace(p, "")
    return text


class AdaptiveAlpha:
    """Self-critical baseline coefficient (reference: pretrain.py:1461-1507).

    ``alpha_type`` 0: constant 1; 1: the mean sample/greedy reward ratio over
    the last ``recent`` updates; 2: the ratio of the running totals; each
    times ``beta``."""

    def __init__(self, alpha_type: int = 0, beta: float = 1.0, recent: int = 5000):
        self.alpha_type = alpha_type
        self.beta = beta
        self.recent = np.zeros(recent, np.float64)
        self.recent_n = recent
        self.idx = 0
        self.sample_total = 0.0
        self.greedy_total = 0.0

    def update(self, reward_sample: np.ndarray, reward_greedy: np.ndarray) -> None:
        s, g = float(np.mean(reward_sample)), float(np.mean(reward_greedy))
        self.sample_total += s
        self.greedy_total += g
        self.recent[self.idx % self.recent_n] = s / g if g else 1.0
        self.idx += 1

    def value(self) -> float:
        if self.alpha_type == 0:
            return 1.0
        if self.alpha_type == 1:
            n = min(self.idx, self.recent_n)
            return float(np.mean(self.recent[:n])) * self.beta if n else 1.0
        if self.alpha_type == 2:
            return (self.sample_total / self.greedy_total) * self.beta if self.greedy_total else 1.0
        raise ValueError(self.alpha_type)
