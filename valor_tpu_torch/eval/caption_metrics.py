"""Caption metrics: BLEU, CIDEr, ROUGE-L (pure Python/numpy).

Replaces the reference's vendored cococaption stack (pycocoevalcap BLEU/
CIDEr/ROUGE + Java METEOR/SPICE, SURVEY.md C23) and the SCST scorer's
internals (scorer/cider_scorer.py, scorer/bleu_scorer.py) with clean-room
implementations of the standard published algorithms:

  * BLEU-N (Papineni et al. 2002): modified n-gram precision, brevity
    penalty; corpus-level and a smoothed sentence-level variant for SCST.
  * CIDEr (Vedantam et al. 2015): tf-idf-weighted n-gram cosine, n=1..4,
    length-gaussian penalty (sigma=6), x10 scaling; document frequencies
    can be precomputed over the train annotations for training-time reward
    (reference: scorer/scorer.py:117-147).
  * ROUGE-L (Lin 2004): LCS-based F-measure with beta=1.2.

METEOR and SPICE: eval/cococaption.py carries a METEOR-1.5 jar wrapper
(exact reference parity when java + $VALOR_METEOR_JAR exist), a pure-Python
classic-METEOR fallback always included in the report, and the documented
SPICE jar hook (column omitted without the jar).

The PyTorch port's own copy of ``valor_tpu/eval/caption_metrics.py`` (pure Python and
numpy; nothing here runs on the card).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def ngram_counts(tokens: Sequence[str], max_n: int = 4) -> Counter:
    out: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            out[tuple(tokens[i : i + n])] += 1
    return out


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


def _bleu_stats(hyp: List[str], refs: List[List[str]], max_n: int = 4):
    stats = []
    for n in range(1, max_n + 1):
        h = Counter(tuple(hyp[i : i + n]) for i in range(len(hyp) - n + 1))
        r: Counter = Counter()
        for ref in refs:
            rc = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
            for k, v in rc.items():
                r[k] = max(r[k], v)
        match = sum(min(c, r[k]) for k, c in h.items())
        total = max(sum(h.values()), 0)
        stats.append((match, total))
    ref_len = min(refs, key=lambda rf: (abs(len(rf) - len(hyp)), len(rf)))
    return stats, len(hyp), len(ref_len)


def bleu_corpus(
    hyps: List[List[str]], refs_list: List[List[List[str]]], max_n: int = 4
) -> List[float]:
    """Corpus BLEU-1..N (cococaption convention: closest ref length)."""
    matches = [0] * max_n
    totals = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, refs in zip(hyps, refs_list):
        stats, hl, rl = _bleu_stats(hyp, refs, max_n)
        for i, (m, t) in enumerate(stats):
            matches[i] += m
            totals[i] += t
        hyp_len += hl
        ref_len += rl
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    out = []
    logsum = 0.0
    for n in range(max_n):
        # no n-grams at this order (all hyps shorter than n): treat the
        # precision as exact rather than zero, keeping perfect-match == 1.0
        p = matches[n] / totals[n] if totals[n] else 1.0
        logsum += math.log(max(p, 1e-16))
        out.append(bp * math.exp(logsum / (n + 1)))
    return out


def bleu_sentence(hyp: List[str], refs: List[List[str]], max_n: int = 4) -> float:
    """Per-sentence BLEU-4 exactly as pycocoevalcap's BleuScorer emits its
    per-image scores (reference scorer/bleu_scorer.py:202-247): geometric
    mean of (correct_k + 1e-15)/(guess_k + 1e-9) over orders 1..N with the
    closest-reference brevity penalty applied when ratio < 1.  This IS the
    BLEU term of the SCST reward (scorer/scorer.py:70-75), so the tiny/small
    smoothing constants must match — golden-tested in
    tests/test_ret_scst_golden.py."""
    small, tiny = 1e-9, 1e-15
    stats, hl, rl = _bleu_stats(hyp, refs, max_n)
    bleu = 1.0
    for m, t in stats:
        bleu *= (m + tiny) / (t + small)
    out = bleu ** (1.0 / max_n)
    ratio = (hl + tiny) / (rl + small)
    if ratio < 1:
        out *= math.exp(1 - 1 / ratio)
    return out


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------


class CiderScorer:
    """CIDEr-D style scorer with optional precomputed document frequencies.

    For eval, df comes from the test references themselves (standard
    cococaption behaviour).  For SCST training reward, df + mean ref length
    are precomputed over the full training annotation set once
    (reference: scorer/scorer.py:117-147).
    """

    def __init__(self, max_n: int = 4, sigma: float = 6.0):
        self.max_n = max_n
        self.sigma = sigma
        self.df: Dict[Tuple, float] = {}
        self.log_ref_count = 0.0

    def fit_df(self, refs_corpus: Iterable[List[List[str]]]) -> "CiderScorer":
        df: Dict[Tuple, int] = defaultdict(int)
        count = 0
        for refs in refs_corpus:
            count += 1
            seen = set()
            for ref in refs:
                seen.update(ngram_counts(ref, self.max_n).keys())
            for g in seen:
                df[g] += 1
        self.df = dict(df)
        self.log_ref_count = math.log(max(count, 1))
        return self

    def _vec(self, counts: Counter):
        vec = [defaultdict(float) for _ in range(self.max_n)]
        norm = [0.0] * self.max_n
        length = 0
        for gram, tf in counts.items():
            n = len(gram) - 1
            dfv = math.log(max(self.df.get(gram, 0.0), 1.0))
            w = tf * (self.log_ref_count - dfv)
            vec[n][gram] = w
            norm[n] += w * w
            if n == 0:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, nh, lh, vr, nr, lr):
        delta = lh - lr
        score = 0.0
        for n in range(self.max_n):
            s = 0.0
            for gram, w in vh[n].items():
                s += min(w, vr[n].get(gram, 0.0)) * vr[n].get(gram, 0.0)
            if nh[n] and nr[n]:
                s /= nh[n] * nr[n]
            score += s * math.exp(-(delta**2) / (2 * self.sigma**2))
        return score / self.max_n

    def score(self, hyps: List[List[str]], refs_list: List[List[List[str]]]) -> np.ndarray:
        if not self.df:
            self.fit_df(refs_list)
        out = np.zeros(len(hyps), np.float32)
        for i, (hyp, refs) in enumerate(zip(hyps, refs_list)):
            vh, nh, lh = self._vec(ngram_counts(hyp, self.max_n))
            s = 0.0
            for ref in refs:
                vr, nr, lr = self._vec(ngram_counts(ref, self.max_n))
                s += self._sim(vh, nh, lh, vr, nr, lr)
            out[i] = 10.0 * s / max(len(refs), 1)
        return out


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(hyps: List[List[str]], refs_list: List[List[List[str]]], beta: float = 1.2) -> float:
    """COCO-convention multi-reference aggregation: the max precision and
    max recall are taken SEPARATELY across references before the single
    F-measure (pycocoevalcap behavior; golden-matched in
    tests/test_metric_parity.py)."""
    scores = []
    for hyp, refs in zip(hyps, refs_list):
        p_max = r_max = 0.0
        for ref in refs:
            lcs = _lcs_len(hyp, ref)
            p_max = max(p_max, lcs / max(len(hyp), 1))
            r_max = max(r_max, lcs / max(len(ref), 1))
        if p_max and r_max:
            f = (1 + beta**2) * p_max * r_max / (r_max + beta**2 * p_max)
        else:
            f = 0.0
        scores.append(f)
    return float(np.mean(scores)) if scores else 0.0


def caption_eval(
    hyps: Dict[str, str], refs: Dict[str, List[str]], tokenize: bool = True
) -> Dict[str, float]:
    """COCOEvalCap-style report over {id: sentence} vs {id: [refs]}
    (reference: test.py:781-788).

    ``tokenize=True`` (default) first pipes hypotheses AND references
    through the PTB normalization (eval/ptb.py) exactly as the reference
    does before every caption score (cococaption/pycocoevalcap/eval.py:40)
    — the leaderboard convention on punctuation-bearing corpora.  Set
    False for corpora that are already PTB-normalized."""
    if tokenize:
        from valor_tpu_torch.eval.ptb import ptb_normalize

        hyps = {k: ptb_normalize(v) for k, v in hyps.items()}
        refs = {k: [ptb_normalize(s) for s in v] for k, v in refs.items()}
    ids = sorted(hyps)
    h = [hyps[i].split() for i in ids]
    r = [[s.split() for s in refs[i]] for i in ids]
    bleu = bleu_corpus(h, r)
    cider = CiderScorer().score(h, r)
    report = {
        "Bleu_1": round(bleu[0], 4),
        "Bleu_2": round(bleu[1], 4),
        "Bleu_3": round(bleu[2], 4),
        "Bleu_4": round(bleu[3], 4),
        "ROUGE_L": round(rouge_l(h, r), 4),
        "CIDEr": round(float(np.mean(cider)), 4),
    }
    from valor_tpu_torch.eval.cococaption import meteor_score, spice_score

    report["METEOR"] = round(meteor_score(hyps, refs), 4)
    spice = spice_score(hyps, refs)
    if spice is not None:
        report["SPICE"] = round(spice, 4)
    return report
