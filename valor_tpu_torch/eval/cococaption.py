"""METEOR / SPICE hooks (cococaption-compatible) + pure-Python METEOR.

The reference's caption eval reports BLEU/METEOR/ROUGE-L/CIDEr/SPICE via
its vendored cococaption stack (reference: cococaption/pycocoevalcap/
eval.py; METEOR and SPICE shell out to Java jars, meteor/meteor.py:15-30,
spice/spice.py).  This module provides:

  * :class:`MeteorJar` — a clean-room wrapper speaking the METEOR-1.5
    ``-stdio`` protocol (``SCORE ||| ref1 ||| ... ||| hyp`` ->
    stats line; one ``EVAL ||| stats ...`` -> per-segment scores then the
    corpus score).  Used when ``java`` and a jar (``$VALOR_METEOR_JAR``)
    are available — exact parity with the reference numbers.
  * :func:`meteor_lite` — a pure-Python METEOR in the classic Banerjee &
    Lavie 2005 formulation (exact + Porter-stem unigram matching,
    Fmean = 10PR/(R+9P), fragmentation penalty 0.5*(chunks/matches)^3).
    It is a documented approximation of METEOR-1.5 (no WordNet synonym or
    paraphrase stages, untuned weights) used when the jar is absent so
    caption reports always carry a METEOR column.
  * :class:`SpiceJar` — the SPICE protocol wrapper (``$VALOR_SPICE_JAR``);
    SPICE has no pure-Python approximation here (it needs a dependency
    parser), so without the jar the column is omitted.

Leaderboard-grade reports need these external artifacts (the reference
vendors the first; its snapshot does not even ship spice.py —
cococaption/pycocoevalcap/eval_spice.py imports a missing module):

  * ``meteor-1.5.jar`` (cmu.edu METEOR 1.5 release, or copy from the
    reference's cococaption/pycocoevalcap/meteor/) ->
    ``export VALOR_METEOR_JAR=/path/to/meteor-1.5.jar``; the ``data/``
    directory with paraphrase tables must sit next to the jar.
  * ``spice-1.0.jar`` + its ``lib/`` directory (panderson.me/spice,
    the standard pycocoevalcap get_stanford_models.sh layout) ->
    ``export VALOR_SPICE_JAR=/path/to/spice-1.0.jar``.
  * a JRE (``java`` on PATH).

Both protocols are tested WITHOUT Java via fake subprocess transports
(tests/test_metrics.py), so wrapper regressions surface in CI.

The PyTorch port's own copy of ``valor_tpu/eval/cococaption.py`` (pure Python and
numpy; nothing here runs on the card).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

METEOR_JAR_ENV = "VALOR_METEOR_JAR"
SPICE_JAR_ENV = "VALOR_SPICE_JAR"


def java_available() -> bool:
    return shutil.which("java") is not None


def meteor_jar_path() -> Optional[str]:
    p = os.environ.get(METEOR_JAR_ENV)
    return p if p and os.path.exists(p) else None


# ---------------------------------------------------------------------------
# Porter stemmer (clean-room implementation of the published algorithm,
# Porter 1980, "An algorithm for suffix stripping")
# ---------------------------------------------------------------------------

_VOWELS = set("aeiou")


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """The m in [C](VC)^m[V]."""
    forms = ""
    for i in range(len(stem)):
        forms += "C" if _is_cons(stem, i) else "V"
    # collapse runs
    collapsed = "".join(c for i, c in enumerate(forms) if i == 0 or c != forms[i - 1])
    return collapsed.count("VC")


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
    ):
        return False
    return word[-1] not in "wxy"


def porter_stem(word: str) -> str:
    """Porter 1980 stemmer, steps 1a-5b."""
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                break
            if _measure(stem) > 1:
                w = stem
            break
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR (classic formulation, pure Python)
# ---------------------------------------------------------------------------


def _chunk_count(pairs) -> int:
    """Maximal runs contiguous and monotone in BOTH sentences."""
    if not pairs:
        return 0
    c = 1
    for (i0, j0), (i1, j1) in zip(pairs, pairs[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            c += 1
    return c


# enumeration bound for the min-chunk alignment search; past it the
# remaining ambiguous keys fall back to first-slot greedy.  Caption-length
# segments (<= ~30 tokens, few duplicated words) never get near it.
_ALIGN_CAP = 256


def _align(hyp: List[str], ref: List[str]) -> List[tuple]:
    """Two-stage unigram alignment: exact matches first, then Porter-stem
    matches on the leftovers.  Returns (hyp_idx, ref_idx) pairs sorted by
    hyp position.

    When a word occurs more than once, several maximum matchings exist;
    METEOR's published tie-break (Banerjee & Lavie 2005 §2.1, and the
    METEOR-1.5 aligner the reference's jar wraps) picks the matching with
    the FEWEST chunks.  All maximum matchings here have the same
    cardinality (per key it is min(#hyp, #ref) occurrences), so the
    enumeration below only varies WHICH duplicate slots pair up, and the
    min-chunk candidate is selected at the end.  The search is capped at
    ``_ALIGN_CAP`` candidates (falling back to first-slot greedy beyond),
    which no caption-length input approaches."""
    from itertools import combinations, islice

    # candidates: (pairs tuple, used hyp idx set, used ref idx set)
    cands = [((), frozenset(), frozenset())]
    for stage in ("exact", "stem"):
        key = (lambda t: t) if stage == "exact" else porter_stem
        nxt = []
        for pairs, used_h, used_r in cands:
            hyp_slots: Dict[str, List[int]] = {}
            for i, t in enumerate(hyp):
                if i not in used_h:
                    hyp_slots.setdefault(key(t), []).append(i)
            ref_slots: Dict[str, List[int]] = {}
            for j, t in enumerate(ref):
                if j not in used_r:
                    ref_slots.setdefault(key(t), []).append(j)
            per_key = []
            for k_, hs in hyp_slots.items():
                rs = ref_slots.get(k_)
                if not rs:
                    continue
                n = min(len(hs), len(rs))
                # order-preserving assignments of n hyp occurrences to n
                # ref slots (monotone per key is never chunk-worse: any
                # crossing between equal words can be swapped away).
                # Enumerated LAZILY up to the cap: a degenerate repeated
                # token (e.g. a greedy decode emitting 'the' x 30 against
                # 'the' x 8) has C(30,8) ~ 5.9M slot choices — the nested
                # generator + islice bound the work BEFORE anything
                # materialises (NB itertools.product is NOT lazy in its
                # arguments — it tuple-izes each iterable up front, which
                # is exactly the blowup being avoided); past the cap the
                # downstream truncation falls back to the first-slot
                # (leftmost, greedy) assignment anyway.
                lazy = (
                    tuple(zip(hc, rc))
                    for hc in combinations(hs, n)
                    for rc in combinations(rs, n)
                )
                per_key.append(list(islice(lazy, _ALIGN_CAP + 1)))
            partial = [()]
            for opts in per_key:
                if len(partial) * len(opts) > _ALIGN_CAP:
                    opts = opts[:1]  # greedy first-slot fallback
                partial = [p + o for p in partial for o in opts]
            for extra in partial:
                nxt.append((
                    tuple(sorted(pairs + extra)),
                    used_h | {i for i, _ in extra},
                    used_r | {j for _, j in extra},
                ))
        # dedup identical pair sets and bound the frontier
        cands = list({c[0]: c for c in nxt}.values())[:_ALIGN_CAP]
    best = min(cands, key=lambda c: _chunk_count(c[0]))
    return list(best[0])


def _meteor_segment(hyp: List[str], ref: List[str]) -> float:
    pairs = _align(hyp, ref)
    m = len(pairs)
    if m == 0 or not hyp or not ref:
        return 0.0
    p = m / len(hyp)
    r = m / len(ref)
    fmean = 10.0 * p * r / (r + 9.0 * p)
    penalty = 0.5 * (_chunk_count(pairs) / m) ** 3
    return fmean * (1.0 - penalty)


def meteor_lite(
    hyps: Dict[str, str], refs: Dict[str, List[str]]
) -> float:
    """Corpus METEOR (classic): mean of per-segment best-reference scores."""
    scores = []
    for k in sorted(hyps):
        hyp = hyps[k].split()
        best = max(
            (_meteor_segment(hyp, ref.split()) for ref in refs[k]), default=0.0
        )
        scores.append(best)
    return float(sum(scores) / len(scores)) if scores else 0.0


# ---------------------------------------------------------------------------
# Jar wrappers (exact reference parity when the artifacts exist)
# ---------------------------------------------------------------------------


class MeteorJar:
    """METEOR-1.5 ``-stdio`` protocol wrapper.

    Protocol (METEOR 1.5 README): one ``SCORE ||| ref1 ||| ... ||| hyp``
    line per segment returns a stats line; a single
    ``EVAL ||| stats1 ||| stats2 ...`` returns one score line per segment
    followed by the corpus score.
    """

    def __init__(self, jar: Optional[str] = None):
        jar = jar or meteor_jar_path()
        if not jar:
            raise RuntimeError(f"no METEOR jar; set ${METEOR_JAR_ENV}")
        if not java_available():
            raise RuntimeError("java not on PATH")
        env = dict(os.environ, LC_ALL="en_US.UTF_8")
        self._p = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en", "-norm"],
            cwd=os.path.dirname(os.path.abspath(jar)),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            # NOT a pipe: a warning-heavy jar run (e.g. partial data/
            # paraphrase dir) fills the 64KB pipe buffer nobody drains,
            # the JVM blocks on stderr, stops answering -stdio, and
            # score() deadlocks on stdout.readline() holding self._lock
            stderr=subprocess.DEVNULL,
            env=env,
            universal_newlines=True,
            bufsize=1,
        )
        self._lock = threading.Lock()

    def _clean(self, s: str) -> str:
        return s.replace("|||", "").replace("  ", " ").strip()

    def score(self, hyps: Dict[str, str], refs: Dict[str, List[str]]):
        """(corpus_score, {id: segment_score})."""
        ids = sorted(hyps)
        with self._lock:
            stats = []
            for k in ids:
                line = "SCORE ||| " + " ||| ".join(
                    [self._clean(r) for r in refs[k]] + [self._clean(hyps[k])]
                )
                self._p.stdin.write(line + "\n")
                stats.append(self._p.stdout.readline().strip())
            self._p.stdin.write("EVAL ||| " + " ||| ".join(stats) + "\n")
            seg = {k: float(self._p.stdout.readline().strip()) for k in ids}
            corpus = float(self._p.stdout.readline().strip())
        return corpus, seg

    def close(self):
        try:
            self._p.stdin.close()
            self._p.kill()
        except Exception:
            pass


class SpiceJar:
    """SPICE hook: ``java -jar spice.jar input.json -out out.json``.

    Input format (reference spice/spice.py): a json list of
    {"image_id", "test", "refs"}; the output carries per-image
    {"scores": {"All": {"f": ...}}}.
    """

    def __init__(self, jar: Optional[str] = None):
        self.jar = jar or os.environ.get(SPICE_JAR_ENV)
        if not self.jar or not os.path.exists(self.jar):
            raise RuntimeError(f"no SPICE jar; set ${SPICE_JAR_ENV}")
        if not java_available():
            raise RuntimeError("java not on PATH")

    def score(self, hyps: Dict[str, str], refs: Dict[str, List[str]]):
        import json
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            inp = os.path.join(td, "in.json")
            out = os.path.join(td, "out.json")
            cache = os.path.join(td, "cache")
            os.makedirs(cache, exist_ok=True)
            payload = [
                {"image_id": k, "test": hyps[k], "refs": refs[k]} for k in sorted(hyps)
            ]
            with open(inp, "w") as f:
                json.dump(payload, f)
            subprocess.check_call(
                ["java", "-jar", "-Xmx8G", self.jar, inp, "-cache", cache,
                 "-out", out, "-subset", "-silent"],
                cwd=os.path.dirname(os.path.abspath(self.jar)),
            )
            with open(out) as f:
                results = json.load(f)
        seg = {r["image_id"]: float(r["scores"]["All"]["f"]) for r in results}
        vals = list(seg.values())
        return (sum(vals) / len(vals) if vals else 0.0), seg


def meteor_score(hyps: Dict[str, str], refs: Dict[str, List[str]]) -> float:
    """METEOR for the caption report: the jar when available (reference
    parity), else the documented pure-Python classic formulation."""
    if meteor_jar_path() and java_available():
        jar = MeteorJar()
        try:
            corpus, _ = jar.score(hyps, refs)
            return corpus
        finally:
            jar.close()
    return meteor_lite(hyps, refs)


def spice_jar_path() -> Optional[str]:
    p = os.environ.get(SPICE_JAR_ENV)
    return p if p and os.path.exists(p) else None


def spice_score(hyps: Dict[str, str], refs: Dict[str, List[str]]) -> Optional[float]:
    """SPICE when the jar is available; None otherwise (no approximation).

    Gates on the jar file EXISTING, not just the env var being set — a
    stale $VALOR_SPICE_JAR must omit the column, not crash a caption
    eval whose BLEU/CIDEr/ROUGE are already computed (the METEOR path's
    meteor_jar_path() makes the same check)."""
    if spice_jar_path() and java_available():
        corpus, _ = SpiceJar().score(hyps, refs)
        return corpus
    return None
