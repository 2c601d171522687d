"""PTB caption tokenization, pure Python (no Java).

The reference pipes every hypothesis AND reference caption through the
Stanford PTBTokenizer jar before scoring
(`edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase`,
reference: cococaption/pycocoevalcap/tokenizer/ptbtokenizer.py:30-33,
invoked from cococaption/pycocoevalcap/eval.py:40), then drops a fixed
punctuation list from the token stream (ptbtokenizer.py:24-25,67-68).
Leaderboard BLEU/CIDEr/METEOR/ROUGE numbers are all defined over this
normalization, so scoring raw model output on whitespace alone deviates
on every punctuation-bearing corpus.

This module is a clean-room reimplementation of that convention: the
Penn-Treebank tokenization rules (the published PTB sed script as
extended by Stanford's tokenizer — contraction/possessive splitting,
punctuation isolation, bracket and quote normalization to the
-LRB-/``-style PTB symbols), lowercasing, then the reference wrapper's
punctuation-drop list.  The jar itself is absent from the reference
snapshot (its PTBTokenizer would crash), so this is capability beyond
the snapshot while matching the documented convention.

The PyTorch port's own copy of ``valor_tpu/eval/ptb.py`` (pure Python and
numpy; nothing here runs on the card).
"""

from __future__ import annotations

import re
from typing import Dict, List

# ptbtokenizer.py:24-25 — tokens removed AFTER tokenization.  NB the
# reference applies this UPPERCASE list to tokens the jar has already
# -lowerCase'd, so the bracket entries ("-LRB-"...) never match and
# "-lrb-"/"-rrb-" tokens survive in its output (the well-known quirk
# visible in every PTB-tokenized COCO caption corpus).  We drop the
# same set against lowercased tokens, reproducing that behavior.
PUNCTUATIONS = frozenset(
    ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
     ".", "?", "!", ",", ":", "-", "--", "...", ";"]
)

# --- Penn Treebank tokenization rules (order matters) -----------------
# opening quotes
_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ (\[{<])(\"|\'{2})"), r"\1 `` "),
]
# punctuation isolation
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # sentence-final period (keeps abbreviation/decimal periods attached,
    # the PTB convention; captions virtually always hit this rule)
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
# brackets -> PTB symbols (Stanford default normalization)
_BRACKETS = [
    (re.compile(r"\("), " -LRB- "),
    (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LSB- "),
    (re.compile(r"\]"), " -RSB- "),
    (re.compile(r"\{"), " -LCB- "),
    (re.compile(r"\}"), " -RCB- "),
]
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
# closing quotes
_ENDING_QUOTES = [
    (re.compile(r"\""), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    # possessives and contraction tails split off as their own tokens
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
# irregular contractions the PTB splits mid-word
_CONTRACTIONS = [
    re.compile(r"(?i)\b(can)(?#X)(not)\b"),
    re.compile(r"(?i)\b(d)(?#X)('ye)\b"),
    re.compile(r"(?i)\b(gim)(?#X)(me)\b"),
    re.compile(r"(?i)\b(gon)(?#X)(na)\b"),
    re.compile(r"(?i)\b(got)(?#X)(ta)\b"),
    re.compile(r"(?i)\b(lem)(?#X)(me)\b"),
    re.compile(r"(?i)\b(mor)(?#X)('n)\b"),
    re.compile(r"(?i)\b(wan)(?#X)(na)\s"),
    re.compile(r"(?i) ('t)(?#X)(is)\b"),
    re.compile(r"(?i) ('t)(?#X)(was)\b"),
]


# Abbreviations that keep their trailing period attached when they end a
# token mid-text (the Stanford tokenizer consults an abbreviation
# lexicon; this is the caption-corpus-sized subset).  Initials ("J.") and
# multi-dot tokens ("u.s.", "1.5") are guarded structurally below.
_ABBREV = frozenset(
    "mr mrs ms dr prof sr jr st mt vs etc inc ltd co corp dept fig gen "
    "gov sgt capt col lt ave blvd rd".split()
)


def _split_sentence_periods(toks: List[str]) -> List[str]:
    """Split sentence-ending periods ANYWHERE in the text, not only at
    end-of-string.  The regex rule above anchors at $, so a multi-sentence
    caption ('a man riding a horse. he wears a hat.') kept 'horse.'
    glued — diverging from the Stanford PTBTokenizer, which isolates (and
    the wrapper then drops) every sentence period.  Abbreviations,
    single-letter initials, and tokens with interior dots (u.s., 1.5)
    keep their period, matching the jar's lexicon-guarded behavior."""
    out: List[str] = []
    for t in toks:
        if (
            len(t) > 2
            and t.endswith(".")
            and not t.endswith("..")
            and "." not in t[:-1]
            and t[:-1].lower() not in _ABBREV
        ):
            out.extend([t[:-1], "."])
        else:
            out.append(t)
    return out


def ptb_word_tokenize(text: str) -> List[str]:
    """Penn-Treebank word tokenization of one sentence (case preserved)."""
    s = " " + text.replace("\n", " ").strip() + " "
    for rx, sub in _STARTING_QUOTES:
        s = rx.sub(sub, s)
    for rx, sub in _PUNCTUATION:
        s = rx.sub(sub, s)
    for rx, sub in _BRACKETS:
        s = rx.sub(sub, s)
    s = _DOUBLE_DASHES[0].sub(_DOUBLE_DASHES[1], s)
    s = " " + s + " "
    for rx, sub in _ENDING_QUOTES:
        s = rx.sub(sub, s)
    for rx in _CONTRACTIONS:
        s = rx.sub(r" \1 \2 ", s)
    return _split_sentence_periods(s.split())


def ptb_normalize(text: str) -> str:
    """The reference's full caption normalization: PTB tokenize,
    lowercase (-lowerCase), drop the wrapper's punctuation list
    (ptbtokenizer.py:67-68).  Returns a space-joined token string."""
    toks = [t.lower() for t in ptb_word_tokenize(text)]
    return " ".join(t for t in toks if t not in PUNCTUATIONS)


def ptb_tokenize(captions_for_image: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Dict-level API mirroring PTBTokenizer.tokenize
    (ptbtokenizer.py:30-73): {id: [sentences]} -> {id: [normalized]}."""
    return {
        k: [ptb_normalize(c) for c in v] for k, v in captions_for_image.items()
    }
