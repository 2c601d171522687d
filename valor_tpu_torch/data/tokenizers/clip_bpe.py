"""CLIP byte-pair-encoding tokenizer, self-contained.

Functional equivalent of the reference's vendored SimpleTokenizer
(model/clip_tokenizer.py, 179 LoC): byte->unicode mapping, merge ranks
from the standard `bpe_simple_vocab_16e6.txt.gz` file, whitespace cleanup
and lowercasing, the CLIP word-split regex, and `</w>` end-of-word marker.
sot/eot tokens are `<|startoftext|>` / `<|endoftext|>`.

The vocab file path is configurable; it is the standard public OpenAI
artifact (data, not code).

The PyTorch port's own copy of ``valor_tpu/data/tokenizers/clip_bpe.py``.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable unicode char mapping (GPT-2 scheme).

    Printable latin-1 bytes map to themselves; control/whitespace bytes
    (and 0xa0 NBSP / 0xad soft hyphen) are relocated to codepoints 256+,
    assigned in ascending byte order — the published GPT-2/CLIP convention,
    so merge-table entries line up with the public vocab file.
    """
    def printable(b: int) -> bool:
        return 0x21 <= b <= 0x7E or 0xA1 <= b <= 0xAC or 0xAE <= b <= 0xFF

    # insertion order defines vocab ids downstream: printable bytes first,
    # then the relocated ones — the published ordering
    table: Dict[int, str] = {b: chr(b) for b in range(256) if printable(b)}
    next_cp = 256
    for b in range(256):
        if not printable(b):
            table[b] = chr(next_cp)
            next_cp += 1
    return table


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # ASCII approximation of the CLIP word-split pattern (the `regex`
        # package's \p{L}/\p{N} classes) — adequate for the lowercased
        # English captions this framework tokenizes
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        """Greedy BPE: repeatedly merge the lowest-rank adjacent symbol
        pair (every occurrence, left to right) until no merge applies.

        The end-of-word marker rides the last byte so word-final merges
        rank separately, per the public merge table.
        """
        if token in self.cache:
            return self.cache[token]
        symbols = list(token[:-1]) + [token[-1] + "</w>"]
        while len(symbols) > 1:
            best_rank = None
            best_pair = None
            for pair in zip(symbols, symbols[1:]):
                rank = self.bpe_ranks.get(pair)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_pair = rank, pair
            if best_pair is None:
                break
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) == best_pair:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        out = " ".join(symbols)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: List[int]) -> str:
        text = "".join(self.decoder.get(t, "") for t in tokens)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
