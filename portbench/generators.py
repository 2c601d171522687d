"""The benchmark's traffic: the inputs of every cell, from the seed and a mix's parameters.

A traffic mix is ``traffic/<name>.json``.  Its ``kind`` picks the cell kind
(``kinds/<kind>.py``) and its other keys are read here:

  * ``pretrain``: a pool of ``pool`` batches in the collate layout, each of
    ``batch`` rows: ``frames`` uint8 frames at the configuration's resolution,
    ``clips`` log-mel clips, BERT and CLIP text rows of ``n_txt`` slots holding
    ``min_txt``-``n_txt`` tokens (begin and end ids included); with
    ``prompt_contra``/``prompt_caption`` lengths, the task prompts' rows;
  * ``serve``: a pool of ``pool`` distinct requests (``frames`` uint8 frames,
    ``clips`` clip-span waveforms of the filterbank's ``target_length``
    frames, all valid) and an open loop of arrivals at ``rate`` a second.  The
    gaps between arrivals are the quantiles of the exponential distribution
    at ``rate`` (a Poisson process), in an order drawn from the seed: every
    seed offers the same number of requests over the same seconds.

Everything is drawn on the host from ``numpy``'s PCG64 seeded with the seed,
so the same seed gives the same inputs.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.reference.model import TEXT

BERT_CLS, BERT_SEP = 101, 102


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([int(seed) & (2**64 - 1), stream]))


def _text(rng, rows: int, slots: int, lo: int, vocab_lo: int, vocab_hi: int, first: int, last: int):
    lengths = rng.integers(lo, slots + 1, size=rows)
    ids = rng.integers(vocab_lo, vocab_hi, size=(rows, slots))
    ids[np.arange(slots)[None, :] >= lengths[:, None]] = 0
    ids[:, 0] = first
    ids[np.arange(rows), lengths - 1] = last
    return ids.astype(np.int64)


def prompt_rows(traffic: Dict[str, Any], cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The task prompts' token rows ([1, P]) where the mix gives their lengths."""
    rng = _rng(seed, 3)
    clip_vocab = _clip_vocab(cfg)
    out = {}
    if traffic.get("prompt_contra"):
        out["prompt_tokens_contra"] = _text(rng, 1, traffic["prompt_contra"], traffic["prompt_contra"], 1,
                                            clip_vocab - 2, clip_vocab - 2, clip_vocab - 1)
    if traffic.get("prompt_caption"):
        vocab = cfg.get("fusion_vocab", 30522)
        out["prompt_tokens_caption"] = _text(rng, 1, traffic["prompt_caption"], traffic["prompt_caption"],
                                             min(1000, vocab // 2), vocab, BERT_CLS, BERT_SEP)
    return out


def _clip_vocab(cfg: dict) -> int:
    return TEXT[cfg.get("txt_encoder_type", "clip_vit_base_16")][2]


def pretrain_pool(traffic: Dict[str, Any], cfg: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    rng = _rng(seed, 1)
    clip_vocab = _clip_vocab(cfg)
    b, n = traffic["batch"], traffic["n_txt"]
    r = cfg.get("video_resolution", 224)
    mel, t = cfg.get("audio_melbins", 64), cfg.get("audio_target_length", 512)
    vocab = cfg.get("fusion_vocab", 30522)
    prompts = prompt_rows(traffic, cfg, seed)
    pool = []
    for _ in range(traffic["pool"]):
        batch = {
            "bert_tokens": _text(rng, b, n, traffic["min_txt"], min(1000, vocab // 2), vocab, BERT_CLS, BERT_SEP),
            "clip_tokens": _text(rng, b, n, traffic["min_txt"], 1, clip_vocab - 2, clip_vocab - 2, clip_vocab - 1),
            "video_pixels": rng.integers(0, 256, size=(b, traffic["frames"], r, r, 3), dtype=np.uint8),
            "audio_spectrograms": rng.standard_normal((b, traffic["clips"], mel, t), dtype=np.float32),
        }
        batch.update(prompts)
        pool.append(batch)
    return pool


def clip_span_samples(target_length: int = 512, sample_frequency: int = 22050, shift_ms: float = 10.0,
                      length_ms: float = 25.0) -> int:
    """Samples that cover ``target_length`` frames of the filterbank (snip edges)."""
    shift = int(sample_frequency * shift_ms / 1000.0)
    win = int(sample_frequency * length_ms / 1000.0)
    return (target_length - 1) * shift + win


def serve_pool(traffic: Dict[str, Any], cfg: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    rng = _rng(seed, 2)
    r = cfg.get("video_resolution", 224)
    t = cfg.get("audio_target_length", 512)
    samples = clip_span_samples(t)
    pool = []
    for _ in range(traffic["pool"]):
        pool.append({
            "video_pixels": rng.integers(0, 256, size=(traffic["frames"], r, r, 3), dtype=np.uint8),
            "audio_waveforms": (0.1 * rng.standard_normal((traffic["clips"], samples), dtype=np.float32)),
            "audio_valid_frames": np.full((traffic["clips"],), t, np.int64),
        })
    return pool


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds) of round(rate * seconds) requests."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = _rng(seed, 4).permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due * (seconds / gaps.sum())


def request_items(n: int, pool: int, seed: int) -> np.ndarray:
    """Which pool item each of ``n`` requests sends: every item in turn, in orders drawn from the seed."""
    rng = _rng(seed, 5)
    reps = -(-n // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:n]
