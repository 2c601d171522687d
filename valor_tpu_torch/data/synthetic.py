"""Seeded synthetic pretraining and retrieval batches in the collate layout.

The port trains on these until the disk data path is ported: numpy arrays
shaped as the JAX package's collate gives them (``bert_tokens`` and
``clip_tokens`` [B, N] int64 with pad 0, ``video_pixels`` [B, frames, R, R, 3]
raw uint8, ``audio_spectrograms`` [B, clips, melbins, target_length] float32).
Each row's text has its own length; BERT rows run [CLS] ... [SEP], CLIP rows
start-of-text ... end-of-text (the two largest ids of the CLIP vocabulary).
A retrieval batch also carries the host-only id lists ``ids`` (one per item)
and ``ids_txt`` (one per caption; one caption per item, as in MSR-VTT 1k-A).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from valor_tpu_torch.core.config import ModelConfig
from valor_tpu_torch.models.clip import text_preset


def pretrain_batch(cfg: ModelConfig, batch: int, frames: int = 4, clips: int = 1,
                   n_txt: int = 40, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    lengths = rng.randint(max(3, n_txt // 2), n_txt + 1, size=batch)
    clip_vocab = text_preset(cfg.video_encoder_type).vocab_size
    bert = np.zeros((batch, n_txt), np.int64)
    clip = np.zeros((batch, n_txt), np.int64)
    for i, n in enumerate(lengths):
        bert[i, :n] = rng.randint(min(1000, cfg.fusion_vocab // 2), cfg.fusion_vocab, size=n)
        bert[i, 0], bert[i, n - 1] = 101, 102
        clip[i, :n] = rng.randint(1, clip_vocab - 2, size=n)
        clip[i, 0], clip[i, n - 1] = clip_vocab - 2, clip_vocab - 1
    r = cfg.video_resolution
    return {
        "bert_tokens": bert,
        "clip_tokens": clip,
        "video_pixels": rng.randint(0, 256, size=(batch, frames, r, r, 3), dtype=np.uint8),
        "audio_spectrograms": rng.randn(
            batch, clips, cfg.audio_melbins, cfg.audio_target_length).astype(np.float32),
    }


def retrieval_batch(cfg: ModelConfig, batch: int, frames: int = 8, clips: int = 2,
                    n_txt: int = 32, seed: int = 0, id_offset: int = 0) -> Dict[str, Any]:
    """A pretraining batch plus ``ids`` ``video{id_offset} ...`` and the same
    ``ids_txt``: item i's caption is row i."""
    out: Dict[str, Any] = dict(pretrain_batch(cfg, batch, frames, clips, n_txt, seed))
    out["ids"] = [f"video{id_offset + i}" for i in range(batch)]
    out["ids_txt"] = list(out["ids"])
    return out
