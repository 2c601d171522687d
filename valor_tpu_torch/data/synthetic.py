"""Seeded synthetic data: batches in the collate layout, and a dataset on disk.

Batches (``pretrain_batch``, ``retrieval_batch``, ``qa_batch``) are numpy arrays
shaped as the JAX package's collate gives them (``bert_tokens`` and
``clip_tokens`` [B, N] int64 with pad 0, ``video_pixels`` [B, frames, R, R, 3]
raw uint8, ``audio_spectrograms`` [B, clips, melbins, target_length] float32).
Each row's text has its own length; BERT rows run [CLS] ... [SEP], CLIP rows
start-of-text ... end-of-text (the two largest ids of the CLIP vocabulary).
A retrieval batch also carries the host-only id lists ``ids`` (one per item)
and ``ids_txt`` (one per caption; one caption per item, as in MSR-VTT 1k-A).

``write_retrieval_dataset`` writes an MSR-VTT-shaped dataset that the disk data
path reads: a folder of JPEG frames per id, a mono int16 WAV per id (one id in
``missing_audio_every`` has none), ``txt_mapper`` JSON files (several captions
per training id, one per evaluation id) drawn from a word list, id lists, and
the tokenizer files built from the same word list (a WordPiece vocabulary and
a CLIP BPE merges file).  ``write_caption_dataset`` writes the caption
finetuning files (``{id: [captions]}`` for both splits) and
``write_qa_dataset`` MSR-VTT-QA's (``{id: [{question, answer, question_id}]}``,
1-3 pairs an id, one-word answers); given the paths of an earlier dataset
(``media``), they write only their text files and share its frames, WAVs and
tokenizer files.
"""

from __future__ import annotations

import json
import os
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Sequence

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


def qa_batch(cfg: ModelConfig, questions: int, frames: int = 4, clips: int = 1, n_question: int = 16,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """A QA training batch in ``data/vqa.py:valorqa_collate_train``'s layout:
    question i has 1 + i % 3 weighted answers, tiled into rows (``tile_index``,
    ``answer_weights``) and padded to a multiple of 8 with zero-weight copies
    of row 0; answers [rows, 7] and questions [rows, ``n_question``] in BERT
    ids; media one row a question."""
    media = pretrain_batch(cfg, questions, frames, clips, n_question, seed)
    rng = np.random.RandomState(seed + 1)
    tile = [q for q in range(questions) for _ in range(1 + q % 3)]
    weights = [w for q in range(questions) for w in np.full(1 + q % 3, 1.0 / (1 + q % 3))]
    pad = (-len(tile)) % 8
    tile, weights = tile + [0] * pad, weights + [0.0] * pad
    answers = np.zeros((len(tile), 7), np.int64)
    lengths = rng.randint(1, 6, size=len(tile))
    for i, n in enumerate(lengths):
        answers[i, 1 : n + 1] = rng.randint(min(1000, cfg.fusion_vocab // 2), cfg.fusion_vocab, size=n)
        answers[i, 0], answers[i, n + 1] = 101, 102
    answers[len(tile) - pad :] = answers[0]
    return {"bert_tokens": answers, "question_prompt": media["bert_tokens"][tile],
            "tile_index": np.asarray(tile, np.int32), "answer_weights": np.asarray(weights, np.float32),
            "video_pixels": media["video_pixels"], "audio_spectrograms": media["audio_spectrograms"]}


WORDS = (
    "a", "man", "woman", "is", "playing", "the", "guitar", "dog", "runs", "on", "grass", "cat",
    "sits", "mat", "car", "drives", "down", "road", "person", "cooking", "in", "kitchen", "kids",
    "dance", "stage", "bird", "flies", "over", "water", "people", "talk", "about", "news",
)
QUESTION_WORDS = ("what", "who", "where")


def write_tokenizer_files(root: str, words: Sequence[str] = WORDS) -> Dict[str, str]:
    """A WordPiece vocabulary (special ids 101-103 where bert-base-uncased has
    them) and a CLIP merges file whose merges build each word, both under
    ``root``; returns their paths ("vocab", "merges")."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[unused99]", "[unused100]"] + list(words)
    merges: List[str] = []
    for w in words:
        symbols = list(w[:-1]) + [w[-1] + "</w>"]
        while len(symbols) > 1:
            pair = f"{symbols[0]} {symbols[1]}"
            if pair not in merges:
                merges.append(pair)
            symbols = [symbols[0] + symbols[1]] + symbols[2:]
    paths = {"vocab": os.path.join(root, "vocab.txt"), "merges": os.path.join(root, "merges.txt")}
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(vocab))
    with open(paths["merges"], "w") as f:
        f.write("\n".join(["#version: synthetic"] + merges))
    return paths


def _write_frames(folder: str, n_frames: int, size, seed: int) -> None:
    from PIL import Image

    rng = np.random.RandomState(seed)
    w, h = size
    base = np.asarray(Image.fromarray(rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8))
                      .resize((w + n_frames * 2, h), Image.BILINEAR))
    os.makedirs(folder, exist_ok=True)
    for i in range(n_frames):  # a slow pan over a smooth scene
        Image.fromarray(np.ascontiguousarray(base[:, 2 * i: 2 * i + w])).save(
            os.path.join(folder, f"img_{i:04d}.jpg"), quality=85)


def _write_wav(path: str, seconds: float, sample_rate: int, seed: int) -> None:
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    sig = sum(np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 4000, size=3))
    sig = 0.2 * sig + 0.05 * rng.randn(len(t))
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())


def write_media(root: str, ids: Sequence[str], n_frames: int = 40, frame_size=(320, 240),
                wav_seconds: float = 10.0, sample_rate: int = 22050, missing_audio_every: int = 10,
                seed: int = 0, workers: int = 8) -> Dict[str, str]:
    """The frame folders and WAVs of ``ids`` under ``root``, and the tokenizer
    files; returns the paths "frames", "audio", "vocab", "merges"."""
    os.makedirs(root, exist_ok=True)
    paths = write_tokenizer_files(root, WORDS + QUESTION_WORDS)
    paths.update({k: os.path.join(root, k) for k in ("frames", "audio")})
    os.makedirs(paths["audio"], exist_ok=True)

    def write(i: int) -> None:
        vid = ids[i]
        _write_frames(os.path.join(paths["frames"], vid), n_frames, frame_size, seed + 1 + i)
        if (i + 1) % missing_audio_every:
            _write_wav(os.path.join(paths["audio"], f"{vid}.wav"), wav_seconds, sample_rate,
                       seed + 1 + i)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, range(len(ids))))
    return paths


def _write_splits(root: str, prefix: str, splits: Dict[str, tuple]) -> Dict[str, str]:
    """``{split: (ids, txt json)}`` as ``{split}_id.json`` and
    ``{split}_{prefix}_mapper.json`` under ``root``; returns their paths."""
    os.makedirs(root, exist_ok=True)
    paths = {}
    for split, (split_ids, txt) in splits.items():
        paths[f"{split}_ids"] = os.path.join(root, f"{split}_id.json")
        paths[f"{split}_txt"] = os.path.join(root, f"{split}_{prefix}_mapper.json")
        with open(paths[f"{split}_ids"], "w") as f:
            json.dump(list(split_ids), f)
        with open(paths[f"{split}_txt"], "w") as f:
            json.dump(txt, f)
    return paths


def _ids(n_train: int, n_val: int):
    ids = [f"video{i}" for i in range(n_train + n_val)]
    return ids, ids[:n_train], ids[n_train:]


def _media(root: str, ids, media, **kw) -> Dict[str, str]:
    if media is not None:
        return {k: media[k] for k in ("frames", "audio", "vocab", "merges")}
    return write_media(root, ids, **kw)


def write_retrieval_dataset(
    root: str, n_train: int = 640, n_val: int = 256, n_frames: int = 40, frame_size=(320, 240),
    wav_seconds: float = 10.0, sample_rate: int = 22050, missing_audio_every: int = 10,
    captions_per_train_id: int = 20, seed: int = 0, workers: int = 8,
) -> Dict[str, str]:
    """Write the dataset under ``root`` (defaults: MSR-VTT's shapes, 10 s clips at
    4 fps and 22050 Hz) and return its paths: "train_ids", "train_txt",
    "val_ids", "val_txt", "frames", "audio", "vocab", "merges"."""
    rng = np.random.RandomState(seed)
    ids, train, val = _ids(n_train, n_val)

    def caption() -> str:
        return " ".join(rng.choice(WORDS, size=rng.randint(5, 13)))

    paths = _write_splits(root, "txt", {
        "train": (train, {v: [caption() for _ in range(captions_per_train_id)] for v in train}),
        "val": (val, {v: caption() for v in val})})
    paths.update(write_media(root, ids, n_frames, frame_size, wav_seconds, sample_rate,
                             missing_audio_every, seed, workers))
    return paths


def write_caption_dataset(root: str, n_train: int = 320, n_val: int = 128,
                          captions_per_id: int = 20, seed: int = 0, media=None,
                          **media_kw) -> Dict[str, str]:
    """Caption finetuning files, ``{id: [captions]}`` with ``captions_per_id``
    captions a training id and as many references an evaluation id; the media
    of ``media`` (an earlier writer's paths) or written here (``media_kw`` as
    ``write_media``'s).  Returns the paths of ``write_retrieval_dataset``."""
    rng = np.random.RandomState(seed + 1)
    ids, train, val = _ids(n_train, n_val)

    def captions():
        return [" ".join(rng.choice(WORDS, size=rng.randint(5, 13))) for _ in range(captions_per_id)]

    paths = _write_splits(root, "caption", {"train": (train, {v: captions() for v in train}),
                                            "val": (val, {v: captions() for v in val})})
    paths.update(_media(root, ids, media, seed=seed, **media_kw))
    return paths


def write_qa_dataset(root: str, n_train: int = 320, n_val: int = 128, max_pairs: int = 3,
                     seed: int = 0, media=None, **media_kw) -> Dict[str, str]:
    """MSR-VTT-QA-style files, ``{id: [{question, answer, question_id}]}`` with
    1 to ``max_pairs`` pairs an id, a "what/who/where ..." question and a
    one-word answer from the word list; media as ``write_caption_dataset``."""
    rng = np.random.RandomState(seed + 2)
    ids, train, val = _ids(n_train, n_val)
    qid = iter(range(10 ** 9))

    def pairs():
        return [{"question": " ".join([str(rng.choice(QUESTION_WORDS))]
                                      + list(rng.choice(WORDS, size=rng.randint(3, 9)))),
                 "answer": str(rng.choice(WORDS)), "question_id": next(qid)}
                for _ in range(rng.randint(1, max_pairs + 1))]

    paths = _write_splits(root, "qa", {"train": (train, {v: pairs() for v in train}),
                                       "val": (val, {v: pairs() for v in val})})
    paths.update(_media(root, ids, media, seed=seed, **media_kw))
    return paths
