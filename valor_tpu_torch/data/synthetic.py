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
tokenizer files.  ``write_sharp_init_run`` writes a run directory of untrained
weights by the sharp init law.
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
    clip_name = next((n for n in (cfg.video_encoder_type, cfg.txt_encoder_type) if n.startswith("clip")),
                     "clip_vit_base_16")  # CLIP ids are unused where neither tower is CLIP
    clip_vocab = text_preset(clip_name).vocab_size
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


# -- video clips, and an ffmpeg stand-in ----------------------------------------
# The stand-in's container is an npz under a video name: ``frames`` [n, H, W, 3]
# uint8 at ``fps`` frames a second and, unless the clip is silent, ``audio``
# (float32 mono) at ``sample_rate``.
FFMPEG_STAND_IN = r'''#!{python}
"""ffmpeg stand-in: the two argument forms of the extraction CLIs, read from
the npz container that write_video_clip writes."""
import os, sys, wave
import numpy as np
from PIL import Image

args = sys.argv[1:]
src, out = args[args.index("-i") + 1], args[-1]
try:
    clip = np.load(src)
    frames, fps = clip["frames"], float(clip["fps"])
except Exception as e:
    sys.exit(f"{{src}}: {{e}}")
if "-vf" in args:
    want = float(args[args.index("-vf") + 1].split("=")[1])
    n = int(len(frames) / fps * want)
    for k in range(n):
        Image.fromarray(frames[min(int(round(k * fps / want)), len(frames) - 1)]).save(out % (k + 1), quality=95)
else:
    if "audio" not in clip:
        sys.exit(f"{{src}}: no audio stream")
    rate = int(args[args.index("-ar") + 1])
    audio, sr = clip["audio"], int(clip["sample_rate"])
    t = np.arange(int(len(audio) * rate / sr)) / rate
    audio = np.interp(t, np.arange(len(audio)) / sr, audio)
    with wave.open(out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
'''


def write_ffmpeg_stand_in(bin_dir: str) -> str:
    """An executable ``ffmpeg`` under ``bin_dir`` (put it at the front of
    ``PATH``) that serves the two ffmpeg calls of ``cli/infer.py`` and
    ``cli/extract.py`` (frames at ``-vf fps=N`` as JPEGs, and a mono ``-ar R``
    WAV) from the container of ``write_video_clip``; returns its path."""
    import sys

    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "ffmpeg")
    with open(path, "w") as f:
        f.write(FFMPEG_STAND_IN.format(python=sys.executable))
    os.chmod(path, 0o755)
    return path


def write_video_clip(path: str, seconds: float = 10.0, size=(320, 240), fps: int = 4,
                     tone_hz: float = 440.0, sample_rate: int = 22050, silent: bool = False,
                     seed: int = 0, ffmpeg: str = "") -> str:
    """A clip of a slow pan over a smooth scene with a tone: an MPEG-4 file
    encoded by ``ffmpeg`` (the path of a real one), or, without it, the
    stand-in's container.  Returns ``path``."""
    import subprocess
    import tempfile

    from PIL import Image

    rng = np.random.RandomState(seed)
    w, h = size
    n = int(seconds * fps)
    base = np.asarray(Image.fromarray(rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8))
                      .resize((w + n * 2, h), Image.BILINEAR))
    frames = np.stack([base[:, 2 * i: 2 * i + w] for i in range(n)])
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    audio = (0.3 * np.sin(2 * np.pi * tone_hz * t) + 0.02 * rng.randn(len(t))).astype(np.float32)
    if not ffmpeg:
        arrays = dict(frames=frames, fps=np.float32(fps), sample_rate=np.int64(sample_rate))
        if not silent:
            arrays["audio"] = audio
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return path
    with tempfile.TemporaryDirectory() as tmp:
        for i, fr in enumerate(frames):
            Image.fromarray(fr).save(os.path.join(tmp, f"{i:04d}.png"))
        cmd = [ffmpeg, "-y", "-loglevel", "error", "-framerate", str(fps), "-i", os.path.join(tmp, "%04d.png")]
        if not silent:
            _write_wav_array(os.path.join(tmp, "tone.wav"), audio, sample_rate)
            cmd += ["-i", os.path.join(tmp, "tone.wav"), "-c:a", "aac"]
        subprocess.run(cmd + ["-c:v", "mpeg4", "-q:v", "2", "-pix_fmt", "yuv420p", "-shortest", path],
                       check=True)
    return path


def _write_wav_array(path: str, audio: np.ndarray, sample_rate: int) -> None:
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())


# -- checkpoints in the released layouts ---------------------------------------
# Random values under the key names and shapes of the files that
# ``models/convert.py`` reads: OpenAI CLIP (a JIT archive), HuggingFace
# bert-base-uncased, the AudioSet AST checkpoint and a whole VALOR training
# checkpoint, at the widths of a ``ModelConfig``.  LayerNorm scales are near 1,
# every other value N(0, 0.02).


def _clip_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    from valor_tpu_torch.models.clip import vision_preset

    v = vision_preset(cfg.video_encoder_type, cfg.video_resolution)
    t = text_preset(cfg.txt_encoder_type if cfg.txt_encoder_type.startswith("clip") else cfg.video_encoder_type)
    grid = v.resolution // v.patch_size
    out = {
        "visual.conv1.weight": (v.width, 3, v.patch_size, v.patch_size),
        "visual.class_embedding": (v.width,),
        "visual.positional_embedding": (1 + grid * grid, v.width),
        "visual.ln_pre.weight": (v.width,), "visual.ln_pre.bias": (v.width,),
        "visual.ln_post.weight": (v.width,), "visual.ln_post.bias": (v.width,),
        "visual.proj": (v.width, t.embed_dim),
        "token_embedding.weight": (t.vocab_size, t.width),
        "positional_embedding": (t.context_length, t.width),
        "ln_final.weight": (t.width,), "ln_final.bias": (t.width,),
        "text_projection": (t.width, t.embed_dim),
        "logit_scale": (),
    }
    for tower, n, w in (("visual.transformer.resblocks", v.layers, v.width),
                        ("transformer.resblocks", t.layers, t.width)):
        for i in range(n):
            p = f"{tower}.{i}"
            out.update({
                f"{p}.ln_1.weight": (w,), f"{p}.ln_1.bias": (w,),
                f"{p}.ln_2.weight": (w,), f"{p}.ln_2.bias": (w,),
                f"{p}.attn.in_proj_weight": (3 * w, w), f"{p}.attn.in_proj_bias": (3 * w,),
                f"{p}.attn.out_proj.weight": (w, w), f"{p}.attn.out_proj.bias": (w,),
                f"{p}.mlp.c_fc.weight": (4 * w, w), f"{p}.mlp.c_fc.bias": (4 * w,),
                f"{p}.mlp.c_proj.weight": (w, 4 * w), f"{p}.mlp.c_proj.bias": (w,),
            })
    return out


def _bert_shapes(cfg: ModelConfig, cross: bool = False) -> Dict[str, tuple]:
    """HuggingFace names without the ``bert.`` prefix; with ``cross``, VALOR's
    cross-attention block in every layer and the prompt-type embedding."""
    h, f = cfg.fusion_hidden, cfg.fusion_intermediate
    out = {
        "embeddings.word_embeddings.weight": (cfg.fusion_vocab, h),
        "embeddings.position_embeddings.weight": (512, h),
        "embeddings.token_type_embeddings.weight": (2, h),
        "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
    }
    if cross:
        out["embeddings.prompt_embedding.weight"] = (1, h)
    for i in range(cfg.fusion_layers):
        p = f"encoder.layer.{i}"
        blocks = [f"{p}.attention.self"] + ([f"{p}.cross_attn.cross"] if cross else [])
        for b in blocks:
            for qkv in ("query", "key", "value"):
                out[f"{b}.{qkv}.weight"], out[f"{b}.{qkv}.bias"] = (h, h), (h,)
        outs = [f"{p}.attention.output"] + ([f"{p}.cross_attn.output"] if cross else [])
        for o in outs:
            out.update({f"{o}.dense.weight": (h, h), f"{o}.dense.bias": (h,),
                        f"{o}.LayerNorm.weight": (h,), f"{o}.LayerNorm.bias": (h,)})
        out.update({
            f"{p}.intermediate.dense.weight": (f, h), f"{p}.intermediate.dense.bias": (f,),
            f"{p}.output.dense.weight": (h, f), f"{p}.output.dense.bias": (h,),
            f"{p}.output.LayerNorm.weight": (h,), f"{p}.output.LayerNorm.bias": (h,),
        })
    return out


def _ast_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The AudioSet AST checkpoint (``module.v.*``, a 12 x 101 patch grid)."""
    h, f, p = cfg.audio_hidden, cfg.audio_intermediate, cfg.audio_patch_size
    out = {
        "module.v.cls_token": (1, 1, h), "module.v.dist_token": (1, 1, h),
        "module.v.pos_embed": (1, 2 + 12 * 101, h),
        "module.v.patch_embed.proj.weight": (h, 1, p, p), "module.v.patch_embed.proj.bias": (h,),
        "module.v.norm.weight": (h,), "module.v.norm.bias": (h,),
    }
    for i in range(cfg.audio_layers):
        b = f"module.v.blocks.{i}"
        out.update({
            f"{b}.norm1.weight": (h,), f"{b}.norm1.bias": (h,),
            f"{b}.norm2.weight": (h,), f"{b}.norm2.bias": (h,),
            f"{b}.attn.qkv.weight": (3 * h, h), f"{b}.attn.qkv.bias": (3 * h,),
            f"{b}.attn.proj.weight": (h, h), f"{b}.attn.proj.bias": (h,),
            f"{b}.mlp.fc1.weight": (f, h), f"{b}.mlp.fc1.bias": (f,),
            f"{b}.mlp.fc2.weight": (h, f), f"{b}.mlp.fc2.bias": (h,),
        })
    return out


def _valor_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """A whole VALOR training checkpoint under the reference's attribute names
    (modeling.py:341-351, :569, :605, :635, :651; pretrain.py:89-119)."""
    h, ah, f, c = cfg.fusion_hidden, cfg.audio_hidden, cfg.audio_intermediate, cfg.contra_dim
    clip = _clip_shapes(cfg)
    out = {f"clip_model.{k}": s for k, s in clip.items()}
    out["clip_model.prompt_embedding.weight"] = (1, clip["positional_embedding"][1])
    out.update({f"multimodal_encoder.{k}": s for k, s in _bert_shapes(cfg, cross=True).items()})
    out.update({"cls.dense.weight": (h, h), "cls.dense.bias": (h,), "cls.layernorm.weight": (h,),
                "cls.layernorm.bias": (h,), "cls.decoder.weight": (cfg.fusion_vocab, h),
                "cls.decoder.bias": (cfg.fusion_vocab,)})
    n_audio = (cfg.audio_melbins // cfg.audio_patch_size) * (cfg.audio_target_length // cfg.audio_patch_size)
    out.update({"audio_embeddings.cls_token": (1, 1, ah),
                "audio_embeddings.first_conv.weight": (ah, 1, cfg.audio_patch_size, cfg.audio_patch_size),
                "audio_embeddings.first_conv.bias": (ah,),
                "audio_embeddings.position_embeddings.weight": (1 + n_audio, ah),
                "audio_encoder.last_layernorm.weight": (ah,), "audio_encoder.last_layernorm.bias": (ah,)})
    for i in range(cfg.audio_layers):
        p = f"audio_encoder.layer.{i}"
        for j in range(4):
            out[f"{p}.attention.linears.{j}.weight"], out[f"{p}.attention.linears.{j}.bias"] = (ah, ah), (ah,)
        out.update({f"{p}.ff_layer.linear1.weight": (f, ah), f"{p}.ff_layer.linear1.bias": (f,),
                    f"{p}.ff_layer.linear2.weight": (ah, f), f"{p}.ff_layer.linear2.bias": (ah,),
                    f"{p}.layernorm1.weight": (ah,), f"{p}.layernorm1.bias": (ah,),
                    f"{p}.layernorm2.weight": (ah,), f"{p}.layernorm2.bias": (ah,)})
    out["contra_head_a.linear.weight"] = (c, ah)
    for name in ("text_fine_weight", "video_fine_weight", "audio_fine_weight"):
        out.update({f"{name}.0.weight": (c, c), f"{name}.0.bias": (c,),
                    f"{name}.2.weight": (1, c), f"{name}.2.bias": (1,)})
    out.update({"contra_temp": (), "video_type_embeddings": (1, 1, h), "audio_type_embeddings": (1, 1, h),
                "video_frame_embedding": (1, 32, h), "audio_frame_embedding": (1, 32, h)})
    return out


def _random_tensors(shapes: Dict[str, tuple], seed: int) -> Dict[str, Any]:
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in shapes.items():
        t = torch.randn(shape, generator=gen) * 0.02
        last = k.rsplit(".", 1)[-1]
        if len(shape) == 1 and last in ("weight", "gamma") and ("norm" in k.lower() or ".ln" in k):
            t += 1.0  # a LayerNorm scale
        out[k] = t
    return out


def released_state_dicts(cfg: ModelConfig, seed: int = 0) -> Dict[str, Dict[str, Any]]:
    """{"clip", "bert", "ast", "valor"}: seeded state dicts in the released
    layouts at ``cfg``'s widths (BERT with the ``bert.`` prefix, its
    ``gamma``/``beta`` LayerNorm names and the masked-LM head)."""
    bert = {f"bert.{k}".replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta"): s
            for k, s in _bert_shapes(cfg).items()}
    h = cfg.fusion_hidden
    bert.update({"cls.predictions.transform.dense.weight": (h, h), "cls.predictions.transform.dense.bias": (h,),
                 "cls.predictions.transform.LayerNorm.gamma": (h,), "cls.predictions.transform.LayerNorm.beta": (h,),
                 "cls.predictions.bias": (cfg.fusion_vocab,), "cls.predictions.decoder.weight": (cfg.fusion_vocab, h)})
    shapes = {"clip": _clip_shapes(cfg), "bert": bert, "ast": _ast_shapes(cfg), "valor": _valor_shapes(cfg)}
    return {name: _random_tensors(s, seed + i) for i, (name, s) in enumerate(shapes.items())}


def save_jit_archive(state_dict: Dict[str, Any], path: str) -> None:
    """``state_dict`` as the parameters of a scripted module saved with
    ``torch.jit.save``, as OpenAI's CLIP files are."""
    import torch
    from torch import nn

    class Holder(nn.Module):
        def forward(self):
            return torch.zeros(1)

    root = Holder()
    for key, val in state_dict.items():
        *parts, leaf = key.split(".")
        m = root
        for p in parts:
            if not hasattr(m, p):
                setattr(m, p, nn.Module())
            m = getattr(m, p)
        m.register_parameter(leaf, nn.Parameter(val, requires_grad=False))
    torch.jit.save(torch.jit.script(root), path)


def write_released_checkpoints(root: str, cfg: ModelConfig, seed: int = 0) -> Dict[str, str]:
    """The four files under ``root`` with the names ``cli/build.py`` looks up:
    ``clip-vit-base-16.pt`` (a JIT archive; the name follows
    ``video_encoder_type``), ``bert-base-uncased.bin``,
    ``audioset_10_10_0.4593.pth`` (a ``{"model": ...}`` pickle, as the AST
    release wraps it) and ``valor.pt`` (a whole VALOR checkpoint); returns
    {"clip", "bert", "ast", "valor"} -> path."""
    import torch

    from valor_tpu_torch.cli.build import _AST_WEIGHTS, _BERT_WEIGHTS, _CLIP_WEIGHTS

    os.makedirs(root, exist_ok=True)
    sds = released_state_dicts(cfg, seed)
    paths = {"clip": os.path.join(root, _CLIP_WEIGHTS.get(cfg.video_encoder_type, "clip.pt")),
             "bert": os.path.join(root, _BERT_WEIGHTS), "ast": os.path.join(root, _AST_WEIGHTS),
             "valor": os.path.join(root, "valor.pt")}
    save_jit_archive(sds.pop("clip"), paths["clip"])
    torch.save(sds.pop("bert"), paths["bert"])
    torch.save({"model": sds.pop("ast")}, paths["ast"])
    torch.save(sds.pop("valor"), paths["valor"])
    return paths


def write_sharp_init_run(run_dir: str, cfg: ModelConfig) -> str:
    """A run directory holding untrained weights of ``VALORModel(cfg)``, drawn
    from seed 0 by the sharp init law (``models/bridge.py:init_params``), as its checkpoint
    ``ckpt/step_0``, the layout ``cli.train --checkpoint``, ``cli.infer`` and
    ``cli.serve`` read.  ``cli.train`` itself starts from the JAX package's
    law; a run whose captions must depend on their media at random weights
    starts from these.  Returns ``run_dir``."""
    import torch

    from valor_tpu_torch.models.bridge import init_params

    path = os.path.join(run_dir, "ckpt", "step_0")
    os.makedirs(path, exist_ok=True)
    torch.save({"params": init_params(cfg, 0, "cpu", law="sharp"), "step": 0}, os.path.join(path, "state.pt"))
    return run_dir
