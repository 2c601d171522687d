"""Single-video inference CLI of the port (counterpart of ``valor_tpu/cli/infer.py``).

    python -m valor_tpu_torch.cli.infer --video_path x.mp4 --task cap%tva \
        --config configs/caption-msrvtt.json --checkpoint <run dir> [--device cpu]

Equivalent of the reference's inference.py:19-321: extract frames (1 fps) and
a mono 22050 Hz wav with ffmpeg, build a one-item batch (float pixels from
``VideoMapper``, host log-mel clips from ``AudioMapper``), generate, and print
one ``[group] caption`` line per caption group.  ``--image_path`` captions one
image with silent audio.  ffmpeg must be on PATH for a video.
``--checkpoint`` names one of the port's own run directories (its latest
``ckpt/step_N``; ``FileNotFoundError`` where there is none, where the JAX
package would caption with random weights); without it the weights are random
from seed 0.  The model runs on the CUDA card unless ``--device`` names
another device.  A config with ``use_task_prompt`` generates with the task
prompts, as serving and evaluation do (the caption prompt, and the QA prompt's
body after the ``[CLS]`` of a ``--question``); the JAX package's CLI applies
none there.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time
from typing import Any, Dict

import numpy as np


def extract_frames_and_wav(video_path: str, out_dir: str, fps: int = 1) -> None:
    frames_dir = os.path.join(out_dir, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
         "-vf", f"fps={fps}", os.path.join(frames_dir, "img_%04d.jpg")],
        check=True,
    )
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
         "-ac", "1", "-ar", "22050", os.path.join(out_dir, "audio.wav")],
        check=False,  # silent videos are fine (zero spectrogram)
    )


def main(argv=None) -> Dict[str, Any]:
    """Caption (or answer) one video or image and print the captions.  Returns
    {"captions": {group: text}, "sequences": {group: ids}, "batch": the
    one-item batch, "seconds": {"extract", "featurize", "build", "generate"}}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_path", default=None)
    parser.add_argument("--image_path", default=None)
    parser.add_argument("--task", default="cap%tva")
    parser.add_argument("--question", default=None)
    parser.add_argument("--config", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--video_sample_num", type=int, default=8)
    parser.add_argument("--audio_sample_num", type=int, default=2)
    parser.add_argument("--beam_size", type=int, default=3)
    parser.add_argument("--device", default=None, help="torch device; the CUDA card by default")
    args = parser.parse_args(argv)

    from valor_tpu_torch.cli.build import build_tokenizers, model_weights
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.device import resolve_device
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.pipeline import AudioMapper, VideoMapper
    from valor_tpu_torch.data.prompts import maybe_prompt_table
    from valor_tpu_torch.eval.generate import Generator
    from valor_tpu_torch.eval.validate import decode_sequence
    from valor_tpu_torch.models.bridge import load_model

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    spec = parse_task(args.task)
    tokenizers = build_tokenizers(cfg.model)
    bert_tok, _ = tokenizers
    seconds = {"extract": 0.0}

    t0 = time.perf_counter()
    if args.image_path:
        vm = VideoMapper(
            os.path.dirname(os.path.abspath(args.image_path)) or ".",
            resolution=cfg.model.video_resolution,
            sample_num=1,
            datatype="image",
            encoder_type=cfg.model.video_encoder_type,
            training=False,
        )
        video = vm[os.path.basename(args.image_path)]
        audio = np.zeros(
            (args.audio_sample_num, cfg.model.audio_melbins, cfg.model.audio_target_length),
            np.float32,
        )
    else:
        if not args.video_path:
            raise ValueError("--video_path or --image_path required")
        with tempfile.TemporaryDirectory() as tmp:
            extract_frames_and_wav(args.video_path, tmp)
            seconds["extract"] = time.perf_counter() - t0
            vm = VideoMapper(
                os.path.join(tmp),
                resolution=cfg.model.video_resolution,
                sample_num=args.video_sample_num,
                datatype="video",
                encoder_type=cfg.model.video_encoder_type,
                training=False,
            )
            video = vm["frames"]
            am = AudioMapper(
                tmp,
                sample_num=args.audio_sample_num,
                melbins=cfg.model.audio_melbins,
                target_length=cfg.model.audio_target_length,
                training=False,
            )
            audio = am["audio"]
    if video is None:  # the mapper's unreadable-media signal
        raise FileNotFoundError(f"no readable frames in {args.video_path or args.image_path}")

    batch = {
        "video_pixels": video[None].astype(np.float32),
        "audio_spectrograms": audio[None].astype(np.float32),
    }
    table = maybe_prompt_table(cfg.model, tokenizers)
    if table is not None:
        batch["prompt_tokens_caption"] = table.caption()
    if args.question:
        body = table.qa_body()[0].tolist() if table is not None else []
        q = [bert_tok.cls_token_id] + body + bert_tok.encode(args.question) + [bert_tok.sep_token_id]
        batch["question_prompt"] = np.asarray(q, np.int32)[None]
    seconds["featurize"] = time.perf_counter() - t0 - seconds["extract"]

    t0 = time.perf_counter()
    model = load_model(cfg.model, model_weights(cfg.model, args.checkpoint, device), device)
    seconds["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = Generator(model).generate(
        batch,
        spec.caption_groups,
        caption_type=cfg.model.caption_type,
        max_len=cfg.model.max_generation_len,
        beam_size=args.beam_size,
    )
    sequences = {g: out[f"generated_sequences_{g}"][0].cpu().numpy() for g in spec.caption_groups}
    seconds["generate"] = time.perf_counter() - t0
    captions = {g: decode_sequence(bert_tok, seq) for g, seq in sequences.items()}
    for g, text in captions.items():
        print(f"[{g}] {text}")
    return {"captions": captions, "sequences": sequences, "batch": batch, "seconds": seconds}


if __name__ == "__main__":
    main()
