"""Offline preprocessing of the port (counterpart of ``valor_tpu/cli/extract.py``):
videos -> jpg frame dirs + 22050 Hz mono wavs.

    python -m valor_tpu_torch.cli.extract --video_dir in/ --out_dir data/ \
        [--fps 4] [--workers 8]

Equivalent of the reference's utils/extract_frame_and_wav_multiprocess.py
(ffmpeg fan-out over a process pool); output layout matches the dataset
directories that ``cli.train``'s mappers read (``frames_fps4/<id>/img_XXXX.jpg``,
``audio_22050hz/<id>.wav``, README.md layout).  ffmpeg must be on PATH.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from concurrent.futures import ProcessPoolExecutor

from valor_tpu_torch.core.logging import LOGGER

VIDEO_EXTS = (".mp4", ".mkv", ".avi", ".webm", ".mov")


def process_one(args) -> str:
    src, frames_root, audio_root, fps = args
    vid = os.path.splitext(os.path.basename(src))[0]
    frame_dir = os.path.join(frames_root, vid)
    os.makedirs(frame_dir, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", src,
         "-vf", f"fps={fps}", os.path.join(frame_dir, "img_%04d.jpg")],
        check=False,
    )
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", src,
         "-ac", "1", "-ar", "22050", os.path.join(audio_root, f"{vid}.wav")],
        check=False,
    )
    return vid


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--fps", type=int, default=4)
    parser.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    args = parser.parse_args(argv)

    frames_root = os.path.join(args.out_dir, f"frames_fps{args.fps}")
    audio_root = os.path.join(args.out_dir, "audio_22050hz")
    os.makedirs(frames_root, exist_ok=True)
    os.makedirs(audio_root, exist_ok=True)

    videos = [
        os.path.join(args.video_dir, f)
        for f in sorted(os.listdir(args.video_dir))
        if f.lower().endswith(VIDEO_EXTS)
    ]
    LOGGER.info(f"extracting {len(videos)} videos with {args.workers} workers")
    jobs = [(v, frames_root, audio_root, args.fps) for v in videos]
    with ProcessPoolExecutor(max_workers=args.workers) as pool:
        for i, vid in enumerate(pool.map(process_one, jobs)):
            if (i + 1) % 100 == 0:
                LOGGER.info(f"{i + 1}/{len(videos)} done")


if __name__ == "__main__":
    main()
