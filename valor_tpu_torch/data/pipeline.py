"""Host-side input pipeline: mappers, dataset, collate (the PyTorch port's copy
of ``valor_tpu/data/pipeline.py``).

Reproduces the reference data layer (data/data.py) with numpy outputs and
**static shapes** per (task, flow):

  * TxtMapper: text clean (dedupe spaces, lowercase, strip punctuation,
    data/data.py:105-111), dual tokenization (BERT + CLIP, :87-104),
    CLS/SEP | SOT/EOT framing and zero-pad to max_len+2 (:113-127).
  * VideoMapper: frame-dir listing + uniform-chunk sampling (random in
    train / centre in eval, :176-199 with split() :240-244), PIL decode,
    resize/crop_flip transforms, CLIP or ImageNet normalisation (:145-173),
    or raw uint8 rows that ``VALORModel.encode_video`` normalises on the
    device.  Video frames with ``transforms == "none"`` decode through the
    C++ decoder (``data/native.py``, the port's own build of the JAX
    package's ``native/``) where it builds, as the JAX mapper's do; it is not
    pixel-equal to PIL (its test asks for correlation > 0.98).
  * AudioMapper: wav -> kaldi-style log-mel clips (:269-323) via
    ``data/fbank.py:fbank_np``, or clip-span waveforms for the device fbank
    (``device_fbank``); zero spectrogram (or ``valid_frames == -1``) when
    the wav is missing (:272-275).
  * VALORDataset: corrupt-sample resample-with-log (:369-380).
  * collate: dense numpy batch with reference key names (:388-430).

``load_image_uint8`` is the serving featurizer's single-image loader.
"""

from __future__ import annotations

import json
import os
import random
import string
import wave
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from valor_tpu_torch.core.logging import LOGGER
from valor_tpu_torch.data import native
from valor_tpu_torch.data.fbank import clip_span_samples, fbank_np
from valor_tpu_torch.data.resample import resample

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_PUNCT = string.punctuation


def clean_text(text: str) -> str:
    text = " ".join(w for w in text.split(" ") if w).lower()
    for p in _PUNCT:
        text = text.replace(p, "")
    return text


def uniform_chunks(items: List, sample_num: int) -> List[List]:
    """Pad-with-last then split into sample_num near-equal chunks
    (split(), data/data.py:240-244)."""
    if len(items) < sample_num:
        items = items + [items[-1]] * (sample_num - len(items))
    k, m = divmod(len(items), sample_num)
    return [items[i * k + min(i, m) : (i + 1) * k + min(i + 1, m)] for i in range(sample_num)]


def chunk_pick(chunks: List[List], training: bool, rng: random.Random):
    if training:
        return [rng.choice(c) for c in chunks]
    return [c[(len(c) + 1) // 2 - 1] for c in chunks]


class TxtMapper:
    def __init__(
        self,
        txt_path: str,
        max_len: int,
        bert_tokenizer=None,
        clip_tokenizer=None,
        training: bool = True,
        test_one: bool = False,
    ):
        self.json_dict = json.load(open(txt_path))
        self.max_len = max_len
        self.bert = bert_tokenizer
        self.clip = clip_tokenizer
        self.training = training
        self.test_one = test_one

    def _pad(self, ids: List[int], bos: int, eos: int,
             max_len: Optional[int] = None) -> np.ndarray:
        L = self.max_len if max_len is None else max_len
        ids = ids[:L]
        ids = [bos] + ids + [eos]
        out = np.zeros(L + 2, np.int32)
        out[: len(ids)] = ids
        return out

    def tokenize_one(self, text: str,
                     max_len: Optional[int] = None) -> Dict[str, np.ndarray]:
        """max_len overrides self.max_len for THIS call only — it must be
        a parameter, not mutated instance state: DataLoader worker
        threads share one mapper, and a temporary self.max_len swap races
        (ragged pad widths, or a permanently corrupted max_len when
        save/restore interleaves)."""
        text = clean_text(text)
        out = {}
        if self.bert is not None:
            out["bert_tokens"] = self._pad(
                self.bert.encode(text), self.bert.cls_token_id,
                self.bert.sep_token_id, max_len,
            )
        if self.clip is not None:
            out["clip_tokens"] = self._pad(
                self.clip.encode(text), self.clip.sot_token,
                self.clip.eot_token, max_len,
            )
        return out

    def __getitem__(self, id_) -> List[Dict[str, np.ndarray]]:
        text = self.json_dict[id_]
        if isinstance(text, list):
            if self.training:
                return [self.tokenize_one(random.choice(text))]
            if self.test_one:
                return [self.tokenize_one(text[0])]
            return [self.tokenize_one(t) for t in text]
        return [self.tokenize_one(text)]


def _resize(img: Image.Image, size) -> Image.Image:
    if isinstance(size, int):  # short side
        w, h = img.size
        if w < h:
            return img.resize((size, int(h * size / w)), Image.BILINEAR)
        return img.resize((int(w * size / h), size), Image.BILINEAR)
    return img.resize((size[1], size[0]), Image.BILINEAR)


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def load_image_uint8(path: str, resolution: int = 224, transforms: str = "none") -> np.ndarray:
    """One image as a [1, H, W, 3] uint8 frame stack, as the eval
    ``VideoMapper(datatype="image", output_uint8=True)`` returns it."""
    if not os.path.exists(path):
        path = path + ".jpg"
    if not os.path.exists(path):
        path = path.replace(".jpg", ".JPEG")
    img = Image.open(path).convert("RGB")
    if transforms == "crop_flip":
        img = _center_crop(_resize(img, resolution), resolution)
    else:
        img = _resize(img, (resolution, resolution))
    return np.asarray(img, np.uint8)[None]


class VideoMapper:
    """frame-dir (video) or single-image datasets -> [n, H, W, 3] float32
    (or raw uint8 with ``output_uint8``), decoded with PIL, or with the C++
    decoder for video frames under ``transforms == "none"``."""

    def __init__(
        self,
        video_dir: str,
        resolution: int = 224,
        sample_num: int = 4,
        datatype: str = "video",
        transforms: str = "none",
        encoder_type: str = "clip_vit_base_16",
        training: bool = True,
        output_uint8: bool = False,
    ):
        self.video_dir = video_dir
        self.resolution = resolution
        self.sample_num = sample_num
        self.datatype = datatype
        self.transforms = transforms
        self.training = training
        # ship raw uint8 pixels; normalisation fuses into the on-device
        # patch embed (encode_video).  This is also exact PIL parity —
        # PIL's resize rounds to uint8 BEFORE the reference normalises.
        self.output_uint8 = output_uint8
        if encoder_type.startswith("clip"):
            self.mean, self.std = CLIP_MEAN, CLIP_STD
        else:
            self.mean, self.std = IMAGENET_MEAN, IMAGENET_STD

    def _augment(self, img: Image.Image, rng: random.Random, crop_params=None) -> Image.Image:
        res = self.resolution
        if self.transforms == "crop_flip" and self.training:
            # RandomResizedCrop(scale=[0.8,1.0], ratio=[1,1]) + HFlip, with
            # the SAME crop across frames (frame_syncaug, data/data.py:139)
            w, h = img.size
            scale, flip, rx, ry = crop_params
            area = w * h * scale
            side = int(round(area**0.5))
            side = min(side, w, h)
            x = int(rx * (w - side))
            y = int(ry * (h - side))
            img = img.crop((x, y, x + side, y + side)).resize((res, res), Image.BILINEAR)
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            return img
        if self.transforms == "crop_flip":
            return _center_crop(_resize(img, res), res)
        return _resize(img, (res, res))

    def _finish(self, frames: List[Image.Image], rng: random.Random) -> np.ndarray:
        crop_params = (
            rng.uniform(0.8, 1.0),
            rng.random() < 0.5,
            rng.random(),
            rng.random(),
        )
        out = []
        for f in frames:
            f = self._augment(f.convert("RGB"), rng, crop_params)
            if self.output_uint8:
                out.append(np.asarray(f, np.uint8))
                continue
            arr = np.asarray(f, np.float32) / 255.0
            out.append((arr - self.mean) / self.std)
        return np.stack(out)  # [n, H, W, 3]

    def __getitem__(self, id_) -> Optional[np.ndarray]:
        rng = random.Random()
        try:
            if self.datatype.startswith("video"):
                frame_dir = os.path.join(self.video_dir, id_)
                names = sorted(os.listdir(frame_dir))
                picks = chunk_pick(uniform_chunks(names, self.sample_num), self.training, rng)
                paths = [os.path.join(frame_dir, p) for p in picks]
                # the C++ decoder: threaded JPEG decode + antialiased resize
                # (+ normalise) in one call, for a plain Resize((r, r)) only
                if self.transforms == "none" and native.available():
                    res = self.resolution
                    if self.output_uint8:
                        out, failed = native.decode_resize_batch_u8(paths, (res, res))
                    else:
                        out, failed = native.decode_resize_batch(paths, (res, res), self.mean, self.std)
                    return None if failed else out
                frames = [Image.open(p) for p in paths]
                return self._finish(frames, rng)
            # image datasets: one frame; optional visual-genome crop syntax
            path = os.path.join(self.video_dir, id_)
            if self.datatype.startswith("image_vg"):
                id2, width, height, x, y = id_.split("%")
                width = int(width.split("width")[1])
                height = int(height.split("height")[1])
                x = int(x.split("x")[1])
                y = int(y.split("y")[1])
                path = os.path.join(self.video_dir, id2)
            if not os.path.exists(path):
                path = path + ".jpg"
            if not os.path.exists(path):
                path = path.replace(".jpg", ".JPEG")
            img = Image.open(path).convert("RGB")
            if self.datatype.startswith("image_vg"):
                img = img.crop((x, y, x + width, y + height))
            return self._finish([img], rng)  # [1, H, W, 3]
        except Exception as e:  # corrupt sample -> caller resamples
            LOGGER.debug(f"video mapper failed for {id_}: {e}")
            return None


def load_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        # honor the file's sample width — blindly parsing as int16 turns
        # 8/24/32-bit PCM into noise waveforms with no error
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 1:  # WAV 8-bit is unsigned
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif width == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif width == 3:  # 24-bit packed little-endian
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            data = ints.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported wav sample width {width}")
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return data, sr


class AudioMapper:
    """wav -> normalised log-mel clips [n, mel, T] (host path), or — with
    ``device_fbank=True`` — fixed-length clip-span waveforms for the
    on-device mel pipeline (fbank.fbank_clips_from_spans).  The split
    exists because a 1-core TPU-VM host cannot afford 13-16 ms of mel
    extraction per sample (PERF_NOTES.md round-2 campaign); clip choice
    stays on the host (cheap RNG), framing/DFT/mel/log ride the MXU."""

    def __init__(
        self,
        audio_dir: str,
        sample_num: int = 1,
        melbins: int = 64,
        target_length: int = 512,
        frame_shift_ms: float = 10.0,
        mean: float = -4.2677393,
        std: float = 4.5689974,
        training: bool = True,
        device_fbank: bool = False,
        sample_frequency: int = 22050,
    ):
        self.audio_dir = audio_dir
        self.sample_num = sample_num
        self.melbins = melbins
        self.target_length = target_length
        self.frame_shift_ms = frame_shift_ms
        self.mean = mean
        self.std = std
        self.training = training
        self.device_fbank = device_fbank
        self.sample_frequency = sample_frequency

    def _span_samples(self) -> int:
        return clip_span_samples(
            self.target_length, self.sample_frequency, self.frame_shift_ms
        )

    def _to_analysis_rate(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """Anti-aliased conversion to the configured analysis rate.

        Both mapper paths (host mel and device_fbank spans) analyse at
        ``sample_frequency`` so the mel basis — and the (x-mean)/(2*std)
        normalisation stats tuned for it — are rate-invariant.  The
        reference instead runs kaldi.fbank at each file's native rate
        (data/data.py:283-315), but its own extraction tool emits 22050 Hz
        wavs, so the paths agree on reference-layout data
        (DIVERGENCES.md #19)."""
        if sr == self.sample_frequency:
            return wav
        return resample(wav, sr, self.sample_frequency)

    def _spans(self, id_) -> Optional[Dict[str, np.ndarray]]:
        """device_fbank half: {'waveforms': [n, L], 'valid_frames': [n]}."""
        L = self._span_samples()
        path = os.path.join(self.audio_dir, str(id_) + ".wav")
        if not os.path.exists(path):
            # missing audio -> exact zero output on device (valid = -1)
            return {
                "waveforms": np.zeros((self.sample_num, L), np.float32),
                "valid_frames": np.full((self.sample_num,), -1, np.int32),
            }
        wav, sr = load_wav(path)
        wav = self._to_analysis_rate(wav, sr)
        wav = wav - wav.mean()
        shift = int(self.sample_frequency * self.frame_shift_ms / 1000.0)
        win = int(self.sample_frequency * 25.0 / 1000.0)
        src = max(1 + (len(wav) - win) // shift, 1)
        T = self.target_length
        total = src // T + 1  # reference always pads > 0 (data/data.py:291)
        rng = random.Random()
        picks = chunk_pick(uniform_chunks(list(range(total)), self.sample_num), self.training, rng)
        spans = np.zeros((self.sample_num, L), np.float32)
        valid = np.zeros((self.sample_num,), np.int32)
        for j, c in enumerate(picks):
            s0 = c * T * shift
            chunk = wav[s0 : s0 + L]
            spans[j, : len(chunk)] = chunk
            valid[j] = int(np.clip(src - c * T, 0, T))
        return {"waveforms": spans, "valid_frames": valid}

    def __getitem__(self, id_) -> Optional[np.ndarray]:
        try:
            if self.device_fbank:
                return self._spans(id_)
        except Exception as e:
            LOGGER.debug(f"audio mapper failed for {id_}: {e}")
            return None
        path = os.path.join(self.audio_dir, str(id_) + ".wav")
        if not os.path.exists(path):
            # missing audio -> zero spectrogram (data/data.py:272-275)
            return np.zeros((self.sample_num, self.melbins, self.target_length), np.float32)
        try:
            wav, sr = load_wav(path)
            wav = self._to_analysis_rate(wav, sr)
            wav = wav - wav.mean()
            fb = fbank_np(
                wav,
                sample_frequency=self.sample_frequency,
                num_mel_bins=self.melbins,
                frame_shift_ms=self.frame_shift_ms,
            )
            src = fb.shape[0]
            pad = self.target_length - src % self.target_length
            fb = np.pad(fb, ((0, pad), (0, 0)))
            total = fb.shape[0] // self.target_length
            rng = random.Random()
            picks = chunk_pick(uniform_chunks(list(range(total)), self.sample_num), self.training, rng)
            clips = np.stack(
                [fb[i * self.target_length : (i + 1) * self.target_length] for i in picks]
            ).transpose(0, 2, 1)  # [n, mel, time]
            return (clips - self.mean) / (2 * self.std)
        except Exception as e:
            LOGGER.debug(f"audio mapper failed for {id_}: {e}")
            return None


class VALORDataset:
    """id-list dataset combining the three mappers with corrupt-sample
    resampling (data/data.py:326-383)."""

    def __init__(self, ids_path, txt_mapper, video_mapper, audio_mapper, training: bool):
        self.ids = json.load(open(ids_path))
        self.txt_mapper = txt_mapper
        self.video_mapper = video_mapper
        self.audio_mapper = audio_mapper
        self.training = training
        for m in (txt_mapper, video_mapper, audio_mapper):
            if m is not None:
                m.training = training

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        id_ = self.ids[i]
        txt, video, audio, id_txt, n_samples = None, None, None, None, None
        if self.txt_mapper is not None:
            txt = self.txt_mapper[id_]
            id_txt = id_ if self.training else [id_] * len(txt)
            n_samples = 1 if self.training else len(txt)
        if self.video_mapper is not None:
            video = self.video_mapper[id_]
            if video is None and self.training:
                j = random.randrange(len(self.ids))
                LOGGER.info(f"sample {id_} has a bad image/video; resampling {self.ids[j]}")
                return self[j]
        if self.audio_mapper is not None:
            audio = self.audio_mapper[id_]
            if audio is None and self.training:
                j = random.randrange(len(self.ids))
                LOGGER.info(f"sample {id_} has bad audio; resampling {self.ids[j]}")
                return self[j]
        return {
            "id": id_,
            "txt": txt,
            "video": video,
            "audio": audio,
            "id_txt": id_txt,
            "num_samples": n_samples,
        }


def collate_audio(batch: Dict[str, Any], audios: Sequence[Any]) -> None:
    """Stack per-sample audio into the batch: normalised spectrograms
    (host path) or clip-span waveform dicts (AudioMapper device_fbank)."""
    if audios[0] is None:
        return
    if isinstance(audios[0], dict):  # device_fbank spans
        batch["audio_waveforms"] = np.stack([a["waveforms"] for a in audios])
        batch["audio_valid_frames"] = np.stack([a["valid_frames"] for a in audios])
    else:
        batch["audio_spectrograms"] = np.stack(audios)


def valor_collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Dense batch with the reference's key layout (data/data.py:388-430)."""
    ids = [s["id"] for s in samples]
    ids_txt: Any = None
    batch: Dict[str, Any] = {"ids": ids}
    if samples[0]["txt"] is not None:
        flat = [t for s in samples for t in s["txt"]]
        for k in flat[0]:
            batch[k] = np.stack([t[k] for t in flat])
        first = samples[0]["id_txt"]
        if isinstance(first, list):
            ids_txt = [j for s in samples for j in s["id_txt"]]
        else:
            ids_txt = [s["id_txt"] for s in samples]
    if samples[0]["video"] is not None:
        batch["video_pixels"] = np.stack([s["video"] for s in samples])
    collate_audio(batch, [s["audio"] for s in samples])
    batch["ids_txt"] = ids_txt
    batch["sample_num"] = [s["num_samples"] for s in samples]
    return batch
