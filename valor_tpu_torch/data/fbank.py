"""Kaldi-compatible log-mel filterbank (counterpart of ``valor_tpu/data/fbank.py``).

Two halves, as in the JAX package:

  * the host half, numpy, copied: ``mel_banks``, ``_dft_mel_basis``,
    ``fbank_np``, ``clip_span_samples`` and ``uniform_chunk_indices``'s host
    side (the eval centre pick and the train pick from a ``random.Random``);
  * the device half, torch: ``fbank``, ``fbank_clips`` and
    ``fbank_clips_from_spans``.  Frames are ``Tensor.unfold`` views of the
    waveform, the DFT is one matrix product against the precomputed cos|sin
    basis, and the mel projection another.

Conventions (the reference's ``torchaudio.compliance.kaldi.fbank``, data/data.py:283-315):
snip_edges framing (n_frames = 1 + (n - win) // shift; a waveform shorter
than one window gives one frame of clipped indices), per-frame DC removal,
preemphasis 0.97, Hanning window, FFT size the next power of two of the
window, power spectrum, mel scale 1127 ln(1 + f / 700) from 20 Hz to Nyquist,
log with kaldi's epsilon floor.

Precision: the JAX package asks for ``Precision.HIGHEST`` on the DFT, so the
two products here must not run in TF32, which would put a log-mel about 1e-3
off.  They run in fp64, where no TF32 setting applies, and leave every
process-wide precision setting as it is (switching one around the products
raised in torch 2.11 once a caller had set TF32 through the other of the
two precision APIs).
"""

from __future__ import annotations

import functools
import math
import random
from typing import List, Optional, Tuple

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # kaldi's flt epsilon


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def mel_banks(
    num_bins: int, nfft: int, sample_freq: float, low_freq: float = 20.0, high_freq: float = 0.0
) -> np.ndarray:
    """Triangular mel filterbank matrix [nfft//2 + 1, num_bins] (numpy, static)."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_low, mel_high = mel(low_freq), mel(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((nfft // 2 + 1, num_bins), np.float32)
    fft_freqs = np.arange(nfft // 2 + 1) * (sample_freq / nfft)
    mel_freqs = mel(fft_freqs)
    for b in range(num_bins):
        left = mel_low + b * delta
        center = left + delta
        right = center + delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[:, b] = np.maximum(0.0, np.minimum(up, down))
    return bins


@functools.lru_cache(maxsize=8)
def _dft_mel_basis(win: int, nfft: int, num_bins: int, sr: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(window [win], cos|sin DFT basis [win, 2 * (nfft//2+1)], mel matrix
    [nfft//2+1, num_bins])."""
    n = np.arange(nfft)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = -2.0 * math.pi * n * k / nfft
    cos_b = np.cos(ang).astype(np.float32)[:win]
    sin_b = np.sin(ang).astype(np.float32)[:win]
    window = np.hanning(win).astype(np.float32) if win > 1 else np.ones((1,), np.float32)
    mel = mel_banks(num_bins, nfft, float(sr))
    return window, np.concatenate([cos_b, sin_b], axis=1), mel


def _frame_sizes(sample_frequency: int, frame_shift_ms: float, frame_length_ms: float = 25.0):
    shift = int(sample_frequency * frame_shift_ms / 1000.0)
    win = int(sample_frequency * frame_length_ms / 1000.0)
    return shift, win


def fbank_np(
    waveform: np.ndarray,
    sample_frequency: int = 22050,
    num_mel_bins: int = 64,
    frame_shift_ms: float = 10.0,
    frame_length_ms: float = 25.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
) -> np.ndarray:
    """Host (numpy) log-mel spectrogram [n_frames, num_mel_bins]."""
    shift, win = _frame_sizes(sample_frequency, frame_shift_ms, frame_length_ms)
    nfft = _next_pow2(win)
    window, dft, mel = _dft_mel_basis(win, nfft, num_mel_bins, sample_frequency)
    n = waveform.shape[0]
    n_frames = max(1 + (n - win) // shift, 1)
    idx = np.arange(n_frames)[:, None] * shift + np.arange(win)[None, :]
    frames = waveform[np.clip(idx, 0, n - 1)].astype(np.float32)
    if remove_dc_offset:
        frames -= frames.mean(axis=1, keepdims=True)
    if preemphasis:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * prev
    frames *= window
    reim = frames @ dft
    half = nfft // 2 + 1
    power = reim[:, :half] ** 2 + reim[:, half:] ** 2
    return np.log(np.maximum(power @ mel, EPSILON))


def clip_span_samples(
    target_length: int = 512,
    sample_frequency: int = 22050,
    frame_shift_ms: float = 10.0,
    frame_length_ms: float = 25.0,
) -> int:
    """Samples covering ``target_length`` kaldi frames (snip_edges)."""
    shift, win = _frame_sizes(sample_frequency, frame_shift_ms, frame_length_ms)
    return (target_length - 1) * shift + win


def uniform_chunk_indices(total: int, sample_num: int, training: bool,
                          rng: Optional[random.Random] = None) -> List[int]:
    """split() semantics (data/data.py:240-244): pad short with the last item,
    split into ``sample_num`` near-equal chunks, pick the centre of each (eval)
    or a random member drawn from ``rng`` (train, when ``rng`` is given)."""
    items = list(range(total))
    if total < sample_num:
        items += [items[-1]] * (sample_num - total)
    k, m = divmod(len(items), sample_num)
    chunks = [items[i * k + min(i, m) : (i + 1) * k + min(i + 1, m)] for i in range(sample_num)]
    if training and rng is not None:
        return [rng.choice(ch) for ch in chunks]
    return [ch[(len(ch) + 1) // 2 - 1] for ch in chunks]


@functools.lru_cache(maxsize=8)
def _basis_on(win: int, nfft: int, num_bins: int, sr: int, device: torch.device):
    """``_dft_mel_basis`` on ``device`` (the window in fp32, the two product
    bases in fp64), made once a device (a graph capture takes no
    host-to-device copy)."""
    window, dft, mel = (torch.from_numpy(a).to(device) for a in _dft_mel_basis(win, nfft, num_bins, sr))
    return window, dft.double(), mel.double()


def _frames(waveforms: torch.Tensor, win: int, shift: int) -> torch.Tensor:
    """[..., n] -> [..., n_frames, win]: an unfold view where n >= win, else
    one frame of clipped indices (the JAX package's clipped gather)."""
    n = waveforms.shape[-1]
    if n >= win:
        return waveforms.unfold(-1, win, shift)
    idx = torch.arange(win, device=waveforms.device).clamp(max=n - 1)
    return waveforms[..., idx].unsqueeze(-2)


def _log_mel(waveforms: torch.Tensor, sample_frequency: int, num_mel_bins: int,
             frame_shift_ms: float, frame_length_ms: float = 25.0,
             preemphasis: float = 0.97, remove_dc_offset: bool = True) -> torch.Tensor:
    """[..., n] float32 waveforms -> [..., n_frames, num_mel_bins] log-mel."""
    shift, win = _frame_sizes(sample_frequency, frame_shift_ms, frame_length_ms)
    nfft = _next_pow2(win)
    window, dft, mel = _basis_on(win, nfft, num_mel_bins, sample_frequency, waveforms.device)
    frames = _frames(waveforms.float(), win, shift)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * window
    half = nfft // 2 + 1
    reim = torch.matmul(frames.double(), dft)  # re | im, fp64: never TF32
    power = reim[..., :half] ** 2 + reim[..., half:] ** 2
    melspec = torch.matmul(power, mel).float()
    return torch.log(torch.clamp_min(melspec, EPSILON))


def fbank(
    waveform: torch.Tensor,  # [n_samples] float32
    sample_frequency: int = 22050,
    num_mel_bins: int = 64,
    frame_shift_ms: float = 10.0,
    frame_length_ms: float = 25.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
) -> torch.Tensor:
    """Log-mel spectrogram [n_frames, num_mel_bins] on the waveform's device."""
    return _log_mel(waveform, sample_frequency, num_mel_bins, frame_shift_ms,
                    frame_length_ms, preemphasis, remove_dc_offset)


def fbank_clips(
    waveform: torch.Tensor,
    sample_num: int,
    target_length: int = 512,
    melbins: int = 64,
    sample_frequency: int = 22050,
    frame_shift_ms: float = 10.0,
    mean: float = -4.2677393,
    std: float = 4.5689974,
    training: bool = False,
    rng: Optional[random.Random] = None,
) -> torch.Tensor:
    """The whole audio pipeline of one waveform on its device -> [sample_num,
    melbins, target_length]: fbank, zero pad to a multiple of
    ``target_length`` (always by more than zero rows, as the reference),
    uniform-chunk clip choice (random from ``rng`` in train, centre in eval),
    (x - mean) / (2 std), (mel, time) layout."""
    fb = fbank(waveform, sample_frequency=sample_frequency, num_mel_bins=melbins,
               frame_shift_ms=frame_shift_ms)
    src = fb.shape[0]
    pad = (-src) % target_length or target_length
    fb = torch.nn.functional.pad(fb, (0, 0, 0, pad))
    total = fb.shape[0] // target_length
    picks = uniform_chunk_indices(total, sample_num, training, rng)
    clips = fb.reshape(total, target_length, melbins)[torch.tensor(picks, device=fb.device)]
    return (clips.transpose(1, 2) - mean) / (2.0 * std)


def fbank_clips_from_spans(
    wavs: torch.Tensor,  # [B, n, L] float32 clip-span waveforms (zero-padded)
    valid_frames: torch.Tensor,  # [B, n] int: frames of real signal; -1 = audio missing
    melbins: int = 64,
    target_length: int = 512,
    sample_frequency: int = 22050,
    frame_shift_ms: float = 10.0,
    mean: float = -4.2677393,
    std: float = 4.5689974,
) -> torch.Tensor:
    """Device half of the split audio pipeline -> [B, n, mel, T] float32.

    ``AudioMapper(device_fbank=True)`` ships fixed-length clip-span waveforms;
    this runs framing, window, DFT, mel and log on the device, then the host
    path's padding semantics (reference data/data.py:283-315):
      * frames >= ``valid_frames`` are the reference's zero rows (normalised
        like the rest, to (0 - mean) / (2 std));
      * ``valid_frames == -1`` marks missing audio: the output is exactly zero
        (the reference returns a zero tensor in place of the clips,
        data/data.py:272-275).
    """
    b, n, _ = wavs.shape
    fb = _log_mel(wavs, sample_frequency, melbins, frame_shift_ms)  # [B, n, T, mel]
    valid = valid_frames.to(fb.device).long()
    frame_ok = (torch.arange(target_length, device=fb.device)
                < valid.clamp_min(0)[..., None])
    fb = torch.where(frame_ok[..., None], fb, torch.zeros((), device=fb.device))
    out = (fb - mean) / (2.0 * std)
    out = torch.where((valid >= 0)[..., None, None], out, torch.zeros((), device=fb.device))
    return out.reshape(b, n, target_length, melbins).transpose(2, 3)
