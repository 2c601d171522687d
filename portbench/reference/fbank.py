"""Plain reference of the device filterbank: clip-span waveforms to normalised log-mel clips.

Kaldi's filterbank as VALOR's data pipeline computes it (torchaudio's
``compliance.kaldi.fbank``): snip-edges framing with a 25 ms window every
10 ms, per-frame DC removal, pre-emphasis 0.97, a Hanning window, the power
spectrum of an FFT of the next power of two, a mel bank from 20 Hz to
Nyquist (mel = 1127 ln(1 + f / 700)), the log floored at float32's epsilon;
frames past a clip's valid count are zero rows, normalised like the rest as
(x - mean) / (2 std); the output is [B, clips, mel, frames].  The transform
is one product against an explicit DFT basis, in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07


def _mel_bank(bins: int, nfft: int, sr: float, low: float = 20.0) -> np.ndarray:
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    lo, hi = mel(low), mel(0.5 * sr)
    delta = (hi - lo) / (bins + 1)
    freqs = mel(np.arange(nfft // 2 + 1) * (sr / nfft))
    out = np.zeros((nfft // 2 + 1, bins), np.float32)
    for b in range(bins):
        left = lo + b * delta
        up = (freqs - left) / delta
        down = (left + 2 * delta - freqs) / delta
        out[:, b] = np.maximum(0.0, np.minimum(up, down))
    return out


def log_mel_clips(wavs: torch.Tensor, valid_frames: torch.Tensor, melbins: int = 64, target_length: int = 512,
                  sr: int = 22050, mean: float = -4.2677393, std: float = 4.5689974) -> torch.Tensor:
    shift, win = int(sr * 0.010), int(sr * 0.025)
    nfft = 1 << (win - 1).bit_length()
    n = np.arange(nfft)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = -2.0 * math.pi * n * k / nfft
    basis = torch.from_numpy(np.concatenate([np.cos(ang).astype(np.float32)[:win],
                                             np.sin(ang).astype(np.float32)[:win]], 1)).to(wavs.device).double()
    window = torch.from_numpy(np.hanning(win).astype(np.float32)).to(wavs.device)
    mel = torch.from_numpy(_mel_bank(melbins, nfft, float(sr))).to(wavs.device).double()
    frames = wavs.float().unfold(-1, win, shift)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], -1)
    reim = torch.matmul((frames * window).double(), basis)
    half = nfft // 2 + 1
    power = reim[..., :half] ** 2 + reim[..., half:] ** 2
    fb = torch.log(torch.clamp_min(torch.matmul(power, mel).float(), EPSILON))  # [B, n, frames, mel]
    ok = torch.arange(target_length, device=fb.device) < valid_frames.long().clamp_min(0)[..., None]
    fb = torch.where(ok[..., None], fb[..., :target_length, :], torch.zeros((), device=fb.device))
    out = (fb - mean) / (2.0 * std)
    out = torch.where((valid_frames >= 0)[..., None, None], out, torch.zeros((), device=fb.device))
    return out.transpose(-1, -2)
