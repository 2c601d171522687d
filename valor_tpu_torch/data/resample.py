"""Polyphase windowed-sinc waveform resampling (host, numpy).

The PyTorch port's own copy of ``valor_tpu/data/resample.py``.

The audio mappers analyse at a fixed configured rate (22050 Hz — the rate
the reference's extraction tool emits, utils/
extract_frame_and_wav_multiprocess.py, and the rate the mel normalisation
stats were computed for).  Files at other rates are converted here with a
proper anti-aliased resampler: a Kaiser-windowed sinc low-pass evaluated
polyphase at the rational rate ratio — the same construction as
scipy.signal.resample_poly / libsamplerate, replacing the former
np.interp linear path (no alias rejection; ADVICE round 2).

Quality: ~80 dB stop-band (Kaiser beta 8.555), 32-tap half-width at the
lower Nyquist.  Pure numpy, one small matmul per output block.
"""

from __future__ import annotations

import functools
import math

import numpy as np

_HALF_WIDTH = 32  # filter half-width in samples at the lower Nyquist rate
_KAISER_BETA = 8.555  # ~80 dB stop-band attenuation


@functools.lru_cache(maxsize=16)
def _polyphase_table(up: int, down: int) -> tuple[np.ndarray, int]:
    """Filter table [up, 2*width+1]; row p holds the taps for fractional
    phase p/up.  Returns (table, width)."""
    cutoff = min(1.0, up / down)  # relative to the input Nyquist
    width = int(math.ceil(_HALF_WIDTH / cutoff))
    k = np.arange(-width, width + 1, dtype=np.float64)[None, :]
    frac = (np.arange(up, dtype=np.float64) / up)[:, None]
    x = frac - k  # offset (input samples) of tap k from output time
    sinc = cutoff * np.sinc(cutoff * x)
    # Kaiser window over the filter support
    arg = np.clip(x / (width + 1), -1.0, 1.0)
    win = np.i0(_KAISER_BETA * np.sqrt(1.0 - arg * arg)) / np.i0(_KAISER_BETA)
    taps = sinc * win
    taps /= taps.sum(axis=1, keepdims=True)  # exact DC gain 1 per phase
    return taps.astype(np.float32), width


def resample(wav: np.ndarray, sr_in: int, sr_out: int, block: int = 1 << 16) -> np.ndarray:
    """Resample a mono float32 waveform from sr_in to sr_out."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"bad sample rates {sr_in} -> {sr_out}")
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    table, width = _polyphase_table(up, down)
    wav = np.asarray(wav, np.float32)
    n_out = int(len(wav) * up) // down
    padded = np.pad(wav, (width, width + 1))
    out = np.empty(n_out, np.float32)
    offsets = np.arange(2 * width + 1)
    for s in range(0, n_out, block):
        j = np.arange(s, min(s + block, n_out))
        t = j * down
        n0 = t // up  # integer input position
        ph = t - n0 * up  # fractional phase index
        rows = padded[n0[:, None] + offsets[None, :]]  # [.., 2w+1]
        out[s : s + len(j)] = np.einsum("ji,ji->j", rows, table[ph])
    return out
