"""ctypes bindings of the port's copy of the C++ data-path runtime (the
counterpart of ``valor_tpu/data/native.py``).

Multi-threaded JPEG decode + antialiased resize (+ normalise) and a C fbank,
from ``valor_tpu_torch/csrc/host/valor_native.cpp``, which
``ops/kernels/_build.py`` compiles with the host compiler at first use into
``valor_tpu_torch/_build/``.  The JAX package loads its own build
(``native/libvalor_native.so``); the port never does.  Where the copy does not
build, the failure is logged once at WARNING with the compiler's output
(``BUILD_ERROR``) and ``available()`` is False, so callers decode with PIL, as
the JAX package does without its library.  ``CALLS`` counts the calls into the
library, so a run can show which decoder a path took.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from valor_tpu_torch.core.logging import LOGGER

CALLS = 0  # calls into the library (decode_resize_batch, _u8 and fbank)
BUILD_ERROR: Optional[str] = None  # the compiler's message where the build failed

_lib = None
_tried = False
_guard = threading.Lock()


def load_library() -> Optional[ctypes.CDLL]:
    """The decoder library, built on first use; None where it does not build."""
    global _lib, _tried, BUILD_ERROR
    if _tried:
        return _lib
    with _guard:
        if _tried:
            return _lib
        from valor_tpu_torch.ops.kernels._build import load_library as build

        try:
            lib = build("valor_native", host=True)
        except Exception as e:  # noqa: BLE001 - any failed build means PIL
            BUILD_ERROR = f"{type(e).__name__}: {e}"
            LOGGER.warning(f"the native decoder did not build; decoding with PIL: {BUILD_ERROR}")
            _tried = True
            return None
        lib.decode_resize_batch.restype = ctypes.c_int
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.decode_resize_batch_u8.restype = ctypes.c_int
        lib.decode_resize_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.fbank.restype = ctypes.c_int
        lib.fbank.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib, _tried = lib, True
        return lib


def available() -> bool:
    return load_library() is not None


def _count() -> None:
    global CALLS
    with _guard:  # the loader's threads call in together
        CALLS += 1


def decode_resize_batch(
    paths: List[str], size: Tuple[int, int], mean: np.ndarray, std: np.ndarray
) -> Tuple[np.ndarray, int]:
    """paths -> [n, H, W, 3] float32 normalised; returns (array, n_failed)."""
    lib = load_library()
    assert lib is not None
    n = len(paths)
    h, w = size
    out = np.empty((n, h, w, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    _count()
    failures = lib.decode_resize_batch(
        c_paths,
        n,
        w,
        h,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out, failures


def decode_resize_batch_u8(
    paths: List[str], size: Tuple[int, int]
) -> Tuple[np.ndarray, int]:
    """paths -> [n, H, W, 3] uint8 (PIL-parity rounding); (array, n_failed).
    ``VALORModel.encode_video`` normalises the raw rows on the card."""
    lib = load_library()
    assert lib is not None
    n = len(paths)
    h, w = size
    out = np.empty((n, h, w, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    _count()
    failures = lib.decode_resize_batch_u8(
        c_paths, n, w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    return out, failures


def fbank(
    wav: np.ndarray,
    sample_rate: int,
    num_bins: int = 64,
    frame_shift_ms: float = 10.0,
    frame_length_ms: float = 25.0,
    preemphasis: float = 0.97,
) -> np.ndarray:
    lib = load_library()
    assert lib is not None
    wav = np.ascontiguousarray(wav, np.float32)
    shift = int(sample_rate * frame_shift_ms / 1000.0)
    win = int(sample_rate * frame_length_ms / 1000.0)
    n_frames = max(1 + (len(wav) - win) // shift, 0)
    out = np.empty((n_frames, num_bins), np.float32)
    _count()
    got = lib.fbank(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(wav),
        sample_rate,
        num_bins,
        frame_shift_ms,
        frame_length_ms,
        preemphasis,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if got < 0:
        raise ValueError("waveform shorter than one frame")
    return out[:got]
