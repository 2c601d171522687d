"""Builds the port's CUDA sources with ``nvcc`` and loads them with ``ctypes``.

Each ``valor_tpu_torch/csrc/<name>.cu`` has a plain C interface and is compiled
for Hopper (``sm_90a``) into ``valor_tpu_torch/_build/lib<name>-<hash>.so`` at
first use; the hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Each source has its own lock,
so two sources build side by side in two threads while two requests for one
source build it once.  Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCKS_GUARD = threading.Lock()
_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _lock(name: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.Lock())


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock(name):
        lib = _LIBS.get(name)
        if lib is None:
            src = CSRC_DIR / f"{name}.cu"
            digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
            target = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
                subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], check=True)
                os.replace(tmp, target)  # atomic: another process never loads half a file
            lib = _LIBS[name] = ctypes.CDLL(str(target))
        return lib
