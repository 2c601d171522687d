"""Builds the port's native sources and loads them with ``ctypes``.

Each ``valor_tpu_torch/csrc/<name>.cu`` has a plain C interface and is compiled
with ``nvcc`` for Hopper (``sm_90a``) into
``valor_tpu_torch/_build/lib<name>-<hash>.so`` at first use; each
``csrc/host/<name>.cpp`` (``host=True``: host code of the data path) is compiled
the same way with the host compiler (``$CXX``, else ``g++``) and
``native/Makefile``'s flags.  The hash covers the source and the flags, and for
host code the compiler and the CPU it tunes for (``-march=native``), so an
edited source is rebuilt, a build is never loaded on another CPU, and an
unchanged one is loaded as it is.  Each source has its own lock, so two sources
build side by side in two threads while two requests for one source build it
once.  A failed host build raises ``BuildError`` with the compiler's output.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
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
# native/Makefile's CXXFLAGS and LDFLAGS
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall")
HOST_LDFLAGS = ("-shared", "-fopenmp", "-ljpeg")

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


class BuildError(RuntimeError):
    """A source did not compile; the message holds the compiler's output."""


def _host_identity(cxx: str) -> str:
    """The compiler's version and what ``-march=native`` tunes for: the CPU's
    model and feature flags."""
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    except OSError:
        version = "missing"
    try:
        with open("/proc/cpuinfo") as f:
            cpu = "".join(sorted({ln for ln in f if ln.startswith(("model name", "flags"))}))
    except OSError:
        cpu = platform.processor() or platform.machine()
    return f"{cxx} {version}{cpu}"


def _compile_host(cmd, what: str) -> None:
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler at all
        raise BuildError(f"{what}: {cmd[0]}: {e}") from None
    if done.returncode != 0:
        raise BuildError(f"{what}: {' '.join(cmd)} exited {done.returncode}:\n"
                         f"{done.stdout}{done.stderr}".rstrip())
    if done.stdout or done.stderr:  # warnings stay visible
        print(f"{what}:\n{done.stdout}{done.stderr}".rstrip(), file=sys.stderr)


def load_library(name: str, host: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or, with ``host``,
    ``csrc/host/<name>.cpp``), built on first use."""
    key = f"host/{name}" if host else name
    with _lock(key):
        lib = _LIBS.get(key)
        if lib is None:
            src = CSRC_DIR / f"{key}.{'cpp' if host else 'cu'}"
            cxx = os.environ.get("CXX", "g++")
            flags, salt = (HOST_FLAGS + HOST_LDFLAGS, _host_identity(cxx)) if host else (NVCC_FLAGS, "")
            digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode() + salt.encode()).hexdigest()
            target = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
                if host:
                    _compile_host([cxx, *HOST_FLAGS, str(src), "-o", str(tmp), *HOST_LDFLAGS],
                                  f"building {src.name}")
                else:
                    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], check=True)
                os.replace(tmp, target)  # atomic: another process never loads half a file
            lib = _LIBS[key] = ctypes.CDLL(str(target))
        return lib
