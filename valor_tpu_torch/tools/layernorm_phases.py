"""Where the LayerNorm backward kernel's time goes, phase by phase, on one card.

    python3 -m valor_tpu_torch.tools.layernorm_phases [--dtype bfloat16 [float32]]

Builds ``csrc/layernorm.cu`` four times into a temporary directory, side by
side, each copy ending the kernel at one more point: after the rows (dx and the
column sums in registers), after the block's partial sums are written, after
the grid-wide barrier, and whole.  Each is timed from CUDA graph replays at the shapes of
``chip_smoke.py`` phase 6 (and 64 rows), beside ATen's LayerNorm backward, and
the differences between neighbours are the phases' times.  Needs ``nvcc`` and
a CUDA card; the loaded library is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from valor_tpu_torch.ops.kernels import _build
from valor_tpu_torch.ops.kernels import layernorm as K

ROOT = Path(__file__).resolve().parents[2]
# (insert before the first occurrence of the anchor, the stop it marks)
STOPS = [
    ("  // the block's column sums: each group's", "rows"),
    ("  cg::this_grid().sync();\n", "partials"),
]
SHAPES = [(64, 768), (1280, 512), (1280, 768), (1000, 500), (4128, 768), (2048, 4096), (25216, 768)]


def _source(stop: str) -> str:
    """The kernel source, returning early at ``stop`` (``full``: as it is)."""
    src = (_build.CSRC_DIR / "layernorm.cu").read_text()
    for anchor, name in STOPS:
        if anchor not in src:
            raise RuntimeError(f"layernorm_phases: the anchor {anchor.strip()!r} is gone")
        if name == stop:
            src = src.replace(anchor, "  return;\n" + anchor, 1)
    if stop == "barrier":
        anchor = "  cg::this_grid().sync();\n"
        src = src.replace(anchor, anchor + "  return;\n", 1)
    return src


def _build_all(stops, tmp: Path):
    """One library a stop, their nvcc runs started together."""
    procs = {}
    for stop in stops:
        src, so = tmp / f"ln_{stop}.cu", tmp / f"libln_{stop}.so"
        src.write_text(_source(stop))
        procs[stop] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS,
                                             f"-I{_build.CSRC_DIR}", "-o", str(so), str(src)]))
    for stop, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"layernorm_phases: nvcc failed for the {stop} copy")
    return {stop: _load(so) for stop, (so, _) in procs.items()}


def _load(so: Path):
    lib = ctypes.CDLL(str(so))
    info, fn = lib.valor_layernorm_bwd_info, lib.valor_layernorm_bwd
    info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int64)]
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_void_p]
    return info, fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", nargs="+", default=["bfloat16"], choices=["bfloat16", "float32"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    stops = ("rows", "partials", "barrier", "full")
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(stops, Path(tmp))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.dtype:
        dtype = getattr(torch, name)
        bf16 = int(dtype == torch.bfloat16)
        for n, c in SHAPES:
            x = torch.randn(n, c, device="cuda", generator=gen).to(dtype)
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            dy = torch.randn(n, c, device="cuda", generator=gen).to(dtype)
            dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
            row = {"shape": [n, c], "dtype": name}
            for stop, (info, fn) in libs.items():
                out = (ctypes.c_int64 * 3)()
                if info(c, bf16, bf16, 1, out):
                    raise RuntimeError("layernorm_phases: the occupancy query failed")
                blocks, steps = K.bwd_grid(n, out[0], out[1])
                part = torch.empty(blocks * 2 * c, device="cuda")

                def call(fn=fn, blocks=blocks, steps=steps, part=part):
                    err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                             dw.data_ptr(), db.data_ptr(), part.data_ptr(), n, c, 1e-5, bf16,
                             bf16, blocks, steps, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"layernorm_phases: launch failed with CUDA error {err}")

                row[f"{stop}_ms"] = cs.graph_ms(call)
                row["blocks"], row["steps"] = blocks, steps
            wl, bl = w.to(dtype), torch.zeros(c, device="cuda", dtype=dtype)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], wl, bl, 1e-5)
            row["aten_ms"] = cs.graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [c], mean, rstd, wl, bl, [True, True, True]))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
