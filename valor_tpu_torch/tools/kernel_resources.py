"""Registers, spills and shared memory of every kernel instantiation in a CUDA source.

    python3 -m valor_tpu_torch.tools.kernel_resources layernorm [--out FILE]

Compiles ``valor_tpu_torch/csrc/<name>.cu`` with the flags of ``_build`` plus
``-Xptxas -v`` into a temporary directory (the loaded library is not touched)
and prints one JSON line per kernel: its demangled name, registers a thread,
spill stores and loads in bytes, stack frame and static shared memory.  Needs
``nvcc``; runs on a machine with the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from valor_tpu_torch.ops.kernels import _build

_ENTRY = re.compile(r"Compiling entry function '(\S+)' for '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names):
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, check=True)
    return out.stdout.splitlines()


def resources(name: str):
    """[{kernel, registers, spill_stores, spill_loads, stack, smem}] of ``csrc/<name>.cu``."""
    src = _build.CSRC_DIR / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(Path(tmp) / "lib.so"),
             str(src)], capture_output=True, text=True, check=True)
    rows, cur = [], None
    for line in proc.stderr.splitlines():
        if (m := _ENTRY.search(line)):
            cur = {"mangled": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _USED.search(line)):
            smem = _SMEM.search(line)
            cur.update(registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    for row, pretty in zip(rows, _demangle([r["mangled"] for r in rows])):
        row["kernel"] = pretty
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", help="source under valor_tpu_torch/csrc, without .cu")
    ap.add_argument("--out", help="also write the rows here as JSON")
    args = ap.parse_args()
    rows = resources(args.name)
    for row in rows:
        print(json.dumps({k: row.get(k) for k in
                          ("kernel", "registers", "spill_stores", "spill_loads", "stack", "smem")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
