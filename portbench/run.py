#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``valor_tpu_torch`` once.

    python3 portbench/run.py --workload base-pretrain --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Set-up (weights and inputs from ``--seed``, the first steps, every shape
warmed up) is ``setup_s``; then the window measures for ``--seconds``; then
the output is checked against the plain reference (``portbench/reference``).
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics and ``breakdown``, as one JSON object on the last line of
standard output; each number compared goes beside its limit on standard error
and under ``checks``.  The program's kernels build into its own
``valor_tpu_torch/_build``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    t0 = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    s = harness.spec(args.workload)
    kind = harness.kind_module(s["traffic"]["kind"])
    result = kind.run(s, args.seed, args.seconds, bool(args.trace), t0)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
