"""Bytes of the hand-written kernels' work, from the shapes of their calls.

A call is (rows, cols, bytes of an x element, bytes of an output element,
whether a gradient flows), as the benchmark's hooks on the program's
LayerNorm modules record it.  Each input is read once and each output
written once, whatever the kernel reads again:

  * K1-fwd: x read, y written, the fp32 scale and bias read;
  * K1-bwd: x and dy read (dy in the output's type), dx written (in x's
    type), the fp32 scale read, its fp32 gradient and the bias's written.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from portbench.harness import HBM_BYTES_PER_S

Call = Tuple[int, int, int, int, bool]


def k1_fwd_bytes(calls: Iterable[Call]) -> int:
    return sum(r * c * (xb + yb) + 2 * 4 * c for r, c, xb, yb, _ in calls)


def k1_bwd_bytes(calls: Iterable[Call]) -> int:
    return sum(r * c * (2 * xb + yb) + 3 * 4 * c for r, c, xb, yb, grad in calls if grad)


def roofline_share(nbytes: int, seconds: float):
    """Percent of the bytes bound reached: the least time (bytes at the HBM
    rate) over the kernel's device time; None where nothing was timed."""
    if not nbytes or not seconds:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds


def kernel_seconds(by_name: dict, fragment: str) -> float:
    return sum(v for k, v in by_name.items() if fragment in k)
