"""Reduction of a profiler trace to the numbers the per-layer metrics read.

``Profiler`` wraps ``torch.profiler``; ``start`` and ``stop`` synchronise the
card and bound a traced stretch.  A cell traces two stretches back to back,
from the thread that launches the work, at step or batch boundaries:

  * ``device``: CUDA activity alone, which costs the host little: the busy and
    idle time, the kernels' times by name;
  * ``host``: CPU and CUDA activity, whose recording of every host operation
    slows the host: each device operation's host range, and the idle gaps'
    labels.

``reduce`` reads a stretch's events:

  * every operation on the device (kernels, copies, sets) with its interval;
    ``busy_s`` is the length of their union, ``window_s`` the stretch from
    the first one's start to the last one's end;
  * each device operation's share of a host range (the program's
    ``record_function`` ranges, or the benchmark's own spans): the range
    whose host interval holds the operation's launch (found through the
    trace's correlation ids), else the device-side annotation of the range
    that holds its start;
  * the idle gaps between the device's busy intervals, each labelled by the
    innermost host range that was open when the device fell idle;
  * ``breakdown``: the ten device operations that took most time, and idle
    time summed by label, ten labels at most.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Tuple


class Profiler:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def _sync(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def start(self, host: bool = True) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        device = ProfilerActivity.CUDA if self.torch.cuda.is_available() else ProfilerActivity.CPU
        acts = sorted({device, ProfilerActivity.CPU} if host else {device}, key=str)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Stops the stretch; returns its seconds on the host clock."""
        self._sync()
        self.prof.stop()
        return time.perf_counter() - self.t0

    def reduce(self, ranges: Iterable[str]) -> Dict[str, Any]:
        return reduce_events(self.prof.profiler.kineto_results.events(), ranges)


class Stretches:
    """The traced stretches after a window: ``advance()`` at each step or batch
    boundary, from the thread that launches the work, once ``armed``.  A first
    stretch of one boundary is traced and thrown away (CUPTI's first start is
    slow, and a profiler once started slows every later launch, so none runs
    before the window closes); then ``device`` and ``host``, each ``length``
    boundaries long (``length_s`` seconds when given)."""

    def __init__(self, torch, length: int = 0, length_s: float = 0.0):
        self.torch, self.length, self.length_s = torch, length, length_s
        self.armed = False
        self.done: Dict[str, Any] = {}  # name -> (Profiler, host seconds, boundaries)
        self.current = None
        self.count = 0

    @property
    def active(self) -> bool:
        return self.current is not None

    def advance(self) -> None:
        if not self.armed or len(self.done) == 3:
            return
        if self.current is not None:
            self.count += 1
            name, prof = self.current
            elapsed = time.perf_counter() - prof.t0
            if name != "warm" and ((self.length_s and elapsed < self.length_s)
                                   or (not self.length_s and self.count < self.length)):
                return
            self.done[name] = (prof, prof.stop(), self.count)
            self.current = None
        if len(self.done) < 3:
            name = ("warm", "device", "host")[len(self.done)]
            prof = Profiler(self.torch)
            prof.start(host=name == "host")
            self.current, self.count = (name, prof), 0

    @property
    def finished(self) -> bool:
        return len(self.done) == 3

    def finish(self) -> None:
        """Stops a stretch still open (the work has ended)."""
        if self.current is not None:
            name, prof = self.current
            self.done[name] = (prof, prof.stop(), self.count)
            self.current = None


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def reduce_events(events, ranges: Iterable[str]) -> Dict[str, Any]:
    from torch.autograd import DeviceType

    names = set(ranges)
    device: List[Tuple[str, int, int, int, int]] = []
    launch: Dict[int, int] = {}
    host_ranges: List[Tuple[str, int, int]] = []
    device_ranges: List[Tuple[str, int, int]] = []
    for e in events:
        name = e.name()
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if name in names or e.is_user_annotation():
                device_ranges.append((name, s, t))
            else:
                device.append((name, s, t, e.linked_correlation_id(), e.correlation_id()))
        else:
            if e.correlation_id():
                launch.setdefault(e.correlation_id(), s)
            if name in names:
                host_ranges.append((name, s, t))
    host_ranges.sort(key=lambda r: r[1])
    by_range: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    unattributed = 0
    starts = [r[1] for r in host_ranges]
    for name, s, t, linked, corr in device:
        by_name[name] += (t - s) * 1e-9
        at = launch.get(linked) or launch.get(corr)
        owner = _holder(host_ranges, starts, at) if at else None
        if owner is None:
            owner = next((r[0] for r in device_ranges if r[1] <= s <= r[2]), None)
        if owner is None:
            unattributed += 1
        else:
            by_range[owner] += (t - s) * 1e-9
    busy = _union([(d[1], d[2]) for d in device])
    if not busy:
        return {"busy_s": 0.0, "window_s": 0.0, "by_range_s": {}, "by_name_s": {}, "device_ops": 0,
                "unattributed": 0, "host_ranges": len(host_ranges), "device_ranges": len(device_ranges),
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    window = (busy[0][0], busy[-1][1])
    idle: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        label = _holder(host_ranges, starts, e0)
        if label is None:
            label = next((r[0] for r in device_ranges if r[1] <= e0 <= r[2]), "host outside the traced ranges")
        idle[label] += (s1 - e0) * 1e-9
    busy_s = sum(e - s for s, e in busy) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s, "window_s": (window[1] - window[0]) * 1e-9,
        "by_range_s": dict(by_range), "by_name_s": dict(by_name), "device_ops": len(device),
        "unattributed": unattributed, "host_ranges": len(host_ranges), "device_ranges": len(device_ranges),
        "breakdown": {"device_ops": [[n[:160], v] for n, v in top], "idle_gaps": [[n, v] for n, v in gaps]},
    }


def _holder(ranges, starts, at: int):
    """The innermost range whose interval holds the time ``at``."""
    best = None
    for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
        name, s, t = ranges[i]
        if s <= at <= t and (best is None or t - s < best[1]):
            best = (name, t - s)
    return None if best is None else best[0]


def reduce_stretches(stretches: "Stretches", ranges: Iterable[str], ln_calls) -> Dict[str, Any]:
    """The per-layer metrics' view of a cell's two stretches: ``device`` (busy
    and window, kernel times by name, the LayerNorm calls recorded over it)
    and ``host`` (device time by host range); ``breakdown`` takes the device
    operations from the first and the idle gaps' labels from the second."""
    out: Dict[str, Any] = {}
    for name, (prof, seconds, count) in stretches.done.items():
        if name == "warm":
            continue
        red = prof.reduce(ranges)
        red.update(host_s=seconds, boundaries=count)
        out[name] = red
    if "device" in out:
        out["device"]["ln_calls"] = list(ln_calls)
    out["breakdown"] = {"device_ops": out.get("device", {}).get("breakdown", {}).get("device_ops", []),
                        "idle_gaps": out.get("host", {}).get("breakdown", {}).get("idle_gaps", [])}
    out["diagnostics"] = {n: {k: r[k] for k in ("device_ops", "unattributed", "host_ranges", "device_ranges",
                                                 "busy_s", "window_s", "host_s", "boundaries")}
                          for n, r in out.items() if n in ("device", "host")}
    return out
