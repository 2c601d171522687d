"""What every cell of the benchmark shares: the spec lookup, the device check,
the result line, the check that nothing of JAX was loaded, and the readers of
the per-layer metrics.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration and a
traffic mix.  The configuration is ``configs/<config>.json``; the traffic mix
is ``traffic/<traffic>.json``, whose ``kind`` names the module of ``kinds/``
that runs it (``pretrain``, ``serve``); the limits of its correctness check
are ``limits/<workload>.json``; each per-layer metric is
``metrics/<metric>.py`` with a ``read(ctx)`` that returns a number or None.
A later cell, mix or metric is new files and new entries, found by name.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "valor_tpu")
BF16_FLOPS_PER_S = 989e12  # one H100 SXM, dense bf16 (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, HBM3
# the keys of a configuration file that describe it rather than configure the program
CONFIG_META = ("name", "source", "reduced", "assumed", "deployment", "caption")


def process_start() -> float:
    """``time.monotonic()`` at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec(workload: str) -> Dict[str, Any]:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and metric entries."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_file = ROOT / configs[cell["config"]]["file"]

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "config": load_json(config_file),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def program_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of a configuration file that configure the program."""
    return {k: v for k, v in config.items() if k not in CONFIG_META}


def kind_module(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[Dict[str, Any]], ctx: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """{name: {value, unit}} of each metric whose reader finds something."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def require_cuda(chips: int):
    """The torch module where ``chips`` CUDA cards are there; exits otherwise,
    with no result."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA card(s); {n} found", file=sys.stderr)
        raise SystemExit(2)
    return torch


def device(torch):
    """The card a one-chip cell runs on."""
    return torch.device("cuda", 0)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pin(t):
    """``t`` in pinned host memory where there is a card to copy it to."""
    import torch

    return t.pin_memory() if torch.cuda.is_available() else t


def peak_bytes(torch, dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def note(msg: str) -> None:
    """A line on standard error for the reader of a run's log."""
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0-1) by linear interpolation between order statistics."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {value, limit}} for every limit (a missing or non-finite value fails)."""
    return {k: {"value": float(checks.get(k, math.inf)), "limit": float(lim)} for k, lim in limits.items()}


def passed(judged: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in judged.values())


def device_info(torch, chips: int, peak: int, trace: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    out = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def emit(result: Dict[str, Any]) -> int:
    """Print the comparisons on standard error, check that no module of JAX
    was loaded, then print ``result`` as the last line of standard output."""
    checks = result.get("checks", {})
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    ordered = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device") if k in result}
    if "breakdown" in result:
        ordered["breakdown"] = result["breakdown"]
    ordered["checks"] = checks
    print(json.dumps(ordered), flush=True)
    return 0
