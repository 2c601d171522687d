#!/usr/bin/env python3
"""Sweeps the offered rate of a serving cell once, to find its knee.

    python3 portbench/sweep.py --workload base-serve --seed 11 --seconds 20 --rates 20,30,40,50,60

One process builds the cell's model and engine as ``kinds/serve.py`` does and
warms its buckets, then offers each rate in turn for ``--seconds`` through the
same open loop, draining between rates.  Each rate prints one JSON line:
offered and completed captions a second, the latency percentiles from when a
request was due, the backlog (requests due and not done) at the window's
middle and close, the engine's queue p95, occupancy and pad fraction.  The
knee is the highest rate whose backlog did not grow over the window (at the
close no more than one top bucket above the middle); the cell's traffic file
takes 0.8 of it as a number.  Not run by the benchmark's cells.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import generators, harness, weights  # noqa: E402
from portbench.kinds.serve import open_loop  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="base-serve")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True, help="comma-separated captions a second")
    args = ap.parse_args(argv)
    s = harness.spec(args.workload)
    torch = harness.require_cuda(s["cell"]["chips"])
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import load_model
    from valor_tpu_torch.serve import InferenceEngine, ServeConfig

    traffic = s["traffic"]
    prog = harness.program_config(s["config"])
    device = harness.device(torch)
    model = load_model(load_config(None, prog).model, weights.make(prog, args.seed, device), device)
    pool = generators.serve_pool(traffic, prog, args.seed)
    top = traffic["buckets"][-1]
    rows = []
    with InferenceEngine(model, ServeConfig(
            buckets=tuple(traffic["buckets"]), max_wait_ms=traffic["max_wait_ms"], group=traffic["group"],
            max_len=traffic["max_len"], max_pending=traffic["max_pending"])) as engine:
        for b in traffic["buckets"]:
            for f in [engine.submit(pool[i % len(pool)]) for i in range(b)]:
                f.result(timeout=600)
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            due = generators.arrivals(rate, args.seconds, args.seed + k)
            which = generators.request_items(len(due), len(pool), args.seed + k)
            engine.reset_stats()
            loop = open_loop(engine, pool, due, which, time.monotonic() + 0.5, traffic["drain_s"], args.seconds)
            st = engine.stats()
            lat = loop["latency_s"]
            row = {"rate": rate, "offered": len(due), "completed_per_s": loop["completed"] / args.seconds,
                   "failed": loop["failed"], "p50_ms": 1e3 * harness.percentile(lat, 0.5),
                   "p95_ms": 1e3 * harness.percentile(lat, 0.95), "backlog_mid": loop["outstanding_mid"],
                   "backlog_end": loop["outstanding_end"], "queue_p95_ms": 1e3 * st["queue_p95_s"],
                   "mean_occupancy": st["mean_occupancy"], "pad_fraction": st["pad_fraction"],
                   "batches": st["batches"]}
            row["grows"] = row["backlog_end"] > row["backlog_mid"] + top or row["failed"] > 0
            rows.append(row)
            print(json.dumps(row), flush=True)
    steady = [r["rate"] for r in rows if not r["grows"]]
    knee = max(steady) if steady else None
    print(json.dumps({"knee": knee, "cell_rate": None if knee is None else round(0.8 * knee, 3),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
