#!/usr/bin/env python3
"""Reads the correctness check's controls and faults on the card, at a cell's own size.

    python3 portbench/control.py --workload base-pretrain --seeds 11,12,13
    python3 portbench/control.py --workload base-serve --seeds 11,12,13 --seconds 6

Not run by the benchmark's cells: it gives the upper readings that the limits
in ``limits/<workload>.json`` sit below.  For each seed it prints one JSON line.

* A pretraining cell: the reference in fp32 (the lower side's yardstick) and,
  in the program's place, (1) the control, the reference with every product
  in fp8 as fp8 training computes it (e4m3 operands, e5m2 gradients, one
  scale a tensor: the step below the configuration's bf16),
  and (2) the fault "half of the batch left out, the mean taken over the
  rest", the reference on the first half of every batch's rows; each read by
  the cell's own comparison (``kinds/pretrain.py:compare``).  Beside them, a
  witness: the reference with its products' operands rounded to bf16, the
  configuration's own precision, which shows how far bf16 products alone
  move each reading.  The fault "a step
  that returns its state unchanged" reads 1 on ``update_gap`` by that
  measure and needs no run.
* A serving cell: a short window of the program at the mix's rate (every
  request finished), the sample the cell checks, and on it the served
  tokens' gap (the program's reading), the control's (at each step, the gap
  of the token that the fp8 reference puts first) and a fault's (each served
  token replaced by the next id, as if altered where it is produced).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import generators, harness  # noqa: E402
from portbench.kinds import pretrain, serve  # noqa: E402


def pretrain_seed(torch, s, seed: int) -> dict:
    from valor_tpu_torch.core.config import load_config

    prog = harness.program_config(s["config"])
    full = load_config(None, prog)
    device = harness.device(torch)
    pool = [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in generators.pretrain_pool(dict(s["traffic"], pool=pretrain.CHECK_STEPS), prog, seed)]
    half = [{k: v if k.startswith("prompt") else v[: v.shape[0] // 2] for k, v in b.items()} for b in pool]
    ref = pretrain.reference(torch, prog, seed, pool, full, device)
    out = {"seed": seed}
    for name, batches, numerics in (("control_fp8", pool, "fp8"), ("fault_half_batch", half, "fp32"),
                                    ("witness_bf16", pool, "bf16")):
        out[name] = pretrain.compare(pretrain.reference(torch, prog, seed, batches, full, device, numerics), ref)
    return out


def serve_seed(torch, s, seed: int, seconds: float) -> dict:
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import load_model
    from valor_tpu_torch.serve import InferenceEngine, ServeConfig

    from portbench import weights

    traffic = s["traffic"]
    prog = harness.program_config(s["config"])
    device = harness.device(torch)
    model = load_model(load_config(None, prog).model, weights.make(prog, seed, device), device)
    pool = generators.serve_pool(traffic, prog, seed)
    due = generators.arrivals(traffic["rate"], seconds, seed)
    which = generators.request_items(len(due), len(pool), seed)
    with InferenceEngine(model, ServeConfig(
            buckets=tuple(traffic["buckets"]), max_wait_ms=traffic["max_wait_ms"], group=traffic["group"],
            max_len=traffic["max_len"], max_pending=traffic["max_pending"])) as engine:
        loop = serve.open_loop(engine, pool, due, which, time.monotonic(), traffic["drain_s"], seconds)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    served = loop["served"]
    sample = serve.check_sample(served, traffic["check_requests"], seed)
    items, seqs = [pool[which[i]] for i in sample], [served[i] for i in sample]
    ref = serve.build_reference(torch, prog, seed, device)
    low = serve.build_reference(torch, prog, seed, device, "fp8")
    vocab = ref.shape.vocab
    program = control = fault = 0.0
    tokens = 0
    for item, seq in zip(items, seqs):
        logits = serve.reference_logits(ref, torch, item, seq, device)
        best = logits.max(1).values
        steps = logits.shape[0]
        tokens += steps
        mine = torch.as_tensor([int(t) for t in seq[:steps]], device=device)
        fp8 = serve.reference_logits(low, torch, item, seq, device).argmax(1)
        altered = (mine + 1) % vocab
        for picked, name in ((mine, "program"), (fp8, "control"), (altered, "fault")):
            gap = float((best - logits.gather(1, picked[:, None])[:, 0]).max())
            if name == "program":
                program = max(program, gap)
            elif name == "control":
                control = max(control, gap)
            else:
                fault = max(fault, gap)
    del ref, low
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed": seed, "requests": len(due), "failed": loop["failed"], "checked": len(sample), "tokens": tokens,
            "program_logit_gap": program, "control_fp8_logit_gap": control, "fault_altered_logit_gap": fault}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0, help="a serving cell's window")
    args = ap.parse_args(argv)
    s = harness.spec(args.workload)
    torch = harness.require_cuda(s["cell"]["chips"])
    for seed in (int(x) for x in args.seeds.split(",")):
        if s["traffic"]["kind"] == "pretrain":
            row = pretrain_seed(torch, s, seed)
        else:
            row = serve_seed(torch, s, seed, args.seconds)
        row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
