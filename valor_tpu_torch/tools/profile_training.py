"""Where a VALOR-base pretraining step spends its time on the CUDA card.

    python3 -m valor_tpu_torch.tools.profile_training [--batch 32] [--out FILE]

Builds VALOR-base from ``configs/pretrain-valor-base.json`` (bf16, seeded
random weights) with its AdamW, and runs ``pt_contra%tva%tv%ta_caption%tva%tv%ta``
steps on one seeded synthetic batch (4 uint8 frames at 224 px, one 64 x 512
spectrogram clip, 40 BERT and 40 CLIP tokens a row).  After two warm-up steps
it reports, for one step of ``train/step.py:train_step`` as ``Trainer.run``
calls it:

  * host wall time of an unprofiled step, ended by a synchronise;
  * a ``torch.profiler`` trace of a further step: device time summed per
    kernel (top 15), the sum over all kernels and the number of launches, and
    that kernel time split over the step's three ``record_function`` ranges
    (forward, backward, optimizer update) by the range in which the host
    launched each kernel; the device's idle share is one minus the kernel
    time over the unprofiled step's wall time (the profiler slows the host,
    not the kernels);
  * ``torch.cuda.max_memory_allocated`` over the steps.

The last line of its output is one JSON object with these numbers and the
card's ``nvidia-smi`` name and power limit; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import torch

from valor_tpu_torch.core.config import load_config
from valor_tpu_torch.core.tasks import parse_task
from valor_tpu_torch.data.synthetic import pretrain_batch
from valor_tpu_torch.models.bridge import init_params, train_model
from valor_tpu_torch.train.optimizer import build_optimizer
from valor_tpu_torch.train.step import RANGES, TrainState, train_step

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "pretrain-valor-base.json"
TASK = "pt_contra%tva%tv%ta_caption%tva%tv%ta"


def split_by_range(events, names):
    """Device ms of the kernels launched inside each named host range, and of
    those launched outside all of them.  A kernel belongs to the op that
    launched it (``FunctionEvent.kernels``), and the op to the range whose host
    interval holds its start, on any thread (the backward runs in autograd's
    device thread while the calling thread waits inside its range).  The
    ranges' own spans on the device timeline are not kernels and are left out."""
    spans = {e.name: e.time_range for e in events
             if e.name in names and e.device_type.name == "CPU"}
    out = dict.fromkeys(names, 0.0)
    out["outside"] = 0.0
    for e in events:
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        t = e.time_range.start
        key = next((n for n, r in spans.items() if r.start <= t <= r.end), "outside")
        out[key] += sum(k.duration for k in e.kernels if k.name not in names) / 1e3
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    full = load_config(str(CONFIG))
    cfg = full.model
    tcfg = dataclasses.replace(full.train, num_train_steps=100)
    model = train_model(cfg, init_params(cfg, seed=0, device="cuda"), "cuda")
    state = TrainState(model, build_optimizer(model, tcfg, cfg.frozen_vision, cfg.frozen_multimodal))
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             pretrain_batch(cfg, args.batch, frames=4, clips=1, n_txt=40, seed=0).items()}
    task = parse_task(TASK)
    seed = tcfg.seed

    def step():
        return train_step(state, batch, task, seed, grad_dtype=tcfg.grad_dtype)

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # warm-up: cuBLAS handles, allocator, kernel build
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages()  # kernels; not the ranges' spans on the device
              if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    split = split_by_range(prof.events(), RANGES)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    result = {
        "card": card, "batch": args.batch, "task": TASK, "dtype": cfg.dtype,
        "step_host_s": step_s, "samples_per_s": args.batch / step_s,
        "profiled_step_host_s": prof_s,
        "forward_kernel_ms": split[RANGES[0]], "backward_kernel_ms": split[RANGES[1]],
        "optimizer_kernel_ms": split[RANGES[2]], "outside_ranges_kernel_ms": split["outside"],
        "profiled_kernel_ms": dev_us / 1e3, "profiled_kernel_launches": launches,
        "device_idle_share": 1.0 - dev_us / 1e6 / step_s,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": [
            {"name": e.key[:200], "ms": e.self_device_time_total / 1e3, "count": e.count}
            for e in top
        ],
    }
    for k, val in result.items():
        if k != "top_kernels":
            print(f"{k}: {val}")
    for row in result["top_kernels"]:
        print(f"  {row['ms']:9.3f} ms  {row['count']:6d}x  {row['name']}")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return result


if __name__ == "__main__":
    main()
