"""A tiny VALOR configuration and mixes for the benchmark's CPU tests."""

from __future__ import annotations

import json
from typing import Any, Dict

import torch

from portbench import harness

TASK = "pt_contra%tva%tv%ta_caption%tva%tv%ta"
TINY = dict(
    video_encoder_type="clip_vit_tiny", txt_encoder_type="clip_vit_tiny", video_resolution=32,
    audio_melbins=16, audio_target_length=32, audio_patch_size=16, fusion_hidden=32, fusion_layers=2,
    fusion_heads=2, fusion_intermediate=64, fusion_vocab=512, audio_hidden=32, audio_layers=2,
    audio_heads=2, audio_intermediate=64, dtype="float32", num_train_steps=39063, learning_rate=1e-4,
    optim="adamw", betas=[0.9, 0.98], weight_decay=0.01, grad_norm=2.0, warmup_ratio=0.1, seed=50,
    max_generation_len=6,
)
PRETRAIN = dict(kind="pretrain", task=TASK, batch=4, frames=2, clips=1, n_txt=12, min_txt=6, pool=4,
                warmup_steps=1, trace_steps=2)
SERVE = dict(kind="serve", rate=20.0, frames=2, clips=2, max_len=6, group="tva", buckets=[1, 4, 16, 64],
             max_wait_ms=25.0, max_pending=1024, pool=8, drain_s=60.0, check_requests=4, trace_s=0.3,
             trace_tail_s=1.0)


def on_cpu(monkeypatch) -> None:
    """Run the cells' code on the CPU (skipping the look for a card)."""
    monkeypatch.setattr(harness, "require_cuda", lambda chips: torch)
    monkeypatch.setattr(harness, "device", lambda t: t.device("cpu"))


def spec(workload: str, config: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """A cell's spec as ``harness.spec`` builds it, with the tiny configuration and mix,
    and the cell's own limits and metric entries."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {"cell": {"name": workload, "chips": 1}, "config": config, "traffic": traffic,
            "limits": harness.load_json(harness.HERE / "limits" / f"{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}
