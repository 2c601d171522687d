"""(a) A cell, a traffic mix and a per-layer metric are new files and entries, found by name."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

from portbench import harness


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(root / "portbench")

    # a later PR's additions: one traffic file, one limits file, one metric reader, and entries
    (root / "portbench" / "traffic" / "pt-b16.json").write_text(json.dumps(dict(
        json.loads((root / "portbench" / "traffic" / "pt-b64.json").read_text()), batch=16)))
    (root / "portbench" / "limits" / "base-pretrain-b16.json").write_text(
        (root / "portbench" / "limits" / "base-pretrain.json").read_text())
    (root / "portbench" / "metrics" / "steps.train.py").write_text(
        '"""Optimizer steps in the window."""\n\n\ndef read(ctx):\n    return ctx.get("steps")\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "base-pretrain-b16", "config": "valor-base", "traffic": "pt-b16",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "trainer", "moves": "train_samples_per_s",
                               "workloads": ["base-pretrain-b16"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "base-pretrain" in m["workloads"]:
            m["workloads"].append("base-pretrain-b16")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    monkeypatch.setattr(harness, "HERE", root / "portbench")
    monkeypatch.setattr(harness, "ROOT", root)
    s = harness.spec("base-pretrain-b16")
    assert s["traffic"]["batch"] == 16 and s["traffic"]["kind"] == "pretrain"
    assert s["config"]["name"] == "valor-base"
    assert [m["name"] for m in s["per_layer"]] == ["steps.train"]
    assert {m["name"] for m in s["end_to_end"]} == {"train_samples_per_s", "setup_s"}
    assert harness.read_metrics(s["per_layer"], {"steps": 7}) == {"steps.train": {"value": 7.0, "unit": "steps"}}
    assert harness.kind_module(s["traffic"]["kind"]).run
    after = _digest(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before  # no file that was there changed


def test_every_entry_has_its_files():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        s = harness.spec(w["name"])
        assert set(s["limits"]["limits"]), w["name"]
        harness.kind_module(s["traffic"]["kind"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert harness.metric_reader(m["name"])({}) is None  # finds nothing to read in an empty run
