"""The correctness check catches the faults a cell can have.

Each test skips the harness's look for a card and drives the rest of a run
(tiny configuration, CPU, the cell's own limits) with the timed path broken
underneath, and sees ``correct`` come out false; the same run unbroken comes
out true.  The pretraining cells can have a step that returns its state
unchanged and half of the batch left out (the mean taken over the rest); the
serving cell a token altered where it is produced.  No cell spans chips, so
no exchange between chips can be left out.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench.kinds import pretrain, serve
from portbench.tests import tiny


def _pretrain(workload):
    return pretrain.run(tiny.spec(workload, tiny.TINY, tiny.PRETRAIN), 31, 0.3, False, time.monotonic())


def _serve():
    return serve.run(tiny.spec("base-serve", tiny.TINY, tiny.SERVE), 32, 0.5, False, time.monotonic())


@pytest.mark.parametrize("workload", ["base-pretrain", "large-pretrain"])
def test_sound_pretraining_run_is_correct(monkeypatch, workload):
    tiny.on_cpu(monkeypatch)
    assert _pretrain(workload)["correct"]


@pytest.mark.parametrize("workload", ["base-pretrain", "large-pretrain"])
def test_state_left_unchanged_is_caught(monkeypatch, workload):
    from valor_tpu_torch.train.optimizer import GroupedAdam

    tiny.on_cpu(monkeypatch)
    monkeypatch.setattr(GroupedAdam, "update", lambda self, grads: True)
    out = _pretrain(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["base-pretrain", "large-pretrain"])
def test_half_batch_left_out_is_caught(monkeypatch, workload):
    from valor_tpu_torch.models.valor import VALORModel

    tiny.on_cpu(monkeypatch)
    forward = VALORModel.forward

    def half(self, batch, task, compute_loss=True, train=True):
        rows = batch["bert_tokens"].shape[0]
        cut = {k: v[: rows // 2] if torch.is_tensor(v) and v.shape[0] == rows else v for k, v in batch.items()}
        return forward(self, cut, task, compute_loss, train)

    monkeypatch.setattr(VALORModel, "forward", half)
    out = _pretrain(workload)
    assert not out["correct"], out["checks"]


def test_sound_serving_run_is_correct(monkeypatch):
    tiny.on_cpu(monkeypatch)
    assert _serve()["correct"]


def test_altered_token_is_caught(monkeypatch):
    from valor_tpu_torch.eval.generate import Generator

    tiny.on_cpu(monkeypatch)
    generate = Generator.generate

    def altered(self, batch, groups, **kw):
        out = generate(self, batch, groups, **kw)
        seqs = out["generated_sequences_tva"].clone()
        seqs[:, 0] = (seqs[:, 0] + 1) % tiny.TINY["fusion_vocab"]
        out["generated_sequences_tva"] = seqs
        return out

    monkeypatch.setattr(Generator, "generate", altered)
    out = _serve()
    assert not out["correct"], out["checks"]
