"""Asynchronous checkpoint writes of the port (``async_checkpoint``;
``train/checkpoints.py:ModelSaver(use_async=True)``), on the CPU.

The cases of ``tests/test_async_checkpoint.py`` (the JAX package's orbax
AsyncCheckpointer): the bookkeeping (best copy, removal of the previous step)
deferred until the write that produced it is durable, the round trip and the
best copy's content, the synchronous default unchanged, and the trainer
draining its writes; and, for the port: ``save`` returning before the write is
done, a snapshot that the next update mutates while the write waits (the file
holds the state as it was at ``save``), and ``cli.train --resume true`` after
asynchronous saves ending bit for bit where an uninterrupted run ends.
"""

import os
import sys
import threading

import pytest
import torch

from tests.test_torch_checkpoints import N_STEPS, TASK, _assert_states_equal, _batch, _build
from valor_tpu_torch.train import checkpoints as tck
from valor_tpu_torch.train.trainer import Trainer


def _state(v: float):
    """A tiny model's state with every parameter filled with ``v``."""
    _, state = _build(accum=1)
    with torch.no_grad():
        for p in state.model.parameters():
            p.fill_(v)
    return state


def _params(path):
    return torch.load(os.path.join(path, tck.STATE_FILE), weights_only=True)["params"]


class TestAsyncCheckpoint:
    def test_deferred_bookkeeping_ordering(self, tmp_path):
        out = tmp_path / "out"
        saver = tck.ModelSaver(str(out), use_async=True)
        assert saver.use_async

        saver.save(_state(1.0), 1, best_name="ret")
        assert saver._pending == (1, "ret")  # the write may be in flight; bookkeeping deferred

        saver.save(_state(2.0), 2)
        # save(2) drained save(1) first: best copied from step_1, and step_1 itself
        # still there (removed only once the next write is durable)
        assert saver._pending == (2, None)
        ckpt = out / "ckpt"
        assert (ckpt / "best_ret").exists()
        assert (ckpt / "step_1").exists()

        saver.finish()
        assert saver._pending is None
        assert not (ckpt / "step_1").exists()  # removed after step_2 was durable
        assert (ckpt / "step_2").exists()
        saver.finish()  # idempotent
        assert [s for s, _, _ in saver.writes] == [1, 2]

    def test_roundtrip_and_best_content(self, tmp_path):
        out = tmp_path / "out"
        saver = tck.ModelSaver(str(out), use_async=True)
        saver.save(_state(1.0), 1, best_name="ret")
        saver.save(_state(2.0), 2)
        restored = saver.restore()  # drains the write in flight itself
        assert restored["step"] == 2
        assert all(torch.equal(v, torch.full_like(v, 2.0)) for v in restored["params"].values())
        best = _params(out / "ckpt" / "best_ret")  # step 1's, copied before step_1 was removed
        assert all(torch.equal(v, torch.full_like(v, 1.0)) for v in best.values())

    def test_sync_default_unchanged(self, tmp_path):
        saver = tck.ModelSaver(str(tmp_path / "out"))
        assert not saver.use_async
        state = _state(3.0)
        saver.save(state, 1)
        assert saver._pending is None and saver.writes == []  # durable when save returns
        assert saver.latest_step() == 1
        # what the synchronous save wrote before: torch.save of the same payload
        ref = tmp_path / "ref"
        ref.mkdir()
        torch.save({"params": state.model.state_dict(), "opt_state": state.optimizer.state_dict(),
                    "step": 1, "micro_step": int(state.step)}, ref / tck.STATE_FILE)
        written = tmp_path / "out" / "ckpt" / "step_1" / tck.STATE_FILE
        assert written.read_bytes() == (ref / tck.STATE_FILE).read_bytes()

    def test_trainer_drains_async_writes(self, tmp_path):
        """``Trainer.run`` finishes the saver, so the final checkpoint is
        durable when ``run`` returns."""
        cfg, state = _build(accum=1)
        saver = tck.ModelSaver(str(tmp_path / "out"), use_async=True)
        trainer = Trainer(cfg, state, [(f"{TASK}--fix", _batch(100 + i)) for i in range(N_STEPS)], saver=saver)
        final = trainer.run()
        assert saver._pending is None and saver._thread is None
        assert saver.latest_step() == N_STEPS
        restored = saver.restore()
        for k, v in final.model.state_dict().items():
            assert torch.equal(restored["params"][k], v), k
        assert restored["opt_state"]["gradient_step"] == N_STEPS


def test_save_returns_before_the_write_and_snapshots_what_the_update_then_changes(tmp_path, monkeypatch):
    """The write waits until the next update has changed every parameter and
    moment; the file holds them as they were at ``save``."""
    gate, save0 = threading.Event(), torch.save

    def held_save(obj, f, *a, **kw):
        assert gate.wait(60)
        return save0(obj, f, *a, **kw)

    monkeypatch.setattr(tck.torch, "save", held_save)
    _, state = _build(accum=1)
    state.optimizer.update([torch.randn_like(p) for p in state.optimizer.params])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    mu_before = [m.clone() for m in state.optimizer.mu]
    saver = tck.ModelSaver(str(tmp_path / "out"), use_async=True)
    saver.save(state, 1)
    assert saver._thread.is_alive() and not (tmp_path / "out" / "ckpt" / "step_1").exists()
    state.optimizer.update([torch.randn_like(p) for p in state.optimizer.params])
    opt = state.optimizer
    assert all(not torch.equal(p, before[n]) for n, p, lbl in zip(opt.names, opt.params, opt.labels)
               if lbl != "frozen")
    gate.set()
    saver.finish()
    restored = saver.restore()
    for k, v in before.items():
        assert torch.equal(restored["params"][k], v), k
    for m, w in zip(restored["opt_state"]["mu"], mu_before):
        assert torch.equal(m, w)
    assert restored["opt_state"]["count"] == 1


def test_a_failed_write_raises_at_finish(tmp_path, monkeypatch):
    def broken_save(obj, f, *a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tck.torch, "save", broken_save)
    saver = tck.ModelSaver(str(tmp_path / "out"), use_async=True)
    saver.save(_state(1.0), 1)
    with pytest.raises(RuntimeError, match="step 1 failed"):
        saver.finish()
    assert saver.latest_step() is None


def test_cli_resume_after_async_saves_is_bit_exact(tmp_path, monkeypatch):
    """``cli.train --async_checkpoint true`` for 2 steps, then ``--resume true``
    to 4, against 4 uninterrupted steps: the same bits; the restored state is
    the first run's.  The flow draws nothing at random on the host and holds
    one training id, so every micro-batch is the same whatever the epoch (a
    resumed run's loader starts its shuffles again, as the JAX package's), and
    the learning rate is constant (a schedule reads ``num_train_steps``)."""
    from tests.test_torch_ddp_cli import _config, _env, _flow
    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.data.synthetic import write_retrieval_dataset

    data = write_retrieval_dataset(str(tmp_path / "data"), n_train=1, n_val=1, n_frames=2, frame_size=(64, 48),
                                   wav_seconds=1.0, captions_per_train_id=1, workers=2)
    for k, v in _env({"ret": data}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)  # the golden tests stub it
    cfg = _config({"ret": data}, tmp_path / "config.json", str(tmp_path / "out"), [],
                  train=[_flow(data, "train", "pt_contra%tv_caption%tv", 1)], caption_type="lm",
                  gradient_accumulation_steps=2, num_train_steps=4, scheduler="warmup_constant", warmup_ratio=0.0)

    def run(out, *extra):
        return main(["--config", cfg, "--device", "cpu", "--async_checkpoint", "true", "--output_dir",
                     str(tmp_path / out), *extra])

    whole = run("whole")
    first = run("parts", "--num_train_steps", "2")
    saved = {k: v.clone() for k, v in first.state.model.state_dict().items()}
    restored = {}
    load0 = tck.load_state

    def load(state, payload):
        load0(state, payload)
        restored.update({k: v.clone() for k, v in state.model.state_dict().items()})

    monkeypatch.setattr(tck, "load_state", load)
    second = run("parts", "--resume", "true")
    assert restored and all(torch.equal(restored[k], v) for k, v in saved.items())
    assert [h[0] for h in second.history] == [5, 6, 7, 8]
    _assert_states_equal(whole.state, second.state)
    assert sorted(os.listdir(tmp_path / "parts" / "ckpt")) == ["step_2", "step_4"]
