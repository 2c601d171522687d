"""Data-parallel training steps of the port (two gloo ranks on the CPU) against
the port's one process, and exact resume at two ranks.

The tiny config in fp32, dropout on and unimlm masks drawn: at the global
batch's shape, this rank's rows taken, so two ranks draw what one process draws.
``pt``, and ``qa`` whose one-process batch holds the ranks' answer rows in rank
order (``tests/test_torch_ddp.py:_one_process_qa``): the losses, the gradients
and one optimizer update of 2 x 4 rows within 1e-5 of 1 x 8 (fp32 sums in
another order), and the two ranks' updated parameters the same bits.  Resume
under gradient accumulation, stopped mid-accumulation: the same bits.
"""

import pytest
import torch

from tests.test_torch_ddp import (
    LIMIT, PT_TASK, SEED, TOL_ONE, UPDATE, WORLD, _batch, _cfg, _close, _one_process_qa, _qa_batch, _shards, _step,
    make_cases, run_cases,
)
from valor_tpu_torch.core.config import TrainConfig
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models.bridge import init_params, train_model
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.launch import run_local
from valor_tpu_torch.train.optimizer import build_optimizer

DRAWN_CASES = {
    "pt_drawn": (dict(dropout=0.1, caption_type="unimlm"), PT_TASK, lambda: _batch(7)),
    "qa_drawn": (dict(dropout=0.1, caption_type="unimlm"), "qa%tva", lambda: _qa_batch(8)),
}
RESUME_TASK = "pt_contra%tv_caption%tv"


@pytest.fixture(scope="module")
def cases():
    return make_cases(DRAWN_CASES, update=True)


@pytest.fixture(scope="module")
def ranks(cases):
    return run_cases(cases)


@pytest.mark.parametrize("name", sorted(DRAWN_CASES))
def test_two_ranks_equal_one_process_with_draws(name, cases, ranks):
    """Losses, gradients and one update of 2 x 4 rows against 1 x 8, dropout
    and masks drawn; both ranks' updated parameters the same bits."""
    c = cases[name]
    batch = _one_process_qa(c["shards"]) if name == "qa_drawn" else c["batch"]
    one = _step(c["cfg"], batch, c["task"], update=True)
    for out in ranks:
        got = out[name]
        assert set(got["metrics"]) == set(one["metrics"])
        for k, v in one["metrics"].items():
            _close(got["metrics"][k], v, TOL_ONE, f"{name} {k}")
        for n, g in one["grads"].items():
            _close(got["grads"][n], g, TOL_ONE, f"{name} grad {n}")
        for n, p in one["params"].items():
            _close(got["params"][n], p, TOL_ONE, f"{name} updated {n}")
    for n, p in ranks[0][name]["params"].items():
        assert torch.equal(p, ranks[1][name]["params"][n]), n


def test_masks_and_dropout_were_drawn(cases):
    """The drawn cases draw: another seed gives other losses."""
    from valor_tpu_torch.ops.layers import RNGStreams, rng_scope

    c = cases["pt_drawn"]
    model = train_model(c["cfg"], init_params(c["cfg"], 0, "cpu"), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    losses = []
    for seed in (SEED, SEED + 1):
        with torch.no_grad(), rng_scope(RNGStreams(seed)):
            losses.append(float(model(batch, tparse(c["task"]))["caption_loss"]))
    assert losses[0] != losses[1]


# -- exact resume at two ranks ---------------------------------------------------
def _train(state, batches, task, seed=3):
    from valor_tpu_torch.train.step import train_step

    for b in batches:
        train_step(state, {k: torch.from_numpy(v) for k, v in b.items()}, tparse(task), seed)


def _rank_resume(cfg, batches, task, out_dir):
    """Four micro-batches (gradient accumulation 2) in one run, and in a run
    stopped after micro-batch 3 (half an accumulation), saved by rank 0,
    restored by every rank and continued."""
    from valor_tpu_torch.train.checkpoints import ModelSaver, load_state
    from valor_tpu_torch.train.step import TrainState

    P.init_data_parallel("gloo", "cpu")
    mine = [s[P.rank()] for s in batches]
    tcfg = TrainConfig(**UPDATE, gradient_accumulation_steps=2)

    def fresh():
        model = train_model(cfg, init_params(cfg, 0, "cpu"), "cpu")
        return TrainState(model, build_optimizer(model, tcfg))

    whole = fresh()
    _train(whole, mine, task)
    first = fresh()
    _train(first, mine[:3], task)
    saver = ModelSaver(out_dir)
    saver.save(first, 1)
    resumed = fresh()
    load_state(resumed, ModelSaver(out_dir).restore())
    _train(resumed, mine[3:], task)
    opt_a, opt_b = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    return {"step": (whole.step, resumed.step, resumed.optimizer.mini_step),
            "params": all(torch.equal(a, b) for a, b in zip(whole.model.parameters(), resumed.model.parameters())),
            "moments": all(torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(opt_a[k], opt_b[k])),
            "counts": (opt_a["count"], opt_a["gradient_step"]) == (opt_b["count"], opt_b["gradient_step"]),
            "first_param": next(whole.model.parameters()).detach().clone()}


def test_resume_at_two_ranks_is_bit_exact(tmp_path):
    cfg = _cfg(dropout=0.1, caption_type="unimlm")
    batches = [_shards(_batch(20 + i)) for i in range(4)]
    outs = run_local(_rank_resume, WORLD, cfg, batches, RESUME_TASK, str(tmp_path), timeout=LIMIT)
    for out in outs:
        assert out["step"] == (4, 4, 0)
        assert out["params"] and out["moments"] and out["counts"]
    assert torch.equal(outs[0]["first_param"], outs[1]["first_param"])
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_1"]
