"""ZeRO-1 of the port (``zero_optimizer``): the optimizer state split over two
gloo ranks on the CPU, against the replicated optimizer and one process.

Follows ``tests/test_pipeline_scale.py:TestZeroOptimizerSharding`` (the JAX
placement shards big leaves and the step stays equal to the replicated one)
and ``tests/test_fsdp.py`` (equal losses, sharded state), on the tiny config
in fp32 with dropout and unimlm masks drawn, its fusion vocabulary at 4096 so
that some leaves reach the placement's 2^14 elements (as the JAX test does).
All rank-side work runs in one two-rank launch.  The checks:

  * each rank holds the JAX placement's share (``parallel/mesh.py:
    zero_sharded``) of the moments and the accumulator, and fewer bytes than
    the replicated optimizer;
  * the two-rank ZeRO steps equal the two-rank replicated ones within 1e-5
    (the clip's norm sums the blocks' squares in another order), with and
    without ``gradient_accumulation_steps`` 2, and with a ZeRO run saved
    mid-accumulation, restored and continued;
  * a checkpoint saved at W = 2 restores at W = 1 and one saved at W = 1
    restores at W = 2 bit for bit (the state whole, each rank's blocks), and
    each continues within 1e-5 of the other world's continuation (1e-5: two
    ranks against one process, tests/test_torch_ddp_steps.py);
  * ``cli.train --zero_optimizer true`` under two ranks gives the losses of
    the replicated two-rank run within 1e-5 and saves the whole state;
  * ``cli.train --model_shards 2`` (tensor parallelism, data 1 x model 2)
    gives them too, each rank holding half of every model-split leaf, and
    saves whole tensors.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_ddp import PT_TASK, UPDATE, WORLD, _batch, _cfg, _shards
from valor_tpu_torch.core.config import TrainConfig
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models.bridge import init_params, train_model
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.launch import run_local
from valor_tpu_torch.train.optimizer import build_optimizer

LIMIT = 240
TOL = 1e-5
SEED = 3  # the steps' random streams
MICRO = 4  # global micro-batches of 8 rows
CFG_KW = dict(dropout=0.1, caption_type="unimlm", fusion_vocab=4096)


def _state(cfg, zero, accum):
    from valor_tpu_torch.train.step import TrainState

    model = train_model(cfg, init_params(cfg, 0, "cpu"), "cpu")
    tcfg = TrainConfig(**UPDATE, gradient_accumulation_steps=accum, zero_optimizer=zero)
    return TrainState(model, build_optimizer(model, tcfg))


def _steps(state, batches, task=PT_TASK):
    """``train_step`` on each batch; the losses of each."""
    from valor_tpu_torch.train.step import train_step

    out = []
    for b in batches:
        m = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()}, tparse(task), SEED)
        out.append({k: float(v) for k, v in m.items()})
    return out


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _whole(state):
    """The state a checkpoint takes (the optimizer's gathered whole on rank 0,
    this rank's blocks of the split leaves elsewhere), as CPU copies."""
    opt = state.optimizer.state_dict()
    return {"params": _params(state), "counters": (state.step, opt["count"], opt["mini_step"], opt["gradient_step"]),
            "tensors": [t.detach().cpu().clone() for t in opt["mu"] + opt["nu"] + (opt["acc"] or [])]}


def _rank_zero(cfg, batches, one_ckpt, out_dir, cli, env):
    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.train.checkpoints import ModelSaver, load_state

    os.environ.update(env)
    P.init_data_parallel("gloo", "cpu")
    r = P.rank()
    mine = [s[r] for s in batches]
    out = {}
    # placement and step equality, with and without accumulation
    for accum in (1, 2):
        zero, rep = _state(cfg, True, accum), _state(cfg, False, accum)
        opt = zero.optimizer
        out[f"placement_{accum}"] = {
            "sharded": list(opt.sharded), "shapes": [tuple(p.shape) for p in opt.params],
            "mu": [tuple(t.shape) for t in opt.mu], "acc": None if opt.acc is None else [tuple(t.shape) for t in opt.acc],
            "live": list(opt.live), "bytes": opt.state_bytes(), "replicated_bytes": rep.optimizer.state_bytes()}
        out[f"zero_{accum}"] = _steps(zero, mine)
        out[f"rep_{accum}"] = _steps(rep, mine)
        out[f"zero_{accum}_params"], out[f"rep_{accum}_params"] = _params(zero), _params(rep)
    # a ZeRO run saved mid-accumulation (after micro-batch 3 of 4), restored at W = 2 and continued
    first = _state(cfg, True, 2)
    _steps(first, mine[:3])
    out["saved_w2"] = _whole(first)
    ModelSaver(os.path.join(out_dir, "w2")).save(first, 1)
    resumed = _state(cfg, True, 2)
    load_state(resumed, ModelSaver(os.path.join(out_dir, "w2")).restore())
    out["resumed_w2"] = _steps(resumed, mine[3:])
    out["resumed_w2_params"] = _params(resumed)
    # the one-process checkpoint restored at W = 2: this rank's blocks and the whole, then continued
    from_one = _state(cfg, True, 2)
    payload = ModelSaver(one_ckpt).restore()
    load_state(from_one, payload)
    opt = from_one.optimizer
    saved = payload["opt_state"]
    out["blocks_equal"] = all(
        torch.equal(t, opt._mine(i, s)) for store, full, idx in (
            (opt.mu, saved["mu"], opt.live), (opt.nu, saved["nu"], opt.live),
            (opt.acc, saved["acc"], range(len(opt.params)))) for t, s, i in zip(store, full, idx))
    out["from_one"] = _whole(from_one)
    _steps(from_one, mine[3:])
    out["from_one_params"] = _params(from_one)
    # cli.train under two ranks, replicated and ZeRO
    for name, extra in (("cli_rep", []), ("cli_zero", ["--zero_optimizer", "true"]),
                        ("cli_tp", ["--model_shards", "2"])):
        trainer = main(["--config", cli, "--device", "cpu", "--output_dir", os.path.join(out_dir, name), *extra])
        out[name] = [h[2] for h in trainer.history]
        out[f"{name}_zero"] = trainer.state.optimizer.zero_world
        model = trainer.state.model
        out[f"{name}_held"] = {n: (p.numel(), model.placements[n].model_dim) for n, p in model.named_parameters()}
        out[f"{name}_grid"] = (P.data_rank(), P.data_world(), P.model_rank(), P.model_world())
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The one-process runs, then every rank-side check in one launch."""
    from tests.test_torch_ddp_cli import _config, _env, _flow
    from valor_tpu_torch.data.synthetic import write_retrieval_dataset
    from valor_tpu_torch.train.checkpoints import ModelSaver

    root = tmp_path_factory.mktemp("zero")
    cfg = _cfg(**CFG_KW)
    batches = [_batch(40 + i) for i in range(MICRO)]
    shards = [_shards(b) for b in batches]
    # one process: saved after micro-batch 3 (mid-accumulation), then continued
    one = _state(cfg, False, 2)
    _steps(one, batches[:3])
    ModelSaver(str(root / "w1")).save(one, 1)
    saved_w1 = _whole(one)
    _steps(one, batches[3:])
    # cli.train's fixture: a flow that draws nothing at random on the host
    data = write_retrieval_dataset(str(root / "data"), n_train=8, n_val=2, n_frames=2, frame_size=(64, 48),
                                   wav_seconds=1.0, captions_per_train_id=1, workers=2)
    cli = _config({"ret": data}, root / "config.json", str(root / "out"), [],
                  train=[_flow(data, "train", "pt_contra%tv_caption%tv", 4)], fusion_vocab=4096,
                  caption_type="lm", num_train_steps=2)
    ranks = run_local(_rank_zero, WORLD, cfg, shards, str(root / "w1"), str(root / "ranks"), cli,
                      _env({"ret": data}), timeout=LIMIT)
    return {"cfg": cfg, "batches": batches, "one_params": _params(one), "saved_w1": saved_w1, "ranks": ranks,
            "root": root}


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL, err_msg=what)


def _same(a, b, rank=0):
    """``a``, the state a checkpoint takes from rank ``rank`` (its own blocks
    of the split leaves off rank 0), equal bit for bit to ``b``, whole."""
    assert a["counters"] == b["counters"]
    assert a["params"].keys() == b["params"].keys()
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    assert len(a["tensors"]) == len(b["tensors"])
    blocks = 0
    for i, (x, y) in enumerate(zip(a["tensors"], b["tensors"])):
        if rank and x.shape != y.shape:
            y, blocks = y.chunk(WORLD)[rank], blocks + 1
        assert x.dtype == y.dtype and torch.equal(x, y), i
    assert bool(blocks) == bool(rank)  # only rank 0 holds the gathered whole


def test_placement_is_the_jax_rule():
    assert P.zero_sharded((4096, 32), 2) and P.zero_sharded((1 << 14,), 2)
    assert not P.zero_sharded((4095, 32), 2)  # dim 0 indivisible
    assert not P.zero_sharded((512, 31), 2)  # under 2^14 elements
    assert not P.zero_sharded((), 2)
    assert P.zero_sharded((3, 8192), 1)  # one rank: one block, the whole leaf


def test_one_rank_is_the_replicated_optimizer(tmp_path):
    """A one-rank group (``torch.distributed.run`` with one process) splits
    nothing: its update runs no collective of ZeRO-1."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        opt = _state(_cfg(**CFG_KW), True, 2).optimizer
        assert (opt.zero_world, any(opt.sharded)) == (0, False)
        assert opt.state_bytes() == _state(_cfg(**CFG_KW), False, 2).optimizer.state_bytes()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("accum", [1, 2])
def test_each_rank_holds_its_share(run, accum):
    for r, out in enumerate(run["ranks"]):
        pl = out[f"placement_{accum}"]
        assert pl["sharded"] == [P.zero_sharded(s, WORLD) for s in pl["shapes"]]
        assert any(pl["sharded"]) and not all(pl["sharded"])
        block = [(s[0] // WORLD,) + s[1:] if sh else s for s, sh in zip(pl["shapes"], pl["sharded"])]
        assert pl["mu"] == [block[i] for i in pl["live"]]
        assert pl["acc"] == (None if accum == 1 else block)
        assert pl["bytes"] < pl["replicated_bytes"]


@pytest.mark.parametrize("accum", [1, 2])
def test_zero_steps_equal_replicated_steps(run, accum):
    for out in run["ranks"]:
        for got, want in zip(out[f"zero_{accum}"], out[f"rep_{accum}"]):
            assert got.keys() == want.keys()
            for k in want:
                _close(got[k], want[k], f"{k}, accumulation {accum}")
        for n, p in out[f"rep_{accum}_params"].items():
            _close(out[f"zero_{accum}_params"][n], p, n)
    a, b = (run["ranks"][r][f"zero_{accum}_params"] for r in range(WORLD))
    for n in a:  # every rank holds the whole model, the same bits
        assert torch.equal(a[n], b[n]), n


def test_zero_resumed_mid_accumulation_continues(run):
    for out in run["ranks"]:
        assert out["saved_w2"]["counters"][2] == 1  # saved with half an accumulation in acc
        for n, p in out["zero_2_params"].items():
            assert torch.equal(out["resumed_w2_params"][n], p), n


def test_w2_checkpoint_resumes_at_w1_and_w1_at_w2(run):
    from valor_tpu_torch.train.checkpoints import ModelSaver, load_state

    cfg, ranks = run["cfg"], run["ranks"]
    # W = 2 -> W = 1: the state whole, bit for bit; continued within TOL of W = 2
    _same(ranks[1]["saved_w2"], ranks[0]["saved_w2"], rank=1)
    one = _state(cfg, False, 2)
    load_state(one, ModelSaver(str(run["root"] / "ranks" / "w2")).restore())
    _same(_whole(one), ranks[0]["saved_w2"])
    _steps(one, run["batches"][3:])
    for n, p in _params(one).items():
        _close(p, ranks[0]["resumed_w2_params"][n], f"W=1 continuation of the W=2 checkpoint, {n}")
    # W = 1 -> W = 2: each rank's blocks and the whole, bit for bit; continued within TOL of W = 1
    for r, out in enumerate(ranks):
        assert out["blocks_equal"]
        _same(out["from_one"], run["saved_w1"], r)
        for n, p in run["one_params"].items():
            _close(out["from_one_params"][n], p, f"W=2 continuation of the W=1 checkpoint, {n}")


def test_cli_train_zero_under_two_ranks(run):
    for out in run["ranks"]:
        assert (out["cli_rep_zero"], out["cli_zero_zero"]) == (0, WORLD)
        assert len(out["cli_zero"]) == len(out["cli_rep"]) == 2
        for got, want in zip(out["cli_zero"], out["cli_rep"]):
            for k in want:
                _close(got[k], want[k], f"cli.train {k}")
    saved = torch.load(os.path.join(run["root"], "ranks", "cli_zero", "ckpt", "step_2", "state.pt"),
                       weights_only=True)
    for mu, p in zip(saved["opt_state"]["mu"], saved["params"].values()):
        assert mu.shape == p.shape  # whole moments, as the replicated run saves them
    with open(os.path.join(run["root"], "ranks", "cli_zero", "hps.json")) as f:
        assert json.load(f)["train"]["zero_optimizer"] is True


def test_cli_train_model_shards_under_two_ranks(run):
    """Tensor parallelism through ``cli.train``: both ranks are model ranks of
    one data rank, load the same rows and report the losses of the two data
    ranks' run within 1e-5; each holds half of a model-split leaf."""
    whole = {n: held for n, (held, _) in run["ranks"][0]["cli_rep_held"].items()}  # the replicated run's
    for r, out in enumerate(run["ranks"]):
        assert out["cli_tp_grid"] == (0, 1, r, WORLD) and out["cli_rep_grid"] == (r, WORLD, 0, 1)
        assert len(out["cli_tp"]) == len(out["cli_rep"]) == 2
        for got, want in zip(out["cli_tp"], out["cli_rep"]):
            for k in want:
                _close(got[k], want[k], f"cli.train --model_shards 2 {k}")
        split = {n: held for n, (held, dim) in out["cli_tp_held"].items() if dim is not None}
        assert split and all(held * WORLD == whole[n] for n, held in split.items())
    saved = torch.load(os.path.join(run["root"], "ranks", "cli_tp", "ckpt", "step_2", "state.pt"),
                       weights_only=True)
    assert {n: p.numel() for n, p in saved["params"].items()} == whole
