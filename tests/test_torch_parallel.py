"""``valor_tpu_torch/parallel``: the data axis's collectives in two gloo ranks on
the CPU (``parallel/launch.py:run_local``), against the same arithmetic in one
process, and their short-circuit in one process; the launcher's environment,
its refusals, the batch shards and the draws at the global batch's shape.

Every two-rank call runs under ``run_local``'s own time limit, which kills
the ranks of a deadlocked collective.  Tolerances: gathers and object
collectives exactly; reductions 1e-6 (fp32 sums in another order).
"""

import os
import time

import numpy as np
import pytest
import torch

from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.launch import run_local

WORLD = 2
LIMIT = 120  # seconds a two-rank call may take


def _x(r, rows=4, cols=3):
    return torch.from_numpy(np.random.RandomState(10 + r).randn(rows, cols).astype(np.float32))


def _loss(y, r):
    """A rank-dependent loss of a gathered tensor."""
    c = torch.arange(1, y.numel() + 1, dtype=torch.float32).reshape(y.shape) * (r + 1)
    return ((y * c) ** 2).sum() / 100.0


def _collectives():
    P.init_data_parallel("gloo", "cpu")
    r = P.rank()
    out = {"rank": r, "world": C.process_count()}
    out["objects"] = C.all_gather_objects({"rank": r, "ids": list(range(r + 1))})
    out["lists"] = C.all_gather_lists([f"id{r}_{i}" for i in range(r + 2)])
    out["arrays"] = C.gather_arrays(_x(r))
    out["ragged"] = C.all_gather_ragged(_x(r, rows=3 - 2 * r))  # 3 rows and 1 row
    out["empty"] = C.all_gather_ragged(_x(r, rows=2 if r == 0 else 0))  # rank 1's shard is empty
    out["ints"] = C.all_gather_ragged(torch.arange(r + 1, dtype=torch.int64)[:, None])
    x = _x(r).requires_grad_(True)
    y = C.all_gather_with_grad(x)
    (_loss(y, r) + (x ** 3).sum()).backward()
    out["gathered"], out["gather_grad"] = y.detach(), x.grad
    z = _x(r).requires_grad_(True)
    _loss(C.all_reduce_mean_with_grad(z), r).backward()
    out["mean_grad"] = z.grad
    C.BUCKET_ELEMS = 7  # several buckets
    grads = [_x(r, 2, 3) * 1.0, _x(r + 5, 4, 1), _x(r + 7, 1, 1)]
    out["reduced_bytes"] = C.all_reduce_mean_(grads)
    out["reduced"] = grads
    with P.batch_shard(P.BatchShard(8, slice(r, 8, WORLD), collective=True)):
        out["sharded_mean"] = C.sharded_mean(torch.tensor(3.0 + r), torch.tensor(2.0 + 3 * r))
        out["global_means"] = C.global_means(torch.tensor([1.0 + r, 2.0]), torch.tensor([0.5, r * 1.0]), 4 + 2 * r)
    out["metrics"] = C.mean_over_ranks({"a": torch.tensor(1.0 + r), "b": torch.tensor(10.0 * r)})
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_local(_collectives, WORLD, timeout=LIMIT)


def test_object_and_list_gathers(ranks):
    for out in ranks:
        assert out["world"] == WORLD
        assert out["objects"] == [{"rank": 0, "ids": [0]}, {"rank": 1, "ids": [0, 1]}]
        assert out["lists"] == ["id0_0", "id0_1", "id1_0", "id1_1", "id1_2"]


def test_array_gathers_pad_gather_and_trim(ranks):
    for out in ranks:
        assert torch.equal(out["arrays"], torch.stack([_x(0), _x(1)]))
        assert torch.equal(out["ragged"], torch.cat([_x(0, rows=3), _x(1, rows=1)]))
        assert torch.equal(out["empty"], _x(0, rows=2))
        assert out["ints"].dtype == torch.int64 and out["ints"][:, 0].tolist() == [0, 0, 1]


def test_all_gather_with_grad_against_one_process(ranks):
    """Each rank's gradient is the one process's gradient of every rank's
    loss (and its own direct term) at its rows."""
    xs = torch.cat([_x(0), _x(1)]).requires_grad_(True)
    (sum(_loss(xs, r) for r in range(WORLD)) + (xs ** 3).sum()).backward()
    for r, out in enumerate(ranks):
        assert torch.equal(out["gathered"], xs.detach())
        np.testing.assert_allclose(out["gather_grad"], xs.grad[4 * r: 4 * r + 4], rtol=1e-6, atol=1e-6)


def test_all_reduce_mean_with_grad_against_one_process(ranks):
    zs = torch.stack([_x(0), _x(1)]).requires_grad_(True)
    mean = zs.mean(0)
    sum(_loss(mean, r) for r in range(WORLD)).backward()
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["mean_grad"], zs.grad[r], rtol=1e-6, atol=1e-6)


def test_gradient_buckets_average_in_place(ranks):
    want = [(_x(0, 2, 3) + _x(1, 2, 3)) / 2, (_x(5, 4, 1) + _x(6, 4, 1)) / 2, (_x(7, 1, 1) + _x(8, 1, 1)) / 2]
    for out in ranks:
        assert out["reduced_bytes"] == 4 * (6 + 4 + 1)
        for got, ref in zip(out["reduced"], want):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_sharded_means_average_to_the_global_mean(ranks):
    shares = [float(out["sharded_mean"]) for out in ranks]
    assert np.isclose(np.mean(shares), (3.0 + 4.0) / (2.0 + 5.0), rtol=1e-6)
    n = [4, 6]
    plain = (np.array([1.0, 2.0]) * n[0] + np.array([2.0, 2.0]) * n[1]) / 10
    with_grad = (np.array([0.5, 0.0]) * n[0] + np.array([0.5, 1.0]) * n[1]) / 10
    for out in ranks:
        np.testing.assert_allclose(out["global_means"][0], plain, rtol=1e-6)
        np.testing.assert_allclose(out["global_means"][1], with_grad, rtol=1e-6)
        assert {k: float(v) for k, v in out["metrics"].items()} == {"a": 1.5, "b": 5.0}


def test_one_process_short_circuits():
    assert not P.is_initialized() and C.process_count() == 1 and P.rank() == 0
    x = _x(0).requires_grad_(True)
    assert C.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert C.all_gather_lists([1, 2]) == [1, 2]
    assert torch.equal(C.gather_arrays(x.detach()), x.detach()[None])
    assert C.all_gather_ragged(x) is x
    assert C.all_gather_with_grad(x) is x and C.all_reduce_mean_with_grad(x) is x
    assert C.all_reduce_mean_([x.detach()]) == 0
    m = {"a": torch.tensor(2.0)}
    assert C.mean_over_ranks(m) is m
    assert float(C.sharded_mean(torch.tensor(3.0), 0)) == 3.0  # a count of 0 divides by 1
    assert P.step_shard({"bert_tokens": torch.zeros(4, 3)}) is None
    P.barrier()
    P.shutdown()


def _fails():
    P.init_data_parallel("gloo", "cpu")
    if P.rank() == 1:
        raise RuntimeError("rank 1 fails")
    P.barrier()  # rank 0 waits for a rank that is gone


def _hangs():
    P.init_data_parallel("gloo", "cpu")
    if P.rank() == 0:
        C.all_reduce_sum(torch.ones(1))
    else:
        time.sleep(600)


def test_a_failed_rank_fails_the_call():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_local(_fails, WORLD, timeout=LIMIT)
    assert time.monotonic() - t0 < LIMIT


def test_a_deadlocked_collective_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_local(_hangs, WORLD, timeout=10)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("env,want", [
    ({}, False), ({"WORLD_SIZE": "1"}, False), ({"WORLD_SIZE": "2"}, True),
    ({"WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1"}, True),
])
def test_launched_reads_the_launchers_environment(monkeypatch, env, want):
    for k in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert P.launched() is want


@pytest.mark.parametrize("backend,device,error", [
    ("nccl", "cpu", "needs a CUDA device"), ("mpi", "cpu", "nccl or gloo"),
])
def test_init_refuses_what_cannot_run(monkeypatch, backend, device, error):
    """No backend is switched for another: nccl on the CPU raises."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match=error):
        P.init_data_parallel(backend, device)
    assert not P.is_initialized()


def test_init_inside_a_joined_group_leaves_it_up(monkeypatch, tmp_path):
    """A process that joined the group already (several runs in one launch)
    gets its place in it; another backend than the group's raises."""
    import torch.distributed as dist

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert P.init_data_parallel(None, "cpu") == P.DataParallel(0, 1, 0, "gloo", torch.device("cpu"))
        with pytest.raises(ValueError, match="the process group runs gloo"):
            P.init_data_parallel("nccl", "cpu")
        assert P.is_initialized()
    finally:
        dist.destroy_process_group()


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    for k, v in {"RANK": "1", "LOCAL_RANK": "1", "WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one card"):
        P.init_data_parallel("nccl", None)
    assert P._rank_device(None, 1) == torch.device("cuda", 0)  # gloo shares the card


def test_local_batch_size():
    assert P.local_batch_size(32, 2) == 16
    with pytest.raises(ValueError, match="not divisible"):
        P.local_batch_size(10, 4)


@pytest.mark.parametrize("knob", ["model_shards", "fusion_pipeline_stages", "sequence_parallel", "fsdp",
                                  "zero_optimizer", "scst_finetuning", "model_shards_moe"])
def test_other_axes_are_refused_across_processes(knob):
    """Every mesh knob runs across processes now: ZeRO-1, SCST, ``fsdp``,
    ``model_shards`` (with MoE experts too: expert parallelism),
    ``sequence_parallel`` and ``fusion_pipeline_stages``; what is refused is
    a grid that does not fit the ranks: pipeline stages times the model
    shards not dividing them (``ValueError``).  One process reads and ignores
    them all."""
    from valor_tpu_torch.core.config import load_config

    overrides = {"model_shards": {"model_shards": 2}, "fusion_pipeline_stages": {"fusion_pipeline_stages": 2},
                 "model_shards_moe": {"model_shards": 2, "fusion_moe_experts": 4}}.get(knob, {knob: True})
    cfg = load_config(None, overrides)
    P.check_data_parallel(cfg, 1)  # read and ignored by one process
    P.check_data_parallel(cfg, 2)
    if knob != "fusion_pipeline_stages":
        return
    P.check_data_parallel(load_config(None, dict(overrides, model_shards=2)), 4)
    with pytest.raises(ValueError, match="fusion_pipeline_stages 2 x model_shards 1 does not divide the 3 ranks"):
        P.check_data_parallel(cfg, 3)
    with pytest.raises(ValueError, match="fusion_pipeline_stages 2 x model_shards 2 does not divide the 6 ranks"):
        P.check_data_parallel(load_config(None, dict(overrides, model_shards=2)), 6)


def test_moe_with_pipeline_stages_is_refused():
    """MoE fusion layers and pipeline stages together raise the JAX
    package's message when the model is built, in one process too."""
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.valor import VALORModel

    cfg = load_config(None, {"fusion_pipeline_stages": 2, "fusion_moe_experts": 4, "fusion_hidden": 32,
                             "fusion_layers": 2, "fusion_heads": 2, "fusion_intermediate": 64})
    with pytest.raises(ValueError, match="pipeline_stages and moe_experts are mutually exclusive"):
        VALORModel(cfg.model, device="meta")


def test_model_shards_must_divide_the_ranks():
    from valor_tpu_torch.core.config import load_config

    with pytest.raises(ValueError, match="model_shards 3 does not divide the 2 ranks"):
        P.check_data_parallel(load_config(None, {"model_shards": 3}), 2)
    P.check_data_parallel(load_config(None, {"model_shards": 2}), 4)


@pytest.mark.parametrize("rows,k", [(8, 1), (6, 3), (5, 2)])
def test_draws_of_every_rank_are_one_process_draws(rows, k):
    """Each rank's draw is its strided rows of the draw at the global shape,
    k rows a batch row (``[B * frames, ...]``), ragged included."""
    def draw(shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(3))

    full = draw((rows * k, 4)).reshape(rows, k, 4)
    for r in range(WORLD):
        shard = P.BatchShard(rows, slice(r, rows, WORLD))
        with P.batch_shard(shard):
            got = P.draw_rows(draw, (shard.local * k, 4))
        assert torch.equal(got, full[r::WORLD].reshape(-1, 4))
    assert torch.equal(P.draw_rows(draw, (rows * k, 4)), full.reshape(-1, 4))  # no shard: as drawn
    shard = P.BatchShard(rows, slice(0, rows, WORLD))
    with P.batch_shard(shard), pytest.raises(ValueError, match="a draw of"):
        P.draw_rows(draw, (shard.local * k + 1, 4))


@pytest.mark.parametrize("n_items,batch", [(9, 2), (5, 3), (1, 2)])
def test_evaluation_shards_are_one_process_batches(n_items, batch):
    """Batch k of every rank's evaluation sampler holds, at its strided rows,
    the items of one process's batch k (at ``batch * WORLD``)."""
    from valor_tpu_torch.data.loader import ShardedBatchSampler

    one = list(ShardedBatchSampler(n_items, batch * WORLD, shuffle=False))
    samplers = [ShardedBatchSampler(n_items, batch, r, WORLD, shuffle=False) for r in range(WORLD)]
    shards = [list(s) for s in samplers]
    assert sorted(i for s in shards for b in s for i in b) == list(range(n_items))
    for k, items in enumerate(one):
        for r, s in enumerate(samplers):
            shard = P.sampler_shard(s, k)
            assert shard.rows == len(items)
            got = shards[r][k] if k < len(shards[r]) else []
            assert got == items[shard.index] and shard.local == len(got)
    assert P.sampler_shard(ShardedBatchSampler(n_items, batch, shuffle=False), 0) is None


def test_answer_rows_concatenate_in_rank_order(monkeypatch):
    monkeypatch.setattr(P, "rank", lambda: 1)
    shard = P.answer_shard(5, [8, 5, 3])
    assert (shard.rows, shard.index, shard.local, shard.collective) == (16, slice(8, 13), 5, True)


def _environment():
    return {k: os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR")}


def test_run_local_passes_the_launchers_environment():
    out = run_local(_environment, WORLD, timeout=LIMIT)
    assert [(o["RANK"], o["LOCAL_RANK"], o["WORLD_SIZE"]) for o in out] == [("0", "0", "2"), ("1", "1", "2")]
