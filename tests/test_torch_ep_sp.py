"""Expert and sequence parallelism of the port in one process: the rules that
decide where they engage, the dropout draw of a sequence chunk, their no-op
in one process, and an expert range that sums with its complement to the
whole MoE output.  The collectives themselves run in the four-rank launch of
``tests/test_torch_fsdp_tp.py`` (the ``ep_2x2``, ``sp_2x2`` and
``ep_sp_fsdp_2x2`` flows).

The model axis is faked by patching ``parallel/mesh.py:model_world`` and
``model_rank``: the rules read nothing else.
"""

import numpy as np
import pytest
import torch

from valor_tpu_torch.ops import moe as tmoe
from valor_tpu_torch.ops.layers import RNGStreams, dropout, rng_scope
from valor_tpu_torch.parallel import activations as A
from valor_tpu_torch.parallel import mesh as P


@pytest.fixture
def model_axis(monkeypatch):
    """``set(m, r)``: a model axis of m ranks, this process rank r."""
    def set_axis(m, r=0):
        monkeypatch.setattr(P, "model_world", lambda: m)
        monkeypatch.setattr(P, "model_rank", lambda: r)

    yield set_axis
    A.set_sequence_sharding(False)
    tmoe.set_expert_sharding(False)


# S: training sequences (text 40, text + prompt, full-masker doubling), decode
# buffers (one token, the greedy buffer, beams folded into the batch), odd ones
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 6, 7, 8, 12, 30, 31, 40, 44, 80, 81])
def test_sequence_splits_where_the_model_axis_divides_it(model_axis, m, s):
    model_axis(m)
    A.set_sequence_sharding(True)
    assert A.sequence_sharded(torch.zeros(4, s, 16)) == (s % m == 0)
    assert A.sequence_sharding_applied() == (s % m == 0)
    assert not A.sequence_sharded(torch.zeros(4, s))  # not a [B, S, D] stream
    A.set_sequence_sharding(False)
    assert not A.sequence_sharded(torch.zeros(4, s, 16))
    assert A.sequence_sharding_applied() == 0


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("e", [1, 2, 3, 4, 6, 8])
def test_experts_split_where_the_model_axis_divides_them(model_axis, m, e):
    tmoe.set_expert_sharding(True)
    ranges = []
    for r in range(m):
        model_axis(m, r)
        ranges.append(tmoe.expert_split(e))
    if m == 1 or e % m:
        assert ranges == [None] * m
    else:
        assert ranges == [(r * e // m, e // m) for r in range(m)]
    tmoe.set_expert_sharding(False)
    assert tmoe.expert_split(e) is None


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("rows", [None, (6, 2)])
def test_dropout_of_a_chunk_is_the_chunk_of_the_whole_draw(model_axis, m, rows):
    """A rank's chunk of the sequence (and, in a batch shard, its rows) keeps
    and scales exactly the elements that one process's draw does."""
    x = torch.randn(3, 8, 5)
    whole_x = x
    shard = None
    if rows is not None:  # this rank holds rows 1, 3, 5 of a global batch of 6
        total, world = rows
        whole_x = torch.randn(total, 8, 5)
        whole_x[1::world] = x
        shard = P.BatchShard(total, slice(1, total, world), collective=True)
    model_axis(1)
    with rng_scope(RNGStreams(9)):
        want = dropout(whole_x, 0.3, True)
    if shard is not None:
        want = want[shard.index]
    for r in range(m):
        model_axis(m, r)
        chunk = slice(r * 8 // m, (r + 1) * 8 // m)
        with rng_scope(RNGStreams(9)), P.batch_shard(shard):
            got = dropout(x[:, chunk], 0.3, True, sequence=True)
        torch.testing.assert_close(got, want[:, chunk], rtol=0, atol=0)


def _moe_valor():
    from tests.test_torch_fsdp_tp import _cfg
    from valor_tpu_torch.models.bridge import init_params, train_model

    cfg = _cfg(dropout=0.1, caption_type="unimlm", fusion_moe_experts=4, fusion_moe_every=2,
               sequence_parallel=True)
    return train_model(cfg, init_params(cfg, 0, "cpu"), "cpu")


def test_one_process_is_a_no_op():
    """With both switches on, one process computes what it computes with both
    off, bit for bit, and neither count moves."""
    from tests.test_torch_ddp import PT_TASK, _batch
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.train.step import losses_and_grads

    batch = {k: torch.from_numpy(v) for k, v in _batch(60).items()}
    runs = []
    for on in (False, True):
        model = _moe_valor()
        A.set_sequence_sharding(on)
        tmoe.set_expert_sharding(on)
        try:
            metrics, grads = losses_and_grads(model, batch, parse_task(PT_TASK), 7, reduce_grads=lambda g: g,
                                              moe_aux_weight=0.01)
            runs.append((metrics, grads, A.sequence_sharding_applied(), tmoe.expert_sharding_applied()))
        finally:
            A.set_sequence_sharding(False)
            tmoe.set_expert_sharding(False)
    (m0, g0, *_), (m1, g1, sp, ep) = runs
    assert (sp, ep) == (0, 0)
    assert "moe_aux" in m1 and m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("top_k,capacity_factor", [(2, 1.25), (1, 1e-6)])
def test_an_expert_range_and_its_complement_sum_to_the_whole(monkeypatch, top_k, capacity_factor):
    """Two ranks' expert ranges, each with the model axis's sums left out
    (``copy_to_model`` and ``reduce_from_model`` as identities), add up to
    the whole block's output, drops included; the aux is every rank's."""
    g, s, m, h, e = 2, 8, 16, 32, 4
    block = tmoe.MoEMlpBlock(m, e, h, top_k, capacity_factor, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    x = torch.randn(g, s, m, generator=gen)
    with torch.no_grad():
        whole, aux = block(x)
        monkeypatch.setattr(tmoe, "copy_to_model", lambda t: t)
        monkeypatch.setattr(tmoe, "reduce_from_model", lambda t: t)
        parts = []
        for first in (0, 2):
            monkeypatch.setattr(tmoe, "expert_split", lambda n, first=first: (first, 2))
            parts.append(block(x))
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole, rtol=1e-6, atol=1e-6)
    for _, a in parts:
        assert torch.equal(a, aux)
    assert all(float(y.abs().max()) > 0 for y, _ in parts)
    assert not np.allclose(parts[0][0].numpy(), whole.numpy(), atol=1e-3)
