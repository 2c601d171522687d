"""Pipeline parallelism of the fusion stack (``valor_tpu_torch/parallel/pipeline.py``)
in one process, against the JAX package's ``valor_tpu/parallel/pipeline.py``.

  * ``pipeline_microbatches`` and the stage assignment (``stage_layers``, JAX's
    ``_reshape_stages``) equal JAX's functions;
  * the schedule: at every tick each stage runs the (microbatch, chunk) of
    JAX's closed form (``tick`` for GPipe, ``tick_interleaved``), every
    microbatch passes all S V blocks once and in order, each hop's send meets
    its receive, and there are M V + S - 1 ticks; a bad M with V > 1 raises;
  * the refusals (MoE with stages, layers that do not divide into S x V
    blocks) raise JAX's messages, and the interleave fallback picks the
    (M, V) that JAX's encoder hands its ``pipeline_layers``;
  * the arithmetic through the loopback transport (one process runs every
    stage): a toy stack with side inputs and dropout, forward and gradients,
    against the plain stack at 1e-5; the tiny ``BertFusionEncoder`` with
    cross-attention against JAX's pipelined encoder on a (data 2, pipe 4) mesh
    of the JAX package's CPU devices at 1e-5, and its gradients against the
    port's plain stack; outside a training step, and in one process without
    the loopback, the stack runs whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import valor_tpu.parallel.pipeline as JP
from valor_tpu_torch.ops.layers import RNGStreams, dropout, rng_scope
from valor_tpu_torch.parallel import pipeline as PL
from valor_tpu_torch.parallel.mesh import BatchShard, batch_shard

TOL = 1e-5
TINY = dict(vocab_size=128, hidden_size=16, num_layers=4, num_heads=2, intermediate=32, dropout=0.0)


@pytest.fixture(autouse=True)
def _clear():
    PL.set_pipeline(0)
    yield
    PL.set_pipeline(0)


def _step_shard(n):
    """A one-process training step's shard (the pipeline engages in a
    training step's forward only)."""
    return batch_shard(BatchShard(n, slice(0, n, 1), collective=True))


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_pipeline_microbatches_equal_jax(stages):
    for n_data in (1, 2):
        for batch in range(1, 17):
            assert PL.pipeline_microbatches(batch, stages, n_data) == \
                JP.pipeline_microbatches(batch, stages, n_data), (batch, n_data)
    PL.set_pipeline(stages, 3)
    JP.set_pipeline(None, 3)
    try:
        assert PL.pipeline_microbatches(16, stages, 2) == JP.pipeline_microbatches(16, stages, 2) == 3
    finally:
        JP.set_pipeline(None)


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_stage_assignment_equals_jax(stages):
    for interleave in (1, 2, 4):
        for per in (1, 2):
            n = stages * interleave * per
            want = np.asarray(JP._reshape_stages(jnp.arange(n), stages, interleave))
            want = want.reshape(stages, interleave, per)
            assert PL.stage_layers(n, stages, interleave) == want.tolist(), (n, interleave)
        with pytest.raises(ValueError) as jax_err:
            JP._reshape_stages(jnp.arange(stages * interleave + 1), stages, interleave)
        with pytest.raises(ValueError) as port_err:
            PL.stage_layers(stages * interleave + 1, stages, interleave)
        assert str(port_err.value) == str(jax_err.value)


def _jax_closed_form(t, idx, m, n_stages, interleave):
    """What JAX's scan body computes for device ``idx`` at tick ``t``
    (``valor_tpu/parallel/pipeline.py:332-393``): (microbatch, chunk,
    ingests, records) where the payload is a real microbatch, else None."""
    if interleave > 1:  # tick_interleaved
        sv = n_stages * interleave
        r = (t - idx) % n_stages
        tr = t - r
        g = tr // sv
        b = tr - g * sv
        mb_i = g * n_stages + r
        if not (g >= 0 and mb_i < m):
            return None
        return mb_i, min(max(b // n_stages, 0), interleave - 1), b == 0, b == sv - 1
    # tick: stage 0 ingests microbatch t; stage idx holds t - idx; the last records t - (S - 1)
    mb_i = t - idx
    if not 0 <= mb_i < m:
        return None
    return mb_i, 0, idx == 0, idx == n_stages - 1


CASES = [(s, m, v) for s in (2, 4) for m in (1, 2, 4, 8) for v in (1, 2)]


@pytest.mark.parametrize("stages,microbatches,interleave", CASES)
def test_schedule_equals_jax_closed_form(stages, microbatches, interleave):
    if interleave > 1 and microbatches % stages:
        with pytest.raises(ValueError, match=r"interleaved schedule needs M % S == 0"):
            PL.schedule(microbatches, stages, interleave)
        return
    table = PL.schedule(microbatches, stages, interleave)
    assert len(table) == microbatches * interleave + stages - 1
    sv = stages * interleave
    seen = {m: [] for m in range(microbatches)}
    for t, row in enumerate(table):
        for d, w in enumerate(row):
            want = _jax_closed_form(t, d, microbatches, stages, interleave)
            if w is None:
                assert want is None, (t, d)
                continue
            m, b = w
            assert want == (m, b // stages, b == 0, b == sv - 1), (t, d)
            assert b % stages == d
            seen[m].append((t, b))
            # the hop after this block meets the receive of the block after it
            if b < sv - 1:
                assert table[t + 1][(d + 1) % stages] == (m, b + 1)
    for m, visits in seen.items():
        assert [b for _, b in visits] == list(range(sv)), m
        assert [t for t, _ in visits] == list(range(visits[0][0], visits[0][0] + sv)), m


def _jax_bert(**kw):
    from valor_tpu.models.bert import BertConfig as JaxBertConfig, BertFusionEncoder as JaxEncoder

    return JaxEncoder(JaxBertConfig(**dict(TINY, **kw)))


def _torch_bert(**kw):
    from valor_tpu_torch.models.bert import BertConfig, BertFusionEncoder

    return BertFusionEncoder(BertConfig(**dict(TINY, **kw)))


def _tokens(b=8, n=6):
    t = np.random.RandomState(0).randint(5, 100, size=(b, n)).astype(np.int32)
    t[:, 0] = 101
    return t


@pytest.mark.parametrize("kw", [dict(pipeline_stages=4, moe_experts=2), dict(pipeline_stages=3),
                                dict(pipeline_stages=2, pipeline_interleave=3)])
def test_refusals_raise_jax_messages(kw):
    with pytest.raises(ValueError) as jax_err:
        _jax_bert(**kw).init(jax.random.PRNGKey(0), jnp.asarray(_tokens()))
    with pytest.raises(ValueError) as port_err:
        _torch_bert(**kw)
    assert str(port_err.value) == str(jax_err.value)


FALLBACK = [  # (data, pipe, batch, interleave)
    (2, 2, 8, 2), (2, 2, 6, 2), (1, 2, 6, 2), (1, 4, 12, 2), (2, 2, 4, 2), (2, 4, 16, 2), (1, 2, 8, 1),
]


@pytest.fixture(scope="module")
def jax_tiny():
    enc = _jax_bert(num_layers=8)
    return enc, enc.init(jax.random.PRNGKey(0), jnp.asarray(_tokens()))["params"]


@pytest.mark.parametrize("n_data,n_pipe,batch,interleave", FALLBACK)
def test_interleave_fallback_picks_what_jax_picks(jax_tiny, monkeypatch, n_data, n_pipe, batch, interleave):
    """The (M, V) that JAX's ``_maybe_pipeline`` hands ``pipeline_layers``,
    against the port's choice for the same global batch and data axis."""
    from valor_tpu.models.bert import BertConfig as JaxBertConfig, BertFusionEncoder as JaxEncoder
    from valor_tpu.parallel.mesh import make_mesh

    _, params = jax_tiny
    enc = JaxEncoder(JaxBertConfig(**dict(TINY, num_layers=8, pipeline_stages=n_pipe,
                                          pipeline_interleave=interleave)))
    picked = []

    def record(apply_layer, stacked, x, mesh, m, shard_batch_over_data=False, extras=None, rng=None,
               interleave=1):
        picked.append((m, interleave))
        return x

    monkeypatch.setattr(JP, "pipeline_layers", record)
    JP.set_pipeline(make_mesh(n_data=n_data, n_model=1, n_pipe=n_pipe))
    try:
        enc.apply({"params": params}, jnp.asarray(_tokens(b=batch)))
    finally:
        JP.set_pipeline(None)
    assert picked == [PL._microbatching(batch, n_pipe, n_data, interleave)]


class ToyLayer(nn.Module):
    """A layer of the fusion layer's signature: a residual tanh MLP that reads
    the batched bias term and the cross memory, with dropout."""

    def __init__(self, width, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = nn.Parameter(torch.randn(width, width, generator=g) * 0.3)
        self.c = nn.Parameter(torch.randn(width, generator=g) * 0.3)

    def forward(self, x, bias, v, a, kv=None, extra=None, sequence=False):
        h = torch.tanh(x @ self.w + bias[0].mean(-1) * self.c + v.mean(1, keepdim=True))
        return x + dropout(h, 0.2, self.training)


@pytest.mark.parametrize("stages,interleave,remat", [(2, 1, False), (4, 1, True), (2, 2, False), (2, 2, True)])
def test_toy_stack_pipelined_equals_plain(stages, interleave, remat):
    from valor_tpu_torch.ops.layers import run_layer

    n_layers, b, width = 8, 8, 6
    layers = nn.ModuleList([ToyLayer(width, i) for i in range(n_layers)]).train()
    rs = np.random.RandomState(3)
    x0 = torch.from_numpy(rs.randn(b, 5, width).astype(np.float32))
    v0 = torch.from_numpy(rs.randn(b, 3, width).astype(np.float32))
    bias = (torch.from_numpy(rs.randn(b, 1, 1, 5).astype(np.float32)), torch.zeros(1, 1, 5, 5))

    def run(pipelined):
        x, v = x0.clone().requires_grad_(), v0.clone().requires_grad_()
        PL.set_pipeline(stages if pipelined else 0, loopback=True)
        with rng_scope(RNGStreams(11)), _step_shard(b):
            out = PL.pipeline_layers(layers, remat, x, bias, v, None, stages, interleave) if pipelined else None
            if out is None:
                out = x
                for layer in layers:
                    out = run_layer(layer, remat, out, bias, v, None, None, None, False)
        grads = torch.autograd.grad((out * torch.linspace(-1, 1, width)).sum(), [x, v, *layers.parameters()])
        return out.detach(), grads, PL.pipeline_applied()

    plain, g_plain, n_plain = run(False)
    piped, g_piped, n_piped = run(True)
    assert (n_plain, n_piped) == (0, 1)
    np.testing.assert_allclose(piped.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    for got, want in zip(g_piped, g_plain):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def encoders():
    """The tiny cross-attention encoder in both packages from JAX's weights,
    and JAX's pipelined output on a (data 2, pipe 4) mesh."""
    from tests.test_torch_models import _load
    from valor_tpu.parallel.mesh import make_mesh

    kw = dict(has_cross_attn=True, cross_attn_type="va_concate", pipeline_stages=4)
    jenc = _jax_bert(**kw)
    toks = jnp.asarray(_tokens())
    rs = np.random.RandomState(1)
    video = rs.randn(8, 5, 16).astype(np.float32)
    audio = rs.randn(8, 3, 16).astype(np.float32)
    params = jenc.init(jax.random.PRNGKey(0), toks, None, video, audio)["params"]
    JP.set_pipeline(make_mesh(n_data=2, n_model=1, n_pipe=4))
    try:
        before = JP.pipeline_applied()
        ref = jax.jit(lambda p: jenc.apply({"params": p}, toks, None, video, audio, causal=True))(params)
        assert JP.pipeline_applied() > before
    finally:
        JP.set_pipeline(None)
    tenc = _load(_torch_bert(**kw), params)
    return {"torch": tenc, "jax_out": np.asarray(ref), "tokens": _tokens(), "video": video, "audio": audio}


def _encode(e, pipelined, train_step=True):
    t = torch.from_numpy
    video, audio = t(e["video"]).requires_grad_(), t(e["audio"]).requires_grad_()
    PL.set_pipeline(4 if pipelined else 0, loopback=True)
    with rng_scope(RNGStreams(0)), batch_shard(BatchShard(8, slice(0, 8, 1), collective=train_step)):
        out = e["torch"](t(e["tokens"]), None, video, audio, causal=True)
    return out, video, audio


def test_encoder_pipelined_equals_jax(encoders):
    out, _, _ = _encode(encoders, True)
    assert PL.pipeline_applied() == 1
    np.testing.assert_allclose(out.detach().numpy(), encoders["jax_out"], rtol=TOL, atol=TOL)


def test_encoder_pipelined_gradients_equal_plain(encoders):
    enc = encoders["torch"]
    got = {}
    for pipelined in (False, True):
        out, video, audio = _encode(encoders, pipelined)
        weights = torch.linspace(-1, 1, out.shape[-1])
        got[pipelined] = torch.autograd.grad((out * weights).sum(), [video, audio, *enc.parameters()],
                                             allow_unused=True)
        assert PL.pipeline_applied() == int(pipelined)
    for a, b in zip(got[True], got[False]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_encoder_runs_whole_outside_a_training_step(encoders):
    """Evaluation (a shard that is not collective), the cross-K/V decode and
    one process without the loopback run the plain stack, with JAX's output."""
    t = torch.from_numpy
    out, _, _ = _encode(encoders, True, train_step=False)
    assert PL.pipeline_applied() == 0
    np.testing.assert_allclose(out.detach().numpy(), encoders["jax_out"], rtol=TOL, atol=TOL)
    enc = encoders["torch"]
    with torch.no_grad(), _step_shard(8):
        kv = enc.precompute_cross_kv(t(encoders["video"]), t(encoders["audio"]))
        enc(t(encoders["tokens"]), None, None, None, True, False, None, kv)
        assert PL.pipeline_applied() == 0
        PL.set_pipeline(4)  # installed, but one process has no pipe axis
        assert PL.get_pipeline() == 0
        enc(t(encoders["tokens"]), None, t(encoders["video"]), t(encoders["audio"]), causal=True)
    assert PL.pipeline_applied() == 0
