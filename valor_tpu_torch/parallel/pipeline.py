"""Pipeline parallelism of the fusion stack over the ``pipe`` axis (counterpart
of ``valor_tpu/parallel/pipeline.py``).

The JAX package splits the fusion encoder's layer stack into S stages over a
``pipe`` mesh axis and runs M microbatches through them in one
``shard_map`` + ``ppermute`` + ``scan`` program, whose backward ``jax.grad``
derives.  The port runs one process a pipe rank and writes both directions:

  * stage assignment (``stage_layers``, the JAX ``_reshape_stages``):
    contiguous blocks of L / S layers, or with V > 1 virtual stages a device
    the stride-S blocks {v S + d} on device d (chunk v of device d is global
    block v S + d);
  * the schedule (``schedule``, the JAX closed form): microbatch m = g S + r
    enters stage 0 at tick g S V + r, moves one hop a tick, and device d
    applies chunk b // S at block b.  V = 1 is GPipe (M + S - 1 ticks); V > 1
    takes M V + S - 1 ticks and needs M % S == 0.  A payload that leaves the
    last device before its last block wraps to device 0 (the JAX ring's wrap;
    with V = 1 nothing wraps);
  * ``_Pipeline``, a ``torch.autograd.Function``: its forward runs the ticks,
    keeping each (microbatch, block)'s graph; its backward runs them in
    reverse, the output gradients entering at the last block and each input
    gradient moving one hop upstream a tick.  The stage's parameters are its
    inputs, and their gradients its input gradients, so the training step
    keeps ``torch.autograd.grad``; with ``checkpointing`` each layer runs
    under ``torch.utils.checkpoint`` (``ops/layers.py:run_layer_in``), as the
    JAX package wraps its ``apply_layer`` in ``jax.checkpoint``;
  * side inputs: the batched bias terms and the cross-attention memories are
    microbatched like the activation, each block reading its microbatch's
    rows; bias terms not of batch shape are closed over;
  * dropout: every rank forks each layer's streams once, in layer order, as
    one process's sequential forward does, and a layer's run on a microbatch
    draws the global batch's mask with those streams and keeps the
    microbatch's rows (``parallel/mesh.py:draw_rows``), so the pipelined step
    draws what one process draws.

Each data rank (and model rank) runs its own pipeline over its pipe ranks.
Where the pipe folds into the batch each pipe rank holds its rows, gathered at
the block's entry (``collectives.pipe_all_gather``) and handed back from the
last stage (``collectives.pipe_hand_back``); otherwise the pipe ranks hold the
same rows and the hand-back sums their output gradients.  Stage traffic goes
through ``collectives.exchange``.  Every rank holds every layer (the JAX
package's stored tree is replicated over pipe too) and runs only its stage's,
so pipelining saves no parameter memory.

``set_pipeline`` installs the switch (``cli/build.py`` from the config's
``fusion_pipeline_stages``), ``pipeline_applied`` counts the stack forwards
that ran pipelined and ``models/bert.py:BertFusionEncoder`` routes its stack
through ``pipeline_layers``.  With ``loopback`` one process runs every stage
itself, its stage traffic handed over in memory (the tests' transport).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from valor_tpu_torch.ops.layers import layer_seed, run_layer_in
from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.mesh import BATCH_AXIS, PIPE_AXIS, BatchShard, collective_step, current_shard

# [stages installed (0: none), microbatches (0: auto), stack forwards pipelined, loopback]
_STATE: list = [0, 0, 0, False]
# this rank's schedule seconds and the compute inside them, summed over the pipelined calls (``set_timing``)
TIMING: Dict[str, float] = {}
_TIMED: list = [False]


def set_pipeline(stages: int, num_microbatches: int = 0, loopback: bool = False) -> None:
    """Install (or clear, with 0) pipeline parallelism over ``stages`` pipe
    ranks; ``num_microbatches`` 0 is the JAX rule (``pipeline_microbatches``).
    ``loopback``: one process runs every stage.  The count starts again at 0."""
    _STATE[:] = [int(stages), int(num_microbatches), 0, bool(loopback)]


def get_pipeline() -> int:
    """The stages the installed pipeline runs over: the pipe axis's ranks (the
    installed stages with ``loopback``) where above 1, else 0."""
    if _STATE[0] <= 1:
        return 0
    n = _STATE[0] if _STATE[3] else P.pipe_world()
    return n if n > 1 else 0


def pipeline_applied() -> int:
    """The fusion stack forwards that ran pipelined since ``set_pipeline``."""
    return _STATE[2]


def set_timing(on: bool) -> None:
    """Time every block's compute, synchronising the card before and after
    it, into ``TIMING`` (emptied here): ``forward_s``/``backward_s`` the
    schedules' seconds, ``*_busy_s`` the blocks' inside them; this rank's
    bubble is the share of the schedules that is not its blocks."""
    _TIMED[0] = bool(on)
    TIMING.clear()


def bubble() -> Optional[float]:
    """1 - the blocks' share of the schedules' seconds since ``set_timing``."""
    wall = TIMING.get("forward_s", 0.0) + TIMING.get("backward_s", 0.0)
    busy = TIMING.get("forward_busy_s", 0.0) + TIMING.get("backward_busy_s", 0.0)
    return 1.0 - busy / wall if _TIMED[0] and wall > 0 else None


def pipeline_microbatches(batch: int, n_stages: int, n_data: int = 1) -> int:
    """The configured M, or the largest M <= 2 S with ``batch % M == 0`` and
    the microbatch still divisible by the data axis (the JAX rule)."""
    if _STATE[1]:
        return _STATE[1]
    m = 1
    for cand in range(1, min(batch, 2 * n_stages) + 1):
        if batch % cand == 0 and (batch // cand) % n_data == 0:
            m = cand
    return m


def stage_layers(n_layers: int, n_stages: int, interleave: int = 1) -> List[List[List[int]]]:
    """``[d][v]``: the layers of chunk v of device d (``_reshape_stages``):
    contiguous blocks of L / (S V) layers, device d holding blocks
    {v S + d}."""
    blocks = n_stages * interleave
    if n_layers % blocks:
        raise ValueError(
            f"{n_layers} layers do not divide into {n_stages} stages"
            + (f" x {interleave} chunks" if interleave > 1 else "")
        )
    lc = n_layers // blocks
    return [[list(range((v * n_stages + d) * lc, (v * n_stages + d + 1) * lc)) for v in range(interleave)]
            for d in range(n_stages)]


def check_schedule(num_microbatches: int, n_stages: int, interleave: int = 1) -> None:
    if interleave > 1 and num_microbatches % n_stages:
        raise ValueError(
            f"interleaved schedule needs M % S == 0, got M={num_microbatches} "
            f"S={n_stages} (microbatch groups of S circulate the ring)"
        )


def work(t: int, d: int, num_microbatches: int, n_stages: int, interleave: int = 1) -> Optional[Tuple[int, int]]:
    """(microbatch, global block) that device ``d`` runs at tick ``t``, or None
    (the JAX package's closed form, ``tick_interleaved``; V = 1 is GPipe)."""
    sv = n_stages * interleave
    r = (t - d) % n_stages
    tr = t - r
    g = tr // sv
    b = tr - g * sv
    m = g * n_stages + r
    return (m, b) if g >= 0 and m < num_microbatches else None


def n_ticks(num_microbatches: int, n_stages: int, interleave: int = 1) -> int:
    return num_microbatches * interleave + n_stages - 1


def schedule(num_microbatches: int, n_stages: int, interleave: int = 1) -> List[List[Optional[Tuple[int, int]]]]:
    """``[t][d]``: what each device runs at each tick (``work``)."""
    check_schedule(num_microbatches, n_stages, interleave)
    return [[work(t, d, num_microbatches, n_stages, interleave) for d in range(n_stages)]
            for t in range(n_ticks(num_microbatches, n_stages, interleave))]


class _Run:
    """One pipelined call: the stages this process runs, the schedule, the
    microbatches and every (microbatch, block)'s graph between the forward and
    the backward."""

    def __init__(self, layers: Sequence[nn.Module], remat: bool, seeds, n_stages: int, interleave: int,
                 num_microbatches: int, local_stages: Sequence[int], rows: Sequence[int], total_rows: int,
                 static_bias: tuple, n_bias: int, has_v: bool, has_a: bool, exchange: Callable):
        self.layers, self.remat, self.seeds = list(layers), remat, list(seeds)
        self.S, self.V, self.M = n_stages, interleave, num_microbatches
        self.local = list(local_stages)
        self.blocks = stage_layers(len(self.layers), n_stages, interleave)
        self.rows, self.total_rows = list(rows), total_rows
        self.static_bias, self.n_bias, self.has_v, self.has_a = static_bias, n_bias, has_v, has_a
        self.exchange = exchange
        self.saved: Dict[Tuple[int, int, int], tuple] = {}

    def block_params(self, d: int, chunk: int) -> List[torch.Tensor]:
        """The parameters of chunk ``chunk`` of device ``d`` (``fsdp``'s blocks as held)."""
        return [p for i in self.blocks[d][chunk] for p in self.layers[i].parameters()]

    def params(self) -> List[torch.Tensor]:
        """The parameters of the local stages' layers."""
        return [p for d in self.local for chunk in range(self.V) for p in self.block_params(d, chunk)]

    def _shard(self, m: int, mb: int) -> BatchShard:
        return BatchShard(self.total_rows, tuple(self.rows[m * mb : (m + 1) * mb]), collective=True)

    def _block(self, d: int, chunk: int, h, ex, m: int, mb: int):
        terms = tuple(ex[: self.n_bias]) + self.static_bias
        v = ex[self.n_bias] if self.has_v else None
        a = ex[self.n_bias + int(self.has_v)] if self.has_a else None
        shard = self._shard(m, mb)
        for i in self.blocks[d][chunk]:
            h = run_layer_in(self.layers[i], self.remat, self.seeds[i], shard, h, terms or None, v, a, None, None,
                             False)
        return h

    def forward(self, x: torch.Tensor, extras: Sequence[torch.Tensor], record: bool) -> torch.Tensor:
        S, V, M = self.S, self.V, self.M
        sv, mb = S * V, x.shape[0] // M
        xs = x.chunk(M)
        exs = [e.chunk(M) for e in extras]
        outputs: Dict[int, torch.Tensor] = {}
        inbox: Dict[Tuple[int, int], torch.Tensor] = {}
        for t in range(n_ticks(M, S, V)):
            sends = {}
            for d in self.local:
                w = work(t, d, M, S, V)
                if w is None:
                    continue
                m, b = w
                h = xs[m] if b == 0 else inbox.pop(((d - 1) % S, d))
                h_in = h.detach().requires_grad_(record and (b > 0 or x.requires_grad))
                ex = [e[m].detach().requires_grad_(record and e[m].requires_grad) for e in exs]
                t0 = _clock(h_in)
                with torch.set_grad_enabled(record):
                    out = self._block(d, b // S, h_in, ex, m, mb)
                _busy("forward", out, t0)
                if record:
                    self.saved[(d, m, b)] = (h_in, ex, out)
                if b == sv - 1:
                    outputs[m] = out.detach()
                else:
                    sends[(d, (d + 1) % S)] = out.detach()
            wants = {}
            for d in self.local:
                w = work(t + 1, d, M, S, V)
                if w is not None and w[1] > 0:
                    wants[((d - 1) % S, d)] = (tuple(xs[0].shape), x.dtype)
            inbox = self.exchange(sends, wants, x.device)
        if (S - 1) not in self.local:
            return torch.zeros_like(x)
        return torch.cat([outputs[m] for m in range(M)])

    def backward(self, grad: torch.Tensor, x_needs: bool, ex_needs: Sequence[bool]):
        S, V, M = self.S, self.V, self.M
        sv = S * V
        gs = grad.chunk(M)
        shape = tuple(gs[0].shape)
        mb = shape[0]
        params = self.params()
        pgrads: Dict[int, torch.Tensor] = {}
        x_grad = grad.new_zeros(grad.shape) if x_needs else None
        ex_grads: List[Optional[torch.Tensor]] = [None] * len(ex_needs)
        inbox: Dict[Tuple[int, int], torch.Tensor] = {}
        for t in reversed(range(n_ticks(M, S, V))):
            sends = {}
            for d in self.local:
                w = work(t, d, M, S, V)
                if w is None:
                    continue
                m, b = w
                g = gs[m] if b == sv - 1 else inbox.pop(((d + 1) % S, d))
                h_in, ex, out = self.saved.pop((d, m, b))
                block = [p for p in self.block_params(d, b // S) if p.requires_grad]
                ex_in = [e for e in ex if e.requires_grad]
                inputs = ([h_in] if h_in.requires_grad else []) + ex_in + block
                t0 = _clock(g)
                got = list(torch.autograd.grad(out, inputs, g, allow_unused=True))
                _busy("backward", g, t0)
                g_in = got.pop(0) if h_in.requires_grad else None
                for j, e in enumerate(ex):
                    if e.requires_grad:
                        ge = got.pop(0)
                        if ge is not None:
                            if ex_grads[j] is None:
                                ex_grads[j] = ge.new_zeros((M * mb,) + tuple(ge.shape[1:]))
                            ex_grads[j][m * mb : (m + 1) * mb] += ge
                for p, gp in zip(block, got):
                    if gp is not None:
                        pgrads[id(p)] = gp if id(p) not in pgrads else pgrads[id(p)] + gp
                if b == 0:
                    if x_grad is not None and g_in is not None:
                        x_grad[m * mb : (m + 1) * mb] = g_in
                else:
                    sends[(d, (d - 1) % S)] = g_in
            wants = {}
            for d in self.local:
                w = work(t - 1, d, M, S, V)
                if w is not None and w[1] < sv - 1:
                    wants[((d + 1) % S, d)] = (shape, grad.dtype)
            inbox = self.exchange(sends, wants, grad.device)
        return x_grad, ex_grads, [pgrads.get(id(p)) for p in params]


def _clock(t: torch.Tensor) -> float:
    if _TIMED[0] and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _busy(what: str, t: torch.Tensor, t0: float, key: str = "_busy_s") -> None:
    """Add the seconds since ``t0`` to ``TIMING[what + key]``."""
    if _TIMED[0]:
        TIMING[what + key] = TIMING.get(what + key, 0.0) + _clock(t) - t0


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, record, n_extras, x, *rest):
        extras = rest[:n_extras]
        ctx.run = run
        ctx.x_needs = x.requires_grad
        ctx.ex_needs = [e.requires_grad for e in extras]
        # the stage graphs take the inputs' requires_grad, from detached copies
        xs = x.detach().requires_grad_(x.requires_grad)
        exs = [e.detach().requires_grad_(e.requires_grad) for e in extras]
        t0 = _clock(x)
        out = run.forward(xs, exs, record)
        _busy("forward", out, t0, "_s")
        return out

    @staticmethod
    def backward(ctx, grad):
        run = ctx.run
        t0 = _clock(grad)
        x_grad, ex_grads, pgrads = run.backward(grad.contiguous(), ctx.x_needs, ctx.ex_needs)
        _busy("backward", grad, t0, "_s")
        ctx.run = None
        return (None, None, None, x_grad, *ex_grads, *pgrads)


def _loopback_exchange(sends, wants, device):
    if set(sends) != set(wants):
        raise RuntimeError(f"stage traffic out of step: sent {sorted(sends)}, expected {sorted(wants)}")
    return dict(sends)


def _process_exchange(sends, wants, device):
    """The stage traffic of this pipe rank through ``collectives.exchange``."""
    keys = list(wants)
    got = C.exchange([(t, P.global_rank(PIPE_AXIS, dst)) for (_, dst), t in sends.items()],
                     [(shape, dtype, P.global_rank(PIPE_AXIS, src)) for (src, _), (shape, dtype) in wants.items()],
                     device)
    return dict(zip(keys, got))


def _layout(n: int):
    """(global rows of the rows this pipe row runs, in gathered order; the
    pipe ranks' row counts, None where the pipe ranks hold the same rows;
    every data rank's row count; the global batch's rows)."""
    shard = current_shard()
    mine = shard.row_ids() if shard is not None else list(range(n))
    if _STATE[3]:
        return mine, None, [len(mine)], shard.rows if shard is not None else n
    everyone = C.all_gather_objects(mine, BATCH_AXIS)
    if not P.pipe_folds():
        return mine, None, [len(r) for r in everyone], sum(len(r) for r in everyone)
    p = P.pipe_world()
    d = P.data_rank()
    lines = [everyone[i * p : (i + 1) * p] for i in range(len(everyone) // p)]
    per_data = [sum(len(r) for r in line) for line in lines]
    return [i for r in lines[d] for i in r], [len(r) for r in lines[d]], per_data, sum(per_data)


def _microbatching(batch: int, n_stages: int, n_data: int, interleave: int) -> Optional[Tuple[int, int]]:
    """(M, V) of a stack forward on a global batch of ``batch`` rows, or None
    where the batch does not microbatch (``models/bert.py:_maybe_pipeline``'s
    checks and its interleave fallback)."""
    m = pipeline_microbatches(batch, n_stages, n_data)
    if batch % m or (batch // m) % n_data:
        return None
    if interleave > 1 and m % n_stages:
        for cand in (2 * n_stages, n_stages):
            if batch % cand == 0 and (batch // cand) % n_data == 0:
                return cand, interleave
        return m, 1
    return m, interleave


def pipeline_layers(layers: Sequence[nn.Module], remat: bool, x: torch.Tensor, bias, cross_v, cross_a,
                    n_stages: int, interleave: int = 1) -> Optional[torch.Tensor]:
    """The stack ``layers`` on ``x`` [B, N, D] (with the attention bias terms
    and the cross-attention memories of ``BertFusionLayer``), pipelined over
    the installed pipe axis, or None where the pipeline does not engage: not
    installed, a pipe axis of other than ``n_stages`` ranks, not a training
    step's forward (``collective_step``: evaluation and decoding run whole),
    data ranks holding different numbers of rows, or a batch that does not
    microbatch.  Every rank reaches the same decision from the batch axis's
    row counts."""
    if get_pipeline() != n_stages or not collective_step():
        return None
    rows, sizes, per_data, total = _layout(x.shape[0])
    if len(set(per_data)) != 1:
        return None
    n_data = len(per_data)
    plan = _microbatching(sum(per_data), n_stages, n_data, interleave)
    if plan is None:
        return None
    m, v = plan
    _STATE[2] += 1
    bias_terms = tuple(bias) if isinstance(bias, (tuple, list)) else ((bias,) if bias is not None else ())
    n = x.shape[0]
    batched = [t for t in bias_terms if t.shape[0] == n]
    static = tuple(t for t in bias_terms if t.shape[0] != n)
    extras = batched + [t for t in (cross_v, cross_a) if t is not None]
    seeds = [layer_seed(layer) for layer in layers]
    if sizes is not None:
        x = C.pipe_all_gather(x, sizes)
        extras = [C.pipe_all_gather(e, sizes) for e in extras]
    local = list(range(n_stages)) if _STATE[3] else [P.pipe_rank()]
    run = _Run(layers, remat, seeds, n_stages, v, m, local, rows, total, static, len(batched),
               cross_v is not None, cross_a is not None, _loopback_exchange if _STATE[3] else _process_exchange)
    out = _Pipeline.apply(run, torch.is_grad_enabled(), len(extras), x, *extras, *run.params())
    if _STATE[3]:
        return out
    spans = [(0, out.shape[0])] * n_stages
    if sizes is not None:
        offs = [sum(sizes[:p]) for p in range(n_stages + 1)]
        spans = list(zip(offs[:-1], offs[1:]))
    return C.pipe_hand_back(out, spans)
