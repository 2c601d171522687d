"""Sequence parallelism over the model axis (counterpart of
``valor_tpu/parallel/activations.py``).

The JAX package constrains the fusion residual stream [B, S, D] to
``P(data, model, None)`` before the first fusion layer and after every layer,
and GSPMD runs LayerNorm, residual adds and dropout on the sequence shard and
gathers the sequence around attention and the FFN (Megatron-LM sequence
parallelism).  The port writes those collectives by hand, on dim 1 over the
model axis's process group (``parallel/collectives.py:all_gather_dim`` and
``reduce_scatter_dim`` move the bytes):

  * ``gather_sequence``: this rank's chunk -> the whole sequence; backward, a
    reduce-scatter where the consumer splits its work over the model ranks
    (tensor-parallel heads or hidden units, experts), so that each rank's
    gradient is a part of the sum, or this rank's chunk of the gradient where
    the consumer runs whole on every rank;
  * ``scatter_sequence``: a whole sequence -> this rank's chunk; forward, a
    reduce-scatter of the model ranks' partial sums (a row-parallel output)
    or the chunk of a tensor that every rank holds whole; backward, an
    all-gather of the chunks' gradients.

``models/bert.py:BertFusionEncoder`` takes its chunk before the first layer and
gathers the sequence after the last; between them a layer's residual adds,
dropout and LayerNorms run on the chunk, and each sublayer gathers its input
and scatters its output (``ops/layers.py``, ``ops/moe.py``).  Dropout on a
chunk draws the whole [B, S, D] mask and keeps its chunk, so the model ranks
draw what one process draws.  A parameter read on the chunk (a LayerNorm's, a
row-parallel bias) gets from each rank the gradient of its chunk's rows:
``sequence_params`` sums them over the model axis in the backward, so every
rank holds the whole gradient, as it does for every other replicated
parameter, whichever forwards ran split.

``set_sequence_sharding`` installs the switch (``cli/build.py`` from the
config's ``sequence_parallel``), ``sequence_sharded`` applies the JAX rule
and ``sequence_sharding_applied`` counts the fusion forwards that ran split.
"""

from __future__ import annotations

import torch

from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.mesh import MODEL_AXIS

_STATE: list = [False, 0]  # [switch, fusion forwards that ran sequence-split]


def set_sequence_sharding(on: bool) -> None:
    """Install (or clear) sequence parallelism; the count starts again at 0."""
    _STATE[0] = bool(on)
    _STATE[1] = 0


def sequence_sharding_applied() -> int:
    """The fusion forwards that ran sequence-split since ``set_sequence_sharding``."""
    return _STATE[1]


def sequence_sharded(x: torch.Tensor) -> bool:
    """Whether the fusion stack runs the [B, S, D] residual stream ``x`` split
    over the model axis, counting it where it does: the switch is on, the
    model axis holds more than one rank and divides S.  The JAX rule also
    asks that the data axis divide the batch; a rank here holds its data
    shard already (``parallel/mesh.py:step_shard``), so that test has no
    counterpart."""
    m = P.model_world()
    if not _STATE[0] or x.dim() != 3 or m <= 1 or x.shape[1] % m:
        return False
    _STATE[1] += 1
    return True


def _chunk(x: torch.Tensor) -> torch.Tensor:
    return x.chunk(P.model_world(), 1)[P.model_rank()].contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, partial):
        ctx.partial = partial
        return C.all_gather_dim(x, 1, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return (C.reduce_scatter_dim(grad, 1, MODEL_AXIS) if ctx.partial else _chunk(grad)), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, partial):
        return C.reduce_scatter_dim(x, 1, MODEL_AXIS) if partial else _chunk(x)

    @staticmethod
    def backward(ctx, grad):
        return C.all_gather_dim(grad, 1, MODEL_AXIS), None


def gather_sequence(x: torch.Tensor, partial: bool = True) -> torch.Tensor:
    """The whole sequence of this rank's chunk ``x`` [B, S/M, ...]; with
    ``partial`` the gradient is summed over the model ranks (their consumers
    each compute a part), else each rank's gradient is whole already and its
    chunk is kept."""
    return _Gather.apply(x, partial)


def scatter_sequence(x: torch.Tensor, partial: bool = True) -> torch.Tensor:
    """This rank's chunk [B, S/M, ...] of ``x``: of the sum over the model
    ranks of their partial ``x`` with ``partial``, else of ``x`` itself (whole
    on every rank); the gradient of the whole is gathered from the chunks."""
    return _Scatter.apply(x, partial)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *params):
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        flat = C.model_all_reduce_(torch.cat([g.reshape(-1).float() for g in grads]))
        return tuple(part.view_as(g).to(g.dtype) for part, g in zip(flat.split([g.numel() for g in grads]), grads))


def sequence_params(*params: torch.Tensor):
    """``params``, read on this rank's chunk of the sequence: themselves, their
    gradients summed over the model axis (one all-reduce)."""
    return _SumGrads.apply(*params)
