"""Core neural-net layers of the port (counterpart of ``valor_tpu/ops/layers.py``).

Parameters are stored fp32 and allocated uninitialised: they are loaded from
``models.bridge`` (``params_from_jax`` or ``init_params``).  Activations run in
the module's compute dtype; every matmul casts its input and its fp32
parameters to that dtype where the JAX package does.  Attention scores and the
softmax stay fp32 and the probabilities are cast back to the compute dtype.
Every LayerNorm goes through ``ops/kernels/layernorm.py``: the CUDA kernels on
the card, their plain versions on the CPU.

Training mode (``module.train()``) turns on dropout where the JAX package has
``maybe_dropout``.  Its masks come from the seeded streams of the enclosing
``rng_scope`` (the counterpart of flax's ``rngs={"dropout": ..., "mask": ...}``),
never from torch's global generator; inside a ``parallel.mesh.batch_shard`` they
are drawn at the global batch's shape and this rank's rows taken.

Tensor parallelism over the model axis (``parallel/partition.py`` sets it up):
a split ``MultiHeadAttention`` runs its rank's heads (its input through
``copy_to_model``, its ``out`` row-parallel: the partial products summed by
``reduce_from_model``, then the bias once), a split ``MlpBlock`` its rank's
hidden units (``fc1`` by rows, ``fc2`` by columns).  Dropout on a rank's
columns of a wider tensor draws the whole width and keeps its columns, so the
model ranks draw what one process draws.  LayerNorms stay whole on every rank.
Under sequence parallelism (``parallel/activations.py``) a ``sequence`` call
takes and returns this rank's chunk of the sequence: the input's sequence is
gathered in place of ``copy_to_model``, and the output scattered in place of
``reduce_from_model`` (a module that stays whole gathers, computes whole and
keeps its chunk); dropout on a chunk draws the whole sequence and keeps it,
and a LayerNorm's parameters and a row-parallel bias read on a chunk have
their gradients summed over the model axis (``sequence_params``).
``run_layer`` runs one encoder layer,
under ``torch.utils.checkpoint`` where the config's ``checkpointing`` and
``remat_scope`` ask for it (``remat_for``); each layer draws from a stream of its
own, so the recompute of the backward draws the same masks.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from valor_tpu_torch.ops.kernels.layernorm import layernorm
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.activations import gather_sequence, scatter_sequence, sequence_params
from valor_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from valor_tpu_torch.parallel.mesh import batch_shard, current_shard, draw_rows

NEG_INF = -1e4  # the attention mask value: (1 - mask) * -10000

BiasTerms = Union[None, torch.Tensor, Sequence[torch.Tensor]]


_MASK64 = (1 << 63) - 1


def _mix(*vals: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each in turn)."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h + (v & _MASK64) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & _MASK64


class RNGStreams:
    """Named random streams ("dropout", "mask") of one forward, from one seed.

    Each draw seeds a ``torch.Generator`` on the tensor's device from (seed,
    stream, draw count), so a seed gives the same draws in every run; ``fork``
    gives an independent set of streams (one per checkpointed layer)."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._counts: Dict[str, int] = {}
        self._gens: Dict[torch.device, torch.Generator] = {}

    def _next(self, stream: str) -> int:
        n = self._counts.get(stream, 0)
        self._counts[stream] = n + 1
        return n

    def generator(self, device, stream: str = "dropout") -> torch.Generator:
        device = torch.device(device)
        g = self._gens.get(device)
        if g is None:
            g = self._gens[device] = torch.Generator(device=device)
        n = self._next(stream)
        return g.manual_seed(_mix(self.seed, sum(map(ord, stream)), n))

    def fork(self) -> "RNGStreams":
        return RNGStreams(_mix(self.seed, 0x666F726B, self._next("fork")))


_RNG = threading.local()  # .streams: the enclosing rng_scope's, per thread


@contextlib.contextmanager
def rng_scope(streams: Optional[RNGStreams]) -> Iterator[Optional[RNGStreams]]:
    """Make ``streams`` the source of dropout and token-mask draws inside the
    block, in this thread (a checkpointed layer's recompute sets its own)."""
    prev = getattr(_RNG, "streams", None)
    _RNG.streams = streams
    try:
        yield streams
    finally:
        _RNG.streams = prev


def current_rng(what: str) -> RNGStreams:
    rng = getattr(_RNG, "streams", None)
    if rng is None:
        raise RuntimeError(f"{what} needs random streams: run the forward inside ops.layers.rng_scope")
    return rng


def dropout(x: torch.Tensor, rate: float, training: bool,
            cols: Optional[Tuple[int, int]] = None, sequence: bool = False) -> torch.Tensor:
    """``maybe_dropout``: keep each element w.p. 1 - rate and scale it by
    1 / (1 - rate); an identity when not training or at rate 0.  ``cols`` =
    (i, n): ``x`` is block i of n equal column blocks of a wider tensor (a
    model rank's heads), whose mask is drawn whole and block i kept;
    ``sequence``: ``x`` [B, S/M, ...] is this model rank's chunk of the
    sequence, whose mask is drawn whole and the chunk kept."""
    if not training or rate <= 0.0:
        return x
    g = current_rng("dropout").generator(x.device, "dropout")
    shape = list(x.shape)
    if cols is not None:
        i, n = cols
        w = shape[-1]
        shape[-1] = w * n
    if sequence:
        s, m, r = shape[1], P.model_world(), P.model_rank()
        shape[1] = s * m
    keep = draw_rows(lambda s: torch.rand(s, generator=g, device=x.device), shape) < 1.0 - rate
    if cols is not None:
        keep = keep[..., i * w : (i + 1) * w]
    if sequence:
        keep = keep[:, r * s : (r + 1) * s]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


REMAT_TOKENS = ("all", "vision", "text", "audio", "fusion", "none")


def remat_for(checkpointing: bool, remat_scope: str, which: str) -> bool:
    """Whether encoder ``which`` checkpoints its layers (``valor_tpu/models/valor.py:105-123``)."""
    if not checkpointing:
        return False
    tokens = {s.strip() for s in remat_scope.split(",") if s.strip()}
    bad = tokens - set(REMAT_TOKENS)
    if bad or not tokens:
        raise ValueError(
            f"checkpointing=True with remat_scope={remat_scope!r}"
            f"{' (unknown token(s) ' + repr(sorted(bad)) + ')' if bad else ''}; "
            "valid tokens: " + ", ".join(REMAT_TOKENS)
        )
    if tokens == {"none"}:
        return False
    return "all" in tokens or which in tokens


_SOWN = threading.local()  # .values: the enclosing sow_scope's list, per thread


@contextlib.contextmanager
def sow_scope() -> Iterator[list]:
    """Collect, inside the block and in this thread, every value that a module
    hands ``sow`` (the MoE layers' load-balancing aux), one a module call, as
    flax's ``sow`` into a mutable collection does; yields the list."""
    prev = getattr(_SOWN, "values", None)
    _SOWN.values = []
    try:
        yield _SOWN.values
    finally:
        _SOWN.values = prev


def sow(value: torch.Tensor) -> None:
    """Hand ``value`` to the enclosing ``sow_scope``; nothing outside one."""
    values = getattr(_SOWN, "values", None)
    if values is not None:
        values.append(value)


def layer_seed(layer: nn.Module) -> Optional[int]:
    """The seed of the streams that a training ``layer`` draws from, forked
    from the enclosing ``rng_scope``'s (one fork a layer call, in call order);
    None where it draws none."""
    rng = getattr(_RNG, "streams", None)
    return rng.fork().seed if layer.training and rng is not None else None


def run_layer(layer: nn.Module, remat: bool, *args):
    """``layer(*args)``, under ``torch.utils.checkpoint`` when ``remat`` is set
    and autograd records.  A training layer draws its dropout from streams of
    its own, forked here (``layer_seed``), which the recompute draws again, in
    the enclosing ``batch_shard`` (the recompute may run in autograd's device
    thread).  A checkpointed layer returns what it sows beside its output, so
    the values of the forward reach the enclosing ``sow_scope`` once and the
    recompute's go nowhere."""
    return run_layer_in(layer, remat, layer_seed(layer), current_shard(), *args)


def run_layer_in(layer: nn.Module, remat: bool, seed: Optional[int], shard, *args):
    """``run_layer`` with the layer's streams from ``seed`` (the enclosing
    ones where None) and its draws in ``shard``: a pipeline stage runs one
    layer on each microbatch with the seed of the layer's one fork, and the
    microbatch's rows of the global batch."""
    rng = getattr(_RNG, "streams", None)

    def fn(*a):
        with rng_scope(rng if seed is None else RNGStreams(seed)), batch_shard(shard):
            return layer(*a)

    if remat and torch.is_grad_enabled():
        def sowing(*a):
            with sow_scope() as values:
                return fn(*a), values

        out, values = checkpoint(sowing, *args, use_reentrant=False)
        for v in values:
            sow(v)
        return out
    return fn(*args)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based gelu."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACT2FN = {"gelu": gelu_exact, "quick_gelu": quick_gelu}


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output in the compute dtype;
    ``sequence``: on this model rank's chunk of the sequence."""

    def __init__(self, dim: int, eps: float = 1e-12, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _param((dim,), device)
        self.bias = _param((dim,), device)

    def forward(self, x: torch.Tensor, sequence: bool = False) -> torch.Tensor:
        w, b = sequence_params(self.weight, self.bias) if sequence else (self.weight, self.bias)
        return layernorm(x, w, b, self.eps, self.dtype)


class Dense(nn.Module):
    """Linear layer: fp32 weight [out, in], matmul in the compute dtype.
    ``row_parallel`` (tensor parallelism): the weight holds this model rank's
    input columns, the partial products are summed over the model axis and
    the bias is added once, after the sum.  ``sequence``: the output is this
    rank's chunk of the sequence (of the sum, where row-parallel)."""

    row_parallel = False

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((out_features, in_features), device)
        self.bias = _param((out_features,), device) if use_bias else None

    def forward(self, x: torch.Tensor, sequence: bool = False) -> torch.Tensor:
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        if self.row_parallel:
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
            if sequence:
                y = scatter_sequence(y)
                bias = None if bias is None else sequence_params(self.bias)[0].to(self.dtype)
            else:
                y = reduce_from_model(y)
            return y if bias is None else y + bias
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)
        return scatter_sequence(y, partial=False) if sequence else y


class Embed(nn.Module):
    """Token embedding: fp32 table, output in the compute dtype."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((num_embeddings, features), device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-weight decoding, x @ table.T."""
        return torch.matmul(x, self.weight.t().to(x.dtype))


def _terms(bias: BiasTerms) -> Tuple[torch.Tensor, ...]:
    if bias is None:
        return ()
    return tuple(bias) if isinstance(bias, (tuple, list)) else (bias,)


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Q, D]
    k: torch.Tensor,  # [B, Hk, K, D], Hk divides H
    v: torch.Tensor,  # [B, Hk, K, D]
    bias: BiasTerms = None,  # additive terms, each [B|1, 1|H, Q|1, K]
    dtype=torch.float32,
) -> torch.Tensor:
    """Masked scaled-dot-product attention, grouped-query where K/V have
    fewer heads than the queries: query head h reads K/V head h // (H / Hk)
    (Hk = H is full multi-head attention).  The queries of a group are
    stacked as rows, [B, Hk, G*Q, D], so each K/V head serves its group in
    one product and K/V are never repeated to the full head count.

    Scores are computed in fp32 (products of the compute-dtype inputs,
    accumulated in fp32), scaled, and each additive bias term is added in
    turn; the fp32 softmax is cast to the compute dtype for the product
    with V."""
    b, h, qlen, depth = q.shape
    hk = k.shape[1]
    if h % hk:
        raise ValueError(f"{h} query heads not divisible by {hk} kv heads")
    g = h // hk
    scores = torch.matmul(q.reshape(b, hk, g * qlen, depth).float(), k.float().transpose(-1, -2))
    scores = (scores / math.sqrt(depth)).reshape(b, hk, g, qlen, -1)
    for term in _terms(bias):
        term = term.float()
        scores = scores + (term.unsqueeze(2) if term.shape[1] == 1 else term.unflatten(1, (hk, g)))
    probs = torch.softmax(scores, dim=-1).to(dtype).reshape(b, hk, g * qlen, -1)
    return torch.matmul(probs, v).reshape(b, h, qlen, depth)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with additive bias terms and caller-managed K/V.

    ``extra_kv`` = (k, v), each [B, Hk, E, D], is appended to the keys and
    values projected from ``kv_in``; with ``kv_in=None`` the keys and values
    come from ``extra_kv`` alone (the decode path's cross-attention cache).
    ``kv_heads`` (0: ``num_heads``) below ``num_heads`` projects K and V to
    ``kv_heads`` heads of the same head width, each serving a group of query
    heads; at ``num_heads`` the parameters are those of full multi-head
    attention.  Under tensor parallelism (``tensor_parallel``) ``num_heads``
    and ``kv_heads`` are this model rank's, ``compute_kv`` gives its heads'
    K/V (the decode caches hold 1/M of the heads) and ``model_cols`` (rank, M)
    places its heads in the whole width for dropout.  ``sequence``: ``q_in``
    (and ``kv_in`` where it is ``q_in``) is this rank's chunk of the
    sequence, gathered here, and so is the output."""

    tensor_parallel = False
    model_cols: Optional[Tuple[int, int]] = None

    def __init__(self, width: int, num_heads: int, dtype=torch.float32, device=None,
                 dropout: float = 0.0, kv_heads: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.kv_heads = kv_heads or num_heads
        self.dtype = dtype
        self.dropout = dropout
        kv_width = width // num_heads * self.kv_heads
        self.query = Dense(width, width, dtype=dtype, device=device)
        self.key = Dense(width, kv_width, dtype=dtype, device=device)
        self.value = Dense(width, kv_width, dtype=dtype, device=device)
        self.out = Dense(width, width, dtype=dtype, device=device)

    def forward(
        self,
        q_in: torch.Tensor,  # [B, Q, C]
        kv_in: Optional[torch.Tensor],  # [B, K, C] or None (cache-only)
        bias: BiasTerms = None,
        extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        sequence: bool = False,
    ) -> torch.Tensor:
        same = kv_in is q_in
        if sequence:
            q_in = gather_sequence(q_in, partial=self.tensor_parallel)
        elif self.tensor_parallel:
            q_in = copy_to_model(q_in)
        qh = split_heads(self.query(q_in), self.num_heads)
        if kv_in is not None:
            kh, vh = self._project_kv(q_in if same else self._model_input(kv_in))
            if extra_kv is not None:
                ek, ev = extra_kv
                kh = torch.cat([kh, ek.to(kh.dtype)], dim=2)
                vh = torch.cat([vh, ev.to(vh.dtype)], dim=2)
        else:
            if extra_kv is None:
                raise ValueError("cache-only attention needs extra_kv")
            kh, vh = (t.to(qh.dtype) for t in extra_kv)
        out = dot_product_attention(qh, kh, vh, bias=bias, dtype=self.dtype)
        return self.out(dropout(merge_heads(out), self.dropout, self.training, self.model_cols), sequence)

    def _model_input(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x) if self.tensor_parallel else x

    def compute_kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project and split K/V for caching (no attention): this model
        rank's heads under tensor parallelism."""
        return self._project_kv(self._model_input(kv_in))

    def _project_kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            split_heads(self.key(kv_in), self.kv_heads),
            split_heads(self.value(kv_in), self.kv_heads),
        )


class MlpBlock(nn.Module):
    """Transformer FFN: dense -> activation -> dense; under tensor
    parallelism this model rank's hidden units (``fc2`` row-parallel);
    ``sequence``: on this rank's chunk of the sequence."""

    tensor_parallel = False

    def __init__(self, width: int, intermediate: int, activation: str = "gelu",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.act = ACT2FN[activation]
        self.fc1 = Dense(width, intermediate, dtype=dtype, device=device)
        self.fc2 = Dense(intermediate, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, sequence: bool = False) -> torch.Tensor:
        if sequence:
            x = gather_sequence(x, partial=self.tensor_parallel)
        elif self.tensor_parallel:
            x = copy_to_model(x)
        return self.fc2(self.act(self.fc1(x)), sequence)


class PreNormLayer(nn.Module):
    """Pre-norm transformer layer (AST and CLIP)."""

    def __init__(self, width: int, num_heads: int, intermediate: int,
                 activation: str = "gelu", ln_eps: float = 1e-12,
                 dtype=torch.float32, device=None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ln1 = LayerNorm(width, ln_eps, dtype, device)
        self.attn = MultiHeadAttention(width, num_heads, dtype, device)
        self.ln2 = LayerNorm(width, ln_eps, dtype, device)
        self.mlp = MlpBlock(width, intermediate, activation, dtype, device)

    def forward(self, x: torch.Tensor, bias: BiasTerms = None) -> torch.Tensor:
        h = self.ln1(x)
        x = x + dropout(self.attn(h, h, bias), self.dropout, self.training)
        return x + dropout(self.mlp(self.ln2(x)), self.dropout, self.training)
