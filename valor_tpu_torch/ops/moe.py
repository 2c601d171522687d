"""Mixture-of-Experts FFN (counterpart of ``valor_tpu/ops/moe.py``).

GShard/Switch routing with static shapes, as the JAX package computes it on
one device:

  * the router is a dense fp32 ``[G, S, E]`` softmax over the experts; the top
    k experts of a token are picked by iterative masking (``torch.argmax``
    takes the first of equal maxima, as ``jnp.argmax`` does);
  * each expert has ``C = ceil(k * S * capacity_factor / E)`` slots per group;
    a choice's slot is the count of earlier claims on its expert, choice k
    claiming before token s (a cumsum over ``[G, K*S, E]``), and a choice past
    the capacity is dropped: its combine weight is zero, so the residual
    carries the token;
  * the combine weight of a kept choice is its gate over the sum of the token's
    top-k gates before any drop;
  * dispatch and combine are one-hot products, ``[G, S, E, C]`` against
    ``[G, S, M]``, giving expert-major batches ``[E, G, C, M]`` for the
    stacked fp32 expert weights, cast to the compute dtype at the product.

The JAX package computes these products with XLA outside any Pallas kernel,
so here they are ``torch.einsum``.

Expert parallelism over the model axis (the JAX package's ``_expert_sharded``
constraints, switched on by ``set_expert_sharding``): where the model axis
holds M > 1 ranks and M divides E, model rank r computes experts
``[r E / M, (r + 1) E / M)``.  Tokens are split over the data axis only, so
every model rank holds every token it routes: routing, capacity and slots run
whole and identical on each rank, and no all-to-all moves tokens.  The
dispatch input and the combine weights pass ``copy_to_model`` before this
rank's experts are taken (their gradients, each rank's from its experts,
are summed over the model axis; the router's gradient flows through the
combine weights), and ``y`` is summed over the model axis
(``reduce_from_model``, or a reduce-scatter of the sequence under sequence
parallelism).  The stacks ``w1``, ``b1``, ``w2``, ``b2`` stay whole on every
rank, as the JAX spec ``P()`` keeps them; each rank reads its rows through
``expert_rows``, whose backward gathers the rows' gradients over the model
axis, so every rank holds the whole, identical gradient of each stack.
Where M does not divide E every rank computes every expert, as the JAX
constraint leaves the tensors unsplit.  ``expert_sharding_applied`` counts the
forwards that ran split.

The Switch load-balancing aux, ``E * sum_e f_e * P_e``
with ``f_e`` the share of tokens whose first choice is ``e`` and ``P_e`` the
mean router probability of ``e`` (1 when balanced), is returned beside the
output; the fusion layer sows it (``ops.layers.sow``).  In a training step
across ranks ``f`` and ``P`` are means over the global batch's tokens
(``parallel/collectives.py:global_means``), as the JAX package's are over the
global array; routing and capacity are per group, so the drops do not change.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from valor_tpu_torch.ops.layers import ACT2FN, _param
from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.activations import gather_sequence, scatter_sequence
from valor_tpu_torch.parallel.collectives import copy_to_model, global_means, reduce_from_model

_STATE: list = [False, 0]  # [switch, forwards that ran expert-split]


def set_expert_sharding(on: bool) -> None:
    """Install (or clear) expert parallelism over the model axis; the count
    starts again at 0."""
    _STATE[0] = bool(on)
    _STATE[1] = 0


def expert_sharding_applied() -> int:
    """The MoE forwards that ran expert-split since ``set_expert_sharding``
    (a checkpointed layer's recompute counts again)."""
    return _STATE[1]


def expert_split(num_experts: int) -> Optional[Tuple[int, int]]:
    """This model rank's experts ``(first, count)`` where expert parallelism
    splits ``num_experts`` over the model axis; None where it does not (the
    switch off, one model rank, or E not divisible by them)."""
    m = P.model_world()
    if not _STATE[0] or m <= 1 or num_experts % m:
        return None
    n = num_experts // m
    return P.model_rank() * n, n


class _ExpertRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stack, first, count):
        return stack.narrow(0, first, count)

    @staticmethod
    def backward(ctx, grad):
        return C.all_gather_dim(grad, 0, C.MODEL_AXIS), None, None


def expert_rows(stack: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """Rows ``[first, first + count)`` of a whole expert stack; the gradient
    of the whole stack is every model rank's rows' gradients gathered."""
    return _ExpertRows.apply(stack, first, count)


def top_k_mask(gates: torch.Tensor, k: int) -> torch.Tensor:
    """[G, S, E] -> [K, G, S, E] one-hot masks of the k largest gates, by
    iterative masking: a picked expert is pushed below every gate."""
    masks = []
    remaining = gates
    for _ in range(k):
        one = F.one_hot(torch.argmax(remaining, dim=-1), gates.shape[-1]).to(gates.dtype)
        masks.append(one)
        remaining = remaining * (1.0 - one) - one
    return torch.stack(masks)


class Routing(NamedTuple):
    gates: torch.Tensor  # [G, S, E] fp32 router probabilities
    sel: torch.Tensor  # [K, G, S, E] one-hot top-k choices
    keep: torch.Tensor  # [K, G, S, E] the choices that found a slot
    slot: torch.Tensor  # [K, G, S] slot of each kept choice (0 if dropped)
    capacity: int


class MoEMlpBlock(nn.Module):
    """Drop-in MoE replacement for ``ops.layers.MlpBlock`` on ``[G, S, M]``
    input; returns ``(y, aux)`` with ``y`` of the input's shape."""

    def __init__(self, width: int, num_experts: int, intermediate: int, top_k: int = 2,
                 capacity_factor: float = 1.25, activation: str = "gelu",
                 dtype=torch.float32, device=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} out of range for {num_experts} experts")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.act = ACT2FN[activation]
        self.dtype = dtype
        e, m, h = num_experts, width, intermediate
        self.router = _param((m, e), device)
        self.w1 = _param((e, m, h), device)
        self.b1 = _param((e, h), device)
        self.w2 = _param((e, h, m), device)
        self.b2 = _param((e, m), device)

    def route(self, x: torch.Tensor) -> Routing:
        """The router's gates, choices, kept choices and slots for ``x``
        [G, S, M] (fp32: argmax ties must not depend on the compute dtype)."""
        g, s, _ = x.shape
        e, k = self.num_experts, self.top_k
        cap = max(1, math.ceil(k * s * self.capacity_factor / e))
        gates = torch.softmax(torch.einsum("gsm,me->gse", x.float(), self.router), dim=-1)
        sel = top_k_mask(gates, k)
        flat = sel.transpose(0, 1).reshape(g, k * s, e)  # choice k before token s
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, k, s, e).transpose(0, 1)
        keep = sel * (pos < cap)
        slot = torch.einsum("kgse,kgse->kgs", pos, keep)
        return Routing(gates, sel, keep, slot, cap)

    def forward(self, x: torch.Tensor, sequence: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(y, aux)``; ``sequence``: ``x`` [G, S/M, M] is this model rank's
        chunk of the sequence, gathered whole before routing (capacity and
        slots count over S), and ``y`` is its chunk."""
        if x.dim() != 3:
            raise ValueError(f"MoE input must be [G, S, M], got {tuple(x.shape)}")
        if sequence:
            x = gather_sequence(x, partial=False)
        dt = self.dtype
        tokens = x.shape[0] * x.shape[1]
        r = self.route(x)
        slot_one = F.one_hot(r.slot.long(), r.capacity).to(r.keep.dtype)  # [K, G, S, C]
        dispatch = torch.einsum("kgse,kgsc->gsec", r.keep.to(x.dtype), slot_one.to(x.dtype))
        picked = torch.einsum("kgse,gse->kgs", r.sel, r.gates)
        weight = picked * r.keep.sum(-1) / torch.clamp(picked.sum(0), min=1e-9)
        combine = torch.einsum("kgse,kgsc,kgs->gsec", r.keep, slot_one, weight).to(x.dtype)

        w1, b1, w2, b2, xin = self.w1, self.b1, self.w2, self.b2, x
        split = expert_split(self.num_experts)
        if split is not None:
            _STATE[1] += 1
            first, n = split
            xin, combine = copy_to_model(x), copy_to_model(combine)
            dispatch, combine = dispatch.narrow(2, first, n), combine.narrow(2, first, n)
            w1, b1, w2, b2 = (expert_rows(t, first, n) for t in (w1, b1, w2, b2))
        expert_in = torch.einsum("gsec,gsm->egcm", dispatch, xin)
        h = torch.einsum("egcm,emh->egch", expert_in, w1.to(dt)) + b1.to(dt)[:, None, None, :]
        out = torch.einsum("egch,ehm->egcm", self.act(h), w2.to(dt)) + b2.to(dt)[:, None, None, :]
        y = torch.einsum("gsec,egcm->gsm", combine, out)
        if split is not None:
            y = scatter_sequence(y) if sequence else reduce_from_model(y)
        elif sequence:
            y = scatter_sequence(y, partial=False)

        f, p = global_means(r.sel[0].mean(dim=(0, 1)), r.gates.mean(dim=(0, 1)), tokens)
        return y, self.num_experts * (f * p).sum()
