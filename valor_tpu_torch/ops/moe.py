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
so here they are ``torch.einsum``.  Expert parallelism (the JAX package's
sharding constraints over the ``model`` mesh axis) is a no-op on one device and
is not part of the port.  The Switch load-balancing aux, ``E * sum_e f_e * P_e``
with ``f_e`` the share of tokens whose first choice is ``e`` and ``P_e`` the
mean router probability of ``e`` (1 when balanced), is returned beside the
output; the fusion layer sows it (``ops.layers.sow``).  In a training step
across ranks ``f`` and ``P`` are means over the global batch's tokens
(``parallel/collectives.py:global_means``), as the JAX package's are over the
global array; routing and capacity are per group, so the drops do not change.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from valor_tpu_torch.ops.layers import ACT2FN, _param
from valor_tpu_torch.parallel.collectives import global_means


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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.dim() != 3:
            raise ValueError(f"MoE input must be [G, S, M], got {tuple(x.shape)}")
        dt = self.dtype
        tokens = x.shape[0] * x.shape[1]
        r = self.route(x)
        slot_one = F.one_hot(r.slot.long(), r.capacity).to(r.keep.dtype)  # [K, G, S, C]
        dispatch = torch.einsum("kgse,kgsc->gsec", r.keep.to(x.dtype), slot_one.to(x.dtype))
        picked = torch.einsum("kgse,gse->kgs", r.sel, r.gates)
        weight = picked * r.keep.sum(-1) / torch.clamp(picked.sum(0), min=1e-9)
        combine = torch.einsum("kgse,kgsc,kgs->gsec", r.keep, slot_one, weight).to(x.dtype)

        expert_in = torch.einsum("gsec,gsm->egcm", dispatch, x)
        h = torch.einsum("egcm,emh->egch", expert_in, self.w1.to(dt)) + self.b1.to(dt)[:, None, None, :]
        out = torch.einsum("egch,ehm->egcm", self.act(h), self.w2.to(dt)) + self.b2.to(dt)[:, None, None, :]
        y = torch.einsum("gsec,egcm->gsm", combine, out)

        f, p = global_means(r.sel[0].mean(dim=(0, 1)), r.gates.mean(dim=(0, 1)), tokens)
        return y, self.num_experts * (f * p).sum()
