"""One training step (counterpart of ``valor_tpu/train/step.py``).

``train_step`` runs the loss-dict forward of one (task, batch) pair in the
seeded random streams of its micro-step, adds ``moe_aux`` (the weight times the
mean of the load-balancing aux that the MoE layers sowed, one value a layer
call) where a weight is given, sums the losses in float32, takes
every parameter's gradient, casts the gradients to ``grad_dtype`` and hands
them to the optimizer.  The JAX step returns a new state; this one updates the
model, the optimizer and ``state.step`` in place.  Its three parts run in
``torch.profiler.record_function`` ranges (``RANGES``), which a profiler trace
reads (``tools/profile_training.py``) and which do nothing otherwise.
``eval_step`` is the loss-free forward of evaluation (``make_eval_step``);
``scst_update`` the REINFORCE update of SCST finetuning (``make_scst_step``).

Across processes (``parallel/``) a step runs in its batch's
``parallel.mesh.batch_shard``: random draws at the global batch's shape, global
loss normalisers and contrastive gallery; the gradients are averaged over ranks
in fp32 before the cast and the update (``GroupedAdam.reduce_grads``: under
ZeRO-1 a split leaf's gradient as this rank's block), and the reported losses
are the global batch's.  Every rank then makes the same update, the one a
single process makes on the global batch.  ``scst_update`` does the same with
the SCST loss normalised over the global batch.  On a (data, model, pipe) mesh
(``parallel/partition.py``) the step runs unchanged in form over this rank's
tensors: the model axis's collectives sit in the layers, ``fsdp``'s in the
reads of its parameters, the pipeline's in the fusion stack
(``parallel/pipeline.py``: a fusion layer's gradient arises on its stage's
ranks), and ``reduce_grads`` averages over the data and pipe axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from valor_tpu_torch.core.device import torch_dtype
from valor_tpu_torch.core.tasks import TaskSpec
from valor_tpu_torch.ops.layers import RNGStreams, _mix, rng_scope, sow_scope
from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel.mesh import BatchShard, batch_shard, step_shard
from valor_tpu_torch.tasks.scst import scst_loss
from valor_tpu_torch.train.optimizer import GroupedAdam

RANGES = ("train_step.forward", "train_step.backward", "train_step.update")
HOST_KEYS = ("ids", "ids_txt", "sample_num", "answers", "question_ids")


@dataclasses.dataclass
class TrainState:
    """``step`` counts micro-batches (the JAX ``TrainState.step``); the
    optimizer counts its own updates."""

    model: nn.Module
    optimizer: GroupedAdam
    step: int = 0


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collate-layout batch (numpy arrays or tensors) as tensors on
    ``device``, without its host-only keys."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if k not in HOST_KEYS and v is not None}


def cast_grads(grads, grad_dtype: Optional[str]):
    """The optional bf16 gradient regime (``TrainConfig.grad_dtype``)."""
    if not grad_dtype or grad_dtype == "float32":
        return list(grads)
    dt = torch_dtype(grad_dtype)
    return [g.to(dt) for g in grads]


def param_grads(total: torch.Tensor, params) -> list:
    """d total / d p for every parameter; zeros where a parameter took no part
    (as ``jax.grad`` gives them)."""
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def moe_aux_weight_for(model_cfg) -> float:
    """The weight of ``moe_aux``: ``fusion_moe_aux_weight`` where the fusion
    stack has MoE layers, else 0."""
    return model_cfg.fusion_moe_aux_weight if model_cfg.fusion_moe_experts > 0 else 0.0


def with_moe_aux(losses: Dict[str, torch.Tensor], sown: list, weight: float) -> Dict[str, torch.Tensor]:
    """``losses`` with ``moe_aux``, the weight times the mean of the aux that
    the MoE layers sowed (one value a layer call), where a weight is given
    and something was sown.  The mean over MoE layer calls keeps the balance
    strength per layer whatever ``fusion_moe_every`` and the layer count."""
    if not (weight and sown):
        return losses
    return dict(losses, moe_aux=weight * (sum(a.float() for a in sown) / len(sown)))


def losses_and_grads(
    model: nn.Module, batch: Dict[str, Any], task: TaskSpec, seed: int,
    grad_dtype: Optional[str] = None, moe_aux_weight: float = 0.0,
    reduce_grads: Optional[Callable[[list], list]] = None,
) -> Tuple[Dict[str, torch.Tensor], list]:
    """The losses (with ``total_loss``, detached) and every parameter's
    gradient of one micro-batch, drawn from ``seed``'s streams; across
    processes the global batch's, averaged over ranks by ``reduce_grads``
    (the optimizer's; ``all_reduce_mean_`` when None)."""
    params = [p for p in model.parameters()]
    fwd, bwd, _ = RANGES
    with rng_scope(RNGStreams(seed)), batch_shard(step_shard(batch)):
        with record_function(fwd):
            with sow_scope() as sown:
                losses = model(batch, task, True, True)
            losses = with_moe_aux(losses, sown, moe_aux_weight)
            total = sum(v.float() for v in losses.values())
        with record_function(bwd):
            grads = param_grads(total, params)
            # every micro-batch's gradient is averaged over ranks (the JAX
            # step's psum of each global-batch gradient), so accumulation and
            # the grad_norm metric see the global gradient; one reduction an
            # update would do for the update alone
            if reduce_grads is None:
                C.all_reduce_mean_(grads)
            else:
                grads = reduce_grads(grads)
            grads = cast_grads(grads, grad_dtype)
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    return C.mean_over_ranks(metrics), grads


def train_step(
    state: TrainState, batch: Dict[str, Any], task: TaskSpec, seed: int,
    grad_dtype: Optional[str] = None, moe_aux_weight: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Forward, backward and optimizer update of one micro-batch.  Returns the
    losses, ``total_loss`` and the gradients' global norm, as device scalars:
    nothing here waits for the device (but a gloo collective)."""
    metrics, grads = losses_and_grads(state.model, batch, task, _mix(seed, state.step), grad_dtype,
                                      moe_aux_weight, state.optimizer.reduce_grads)
    with record_function(RANGES[2]):
        state.optimizer.update(grads)
    state.step += 1
    metrics["grad_norm"] = state.optimizer.grad_norm(grads)
    return metrics


def scst_update(
    state: TrainState, batch: Dict[str, Any], sequences: torch.Tensor, rewards: torch.Tensor,
    caption_type: str, group: str, shard: Optional[BatchShard] = None,
) -> Dict[str, torch.Tensor]:
    """One REINFORCE update of the fusion stack and its head on a sampled
    rollout (``tasks/scst.py:scst_loss``; ``batch`` holds the fusion-space
    media of one encode).  The JAX loss runs outside ``train_step`` and so
    without dropout: the model is in eval mode for the forward and backward,
    and its training mode is restored after.  Every parameter gets a gradient,
    zeros for the towers that encoded the media without autograd (as
    ``jax.grad`` gives them), so the optimizer decays them as the JAX step
    does.  ``state.step`` counts the update.  Across processes (``shard``, this
    rank's rows of the global batch) the loss is this rank's share of the
    global batch's and the gradients are averaged over ranks.  Returns
    ``{"loss": ...}``, the global batch's loss, a device scalar."""
    model = state.model
    params = [p for p in model.parameters()]
    fwd, bwd, upd = RANGES
    was_training = model.training
    model.eval()
    try:
        with record_function(fwd), batch_shard(shard):
            loss = scst_loss(model, batch, sequences, rewards, caption_type,
                             use_video="v" in group, use_audio="a" in group)
        with record_function(bwd):
            grads = state.optimizer.reduce_grads(param_grads(loss, params))
    finally:
        model.train(was_training)
    with record_function(upd):
        state.optimizer.update(grads)
    state.step += 1
    return C.mean_over_ranks({"loss": loss.detach()})


def eval_step(model: nn.Module, batch: Dict[str, Any], task: TaskSpec) -> Dict[str, Any]:
    """The loss-free forward of ``task`` on ``batch`` (``compute_loss=False``,
    ``train=False``): the model in eval mode, without autograd, with the fixed
    random streams of seed 0 (the JAX step's fixed ``PRNGKey(0)`` mask stream),
    and its training mode restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), rng_scope(RNGStreams(0)):
            return model(to_device(batch, model.device), task, False, False)
    finally:
        model.train(was_training)
