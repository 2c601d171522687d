"""Collectives of the data axis (counterpart of ``valor_tpu/parallel/collectives.py``).

Host objects and evaluation arrays (the JAX package's ``process_allgather``
uses): ``all_gather_objects``, ``all_gather_lists``, ``gather_arrays`` and
``all_gather_ragged``, which pads every rank's rows to the largest shard,
gathers and trims.  Every one of them short-circuits in one process.

A training step's global arithmetic, which XLA derives from the global array
in the JAX package:

  * ``all_gather_with_grad``: the batch's rows from every rank; its backward
    gives this rank's slice of the gradient summed over ranks;
  * ``all_reduce_mean_with_grad``: the mean over ranks, and the mean of the
    gradient in the backward;
  * ``sharded_mean``: this rank's share of a mean over the global batch, so that
    the mean over ranks of every rank's loss is the global loss and the mean of
    their gradients its gradient;
  * ``all_reduce_mean_``: the gradients averaged over ranks in fp32 buckets;
  * ``mean_over_ranks``: the step's reported losses, as global values.

ZeRO-1 (``zero_optimizer``; ``train/optimizer.py``) splits a leaf on dim 0 into
one block a rank, in rank order:

  * ``reduce_scatter_mean``: this rank's block of each tensor, averaged over
    ranks;
  * ``all_gather_blocks_``: every rank's block of each tensor, in place;
  * ``gather_blocks_``: every rank's block of each tensor into rank 0's whole
    tensors (a checkpoint's optimizer state).

They go through flat fp32 buckets whose row w holds rank w's blocks.  NCCL
takes the tensor forms (``reduce_scatter_tensor``, ``all_gather_into_tensor``);
gloo has no reduce-scatter, so it all-reduces the bucket and keeps this rank's
row, and gathers through the list form of ``all_gather``.  Each element is the
same sum of the same values on both paths.  ``gather_blocks_`` takes
``dist.gather`` on both.

The backend's own rules hold: NCCL reduces CUDA tensors only, gloo both.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist

from valor_tpu_torch.parallel.mesh import collective_step, is_initialized, rank, world_size

BUCKET_ELEMS = 1 << 25  # fp32 elements a gradient bucket (128 MiB)


def process_count() -> int:
    return world_size()


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object a rank -> the list in rank order."""
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def all_gather_lists(items: Sequence[Any]) -> List[Any]:
    """Every rank's list, concatenated in rank order."""
    return [x for chunk in all_gather_objects(list(items)) for x in chunk]


def all_gather_rows(items: Sequence[Any], shard) -> List[Any]:
    """This rank's items of a global batch (one a row of ``shard``, a
    ``parallel.mesh.BatchShard``; None in one process) gathered from every
    rank, in the global batch's row order."""
    if shard is None:
        return list(items)
    out: List[Any] = [None] * shard.rows
    rows = all_gather_lists(zip(range(shard.rows)[shard.index], items))
    for i, x in rows:
        out[i] = x
    return out


def gather_arrays(x: torch.Tensor) -> torch.Tensor:
    """A tensor of one shape on every rank, stacked in rank order."""
    if world_size() == 1:
        return x[None]
    out = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(out, x.contiguous())
    return torch.stack(out)


def all_gather_ragged(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows concatenated in rank order, where ranks hold
    different numbers of rows (ragged evaluation shards, an empty one
    included)."""
    if world_size() == 1:
        return x
    sizes = all_gather_objects(int(x.shape[0]))
    pad = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
    pad[: x.shape[0]] = x
    gathered = gather_arrays(pad)
    return torch.cat([gathered[i, :n] for i, n in enumerate(sizes)])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return gather_arrays(x).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        r = rank()
        return grad[r * ctx.rows : (r + 1) * ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows (as many on each) concatenated in rank order; the
    gradient of this rank's rows is their gradient summed over every rank's
    loss."""
    return x if world_size() == 1 else _AllGather.apply(x)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y / world_size()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad / world_size()


def all_reduce_mean_with_grad(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks, with the gradient of every rank's loss."""
    return x if world_size() == 1 else _AllReduceMean.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, outside autograd (counts)."""
    x = x.detach().clone()
    if world_size() > 1:
        dist.all_reduce(x)
    return x


def sharded_mean(total: torch.Tensor, count) -> torch.Tensor:
    """``total / count`` (count at least 1).  In a training step across
    ranks, this rank's share of the mean over the global batch: ``world *
    total / (count summed over ranks)``, whose mean over ranks is the global
    mean."""
    count = torch.as_tensor(count, dtype=torch.float32, device=total.device)
    if not collective_step():
        return total / count.clamp_min(1.0)
    return world_size() * total / all_reduce_sum(count).clamp_min(1.0)


def global_means(plain: torch.Tensor, with_grad: torch.Tensor, n: int):
    """Two means over ``n`` rows of this rank as means over the global batch
    (rows weighted by rank), the second with its gradient; as they are in one
    process."""
    if not collective_step():
        return plain, with_grad
    w = n / float(all_reduce_sum(torch.tensor(float(n), device=plain.device)))
    return all_reduce_sum(plain * w), all_reduce_mean_with_grad(with_grad * w) * world_size()


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """``tensors`` in order, in lists of up to ``BUCKET_ELEMS`` elements (a
    larger tensor alone)."""
    buckets: List[List[torch.Tensor]] = [[]]
    size = 0
    for t in tensors:
        if size and size + t.numel() > BUCKET_ELEMS:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel()
    return [b for b in buckets if b]


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> int:
    """Average ``tensors`` over ranks in place, through flat fp32 buckets of
    up to ``BUCKET_ELEMS`` elements; returns the bytes reduced.  Runs whenever
    a process group is set, also at one rank (the launcher's path)."""
    if not is_initialized():
        return 0
    world, nbytes = world_size(), 0
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat)
        flat /= world
        nbytes += flat.numel() * 4
        for t, part in zip(bucket, torch.split(flat, [t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return nbytes


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def reduce_scatter_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """This rank's dim-0 block of each tensor (dim 0 divisible by the ranks),
    averaged over ranks in fp32: rows ``[r * n / W, (r + 1) * n / W)`` of a
    tensor of n rows at rank r.  Needs a process group."""
    world, r = world_size(), rank()
    out: List[torch.Tensor] = []
    for bucket in _buckets(tensors):
        flat = torch.cat([t.float().reshape(world, -1) for t in bucket], dim=1)  # row w: rank w's blocks
        if _nccl():
            mine = flat.new_empty(flat.shape[1])
            dist.reduce_scatter_tensor(mine, flat.reshape(-1))
        else:
            dist.all_reduce(flat)
            mine = flat[r]
        mine /= world
        parts = torch.split(mine, [t.numel() // world for t in bucket])
        out += [p.view((t.shape[0] // world,) + tuple(t.shape[1:])) for t, p in zip(bucket, parts)]
    return out


def all_gather_blocks_(tensors: Sequence[torch.Tensor]) -> int:
    """Fill every rank's dim-0 block of each tensor (contiguous, dim 0
    divisible by the ranks) from that rank, in place: after it every rank holds
    the whole tensors.  The blocks travel in fp32 (exact for fp32 and bf16
    tensors).  Returns the bytes this rank receives."""
    world, r = world_size(), rank()
    nbytes = 0
    for bucket in _buckets(tensors):
        mine = torch.cat([t.reshape(world, -1)[r].float() for t in bucket])
        if _nccl():
            full = mine.new_empty(world * mine.numel())
            dist.all_gather_into_tensor(full, mine)
            full = full.view(world, -1)
        else:
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine)
            full = torch.stack(parts)
        nbytes += full.numel() * 4
        for t, cols in zip(bucket, torch.split(full, [t.numel() // world for t in bucket], dim=1)):
            t.view(world, -1).copy_(cols)
    return nbytes


def gather_blocks_(blocks: Sequence[torch.Tensor], wholes: Sequence[torch.Tensor]) -> int:
    """Gather every rank's dim-0 block of each tensor into rank 0's ``wholes``
    (contiguous, W times a block's rows), in place; the other ranks only send,
    and their ``wholes`` are not read.  The blocks travel in fp32 (exact for
    fp32 and bf16 tensors).  Returns the bytes rank 0 receives (0 elsewhere)."""
    world, first = world_size(), rank() == 0
    nbytes, dst = 0, iter(wholes)
    for bucket in _buckets(blocks):
        mine = torch.cat([b.reshape(-1).float() for b in bucket])
        parts = [torch.empty_like(mine) for _ in range(world)] if first else None
        dist.gather(mine, parts, dst=0)
        if first:
            full = torch.stack(parts)
            nbytes += full.numel() * 4
            for b, cols in zip(bucket, torch.split(full, [b.numel() for b in bucket], dim=1)):
                next(dst).view(world, -1).copy_(cols)
    return nbytes


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalars averaged over ranks, in one collective."""
    if world_size() == 1 or not values:
        return values
    stacked = torch.stack([v.float() for v in values.values()])
    dist.all_reduce(stacked)
    return dict(zip(values, stacked / world_size()))
