"""Collectives of the mesh's axes (counterpart of ``valor_tpu/parallel/collectives.py``).

Every function takes the axis it reduces over, ``axis``: its process group is
this rank's line of that axis in ``parallel/mesh.py:make_mesh``'s grid, the
default group where the line holds every rank.  "batch" (the default of the
batch's arithmetic: its rows, losses and evaluation gathers) is data x pipe
where the pipe folds into the batch, else "data"; "replica" is every rank of
one model rank (the gradients' mean); "data" alone carries ``fsdp`` and
ZeRO-1, "model" tensor parallelism and "pipe" the pipeline's gathers.

Host objects and evaluation arrays (the JAX package's ``process_allgather``
uses): ``all_gather_objects``, ``all_gather_lists``, ``gather_arrays`` and
``all_gather_ragged``, which pads every rank's rows to the largest shard,
gathers and trims.  Every one of them short-circuits at one rank.

A training step's global arithmetic over the batch axis, which XLA derives
from the global array in the JAX package:

  * ``all_gather_with_grad``: the batch's rows from every rank; its backward
    gives this rank's slice of the gradient summed over ranks;
  * ``all_reduce_mean_with_grad``: the mean over ranks, and the mean of the
    gradient in the backward;
  * ``sharded_mean``: this rank's share of a mean over the global batch, so that
    the mean over ranks of every rank's loss is the global loss and the mean of
    their gradients its gradient;
  * ``all_reduce_mean_``: the gradients averaged over the replicas in fp32
    buckets;
  * ``mean_over_ranks``: the step's reported losses, as global values.

Tensor parallelism over the model axis (the Megatron pair, ``ops/layers.py``):
``copy_to_model`` (identity forward, all-reduce of the gradient backward) and
``reduce_from_model`` (all-reduce forward, identity backward), both through
``model_all_reduce_``.  ``fsdp`` over the data axis (``parallel/fsdp.py``):
``all_gather_dim`` (every rank's block of a tensor, concatenated on a dim)
and ``reduce_scatter_dim`` (this rank's block of the sum over ranks).

ZeRO-1 (``zero_optimizer``; ``train/optimizer.py``) splits a leaf on dim 0 into
one block a data rank, in rank order:

  * ``reduce_scatter_mean``: this rank's block of each tensor, averaged over
    ranks;
  * ``all_gather_blocks_``: every rank's block of each tensor, in place;
  * ``gather_blocks_``: every rank's block of each tensor into data rank 0's
    whole tensors (a checkpoint's optimizer state).

They go through flat fp32 buckets whose row w holds rank w's blocks.  NCCL
takes the tensor forms (``reduce_scatter_tensor``, ``all_gather_into_tensor``);
gloo has no reduce-scatter, so it all-reduces the bucket and keeps this rank's
row, and gathers through the list form of ``all_gather``.  Each element is the
same sum of the same values on both paths.  ``gather_blocks_`` takes
``dist.gather`` on both.

Pipeline parallelism over the pipe axis (``parallel/pipeline.py``):

  * ``pipe_all_gather``: the stack's input and side inputs, every pipe rank's
    rows (as many or not) concatenated in pipe order; backward, this rank's
    rows of the gradient summed over the pipe ranks (every stage reads the
    cross-attention memories, so each adds to their gradient);
  * ``pipe_hand_back``: the last stage's outputs, each pipe rank its rows (the
    JAX package's ``psum`` of the masked outputs, then a slice); backward,
    every pipe rank's output gradient collected at the last stage;
  * ``exchange``: one round of point-to-point sends and receives between
    neighbouring stages, all posted before any is waited on
    (``batch_isend_irecv``), so that no rank blocks in a send while its
    neighbour blocks in its own.  NCCL moves device tensors; gloo sends host
    tensors only, so a CUDA tensor goes through pinned host memory
    (``transport()`` names the path), and a CPU one as it is.  ``PIPE_STATS``
    counts the sends, the pipe collectives, their bytes and seconds.

The backend's own rules hold: NCCL reduces CUDA tensors only, gloo both.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.mesh import (
    BATCH_AXIS, DATA_AXIS, MODEL_AXIS, PIPE_AXIS, REPLICA_AXIS, collective_step, is_initialized,
)

BUCKET_ELEMS = 1 << 25  # fp32 elements a gradient bucket (128 MiB)


_AXES = {
    DATA_AXIS: (P.data_rank, P.data_world),
    MODEL_AXIS: (P.model_rank, P.model_world),
    PIPE_AXIS: (P.pipe_rank, P.pipe_world),
    BATCH_AXIS: (P.batch_rank, P.batch_world),
    REPLICA_AXIS: (lambda: P.data_rank() * P.pipe_world() + P.pipe_rank(),
                   lambda: P.data_world() * P.pipe_world()),
}


def _axis(axis: str):
    """(process group, this rank's index in it, its size) of ``axis``."""
    if axis not in _AXES:
        raise ValueError(f"axis {axis!r}: one of {sorted(_AXES)}")
    index, size = _AXES[axis]
    return P.group(axis), index(), size()


def process_count() -> int:
    return P.world_size()


def axis_size(axis: str = BATCH_AXIS) -> int:
    """The ranks of ``axis``."""
    return _axis(axis)[2]


def all_gather_objects(obj: Any, axis: str = BATCH_AXIS) -> List[Any]:
    """One picklable object a rank -> the list in rank order."""
    group, _, world = _axis(axis)
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather_lists(items: Sequence[Any], axis: str = BATCH_AXIS) -> List[Any]:
    """Every rank's list, concatenated in rank order."""
    return [x for chunk in all_gather_objects(list(items), axis) for x in chunk]


def all_gather_rows(items: Sequence[Any], shard) -> List[Any]:
    """This rank's items of a global batch (one a row of ``shard``, a
    ``parallel.mesh.BatchShard``; None in one process) gathered from every
    rank, in the global batch's row order."""
    if shard is None:
        return list(items)
    out: List[Any] = [None] * shard.rows
    rows = all_gather_lists(zip(shard.row_ids(), items))
    for i, x in rows:
        out[i] = x
    return out


def gather_arrays(x: torch.Tensor, axis: str = BATCH_AXIS) -> torch.Tensor:
    """A tensor of one shape on every rank, stacked in rank order."""
    group, _, world = _axis(axis)
    if world == 1:
        return x[None]
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def all_gather_ragged(x: torch.Tensor, axis: str = BATCH_AXIS) -> torch.Tensor:
    """Every rank's rows concatenated in rank order, where ranks hold
    different numbers of rows (ragged evaluation shards, an empty one
    included)."""
    if _axis(axis)[2] == 1:
        return x
    sizes = all_gather_objects(int(x.shape[0]), axis)
    pad = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
    pad[: x.shape[0]] = x
    gathered = gather_arrays(pad, axis)
    return torch.cat([gathered[i, :n] for i, n in enumerate(sizes)])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.rows, ctx.axis = x.shape[0], axis
        return gather_arrays(x, axis).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        group, r, _ = _axis(ctx.axis)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        return grad[r * ctx.rows : (r + 1) * ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, axis: str = BATCH_AXIS) -> torch.Tensor:
    """Every rank's rows (as many on each) concatenated in rank order; the
    gradient of this rank's rows is their gradient summed over every rank's
    loss."""
    return x if _axis(axis)[2] == 1 else _AllGather.apply(x, axis)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        group, _, world = _axis(axis)
        ctx.axis = axis
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / world

    @staticmethod
    def backward(ctx, grad):
        group, _, world = _axis(ctx.axis)
        grad = grad.clone()
        dist.all_reduce(grad, group=group)
        return grad / world, None


def all_reduce_mean_with_grad(x: torch.Tensor, axis: str = BATCH_AXIS) -> torch.Tensor:
    """The mean over ranks, with the gradient of every rank's loss."""
    return x if _axis(axis)[2] == 1 else _AllReduceMean.apply(x, axis)


def all_reduce_sum(x: torch.Tensor, axis: str = BATCH_AXIS) -> torch.Tensor:
    """The sum over ranks, outside autograd (counts)."""
    group, _, world = _axis(axis)
    x = x.detach().clone()
    if world > 1:
        dist.all_reduce(x, group=group)
    return x


def sharded_mean(total: torch.Tensor, count, axis: str = BATCH_AXIS) -> torch.Tensor:
    """``total / count`` (count at least 1).  In a training step across
    ranks, this rank's share of the mean over the global batch: ``world *
    total / (count summed over ranks)``, whose mean over ranks is the global
    mean."""
    count = torch.as_tensor(count, dtype=torch.float32, device=total.device)
    if not collective_step():
        return total / count.clamp_min(1.0)
    return _axis(axis)[2] * total / all_reduce_sum(count, axis).clamp_min(1.0)


def global_means(plain: torch.Tensor, with_grad: torch.Tensor, n: int, axis: str = BATCH_AXIS):
    """Two means over ``n`` rows of this rank as means over the global batch
    (rows weighted by rank), the second with its gradient; as they are in one
    process."""
    if not collective_step():
        return plain, with_grad
    w = n / float(all_reduce_sum(torch.tensor(float(n), device=plain.device), axis))
    return (all_reduce_sum(plain * w, axis),
            all_reduce_mean_with_grad(with_grad * w, axis) * _axis(axis)[2])


# -- tensor parallelism: the Megatron pair over the model axis -----------------

def model_all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the model axis in place (the pair's one collective)."""
    dist.all_reduce(x, group=P.model_group())
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce_(grad.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return model_all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel layer: ``x`` itself, its gradient summed
    over the model axis (each rank's heads or hidden units give a part)."""
    return _CopyToModel.apply(x) if P.model_world() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel layer: the partial products summed over
    the model axis; the gradient passes as it is."""
    return _ReduceFromModel.apply(x) if P.model_world() > 1 else x


# -- fsdp: a parameter's blocks over the data axis -----------------------------

def all_gather_dim(x: torch.Tensor, dim: int, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's block of a tensor (as large on each), concatenated on
    ``dim`` in rank order."""
    group, _, world = _axis(axis)
    x = x.contiguous()
    if _nccl():
        full = x.new_empty((world,) + tuple(x.shape))
        dist.all_gather_into_tensor(full, x, group=group)
        parts = list(full.unbind(0))
    else:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's block on ``dim`` of ``x`` summed over ranks (``dim``
    divisible by the ranks)."""
    group, r, world = _axis(axis)
    blocks = x.chunk(world, dim)
    if _nccl():
        flat = torch.stack([b.contiguous() for b in blocks])
        mine = flat.new_empty(flat.shape[1:])
        dist.reduce_scatter_tensor(mine, flat, group=group)
        return mine
    full = x.contiguous().clone()
    dist.all_reduce(full, group=group)
    return full.chunk(world, dim)[r].contiguous()


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


def all_reduce_mean_(tensors: Sequence[torch.Tensor], axis: str = REPLICA_AXIS, divide: int = 0) -> int:
    """Average ``tensors`` over ranks in place (or, with ``divide``, sum them
    and divide by it), through flat fp32 buckets of up to ``BUCKET_ELEMS``
    elements; returns the bytes reduced.  Runs whenever a process group is
    set, also at one rank (the launcher's path)."""
    if not is_initialized():
        return 0
    group, _, world = _axis(axis)
    nbytes = 0
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, group=group)
        flat /= divide or world
        nbytes += flat.numel() * 4
        for t, part in zip(bucket, torch.split(flat, [t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return nbytes


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def reduce_scatter_mean(tensors: Sequence[torch.Tensor], axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """This rank's dim-0 block of each tensor (dim 0 divisible by the ranks),
    averaged over ranks in fp32: rows ``[r * n / W, (r + 1) * n / W)`` of a
    tensor of n rows at rank r.  Needs a process group."""
    group, r, world = _axis(axis)
    out: List[torch.Tensor] = []
    for bucket in _buckets(tensors):
        flat = torch.cat([t.float().reshape(world, -1) for t in bucket], dim=1)  # row w: rank w's blocks
        if _nccl():
            mine = flat.new_empty(flat.shape[1])
            dist.reduce_scatter_tensor(mine, flat.reshape(-1), group=group)
        else:
            dist.all_reduce(flat, group=group)
            mine = flat[r]
        mine /= world
        parts = torch.split(mine, [t.numel() // world for t in bucket])
        out += [p.view((t.shape[0] // world,) + tuple(t.shape[1:])) for t, p in zip(bucket, parts)]
    return out


def all_gather_blocks_(tensors: Sequence[torch.Tensor], axis: str = DATA_AXIS) -> int:
    """Fill every rank's dim-0 block of each tensor (contiguous, dim 0
    divisible by the ranks) from that rank, in place: after it every rank holds
    the whole tensors.  The blocks travel in fp32 (exact for fp32 and bf16
    tensors).  Returns the bytes this rank receives."""
    group, r, world = _axis(axis)
    nbytes = 0
    for bucket in _buckets(tensors):
        mine = torch.cat([t.reshape(world, -1)[r].float() for t in bucket])
        if _nccl():
            full = mine.new_empty(world * mine.numel())
            dist.all_gather_into_tensor(full, mine, group=group)
            full = full.view(world, -1)
        else:
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine, group=group)
            full = torch.stack(parts)
        nbytes += full.numel() * 4
        for t, cols in zip(bucket, torch.split(full, [t.numel() // world for t in bucket], dim=1)):
            t.view(world, -1).copy_(cols)
    return nbytes


def gather_blocks_(blocks: Sequence[torch.Tensor], wholes: Sequence[torch.Tensor], axis: str = DATA_AXIS) -> int:
    """Gather every rank's dim-0 block of each tensor into the ``wholes`` of
    the axis's rank 0 (contiguous, W times a block's rows), in place; the other
    ranks only send, and their ``wholes`` are not read.  The blocks travel in
    fp32 (exact for fp32 and bf16 tensors).  Returns the bytes the axis's rank
    0 receives (0 elsewhere)."""
    group, r, world = _axis(axis)
    first = r == 0
    dst0 = dist.get_global_rank(group, 0) if group is not None else 0
    nbytes, dst = 0, iter(wholes)
    for bucket in _buckets(blocks):
        mine = torch.cat([b.reshape(-1).float() for b in bucket])
        parts = [torch.empty_like(mine) for _ in range(world)] if first else None
        dist.gather(mine, parts, dst=dst0, group=group)
        if first:
            full = torch.stack(parts)
            nbytes += full.numel() * 4
            for b, cols in zip(bucket, torch.split(full, [b.numel() for b in bucket], dim=1)):
                next(dst).view(world, -1).copy_(cols)
    return nbytes


def mean_over_ranks(values: Dict[str, torch.Tensor], axis: str = BATCH_AXIS) -> Dict[str, torch.Tensor]:
    """Scalars averaged over ranks, in one collective."""
    group, _, world = _axis(axis)
    if world == 1 or not values:
        return values
    stacked = torch.stack([v.float() for v in values.values()])
    dist.all_reduce(stacked, group=group)
    return dict(zip(values, stacked / world))


# -- pipeline parallelism over the pipe axis -----------------------------------

_STAT_KEYS = ("sends", "send_bytes", "send_s", "gathers", "gather_bytes", "gather_s",
              "hand_backs", "hand_back_bytes", "hand_back_s")
PIPE_STATS: Dict[str, float] = dict.fromkeys(_STAT_KEYS, 0)
_PINNED: Dict[Tuple, torch.Tensor] = {}  # (shape, dtype, slot) -> a pinned host buffer, reused


def reset_pipe_stats() -> None:
    """Start ``PIPE_STATS`` again at 0."""
    PIPE_STATS.update(dict.fromkeys(_STAT_KEYS, 0))


def _count(kind: str, nbytes: int, t0: float) -> None:
    PIPE_STATS[kind + "s"] += 1
    PIPE_STATS[kind + "_bytes"] += nbytes
    PIPE_STATS[kind + "_s"] += time.perf_counter() - t0


def transport(device) -> str:
    """How the point-to-point sends of a tensor on ``device`` travel: "nccl"
    (device to device), "gloo-pinned-host" (a CUDA tensor copied through
    pinned host memory: gloo sends host tensors only) or "gloo-host"."""
    if _nccl():
        return "nccl"
    return "gloo-pinned-host" if torch.device(device).type == "cuda" else "gloo-host"


def _pinned(shape, dtype, slot) -> torch.Tensor:
    key = (tuple(shape), dtype, slot)
    if key not in _PINNED:
        _PINNED[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
    return _PINNED[key]


def exchange(sends: Sequence[Tuple[torch.Tensor, int]], recvs: Sequence[Tuple[tuple, torch.dtype, int]],
             device, count: bool = True) -> List[torch.Tensor]:
    """One round of point-to-point traffic: each ``(tensor, dst)`` of
    ``sends`` to global rank dst, and a tensor of each ``(shape, dtype,
    src)`` of ``recvs`` from global rank src, all posted at once and then
    waited on; returns the received tensors on ``device``, in ``recvs``
    order.  ``count``: the sends are stage traffic (``PIPE_STATS``)."""
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    staged = transport(device) == "gloo-pinned-host"
    ops, bufs, nbytes = [], [], 0
    for i, (t, dst) in enumerate(sends):
        buf = t.detach().contiguous()
        if staged:
            buf = _pinned(buf.shape, buf.dtype, ("send", i)).copy_(buf)
        ops.append(dist.P2POp(dist.isend, buf, dst))
        nbytes += buf.numel() * buf.element_size()
    for i, (shape, dtype, src) in enumerate(recvs):
        buf = _pinned(shape, dtype, ("recv", i)) if staged else torch.empty(shape, dtype=dtype, device=device)
        ops.append(dist.P2POp(dist.irecv, buf, src))
        bufs.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [b.to(device, copy=True) if staged else b for b in bufs]
    if count:
        PIPE_STATS["sends"] += len(sends)
        PIPE_STATS["send_bytes"] += nbytes
        PIPE_STATS["send_s"] += time.perf_counter() - t0
    return out


class _PipeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes):
        t0 = time.perf_counter()
        group, r, world = _axis(PIPE_AXIS)
        ctx.sizes, ctx.rank = sizes, r
        pad = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
        pad[: x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in range(world)]
        dist.all_gather(parts, pad, group=group)
        out = torch.cat([part[:n] for part, n in zip(parts, sizes)])
        _count("gather", out.numel() * out.element_size(), t0)
        return out

    @staticmethod
    def backward(ctx, grad):
        t0 = time.perf_counter()
        group, _, _ = _axis(PIPE_AXIS)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        off = sum(ctx.sizes[: ctx.rank])
        _count("gather", grad.numel() * grad.element_size(), t0)
        return grad[off : off + ctx.sizes[ctx.rank]], None


def pipe_all_gather(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Every pipe rank's rows (``sizes[p]`` of them on pipe rank p)
    concatenated in pipe order; the gradient of this rank's rows is theirs
    summed over the pipe ranks."""
    return _PipeGather.apply(x, list(sizes))


class _HandBack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, spans):
        t0 = time.perf_counter()
        _, r, world = _axis(PIPE_AXIS)
        last = world - 1
        ctx.spans, ctx.rank, ctx.shape = spans, r, out.shape
        rest = tuple(out.shape[1:])
        if r == last:
            exchange([(out[a:b], P.global_rank(PIPE_AXIS, p)) for p, (a, b) in enumerate(spans) if p != last],
                     [], out.device, count=False)
            a, b = spans[last]
            mine = out[a:b].clone()
        else:
            a, b = spans[r]
            mine, = exchange([], [((b - a,) + rest, out.dtype, P.global_rank(PIPE_AXIS, last))], out.device,
                             count=False)
        _count("hand_back", mine.numel() * mine.element_size(), t0)
        return mine

    @staticmethod
    def backward(ctx, grad):
        t0 = time.perf_counter()
        _, r, world = _axis(PIPE_AXIS)
        last, spans = world - 1, ctx.spans
        grad = grad.contiguous()
        full = grad.new_zeros(ctx.shape)
        if r == last:
            others = [p for p in range(world) if p != last]
            got = exchange([], [((spans[p][1] - spans[p][0],) + tuple(ctx.shape[1:]), grad.dtype,
                                 P.global_rank(PIPE_AXIS, p)) for p in others], grad.device, count=False)
            for p, g in zip(others + [last], got + [grad]):
                full[spans[p][0] : spans[p][1]] += g
        else:
            exchange([(grad, P.global_rank(PIPE_AXIS, last))], [], grad.device, count=False)
        _count("hand_back", grad.numel() * grad.element_size(), t0)
        return full, None


def pipe_hand_back(out: torch.Tensor, spans: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The last stage's outputs ``out`` (whatever the other pipe ranks pass),
    rows ``spans[p]`` of them to pipe rank p; backward, every pipe rank's
    output gradient summed into the last stage's (the other ranks' input
    gradient is zeros)."""
    return _HandBack.apply(out, [tuple(s) for s in spans])
