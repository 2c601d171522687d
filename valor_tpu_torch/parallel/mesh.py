"""The mesh across processes (counterpart of ``valor_tpu/parallel/mesh.py``).

The JAX package trains data-parallel over a device mesh: its loaders give each
process a shard of every global batch, XLA averages the gradients over the
``data`` axis, and every loss is computed over the global array.  The port runs
one process a card under a launcher (``python -m torch.distributed.run``), and
makes that arithmetic explicit:

  * ``init_data_parallel`` reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), takes the
    rank's device and joins the process group;
  * ``BatchShard`` says which rows of a step's global batch this rank holds.
    The loaders' ``ShardedBatchSampler`` gives rank r the items ``r::W`` of the
    order, so the global batch of a step is the batch one process takes from
    the same order, and rank r holds its rows r, r + W, r + 2W, ...  Random
    draws (dropout, token masks) are made at the global shape and this rank's
    rows taken (``draw_rows``): W ranks draw what one process draws;
  * the losses' normalisers and the contrastive gallery are global
    (``parallel/collectives.py``), and the gradients are averaged over ranks
    before the update (``train/step.py``).

The parameter axes (``make_mesh``): ``model_shards`` M and
``fusion_pipeline_stages`` P split the W ranks into a (data, model, pipe) grid
with ``pipe`` innermost, as the JAX package's ``make_mesh`` reshapes its
devices to (n_data, n_model, n_pipe): rank r is data rank r // (M P), model
rank (r // P) % M and pipe rank r % P.  One ``torch.distributed`` group a line
of each axis (a data row's M model ranks: tensor parallelism's all-reduces; a
(model, pipe) column's D data ranks: ``fsdp`` and ZeRO-1; a (data, model)
row's P pipe ranks: the pipeline's gathers) and one of every rank of one model
rank (the D P replicas of a parameter: the gradients' mean) are made in the
same order on every rank.  The M ranks of one data rank hold the same rows and
make the same draws.  The pipe axis acts on the batch as the JAX package's
``shard_batch`` does: where the global batch divides D P (``fold_pipe``), its
rows spread over data x pipe (the ``batch`` axis is the D P replicas: the
loaders, random draws, loss normalisers and evaluation gathers follow it), so
the towers and heads run on B / (D P) rows; otherwise the P ranks of one data
rank hold the same rows, as the model ranks do, and the ``batch`` axis is the
data axis.  ``parallel/partition.py`` places the parameters over the data and
model axes (tensor parallelism over ``model``, ``fsdp`` over ``data``) and
keeps the ZeRO-1 rule of ``zero_optimizer``; MoE experts (``ops/moe.py``) and,
with ``sequence_parallel``, the fusion sequence (``parallel/activations.py``)
split over ``model`` too; the fusion stack's layers split into stages over
``pipe`` (``parallel/pipeline.py``), every rank holding every layer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
ZERO_MIN_ELEMS = 1 << 14  # smaller leaves stay whole on every rank (replication is cheaper)
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
BATCH_AXIS = "batch"  # the ranks a step's rows spread over: data x pipe where the pipe folds, else data
REPLICA_AXIS = "replica"  # every rank of one model rank: the replicas whose gradients are averaged


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the group and, after ``make_mesh``, in the
    (data, model, pipe) grid: its ranks, the worlds and the groups of the data
    and model axes (None: the default group, or no group)."""

    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device
    data_rank: int = 0
    data_world: int = 1
    model_rank: int = 0
    model_world: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    pipe_world: int = 1
    batch_world: int = 1


def launched() -> bool:
    """Whether a launcher's environment is set: ``WORLD_SIZE`` above 1, or 1
    with the launcher's ``MASTER_ADDR`` (``torch.distributed.run`` with one
    process).  A bare ``WORLD_SIZE=1`` is one process."""
    world = os.environ.get("WORLD_SIZE")
    return world is not None and (int(world) > 1 or "MASTER_ADDR" in os.environ)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class _Grid:
    model_shards: int
    pipe_stages: int
    world: int
    groups: Dict[str, Optional[object]]  # axis -> this rank's group (None: the default group)
    fold_pipe: bool = True


_GRID: Dict[tuple, _Grid] = {}  # (world, model_shards, pipe_stages) -> its groups, made once
_CURRENT: list = [None]  # the grid of the last make_mesh, while the group lives


def _lines(world: int, m: int, p: int) -> Dict[str, List[List[int]]]:
    """Every line of each axis of the (data, model, pipe) grid, as global
    ranks in axis order (rank r is (r // (m p), (r // p) % m, r % p))."""
    d = world // (m * p)
    at = lambda i, j, k: (i * m + j) * p + k  # noqa: E731
    return {
        DATA_AXIS: [[at(i, j, k) for i in range(d)] for j in range(m) for k in range(p)],
        MODEL_AXIS: [[at(i, j, k) for j in range(m)] for i in range(d) for k in range(p)],
        PIPE_AXIS: [[at(i, j, k) for k in range(p)] for i in range(d) for j in range(m)],
        REPLICA_AXIS: [[at(i, j, k) for i in range(d) for k in range(p)] for j in range(m)],
    }


def make_mesh(model_shards: int, device, pipe_stages: int = 1, fold_pipe: bool = True) -> DataParallel:
    """The (data, model, pipe) grid of this process group with
    ``model_shards`` M ranks on the model axis and ``pipe_stages`` P on the
    pipe axis (the counterpart of ``valor_tpu/parallel/mesh.py:make_mesh``):
    rank r is data rank r // (M P), model rank (r // P) % M and pipe rank
    r % P.  ``fold_pipe``: the step's rows spread over data x pipe (the
    caller's global batches divide D P), else the pipe ranks of one data rank
    hold the same rows.  Every rank calls it with the same arguments (it makes
    groups, a collective); one process, or M = P = 1, makes none.
    ``ValueError`` where M P does not divide the ranks.  Returns this
    process's place in it, on ``device``."""
    world = world_size()
    if model_shards < 1 or pipe_stages < 1 or world % (model_shards * pipe_stages):
        what = f"model_shards {model_shards}" + (f" x pipe stages {pipe_stages}" if pipe_stages != 1 else "")
        raise ValueError(f"{what} does not divide the {world} ranks")
    if not is_initialized() or model_shards * pipe_stages == 1:
        _CURRENT[0] = None
    else:
        key = (world, model_shards, pipe_stages)
        if key not in _GRID:
            r = rank()
            groups: Dict[str, Optional[object]] = {}
            made: Dict[tuple, Optional[object]] = {tuple(range(world)): None}  # one group a set of ranks
            for axis, lines in _lines(world, model_shards, pipe_stages).items():
                for line in lines:
                    if tuple(line) not in made:
                        made[tuple(line)] = dist.new_group(line)
                    if r in line:
                        groups[axis] = made[tuple(line)]
            _GRID[key] = _Grid(model_shards, pipe_stages, world, groups)
        _CURRENT[0] = dataclasses.replace(_GRID[key], fold_pipe=bool(fold_pipe))
    return DataParallel(rank(), world_size(), int(os.environ.get("LOCAL_RANK", rank())),
                        dist.get_backend() if is_initialized() else "none", torch.device(device),
                        data_rank(), data_world(), model_rank(), model_world(), data_group(), model_group(),
                        pipe_world(), batch_world())


def _grid() -> Optional[_Grid]:
    g = _CURRENT[0]
    return g if g is not None and is_initialized() and g.world == world_size() else None


def model_world() -> int:
    g = _grid()
    return g.model_shards if g is not None else 1


def pipe_world() -> int:
    g = _grid()
    return g.pipe_stages if g is not None else 1


def model_rank() -> int:
    return (rank() // pipe_world()) % model_world()


def pipe_rank() -> int:
    return rank() % pipe_world()


def data_world() -> int:
    return world_size() // (model_world() * pipe_world())


def data_rank() -> int:
    return rank() // (model_world() * pipe_world())


def pipe_folds() -> bool:
    """Whether the step's rows spread over data x pipe (else the pipe ranks of
    one data rank hold the same rows)."""
    g = _grid()
    return g is not None and g.pipe_stages > 1 and g.fold_pipe


def batch_world() -> int:
    """The ranks a step's rows spread over (the ``batch`` axis)."""
    return data_world() * (pipe_world() if pipe_folds() else 1)


def batch_rank() -> int:
    return data_rank() * pipe_world() + pipe_rank() if pipe_folds() else data_rank()


def group(axis: str):
    """The process group of this rank's line of ``axis`` (None: the default
    group, which is that line where the axis spans every rank, or where there
    is no grid)."""
    g = _grid()
    if g is None:
        return None
    if axis == BATCH_AXIS:
        axis = REPLICA_AXIS if pipe_folds() else DATA_AXIS
    return g.groups[axis]


def data_group():
    """The process group of this rank's (model, pipe) column (the data axis);
    None, the default group, where there is no model or pipe axis."""
    return group(DATA_AXIS)


def model_group():
    """The process group of this rank's data row (the model axis); None where
    there is no model axis."""
    return group(MODEL_AXIS)


def global_rank(axis: str, index: int) -> int:
    """The global rank of member ``index`` of this rank's line of ``axis``."""
    grp = group(axis)
    return index if grp is None else dist.get_global_rank(grp, index)


def _rank_device(device, local_rank: int) -> torch.device:
    """``device`` as named; None or a bare "cuda" is card ``LOCAL_RANK``, or
    ``LOCAL_RANK`` modulo the cards where ranks outnumber them (gloo only)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_data_parallel(backend: Optional[str] = None, device=None) -> DataParallel:
    """Join the launcher's process group.  ``backend`` defaults to ``nccl`` on
    a card and ``gloo`` on the CPU; ``nccl`` where it cannot run (the CPU, no
    NCCL, two ranks on one card) raises: nothing switches backend by itself.
    Where the process has joined the group already (several runs in one
    launch), this rank's place in it is returned and the group is left as is."""
    joined = is_initialized()
    r = dist.get_rank() if joined else int(os.environ["RANK"])
    world = dist.get_world_size() if joined else int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", r))
    dev = _rank_device(device, local)
    if joined:
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"--dist_backend {backend}: the process group runs {dist.get_backend()}")
        backend = dist.get_backend()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"--dist_backend nccl needs a CUDA device, not {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("--dist_backend nccl: this torch has no NCCL")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"--dist_backend nccl: local rank {local} has no card of its own "
                f"({torch.cuda.device_count()} cards); NCCL refuses two ranks on one card, gloo shares it")
    elif backend != "gloo":
        raise ValueError(f"--dist_backend {backend!r}: nccl or gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not joined:
        dist.init_process_group(backend, rank=r, world_size=world)
    return DataParallel(r, world, local, backend, dev, data_rank(), data_world(), model_rank(), model_world(),
                        data_group(), model_group(), pipe_world(), batch_world())


def shutdown() -> None:
    """Leave the process group, where there is one (its grids go with it)."""
    if is_initialized():
        dist.destroy_process_group()
    _GRID.clear()
    _CURRENT[0] = None


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def local_batch_size(global_batch: int, world: int) -> int:
    """A rank's rows of a global training batch (``world``: the batch axis's ranks)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by the {world} ranks "
                         f"of the {BATCH_AXIS!r} axis")
    return global_batch // world


def check_data_parallel(cfg, world: int) -> None:
    """Refuse, across processes, a grid that does not fit the ranks: a
    ``model_shards`` M, times the ``fusion_pipeline_stages`` S where there are
    stages, that does not divide them (``ValueError``).  One process reads and
    ignores every mesh knob.  SCST, ``zero_optimizer``, ``fsdp``,
    ``model_shards`` (with MoE experts too), ``sequence_parallel`` and pipeline
    stages run across processes (MoE with stages is refused by the model,
    ``models/bert.py``, as the JAX package's)."""
    if world <= 1:
        return
    m, s = cfg.train.model_shards, cfg.model.fusion_pipeline_stages
    if s > 0 and (m < 1 or world % (m * s)):
        raise ValueError(f"fusion_pipeline_stages {s} x model_shards {m} does not divide the {world} ranks")
    if m < 1 or world % m:
        raise ValueError(f"model_shards {m} does not divide the {world} ranks")


def zero_sharded(shape, world: int) -> bool:
    """The JAX package's ZeRO-1 placement (``valor_tpu/parallel/partition.py:
    shard_opt_state``): a leaf of the optimizer state (a moment or the
    accumulated gradient of a parameter of ``shape``) is split on dim 0 over
    the data axis where it holds at least 2^14 elements and dim 0 divides by
    the ``world`` ranks; any other leaf stays whole on every rank.
    ``parallel/partition.py`` applies it to the leaves that neither tensor
    parallelism nor ``fsdp`` split."""
    return len(shape) >= 1 and shape[0] % world == 0 and math.prod(shape) >= ZERO_MIN_ELEMS


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's ``index`` of the ``rows`` rows of a global batch (a slice,
    or a tuple of rows: a pipeline microbatch's); ``collective``: the
    forward's losses reduce over ranks (a training step; an evaluation forward
    runs no collective, since ranks may hold different numbers of evaluation
    batches)."""

    rows: int
    index: Union[slice, Tuple[int, ...]]
    collective: bool = False

    def row_ids(self) -> List[int]:
        """The global rows this rank holds, in its order."""
        return list(range(self.rows)[self.index]) if isinstance(self.index, slice) else list(self.index)

    @property
    def local(self) -> int:
        return len(self.row_ids())


_SHARD = threading.local()  # .shard: the enclosing batch_shard's, per thread


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]) -> Iterator[Optional[BatchShard]]:
    """Make ``shard`` the rows that draws and losses see inside the block."""
    prev = getattr(_SHARD, "shard", None)
    _SHARD.shard = shard
    try:
        yield shard
    finally:
        _SHARD.shard = prev


def current_shard() -> Optional[BatchShard]:
    return getattr(_SHARD, "shard", None)


def collective_step() -> bool:
    """Whether the enclosing forward is a training step across ranks."""
    s = current_shard()
    return s is not None and s.collective


_ROW_KEYS = ("video_pixels", "audio_spectrograms", "audio_waveforms", "bert_tokens", "clip_tokens")


def step_shard(batch) -> Optional[BatchShard]:
    """The shard of a training step's batch across the batch axis (None with
    one rank there and no pipe axis): every rank holds the same number of
    rows, its rows of the global batch strided as the sampler's shards.  With
    a pipe axis the step is always collective, so that the fusion stack
    pipelines (``parallel/pipeline.py``)."""
    world = batch_world()
    if world == 1 and pipe_world() == 1:
        return None
    n = next(batch[k].shape[0] for k in _ROW_KEYS if batch.get(k) is not None)
    return BatchShard(n * world, slice(batch_rank(), n * world, world), collective=True)


def sampler_shard(sampler, k: int) -> Optional[BatchShard]:
    """The shard of evaluation batch ``k`` of a ``ShardedBatchSampler``
    (None for one shard or another loader): batch k of every shard together is
    the items ``[k b W, (k + 1) b W)`` of the order, the last one ragged."""
    w = getattr(sampler, "n_shards", 1)
    if w <= 1:
        return None
    span = sampler.batch_size * w
    rows = min(span, sampler.n_items - k * span)
    return BatchShard(rows, slice(sampler.shard, rows, w))


def answer_shard(n: int, counts: Sequence[int]) -> BatchShard:
    """The shard of a QA step's tiled answer rows: the batch axis's rows
    (``counts``, ``n`` of them this rank's) concatenated in rank order."""
    off = sum(counts[: batch_rank()])
    return BatchShard(sum(counts), slice(off, off + n), collective=True)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)``, or inside a ``batch_shard`` this rank's rows of
    ``draw`` at the global batch's shape: ``shape[0]`` is k rows a local row
    (rows first, as ``[B * frames, ...]`` is), and local row j's k rows are its
    global row's."""
    shape = tuple(shape)
    s = current_shard()
    if s is None:
        return draw(shape)
    n, rest = shape[0], shape[1:]
    if not s.local or n % s.local:
        raise ValueError(f"a draw of {n} rows in a shard of {s.local} rows")
    k = n // s.local
    full = draw((s.rows * k,) + rest).reshape((s.rows, k) + rest)
    index = s.index if isinstance(s.index, slice) else torch.tensor(s.index, device=full.device)
    return full[index].reshape(shape)
