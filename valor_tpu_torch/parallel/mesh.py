"""The data axis across processes (counterpart of ``valor_tpu/parallel/mesh.py``).

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

The parameter axes (``make_mesh``): ``model_shards`` M splits the W ranks
into a (data, model) grid with ``model`` innermost, as the JAX package's
``make_mesh`` reshapes its devices: rank r is data rank r // M and model rank
r % M.  One ``torch.distributed`` group a data row (the M ranks of one data
rank: tensor parallelism's all-reduces) and one a model column (the W / M ranks
of one model rank: the data axis's collectives) are made in the same order on
every rank.  Batch shards, the loaders and random draws follow the data axis:
the M ranks of one data rank hold the same rows and make the same draws.
``parallel/partition.py`` places the parameters over both axes (tensor
parallelism over ``model``, ``fsdp`` over ``data``) and keeps the ZeRO-1 rule
of ``zero_optimizer``; MoE experts (``ops/moe.py``) and, with
``sequence_parallel``, the fusion sequence (``parallel/activations.py``) split
over ``model`` too.  The knob still to come, ``fusion_pipeline_stages``, is
read and ignored by one process and refused across processes
(``check_data_parallel``), naming the part of ROADMAP item 13 that will bring
it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
ZERO_MIN_ELEMS = 1 << 14  # smaller leaves stay whole on every rank (replication is cheaper)
MODEL_AXIS = "model"
LATER_PART = {  # knob -> the part of ROADMAP item 13 that brings it
    "fusion_pipeline_stages": "ROADMAP item 13e, pipeline parallelism",
}


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the group and, after ``make_mesh``, in the
    (data, model) grid: both ranks, both worlds and both groups (None: the
    default group, or no group)."""

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
    world: int
    data_group: Optional[object]
    model_group: Optional[object]


_GRID: Dict[tuple, _Grid] = {}  # (group's world, model_shards) -> its groups, made once
_CURRENT: list = [None]  # the grid of the last make_mesh, while the group lives


def make_mesh(model_shards: int, device) -> DataParallel:
    """The (data, model) grid of this process group with ``model_shards`` M
    ranks on the model axis (the counterpart of ``valor_tpu/parallel/mesh.py:
    make_mesh``): rank r is data rank r // M and model rank r % M.  Every rank
    calls it with the same M (it makes groups, a collective); one process, or
    M = 1, makes none.  ``ValueError`` where M does not divide the ranks.
    Returns this process's place in it, on ``device``."""
    world = world_size()
    if model_shards < 1 or world % model_shards:
        raise ValueError(f"model_shards {model_shards} does not divide the {world} ranks")
    if not is_initialized() or model_shards == 1:
        _CURRENT[0] = None
    else:
        key = (world, model_shards)
        if key not in _GRID:
            m = model_shards
            rows = [dist.new_group(list(range(d * m, (d + 1) * m))) for d in range(world // m)]
            cols = [dist.new_group(list(range(j, world, m))) for j in range(m)]
            r = rank()
            _GRID[key] = _Grid(m, world, cols[r % m], rows[r // m])
        _CURRENT[0] = _GRID[key]
    return DataParallel(rank(), world_size(), int(os.environ.get("LOCAL_RANK", rank())),
                        dist.get_backend() if is_initialized() else "none", torch.device(device),
                        data_rank(), data_world(), model_rank(), model_world(), data_group(), model_group())


def _grid() -> Optional[_Grid]:
    g = _CURRENT[0]
    return g if g is not None and is_initialized() and g.world == world_size() else None


def model_world() -> int:
    g = _grid()
    return g.model_shards if g is not None else 1


def model_rank() -> int:
    return rank() % model_world()


def data_world() -> int:
    return world_size() // model_world()


def data_rank() -> int:
    return rank() // model_world()


def data_group():
    """The process group of this rank's model column (the data axis); None,
    the default group, where there is no model axis."""
    g = _grid()
    return g.data_group if g is not None else None


def model_group():
    """The process group of this rank's data row (the model axis); None where
    there is no model axis."""
    g = _grid()
    return g.model_group if g is not None else None


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
                        data_group(), model_group())


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
    """A rank's rows of a global training batch (``world``: the data axis's ranks)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by the {world} ranks "
                         f"of the {DATA_AXIS!r} axis")
    return global_batch // world


def check_data_parallel(cfg, world: int) -> None:
    """Refuse, across processes, the mesh knobs still to come, each with the
    part of ROADMAP item 13 that will bring it, and a ``model_shards`` that
    does not divide the ranks (``ValueError``).  One process reads and ignores
    every mesh knob.  SCST, ``zero_optimizer``, ``fsdp``, ``model_shards``
    (with MoE experts too) and ``sequence_parallel`` run across processes."""
    if world <= 1:
        return
    knob = "fusion_pipeline_stages"
    if cfg.model.fusion_pipeline_stages > 0:
        raise NotImplementedError(f"{knob} across {world} processes: {LATER_PART[knob]}")
    m = cfg.train.model_shards
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
    """This rank's ``index`` of the ``rows`` rows of a global batch;
    ``collective``: the forward's losses reduce over ranks (a training step;
    an evaluation forward runs no collective, since ranks may hold different
    numbers of evaluation batches)."""

    rows: int
    index: slice
    collective: bool = False

    @property
    def local(self) -> int:
        return len(range(self.rows)[self.index])


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
    """The shard of a training step's batch across the data axis (None with
    one data rank): every rank holds the same number of rows, its rows of the
    global batch strided as the sampler's shards."""
    world = data_world()
    if world == 1:
        return None
    n = next(batch[k].shape[0] for k in _ROW_KEYS if batch.get(k) is not None)
    return BatchShard(n * world, slice(data_rank(), n * world, world), collective=True)


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
    """The shard of a QA step's tiled answer rows: the data ranks' rows
    (``counts``, ``n`` of them this rank's) concatenated in rank order."""
    off = sum(counts[: data_rank()])
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
    full = draw((s.rows * k,) + rest)
    return full.reshape((s.rows, k) + rest)[s.index].reshape(shape)
