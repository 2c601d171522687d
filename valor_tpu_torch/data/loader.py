"""Multi-dataset mixing, sharding, and device prefetch (the PyTorch port's copy of
``valor_tpu/data/loader.py``).

  * MetaLoader (reference data/loader.py:75-124): per-step random task
    choice from a seeded python Random, the same seed and order as the JAX
    package's.
  * ShardedBatchSampler (utils/distributed.py:161-189): contiguous shard
    with drop-tail semantics; one process is shard 0 of 1 here.
  * DataLoader: threaded sample fetch, collate in a background thread, and
    with ``pin_memory`` the batch's arrays copied into pinned (page-locked)
    host tensors there, off the training thread.
  * DevicePrefetcher (PrefetchLoader, :154-212): one batch in flight to the
    CUDA card, copied on a side stream.
"""

from __future__ import annotations

import random
import threading
import queue as queue_mod
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


class ShardedBatchSampler:
    """Per-host strided shard (``order[shard::n_shards]`` — the reference's
    DistributedSampler_wopadding subsample, utils/distributed.py:185).

    Train (``shuffle=True``): every shard yields the SAME number of full
    batches — (n_items // n_shards) // batch_size, computed globally — so
    SPMD hosts stay in lockstep.  Eval (``shuffle=False``): every item is
    covered exactly once across shards; the final batch may be ragged and
    shard sizes may differ by one (multihost eval gathers per-host lists,
    so ragged shards are fine — dropping gallery items would silently
    clip retrieval metrics)."""

    def __init__(
        self,
        n_items: int,
        batch_size: int,
        shard: int = 0,
        n_shards: int = 1,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.n_items = n_items
        self.batch_size = batch_size
        self.shard = shard
        self.n_shards = n_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _my_items(self) -> List[int]:
        order = list(range(self.n_items))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        return order[self.shard :: self.n_shards]

    def __iter__(self) -> Iterator[List[int]]:
        mine = self._my_items()
        n_batches = len(self)
        for b in range(n_batches):
            yield mine[b * self.batch_size : (b + 1) * self.batch_size]

    def __len__(self) -> int:
        if self.shuffle:  # identical on every shard
            return (self.n_items // self.n_shards) // self.batch_size
        mine = self.n_items // self.n_shards + int(
            self.shard < self.n_items % self.n_shards
        )
        return -(-mine // self.batch_size)


class DataLoader:
    """Map-style loader: sampler -> dataset -> collate.

    ``n_workers`` threads fetch samples concurrently (the hot work — PIL's
    JPEG decode and resize, wav reads, numpy — releases the GIL, so threads
    scale like the reference's worker processes without pickling batches);
    two batches of sample futures stay in flight ahead of the consumer, and
    a background thread runs collate (and ``pin_batch`` with ``pin_memory``)
    and hands batches over a small queue.
    Replaces the reference's torch DataLoader(n_workers) fork pool
    (train_utils.py:423-486)."""

    def __init__(
        self,
        dataset,
        sampler: ShardedBatchSampler,
        collate_fn: Callable,
        n_workers: int = 0,
        prefetch_batches: int = 2,
        repeat: bool = False,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.n_workers = n_workers
        self.prefetch_batches = max(prefetch_batches, 1)
        self._stop = threading.Event()
        self._feeders: List[threading.Thread] = []
        # repeat=True: iterate epochs forever INSIDE one worker pool
        # (sampler epoch bumped for a fresh shuffle each pass).  Restarting
        # iteration from outside instead tears down the pool and drains the
        # prefetch pipeline every epoch — ruinous on small datasets (the
        # per-epoch refill gap is prefetch_batches * batch build time).
        self.repeat = repeat
        # pin in the producer thread: a non_blocking copy from pageable
        # memory is silently synchronous
        self.pin_memory = pin_memory

    def _collate(self, samples) -> Any:
        batch = self.collate_fn(samples)
        return pin_batch(batch) if self.pin_memory else batch

    def _batch_indices(self) -> Iterator[Any]:
        epoch = 0
        while True:
            yield from self.sampler
            if not self.repeat:
                return
            epoch += 1
            self.sampler.set_epoch(epoch)

    def _produce(self) -> Iterator[Any]:
        if self.n_workers <= 1:
            for batch_idx in self._batch_indices():
                yield self._collate([self.dataset[i] for i in batch_idx])
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.n_workers) as pool:
            it = self._batch_indices()
            pending: deque = deque()

            def submit():
                idx = next(it, None)
                if idx is not None:
                    pending.append([pool.submit(self.dataset.__getitem__, i) for i in idx])

            for _ in range(self.prefetch_batches):
                submit()
            while pending and not self._stop.is_set():
                futs = pending.popleft()
                submit()  # keep the pool fed while we block on results
                yield self._collate([f.result() for f in futs])

    def __iter__(self) -> Iterator[Any]:
        if self.n_workers <= 0:
            yield from self._produce()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=max(2, self.prefetch_batches))
        sentinel = object()

        def interruptible_put(item) -> bool:
            """Blocking put that aborts on close(); True if delivered.
            A repeat=True producer whose consumer walked away would
            otherwise park on q.put forever, leaking the worker pool and
            its decoded batches."""
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def work():
            try:
                for b in self._produce():
                    if not interruptible_put(b):
                        return
            finally:
                # the sentinel must use the SAME interruptible blocking
                # put: a full queue here usually means the consumer is
                # merely behind, and dropping the sentinel would leave it
                # blocked on q.get forever after draining (end of a
                # finite loader with a slow consumer)
                interruptible_put(sentinel)
        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._feeders.append(t)
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b

    def close(self):
        """Terminally stop background production.  repeat=True loaders
        never exhaust on their own; abandoning their iterator leaves the
        feeder thread parked on a full queue and the worker pool (plus
        ~prefetch_batches decoded batches) alive for the process
        lifetime.  Sweeps that build several loaders in one process
        (bench BENCH_DATA_SWEEP) must close each point before timing the
        next, or the leaked workers contaminate the measurement.

        Returns once the feeder threads and their worker pools have ended, so
        that a process which exits right after training (a rank under
        ``torch.distributed.run``) exits with no thread of the loader running."""
        self._stop.set()
        while self._feeders:
            self._feeders.pop().join()

    def __len__(self) -> int:
        return len(self.sampler)


class MetaLoader:
    """Random task mixing with a shared-seed synchronized choice."""

    def __init__(
        self,
        loaders: Dict[str, Tuple[Any, int]],
        accum_steps: int = 1,
        seed: int = 0,
        mix_type: str = "random",  # 'random' | 'accum' (round-robin)
    ):
        self.name2loader = {}
        self.name2iter = {}
        self.pool: List[str] = []
        for name, spec in loaders.items():
            loader, ratio = spec if isinstance(spec, tuple) else (spec, 1)
            self.name2loader[name] = loader
            self.name2iter[name] = iter(loader)
            self.pool.extend([name] * ratio)
        self.accum_steps = accum_steps
        self.rng = random.Random(seed)  # same seed on every host
        self.mix_type = mix_type
        self.step = 0
        self.epoch = 0
        self.names = list(self.name2loader)

    def _next_task(self) -> str:
        if self.mix_type == "accum":
            return self.names[(self.step // self.accum_steps) % len(self.names)]
        if self.step % self.accum_steps == 0:
            self._task = self.rng.choice(self.pool)
        return self._task

    def __iter__(self):
        while True:
            task = self._next_task()
            self.step += 1
            try:
                batch = next(self.name2iter[task])
            except StopIteration:
                self.epoch += 1
                self.name2loader[task].sampler.set_epoch(self.epoch)
                self.name2iter[task] = iter(self.name2loader[task])
                try:
                    batch = next(self.name2iter[task])
                except StopIteration:
                    # a fresh iterator yielding nothing means the per-host
                    # sampler is EMPTY ((n_items // n_hosts) // batch < 1);
                    # re-raising StopIteration inside this generator would
                    # surface as PEP-479 "RuntimeError: generator raised
                    # StopIteration" with no hint at the cause
                    raise ValueError(
                        f"train flow {task!r} yields no batches: the "
                        "dataset is smaller than one per-host batch "
                        "(shrink batch_size or the host count)"
                    ) from None
            yield task, batch




def pin_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch with every array as a pinned CPU tensor; lists and other host
    values stay as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor) and v.device.type == "cpu" and not v.is_pinned():
            v = v.pin_memory()
        out[k] = v
    return out


class DevicePrefetcher:
    """Keep one ``(task, batch)`` pair in flight to ``device`` (the
    PrefetchLoader equivalent).

    On a CUDA device each batch is pinned (unless the loader pinned it
    already), copied with ``non_blocking`` on a side stream while the caller
    computes on the current stream, and handed out only after the current
    stream waits on an event recorded behind the copies; ``record_stream``
    tells the caching allocator that the current stream uses the copies, so
    their memory is not reused while the step still reads it.  Arrays and
    tensors move; other values (id lists) stay on the host.  On the CPU there
    is nothing to overlap: batches pass as they are, one ahead.
    """

    def __init__(self, it: Iterator, device):
        self.it = iter(it)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._next = None
        self._advance()

    def _put(self, batch: Dict[str, Any]):
        if not self.cuda:
            return batch, None
        batch = pin_batch(batch)
        with torch.cuda.stream(self.stream):
            out = {k: v.to(self.device, non_blocking=True) if isinstance(v, torch.Tensor) else v
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def _advance(self) -> None:
        item = next(self.it, None)
        self._next = None if item is None else (item[0], *self._put(item[1]))

    def __iter__(self):
        while self._next is not None:
            task, batch, ready = self._next
            if ready is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(ready)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            self._advance()  # the next copy runs while the caller computes
            yield task, batch
