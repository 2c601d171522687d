"""Ranks on this host from Python: ``run_local(fn, world, *args)`` runs
``fn(*args)`` in ``world`` fresh processes with the environment that
``torch.distributed.run`` gives its ranks (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` at a free port; one CPU
thread each, as its ``OMP_NUM_THREADS=1``), and returns their results in rank
order.  ``fn`` joins the group itself
(``mesh.init_data_parallel``, or ``cli.train``'s ``main``).

A rank that fails fails the call: the others are killed (they may wait in a
collective for it) and its traceback is raised.  So does the time limit: past
``timeout`` seconds every rank is killed and ``TimeoutError`` raised, so a
deadlocked collective ends the call instead of hanging it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import random
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch


def free_port() -> int:
    """A port that binds now, below Linux's ephemeral range (32768-60999),
    where the host's outgoing connections take theirs."""
    rng = random.Random()
    for _ in range(100):
        port = rng.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in 20000-32767")


def _rank_main(fn: Callable, r: int, world: int, port: int, out: str, args: tuple) -> None:
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)  # as the launcher's OMP_NUM_THREADS=1: ranks share the host's cores
    try:
        result = fn(*args)
    except BaseException:
        with open(os.path.join(out, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        from valor_tpu_torch.parallel.mesh import shutdown

        shutdown()
    torch.save(result, os.path.join(out, f"rank{r}.pt"))


def run_local(fn: Callable, world: int, *args: Any, timeout: float = 300.0) -> List[Any]:
    """``fn(*args)``'s result on each of ``world`` ranks (``fn`` a module-level
    function, its arguments and result picklable).  A free port can be taken
    by another process between the probe and rank 0's listen: then the ranks
    start again on another port, up to three times."""
    for attempt in range(3):
        try:
            return _run_once(fn, world, args, timeout)
        except _PortTaken:
            if attempt == 2:
                raise


class _PortTaken(RuntimeError):
    pass


def _run_once(fn: Callable, world: int, args: tuple, timeout: float) -> List[Any]:
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="valor_ranks_") as out:
        port = free_port()
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, out, args)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(out, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise (_PortTaken if "EADDRINUSE" in "".join(errors) else RuntimeError)("\n".join(errors))
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]
