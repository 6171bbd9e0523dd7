"""Run a function on d CPU ranks over gloo, each its own process.

The port's counterpart of the JAX package's forced host device count: a
world of d gloo ranks on this host, for ``entry.dryrun_multichip`` and
the tests. Ranks start with the ``spawn`` method, so each imports only
what the function it runs needs (torch and this package: a function sent
to the ranks must live in a module that imports no JAX). A ``World``
stays up and runs one task after another; every wait has a timeout, so a
rank that hangs in a collective fails the caller instead of blocking it,
and the world is then stopped.

    with World(8) as w:
        results = w.run(fn, *args)     # fn(*args) on every rank, by rank
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta


def _rank_main(rank: int, n: int, store: str, timeout: float, tasks,
               results) -> None:
    """A rank's loop: join the gloo world, then run tasks until None."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=timedelta(seconds=timeout))
        results.put((rank, True, None))
    except Exception:  # reported to the caller, which stops the world
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except Exception:  # reported to the caller, which stops the world
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank raised; the message holds its traceback."""


class World:
    """d gloo ranks in child processes (rank r runs ``fn`` with
    ``torch.distributed`` initialised as rank r of d)."""

    def __init__(self, n: int, timeout: float = 120.0):
        self.n = n
        self.timeout = timeout
        self._dir = tempfile.mkdtemp(prefix="kofft_world_")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, n, os.path.join(self._dir, "store"), timeout,
                  self._tasks[r], self._results), daemon=True)
            for r in range(n)]
        for p in self._procs:
            p.start()
        try:
            self._collect()
        except BaseException:
            self.close()
            raise

    def _collect(self) -> list:
        out = [None] * self.n
        deadline = time.monotonic() + self.timeout
        for _ in range(self.n):
            rank, ok, value = self._next(deadline)
            if not ok:
                self.close()
                raise RankError(f"rank {rank} of {self.n} raised:\n{value}")
            out[rank] = value
        return out

    def _next(self, deadline: float):
        """The next result; raises when a rank died or time ran out."""
        while True:
            try:
                return self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    why = (f"rank {dead[0]} exited" if dead else
                           f"a rank gave no result within {self.timeout} s")
                    raise RankError(f"{why} (world of {self.n}); the world "
                                    f"is stopped") from None

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results by rank. A
        rank that raises or exceeds the timeout stops the world and
        raises here."""
        if not self.alive:
            raise RuntimeError("the world is stopped")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect()

    def close(self) -> None:
        """Stop every rank (politely, then by force) and remove the
        store."""
        procs, self._procs = self._procs, []
        for p, q in zip(procs, self._tasks):
            if p.is_alive():
                q.put(None)
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run(fn, n: int, *args, timeout: float = 120.0, **kwargs) -> list:
    """``fn(*args, **kwargs)`` once on each of n fresh gloo ranks; the
    results by rank."""
    with World(n, timeout) as world:
        return world.run(fn, *args, **kwargs)
