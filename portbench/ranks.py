"""A cell on more than one card: one rank per card, each its own process.

``launch`` starts the ranks with the ``spawn`` method, so that none
inherits a CUDA context, and waits for them. Rank r binds card r, joins
the default process group of all ranks (NCCL on the card, gloo on the
CPU) and a gloo group of the same ranks for the harness's control
messages, both over a TCP store on localhost that the launcher serves.
Before the adapter's entry is called the group is up and the rank's card
is current; rank 0 builds the program's kernel library while the others
wait at a control barrier, so no two ranks compile into the same files.
Then every rank runs ``harness.run_cell`` with its ``Group``, and rank 0
hands the result back.

Every wait has a deadline: the collectives and control messages the
groups' timeout, the library's build a barrier of its own, and the whole
run the launcher's ``deadline_s``. If a rank raises, exits non-zero or
outlives the deadline, the launcher stops every rank and raises
``RankFailed``; a rank that finds its card missing, or the card of
another rank, raises ``Refused``. A rank whose launcher is gone exits.
On the CPU (``device="cpu"``, the tests) each rank is a device of its
own.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import threading
import time
import traceback
from datetime import timedelta
from multiprocessing import connection
from pathlib import Path

# seconds: the whole run (a checkout's first run builds the library), the
# build's barrier, and every collective and control message
DEADLINE_S = 1150.0
BUILD_S = 900.0
TIMEOUT_S = 300.0


class Refused(RuntimeError):
    """The ranks did not get distinct cards that torch can see."""


class RankFailed(RuntimeError):
    """A rank raised, exited non-zero or outlived its deadline."""


class Group:
    """What ``harness.run_cell`` needs of the other ranks: this rank's
    place, the cards the ranks run on, and the control messages, which go
    over the gloo group ``ctrl`` with a deadline each."""

    def __init__(self, rank: int, size: int, ctrl, cards: list):
        self.rank, self.size, self.ctrl = rank, size, ctrl
        self.timeout = timedelta(seconds=TIMEOUT_S)
        self.kind = cards[0]["name"]
        self.count = len({c["id"] for c in cards})

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.monitored_barrier(self.ctrl, timeout=self.timeout)

    def synced(self, sync):
        """``sync``, which waits for this rank's card, then a barrier: the
        card of every rank has finished."""
        def both():
            sync()
            self.barrier()
        return both

    def broadcast(self, value):
        """Rank 0's ``value`` on every rank."""
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.ctrl)
        return box[0]

    def gather(self, value) -> list | None:
        """Every rank's ``value`` by rank on rank 0; None on the others."""
        import torch.distributed as dist
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(value, out, dst=0, group=self.ctrl)
        return out


def _card(device: str, rank: int) -> dict:
    """This rank's device: its index, name and an id that tells cards
    apart (the card's UUID, else its PCI address)."""
    if device != "cuda":
        return {"index": rank, "name": "cpu", "id": f"cpu rank {rank}"}
    import torch
    i = torch.cuda.current_device()
    p = torch.cuda.get_device_properties(i)
    uid = getattr(p, "uuid", None)
    if uid is None:
        uid = "pci " + ":".join(str(getattr(p, k, "?")) for k in
                                ("pci_domain_id", "pci_bus_id",
                                 "pci_device_id"))
    return {"index": i, "name": torch.cuda.get_device_name(i),
            "id": str(uid)}


def _exit_with_parent() -> None:
    """Exit when the launcher's process is gone, however it ended."""
    parent = mp.parent_process()
    if parent is None:
        return

    def watch():
        connection.wait([parent.sentinel])
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _join(rank: int, size: int, port: int, device: str):
    """Bind this rank's card and join the default and control groups;
    the cards of every rank, by rank."""
    import torch
    import torch.distributed as dist
    # the ranks share the host's cores: a share each, one on the CPU,
    # where every rank computes on them
    torch.set_num_threads(1 if device != "cuda"
                          else max(1, (os.cpu_count() or 1) // size))
    timeout = timedelta(seconds=TIMEOUT_S)
    kw = {}
    if device == "cuda":
        # the ranks share one host: NCCL's bootstrap stays on loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        seen = torch.cuda.device_count()
        if rank >= seen:
            raise Refused(f"rank {rank} needs card {rank}; torch sees {seen}")
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    store = dist.TCPStore("127.0.0.1", port, None, False, timeout=timeout)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=store, rank=rank, world_size=size,
                            timeout=timeout, **kw)
    ctrl = dist.new_group(backend="gloo", timeout=timeout)
    cards = [None] * size
    dist.all_gather_object(cards, _card(device, rank), group=ctrl)
    _check_cards(cards)
    return ctrl, cards


def _check_cards(cards: list) -> None:
    """Refuse ranks that share a card; fail on cards of two kinds."""
    ids = [c["id"] for c in cards]
    if len(set(ids)) != len(ids):
        raise Refused(f"{len(ids)} ranks on {len(set(ids))} distinct "
                      f"devices: {ids}")
    names = {c["name"] for c in cards}
    if len(names) != 1:
        raise RuntimeError(f"the ranks' cards differ: {sorted(names)}")


def _rank_main(rank: int, size: int, port: int, job: dict, results) -> None:
    """One rank: join, build (rank 0), run the cell, hand back rank 0's
    result and every rank's forbidden modules."""
    _exit_with_parent()

    def log(*a):
        # one write a line, so that the ranks' lines do not interleave
        sys.stderr.write(" ".join([f"[rank {rank}]", *map(str, a)]) + "\n")
        sys.stderr.flush()
    try:
        import torch.distributed as dist
        from portbench import harness
        device = job["device"]
        ctrl, cards = _join(rank, size, port, device)
        log(f"card {cards[rank]['index']} ({cards[rank]['name']}, "
            f"{cards[rank]['id']}), pid {os.getpid()}, joined at "
            f"{time.perf_counter() - job['t_start']:.3f} s")
        if device == "cuda":
            # every rank imports the program at once; rank 0 builds
            from kofft_tpu_torch.ops import _cuda_build
            if rank == 0:
                _cuda_build.lib()
                log(f"kernel library: built in "
                    f"{_cuda_build.build_info['seconds']} s (0.0: found "
                    f"built), {_cuda_build.build_info['path']}")
            dist.monitored_barrier(ctrl, timeout=timedelta(seconds=BUILD_S))
            log(f"library ready at "
                f"{time.perf_counter() - job['t_start']:.3f} s")
        group = Group(rank, size, ctrl, cards)
        result = harness.run_cell(job["root"], job["workload"], job["seed"],
                                  job["seconds"], job["trace"], device,
                                  job["t_start"], log, group=group)
        found = group.gather(harness.forbidden_modules())
        if rank == 0:
            results.put(("result", rank,
                         (result, sorted(set().union(*found)))))
        else:
            results.put(("done", rank, None))
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        dist.destroy_process_group()
    except Refused as e:
        log(f"refused: {e}")
        results.put(("refused", rank, str(e)))
        sys.exit(2)
    except Exception:  # reported to the launcher, which stops every rank
        log(traceback.format_exc())
        results.put(("error", rank, traceback.format_exc()))
        sys.exit(1)


def _stop(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def launch(root: Path, workload: str, seed: int, seconds: float,
           trace: bool, device: str, chips: int, t_start: float, log,
           deadline_s: float = DEADLINE_S) -> tuple:
    """Run ``workload`` on ``chips`` ranks, rank r on card r: (rank 0's
    result, the forbidden modules any rank held). Raises ``Refused`` or
    ``RankFailed``; every rank has ended when it returns or raises."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          timeout=timedelta(seconds=TIMEOUT_S),
                          wait_for_workers=False)
    job = {"root": str(root), "workload": workload, "seed": seed,
           "seconds": seconds, "trace": trace, "device": device,
           "t_start": t_start}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank {r}", daemon=True,
                         args=(r, chips, store.port, job, results))
             for r in range(chips)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        log(f"{chips} ranks, pids {[p.pid for p in procs]}, store on "
            f"localhost:{store.port}, deadline {deadline_s} s, started at "
            f"{time.perf_counter() - t_start:.3f} s")
        got = {}
        while len(got) < chips:
            try:
                kind, rank, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    r, code = dead[0]
                    # a refused rank exits 2, maybe before its word arrives
                    if code == 2:
                        raise Refused(f"rank {r} was refused: see its log")
                    raise RankFailed(f"rank {r} exited with code {code}")
                if time.monotonic() > end:
                    late = sorted(set(range(chips)) - set(got))
                    raise RankFailed(f"ranks {late} gave nothing within "
                                     f"{deadline_s} s") from None
                continue
            if kind == "refused":
                raise Refused(f"rank {rank}: {value}")
            if kind == "error":
                raise RankFailed(f"rank {rank} raised:\n{value}")
            got[rank] = value
        for r, p in enumerate(procs):
            p.join(max(0.0, end - time.monotonic()))
            if p.exitcode != 0:
                raise RankFailed(f"rank {r} ended with code {p.exitcode}"
                                 if p.exitcode is not None else
                                 f"rank {r} did not end within "
                                 f"{deadline_s} s")
        return got[0]
    finally:
        _stop(procs)
