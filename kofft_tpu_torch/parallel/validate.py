"""Communication-volume audits over a log of the programs' collectives.

The counterpart of ``kofft_tpu.parallel.validate``. The JAX package
audits the compiled HLO; the port runs eagerly, so the sharded programs
report every collective they issue to the logs that ``comm_log()`` opens
(through ``ndfft_sharded._a2a`` and ``stft_sharded``'s halo exchange),
and the audits read those logs. Each rank keeps its own log: an
all_to_all's bytes are this rank's local share, as the HLO's result type
is one device's; a halo send is one (source, destination) pair, so the
pairs of a whole program are the sends of every rank's log.

``independent_sources`` is the number of all_to_alls a program issues
before its first ``wait()``: the re and im planes go as two collectives,
both issued before that wait, so the sequential programs count 2 and the
``overlap=K`` pipelines 2K (stage A's chunks), the figure of
``kofft_tpu``'s dependency audit of the HLO.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, NamedTuple, Optional, Union

__all__ = ["comm_log", "CommLog", "Collective",
           "fft_sharded_expected_a2a_bytes", "check_fft_sharded_comm_volume",
           "a2a_bytes_by_group_size", "send_bytes_by_tier"]


class Collective(NamedTuple):
    """One collective this rank issued."""
    kind: str           # "all_to_all", "send" or "recv"
    tier: str           # an all_to_all's mesh dimension; a halo's "ici",
                        # "dcn" or the flat mesh's axis name
    nbytes: int         # this rank's local bytes (its send or recv buffer)
    group_size: int
    in_flight: int      # collectives issued and not waited on, this one too


class CommLog:
    """The collectives of one rank, in the order it issued them."""

    def __init__(self) -> None:
        self.entries: list[Collective] = []
        self.first_wait: Optional[int] = None
        self._pending = 0

    def _issue(self, kind, tier, nbytes, group_size) -> None:
        self._pending += 1
        self.entries.append(Collective(kind, tier, int(nbytes), group_size,
                                       self._pending))

    def _wait(self) -> None:
        self._pending -= 1
        if self.first_wait is None:
            self.first_wait = len(self.entries)

    def a2a(self) -> list:
        return [e for e in self.entries if e.kind == "all_to_all"]

    def independent_sources(self) -> int:
        """All_to_alls issued before the first wait."""
        head = self.entries[:self.first_wait]
        return sum(e.kind == "all_to_all" for e in head)


_ACTIVE: list = []


@contextlib.contextmanager
def comm_log():
    """Record every collective the sharded programs issue in this process
    inside the block: ``with comm_log() as log: ...``."""
    log = CommLog()
    _ACTIVE.append(log)
    try:
        yield log
    finally:
        _ACTIVE.remove(log)


def _issued(kind: str, tier: str, nbytes: int, group_size: int) -> None:
    for log in _ACTIVE:
        log._issue(kind, tier, nbytes, group_size)


def _waited() -> None:
    for log in _ACTIVE:
        log._wait()


def a2a_bytes_by_group_size(log: CommLog) -> dict:
    """Local all_to_all bytes keyed by the group size, the counterpart of
    ``hlo_a2a_bytes_by_group_size``: on a (slice, chip) mesh the chip legs
    (ICI) have groups of ``chips_per_slice`` and the slice legs (DCN) of
    ``n_slices``."""
    out: dict = {}
    for e in log.a2a():
        out[e.group_size] = out.get(e.group_size, 0) + e.nbytes
    return out


def send_bytes_by_tier(logs: Union[CommLog, Iterable[CommLog]]) -> dict:
    """Halo bytes sent per tier, summed over the given logs (pass every
    rank's for a whole program), the counterpart of
    ``hlo_ppermute_bytes_by_tier``: one send is one (source, destination)
    pair of the JAX package's ppermutes."""
    logs = [logs] if isinstance(logs, CommLog) else list(logs)
    out = {"ici": 0, "dcn": 0}
    for log in logs:
        for e in log.entries:
            if e.kind == "send":
                out[e.tier] = out.get(e.tier, 0) + e.nbytes
    return out


def fft_sharded_expected_a2a_bytes(n: int, d: int,
                                   restore_layout: bool) -> int:
    """Canonical local volume of ``fft_sharded``: 2 all_to_alls (3 with
    layout restore), each over both (re, im) float32 planes of the local
    n/d-point shard."""
    steps = 3 if restore_layout else 2
    return steps * 2 * (n // d) * 4


def check_fft_sharded_comm_volume(n: int, mesh, axis_name: str = "d",
                                  restore_layout: bool = True,
                                  backend: str = "torch",
                                  overlap: int = 1) -> dict:
    """Run ``fft_sharded`` on n zeros (a collective: every rank of the mesh
    calls it) and check that this rank's log moves exactly the canonical
    all_to_all volume. Returns the report of ``kofft_tpu``'s audit (the
    same keys); raises AssertionError on a mismatch."""
    import torch

    from .fft_sharded import _split_for_mesh, fft_sharded
    from .mesh import _mesh_device

    d = mesh.size(mesh.mesh_dim_names.index(axis_name))
    split = _split_for_mesh(n, d)
    assert split is not None, f"n={n} does not factorize for d={d}"
    x = torch.zeros(n, dtype=torch.float32, device=_mesh_device(mesh))
    with comm_log() as log:
        fft_sharded(x, x, mesh=mesh, axis_name=axis_name, backend=backend,
                    restore_layout=restore_layout, overlap=overlap)
    got = sum(e.nbytes for e in log.a2a())
    want = fft_sharded_expected_a2a_bytes(n, d, restore_layout)
    assert got == want, (
        f"all_to_all local volume {got} B != canonical {want} B "
        f"(n={n}, d={d}, restore={restore_layout}, overlap={overlap})")
    return {"n": n, "d": d, "restore_layout": restore_layout,
            "overlap": overlap, "local_a2a_bytes": got,
            "cross_chip_bytes": got * (d - 1) // d,
            "total": len(log.a2a()),
            "independent_sources": log.independent_sources()}
