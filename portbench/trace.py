"""The traced run: ``torch.profiler`` over the window, reduced to numbers.

Only device activity is recorded (``ProfilerActivity.CUDA``): the kernels,
copies and fills the card ran, whoever launched them (the program's
kernels, cuFFT's, PyTorch's). The host spans are the benchmark's own
(``traffic``), on the host clock; the profiler stamps device records on a
host clock of its own, and ``clock_offsets`` with ``pick_offset`` find
which one, so that an idle gap on the device can be named by the span the
host had open meanwhile.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

# activity kinds of device records that are not work (ranges, markers)
_NOT_WORK = ("annotation", "range", "marker")


@dataclass
class Trace:
    """What the profiler saw in the window, in seconds."""
    window_s: float
    calls: int
    kernels: int
    ops: int
    busy_s: float
    op_sum_s: float
    by_name: dict = field(default_factory=dict)
    idle_by_span: dict = field(default_factory=dict)


def clock_offsets(samples: int = 8) -> dict:
    """Offsets from ``time.perf_counter_ns`` to the clocks the profiler
    may stamp with, each the tightest of a few back-to-back readings."""
    out = {}
    for name, fn in (("realtime", time.time_ns),
                     ("monotonic", time.monotonic_ns)):
        best = None
        for _ in range(samples):
            a = time.perf_counter_ns()
            c = fn()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, c - (a + b) // 2)
        out[name] = best[1]
    return out


def device_records(prof) -> list:
    """(name, start ns, duration ns, kind) of every device record that is
    work, from a stopped ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != cuda
                or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        name = e.name()
        kind = _kind(e, name)
        if any(w in kind for w in _NOT_WORK):
            continue
        out.append((name, e.start_ns(), e.duration_ns(), kind))
    return out


def _kind(e, name: str) -> str:
    """The record's activity kind; PyTorch builds whose events do not
    give it name copies and fills as the profiler does."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def pick_offset(records: list, start: int, end: int, offsets: dict) -> int:
    """The offset under which most device records start inside the
    window [start, end] (host-clock ns)."""
    if not records:
        return 0
    starts = np.fromiter((r[1] for r in records), np.int64, len(records))

    def inside(off):
        return int(np.count_nonzero((starts >= start + off)
                                    & (starts <= end + off)))
    return max(offsets.values(), key=inside)


def _union(starts: np.ndarray, ends: np.ndarray):
    """Sorted disjoint intervals covering the given ones."""
    if starts.size == 0:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    reach = np.maximum.accumulate(e)
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], reach[last]


def _covered(gs: np.ndarray, ge: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Total length of the disjoint sorted intervals [gs, ge] that lies
    inside the intervals [a, b]."""
    if gs.size == 0 or a.size == 0:
        return 0
    cum = np.concatenate(([0], np.cumsum(ge - gs)))

    def upto(t):
        i = np.searchsorted(gs, t, side="right") - 1
        ic = np.clip(i, 0, None)
        part = np.clip(np.minimum(t, ge[ic]) - gs[ic], 0, None)
        return np.where(i < 0, 0, cum[ic] + part)
    return int(np.sum(upto(b) - upto(a)))


def reduce(records: list, offset: int, loop: dict) -> Trace:
    """Reduce device records (profiler clock) and the loop's host spans
    (host clock, ``offset`` between the two) over the window. The profiler
    runs from just before the window's first call to after its final
    synchronise, so every record is the window's; the busy intervals are
    clipped to the window, since the two clocks agree to microseconds
    only."""
    w0, w1 = loop["start"] + offset, loop["end"] + offset
    starts = np.fromiter((r[1] for r in records), np.int64, len(records))
    durs = np.fromiter((r[2] for r in records), np.int64, len(records))
    by_name = {}
    for name, _, d, _ in records:
        by_name[name] = by_name.get(name, 0) + d
    cs = np.clip(starts, w0, w1)
    ce = np.clip(starts + durs, w0, w1)
    bs, be = _union(cs[ce > cs], ce[ce > cs])
    busy = int(np.sum(be - bs)) if bs.size else 0
    # idle gaps: the window less the busy intervals
    gs = np.concatenate(([w0], be))
    ge = np.concatenate((bs, [w1]))
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    idle = {}
    for span in ("pick_input", "wait_event", "entry"):
        iv = loop[span] + offset
        idle[span] = _covered(gs, ge, iv[:, 0], iv[:, 1])
    s0, s1 = loop["sync"]
    idle["sync"] = _covered(gs, ge, np.array([s0 + offset]),
                            np.array([s1 + offset]))
    idle["between spans"] = int(np.sum(ge - gs)) - sum(idle.values())
    return Trace(window_s=(w1 - w0) * 1e-9, calls=loop["calls"],
                 kernels=sum(1 for r in records if r[3] == "kernel"),
                 ops=len(records), busy_s=busy * 1e-9,
                 op_sum_s=int(durs.sum()) * 1e-9,
                 by_name={k: v * 1e-9 for k, v in by_name.items()},
                 idle_by_span={k: v * 1e-9 for k, v in idle.items()})


def breakdown(t: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the idle time by the host span open meanwhile."""
    ops = sorted(t.by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(t.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
