"""The closed loop: one caller, ``inflight`` calls outstanding at most.

The caller takes its inputs in turn from the pool. Before issuing call i
it waits on the device event of call i - inflight: ``inflight = 1`` is a
caller that acts on each result before it sends the next block,
``inflight = 2`` a double-buffered pipeline. When the window's time is up
it issues no more calls and waits for all of them (the ``sync`` span); the
window ends when they are done.

The host spans of every call are kept in memory as host-clock
nanoseconds: ``pick_input``, ``wait_event`` and ``entry`` (issue to
return, with no synchronise), and the one ``sync`` at the end. Where the
caller is given start events too, each call is stamped on the device
before it is issued and after its work, and the stamps of a call are read
in ``wait_event`` once it is done: its latency from issue to result.
"""

from __future__ import annotations

import time

import numpy as np

SPANS = ("pick_input", "wait_event", "entry")


def run(call, pool: list, inflight: int, events: list, sync, *,
        starts: list | None = None, seconds: float | None = None,
        calls: int | None = None, keep=None,
        clock=time.perf_counter_ns) -> dict:
    """Drive ``call`` over ``pool`` for ``seconds`` of host time, or for
    ``calls`` calls. ``events`` is a ring of at least ``inflight`` objects
    with ``record()`` and ``synchronize()`` (device events): call i
    records ``events[i % len(events)]``. ``starts``, if given, is a ring
    of as many timed events, recorded before each call, whose
    ``elapsed_time(end)`` in ms is each call's latency. ``sync()`` waits
    for the device. ``keep(i, j, out)`` sees each call's index, its
    input's index in the pool and its output. Returns the window's start
    and end, every call's span boundaries (numpy int64 ns) and, with
    ``starts``, every call's latency (numpy float64 ms)."""
    ring = len(events)
    if inflight < 1 or ring < inflight:
        raise ValueError("an event per call in flight at least, "
                         "inflight >= 1")
    if starts is not None and len(starts) != ring:
        raise ValueError("one start event per end event")
    if (seconds is None) == (calls is None):
        raise ValueError("give the window in seconds or in calls")
    stop = None if seconds is None else int(seconds * 1e9)
    npool = len(pool)
    marks = []
    lat = []
    t_start = clock()
    i = 0
    while True:
        t0 = clock()
        j = i % npool
        inp = pool[j]
        t1 = clock()
        if i >= inflight:
            events[(i - inflight) % ring].synchronize()
        if starts is not None and i >= ring:
            lat.append(starts[i % ring].elapsed_time(events[i % ring]))
        t2 = clock()
        if starts is not None:
            starts[i % ring].record()
        out = call(inp)
        t3 = clock()
        events[i % ring].record()
        if keep is not None:
            keep(i, j, out)
        marks.append((t0, t1, t2, t3))
        i += 1
        if calls is not None and i >= calls:
            break
        if stop is not None and t3 - t_start >= stop:
            break
    t_sync = clock()
    sync()
    t_end = clock()
    if starts is not None:
        lat.extend(starts[k % ring].elapsed_time(events[k % ring])
                   for k in range(max(0, i - ring), i))
    m = np.asarray(marks, dtype=np.int64).reshape(-1, 4)
    return {"start": t_start, "end": t_end, "sync": (t_sync, t_end),
            "calls": len(marks),
            "pick_input": m[:, 0:2], "wait_event": m[:, 1:3],
            "entry": m[:, 2:4],
            "latency_ms": (None if starts is None
                           else np.asarray(lat, dtype=np.float64))}
