"""Observability of the port: program spans and counters, profiler
traces, a persistent kernel build directory, and prewarming.

The counterpart of ``kofft_tpu.utils.observability``. Where the JAX
package keeps XLA's persistent compilation cache, the port keeps its
built kernel library: ``ops/_cuda_build.py`` names the library by a hash
of its sources and flags, so a later process that finds it in the build
directory loads it without running nvcc.

Spans. The host path of a call is cut into named spans where the work
happens: the public entries open a root span each (``fft_split``,
``ifft_split``, ``fft``, ``ifft``, ``rfft_split``, ``fftn_split``,
``stft_split``, ``istft_split``), and inside them ``ladder`` (backend
and zone choice, the kernel checks), ``route`` (the kernel route's class
and split, on the 2-D routes its class and the planes' reshapes; closed
before the launches), ``frame`` (the STFT's window, framing and
overlap-add), ``args`` (a launch's cached arguments), ``table`` (a cache
miss that builds a host table, a device copy or launch arguments),
``alloc`` (the port's own device buffers), ``launch`` (a native launch
and its check), ``tree`` (the plain PyTorch engines, the axis and stage
kernels' plain versions on CPU tensors among them) and ``cufft`` (the
``torch.fft`` branches). A span records its name, its start and end on
``time.perf_counter_ns``, the id of its parent and the id of its call:
every span under one root shares the root's call id, and a span opened
outside any other starts a call of its own. Each thread keeps its own
stack. Closing a span adds its duration to its parent's child time; the
per-name totals keep the count, the inclusive ns and the self ns (the
duration less its children's), and the last ``RING_RECORDS`` records are
kept in a ring. A call's totals join the process's when its root span
closes, so :func:`snapshot` holds whole calls.

Spans record only while they are on: while ``torch.profiler`` runs (the
profiler sets ``torch.autograd.profiler._is_profiler_enabled``) or while
an operator has switched them on with :class:`record_spans`. A call site
on the hot path tests the two flags and opens nothing when both are off::

    sp = begin("ladder") if _prof._is_profiler_enabled or _obs.switch \\
        else None
    ...
    if sp:
        end(sp)

The public entries and the ladders end their spans in ``finally``, and
ending a span also ends any span opened above it that an exception left
open.

Counters are plain integers, always on: ``counts`` (``table_builds``,
the cache misses that ran a builder; ``alloc_bytes``, the bytes of the
device buffers the port allocates itself, not those torch ops allocate)
and the groups registered with :func:`counter_group`
(``hopper_kernels.launches`` and ``classes``, ``goertzel.launches``).
Like ``launches``, they are exact for one thread; threads that count at
the same moment may lose an update. :func:`reset` zeroes every counter
and the span totals (``hopper_kernels.reset_counts`` calls it), and
:func:`snapshot` returns them as plain dicts::

    import sys
    obs = sys.modules["kofft_tpu_torch.utils.observability"]
    with obs.record_spans():
        kt.fft_split(xr, xi)
    obs.snapshot()["spans"]["ladder"]   # {"count", "incl_ns", "self_ns"}
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from pathlib import Path

from torch.autograd import profiler as _prof

# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

counts = {"table_builds": 0, "alloc_bytes": 0}
_GROUPS: dict = {}


def counter_group(name: str) -> dict:
    """The registered dict of counters ``name`` (made empty on first use):
    the caller adds its keys and counts into it; :func:`reset` zeroes it
    and :func:`snapshot` reports it under ``name``."""
    return _GROUPS.setdefault(name, {})


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

# the operator's switch (record_spans); spans are also on while the
# profiler runs
switch = False
# raw records kept, oldest dropped first (about 250 bytes each)
RING_RECORDS = 1 << 18

_ring: collections.deque = collections.deque(maxlen=RING_RECORDS)
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_calls = itertools.count()
_totals: dict = {}        # name -> [count, inclusive ns, self ns]
_roots = [0, 0, 0]        # the same over root spans
_clock = time.perf_counter_ns
# Chrome trace process id of the program's span track: no real pid
_TRACK_PID = 0x7FFFFFFE


def spans_on() -> bool:
    """Whether spans record now: the profiler runs, or the switch is on."""
    return _prof._is_profiler_enabled or switch


class record_spans:
    """Switch spans on (``record_spans()``) or off (``record_spans(False)``)
    for the process; as a context manager the switch returns to its
    previous state when the block ends."""

    def __init__(self, on: bool = True):
        global switch
        self._prev = switch
        switch = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global switch
        switch = self._prev


def _thread_state() -> tuple:
    """This thread's (span stack, totals of its open call, thread id)."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], {}, threading.get_native_id())
        return _local.state


def begin(name: str) -> list:
    """Open span ``name`` on this thread's stack and return it for
    :func:`end`. Records whether or not spans are on: the call site tests
    :func:`spans_on`'s flags first."""
    try:
        st = _local.state[0]
    except AttributeError:
        st = _thread_state()[0]
    if st:
        top = st[-1]
        sp = [name, 0, 0, next(_ids), top[3], top[5], len(st)]
    else:
        sp = [name, 0, 0, next(_ids), -1, next(_calls), 0]
    st.append(sp)
    sp[1] = _clock()
    return sp


def end(sp: list) -> None:
    """Close span ``sp``, and first any span still open above it. A span's
    totals go to its thread's totals of the call, which join the
    process's when the call's root span closes (one lock per call)."""
    t = _clock()
    st, pending, tid = _local.state
    depth = sp[6]
    if len(st) <= depth or st[depth] is not sp:
        return
    while len(st) > depth:
        name, start, child, sid, parent, call, _ = st.pop()
        dur = t - start
        tot = pending.get(name)
        if tot is None:
            tot = pending[name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - child
        _ring.append((sid, name, start, t, parent, call, tid))
        if st:
            st[-1][2] += dur
        else:
            _join(pending, dur, dur - child)


def _join(pending: dict, dur: int, own: int) -> None:
    """Add a finished call's totals to the process's."""
    with _lock:
        for name, (c, incl, own_ns) in pending.items():
            tot = _totals.get(name)
            if tot is None:
                _totals[name] = [c, incl, own_ns]
            else:
                tot[0] += c
                tot[1] += incl
                tot[2] += own_ns
        _roots[0] += 1
        _roots[1] += dur
        _roots[2] += own
    pending.clear()


def table_build(builder, *args):
    """Run a cache's ``builder`` on a miss: one count in
    ``counts["table_builds"]``, timed as a ``table`` span when spans are
    on."""
    counts["table_builds"] += 1
    if not (_prof._is_profiler_enabled or switch):
        return builder(*args)
    sp = begin("table")
    try:
        return builder(*args)
    finally:
        end(sp)


def reset() -> None:
    """Set every counter (``counts`` and the registered groups) and the
    span totals to 0. The ring of raw records is kept."""
    for d in (counts, *_GROUPS.values()):
        for k in d:
            d[k] = 0
    with _lock:
        _totals.clear()
        _roots[:] = [0, 0, 0]


def snapshot() -> dict:
    """The span totals since the last :func:`reset`, ``{"spans": {name:
    {"count", "incl_ns", "self_ns"}}, "roots": {"count", "incl_ns",
    "self_ns"}, "counters": {...}}``: ``roots`` sums the root spans alone,
    ``counters`` holds ``counts``' integers and each group's dict."""
    with _lock:
        spans = {k: {"count": c, "incl_ns": i, "self_ns": s}
                 for k, (c, i, s) in _totals.items()}
        roots = {"count": _roots[0], "incl_ns": _roots[1],
                 "self_ns": _roots[2]}
    counters = dict(counts)
    counters.update({g: dict(d) for g, d in _GROUPS.items()})
    return {"spans": spans, "roots": roots, "counters": counters}


def records() -> list:
    """The raw records in the ring, oldest first: (id, name, start ns, end
    ns, parent id or -1, call id, thread id), on ``perf_counter_ns``."""
    return list(_ring.copy())


# ---------------------------------------------------------------------------
# build directory, prewarming, profiler traces
# ---------------------------------------------------------------------------

def enable_compilation_cache(path: str | Path = "~/.cache/kofft_tpu_torch"
                             ) -> str:
    """Build (and look for) the port's kernel library and native host
    library in ``path`` from now on, so that later processes pointed at
    the same directory reuse them; returns the path. A library this
    process has loaded already stays loaded."""
    from ..ops import _cuda_build
    p = Path(path).expanduser()
    p.mkdir(parents=True, exist_ok=True)
    _cuda_build.BUILD_DIR = p
    return str(p)


def prewarm(sizes, batch_shape: tuple = (), rfft_sizes=(),
            ndfft_shapes=(), device="cuda"):
    """Build the kernels (on a CUDA ``device``) and run each given size
    once through the public entries (``fft_split``/``ifft_split``,
    ``fft``/``ifft``, ``rfft_split``, ``fftn_split`` both ways), so that
    their host tables and device copies exist before the first real call.
    Combine with :func:`enable_compilation_cache` to keep the build
    across processes."""
    import torch

    from .. import fft, fftn_split, fft_split, ifft, ifft_split, rfft_split
    from ..ops._complex import host_device

    dev = host_device(device)
    if dev.type == "cuda":
        from ..ops import _cuda_build
        _cuda_build.lib()
    for n in sizes:
        z = torch.zeros((*batch_shape, n), device=dev)
        fft_split(z, z)
        ifft_split(z, z)
        zc = torch.zeros((*batch_shape, n), dtype=torch.complex64,
                         device=dev)
        ifft(fft(zc))
    for n in rfft_sizes:
        rfft_split(torch.zeros((*batch_shape, n), device=dev))
    for shape in ndfft_shapes:
        z = torch.zeros(tuple(shape), device=dev)
        yr, yi = fftn_split(z, z)
        fftn_split(yr, yi, inverse=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _realtime_offset(samples: int = 8) -> int:
    """``time.time_ns()`` less ``perf_counter_ns()``, the tightest of a few
    back-to-back readings: the profiler stamps its events on the former."""
    best = None
    for _ in range(samples):
        a = _clock()
        c = time.time_ns()
        b = _clock()
        if best is None or b - a < best[0]:
            best = (b - a, c - (a + b) // 2)
    return best[1]


def _add_spans(path: Path, t0: int, t1: int) -> None:
    """Append the program's spans recorded between ``t0`` and ``t1``
    (``perf_counter_ns``) to the Chrome trace at ``path``: complete events
    on a track of their own, shifted onto the profiler's clock (its
    events' ``ts`` are µs of the realtime clock after
    ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    shift = _realtime_offset() - int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": _TRACK_PID,
                   "tid": 0, "args": {"name": "kofft_tpu_torch spans"}})
    for sid, name, s, e, parent, call, tid in records():
        if e < t0 or s > t1:
            continue
        events.append({"ph": "X", "cat": "kofft_tpu_torch", "name": name,
                       "pid": _TRACK_PID, "tid": tid,
                       "ts": (s + shift) / 1e3, "dur": (e - s) / 1e3,
                       "args": {"id": sid, "parent": parent,
                                "call": call}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """``torch.profiler`` trace of the block (CPU activity, and CUDA where
    a card is present), written as a Chrome trace JSON file into
    ``log_dir`` (default ``kofft_tpu_torch_trace`` in the temporary
    directory): ``with trace("/path/t"): run()``; open it in Perfetto or
    chrome://tracing. Spans are on while the profiler runs, and the
    program's spans of the block are written into the same file, on a
    track of their own (``kofft_tpu_torch spans``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    d = Path(log_dir if log_dir is not None else
             Path(tempfile.gettempdir()) / "kofft_tpu_torch_trace")
    d.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    t0 = _clock()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        t1 = _clock()
        path = d / f"kofft_tpu_torch.{os.getpid()}.{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        _add_spans(path, t0, t1)
