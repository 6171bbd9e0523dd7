"""One run of one cell: set up, measure, check, and build the result line.

``run_cell`` does, in order: load the program through the cell's adapter;
make the cell's pool of inputs on the device from the seed; warm up the
cell's own shape (two passes over the pool, at least 16 calls); measure
for ``seconds`` through the cell's traffic loop; read the peak device
memory; free the program's state; compare a sample of the window's
answers, drawn from the seed, with the plain reference; and read the
cell's metrics. When ``trace`` is set, the window's first half runs as
an untraced one does, and the host-clock readers read it; the device is
drained and the second half runs under ``torch.profiler``, which the
device readers read.

Nothing here is specific to a configuration or a cell: those are files
that ``loader`` finds by name.
"""

from __future__ import annotations

import random
import sys
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from portbench import check, loader, readers
from portbench import trace as tracing

# top-level module names the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "kofft_tpu")


# timed event pairs a cell that asks for per-call latency cycles through
STAMP_RING = 256


@dataclass
class Run:
    """What the metric readers read: the untraced window's calls, and the
    traced window's reduction where there is one."""
    setup_s: float
    window_s: float
    calls: int
    units: int        # work units per call
    unit: str         # "points", "frames", ...
    bound_s: float    # the roofline's bound of one call
    entry_ns: np.ndarray
    latency_ms: np.ndarray | None  # per call, issue to done, device clock
    trace: tracing.Trace | None


def forbidden_modules() -> list:
    """Top-level names in sys.modules equal to a forbidden one (whole
    names: ``kofft_tpu_torch`` is not ``kofft_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def seeds(seed: int) -> tuple:
    """(the pool's seed, the answer sample's seed) derived from --seed."""
    if seed < 0:
        raise ValueError("--seed must be >= 0")
    s = np.random.SeedSequence(seed).generate_state(2, np.uint64)
    return int(s[0]) >> 1, int(s[1])


class _Reservoir:
    """A uniform sample of k calls of the window (reservoir sampling),
    holding each sampled call's input index and output."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def __call__(self, i, j, out):
        if i < self.k:
            self.kept.append((i, j, out))
        else:
            r = self.rng.randrange(i + 1)
            if r < self.k:
                self.kept[r] = (i, j, out)


class _HostEvent:
    """The CPU's stand-in for a device event: the work is done when the
    call returns, so a record is a reading of the host clock."""

    def record(self):
        self.t = time.perf_counter_ns()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e-6


def _device_hooks(device: str):
    """(make an event; timed or not, wait for the device)."""
    import torch
    if device == "cuda":
        return ((lambda timed: torch.cuda.Event(enable_timing=timed)),
                torch.cuda.synchronize)
    return (lambda timed: _HostEvent()), (lambda: None)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             log=print) -> dict:
    """One run of ``workload``: the result line as a dict, its ``checks``
    last. ``t_start`` is the process's start on ``time.perf_counter``."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = loader.load(root, workload)
    ad, cfg, tr = cell.adapter, cell.cfg, cell.traffic
    pool_seed, sample_seed = seeds(seed)
    call = ad.entry(cfg, tr)
    t_loaded = time.perf_counter()
    pool = ad.make_pool(cfg, tr, pool_seed, device)
    new_event, sync = _device_hooks(device)
    inflight = tr["inflight"]
    timed = bool(tr.get("latency"))
    ring = max(inflight, STAMP_RING) if timed else inflight
    events = [new_event(timed) for _ in range(ring)]
    starts = [new_event(True) for _ in range(ring)] if timed else None
    for e in events + (starts or []):
        e.record()

    def loop(**kw):
        return cell.loop.run(call, pool, inflight, events, sync,
                             starts=starts, **kw)

    t_pool = time.perf_counter()
    loop(calls=max(16, 2 * len(pool), ring + inflight))
    _program_counters(reset=True)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: program loaded at {t_loaded - t_start:.3f} s, pool made "
        f"in {t_pool - t_loaded:.3f} s, warm-up "
        f"{t_start + setup_s - t_pool:.3f} s")
    keep = _Reservoir(tr["check"]["samples"], sample_seed)
    summary = None
    host = loop(seconds=seconds / 2 if trace else seconds, keep=keep)
    rec = host
    if trace:
        offsets = tracing.clock_offsets()
        act = torch.profiler.ProfilerActivity
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        prof = torch.profiler.profile(
            activities=[act.CUDA if device == "cuda" else act.CPU])
        prof.start()
        n0 = host["calls"]
        rec = loop(seconds=seconds / 2,
                   keep=lambda i, j, out: keep(n0 + i, j, out))
        prof.stop()
        t0 = time.perf_counter()
        records = tracing.device_records(prof)
        off = tracing.pick_offset(records, rec["start"], rec["end"], offsets)
        summary = tracing.reduce(records, off, rec)
        log(f"trace: {summary.ops} device records, {summary.kernels} "
            f"kernels, offset {off} ns, read in "
            f"{time.perf_counter() - t0:.3f} s")
        del prof, records
    window_s = (host["end"] - host["start"]) * 1e-9
    attempted = host["calls"] + (rec["calls"] if trace else 0)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    log(f"program counters over the window: {_program_counters()}")

    # the program's state goes; the sampled answers stay for the check
    del pool, call, loop
    work = ad.work(cfg, tr)
    t0 = time.perf_counter()
    inputs = ad.make_pool(cfg, tr, pool_seed, device)
    readings = []
    for i, j, out in sorted(keep.kept, key=lambda x: x[0]):
        readings.append(check.errors(ad.answer(out),
                                     ad.expected(cfg, tr, inputs[j])))
    del inputs, keep
    correct, failed, checks = check.judge(readings, tr["check"]["limits"])
    log(f"check: {len(readings)} sampled answers of {attempted} calls "
        f"against the reference in {time.perf_counter() - t0:.3f} s")

    run = Run(setup_s=setup_s, window_s=window_s, calls=host["calls"],
              units=work["units"], unit=ad.UNIT, bound_s=work["bound_s"],
              entry_ns=np.diff(host["entry"], axis=1)[:, 0],
              latency_ms=host.get("latency_ms"), trace=summary)
    ends = host["entry"][:, 1] - host["start"]
    per_s = np.bincount((ends // 1_000_000_000).astype(np.int64))
    log(f"calls per second of the untraced window: {per_s.tolist()}")
    log(f"untraced window {window_s!r} s, {host['calls']} calls, host us "
        f"per call "
        f"{readers.host_us_per_call(run)!r}, bound {work['bound_s']!r} s "
        f"per call ({work['bound_by']})")
    metrics = {}
    for name, unit, read in (cell.per_layer if trace else cell.end_to_end):
        v = read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": unit}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = tracing.breakdown(summary)
    result["checks"] = checks
    return result


def _program_counters(reset: bool = False) -> dict:
    """The program's own route and launch counts since the last reset
    (printed, not metrics); ``reset`` sets them to 0."""
    hk = sys.modules.get("kofft_tpu_torch.ops.hopper_kernels")
    if hk is None:
        return {}
    if reset:
        hk.reset_counts()
        return {}
    return {k: v for d in (hk.classes, hk.launches) for k, v in d.items()
            if v}
