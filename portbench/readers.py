"""Readers of the metrics, shared by the files under ``metrics/``.

A reader takes the run (``harness.Run``) and returns the metric's value,
or None where the run has nothing to read, in which case the harness
leaves the metric out of the result line. A share of a roofline is never
given as 0 for want of records.
"""

from __future__ import annotations

import numpy as np


def setup_s(run):
    return run.setup_s


def rate(unit: str):
    """Units of the calls issued over the window, per second of it."""
    def read(run):
        if run.unit != unit:
            return None
        return run.calls * run.units / run.window_s
    return read


def call_p95_ms(run):
    """95th percentile over every call of the window of its latency,
    issue to result, in ms (the device's stamps)."""
    lat = run.latency_ms
    if lat is None or lat.size == 0:
        return None
    return float(np.percentile(lat, 95))


def host_us_per_call(run):
    """Mean host time of a call, issue to return, in microseconds (the
    untraced window's calls, also in a traced run)."""
    return float(run.entry_ns.mean()) * 1e-3 if run.calls else None


def kernels_per_call(run):
    t = run.trace
    return t.kernels / t.calls if t is not None and t.kernels else None


def roofline_pct(run):
    """The transform's bound times the traced calls, over the device time
    of every operation the traced window ran, in percent."""
    t = run.trace
    if t is None or t.op_sum_s <= 0:
        return None
    return 100.0 * run.bound_s * t.calls / t.op_sum_s


def idle_pct(run):
    """Share of the traced window in which the device ran nothing."""
    t = run.trace
    if t is None or t.ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
