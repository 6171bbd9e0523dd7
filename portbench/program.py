"""Readers of the program's own spans and counters, shared by the files
under ``metrics/`` that read them.

The program keeps them in ``kofft_tpu_torch.utils.observability``, read
here through ``sys.modules`` with its ``snapshot()``, after the window.
The harness resets them right after the warm-up (``reset_counts``), and
spans record only while the profiler runs, that is over the traced half
of a ``--trace 1`` run. So a span reader reads the traced calls, the
profiler's cost per launch included, and a counter reader every call of
the window. A span reader returns None where the snapshot holds no root
span; a counter reader returns None only where the program has no such
counter (not loaded, or a version without it), and its 0 is a reading.
"""

from __future__ import annotations

import sys

MODULE = "kofft_tpu_torch.utils.observability"


def snapshot():
    """The program's snapshot, or None where it keeps none."""
    read = getattr(sys.modules.get(MODULE), "snapshot", None)
    return read() if read is not None else None


def span_us_per_call(*names):
    """Self µs of the spans ``names`` (none: the root spans) per root
    span."""
    def read(run):
        snap = snapshot()
        if snap is None or not snap["roots"]["count"]:
            return None
        if names:
            ns = sum(snap["spans"].get(k, {}).get("self_ns", 0)
                     for k in names)
        else:
            ns = snap["roots"]["self_ns"]
        return ns * 1e-3 / snap["roots"]["count"]
    return read


def counter_per_call(name: str, scale: float = 1.0):
    """Counter ``name`` times ``scale`` per call of the window, untraced
    and traced calls together."""
    def read(run):
        snap = snapshot()
        if snap is None or name not in snap["counters"]:
            return None
        calls = run.calls + (run.trace.calls if run.trace else 0)
        return snap["counters"][name] * scale / calls if calls else None
    return read
