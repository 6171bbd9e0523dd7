"""The comparison that decides ``correct``.

Each sampled answer of the timed window is compared with the plain
reference's answer to the same input by two numbers, both relative to the
reference's root mean square |ref|_rms:

  rms_err  root mean square of |got - ref|, over |ref|_rms (the SNR's
           10^(-SNR/20));
  max_err  the largest |got - ref| of any element, over |ref|_rms, so one
           element altered where it is produced shows.

A run is correct when every sampled answer reads each number at or below
the cell's limit for it. The limits come from the cell's file; how each
was set is in PERF.md.
"""

from __future__ import annotations

import numpy as np

NAMES = ("rms_err", "max_err")


def planes(out) -> np.ndarray:
    """A pair of (re, im) planes on any device as complex128 on the host."""
    return (out[0].double().cpu().numpy()
            + 1j * out[1].double().cpu().numpy())


def errors(got: np.ndarray, ref: np.ndarray) -> dict:
    """The compared numbers of one answer against its reference."""
    if got.shape != ref.shape:
        return {k: float("inf") for k in NAMES}
    d = np.abs(got - ref)
    scale = np.sqrt(np.mean(np.abs(ref) ** 2))
    worst = float(np.max(d)) if d.size else 0.0
    if not np.isfinite(worst):
        return {k: float("inf") for k in NAMES}
    return {"rms_err": float(np.sqrt(np.mean(d ** 2)) / scale),
            "max_err": worst / float(scale)}


def judge(readings: list, limits: dict) -> tuple:
    """(correct, failed answers, {name: {"value", "limit"}}) of the
    readings of every sampled answer: each number the worst over them."""
    worst = {k: max((r[k] for r in readings), default=float("inf"))
             for k in limits}
    failed = sum(any(r[k] > limits[k] for k in limits) for r in readings)
    correct = bool(readings) and failed == 0
    return correct, failed, {k: {"value": worst[k], "limit": limits[k]}
                             for k in limits}
