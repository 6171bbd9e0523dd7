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

On more than one rank each rank holds its own part of an answer and of its
reference: ``partial`` reduces a part to sums and a largest gap, and
``combine`` joins the parts of one answer into the numbers ``errors``
gives on the whole array, so no rank gathers the answer.
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
    return combine([partial(got, ref)])


def partial(got: np.ndarray, ref: np.ndarray) -> dict:
    """A part of an answer against the same part of its reference (on
    more than one rank, the rank's own): the sums and the largest gap
    that ``combine`` joins."""
    if got.shape != ref.shape:
        return {"same_shape": False}
    d = np.abs(got - ref)
    return {"same_shape": True, "n": d.size,
            "sq_err": float(np.sum(d ** 2)),
            "sq_ref": float(np.sum(np.abs(ref) ** 2)),
            "max_abs": float(np.max(d)) if d.size else 0.0}


def combine(parts: list) -> dict:
    """The compared numbers of a whole answer from the ``partial`` of
    each of its parts; an answer of another shape, with a gap that is not
    finite, or empty fails every number."""
    n = sum(p.get("n", 0) for p in parts)
    gaps = [p.get("max_abs", 0.0) for p in parts]
    if not all(p["same_shape"] for p in parts) or not n \
            or not np.all(np.isfinite(gaps)):
        return {k: float("inf") for k in NAMES}
    worst = max(gaps)
    scale = np.sqrt(sum(p["sq_ref"] for p in parts) / n)
    return {"rms_err": float(np.sqrt(sum(p["sq_err"] for p in parts) / n)
                             / scale),
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
