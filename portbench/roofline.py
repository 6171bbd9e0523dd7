"""The least time the card can take for a transform: the roofline's bound.

Copied from ``chip_smoke.py`` (``PEAK_BYTES``, ``PEAK_FLOPS``,
``bound_ms``, ``fft_flops``, ``transform_bound``, ``nd_bound``) so that
the yardstick does not move when the program does, and extended with the
one-sided STFT's bound. A bound is what the function must do, never the
operations one algorithm issues: each input byte read once, each output
byte written once, 5 n log2 n operations per complex line of n points
(half for real input or one-sided output).

The peaks are the published ones of one H100 SXM (NVIDIA's data sheet)
at its full power limit of 700 W; a run prints the card's own limit
beside them.
"""

from __future__ import annotations

import math

# HBM bytes/s, float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card can take to
    move ``nbytes`` through device memory or to do ``flops`` float32
    operations, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_flops(points: int, m: int, real: bool) -> float:
    """Operations of FFTs of length m over ``points`` points: 5 m log2 m
    per complex line, half that for real input or one-sided output."""
    return (2.5 if real else 5.0) * points * math.log2(m)


def transform_bound(real: bool, b: int, n: int, elt: int = 4):
    """bound_ms of b transforms of length n on planes of ``elt`` bytes per
    element: input read once, output written once, 5 n log2 n operations
    per line (half for the rfft)."""
    nbytes = (b * elt * (n + 2 * (n // 2 + 1)) if real
              else 4 * elt * b * n)
    return bound_ms(nbytes, fft_flops(b * n, n, real))


def nd_bound(shape, axes=None):
    """bound_ms of a complex N-D transform of ``shape`` over ``axes``
    (default all): the planes read once and written once, and 5 m log2 m
    operations per line along each transformed axis."""
    pts = math.prod(shape)
    axes = range(len(shape)) if axes is None else axes
    return bound_ms(16 * pts, sum(fft_flops(pts, shape[a], False)
                                  for a in axes))


def stft_bound(b: int, samples: int, win: int, hop: int, elt: int = 4):
    """bound_ms of the one-sided STFT of b real signals of ``samples``
    points: each signal read once (never the overlapping frames), the
    F = ceil(samples / hop) one-sided spectra of win // 2 + 1 bins written
    once as two planes, and 2.5 win log2 win operations per frame."""
    frames = b * -(-samples // hop)
    nbytes = elt * (b * samples + 2 * frames * (win // 2 + 1))
    return bound_ms(nbytes, fft_flops(frames * win, win, True))
