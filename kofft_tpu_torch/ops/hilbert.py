"""Hilbert transform / analytic signal by one-sided doubling of the FFT.

The counterpart of ``kofft_tpu.ops.hilbert``: FFT, double bins 1..n/2
(even n) or 1..(n-1)/2 (odd n), zero the negative frequencies, inverse
FFT, both transforms through the port's engine ladder. Any n is
accepted.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..plan import tables
from ._complex import const, dtype_name, merge
from .fft import _real_tensor, engine_fft_planes, resolve_backend

__all__ = ["hilbert_analytic", "hilbert_analytic_split", "hilbert"]


def _sideband_mask(n: int) -> np.ndarray:
    """Gain per bin: 1 at DC (and Nyquist for even n), 2 for positive
    frequencies, 0 for negative (cached host table)."""
    def build():
        g = np.zeros(n, dtype=np.float32)
        g[0] = 1.0
        if n % 2 == 0:
            g[n // 2] = 1.0
            g[1: n // 2] = 2.0
        else:
            g[1: (n - 1) // 2 + 1] = 2.0
        return g
    return tables.custom(("hilbert_mask", n), build)


def _analytic_planes(x, backend: str):
    n = x.shape[-1]
    dtype = dtype_name(x)
    yr, yi = engine_fft_planes(x, torch.zeros_like(x), n, False, dtype,
                               backend)
    g = const(_sideband_mask(n), x.device)
    zr, zi = engine_fft_planes(yr * g, yi * g, n, True, dtype, backend)
    return zr / n, zi / n


def hilbert_analytic_split(x, backend: Optional[str] = None, device="cuda"):
    """Analytic signal as (re, im) planes."""
    x = _real_tensor(x, device, "hilbert")
    return _analytic_planes(x, resolve_backend(backend))


def hilbert_analytic(x, backend: Optional[str] = None, device="cuda"):
    """Analytic signal x + i*H[x], a complex tensor."""
    return merge(*hilbert_analytic_split(x, backend, device))


def hilbert(x, backend: Optional[str] = None, device="cuda"):
    """The Hilbert transform itself, H[x] = Im(analytic(x))."""
    return hilbert_analytic_split(x, backend, device)[1]
