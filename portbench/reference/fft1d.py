"""Plain reference of the 1-D complex FFT: NumPy in float64.

numpy's FFT with its default normalisation (forward unscaled, inverse
1/n), on the (re, im) planes that the benchmark handed to the program.
Imports NumPy alone.
"""

from __future__ import annotations

import numpy as np


def fft(xr: np.ndarray, xi: np.ndarray, inverse: bool = False) -> np.ndarray:
    """complex128 DFT along the last axis of xr + i xi."""
    x = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    return np.fft.ifft(x) if inverse else np.fft.fft(x)
