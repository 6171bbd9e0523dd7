"""Plain reference of the 2-D complex FFT: NumPy in float64.

numpy's 2-D FFT over the last two axes with its default normalisation
(forward unscaled, inverse 1/(n1 n2)), on the (re, im) planes that the
benchmark handed to the program, widened to complex128. Imports NumPy
alone, so it shares no code with the program or with cuFFT.
"""

from __future__ import annotations

import numpy as np


def fft2(xr: np.ndarray, xi: np.ndarray, inverse: bool = False) -> np.ndarray:
    """complex128 DFT over the last two axes of xr + i xi."""
    x = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    return np.fft.ifft2(x) if inverse else np.fft.fft2(x)
