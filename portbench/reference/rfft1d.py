"""Plain reference of the 1-D real FFT: NumPy in float64.

numpy's one-sided real FFT with its default normalisation (forward
unscaled), of the float32 signal that the benchmark handed to the
program, widened to float64. Imports NumPy alone, as every reference here
does (the benchmark's tests hold each file of this directory to it), so
it shares no code with the program or with cuFFT, and runs on the card's
machine without the JAX package; it is NumPy and not plain PyTorch on
purpose.
"""

from __future__ import annotations

import numpy as np


def rfft(x: np.ndarray) -> np.ndarray:
    """complex128 bins k = 0 ... n // 2 of the DFT along the last axis of
    the real signal x."""
    return np.fft.rfft(np.asarray(x, np.float64))
