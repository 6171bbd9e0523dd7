"""Naive O(n^2) DFT oracle in float64 numpy (host).

A copy of ``kofft_tpu.ops.dft``: the port may not import the JAX
package. Pure numpy float64; the ground truth of the port's parity checks.
"""

from __future__ import annotations

import numpy as np


def dft(x: np.ndarray, axis: int = -1, inverse: bool = False) -> np.ndarray:
    """Naive DFT along ``axis`` in complex128. inverse applies 1/n scaling."""
    x = np.asarray(x)
    x = np.moveaxis(x, axis, -1).astype(np.complex128)
    n = x.shape[-1]
    j = np.arange(n)
    sign = 2.0j if inverse else -2.0j
    f = np.exp(sign * np.pi * np.outer(j, j) / n)
    y = x @ f
    if inverse:
        y = y / n
    return np.moveaxis(y, -1, axis)


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    """Signal-to-noise ratio of ``got`` against a float64 reference, in
    dB. Float32 paths are held to > 100 dB."""
    ref = np.asarray(ref, dtype=np.complex128)
    got = np.asarray(got, dtype=np.complex128)
    num = np.sum(np.abs(ref) ** 2)
    den = np.sum(np.abs(ref - got) ** 2)
    if den == 0:
        return float("inf")
    if num == 0:
        return float("-inf")
    return float(10.0 * np.log10(num / den))
