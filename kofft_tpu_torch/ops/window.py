"""Window functions (host tables).

The counterpart of ``kofft_tpu.ops.window``, kept as a copy because the
port may not import the JAX package (``import kofft_tpu.ops.window`` pulls
in jax). The same formulas, conventions and cache: Hann, Hamming and
Blackman are periodic (denominator ``len``, DFT-even, the right choice for
STFT overlap-add), Kaiser, Tukey, Bartlett, Bohman and Nuttall symmetric
(denominator ``len - 1``). Tables are computed on the host in float64,
cast to the requested dtype and cached through ``tables.custom``; they
are numpy arrays, as in the JAX package, and the STFT moves a window to
the card once per (window, device).

The Bohman window is the standard formula (the reference library's text
omits an ``abs`` inside its sine term); the JAX package does the same, and
so does this copy.
"""

from __future__ import annotations

import math

import numpy as np

from ..errors import InvalidValueError, require
from ..plan import tables

__all__ = ["hann", "hamming", "blackman", "kaiser", "tukey", "bartlett",
           "bohman", "nuttall", "get_window"]


def _cached(name: str, n: int, build, dtype: str = "float32",
            param: float | None = None):
    require(n >= 1, InvalidValueError, f"window length must be >= 1, got {n}")
    return tables.custom(("window", name, n, param, dtype),
                         lambda: build().astype(dtype))


def hann(n: int, dtype: str = "float32") -> np.ndarray:
    """Periodic Hann: 0.5 - 0.5*cos(2*pi*i/n)  (reference window.rs:24-28)."""
    return _cached("hann", n, lambda: 0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(n, dtype=np.float64) / n), dtype)


def hamming(n: int, dtype: str = "float32") -> np.ndarray:
    """Periodic Hamming: 0.54 - 0.46*cos(2*pi*i/n) (window.rs:31-35)."""
    return _cached("hamming", n, lambda: 0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(n, dtype=np.float64) / n), dtype)


def blackman(n: int, dtype: str = "float32") -> np.ndarray:
    """Periodic Blackman, a=(0.42, 0.5, 0.08) (window.rs:38-47)."""
    def build():
        x = np.arange(n, dtype=np.float64) / n
        return (0.42 - 0.5 * np.cos(2 * np.pi * x)
                + 0.08 * np.cos(4 * np.pi * x))
    return _cached("blackman", n, build, dtype)


def kaiser(n: int, beta: float, dtype: str = "float32") -> np.ndarray:
    """Symmetric Kaiser window, I0 via numpy's exact Bessel-series
    (reference approximates I0 with a 20-term series, window.rs:9-21)."""
    def build():
        m = (n - 1) / 2.0
        i = np.arange(n, dtype=np.float64)
        r = np.clip((i - m) / m if m > 0 else np.zeros(n), -1.0, 1.0)
        return np.i0(beta * np.sqrt(1.0 - r * r)) / np.i0(beta)
    return _cached("kaiser", n, build, dtype, param=float(beta))


def tukey(n: int, alpha: float = 0.5, dtype: str = "float32") -> np.ndarray:
    """Tapered-cosine (window_more.rs:13-28); alpha clamped to [0, 1]."""
    def build():
        a = min(max(float(alpha), 0.0), 1.0)
        w = np.ones(n, dtype=np.float64)
        if a <= 0.0 or n == 1:
            return w
        edge = int(math.floor(a * (n - 1) / 2.0))
        i = np.arange(n, dtype=np.float64)
        left = i < edge
        right = i >= n - edge
        w[left] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * i[left] / (a * (n - 1))
                                               - 1.0)))
        w[right] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * i[right] / (a * (n - 1))
                                                - 2.0 / a + 1.0)))
        return w
    return _cached("tukey", n, build, dtype, param=float(alpha))


def bartlett(n: int, dtype: str = "float32") -> np.ndarray:
    """Triangular window (window_more.rs:31-40)."""
    def build():
        if n == 1:
            return np.ones(1, dtype=np.float64)
        half = (n - 1) / 2.0
        x = (np.arange(n, dtype=np.float64) - half) / half
        return 1.0 - np.abs(x)
    return _cached("bartlett", n, build, dtype)


def bohman(n: int, dtype: str = "float32") -> np.ndarray:
    """Standard Bohman window (see module docstring divergence note)."""
    def build():
        if n == 1:
            return np.ones(1, dtype=np.float64)
        x = np.abs(np.arange(n, dtype=np.float64) / (n - 1) - 0.5) * 2.0
        x = np.clip(x, 0.0, 1.0)
        return (1.0 - x) * np.cos(np.pi * x) + np.sin(np.pi * x) / np.pi
    return _cached("bohman", n, build, dtype)


def nuttall(n: int, dtype: str = "float32") -> np.ndarray:
    """Nuttall 4-term (window_more.rs:53-66), symmetric."""
    def build():
        if n == 1:
            return np.ones(1, dtype=np.float64)
        x = 2.0 * np.pi * np.arange(n, dtype=np.float64) / (n - 1)
        return (0.355768 - 0.487396 * np.cos(x) + 0.144232 * np.cos(2 * x)
                - 0.012604 * np.cos(3 * x))
    return _cached("nuttall", n, build, dtype)


_WINDOWS = {
    "hann": hann, "hamming": hamming, "blackman": blackman,
    "bartlett": bartlett, "bohman": bohman, "nuttall": nuttall,
}
_PARAM_WINDOWS = {"kaiser": kaiser, "tukey": tukey}


def get_window(name, n: int, param: float | None = None,
               dtype: str = "float32") -> np.ndarray:
    """Window by name ('hann', ('kaiser', beta) style also accepted)."""
    if isinstance(name, (tuple, list)):
        name, param = name[0], name[1]
    name = str(name).lower()
    if name in _WINDOWS:
        return _WINDOWS[name](n, dtype=dtype)
    if name in _PARAM_WINDOWS:
        require(param is not None, InvalidValueError,
                f"window {name!r} requires a parameter")
        return _PARAM_WINDOWS[name](n, param, dtype=dtype)
    raise InvalidValueError(
        f"unknown window {name!r}; available: "
        f"{sorted(_WINDOWS) + sorted(_PARAM_WINDOWS)}")
