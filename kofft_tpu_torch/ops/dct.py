"""DCT I-IV in the reference library's (unnormalized) conventions.

The counterpart of ``kofft_tpu.ops.dct``. Up to ``FAST_CUTOFF`` points a
transform is one product against a cached cosine matrix (host float64,
cast to the input's dtype), ``torch.matmul`` in float32 (or float64) on
every precision tier: PyTorch's float32 products run in full float32
(TF32 off) unless the caller turns TF32 on. The JAX package runs the
product at its tier's precision, one bf16 pass on `default`. Above the
cutoff the matrix would be too large (n^2 floats) and the FFT-composed
identities of ``_trig`` take over, through the port's FFT ladders.

Conventions (scipy's unnormalized transforms scaled by 1/2, except
DCT-I):
  DCT-I  : X_k = x_0 + (-1)^k x_{n-1} + 2 sum_{i=1}^{n-2} x_i cos(pi i k/(n-1))
  DCT-II : X_k = sum_i x_i cos(pi (i+1/2) k / n)
  DCT-III: X_k = x_0/2 + sum_{i>=1} x_i cos(pi i (k+1/2) / n)
  DCT-IV : X_k = sum_i x_i cos(pi (i+1/2)(k+1/2) / n)
DCT-I of n=1 returns 2*x_0. Host input goes to ``device`` (default
``"cuda"``); a tensor is computed where it lies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidValueError, require
from ..plan import tables
from ._complex import const, dtype_name
from .fft import _real_tensor

__all__ = ["dct1", "dct2", "dct3", "dct4", "dct", "idct",
           "dct_batch", "dct_multi_channel"]


def _dct_matrix_np(kind: int, n: int) -> np.ndarray:
    """M[i, k] such that X = x @ M (host float64)."""
    i = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if kind == 1:
        if n == 1:
            return np.array([[2.0]])
        m = 2.0 * np.cos(np.pi * i * k / (n - 1))
        m[0, :] = 1.0
        m[n - 1, :] = (-1.0) ** np.arange(n)
        return m
    if kind == 2:
        return np.cos(np.pi * (i + 0.5) * k / n)
    if kind == 3:
        m = np.cos(np.pi * i * (k + 0.5) / n)
        m[0, :] = 0.5
        return m
    if kind == 4:
        return np.cos(np.pi * (i + 0.5) * (k + 0.5) / n)
    raise InvalidValueError(f"DCT type must be 1..4, got {kind}")


def _matrix(kind: int, n: int, dtype: str):
    return tables.custom(("dct", kind, n, dtype),
                         lambda: _dct_matrix_np(kind, n).astype(dtype))


# Above this the cosine matrix is too big for a table (n^2 floats: 64 MB
# at 4096) and the O(n log n) FFT-composed path takes over. Tests lower it.
FAST_CUTOFF = 4096


def _apply(kind: int, x, device):
    x = _real_tensor(x, device, "DCT")
    n = x.shape[-1]
    if n > FAST_CUTOFF and n >= 2:
        from ._trig import fast_dct
        return fast_dct(kind, x)
    return torch.matmul(x, const(_matrix(kind, n, dtype_name(x)), x.device))


def dct1(x, device="cuda"):
    """DCT-I."""
    return _apply(1, x, device)


def dct2(x, device="cuda"):
    """DCT-II."""
    return _apply(2, x, device)


def dct3(x, device="cuda"):
    """DCT-III."""
    return _apply(3, x, device)


def dct4(x, device="cuda"):
    """DCT-IV."""
    return _apply(4, x, device)


_KINDS = {1: dct1, 2: dct2, 3: dct3, 4: dct4}


def dct(x, type: int = 2, device="cuda"):
    require(type in _KINDS, InvalidValueError,
            f"DCT type must be 1..4, got {type}")
    return _KINDS[type](x, device)


def idct(x, type: int = 2, device="cuda"):
    """Inverse of :func:`dct` under the reference conventions: DCT-II and
    DCT-III are mutual inverses up to 2/n, DCT-IV is self-inverse up to
    2/n, DCT-I self-inverse up to 1/(2(n-1))."""
    n = np.shape(x)[-1]
    if type == 2:
        return dct3(x, device) * (2.0 / n)
    if type == 3:
        return dct2(x, device) * (2.0 / n)
    if type == 4:
        return dct4(x, device) * (2.0 / n)
    if type == 1:
        require(n >= 2, InvalidValueError, "inverse DCT-I needs n >= 2")
        return dct1(x, device) * (1.0 / (2.0 * (n - 1)))
    raise InvalidValueError(f"DCT type must be 1..4, got {type}")


def dct_batch(xs, type: int = 2, device="cuda"):
    """Batch over the leading dims (they are batched already)."""
    return dct(xs, type=type, device=device)


def dct_multi_channel(xs, type: int = 2, device="cuda"):
    """Multi-channel = batch."""
    return dct(xs, type=type, device=device)
