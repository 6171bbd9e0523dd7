"""DST I-IV in the reference library's (unnormalized) conventions.

The counterpart of ``kofft_tpu.ops.dst``, built as :mod:`.dct` is: a
cached sine-matrix product up to ``FAST_CUTOFF`` points (float32 or
float64 ``torch.matmul`` on every tier), the FFT-composed identities of
``_trig`` above it.

Conventions:
  DST-I  : X_k = sum_i x_i sin(pi (i+1)(k+1) / (n+1))
  DST-II : X_k = sum_i x_i sin(pi (i+1/2)(k+1) / n)
  DST-III: X_k = x_0/2 + sum_{i>=1} x_i sin(pi (k+1/2) i / n)
  DST-IV : X_k = sum_i x_i sin(pi (i+1/2)(k+1/2) / n)

DST-III mirrors the reference library's DCT-III mechanically (constant
x_0/2 term): it is not scipy's DST-III and not the exact inverse of its
DST-II. The behaviour, not the textbook form, is the contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidValueError, require
from ..plan import tables
from ._complex import const, dtype_name
from .fft import _real_tensor

__all__ = ["dst1", "dst2", "dst3", "dst4", "dst", "dst_batch",
           "dst_multi_channel"]


def _dst_matrix_np(kind: int, n: int) -> np.ndarray:
    """M[i, k] such that X = x @ M (host float64)."""
    i = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if kind == 1:
        return np.sin(np.pi * (i + 1.0) * (k + 1.0) / (n + 1))
    if kind == 2:
        return np.sin(np.pi * (i + 0.5) * (k + 1.0) / n)
    if kind == 3:
        m = np.sin(np.pi * (k + 0.5) * i / n)
        m[0, :] = 0.5
        return m
    if kind == 4:
        return np.sin(np.pi * (i + 0.5) * (k + 0.5) / n)
    raise InvalidValueError(f"DST type must be 1..4, got {kind}")


def _matrix(kind: int, n: int, dtype: str):
    return tables.custom(("dst", kind, n, dtype),
                         lambda: _dst_matrix_np(kind, n).astype(dtype))


# The same large-n FFT-composed route as ops/dct.py (see the note there).
FAST_CUTOFF = 4096


def _apply(kind: int, x, device):
    x = _real_tensor(x, device, "DST")
    n = x.shape[-1]
    if n > FAST_CUTOFF and n >= 2:
        from ._trig import fast_dst
        return fast_dst(kind, x)
    return torch.matmul(x, const(_matrix(kind, n, dtype_name(x)), x.device))


def dst1(x, device="cuda"):
    """DST-I."""
    return _apply(1, x, device)


def dst2(x, device="cuda"):
    """DST-II."""
    return _apply(2, x, device)


def dst3(x, device="cuda"):
    """DST-III (the reference library's constant term)."""
    return _apply(3, x, device)


def dst4(x, device="cuda"):
    """DST-IV."""
    return _apply(4, x, device)


_KINDS = {1: dst1, 2: dst2, 3: dst3, 4: dst4}


def dst(x, type: int = 2, device="cuda"):
    require(type in _KINDS, InvalidValueError,
            f"DST type must be 1..4, got {type}")
    return _KINDS[type](x, device)


def dst_batch(xs, type: int = 1, device="cuda"):
    """Batch over the leading dims."""
    return dst(xs, type=type, device=device)


def dst_multi_channel(xs, type: int = 1, device="cuda"):
    return dst(xs, type=type, device=device)
