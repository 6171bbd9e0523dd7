"""O(n log n) FFT-composed paths of the trigonometric transforms.

The counterpart of ``kofft_tpu.ops._trig``. Above the DCT/DST modules'
``FAST_CUTOFF`` a cosine or sine matrix is too large to be a table (n^2
floats), so each kind reduces to

    extend / chirp-premultiply -> FFT_m -> twiddle postmultiply -> Re/Im

with m = 2n (2(n-1) and 2(n+1) for the type-I transforms), through the
port's ladders: ``_fft_norm_planes`` and ``_rfft_planes`` (the stage
kernels where they serve m, Bluestein for an m whose odd part exceeds
23, as in the JAX package).

Identities (each against the matrix forms in the tests):
  DCT-II : X_k = Re( e^{-i pi k/(2n)}      F_{2n}([x, 0])_k )
  DCT-III: X_k = Re( F_{2n}([x' c, 0])_k ),
           x'_0 = x_0/2, c_i = e^{-i pi i/(2n)}
  DCT-IV : X_k = Re( e^{-i pi (2k+1)/(4n)} F_{2n}([x c, 0])_k )
  DCT-I  : X_k = Re( rfft([x, x_{n-2}..x_1])_k )            (m = 2(n-1))
  DST-II : X_k = -Im( e^{-i pi (k+1)/(2n)} F_{2n}([x, 0])_{k+1} )
  DST-III: X_k = x_0/2 - Im( F_{2n}([x c, 0])_k )           (the reference
           library's constant term; c as in DCT-III)
  DST-IV : X_k = -Im( e^{-i pi (2k+1)/(4n)} F_{2n}([x c, 0])_k )
  DST-I  : X_k = -Im( rfft([0, x, 0, -x_{n-1}..-x_0])_{k+1} ) / 2
           (m = 2(n+1) antisymmetric extension)
"""

from __future__ import annotations

import numpy as np
import torch

from ..plan import tables
from ._complex import const, dtype_name


def _post(kind: str, n: int, dtype: str):
    """(re, im) of the k-indexed post-twiddle, host float64 -> dtype."""
    def build():
        k = np.arange(n, dtype=np.float64)
        if kind == "half":           # e^{-i pi k/(2n)}
            ang = -np.pi * k / (2 * n)
        elif kind == "half_shift":   # e^{-i pi (k+1)/(2n)}
            ang = -np.pi * (k + 1.0) / (2 * n)
        else:                        # "quarter": e^{-i pi (2k+1)/(4n)}
            ang = -np.pi * (2 * k + 1.0) / (4 * n)
        return (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))

    return tables.custom(("trig_post", kind, n, dtype), build)


def _post_dev(kind: str, x):
    """:func:`_post` for ``x``'s length and dtype, on ``x``'s device."""
    return tuple(const(a, x.device)
                 for a in _post(kind, x.shape[-1], dtype_name(x)))


def _pad_to(x, m: int):
    return torch.nn.functional.pad(x, (0, m - x.shape[-1]))


def _fft2n_planes(xr, xi, m: int):
    """Engine FFT of planes zero-padded to length m (unnormalized)."""
    from .fft import _fft_norm_planes, resolve_backend
    return _fft_norm_planes(_pad_to(xr, m), _pad_to(xi, m), m, False, None,
                            resolve_backend())


def _rfft_m_planes(x, m: int):
    from .fft import resolve_backend
    from .rfft import _rfft_planes
    return _rfft_planes(_pad_to(x, m), m, resolve_backend())


def fast_dct(kind: int, x):
    """FFT-composed DCT along the last axis (reference conventions)."""
    n = x.shape[-1]
    if kind == 1:
        # symmetric extension [x, x_{n-2}..x_1], length 2(n-1)
        ext = torch.cat([x, torch.flip(x[..., 1:-1], (-1,))], dim=-1)
        yr, _ = _rfft_m_planes(ext, 2 * (n - 1))
        return yr[..., :n]
    if kind == 2:
        yr, yi = _rfft_m_planes(x, 2 * n)
        pr, pi = _post_dev("half", x)
        return yr[..., :n] * pr - yi[..., :n] * pi
    cr, ci = _post_dev("half", x)      # the chirp c_i
    if kind == 3:
        xp = torch.cat([x[..., :1] * 0.5, x[..., 1:]], dim=-1)
        yr, _ = _fft2n_planes(xp * cr, xp * ci, 2 * n)
        return yr[..., :n]
    # kind == 4
    yr, yi = _fft2n_planes(x * cr, x * ci, 2 * n)
    pr, pi = _post_dev("quarter", x)
    return yr[..., :n] * pr - yi[..., :n] * pi


def fast_dst(kind: int, x):
    """FFT-composed DST along the last axis (reference conventions,
    including the reference library's DST-III constant term)."""
    n = x.shape[-1]
    if kind == 1:
        zero = torch.zeros_like(x[..., :1])
        ext = torch.cat([zero, x, zero, -torch.flip(x, (-1,))], dim=-1)
        _, yi = _rfft_m_planes(ext, 2 * (n + 1))
        return -0.5 * yi[..., 1: n + 1]
    if kind == 2:
        yr, yi = _rfft_m_planes(x, 2 * n)
        pr, pi = _post_dev("half_shift", x)
        # -Im(post * Y_{k+1}) = -(yr*pi + yi*pr)
        return -(yr[..., 1: n + 1] * pi + yi[..., 1: n + 1] * pr)
    cr, ci = _post_dev("half", x)
    yr, yi = _fft2n_planes(x * cr, x * ci, 2 * n)
    if kind == 3:
        return x[..., :1] * 0.5 - yi[..., :n]
    # kind == 4
    pr, pi = _post_dev("quarter", x)
    return -(yr[..., :n] * pi + yi[..., :n] * pr)
