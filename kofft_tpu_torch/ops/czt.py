"""Chirp Z-Transform: X_k = sum_i x_i * a^{-i} * w^{i*k},  k in [0, m).

The counterpart of ``kofft_tpu.ops.czt``, with its two paths:

  * ``czt`` / ``czt_split``: the O(n*m) sum as a product against the
    cached (n, m) chirp matrix (host complex128, cast to the input's
    dtype; ``torch.matmul``), for any ``w`` and ``a``;
  * ``czt_fast``: the O((n+m) log) Bluestein factorization
    w^{ik} = w^{(i^2 + k^2 - (k-i)^2)/2}: chirp-premultiply, an FFT
    convolution with the conjugate chirp over L = next_pow2(n + m - 1)
    points, chirp-postmultiply. It needs |w| = 1. Its two inner FFTs take
    the engine ladder, and so the stage kernels from L = 2^14 (under
    ``auto`` and outside the torch.fft zone).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import next_pow2, tables
from ._complex import cmul, const, dtype_name, merge
from .fft import _real_tensor, engine_fft_planes

__all__ = ["czt", "czt_fast", "czt_split"]


def _czt_matrix(n: int, m: int, w: complex, a: complex, dtype: str):
    """M[i, k] = a^{-i} * w^{i*k} as (re, im), host complex128 -> dtype."""
    def build():
        i = np.arange(n, dtype=np.float64)[:, None]
        k = np.arange(m, dtype=np.float64)[None, :]
        # powers through exp/log in complex128 (non-unit modulus too);
        # a == 0 takes a^-1 as 0
        ai = np.zeros(n, np.complex128) if a == 0 else np.exp(
            -i[:, 0] * np.log(complex(a)))
        wik = np.exp((i * k) * np.log(complex(w)))
        mat = ai[:, None] * wik
        return (mat.real.astype(dtype), mat.imag.astype(dtype))
    return tables.custom(("czt", n, m, complex(w), complex(a), dtype), build)


def czt_split(x, m: int, w: complex, a: complex = 1.0 + 0j, device="cuda"):
    """CZT of a real signal at m bins as (re, im) planes."""
    x = _real_tensor(x, device, "czt")
    require(m >= 1, InvalidValueError, f"m must be >= 1, got {m}")
    mr, mi = (const(t, x.device) for t in
              _czt_matrix(x.shape[-1], m, complex(w), complex(a),
                          dtype_name(x)))
    return torch.matmul(x, mr), torch.matmul(x, mi)


def czt(x, m: int, w: complex, a: complex = 1.0 + 0j, device="cuda"):
    """CZT of a real signal at m bins, a complex tensor."""
    return merge(*czt_split(x, m, w, a, device))


def _czt_fast_consts(n: int, m: int, w: complex, a: complex, dtype: str):
    """Premultiplier a^{-i} w^{i^2/2}, postmultiplier w^{k^2/2} and the
    FFT of the wrapped kernel w^{-j^2/2}, as (re, im) pairs (host)."""
    L = next_pow2(n + m - 1)
    theta = np.angle(w)  # w = e^{i*theta}

    def build():
        i = np.arange(max(n, m), dtype=np.float64)
        half = np.exp(1j * theta * (i * i) / 2.0)
        apow = (np.zeros(n, np.complex128) if a == 0
                else np.exp(-np.arange(n) * np.log(a)))
        pre = apow * half[:n]
        post = half[:m]
        # kernel b[j] = w^{-j^2/2} over j in (-(n-1) .. m-1), wrapped in L
        b = np.zeros(L, np.complex128)
        bneg = np.exp(-1j * theta * (i * i) / 2.0)
        b[:m] = bneg[:m]
        b[L - n + 1:] = bneg[1:n][::-1]
        bf = np.fft.fft(b)
        return tuple(t.astype(dtype) for t in (
            pre.real, pre.imag, post.real, post.imag, bf.real, bf.imag))

    return tables.custom(("czt_fast", n, m, w, a, dtype), build)


def czt_fast(x, m: int, w: complex, a: complex = 1.0 + 0j,
             backend: Optional[str] = None, device="cuda"):
    """Bluestein-factorized CZT (O((n+m) log); needs |w| = 1), a complex
    tensor."""
    w = complex(w)
    a = complex(a)
    require(abs(abs(w) - 1.0) < 1e-6, InvalidValueError,
            "czt_fast requires |w| == 1; use czt() for general w")
    x = _real_tensor(x, device, "czt")
    n = x.shape[-1]
    require(m >= 1, EmptyInputError, "czt input must be non-empty")
    dtype = dtype_name(x)
    L = next_pow2(n + m - 1)
    pre_r, pre_i, post_r, post_i, bfr, bfi = (
        const(t, x.device) for t in _czt_fast_consts(n, m, w, a, dtype))
    b = backend or "auto"
    pad = (0, L - n)
    ar = torch.nn.functional.pad(x * pre_r, pad)
    ai = torch.nn.functional.pad(x * pre_i, pad)
    fr, fi = engine_fft_planes(ar, ai, L, False, dtype, b)
    pr, pi = cmul(fr, fi, bfr, bfi)
    qr, qi = engine_fft_planes(pr, pi, L, True, dtype, b)
    return merge(*cmul(qr[..., :m] / L, qi[..., :m] / L, post_r, post_i))
