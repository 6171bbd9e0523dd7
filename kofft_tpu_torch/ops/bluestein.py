"""Bluestein (chirp-Z) FFT for arbitrary / non-smooth sizes.

The counterpart of ``kofft_tpu.ops.bluestein``:

    X[k] = c[k] * sum_j (x[j] * c[j]) * conj(c)[k - j],  c[j] = e^{-i pi j^2 / n}

a linear convolution with the conjugate chirp, computed as a circular
convolution of pow2 size m >= 2n-1 through the engine ladder, with the
backend the ladder resolved for n (under 'auto' that is 'torch', as in
the JAX package, so the inner transforms take the plain tree). The FFT of
the padded conjugate-chirp kernel is built on the host in float64 and
cached.
"""

from __future__ import annotations

import numpy as np
import torch

from ..plan import chirp_np, next_pow2, tables
from ._complex import cmul, const


def _bfft_tables(n: int, m: int, dtype: str):
    """Cached constants: FFT of the wrapped conjugate chirp b, length m."""
    def build():
        cr, ci = chirp_np(n)
        b = np.zeros(m, dtype=np.complex128)
        bc = np.conj(cr + 1j * ci)     # b[j] = exp(+i pi j^2 / n)
        b[:n] = bc
        if n > 1:
            b[m - n + 1:] = bc[1:][::-1]   # b[m - j] = b[j], j = 1..n-1
        bf = np.fft.fft(b)
        return (bf.real.astype(dtype), bf.imag.astype(dtype))
    return tables.custom(("bluestein_bfft", n, m, dtype), build)


def _bluestein_planes(xr, xi, n: int, dtype: str, backend: str = "auto"):
    """Unnormalized forward DFT of length n on planes. The caller's backend
    threads through to the inner pow2 transforms."""
    from .fft import engine_fft_planes

    dev = xr.device
    m = next_pow2(2 * n - 1)
    cr, ci = (const(a, dev) for a in tables.chirp(n, dtype))
    ar, ai = cmul(xr, xi, cr, ci)
    pad = (0, m - n)
    ar = torch.nn.functional.pad(ar, pad)
    ai = torch.nn.functional.pad(ai, pad)
    fr, fi = engine_fft_planes(ar, ai, m, False, dtype, backend)
    br, bi = (const(a, dev) for a in _bfft_tables(n, m, dtype))
    pr, pi = cmul(fr, fi, br, bi)
    # unnormalized inverse (= m * ifft), so scale by 1/m
    qr, qi = engine_fft_planes(pr, pi, m, True, dtype, backend)
    qr = qr[..., :n] * (1.0 / m)
    qi = qi[..., :n] * (1.0 / m)
    return cmul(qr, qi, cr, ci)
