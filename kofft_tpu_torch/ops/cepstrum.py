"""Real cepstrum, mel filterbank, MFCC.

The counterpart of ``kofft_tpu.ops.cepstrum``. The mel filterbank's
triangular filters are a cached (n_mags, n_mel) weight matrix built on the
host with the reference library's integer bin arithmetic
(``floor(f * (n_mags + 1) / sample_rate)`` bin edges, degenerate filters
skipped) and applied as one product. MFCC = mel -> log(+1e-12) -> DCT-II
(the port's ``dct2``), truncated. The cepstrum's two FFTs take the
port's engine ladder; any n is accepted.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..errors import InvalidValueError, require
from ..plan import tables
from ._complex import const, dtype_name
from .dct import dct2
from .fft import _real_tensor, engine_fft_planes, resolve_backend

__all__ = ["real_cepstrum", "mel_filterbank_matrix", "mel_filterbank", "mfcc"]


def real_cepstrum(x, backend: Optional[str] = None, device="cuda"):
    """IFFT(log(|FFT(x)| + 1e-12)).real along the last axis."""
    x = _real_tensor(x, device, "cepstrum")
    b = resolve_backend(backend)
    n = x.shape[-1]
    dtype = dtype_name(x)
    yr, yi = engine_fft_planes(x, torch.zeros_like(x), n, False, dtype, b)
    logmag = torch.log(torch.sqrt(yr * yr + yi * yi) + 1e-12)
    zr, _ = engine_fft_planes(logmag, torch.zeros_like(logmag), n, True,
                              dtype, b)
    return zr / n


def mel_filterbank_matrix(n_mags: int, sample_rate: float,
                          num_filters: int) -> np.ndarray:
    """(n_mags, num_filters) float32 triangular-filter weights (host),
    with the reference library's bin arithmetic."""
    require(num_filters >= 1, InvalidValueError, "num_filters must be >= 1")
    require(sample_rate > 0, InvalidValueError, "sample_rate must be > 0")

    def build():
        f_min, f_max = 0.0, sample_rate / 2.0
        mel_min = 2595.0 * math.log10(1.0 + f_min / 700.0)
        mel_max = 2595.0 * math.log10(1.0 + f_max / 700.0)
        mel_pts = [mel_min + (mel_max - mel_min) * i / (num_filters + 1)
                   for i in range(num_filters + 2)]
        freqs = [700.0 * (10.0 ** (m / 2595.0) - 1.0) for m in mel_pts]
        bins = [int(math.floor(f * (n_mags + 1.0) / sample_rate))
                for f in freqs]
        w = np.zeros((n_mags, num_filters), dtype=np.float32)
        for m in range(1, num_filters + 1):
            b0, b1, b2 = bins[m - 1], bins[m], bins[m + 1]
            if b1 == b0 or b2 == b1:
                continue  # degenerate filter skipped
            for k in range(b0, min(b1, n_mags)):
                w[k, m - 1] += (k - b0) / (b1 - b0)
            for k in range(b1, min(b2, n_mags)):
                w[k, m - 1] += (b2 - k) / (b2 - b1)
        return w
    return tables.custom(("mel", n_mags, float(sample_rate), num_filters,
                          "float32"), build)


def mel_filterbank(fft_mags, sample_rate: float, num_filters: int,
                   device="cuda"):
    """Mel energies: one product against the cached filter matrix."""
    x = _real_tensor(fft_mags, device, "mel_filterbank")
    w = mel_filterbank_matrix(x.shape[-1], sample_rate, num_filters)
    return torch.matmul(x, const(w, x.device).to(x.dtype))


def mfcc(fft_mags, sample_rate: float, num_mel: int, num_coeffs: int,
         device="cuda"):
    """MFCCs from a magnitude spectrum: mel -> log -> DCT-II ->
    truncate."""
    require(num_coeffs <= num_mel, InvalidValueError,
            f"num_coeffs ({num_coeffs}) > num_mel ({num_mel})")
    mel = mel_filterbank(fft_mags, sample_rate, num_mel, device)
    return dct2(torch.log(mel + 1e-12))[..., :num_coeffs]
