"""Goertzel single-bin DFT detector.

The counterpart of ``kofft_tpu.ops.goertzel``: bin k = floor(freq * n /
sample_rate), magnitude |X_k| for X_k = sum_i x_i e^{-j w i}.
``goertzel`` and ``goertzel_bins`` compute |X_k| as two basis products
(cached host float64 tables cast to the input's dtype, ``torch.matmul``),
batched over leading dims and over many bins at once. ``goertzel_scan``
keeps the literal O(n) recurrence in float32, with the rounding order of
the reference library's scalar loop:

    s = x_i + coeff * s1 - s2,   |X_k| = sqrt(s2^2 + s1^2 - coeff*s1*s2)

The JAX package runs it as a ``lax.scan``; on the card it is the
``goertzel_scan`` CUDA kernel (``csrc/goertzel.cu``, one thread per row,
no FMA contraction), whose wrapper ``scan_rows`` counts each launch in
``launches``; on CPU tensors the wrapper runs ``scan_rows_plain``, a
loop over the samples vectorized across rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.autograd import profiler as _prof

from ..errors import InvalidValueError, require
from ..plan import tables
from ..utils import observability as _obs
from ._complex import const, dtype_name
from .fft import _real_tensor

__all__ = ["goertzel", "goertzel_bins", "goertzel_scan"]

# a group of the port's counter registry (utils/observability.py)
launches = _obs.counter_group("goertzel_launches")
launches["goertzel_scan"] = 0


def _bin_of(n: int, sample_rate: float, target_freq: float) -> int:
    return int(math.floor(target_freq * n / sample_rate))


def _basis(n: int, bins: tuple, dtype: str):
    def build():
        k = np.asarray(bins, dtype=np.float64)[None, :]
        i = np.arange(n, dtype=np.float64)[:, None]
        ang = -2.0 * np.pi * i * k / n
        return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
    return tables.custom(("goertzel", n, bins, dtype), build)


def _check_rate(sample_rate: float) -> None:
    require(sample_rate > 0.0, InvalidValueError,
            f"sample_rate must be > 0, got {sample_rate}")


def goertzel_bins(x, bins, device="cuda"):
    """|X_k| for many integer bins at once (two basis products)."""
    x = _real_tensor(x, device, "goertzel")
    bins = tuple(int(b) for b in bins)
    cr, ci = (const(t, x.device)
              for t in _basis(x.shape[-1], bins, dtype_name(x)))
    re = torch.matmul(x, cr)
    im = torch.matmul(x, ci)
    return torch.sqrt(re * re + im * im)


def goertzel(x, sample_rate: float, target_freq: float, device="cuda"):
    """Magnitude at the bin nearest below ``target_freq`` (floor bin
    selection)."""
    x = _real_tensor(x, device, "goertzel")
    _check_rate(sample_rate)
    k = _bin_of(x.shape[-1], sample_rate, target_freq)
    return goertzel_bins(x, (k,))[..., 0]


def scan_rows_plain(x2, coeff: float):
    """The recurrence over the rows of a (rows, n) float32 tensor, one
    sample at a time for all rows: the kernel's plain version. Each step
    rounds coeff * s1, then x_i + that, then minus s2, into three buffers
    that rotate. The square root is taken in float64 and rounded to
    float32, which is correctly rounded as the kernel's ``__fsqrt_rn``:
    a CPU build's vectorized float32 square root can be one ulp off."""
    c = x2.new_full((), coeff)
    s1 = x2.new_zeros(x2.shape[0])
    s2 = x2.new_zeros(x2.shape[0])
    s = torch.empty_like(s1)
    for col in x2.t().contiguous():
        torch.mul(c, s1, out=s)
        torch.add(col, s, out=s)
        s.sub_(s2)
        s1, s2, s = s, s1, s2
    power = s2 * s2 + s1 * s1 - c * s1 * s2
    return torch.sqrt(torch.clamp_min(power, 0.0).double()).float()


def scan_rows(x2, coeff: float):
    """The recurrence over the rows of a contiguous (rows, n) float32
    tensor -> (rows,) magnitudes. CUDA tensors launch the goertzel_scan
    kernel (one count in ``launches``); CPU tensors run
    ``scan_rows_plain``."""
    require(x2.dim() == 2 and x2.dtype == torch.float32
            and x2.is_contiguous(), InvalidValueError,
            "scan_rows takes a contiguous (rows, n) float32 tensor")
    if x2.device.type == "cpu":
        return scan_rows_plain(x2, coeff)
    require(x2.device.type == "cuda", InvalidValueError,
            f"scan_rows runs on CPU or CUDA tensors, not {x2.device}")
    from ._cuda_build import check, lib
    from .hopper_kernels import _stream
    rows, n = x2.shape
    sp = (_obs.begin("alloc")
          if _prof._is_profiler_enabled or _obs.switch else None)
    out = torch.empty(rows, dtype=torch.float32, device=x2.device)
    if sp:
        _obs.end(sp)
    _obs.counts["alloc_bytes"] += out.nbytes
    sp = (_obs.begin("launch")
          if _prof._is_profiler_enabled or _obs.switch else None)
    check(lib().kofft_goertzel_scan(
        x2.data_ptr(), out.data_ptr(), rows, n, coeff, x2.device.index,
        _stream(x2.device)), "goertzel_scan launch")
    if sp:
        _obs.end(sp)
    launches["goertzel_scan"] += 1
    return out


def goertzel_scan(x, sample_rate: float, target_freq: float, device="cuda"):
    """The literal Goertzel recurrence over the last axis, in float32;
    returns the magnitudes of shape ``x.shape[:-1]``."""
    x = _real_tensor(x, device, "goertzel")
    _check_rate(sample_rate)
    n = x.shape[-1]
    k = _bin_of(n, sample_rate, target_freq)
    coeff = float(np.float32(2.0 * math.cos(2.0 * math.pi * k / n)))
    x2 = x.to(torch.float32).reshape(-1, n).contiguous()
    return scan_rows(x2, coeff).reshape(x.shape[:-1])
