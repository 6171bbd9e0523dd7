"""Real FFT: one-sided ``n//2 + 1`` spectrum, numpy layout.

The counterpart of ``kofft_tpu.ops.rfft``. The forward transform is the
full n-point DFT of the real signal with one side kept; on the kernel path
the real stage kernels read the single real plane and write only the
one-sided bins (``hopper_kernels.fused_multilevel_rfft``). The engine
ladder follows ``kofft_tpu.ops.rfft._rfft_planes``:

    'auto' in the cufft zone          -> torch.fft.rfft
    'cuda' (and 'auto') kernel sizes  -> the real stage kernels
    otherwise                         -> plain _fft_planes of (x, 0), sliced

The inverse rebuilds the Hermitian spectrum with one half-length flip and
keeps the real plane of the full complex inverse (the complex kernels on
kernel sizes), which also drops unrealizable DC/Nyquist imaginary parts
as numpy does. bfloat16 input reaches the kernels' bf16 forms on kernel
sizes and computes in float32 and rounds back elsewhere. Host input goes
to ``device`` (default ``"cuda"``, the card).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd import profiler as _prof

from ..errors import EmptyInputError, InvalidValueError, require
from ..utils import observability as _obs
from ._complex import dtype_name, merge, split
from .fft import (_NORMS, _as_tensor, _cufft_zone, _fft_planes, _norm_scale,
                  _planes, _prep, engine_fft_planes, resolve_backend)
from .hopper_fft import kernel_rfft_planes, kernel_supported

__all__ = ["rfft", "irfft", "rfft_split", "irfft_split"]


def _rfft_planes(x, n: int, backend: str):
    """real (..., n) -> one-sided planes (..., n//2+1), unnormalized. The
    JAX order (``kofft_tpu.ops.rfft``:53-72): bfloat16 input skips the
    cufft-zone reroute and reaches the real kernels' bf16 forms; only
    engines without a bf16 kernel compute in float32 and round back.
    Timed as a ``ladder`` span, the ``torch.fft`` branch as a ``cufft``
    span in it."""
    sp = (_obs.begin("ladder")
          if _prof._is_profiler_enabled or _obs.switch else None)
    try:
        dtype = dtype_name(x)
        b = backend
        if b == "auto":
            b = ("cufft" if dtype != "bfloat16" and _cufft_zone(x.shape, n)
                 else "cuda")
        if b == "cuda":
            if kernel_supported(n, dtype):
                return kernel_rfft_planes(x, n)
            b = "torch"
        if dtype == "bfloat16":
            yr, yi = _rfft_planes(x.float(), n, b)
            return yr.to(x.dtype), yi.to(x.dtype)
        if b == "cufft":
            sc = (_obs.begin("cufft")
                  if _prof._is_profiler_enabled or _obs.switch else None)
            y = torch.fft.rfft(x)
            yr, yi = y.real.contiguous(), y.imag.contiguous()
            if sc:
                _obs.end(sc)
            return yr, yi
        yr, yi = _fft_planes(x, torch.zeros_like(x), n, False, b, dtype)
        return yr[..., : n // 2 + 1], yi[..., : n // 2 + 1]
    finally:
        if sp:
            _obs.end(sp)


def _irfft_planes(yr, yi, n: int, backend: str):
    """one-sided planes (..., n//2+1) -> real (..., n), unnormalized (n*x).
    Like ``kofft_tpu``'s, 'auto' takes no zone reroute here: kernel sizes
    invert on the complex kernels."""
    tail_r = torch.flip(yr[..., 1: (n + 1) // 2], (-1,))
    tail_i = -torch.flip(yi[..., 1: (n + 1) // 2], (-1,))
    fr = torch.cat([yr[..., : n // 2 + 1], tail_r], dim=-1)
    fi = torch.cat([yi[..., : n // 2 + 1], tail_i], dim=-1)
    b = "cuda" if backend == "auto" else backend
    xr, _ = engine_fft_planes(fr, fi, n, True, dtype_name(fr), b)
    return xr


def _check_norm(norm: Optional[str]) -> None:
    require(norm in _NORMS, InvalidValueError,
            f"norm must be one of {_NORMS}, got {norm!r}")


def _scaled(t, n: int, norm: Optional[str], inverse: bool):
    s = _norm_scale(n, norm, inverse)
    return t if s is None else t * s


def _prep_real(x, n: Optional[int], axis: int, device):
    """Real input with ``axis`` moved last and padded/trimmed to ``n``."""
    x = _as_tensor(x, device)
    require(not x.is_complex(), InvalidValueError, "rfft input must be real")
    return _prep(x, n, axis, device)


def _last_axis(t, axis: int):
    ax = axis if axis >= 0 else t.dim() + axis
    return t if ax == t.dim() - 1 else torch.movedim(t, -1, ax)


def rfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, backend: Optional[str] = None,
         device="cuda"):
    """One-sided real FFT (length ``n//2 + 1`` along ``axis``). Returns a
    complex tensor on the device of ``x`` (a host input is placed on
    ``device`` first)."""
    _check_norm(norm)
    b = resolve_backend(backend)
    x, m = _prep_real(x, n, axis, device)
    yr, yi = _rfft_planes(x.contiguous(), m, b)
    return _last_axis(merge(_scaled(yr, m, norm, False),
                            _scaled(yi, m, norm, False)), axis)


def irfft(y, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None, backend: Optional[str] = None,
          device="cuda"):
    """Inverse of :func:`rfft` -> real signal of length ``n`` (default
    ``2*(y.shape[axis]-1)``). A short spectrum is zero-padded, a long one
    truncated, to ``n//2 + 1`` bins."""
    _check_norm(norm)
    b = resolve_backend(backend)
    y = _as_tensor(y, device)
    require(y.dim() >= 1 and y.shape[axis] >= 1, EmptyInputError,
            "irfft input must be non-empty")
    ax = axis if axis >= 0 else y.dim() + axis
    if ax != y.dim() - 1:
        y = torch.movedim(y, ax, -1)
    k = y.shape[-1]
    m = n if n is not None else 2 * (k - 1)
    require(m >= 1, InvalidValueError, f"output length must be >= 1, got {m}")
    want = m // 2 + 1
    if k < want:
        y = torch.cat([y, y.new_zeros((*y.shape[:-1], want - k))], dim=-1)
    elif k > want:
        y = y[..., :want]
    yr, yi = split(y)
    x = _irfft_planes(yr.contiguous(), yi.contiguous(), m, b)
    return _last_axis(_scaled(x, m, norm, True), axis)


def rfft_split(x, norm: Optional[str] = None, backend: Optional[str] = None,
               device="cuda"):
    """Real FFT along the last axis with (re, im) plane outputs."""
    sp = (_obs.begin("rfft_split")
          if _prof._is_profiler_enabled or _obs.switch else None)
    try:
        _check_norm(norm)
        x, n = _prep_real(x, None, -1, device)
        yr, yi = _rfft_planes(x.contiguous(), n, resolve_backend(backend))
        return _scaled(yr, n, norm, False), _scaled(yi, n, norm, False)
    finally:
        if sp:
            _obs.end(sp)


def irfft_split(yr, yi, n: Optional[int] = None, norm: Optional[str] = None,
                backend: Optional[str] = None, device="cuda"):
    """Inverse real FFT from (re, im) planes -> real (..., n), default
    ``n = 2*(k-1)`` for k one-sided bins."""
    _check_norm(norm)
    yr, yi = _planes(yr, yi, device)
    require(yr.dim() >= 1 and yr.shape[-1] >= 1, EmptyInputError,
            "irfft input must be non-empty")
    k = yr.shape[-1]
    m = n if n is not None else 2 * (k - 1)
    require(m >= 1, InvalidValueError, f"output length must be >= 1, got {m}")
    require(k >= m // 2 + 1, InvalidValueError,
            f"irfft_split of n={m} needs {m // 2 + 1} bins, got {k}")
    x = _irfft_planes(yr.contiguous(), yi.contiguous(), m,
                      resolve_backend(backend))
    return _scaled(x, m, norm, True)
