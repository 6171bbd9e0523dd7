"""Core complex FFT engine and the public 1-D entries.

The counterpart of ``kofft_tpu.ops.fft``. The engine ladder is the same:

    smooth n the stage kernels serve -> hand-written CUDA kernels
                                        (plain versions for CPU tensors)
    batched mid-size pow2 (cufft zone) -> torch.fft (cuFFT on the card)
    n <= dft_cutoff                    -> direct DFT matmul
    other smooth n                     -> recursive Bailey four-step tree
    non-smooth n                       -> Bluestein chirp-Z

Everything computes on split (re, im) float planes. A tensor is computed
on the device where it lies; a numpy input is placed on ``device``
(default ``"cuda"``, the card; ``device="cpu"`` computes host data on
the CPU, and with no card the default raises). Normalization follows
numpy: forward unscaled, inverse 1/n.
"""

from __future__ import annotations

from typing import Optional

import numpy as _np
import torch

from ..config import get_config
from ..errors import (EmptyInputError, InvalidValueError,
                      MismatchedLengthsError, require)
from ..plan import (DftLeaf, FourStepNode, balanced_split,
                    build_factor_tree, is_smooth, tables)
from ._complex import (cmatmul_last, cmul, const, dtype_name,
                       host_device, host_float_dtype, merge, split)

_NORMS = (None, "backward", "ortho", "forward")
_STRATEGIES = ("auto", "dft", "four_step", "bluestein")


# --------------------------------------------------------------------------
# plain engines (matrix products outside any kernel)
# --------------------------------------------------------------------------

def _apply_tree(xr, xi, tree, dtype: str):
    """Apply the DFT described by ``tree`` along the last axis."""
    if isinstance(tree, DftLeaf):
        fr, fi = tables.dft_matrix(tree.n, dtype)
        return cmatmul_last(xr, xi, fr, fi)
    assert isinstance(tree, FourStepNode)
    n1, n2 = tree.n1, tree.n2
    batch = xr.shape[:-1]
    # A[j1, j2] = x[j1*n2 + j2]; DFT_{n1} over j1 with j1 moved last
    ar = xr.reshape(*batch, n1, n2).transpose(-1, -2)
    ai = xi.reshape(*batch, n1, n2).transpose(-1, -2)
    br, bi = _apply_tree(ar, ai, tree.left, dtype)       # (..., j2, k1)
    twr, twi = tables.twiddle(n1, n2, dtype)             # W[k1, j2]
    dev = xr.device
    cr, ci = cmul(br, bi, const(twr, dev).T, const(twi, dev).T)
    cr = cr.transpose(-1, -2)                            # (..., k1, j2)
    ci = ci.transpose(-1, -2)
    dr, di = _apply_tree(cr, ci, tree.right, dtype)      # (..., k1, k2)
    # X[k1 + n1*k2] = D[k1, k2]
    dr = dr.transpose(-1, -2).reshape(*batch, tree.n)
    di = di.transpose(-1, -2).reshape(*batch, tree.n)
    return dr, di


def _d2_zone(n: int, dtype: str) -> bool:
    """Shape class of the two-GEMM route below: smooth n in [2^16, 2^22]
    with a balanced split whose factors lie in [32, 2048], on the
    `default` tier only. The predicate is the JAX package's, measured on
    a TPU v5e; re-measuring it on the H100 is queued."""
    if get_config().precision != "default" or dtype != "float32":
        return False
    if not ((1 << 16) <= n <= (1 << 22)) or not is_smooth(n):
        return False
    n1, n2 = balanced_split(n)
    return max(n1, n2) <= 2048 and min(n1, n2) >= 32


def _d2_dense_planes(xr, xi, n: int, dtype: str):
    """Forward unnormalized DFT for smooth n = n1*n2 as two dense
    contractions with no transposes:

        B[..., k0, j1] = sum_j0 F_{n1}[j0, k0] * A[..., j0, j1]
        C               = B * W,  W[k0, j1] = w_n^{k0 j1}
        Y[..., k1, k0] = sum_j1 F_{n2}[j1, k1] * C[..., k0, j1]

    Y's row-major flattening is the natural-order spectrum."""
    n1, n2 = balanced_split(n)
    dev = xr.device
    f1r, f1i = (const(a, dev) for a in tables.dft_matrix(n1, dtype))
    f2r, f2i = (const(a, dev) for a in tables.dft_matrix(n2, dtype))
    wr, wi = (const(a, dev) for a in tables.twiddle(n1, n2, dtype))
    batch = xr.shape[:-1]
    ar = xr.reshape(*batch, n1, n2)
    ai = xi.reshape(*batch, n1, n2)

    def gauss(sub, mr, mi, vr, vi):
        t1 = torch.einsum(sub, mr, vr)
        t2 = torch.einsum(sub, mi, vi)
        t3 = torch.einsum(sub, mr + mi, vr + vi)
        return t1 - t2, t3 - t1 - t2

    br, bi = gauss("jk,...jc->...kc", f1r, f1i, ar, ai)   # (..., k0, j1)
    cr = br * wr - bi * wi
    ci = br * wi + bi * wr
    yr, yi = gauss("jk,...cj->...kc", f2r, f2i, cr, ci)   # (..., k1, k0)
    return yr.reshape(*batch, n), yi.reshape(*batch, n)


def _fft_planes(xr, xi, n: int, inverse: bool, backend: str, dtype: str,
                strategy: str = "auto"):
    """Unnormalized forward/inverse DFT on planes along the last axis with
    the plain engines (inverse = n * ifft, by the conjugation identity).
    ``strategy`` pins the algorithm: 'dft' the single matmul, 'four_step'
    the factor tree (smooth n), 'bluestein' the chirp-Z, 'auto' the
    size-based dispatch."""
    if inverse:
        yr, yi = _fft_planes(xr, -xi, n, False, backend, dtype, strategy)
        return yr, -yi
    require(strategy in _STRATEGIES, InvalidValueError,
            f"strategy must be one of {_STRATEGIES}, got {strategy!r}")
    if backend == "naive" or strategy == "dft":
        fr, fi = tables.dft_matrix(n, dtype)
        return cmatmul_last(xr, xi, fr, fi)
    if strategy == "bluestein":
        from .bluestein import _bluestein_planes
        return _bluestein_planes(xr, xi, n, dtype, backend)
    if strategy == "four_step":
        require(is_smooth(n), InvalidValueError,
                f"four_step strategy needs a smooth size, got {n}")
        return _apply_tree(xr, xi, build_factor_tree(n), dtype)
    if is_smooth(n):
        if _d2_zone(n, dtype):
            return _d2_dense_planes(xr, xi, n, dtype)
        return _apply_tree(xr, xi, build_factor_tree(n), dtype)
    from .bluestein import _bluestein_planes
    return _bluestein_planes(xr, xi, n, dtype, backend)


def _norm_scale(n: int, norm: Optional[str], inverse: bool) -> Optional[float]:
    """Scale to apply to the unnormalized engine output."""
    if norm in (None, "backward"):
        return (1.0 / n) if inverse else None
    if norm == "ortho":
        return 1.0 / (n ** 0.5)
    if norm == "forward":
        return (1.0 / n) if not inverse else None
    raise InvalidValueError(f"norm must be one of {_NORMS}, got {norm!r}")


# --------------------------------------------------------------------------
# backend resolution and the engine ladder
# --------------------------------------------------------------------------

def resolve_backend(backend: Optional[str] = None) -> str:
    """The requested backend, or the configured one. 'auto' picks an
    engine per shape class; an explicit name is never rerouted by zone,
    only degraded where the kernels lack the shape ('cuda' -> 'torch')."""
    return backend or get_config().backend


def _cufft_zone(shape, n: int) -> bool:
    """Shape class 'auto' sends to torch.fft: batched mid-size pow2 (n in
    [2^12, 2^16], >= 2^18 points in all) and pow2 n above 2^26. The
    predicate is the JAX package's ``_jnp_fft_zone``, whose thresholds
    were measured on a TPU v5e; re-measuring them on the H100 is
    queued."""
    if n & (n - 1):
        return False
    if n > (1 << 26):
        return True
    if not ((1 << 12) <= n <= (1 << 16)):
        return False
    total = n
    for s in shape[:-1]:
        total *= s
    return total >= (1 << 18)


def engine_fft_planes(xr, xi, n: int, inverse: bool, dtype: str,
                      backend: Optional[str] = None, donate: bool = False):
    """Backend-dispatched unnormalized DFT on planes (inverse = n * ifft):
    the one engine ladder, used by the public entries and by composite
    transforms (Bluestein's inner FFTs, which receive the backend already
    resolved here). The JAX order (``kofft_tpu.ops.fft``:256-277): the
    kernels take bfloat16 planes as they are (their bf16 forms), and only
    engines without a bf16 kernel compute in float32 and round back;
    float64 planes take the plain engines on either device."""
    b = resolve_backend(backend)
    if b == "auto":
        b = "cufft" if _cufft_zone(xr.shape, n) else "cuda"
    if b == "cuda":
        from .hopper_fft import kernel_fft_planes, kernel_supported
        if kernel_supported(n, dtype):
            return kernel_fft_planes(xr, xi, n, inverse, donate)
        b = "torch"
    if dtype == "bfloat16":
        yr, yi = engine_fft_planes(xr.float(), xi.float(), n, inverse,
                                   "float32", b)
        return yr.to(xr.dtype), yi.to(xr.dtype)
    if b == "cufft":
        x = merge(xr, xi)
        y = torch.fft.ifft(x) * n if inverse else torch.fft.fft(x)
        return y.real.contiguous(), y.imag.contiguous()
    return _fft_planes(xr, xi, n, inverse, b, dtype)


def _fft_norm_planes(xr, xi, n: int, inverse: bool, norm: Optional[str],
                     backend: str, donate: bool = False):
    """Planes -> planes DFT along the last axis, normalized: the
    counterpart of ``kofft_tpu.ops.fft._fft_traced_planes``."""
    yr, yi = engine_fft_planes(xr, xi, n, inverse, dtype_name(xr), backend,
                               donate)
    s = _norm_scale(n, norm, inverse)
    if s is not None:
        if donate and not yr.requires_grad:
            yr.mul_(s)
            yi.mul_(s)
        else:
            yr, yi = yr * s, yi * s
    return yr, yi


# --------------------------------------------------------------------------
# input handling
# --------------------------------------------------------------------------

_KEEP = (torch.float32, torch.float64, torch.bfloat16,
         torch.complex64, torch.complex128)


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor stays where it lies; anything else becomes a tensor on
    ``device`` in its working dtype (float64 kept, else float32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _KEEP:
            x = x.to(torch.float32)
        return x
    a = _np.asarray(x)
    if _np.iscomplexobj(a):
        a = a.astype(_np.complex128 if host_float_dtype(a.real.dtype)
                     == _np.float64 else _np.complex64, copy=False)
    else:
        a = a.astype(host_float_dtype(a.dtype), copy=False)
    return torch.as_tensor(_np.ascontiguousarray(a),
                           device=host_device(device))


def _real_tensor(x, device, what: str) -> torch.Tensor:
    """The input of a composite transform (DCT, DST, DHT, Hilbert, CZT,
    cepstrum, Goertzel) as a tensor, non-empty along its last axis.
    bfloat16 computes in float32: the host tables are float32 or
    float64."""
    x = _as_tensor(x, device)
    require(x.dim() >= 1 and x.shape[-1] >= 1, EmptyInputError,
            f"{what} input must be non-empty")
    return x.float() if x.dtype == torch.bfloat16 else x


def _prep(x, n: Optional[int], axis: int, device="cuda"):
    """Move ``axis`` last and pad/trim to ``n`` (numpy semantics).
    Returns (tensor, n)."""
    x = _as_tensor(x, device)
    require(x.dim() >= 1, EmptyInputError, "input must have at least 1 dim")
    ax = axis if axis >= 0 else x.dim() + axis
    require(0 <= ax < x.dim(), InvalidValueError,
            f"axis {axis} out of range for ndim {x.dim()}")
    if ax != x.dim() - 1:
        x = torch.movedim(x, ax, -1)
    m = x.shape[-1]
    require(m >= 1 or (n is not None and n >= 1), EmptyInputError,
            "FFT input must be non-empty")
    if n is not None:
        require(n >= 1, InvalidValueError, f"n must be >= 1, got {n}")
        if n < m:
            x = x[..., :n]
        elif n > m:
            x = torch.cat([x, x.new_zeros((*x.shape[:-1], n - m))], dim=-1)
        m = n
    return x, m


def _dispatch(x, n, axis, norm, inverse, backend, device):
    require(norm in _NORMS, InvalidValueError,
            f"norm must be one of {_NORMS}, got {norm!r}")
    b = resolve_backend(backend)
    x, m = _prep(x, n, axis, device)
    xr, xi = split(x)
    y = merge(*_fft_norm_planes(xr.contiguous(), xi.contiguous(), m,
                                inverse, norm, b))
    ax = axis if axis >= 0 else y.dim() + axis
    if ax != y.dim() - 1:
        y = torch.movedim(y, -1, ax)
    return y


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def fft(x, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None, backend: Optional[str] = None,
        device="cuda"):
    """Complex DFT along ``axis``. Returns a complex tensor on the device
    of ``x`` (a numpy input is placed on ``device`` first)."""
    return _dispatch(x, n, axis, norm, False, backend, device)


def ifft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None, backend: Optional[str] = None,
         device="cuda"):
    """Inverse complex DFT along ``axis`` (1/n backward normalization)."""
    return _dispatch(x, n, axis, norm, True, backend, device)


def _planes(xr, xi, device):
    xr = _as_tensor(xr, device)
    xi = _as_tensor(xi, device)
    # messages are formatted only on failure (this runs on every call)
    require(not (xr.is_complex() or xi.is_complex()), InvalidValueError,
            "planes must be real tensors")
    if xr.shape != xi.shape:
        raise MismatchedLengthsError(
            f"re/im plane shapes differ: {tuple(xr.shape)} vs "
            f"{tuple(xi.shape)}")
    if xr.dtype != xi.dtype or xr.device != xi.device:
        raise InvalidValueError(
            f"re/im planes differ in dtype or device: {xr.dtype} on "
            f"{xr.device} vs {xi.dtype} on {xi.device}")
    return xr, xi


def fft_split(xr, xi, inverse: bool = False, norm: Optional[str] = None,
              backend: Optional[str] = None, donate: bool = False,
              device="cuda"):
    """Split-complex FFT along the last axis: (re, im) planes in and out.

    ``donate=True`` lets the transform reuse the input planes' storage:
    on the kernel path stage 2 reads only the inter-stage matrix C, so it
    writes the output into the input planes (no output allocation). The
    caller must not use the inputs afterwards."""
    xr, xi = _planes(xr, xi, device)
    require(xr.dim() >= 1 and xr.shape[-1] >= 1, EmptyInputError,
            "FFT input must be non-empty")
    n = xr.shape[-1]
    return _fft_norm_planes(xr, xi, n, inverse, norm,
                            resolve_backend(backend), bool(donate))


def ifft_split(xr, xi, norm: Optional[str] = None,
               backend: Optional[str] = None, donate: bool = False,
               device="cuda"):
    return fft_split(xr, xi, inverse=True, norm=norm, backend=backend,
                     donate=donate, device=device)


def tiled_shape(n: int) -> tuple:
    """The (m, m) tiled-plane shape ``fft_split_tiled`` uses for an
    n-point transform (n = m*m, even pow2 exponents 2^14 ... 2^26).
    Flat row-major order of the tiled planes is the 1-D order."""
    from .hopper_kernels import _pow2_split
    sp = _pow2_split(n)
    require(sp is not None and sp[0] == sp[1], InvalidValueError,
            f"tiled layout serves n = m*m (even pow2 exponent); got {n}")
    return sp


def fft_split_tiled(ar, ai, inverse: bool = False, donate: bool = False,
                    device="cuda"):
    """FFT on tiled (..., m, m) planes, n = m*m: flat row-major order is
    the 1-D order on both ends (input = signal, output = natural-order
    spectrum), so pointwise spectral work applies to the tiled planes
    directly. Forward is unnormalized, ``inverse=True`` scales by 1/n.
    ``donate=True`` writes the kernel path's output into the input
    planes' storage, as in :func:`fft_split`."""
    ar, ai = _planes(ar, ai, device)
    require(ar.dim() >= 2, EmptyInputError,
            "tiled planes need >= 2 dims; use tiled_shape(n)")
    m = ar.shape[-1]
    require(ar.shape[-2] == m and tiled_shape(m * m) == (m, m),
            InvalidValueError,
            f"tiled planes must be (..., m, m) with n = m*m served; "
            f"got {tuple(ar.shape[-2:])}")
    n = m * m
    batch = ar.shape[:-2]
    b = 1
    for s in batch:
        b *= s
    a2r = ar.reshape(b, m, m)
    a2i = ai.reshape(b, m, m)
    from .hopper_fft import kernel_supported, kernel_tiled_planes
    if kernel_supported(n, dtype_name(ar)):
        yr, yi = kernel_tiled_planes(a2r, a2i, inverse, bool(donate))
    else:
        yr, yi = engine_fft_planes(a2r.reshape(b, n), a2i.reshape(b, n), n,
                                   inverse, dtype_name(ar))
    if inverse:
        if donate and not yr.requires_grad:
            yr.div_(n)
            yi.div_(n)
        else:
            yr, yi = yr / n, yi / n
    return yr.reshape(*batch, m, m), yi.reshape(*batch, m, m)


def ifft_split_tiled(ar, ai, donate: bool = False, device="cuda"):
    return fft_split_tiled(ar, ai, inverse=True, donate=donate,
                           device=device)


def fftfreq(n: int, d: float = 1.0):
    """Sample frequencies of :func:`fft` (numpy convention, host numpy)."""
    require(n >= 1, EmptyInputError, "fftfreq needs n >= 1")
    return _np.fft.fftfreq(n, d)


def rfftfreq(n: int, d: float = 1.0):
    """Sample frequencies of a real FFT (length n//2 + 1, host numpy)."""
    require(n >= 1, EmptyInputError, "rfftfreq needs n >= 1")
    return _np.fft.rfftfreq(n, d)


def fftshift(x, axes=None):
    """Move the zero-frequency bin to the center. Tensors shift where they
    lie; host inputs stay numpy."""
    if isinstance(x, torch.Tensor):
        return torch.fft.fftshift(x, dim=axes)
    return _np.fft.fftshift(_np.asarray(x), axes=axes)


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift` (exact also for odd lengths)."""
    if isinstance(x, torch.Tensor):
        return torch.fft.ifftshift(x, dim=axes)
    return _np.fft.ifftshift(_np.asarray(x), axes=axes)


def fft_batch(xs, backend: Optional[str] = None, device="cuda"):
    """Batch FFT over the leading dims (the batch is the leading dims)."""
    return fft(xs, axis=-1, backend=backend, device=device)


def ifft_batch(xs, backend: Optional[str] = None, device="cuda"):
    return ifft(xs, axis=-1, backend=backend, device=device)
