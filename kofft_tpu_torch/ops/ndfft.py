"""N-D FFT: the counterpart of ``kofft_tpu.ops.ndfft``.

``_fftn_planes`` tries its routes in the JAX package's order:

    'auto'/'cuda', float32, kernel zone  -> col_fft per axis but the last,
                                            then row_fft (route axes)
    'cufft', or 'auto' in the cuFFT zone -> torch.fft.fftn
    small axes (<= 256)                  -> dense-DFT einsums per axis
    otherwise                            -> per axis, the 1-D engine ladder

The kernel zone (``_kernel_nd_zone``) is the union of the JAX package's
three N-D kernel zones, and every zone lives in this module. The kernel
route takes CUDA tensors to the hand-written kernels and CPU tensors to
their plain versions. An explicit 'cufft' backend takes
``torch.fft.fftn`` over the axes, where the JAX package maps 'jnpfft' to
its XLA engines. Inverse transforms scale by 1/N (numpy). Host input goes
to ``device`` (default ``"cuda"``, the card).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch.autograd import profiler as _prof

from ..config import get_config
from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import tables
from ..utils import observability as _obs
from ._complex import const, dtype_name, merge, split
from .fft import (_as_tensor, _fft_planes, _planes, engine_fft_planes,
                  resolve_backend)
from .hopper_fft import kernel_nd_planes
from .hopper_kernels import _LINE_MAX

__all__ = ["fft2", "ifft2", "fft3", "ifft3", "fftn", "ifftn",
           "fftn_split", "rfftn", "irfftn", "rfftn_split", "irfftn_split"]


# The kernel zone's edges: the JAX package's (pallas_kernels.py:1377-1394,
# :1518-1553, :1759-1777), measured on a TPU v5e; re-measuring them on the
# H100 is queued.
_KERNEL_MIN_SIDE = 128
_ALL_AXES_MAX_SIDE = 512                # every axis transformed
_ALL_AXES_POINTS = (1 << 17, 1 << 21)
_TWO_AXES_POINTS = (1 << 18, 1 << 26)   # the last two axes, per image
# the last two axes: sides above 2048 only above the one-call 2-D kernel's
# cap of points per image
_ONE_CALL_MAX_SIDE = 2048
_ONE_CALL_CAP = 1 << 20
_ONE_CALL_CAP_DEFAULT = 1 << 22


def _kernel_nd_zone(shape: tuple, axes: tuple) -> bool:
    """Shape class of the axis kernels (``hopper_kernels.axes_fft_planes``),
    the union of the JAX package's three N-D kernel zones: power-of-two
    sides of at least 128 points, and
    - every axis transformed, sides up to 512, 2^17 ... 2^21 points
      (the fused all-axes kernel's zone); or
    - the last two axes, sides up to 8192 (``_LINE_MAX``), 2^18 ... 2^26
      points per image, sides above 2048 only above the one-call 2-D
      kernel's cap (2^20 points; 2^22 on `default`), as the two 2-D
      kernels' zones do together (4096 x 128 stays off the kernels)."""
    nd = len(shape)
    ax = sorted(a % nd for a in axes)
    if len(ax) < 2 or ax != list(range(nd - len(ax), nd)):
        return False
    sides = [shape[a] for a in ax]
    if any(s & (s - 1) or s < _KERNEL_MIN_SIDE for s in sides):
        return False
    points = math.prod(sides)
    if (len(ax) == nd and max(sides) <= _ALL_AXES_MAX_SIDE
            and _ALL_AXES_POINTS[0] <= points <= _ALL_AXES_POINTS[1]):
        return True
    cap = (_ONE_CALL_CAP_DEFAULT if get_config().precision == "default"
           else _ONE_CALL_CAP)
    return (len(ax) == 2 and max(sides) <= _LINE_MAX
            and _TWO_AXES_POINTS[0] <= points <= _TWO_AXES_POINTS[1]
            and (points > cap or max(sides) <= _ONE_CALL_MAX_SIDE))


def _nd_cufft_zone(shape: tuple, axes: tuple) -> bool:
    """Shape class 'auto' sends to torch.fft.fftn: >= 2 pow2 axes, each
    in [2^10, 2^16], at >= 2^20 points in all. The predicate is the JAX
    package's ``_nd_jnp_zone``, whose thresholds were measured on a TPU
    v5e; re-measuring them on the H100 is queued."""
    if len(axes) < 2:
        return False
    total = 1
    for s in shape:
        total *= s
    if total < (1 << 20):
        return False
    for a in axes:
        n = shape[a]
        if n & (n - 1) or not ((1 << 10) <= n <= (1 << 16)):
            return False
    return True


_SMALL_AXES_MAX_N = 256


def _small_axes_zone(shape: tuple, axes: tuple) -> bool:
    """Shape class of the per-axis einsum route: >= 2 transform axes, each
    short enough for one dense DFT matmul (<= 256), at most 15 dims (the
    einsum letter pool)."""
    if len(axes) < 2 or len(shape) > 15:
        return False
    return all(2 <= shape[a] <= _SMALL_AXES_MAX_N for a in axes)


def _axis_einsum_planes(xr, xi, axes: tuple, inverse: bool, dtype: str):
    """N-D DFT over small axes as dense-DFT einsums in place of each axis,
    ``Y[a,k,c] = sum_j F[j,k] X[a,j,c]``, with the Gauss three-product.
    The JAX package computes this route outside any Pallas kernel, so it
    is plain ``torch.einsum`` here. Inverse by conjugation, unnormalized
    (the caller scales)."""
    if inverse:
        yr, yi = _axis_einsum_planes(xr, -xi, axes, False, dtype)
        return yr, -yi
    nd = xr.dim()
    ltrs = "abcdefghilmnopq"[:nd]   # j, k reserved for the contraction
    for ax in axes:
        a = ax % nd
        fr, fi = (const(t, xr.device)
                  for t in tables.dft_matrix(xr.shape[a], dtype))
        sub = f"jk,{ltrs[:a]}j{ltrs[a + 1:]}->{ltrs[:a]}k{ltrs[a + 1:]}"
        t1 = torch.einsum(sub, fr, xr)
        t2 = torch.einsum(sub, fi, xi)
        t3 = torch.einsum(sub, fr + fi, xr + xi)
        xr, xi = t1 - t2, t3 - t1 - t2
    return xr, xi


def _inverse_rescale(yr, yi, shape: tuple, axes: tuple, inverse: bool):
    """1/N scaling for routes that return the unnormalized inverse."""
    if not inverse:
        return yr, yi
    scale = 1
    for a in axes:
        scale *= shape[a]
    return yr / scale, yi / scale


def _fftn_planes(xr, xi, axes: tuple, inverse: bool, backend: str):
    """The N-D ladder (:func:`_fftn_route`) as a ``ladder`` span."""
    sp = (_obs.begin("ladder")
          if _prof._is_profiler_enabled or _obs.switch else None)
    try:
        return _fftn_route(xr, xi, axes, inverse, backend)
    finally:
        if sp:
            _obs.end(sp)


def _fftn_route(xr, xi, axes: tuple, inverse: bool, backend: str):
    """The routes of the module docstring, in order; the ``torch.fft``
    route as a ``cufft`` span, the einsums as a ``tree`` span."""
    dtype = dtype_name(xr)
    if dtype == "bfloat16":
        yr, yi = _fftn_planes(xr.float(), xi.float(), axes, inverse, backend)
        return yr.to(xr.dtype), yi.to(xr.dtype)
    shape = tuple(xr.shape)
    nd = xr.dim()
    # the kernel zone goes first: it overlaps the cuFFT zone (1024^2)
    if (backend in ("auto", "cuda") and dtype == "float32"
            and _kernel_nd_zone(shape, axes)):
        yr, yi = kernel_nd_planes(xr, xi, inverse, nd - len(axes))
        return _inverse_rescale(yr, yi, shape, axes, inverse)
    if backend == "cufft" or (backend == "auto"
                              and _nd_cufft_zone(shape, axes)):
        sp = (_obs.begin("cufft")
              if _prof._is_profiler_enabled or _obs.switch else None)
        x = merge(xr, xi)
        y = (torch.fft.ifftn(x, dim=axes) if inverse
             else torch.fft.fftn(x, dim=axes))
        yr, yi = y.real.contiguous(), y.imag.contiguous()
        if sp:
            _obs.end(sp)
        return yr, yi
    if backend in ("auto", "torch", "cuda") and _small_axes_zone(shape, axes):
        sp = (_obs.begin("tree")
              if _prof._is_profiler_enabled or _obs.switch else None)
        yr, yi = _axis_einsum_planes(xr, xi, axes, inverse, dtype)
        if sp:
            _obs.end(sp)
        return _inverse_rescale(yr, yi, shape, axes, inverse)
    for ax in axes:
        a = ax % nd
        if a != nd - 1:
            xr = torch.movedim(xr, a, -1)
            xi = torch.movedim(xi, a, -1)
        n = xr.shape[-1]
        if backend in ("auto", "cuda"):
            xr, xi = engine_fft_planes(xr.contiguous(), xi.contiguous(), n,
                                       inverse, dtype, backend)
        else:
            xr, xi = _fft_planes(xr, xi, n, inverse, backend, dtype)
        if inverse:
            xr, xi = xr / n, xi / n
        if a != nd - 1:
            xr = torch.movedim(xr, -1, a)
            xi = torch.movedim(xi, -1, a)
    return xr, xi


def _norm_axes(ndim: int, axes: Optional[Sequence[int]]) -> tuple:
    if axes is None:
        axes = tuple(range(ndim))
    axes = tuple(int(a) % ndim for a in axes)
    require(len(set(axes)) == len(axes), InvalidValueError,
            f"repeated axes in {axes}")
    return axes


def fftn_split(xr, xi, axes: Optional[Sequence[int]] = None,
               inverse: bool = False, backend: Optional[str] = None,
               device="cuda"):
    """N-D FFT over ``axes`` (default: all) on (re, im) planes; the
    inverse scales by 1/N."""
    sp = (_obs.begin("fftn_split")
          if _prof._is_profiler_enabled or _obs.switch else None)
    try:
        xr, xi = _planes(xr, xi, device)
        require(xr.dim() >= 1, EmptyInputError,
                "fftn input must have >= 1 dim")
        axes = _norm_axes(xr.dim(), axes)
        return _fftn_planes(xr, xi, axes, inverse, resolve_backend(backend))
    finally:
        if sp:
            _obs.end(sp)


def _dispatch_nd(x, axes, inverse: bool, backend, device):
    xr, xi = split(_as_tensor(x, device))
    require(xr.dim() >= 1 and min(xr.shape) >= 1, EmptyInputError,
            "fftn input must be non-empty")
    axes = _norm_axes(xr.dim(), axes)
    return merge(*_fftn_planes(xr.contiguous(), xi, axes, inverse,
                               resolve_backend(backend)))


def fftn(x, axes: Optional[Sequence[int]] = None,
         backend: Optional[str] = None, device="cuda"):
    """N-D FFT over ``axes`` (default: all). Returns a complex tensor on
    the device of ``x`` (a host input is placed on ``device`` first)."""
    return _dispatch_nd(x, axes, False, backend, device)


def ifftn(x, axes: Optional[Sequence[int]] = None,
          backend: Optional[str] = None, device="cuda"):
    """Inverse N-D FFT over ``axes`` (1/N normalization)."""
    return _dispatch_nd(x, axes, True, backend, device)


def _at_least(x, nd: int, what: str, device):
    x = _as_tensor(x, device)
    require(x.dim() >= nd, InvalidValueError, f"{what} needs >= {nd} dims")
    return x


def fft2(x, backend: Optional[str] = None, device="cuda"):
    """2-D FFT over the last two axes."""
    return fftn(_at_least(x, 2, "fft2", device), axes=(-2, -1),
                backend=backend)


def ifft2(x, backend: Optional[str] = None, device="cuda"):
    return ifftn(_at_least(x, 2, "ifft2", device), axes=(-2, -1),
                 backend=backend)


def fft3(x, backend: Optional[str] = None, device="cuda"):
    """3-D FFT over the last three axes."""
    return fftn(_at_least(x, 3, "fft3", device), axes=(-3, -2, -1),
                backend=backend)


def ifft3(x, backend: Optional[str] = None, device="cuda"):
    return ifftn(_at_least(x, 3, "ifft3", device), axes=(-3, -2, -1),
                 backend=backend)


def rfftn_split(x, axes: Optional[Sequence[int]] = None,
                backend: Optional[str] = None, device="cuda"):
    """N-D FFT of a real input on planes (numpy ``rfftn`` convention):
    the one-sided real FFT along the LAST of ``axes`` (length n//2 + 1),
    then the complex FFT over the other axes, each on its own ladder."""
    from .rfft import rfft_split
    x = _as_tensor(x, device)
    require(not x.is_complex(), InvalidValueError, "rfftn input must be real")
    require(x.dim() >= 1 and min(x.shape) >= 1, EmptyInputError,
            "rfftn input must be non-empty")
    axes = _norm_axes(x.dim(), axes)
    require(len(axes) >= 1, InvalidValueError,
            "rfftn needs at least one axis (numpy raises here too)")
    last = axes[-1]
    if last != x.dim() - 1:
        x = torch.movedim(x, last, -1)
    yr, yi = rfft_split(x, backend=backend)
    if last != yr.dim() - 1:
        yr = torch.movedim(yr, -1, last)
        yi = torch.movedim(yi, -1, last)
    if len(axes) > 1:
        yr, yi = fftn_split(yr, yi, axes=axes[:-1], backend=backend)
    return yr, yi


def irfftn_split(yr, yi, n: Optional[int] = None,
                 axes: Optional[Sequence[int]] = None,
                 backend: Optional[str] = None, device="cuda"):
    """Inverse of :func:`rfftn_split` -> real signal. ``n`` sets the last
    transformed axis's output length (default ``2*(shape[axes[-1]] - 1)``,
    numpy convention); the other axes keep their lengths."""
    from .rfft import irfft_split
    yr, yi = _planes(yr, yi, device)
    require(yr.dim() >= 1 and min(yr.shape) >= 1, EmptyInputError,
            "irfftn input must be non-empty")
    axes = _norm_axes(yr.dim(), axes)
    require(len(axes) >= 1, InvalidValueError,
            "irfftn needs at least one axis")
    last = axes[-1]
    if len(axes) > 1:
        yr, yi = fftn_split(yr, yi, axes=axes[:-1], inverse=True,
                            backend=backend)
    if last != yr.dim() - 1:
        yr = torch.movedim(yr, last, -1)
        yi = torch.movedim(yi, last, -1)
    x = irfft_split(yr, yi, n=n, backend=backend)
    return x if last == x.dim() - 1 else torch.movedim(x, -1, last)


def rfftn(x, axes: Optional[Sequence[int]] = None,
          backend: Optional[str] = None, device="cuda"):
    """N-D real FFT (complex output; see :func:`rfftn_split`)."""
    return merge(*rfftn_split(x, axes=axes, backend=backend, device=device))


def irfftn(y, n: Optional[int] = None,
           axes: Optional[Sequence[int]] = None,
           backend: Optional[str] = None, device="cuda"):
    """Inverse N-D real FFT from a complex spectrum (numpy ``irfftn``
    convention for the last transformed axis's length ``n``)."""
    yr, yi = split(_as_tensor(y, device))
    return irfftn_split(yr, yi, n=n, axes=axes, backend=backend)
