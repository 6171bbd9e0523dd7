"""The kernel FFT as differentiable PyTorch ops: the counterpart of
``kofft_tpu.ops.pallas_fft``'s linear primitives.

The DFT is linear with a symmetric matrix, so the backward of the planes
map is the same transform in the other direction (the unnormalized
inverse of the cotangent, pallas_fft.py:105-110) and the forward-mode
derivative is the same transform of the tangents (:95-99). Both run the
same kernels, so no backward kernel exists or is needed; bfloat16 planes
pass through unchanged, and their bf16 cotangents and tangents take the
same bf16 forms. The real FFT's
backward zero-pads the one-sided cotangent and takes the real plane of
the unnormalized complex inverse (pallas_fft.py:166-178). The N-D route
is one op (``_KernelND``); every per-axis DFT matrix is symmetric, so the
same argument holds axis by axis (pallas_fft.py:227-234).

``torch.func.vmap`` (the counterpart of the primitives' batching rules,
pallas_fft.py:115-128): each op's ``vmap`` rule moves the mapped dim to
the front (or expands an unmapped input) and folds it into the batch of
one call, so the kernels see plain tensors with a real ``data_ptr()``;
the N-D route keeps that dim out of its transformed axes.

A backward or forward-mode derivative runs at the precision tier its
forward ran at, stored in ``ctx`` and set by ``config.precision_scope``:
autograd calls ``backward`` after a scoped tier change such as the
ISTFT's synthesis lift has been undone, and the routes read the tier
(the `default` tier's bf16 casts).
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..config import get_config, precision_scope
from .hopper_kernels import (_pow2_split, axes_fft_planes,
                             fused_multilevel_fft, fused_multilevel_rfft)


def kernel_supported(n: int, dtype: str) -> bool:
    """Which (n, dtype) the stage kernels serve: smooth n = odd * 2^k
    (odd <= 23) in [2^14, 2^26] on float32 or bfloat16 planes
    (``pallas_supported``, pallas_fft.py:40-47). bf16 planes keep bf16
    I/O where the JAX package's phased grid serves them and run the
    float32 kernels otherwise (``fused_multilevel_fft``)."""
    return dtype in ("float32", "bfloat16") and _pow2_split(n) is not None


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t.contiguous()


def _batched(info, in_dims, *xs):
    """The inputs of a vmapped call with the mapped dim in front: moved
    there, or an unmapped input expanded to the batch."""
    return tuple(
        x.unsqueeze(0).expand(info.batch_size, *x.shape).contiguous()
        if d is None else x.movedim(d, 0).contiguous()
        for x, d in zip(xs, in_dims))


class _KernelFFT(torch.autograd.Function):
    @staticmethod
    def forward(xr, xi, n, inverse):
        return fused_multilevel_fft(xr, xi, n, inverse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.inverse = inputs[2], inputs[3]
        ctx.like = inputs[0].detach()
        ctx.tier = get_config().precision

    @staticmethod
    def backward(ctx, gr, gi):
        gr = _zeros_if_none(gr, ctx.like)
        gi = _zeros_if_none(gi, ctx.like)
        with precision_scope(ctx.tier):
            yr, yi = _KernelFFT.apply(gr, gi, ctx.n, not ctx.inverse)
        return yr, yi, None, None

    @staticmethod
    def jvp(ctx, tr, ti, _n, _inverse):
        tr = _zeros_if_none(tr, ctx.like)
        ti = _zeros_if_none(ti, ctx.like)
        with precision_scope(ctx.tier):
            return fused_multilevel_fft(tr, ti, ctx.n, ctx.inverse)

    @staticmethod
    def vmap(info, in_dims, xr, xi, n, inverse):
        xr, xi = _batched(info, in_dims[:2], xr, xi)
        return _KernelFFT.apply(xr, xi, n, inverse), (0, 0)


def _tracked(xr, xi) -> bool:
    """Whether autograd or a ``torch.func`` transform (vmap, grad, jvp)
    has to see the op. Untracked calls skip ``autograd.Function.apply``,
    whose argument binding costs tens of microseconds of host time on the
    host-bound 2^20 path. One tensor is asked as ``_tracked(x, x)``, and
    its forward-AD tangent is read once."""
    if torch._C._are_functorch_transforms_active():
        return True
    if torch.is_grad_enabled() and (xr.requires_grad or xi.requires_grad):
        return True
    return (fwAD.unpack_dual(xr).tangent is not None
            or (xi is not xr and fwAD.unpack_dual(xi).tangent is not None))


def kernel_fft_planes(xr, xi, n: int, inverse: bool, donate: bool = False):
    """Unnormalized DFT (inverse: n * ifft) of (..., n) float32 or bf16 planes
    through the stage kernels, differentiable in both modes. With
    ``donate`` (and no gradient to track) the result is written into the
    input planes' storage."""
    xr = xr.contiguous()
    xi = xi.contiguous()
    if not _tracked(xr, xi):
        return fused_multilevel_fft(xr, xi, n, inverse, donate=donate)
    return _KernelFFT.apply(xr, xi, n, bool(inverse))


def kernel_tiled_planes(ar, ai, inverse: bool = False,
                        donate: bool = False):
    """:func:`kernel_fft_planes` on tiled (b, m, m) planes, n = m*m (the
    contract of the JAX package's tiled entry): the (b, n) batch runs the
    stage kernels, and the (b, n2, n1) result is the natural-order
    spectrum in row-major order."""
    b, m = ar.shape[0], ar.shape[-1]
    yr, yi = kernel_fft_planes(ar.reshape(b, m * m), ai.reshape(b, m * m),
                               m * m, inverse, donate)
    return yr.reshape(b, m, m), yi.reshape(b, m, m)


class _KernelRFFT(torch.autograd.Function):
    @staticmethod
    def forward(x, n):
        return fused_multilevel_rfft(x, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n = inputs[1]
        ctx.tier = get_config().precision

    @staticmethod
    def backward(ctx, gr, gi):
        # transpose of (real -> one-sided planes): zero-pad the cotangent
        # (materialized by autograd) to the full spectrum, then the real
        # plane of the unnormalized inverse
        pad = (0, ctx.n - gr.shape[-1])
        with precision_scope(ctx.tier):
            xr, _ = _KernelFFT.apply(torch.nn.functional.pad(gr, pad),
                                     torch.nn.functional.pad(gi, pad),
                                     ctx.n, True)
        return xr, None

    @staticmethod
    def jvp(ctx, t, _n):
        # x is the only tensor input, so its tangent is never None here
        with precision_scope(ctx.tier):
            return fused_multilevel_rfft(t.contiguous(), ctx.n)

    @staticmethod
    def vmap(info, in_dims, x, n):
        (x,) = _batched(info, in_dims[:1], x)
        return _KernelRFFT.apply(x, n), (0, 0)


def kernel_rfft_planes(x, n: int):
    """One-sided unnormalized DFT (..., n//2 + 1) of a real (..., n)
    float32 or bf16 plane through the real stage kernels, differentiable in
    both modes."""
    x = x.contiguous()
    if not _tracked(x, x):
        return fused_multilevel_rfft(x, n)
    return _KernelRFFT.apply(x, n)


class _KernelND(torch.autograd.Function):
    """The N-D route over the planes' dims after the first ``lead``
    (``axes_fft_planes``)."""

    @staticmethod
    def forward(xr, xi, inverse, lead):
        return axes_fft_planes(xr, xi, inverse, lead)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.inverse, ctx.lead = inputs[2:]
        ctx.like = inputs[0].detach()
        ctx.tier = get_config().precision

    @staticmethod
    def backward(ctx, gr, gi):
        with precision_scope(ctx.tier):
            yr, yi = _KernelND.apply(_zeros_if_none(gr, ctx.like),
                                     _zeros_if_none(gi, ctx.like),
                                     not ctx.inverse, ctx.lead)
        return yr, yi, None, None

    @staticmethod
    def jvp(ctx, tr, ti, _inverse, _lead):
        with precision_scope(ctx.tier):
            return axes_fft_planes(_zeros_if_none(tr, ctx.like),
                                   _zeros_if_none(ti, ctx.like), ctx.inverse,
                                   ctx.lead)

    @staticmethod
    def vmap(info, in_dims, xr, xi, inverse, lead):
        xr, xi = _batched(info, in_dims[:2], xr, xi)
        return _KernelND.apply(xr, xi, inverse, lead + 1), (0, 0)


def kernel_nd_planes(xr, xi, inverse: bool, lead: int = 0):
    """Unnormalized DFT (inverse: N * ifftn) of float32 planes over every
    dim after the first ``lead`` through the axis kernels
    (``axes_fft_planes``), differentiable in both modes and under
    ``torch.func.vmap``."""
    xr = xr.contiguous()
    xi = xi.contiguous()
    if not _tracked(xr, xi):
        return axes_fft_planes(xr, xi, inverse, lead)
    return _KernelND.apply(xr, xi, bool(inverse), lead)
