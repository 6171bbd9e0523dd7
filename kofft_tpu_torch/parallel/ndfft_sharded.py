"""Mesh-sharded N-D FFT: slab/pencil decomposition with all_to_all.

The counterpart of ``kofft_tpu.parallel.ndfft_sharded``. Each rank holds
a slab (axis 0 sharded), transforms every local axis with the port's N-D
engine (``_fftn_planes``, with the backend asked for: under ``"cuda"`` a
local slab in ``ndfft._kernel_nd_zone`` rides the axis kernels ``col_fft``
+ ``row_fft``),
then one all_to_all re-pencils the array (axis 0 gathered, the last axis
scattered) and the leading axis is transformed in place.

Layout: input sharded on axis 0 (``Shard(0)``), output sharded on the
last axis (``Shard(ndim - 1)``) unless ``restore_layout``, which pays a
second all_to_all back to ``Shard(0)``.

``_a2a`` is JAX's tiled ``lax.all_to_all`` on ``dist.all_to_all_single``,
issued with ``async_op=True``; every program communicates through it,
and it reports each collective to the open logs (``validate.comm_log``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..errors import InvalidValueError, require
from ..ops.ndfft import _fftn_planes
from . import validate as _log
from .mesh import _axis, _dtensor, _local, _shape, make_mesh

__all__ = ["fftn_sharded", "ifftn_sharded"]


class _A2A:
    """One tiled all_to_all in flight. ``wait()`` returns the received
    chunks concatenated along ``concat_axis`` in group-rank order; the
    send buffer stays referenced until then."""

    def __init__(self, x: torch.Tensor, axis, split_axis: int,
                 concat_axis: int):
        d = axis.size
        xs = x.movedim(split_axis, 0)
        self._send = xs.reshape(d, xs.shape[0] // d,
                                *xs.shape[1:]).contiguous()
        self._recv = torch.empty_like(self._send)
        self._split, self._concat = split_axis, concat_axis
        self._work = dist.all_to_all_single(self._recv, self._send,
                                            group=axis.group, async_op=True)
        _log._issued("all_to_all", axis.name,
                     self._send.numel() * self._send.element_size(), d)

    def wait(self) -> torch.Tensor:
        self._work.wait()
        _log._waited()
        y = self._recv.movedim(1, self._split + 1).movedim(0, self._concat)
        c = self._concat
        out = y.reshape(*y.shape[:c], y.shape[c] * y.shape[c + 1],
                        *y.shape[c + 2:])
        self._send = self._recv = None
        return out


def _a2a(x: torch.Tensor, axis, split_axis: int, concat_axis: int) -> _A2A:
    """Issue JAX's ``all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)`` over the mesh dimension ``axis`` (a ``mesh._Axis``):
    ``x`` is split along ``split_axis`` into ``axis.size`` chunks, chunk j
    goes to coordinate j, and the chunks received concatenate along
    ``concat_axis``. Call ``wait()`` on the result before reading it."""
    return _A2A(x, axis, split_axis, concat_axis)


def _wait(*pending) -> tuple:
    return tuple(p.wait() for p in pending)


def _local_stage(xr, xi, ndim: int, inverse: bool, backend: str, axis):
    """Local axes -> all_to_all -> leading axis."""
    local_axes = tuple(range(1, ndim))
    if local_axes:
        xr, xi = _fftn_planes(xr, xi, local_axes, inverse, backend)
    xr, xi = _wait(_a2a(xr, axis, ndim - 1, 0), _a2a(xi, axis, ndim - 1, 0))
    return _fftn_planes(xr, xi, (0,), inverse, backend)


def _overlap_stage(xr, xi, ndim: int, inverse: bool, backend: str, axis,
                   k_chunks: int):
    """The chunked pipeline (restore layout only). The last axis is
    transformed first (its DFT mixes all its columns); then each chunk of
    its output columns takes the middle axes and issues its all_to_all,
    all K before the first wait, and chunk k is waited on just before its
    leading-axis DFT, after which its restore all_to_all is issued. The
    restores gather chunk k's columns in ascending order, so the chunks
    side by side rebuild the input layout."""
    xr, xi = _fftn_planes(xr, xi, (ndim - 1,), inverse, backend)
    ck = xr.shape[-1] // k_chunks
    mids = tuple(range(1, ndim - 1))
    fwd = []
    for k in range(k_chunks):
        cr, ci = xr[..., k * ck:(k + 1) * ck], xi[..., k * ck:(k + 1) * ck]
        if mids:
            cr, ci = _fftn_planes(cr, ci, mids, inverse, backend)
        fwd.append((_a2a(cr, axis, ndim - 1, 0), _a2a(ci, axis, ndim - 1, 0)))
    back = []
    for pr, pi in fwd:
        cr, ci = _fftn_planes(*_wait(pr, pi), (0,), inverse, backend)
        back.append((_a2a(cr, axis, 0, ndim - 1), _a2a(ci, axis, 0, ndim - 1)))
    outs = [_wait(pr, pi) for pr, pi in back]
    return (torch.cat([o[0] for o in outs], dim=-1),
            torch.cat([o[1] for o in outs], dim=-1))


def _check_nd(shape: tuple, d: int, restore_layout: bool, overlap: int,
              what: str) -> None:
    require(len(shape) >= 2, InvalidValueError,
            f"{what} needs >= 2 dims (use fft_split for 1-D)")
    require(shape[0] % d == 0 and shape[-1] % d == 0, InvalidValueError,
            f"axis 0 ({shape[0]}) and axis -1 ({shape[-1]}) must be "
            f"divisible by the mesh size {d}")
    require(overlap >= 1, InvalidValueError, "overlap must be >= 1")
    require(overlap == 1 or restore_layout, InvalidValueError,
            "overlap > 1 requires restore_layout=True (natural order)")
    require(shape[-1] % (d * overlap) == 0, InvalidValueError,
            f"overlap={overlap} needs axis -1 ({shape[-1]}) divisible by "
            f"mesh_size*overlap = {d * overlap}")


def fftn_sharded(xr, xi, mesh=None, axis_name: str = "d",
                 inverse: bool = False, backend: str = "torch",
                 restore_layout: bool = False, overlap: int = 1):
    """Distributed N-D FFT over all axes of (xr, xi) planes: DTensors (or
    tensors / arrays holding the global value on every rank) in, DTensors
    out. Input is taken sharded on axis 0; output planes are sharded on
    the last axis unless ``restore_layout``. Requires shape[0] and
    shape[-1] divisible by the mesh size; ``overlap=K`` (K > 1) runs the
    chunked pipeline and needs ``restore_layout=True`` and the last axis
    divisible by mesh_size * K. The inverse scales by 1/N."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    axis = _axis(mesh, axis_name)
    shape = _shape(xr)
    require(shape == _shape(xi), InvalidValueError,
            "re/im plane shapes differ")
    _check_nd(shape, axis.size, restore_layout, overlap, "fftn_sharded")
    ndim = len(shape)
    place_in = (Shard(0),)
    xr, xi = _local(xr, mesh, place_in), _local(xi, mesh, place_in)
    if overlap > 1:
        yr, yi = _overlap_stage(xr, xi, ndim, inverse, backend, axis,
                                overlap)
    else:
        yr, yi = _local_stage(xr, xi, ndim, inverse, backend, axis)
        if restore_layout:
            yr, yi = _wait(_a2a(yr, axis, 0, ndim - 1),
                           _a2a(yi, axis, 0, ndim - 1))
    place = place_in if restore_layout else (Shard(ndim - 1),)
    return (_dtensor(yr.contiguous(), mesh, place),
            _dtensor(yi.contiguous(), mesh, place))


def ifftn_sharded(xr, xi, mesh=None, axis_name: str = "d",
                  backend: str = "torch", restore_layout: bool = False,
                  overlap: int = 1):
    return fftn_sharded(xr, xi, mesh=mesh, axis_name=axis_name,
                        inverse=True, backend=backend,
                        restore_layout=restore_layout, overlap=overlap)
