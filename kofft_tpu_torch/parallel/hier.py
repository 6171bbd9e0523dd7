"""Two-level (slice, chip) mesh programs: the ICI + DCN hierarchy.

The counterpart of ``kofft_tpu.parallel.hier``. A flat all_to_all over
s * c devices makes every pair a peer; on a multi-slice deployment most
pairs then cross the slower inter-slice link with small messages. Here
each global re-pencil is TWO tiled all_to_alls (``_hier_repencil``):

    1. over the "chip" dimension (c peers, inside a slice: ICI)
    2. over the "slice" dimension (s peers, across slices: DCN)

The slice leg moves exactly the (s-1)/s share that must cross slices, in
s-1 large messages. The nested redistribution assigns digit ranges
chip-major, slice-minor, so offsets, row un-permutes and the output's
block order follow the nested digits: the outputs are DTensors on the
mesh's (chip, slice) view (``mesh._nested``), whose ``(Shard(a),
Shard(a))`` orders blocks chip-major as JAX's ``P((chip, slice))``.

The 1-D programs' local DFTs run on the plain engine ``_fft_planes``; the
N-D programs take the port's ``_fftn_planes`` with the backend asked for,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..errors import InvalidValueError, require
from ..ops.ndfft import _fftn_planes
from ..plan import tables
from .fft_sharded import _check_split, _dft, _twiddle, _unit_phases
from .mesh import _axis, _dtensor, _local, _mesh, _nested, _shape
from .ndfft_sharded import _a2a, _check_nd, _wait

__all__ = ["make_hier_mesh", "fft_sharded_hier", "fftn_sharded_hier",
           "ifftn_sharded_hier", "ifft_sharded_hier"]


def make_hier_mesh(n_slices: int, chips_per_slice: int,
                   names=("slice", "chip"), device="cuda"):
    """A (slice, chip) DeviceMesh over ranks 0 … s*c - 1, row-major: rows
    are slices (the DCN dimension), columns chips (the ICI dimension)."""
    return _mesh((n_slices, chips_per_slice), tuple(names), device)


def _axes(mesh):
    s_name, c_name = mesh.mesh_dim_names
    return _axis(mesh, s_name), _axis(mesh, c_name)


def _default(mesh):
    """``mesh``, or a (1, world) mesh over the default group's world."""
    if mesh is not None:
        return mesh
    return make_hier_mesh(1, dist.get_world_size()
                          if dist.is_initialized() else 1)


def _hier_twiddles(n: int, n1: int, n2: int, s: int, c: int, dtype: str,
                   k_chunks: int = 1):
    """Separable twiddle for the nested j2 digits: base rows t in
    [0, n2/(K s c)) and one offset row per (chunk, slice, chip),
    off(k, sigma, gamma) = k (n2/K) + gamma (n2/(K c)) + sigma (n2/(K s c)),
    row k s c + sigma c + gamma. Host float64, exact integer phase mod n."""
    def build():
        ca = n2 // k_chunks
        rows = ca // (s * c)
        k1 = np.arange(n1, dtype=np.int64)
        ks = np.arange(k_chunks, dtype=np.int64)[:, None, None] * ca
        sg = np.arange(s, dtype=np.int64)[None, :, None] * rows
        gm = np.arange(c, dtype=np.int64)[None, None, :] * (ca // c)
        return (*_unit_phases(np.arange(rows, dtype=np.int64), k1, n, dtype),
                *_unit_phases((ks + sg + gm).reshape(-1), k1, n, dtype))

    return tables.custom(("fft_hier_tw", n, n1, n2, s, c, dtype, k_chunks),
                         build)


class _Legs:
    """A sequence of tiled all_to_alls on one tensor: the first is issued
    now, ``wait()`` waits on it and runs the others in turn."""

    def __init__(self, a: torch.Tensor, legs: list):
        self._legs = legs[1:]
        self._first = _a2a(a, *legs[0])

    def wait(self) -> torch.Tensor:
        a = self._first.wait()
        for leg in self._legs:
            a = _a2a(a, *leg).wait()
        return a


def _hier_repencil(a, chip, slc, split_axis: int = 1,
                   concat_axis: int = 0) -> _Legs:
    """The two-level redistribution: the chip (ICI) leg first, then the
    slice (DCN) leg. The order is a correctness invariant (the nested
    digit assignment, the per-tier audit and every un-permute depend on
    it), so every hierarchical program re-pencils through here."""
    return _Legs(a, [(chip, split_axis, concat_axis),
                     (slc, split_axis, concat_axis)])


def _seq_1d(xr, xi, slc, chip, n, n1, n2, backend, dtype):
    s, c = slc.size, chip.size
    d = s * c
    m1, r1 = n1 // d, n2 // d
    tw = _hier_twiddles(n, n1, n2, s, c, dtype)
    xr, xi = xr.reshape(m1, n2), xi.reshape(m1, n2)
    # rows gathered in the slice then across slices stay ascending; the
    # columns land at the nested (chip-major) digit offset
    xr, xi = _wait(_hier_repencil(xr, chip, slc),
                   _hier_repencil(xi, chip, slc))            # (n1, r1)
    yr, yi = _dft(xr, xi, n1, backend, dtype)                # (r1, n1)
    tr, ti = _twiddle(yr, yi, tw, slc.me * c + chip.me)
    # rows arrive (sigma', gamma', t), j2 = gamma' n2/c + sigma' r1 + t
    tr, ti = (a.reshape(s, c, r1, m1).transpose(0, 1).reshape(n2, m1)
              for a in _wait(_hier_repencil(tr, chip, slc),
                             _hier_repencil(ti, chip, slc)))
    zr, zi = _dft(tr, ti, n2, backend, dtype)                # (m1, n2)
    # rows arrive (sigma', gamma', u), k1 = gamma' n1/c + sigma' m1 + u
    zr, zi = (a.reshape(s, c, m1, r1).transpose(0, 1).reshape(n1, r1).t()
              for a in _wait(_hier_repencil(zr, chip, slc),
                             _hier_repencil(zi, chip, slc)))
    return zr.reshape(-1), zi.reshape(-1)


def _overlap_1d(xr, xi, slc, chip, n, n1, n2, backend, dtype, k_chunks):
    """K chunk chains per stage, each re-pencil a chip leg then a slice
    leg, so chunk k+1's legs (the DCN leg too) fly while chunk k's DFT
    runs; the nested digits compose with the chunk offsets. Natural-order
    output equal to the sequential hierarchical program's."""
    s, c = slc.size, chip.size
    d = s * c
    require(n1 % (d * k_chunks) == 0 and n2 % (d * k_chunks) == 0,
            InvalidValueError,
            f"overlap={k_chunks} needs n1={n1} and n2={n2} divisible by "
            f"mesh_size*overlap = {d * k_chunks}")
    tw = _hier_twiddles(n, n1, n2, s, c, dtype, k_chunks)
    ca, cb = n2 // k_chunks, n1 // k_chunks
    ra, rb = ca // d, cb // d
    xr, xi = xr.reshape(n1 // d, n2), xi.reshape(n1 // d, n2)
    sent = [(_hier_repencil(xr[:, k * ca:(k + 1) * ca], chip, slc),
             _hier_repencil(xi[:, k * ca:(k + 1) * ca], chip, slc))
            for k in range(k_chunks)]
    ys = []
    for k, (pr, pi) in enumerate(sent):
        yr, yi = _dft(*_wait(pr, pi), n1, backend, dtype)    # (ra, n1)
        ys.append(_twiddle(yr, yi, tw, k * d + slc.me * c + chip.me))
    # rows (k, t): j2 = k ca + gamma ca/c + sigma ra + t
    yr = torch.cat([y[0] for y in ys])
    yi = torch.cat([y[1] for y in ys])
    sent = [(_hier_repencil(yr[:, q * cb:(q + 1) * cb], chip, slc),
             _hier_repencil(yi[:, q * cb:(q + 1) * cb], chip, slc))
            for q in range(k_chunks)]
    back = []
    for pr, pi in sent:
        # rows (sigma', gamma', k, t) -> ascending j2 = (k, gamma', sigma', t)
        sr, si = (a.reshape(s, c, k_chunks, ra, rb).permute(2, 1, 0, 3, 4)
                  .reshape(n2, rb) for a in _wait(pr, pi))
        zr, zi = _dft(sr, si, n2, backend, dtype)            # (rb, n2)
        back.append((_hier_repencil(zr, chip, slc),
                     _hier_repencil(zi, chip, slc)))
    outs = [tuple(a.reshape(s, c, rb, n2 // d).transpose(0, 1)
                  .reshape(cb, n2 // d).t() for a in _wait(pr, pi))
            for pr, pi in back]
    zr = torch.cat([o[0] for o in outs], dim=1)              # (n2/d, n1)
    zi = torch.cat([o[1] for o in outs], dim=1)
    return zr.reshape(-1), zi.reshape(-1)


def fft_sharded_hier(xr, xi, mesh=None, inverse: bool = False,
                     backend: str = "torch", n1: Optional[int] = None,
                     overlap: int = 1):
    """Distributed 1-D DFT over a (slice, chip) mesh, natural-order output
    (``fft_sharded``'s ``restore_layout=True`` contract): input sharded
    slice-major, output a DTensor whose gathered value equals the FFT.
    Every re-pencil is a chip all_to_all then a slice all_to_all: 6
    collectives per plane pair; ``overlap=K`` runs K chunk chains per
    stage."""
    mesh = _default(mesh)
    require(mesh.ndim == 2, InvalidValueError,
            "fft_sharded_hier needs a 2-D (slice, chip) mesh")
    shape = _shape(xr)
    require(len(shape) == 1 and shape == _shape(xi), InvalidValueError,
            "fft_sharded_hier takes flat 1-D (re, im) planes")
    require(overlap >= 1, InvalidValueError, "overlap must be >= 1")
    n = shape[0]
    n1, n2 = _check_split(n, n1, mesh.size())
    slc, chip = _axes(mesh)
    place = (Shard(0), Shard(0))
    xr, xi = _local(xr, mesh, place), _local(xi, mesh, place)
    if inverse:
        xi = -xi
    dtype = str(xr.dtype).replace("torch.", "")
    if overlap > 1:
        yr, yi = _overlap_1d(xr, xi, slc, chip, n, n1, n2, backend, dtype,
                             overlap)
    else:
        yr, yi = _seq_1d(xr, xi, slc, chip, n, n1, n2, backend, dtype)
    if inverse:
        yr, yi = yr / n, -yi / n
    view = _nested(mesh)
    return (_dtensor(yr.contiguous(), view, place),
            _dtensor(yi.contiguous(), view, place))


def ifft_sharded_hier(xr, xi, mesh=None, backend: str = "torch",
                      n1: Optional[int] = None, overlap: int = 1):
    return fft_sharded_hier(xr, xi, mesh=mesh, inverse=True,
                            backend=backend, n1=n1, overlap=overlap)


def _restore(a, slc, chip, nd: int) -> _Legs:
    """Back to axis-0 sharding: the slice leg, then the chip leg."""
    return _Legs(a, [(slc, 0, nd - 1), (chip, 0, nd - 1)])


def fftn_sharded_hier(xr, xi, mesh=None, inverse: bool = False,
                      backend: str = "torch", restore_layout: bool = False,
                      overlap: int = 1):
    """Distributed N-D FFT over a (slice, chip) mesh: the pencil
    redistribution runs as chip then slice all_to_alls. Output sharded on
    the last axis in nested (chip, slice) order unless ``restore_layout``;
    the gathered value equals :func:`fftn_sharded`'s. ``overlap=K`` runs K
    chunk chains (``restore_layout=True`` and the last axis divisible by
    mesh_size * K)."""
    mesh = _default(mesh)
    require(mesh.ndim == 2, InvalidValueError,
            "fftn_sharded_hier needs a 2-D (slice, chip) mesh")
    shape = _shape(xr)
    require(len(shape) >= 2 and shape == _shape(xi), InvalidValueError,
            "fftn_sharded_hier takes >= 2-D equal-shape planes")
    _check_nd(shape, mesh.size(), restore_layout, overlap,
              "fftn_sharded_hier")
    slc, chip = _axes(mesh)
    nd = len(shape)
    place_in = (Shard(0), Shard(0))
    xr, xi = _local(xr, mesh, place_in), _local(xi, mesh, place_in)
    if overlap > 1:
        # the last axis first; then per output-column chunk: middle axes,
        # re-pencil, axis 0, restore (which inverts the re-pencil per
        # chunk, so the chunks side by side rebuild the input layout)
        xr, xi = _fftn_planes(xr, xi, (nd - 1,), inverse, backend)
        ck = xr.shape[-1] // overlap
        mids = tuple(range(1, nd - 1))
        fwd = []
        for k in range(overlap):
            cr, ci = xr[..., k * ck:(k + 1) * ck], xi[..., k * ck:(k + 1) * ck]
            if mids:
                cr, ci = _fftn_planes(cr, ci, mids, inverse, backend)
            fwd.append((_hier_repencil(cr, chip, slc, nd - 1, 0),
                        _hier_repencil(ci, chip, slc, nd - 1, 0)))
        back = []
        for pr, pi in fwd:
            cr, ci = _fftn_planes(*_wait(pr, pi), (0,), inverse, backend)
            back.append((_restore(cr, slc, chip, nd),
                         _restore(ci, slc, chip, nd)))
        outs = [_wait(pr, pi) for pr, pi in back]
        yr = torch.cat([o[0] for o in outs], dim=-1)
        yi = torch.cat([o[1] for o in outs], dim=-1)
    else:
        local_axes = tuple(range(1, nd))
        if local_axes:
            xr, xi = _fftn_planes(xr, xi, local_axes, inverse, backend)
        # the last axis lands at the nested (chip-major) digit
        xr, xi = _wait(_hier_repencil(xr, chip, slc, nd - 1, 0),
                       _hier_repencil(xi, chip, slc, nd - 1, 0))
        yr, yi = _fftn_planes(xr, xi, (0,), inverse, backend)
        if restore_layout:
            yr, yi = _wait(_restore(yr, slc, chip, nd),
                           _restore(yi, slc, chip, nd))
    if restore_layout:
        mesh_out, place = mesh, place_in
    else:
        mesh_out, place = _nested(mesh), (Shard(nd - 1), Shard(nd - 1))
    return (_dtensor(yr.contiguous(), mesh_out, place),
            _dtensor(yi.contiguous(), mesh_out, place))


def ifftn_sharded_hier(xr, xi, mesh=None, backend: str = "torch",
                       restore_layout: bool = False, overlap: int = 1):
    return fftn_sharded_hier(xr, xi, mesh=mesh, inverse=True,
                             backend=backend, restore_layout=restore_layout,
                             overlap=overlap)
