"""Mesh-sharded 1-D FFT: the four-step factorization across ranks.

The counterpart of ``kofft_tpu.parallel.fft_sharded``. The flat signal
n = n1 * n2 is the row-major (n1, n2) matrix, rows sharded over the mesh:

    1. all_to_all        (m1, n2)   -> (n1, n2/D)   gather j1, split j2
    2. local DFT_{n1}    over j1 (axis moved last)
    3. twiddle           W[k1, j2] = w_n^{k1 j2} from a base B[t, k1] and
                         this rank's offset row C[c, k1] (host float64,
                         exact integer phase mod n)
    4. all_to_all        (n2/D, n1) -> (n2, n1/D)   gather j2, split k1
    5. local DFT_{n2}    over j2
    -> rank c holds X[k1 + n1*k2] for its n1/D slice of k1 (transposed
       digit order); ``restore_layout=True`` pays a third all_to_all and a
       local transpose for the natural-order spectrum.

The local DFTs run on the plain engine ``_fft_planes`` whatever backend
is given, as in the JAX package. ``overlap=K`` splits each stage into K
chunk chains (``_overlap``): each stage issues its chunks' all_to_alls
before it computes and waits on chunk k just before chunk k's DFT.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import Shard

from ..errors import InvalidValueError, require
from ..ops._complex import const
from ..ops.fft import _fft_planes
from ..plan import tables
from .mesh import _axis, _dtensor, _local, _shape, make_mesh
from .ndfft_sharded import _a2a, _wait

__all__ = ["fft_sharded", "ifft_sharded"]


def _split_for_mesh(n: int, d: int):
    """n = n1 * n2, both divisible by d, as balanced as possible."""
    best = None
    f = 1
    while f * f <= n:
        if n % f == 0:
            n1, n2 = f, n // f
            if n1 % d == 0 and n2 % d == 0:
                best = (n1, n2)
        f += 1
    return best


def _unit_phases(rows: np.ndarray, k1: np.ndarray, n: int, dtype: str):
    """(cos, sin) of -2 pi ((r k) mod n) / n for every row r of ``rows``
    and column k of ``k1``, in ``dtype``: host float64 with the exact
    integer phase mod n, the JAX package's formula, computed in blocks of
    rows on threads (numpy releases the GIL), since the table of a 2^28
    point transform on one rank holds 2^28 entries."""
    cos = np.empty((rows.size, k1.size), dtype)
    sin = np.empty_like(cos)
    step = max(1, (1 << 20) // max(1, k1.size))

    def block(lo):
        hi = min(lo + step, rows.size)
        ang = (-2.0 * np.pi / n) * np.mod(np.outer(rows[lo:hi], k1),
                                          n).astype(np.float64)
        cos[lo:hi] = np.cos(ang)
        sin[lo:hi] = np.sin(ang)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(block, range(0, rows.size, step)))
    return cos, sin


def _twiddle_consts(n: int, n1: int, n2: int, d: int, dtype: str,
                    k_chunks: int = 1):
    """Separable twiddle parts: the base B[t, k1] = w_n^{t k1} for
    t < n2/(d K) and one offset row per (chunk, rank), offset(k, c) =
    k n2/K + c n2/(d K), row k d + c; as (Br, Bi, Cr, Ci)."""
    def build():
        rows = n2 // (d * k_chunks)
        k1 = np.arange(n1, dtype=np.int64)
        ks = np.arange(k_chunks, dtype=np.int64)[:, None] * (n2 // k_chunks)
        cs = np.arange(d, dtype=np.int64)[None, :] * rows
        return (*_unit_phases(np.arange(rows, dtype=np.int64), k1, n, dtype),
                *_unit_phases((ks + cs).reshape(-1), k1, n, dtype))

    return tables.custom(("fft_sharded_tw", n, n1, n2, d, dtype, k_chunks),
                         build)


def _twiddle(yr, yi, tw, row: int):
    """(yr + i yi) * B * C[row]: the twiddle of one rank's (chunk's) rows."""
    br, bi, cr, ci = (const(a, yr.device) for a in tw)
    wr = br * cr[row] - bi * ci[row]
    wi = br * ci[row] + bi * cr[row]
    return yr * wr - yi * wi, yr * wi + yi * wr


def _dft(xr, xi, n: int, backend: str, dtype: str):
    """Local DFT over the first axis of (n, rows) planes, as (rows, n)."""
    return _fft_planes(xr.t().contiguous(), xi.t().contiguous(), n, False,
                       backend, dtype)


def _sequential(xr, xi, axis, n, n1, n2, backend, restore_layout, dtype):
    d = axis.size
    tw = _twiddle_consts(n, n1, n2, d, dtype)
    xr, xi = xr.reshape(n1 // d, n2), xi.reshape(n1 // d, n2)
    xr, xi = _wait(_a2a(xr, axis, 1, 0), _a2a(xi, axis, 1, 0))  # (n1, n2/d)
    yr, yi = _dft(xr, xi, n1, backend, dtype)                   # (n2/d, n1)
    tr, ti = _twiddle(yr, yi, tw, axis.me)
    tr, ti = _wait(_a2a(tr, axis, 1, 0), _a2a(ti, axis, 1, 0))  # (n2, n1/d)
    zr, zi = _dft(tr, ti, n2, backend, dtype)                   # (n1/d, n2)
    if not restore_layout:
        return zr.reshape(-1), zi.reshape(-1)
    zr, zi = _wait(_a2a(zr, axis, 1, 0), _a2a(zi, axis, 1, 0))  # (n1, n2/d)
    return zr.t().reshape(-1), zi.t().reshape(-1)


def _overlap(xr, xi, axis, n, n1, n2, backend, k_chunks, dtype):
    """The chunked four-step (natural order only, equal to the sequential
    program's output):
      stage A  chunk k = j2 columns [k n2/K, (k+1) n2/K): all_to_all
               (gather j1, split j2) -> DFT_{n1} -> twiddle with the
               (chunk, rank) offset row
      stage B  chunk q = k1 columns [q n1/K, (q+1) n1/K) of stage A's
               rows: all_to_all (gather j2, split k1) -> row un-permute
               (c', k, t) -> (k, c', t) -> DFT_{n2} -> restore all_to_all
               (gather k1, split k2)
    The volume is the sequential program's; only the granularity
    changes."""
    d = axis.size
    require(n1 % (d * k_chunks) == 0 and n2 % (d * k_chunks) == 0,
            InvalidValueError,
            f"overlap={k_chunks} needs n1={n1} and n2={n2} divisible by "
            f"mesh_size*overlap = {d * k_chunks}")
    tw = _twiddle_consts(n, n1, n2, d, dtype, k_chunks)
    ca, cb = n2 // k_chunks, n1 // k_chunks
    ra, rb = ca // d, cb // d
    xr, xi = xr.reshape(n1 // d, n2), xi.reshape(n1 // d, n2)
    sent = [(_a2a(xr[:, k * ca:(k + 1) * ca], axis, 1, 0),
             _a2a(xi[:, k * ca:(k + 1) * ca], axis, 1, 0))
            for k in range(k_chunks)]
    ys = []
    for k, (pr, pi) in enumerate(sent):
        yr, yi = _dft(*_wait(pr, pi), n1, backend, dtype)       # (ra, n1)
        ys.append(_twiddle(yr, yi, tw, k * d + axis.me))
    # rows (k, t): j2 = k ca + me ra + t
    yr = torch.cat([y[0] for y in ys])
    yi = torch.cat([y[1] for y in ys])
    sent = [(_a2a(yr[:, q * cb:(q + 1) * cb], axis, 1, 0),
             _a2a(yi[:, q * cb:(q + 1) * cb], axis, 1, 0))
            for q in range(k_chunks)]
    back = []
    for pr, pi in sent:
        sr, si = (a.reshape(d, k_chunks, ra, rb).transpose(0, 1)
                  .reshape(n2, rb) for a in _wait(pr, pi))
        zr, zi = _dft(sr, si, n2, backend, dtype)               # (rb, n2)
        back.append((_a2a(zr, axis, 1, 0), _a2a(zi, axis, 1, 0)))
    outs = [tuple(a.t() for a in _wait(pr, pi)) for pr, pi in back]
    zr = torch.cat([o[0] for o in outs], dim=1)                 # (n2/d, n1)
    zi = torch.cat([o[1] for o in outs], dim=1)
    return zr.reshape(-1), zi.reshape(-1)


def _check_split(n: int, n1: Optional[int], d: int):
    split = (n1, n // n1) if n1 else _split_for_mesh(n, d)
    require(split is not None and n % split[0] == 0
            and split[0] % d == 0 and split[1] % d == 0, InvalidValueError,
            f"n={n} has no n1*n2 factorization with both factors "
            f"divisible by the mesh size {d}")
    return split


def fft_sharded(xr, xi, mesh=None, axis_name: str = "d",
                inverse: bool = False, backend: str = "torch",
                restore_layout: bool = False, n1: Optional[int] = None,
                overlap: int = 1):
    """Distributed 1-D DFT of flat (n,) planes sharded over the mesh:
    DTensors (or tensors / arrays holding the global value on every rank)
    in, ``Shard(0)`` DTensors out.

    ``restore_layout=True`` returns the natural-order spectrum; the default
    returns the transposed-digit layout (element [k1, k2] of the row-major
    (n1, n2) view holds X[k1 + n1 k2]). ``ifft_sharded`` is the
    conjugate-wrapped forward program and takes natural-order input. The
    inverse applies 1/n. ``overlap=K`` (K > 1) runs K chunk chains per
    stage; it needs ``restore_layout=True`` and n1, n2 divisible by
    mesh_size * K."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    axis = _axis(mesh, axis_name)
    shape = _shape(xr)
    require(len(shape) == 1 and shape == _shape(xi), InvalidValueError,
            "fft_sharded takes flat 1-D (re, im) planes")
    require(overlap >= 1, InvalidValueError, "overlap must be >= 1")
    require(overlap == 1 or restore_layout, InvalidValueError,
            "overlap > 1 requires restore_layout=True (natural order)")
    n = shape[0]
    n1, n2 = _check_split(n, n1, axis.size)
    place = (Shard(0),)
    xr, xi = _local(xr, mesh, place), _local(xi, mesh, place)
    if inverse:
        xi = -xi
    dtype = str(xr.dtype).replace("torch.", "")
    if overlap > 1:
        yr, yi = _overlap(xr, xi, axis, n, n1, n2, backend, overlap, dtype)
    else:
        yr, yi = _sequential(xr, xi, axis, n, n1, n2, backend,
                             restore_layout, dtype)
    if inverse:
        yr, yi = yr / n, -yi / n
    return (_dtensor(yr.contiguous(), mesh, place),
            _dtensor(yi.contiguous(), mesh, place))


def ifft_sharded(xr, xi, mesh=None, axis_name: str = "d",
                 backend: str = "torch", restore_layout: bool = False,
                 n1: Optional[int] = None, overlap: int = 1):
    return fft_sharded(xr, xi, mesh=mesh, axis_name=axis_name, inverse=True,
                       backend=backend, restore_layout=restore_layout, n1=n1,
                       overlap=overlap)
