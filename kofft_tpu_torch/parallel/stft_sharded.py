"""Mesh-sharded STFT/ISTFT with a halo exchange between neighbours.

The counterpart of ``kofft_tpu.parallel.stft_sharded``. The signal's time
axis is sharded; each rank computes the frames whose start lies in its
shard and takes the ``win - hop`` samples that spill into its right
neighbour from that neighbour: each rank sends its head to its left
neighbour (``dist.batch_isend_irecv``), and the last shard takes zeros
(the signal's zero padding). The ISTFT overlap-adds its local frames,
sends its ``win - hop`` tail (signal and window-square norm) to its right
neighbour, and the first shard takes zeros; the output is the first
F * hop samples, the streaming "push" region. At d = 1 nothing is sent:
there is no neighbour, and the zeros are what JAX's ring gives.

The hierarchical forms shard (slice-major, chip-minor) over a (slice,
chip) mesh; a halo between neighbours of one slice is an ``ici``
transfer, one across a slice boundary a ``dcn`` transfer, so each
boundary halo crosses the slower tier exactly once. The local DFTs run on
the plain engine ``_fft_planes``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from ..errors import InvalidHopSizeError, InvalidValueError, require
from ..ops._complex import const
from ..ops.fft import _fft_planes
from ..ops.stft import (_frame_indices, _frame_matrix, _ola_add,
                        _window_const)
from . import validate as _log
from .hier import _default
from .mesh import _axis, _dtensor, _in_mesh, _local, _shape, make_mesh

__all__ = ["stft_sharded", "istft_sharded",
           "stft_sharded_hier", "istft_sharded_hier"]


def _exchange(buf: torch.Tensor, mesh, lin: int, d: int, step: int,
              tier) -> torch.Tensor:
    """Send ``buf`` to the shard ``step`` (-1 or +1) away in the linear
    order and return what the shard on the other side sent: zeros where
    that shard does not exist. ``tier(a, b)`` names the transfer between
    linear positions a and b."""
    ranks = mesh.mesh.reshape(-1).tolist()
    group = dist.group.WORLD
    recv = torch.zeros_like(buf)
    ops = []
    dst, src = lin + step, lin - step
    if 0 <= dst < d:
        ops.append(dist.P2POp(dist.isend, buf, ranks[dst], group))
        _log._issued("send", tier(lin, dst), buf.numel() * buf.element_size(),
                     2)
    if 0 <= src < d:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[src], group))
        _log._issued("recv", tier(src, lin),
                     recv.numel() * recv.element_size(), 2)
    for work in (dist.batch_isend_irecv(ops) if ops else ()):
        work.wait()
        _log._waited()
    return recv


def _flat_tier(name: str):
    return lambda a, b: name


def _hier_tier(c: int):
    return lambda a, b: "ici" if a // c == b // c else "dcn"


def _stft_local(xs, w, win: int, hop: int, backend: str, halo_recv):
    """Frame spectra planes (n_local // hop, win) of one shard, its halo
    taken from the right neighbour by ``halo_recv(head)``."""
    halo = max(0, win - hop)
    nf = xs.shape[0] // hop
    ext = torch.cat([xs, halo_recv(xs[:halo].contiguous())]) if halo else xs
    if win % hop == 0:
        frames = _frame_matrix(ext, win, hop, nf)
    else:
        frames = ext[const(_frame_indices(nf, win, hop), ext.device)]
    frames = frames * const(w, ext.device)
    return _fft_planes(frames, torch.zeros_like(frames), win, False,
                       backend, "float32")


def _istft_local(fr, fi, w, win: int, hop: int, backend: str, tail_send):
    """The push region (nf_local * hop,) of one shard's frames, its OLA
    tail sent right by ``tail_send(tail)``, which returns the left
    neighbour's."""
    halo = max(0, win - hop)
    nf = fr.shape[0]
    n_local = nf * hop
    tr, _ = _fft_planes(fr, fi, win, True, backend, "float32")
    y = (tr / win) * const(w, tr.device)
    acc = _ola_add(y, win, hop, nf)
    wsq = const(_window_const(w * w), tr.device)
    norm = _ola_add(wsq.expand(nf, win), win, hop, nf)
    if acc.shape[-1] < n_local + halo:        # win < hop: sparse frames
        pad = n_local + halo - acc.shape[-1]
        acc, norm = F.pad(acc, (0, pad)), F.pad(norm, (0, pad))
    if halo:
        tail_acc = tail_send(acc[n_local:].contiguous())
        tail_norm = tail_send(norm[n_local:].contiguous())
        acc, norm = acc[:n_local].clone(), norm[:n_local].clone()
        acc[:halo] += tail_acc
        norm[:halo] += tail_norm
    else:
        acc, norm = acc[:n_local], norm[:n_local]
    live = norm > 1e-8
    return torch.where(live, acc / torch.where(live, norm, 1.0), acc)


def _window32(window) -> np.ndarray:
    """The window as a cached float32 host table (one array per content,
    so that its device copy is made once)."""
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    return _window_const(np.asarray(window, np.float32))


def _check_signal(signal, hop: int, d: int, what: str) -> int:
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    shape = _shape(signal)
    require(len(shape) == 1, InvalidValueError, f"{what} takes a 1-D signal")
    n = shape[0]
    require(n % (d * hop) == 0, InvalidValueError,
            f"signal length {n} must be divisible by mesh*hop = {d * hop}")
    return n


def _check_frames(fr, fi, w, d: int, what: str) -> None:
    shape = _shape(fr)
    require(len(shape) == 2 and shape == _shape(fi), InvalidValueError,
            f"{what} takes (F, win) planes")
    require(shape[-1] == w.shape[0], InvalidValueError,
            f"frame length {shape[-1]} != window length {w.shape[0]}")
    require(shape[0] % d == 0, InvalidValueError,
            f"frame count {shape[0]} must be divisible by mesh size {d}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def stft_sharded(signal, window, hop: int, mesh=None, axis_name: str = "d",
                 backend: str = "torch"):
    """Distributed STFT of a 1-D signal sharded over the mesh. Requires
    len(signal) divisible by mesh size * hop. Returns (F, win) frame
    spectra planes as ``Shard(0)`` DTensors, the values of the
    single-card two-sided ``stft_split``."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    axis = _axis(mesh, axis_name)
    w = _window32(window)
    _check_signal(signal, hop, axis.size, "stft_sharded")
    xs = _f32(_local(signal, mesh, (Shard(0),)))
    yr, yi = _stft_local(
        xs, w, w.shape[0], hop, backend,
        lambda head: _exchange(head, mesh, axis.me, axis.size, -1,
                               _flat_tier(axis_name)))
    return _dtensor(yr, mesh, (Shard(0),)), _dtensor(yi, mesh, (Shard(0),))


def istft_sharded(fr, fi, window, hop: int, mesh=None, axis_name: str = "d",
                  backend: str = "torch"):
    """Distributed ISTFT of (F, win) frame planes sharded over the frame
    axis: the first F * hop reconstructed samples (the push region) as a
    ``Shard(0)`` DTensor. Requires F divisible by the mesh size."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    axis = _axis(mesh, axis_name)
    w = _window32(window)
    _check_frames(fr, fi, w, axis.size, "istft_sharded")
    place = (Shard(0),)
    out = _istft_local(
        _f32(_local(fr, mesh, place)), _f32(_local(fi, mesh, place)), w,
        w.shape[0], hop, backend,
        lambda tail: _exchange(tail, mesh, axis.me, axis.size, +1,
                               _flat_tier(axis_name)))
    return _dtensor(out, mesh, place)


def _hier(mesh, what: str):
    """(the mesh, its slice count, its chips per slice)."""
    mesh = _default(mesh)
    require(mesh.ndim == 2, InvalidValueError,
            f"{what} needs a 2-D (slice, chip) mesh")
    return mesh, mesh.shape[0], mesh.shape[1]


def stft_sharded_hier(signal, window, hop: int, mesh=None,
                      backend: str = "torch"):
    """Distributed STFT over a (slice, chip) mesh: the time axis sharded
    slice-major, chip-minor; in-slice halos are ``ici`` transfers, each
    slice boundary one ``dcn`` transfer. Values equal to
    :func:`stft_sharded`'s."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    mesh, s, c = _hier(mesh, "stft_sharded_hier")
    w = _window32(window)
    _check_signal(signal, hop, s * c, "stft_sharded_hier")
    place = (Shard(0), Shard(0))
    xs = _f32(_local(signal, mesh, place))
    sigma, gamma = _in_mesh(mesh)
    yr, yi = _stft_local(
        xs, w, w.shape[0], hop, backend,
        lambda head: _exchange(head, mesh, sigma * c + gamma, s * c, -1,
                               _hier_tier(c)))
    return _dtensor(yr, mesh, place), _dtensor(yi, mesh, place)


def istft_sharded_hier(fr, fi, window, hop: int, mesh=None,
                       backend: str = "torch"):
    """Distributed ISTFT over a (slice, chip) mesh: frames sharded
    slice-major, chip-minor; OLA tails ride ``ici`` between in-slice
    neighbours and cross each slice boundary once as ``dcn``. Returns the
    push region (F * hop,), sharded."""
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")
    mesh, s, c = _hier(mesh, "istft_sharded_hier")
    w = _window32(window)
    _check_frames(fr, fi, w, s * c, "istft_sharded_hier")
    place = (Shard(0), Shard(0))
    sigma, gamma = _in_mesh(mesh)
    out = _istft_local(
        _f32(_local(fr, mesh, place)), _f32(_local(fi, mesh, place)), w,
        w.shape[0], hop, backend,
        lambda tail: _exchange(tail, mesh, sigma * c + gamma, s * c, +1,
                               _hier_tier(c)))
    return _dtensor(out, mesh, place)
