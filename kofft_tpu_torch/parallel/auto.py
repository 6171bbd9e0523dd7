"""Automatic single-card vs sharded dispatch, and the threshold's
calibration.

The counterpart of ``kofft_tpu.parallel.auto``. The auto entries consult
:func:`should_shard` (points per rank against ``shard_threshold``) and the
divisibility constraints, then take the sharded program over the default
process group's world or the single-card entry (which carries the
kernels: ``fft_split``'s stage kernels, ``fftn_split``'s axis kernels).
Every rank must take the same route: the gates read only shapes, the
world size and the configuration.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.ndfft import fftn_split
from ..ops.stft import stft_split
from .mesh import _shape, make_mesh, should_shard
from .ndfft_sharded import fftn_sharded
from .stft_sharded import stft_sharded

__all__ = ["fft_auto", "fftn_auto", "stft_auto", "istft_auto",
           "calibrate_shard_threshold"]


def _usable_devices() -> int:
    """The default process group's world size, 1 when none is started."""
    return dist.get_world_size() if dist.is_initialized() else 1


def fftn_auto(xr, xi, axis_name: str = "d", inverse: bool = False,
              device="cuda"):
    """N-D FFT planes: sharded when worth it and the shapes divide, else
    ``fftn_split`` on one card. The sharded route returns natural-layout
    (``Shard(0)``) DTensors and uses the largest overlap chunking <=
    ``overlap_chunks`` that divides the last axis."""
    from ..config import get_config
    d = _usable_devices()
    shape = _shape(xr)
    total = int(np.prod(shape))
    if (d > 1 and len(shape) >= 2 and should_shard(total, d)
            and shape[0] % d == 0 and shape[-1] % d == 0):
        k = max(1, get_config().overlap_chunks)
        while k > 1 and shape[-1] % (d * k):
            k //= 2
        return fftn_sharded(xr, xi, mesh=make_mesh(d, axis_name, device),
                            axis_name=axis_name, inverse=inverse,
                            restore_layout=True, overlap=k)
    return fftn_split(xr, xi, inverse=inverse, device=device)


def stft_auto(signal, window, hop: int, axis_name: str = "d",
              device="cuda"):
    """1-D STFT planes: frame-sharded with the halo exchange when worth it,
    else the single-card two-sided ``stft_split``."""
    d = _usable_devices()
    shape = _shape(signal)
    n = shape[-1]
    halo_ok = (n // d) >= max(0, len(window) - hop)
    if (d > 1 and len(shape) == 1 and should_shard(n, d)
            and n % (d * hop) == 0 and halo_ok):
        return stft_sharded(signal, window, hop,
                            mesh=make_mesh(d, axis_name, device),
                            axis_name=axis_name)
    return stft_split(signal, window, hop, device=device)


def fft_auto(xr, xi, axis_name: str = "d", inverse: bool = False,
             device="cuda"):
    """1-D FFT planes: the distributed four-step (``fft_sharded``, natural
    order, the largest overlap chunking <= ``overlap_chunks`` that
    divides both factors) when the signal clears the threshold and
    factorizes for the world, else ``fft_split`` on one card."""
    from ..config import get_config
    from ..ops.fft import fft_split
    from .fft_sharded import _split_for_mesh, fft_sharded
    d = _usable_devices()
    shape = _shape(xr)
    n = shape[-1] if shape else 0
    if (d > 1 and len(shape) == 1 and should_shard(n, d)
            and _split_for_mesh(n, d) is not None):
        n1, n2 = _split_for_mesh(n, d)
        k = max(1, get_config().overlap_chunks)
        while k > 1 and (n1 % (d * k) or n2 % (d * k)):
            k //= 2
        return fft_sharded(xr, xi, mesh=make_mesh(d, axis_name, device),
                           axis_name=axis_name, inverse=inverse,
                           restore_layout=True, overlap=k)
    return fft_split(xr, xi, inverse=inverse, device=device)


def istft_auto(fr, fi, window, hop: int, axis_name: str = "d",
               device="cuda"):
    """Inverse STFT planes: frame-sharded OLA with the halo exchange when
    worth it, else ``istft_split``. Both return the first F * hop samples
    (the push region)."""
    from ..ops.stft import istft_split
    from .stft_sharded import istft_sharded
    d = _usable_devices()
    shape = _shape(fr)
    nf = shape[-2] if len(shape) >= 2 else 0
    total = nf * len(window)
    if (d > 1 and len(shape) == 2 and should_shard(total, d)
            and nf % d == 0):
        return istft_sharded(fr, fi, window, hop,
                             mesh=make_mesh(d, axis_name, device),
                             axis_name=axis_name)
    return istft_split(fr, fi, window, hop, length=nf * hop, device=device)


def calibrate_shard_threshold(axis_name: str = "d",
                              probe_points: int = 1 << 18,
                              apply: bool = True,
                              max_points: int = 1 << 24,
                              device="cuda") -> int:
    """Measure whether sharding pays at ``probe_points`` on the live world
    and set the threshold accordingly (every rank of the default group
    calls it). Times ``fft_split`` on one card against ``fft_sharded``
    (natural order) at the probe size, then scans octaves: down while
    sharding wins (the smallest winning size), up to ``max_points`` while
    it loses. The threshold is the smallest measured winning size, in
    points per rank. With one rank, or if sharding never wins, returns
    the current threshold unchanged.

    Each timed call ends in a ``torch.cuda.synchronize()`` on the card,
    so both paths pay one dispatch and one sync per sample; the minimum
    of three drops jitter. Rank 0's timings decide each probe and the
    decision is broadcast, so every rank walks the same scan and sets the
    same threshold."""
    import time

    from ..config import get_config, set_shard_threshold
    from .fft_sharded import _split_for_mesh, fft_sharded

    d = _usable_devices()
    cur = get_config().shard_threshold
    if d <= 1:
        return cur

    from ..ops.fft import fft_split
    mesh = make_mesh(d, axis_name, device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _time(f, *args):
        f(*args)                           # warm
        sync()
        best_t = None
        for _ in range(3):
            t0 = time.perf_counter()
            f(*args)
            sync()
            dt = time.perf_counter() - t0
            best_t = dt if best_t is None else min(best_t, dt)
        return best_t

    def _shard_wins(n: int):
        if _split_for_mesh(n, d) is None:
            return None                    # size not probe-able
        xr = torch.zeros(n, dtype=torch.float32, device=dev)
        t_local = _time(lambda a, b: fft_split(a, b), xr, xr)
        t_shard = _time(
            lambda a, b: fft_sharded(a, b, mesh=mesh, axis_name=axis_name,
                                     restore_layout=True), xr, xr)
        decision = [t_shard < t_local]
        dist.broadcast_object_list(decision, src=0)
        return decision[0]

    best = None
    n = int(probe_points)
    first = _shard_wins(n)
    if first:
        best = n // d                      # points per rank
        while True:                        # down: the smallest winning n
            n //= 2
            if n < 1 << 10:
                break
            win = _shard_wins(n)
            if not win:
                break
            best = n // d
    elif first is not None:
        while True:                        # up: does sharding ever pay?
            n *= 2
            if n > max_points:
                break
            win = _shard_wins(n)
            if win:
                best = n // d
                break
            if win is None:
                break
    out = best if best is not None else cur
    if apply and best is not None:
        set_shard_threshold(out)
    return out
