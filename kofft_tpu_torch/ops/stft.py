"""STFT / ISTFT: batch, streaming and frame-level entries.

The counterpart of ``kofft_tpu.ops.stft``, with the same semantics:

  * frame count = ceil(N / hop); frame f starts at f*hop and is
    zero-padded past the signal's end;
  * frames are full complex spectra of length win_len, or the one-sided
    n//2 + 1 bins when ``onesided``;
  * istft: inverse FFT of each frame, times the synthesis window,
    overlap-add, then division by the accumulated window square where it
    exceeds 1e-8;
  * the streaming ISTFT emits ``hop`` samples per pushed frame and a
    ``win_len - hop`` tail on flush, equal to the offline path.

Frames form one (..., F, win) matrix and go through the port's FFT
ladders as one batched call (``_rfft_planes``, ``engine_fft_planes``), so
a window the stage kernels serve (win >= 2^14) runs on them. Each call
runs eagerly; the window moves to the device once per (window, device)
(``const``), and ``tables.clear()`` drops it. Host input goes to
``device`` (default ``"cuda"``, the card); a tensor is computed where it
lies. Every entry returns tensors on the compute device, except
``IstftStream.push_frame`` and ``flush``, which return numpy as the JAX
package's do.

The two device-side stream forms (``stft_stream_scan``,
``istft_stream_scan``) are ``lax.scan``s over frames in the JAX package.
Here they run in chunks of frames, each one batched transform, with the
overlap-add carried across chunks, so no (F, win) frame matrix of the
whole signal is built and the host enqueues a few calls, not a few per
frame. ``StftPushStream`` runs exactly the k frames a push completes
(the JAX package pads k to a power of two to bound its compilations).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import profiler as _prof

from ..config import get_config, precision_scope
from ..errors import (EmptyInputError, InvalidHopSizeError,
                      MismatchedLengthsError, require)
from ..plan import tables
from ..utils import observability as _obs
from ._complex import (const, dtype_name, host_device, host_float, merge,
                       split)
from .fft import (_as_tensor, _fft_planes, _planes, engine_fft_planes,
                  resolve_backend)
from .hopper_fft import _tracked
from .hopper_kernels import _FRAMES_MAX_WIN, _FRAMES_MIN_WIN, stft_frames
from .rfft import _rfft_planes

__all__ = ["stft", "istft", "stft_split", "istft_split", "frame_split",
           "inverse_frame_split", "StftStream", "StftPushStream",
           "IstftStream", "istft_stream_scan", "stft_stream_scan",
           "num_frames"]

# frame points per chunk of the stream scans: bounds the frame matrix a
# chunk builds (4 MiB of float32), and keeps a chunk of windows of 2^12 …
# 2^14 points in the shape classes of the whole (2^18 points and up)
_SCAN_POINTS = 1 << 20


def num_frames(n: int, hop: int) -> int:
    """Frame count for a length-n signal: ceil(n / hop)."""
    return -(-n // hop)


def _frame_indices(n_frames: int, win: int, hop: int) -> np.ndarray:
    """idx[f, j] = f*hop + j (cached host table)."""
    def build():
        i = np.arange(n_frames, dtype=np.int64)[:, None] * hop
        return i + np.arange(win, dtype=np.int64)[None, :]
    return tables.custom(("stft_idx", n_frames, win, hop), build)


def _window_const(window) -> np.ndarray:
    """The window as a cached host array in its working dtype: one array
    per window content, so that its device copy is made once per
    device."""
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    w = host_float(window)
    require(w.ndim == 1 and w.size >= 1, EmptyInputError,
            "window must be a non-empty 1-D array")
    return tables.custom(("stft_window", w.dtype.str, w.tobytes()),
                         lambda: w.copy())


def _ola_norm_const(win_sq: np.ndarray, n_frames: int, hop: int,
                    length: int) -> np.ndarray:
    """Accumulated window-square normalization buffer: a function of
    (window, hop, frames, length) alone, computed on the host in float64
    and cast to the window's dtype."""
    win = win_sq.shape[0]
    norm = np.zeros(length, dtype=np.float64)
    for f in range(n_frames):
        s = f * hop
        e = min(s + win, length)
        if s < length:
            norm[s:e] += win_sq[: e - s]
    return norm.astype(win_sq.dtype)


def _ola_den(w: np.ndarray, n_frames: int, hop: int, length: int):
    """The divisor of the overlap-added signal: the accumulated window
    square where it exceeds 1e-8, else 1 (cached host table)."""
    def build():
        norm = _ola_norm_const(w * w, n_frames, hop, length)
        return np.where(norm > 1e-8, norm, 1.0).astype(w.dtype)
    return tables.custom(("stft_ola_den", id(w), n_frames, hop, length),
                         build)


def _pad_last(x, length: int):
    """``x`` zero-padded along the last axis to ``length`` (if shorter)."""
    n = x.shape[-1]
    return F.pad(x, (0, length - n)) if length > n else x


# --------------------------------------------------------------------------
# cores
# --------------------------------------------------------------------------

def _frame_matrix(x, win: int, hop: int, nf: int):
    """Gather-free framing when win % hop == 0: a strided view of the
    zero-padded signal, frame f = x[f*hop : f*hop + win]. The window
    multiply that follows makes the frames contiguous."""
    return _pad_last(x, (nf - 1) * hop + win).unfold(-1, win, hop)[..., :nf, :]


def _frames_route(x, window_np: np.ndarray, backend: str) -> bool:
    """Whether a one-sided call goes to the frame kernel
    (``hopper_kernels.stft_frames``): a float32 signal on the card, a
    float32 window of a power of two in [2^6, 2^11] points (below
    ``_cufft_zone`` and the stage kernels, where the engines take the plain
    factor tree), the backend `auto` or `cuda`, and nothing that autograd,
    forward AD or a ``torch.func`` transform has to see
    (``hopper_fft._tracked``): the kernel has no backward, so tracked
    calls keep the differentiable torch ops. Timed as a ``ladder`` span.
    """
    sp = (_obs.begin("ladder")
          if _prof._is_profiler_enabled or _obs.switch else None)
    try:
        win = window_np.shape[0]
        return (x.is_cuda and x.dtype == torch.float32
                and window_np.dtype == np.float32 and x.numel() > 0
                and backend in ("auto", "cuda") and win & (win - 1) == 0
                and _FRAMES_MIN_WIN <= win <= _FRAMES_MAX_WIN
                and not _tracked(x, x))
    finally:
        if sp:
            _obs.end(sp)


def _stft_planes(x, window_np: np.ndarray, hop: int, onesided: bool,
                 backend: str, nf: Optional[int] = None):
    """real (..., N) -> frame spectra planes (..., F, K). ``nf``
    overrides the frame count (default ceil(N/hop)): the chunked streams
    compute exactly the frames of a segment. A one-sided call that
    ``_frames_route`` admits is one launch of the frame kernel; any other
    builds the frame matrix and runs the engine ladder, the framing and
    the window product as a ``frame`` span."""
    nf = nf if nf is not None else num_frames(x.shape[-1], hop)
    if onesided and _frames_route(x, window_np, backend):
        return stft_frames(x.contiguous(), const(window_np, x.device), hop,
                           nf)
    win = window_np.shape[0]
    sp = (_obs.begin("frame")
          if _prof._is_profiler_enabled or _obs.switch else None)
    w = const(window_np, x.device)
    if win % hop == 0:
        frames = _frame_matrix(x, win, hop, nf) * w
    else:
        x = _pad_last(x, (nf - 1) * hop + win)
        idx = const(_frame_indices(nf, win, hop), x.device)
        frames = x[..., idx] * w                     # (..., F, win)
    if sp:
        _obs.end(sp)
    if onesided:
        return _rfft_planes(frames, win, backend)
    return engine_fft_planes(frames, torch.zeros_like(frames), win, False,
                             dtype_name(frames), backend)


def _ola_add(y, win: int, hop: int, nf: int):
    """Overlap-add of windowed frames y (..., F, win) -> (..., (F-1)*hop +
    win). When win % hop == 0 each frame is k = win // hop hop-chunks and
    chunk j of frame f lands at slot f + j: k shifted adds. Otherwise an
    index add (``index_add``, which sums with atomics on the card: the
    order of the float sums varies from run to run)."""
    lead = y.shape[:-2]
    if win % hop != 0:
        idx = const(_frame_indices(nf, win, hop), y.device)
        out = y.new_zeros((*lead, (nf - 1) * hop + win))
        return out.index_add(-1, idx.reshape(-1), y.reshape(*lead, nf * win))
    k = win // hop
    c3 = y.reshape(*lead, nf, k, hop)
    out3 = y.new_zeros((*lead, nf + k - 1, hop))
    for j in range(k):
        out3[..., j: j + nf, :] += c3[..., :, j, :]
    return out3.reshape(*lead, (nf + k - 1) * hop)


def _synthesis_tier():
    """ISTFT synthesis never runs below the `high` tier: OLA turns each
    frame's error straight into signal error, so the `default` tier is
    lifted to `high` for the inverse transforms and restored after, also
    when the call raises. On the port the tier changes the `default`
    tier's bf16 casts of the kernel routes and the d2 route's zone."""
    prev = get_config().precision
    return precision_scope("high" if prev == "default" else prev)


def _synthesis(fr, fi, w, win: int, backend: str):
    """Windowed time frames (..., F, win) of spectra planes: the inverse
    transform on the synthesis tier, 1/win, times the window."""
    with _synthesis_tier():
        tr, _ = engine_fft_planes(fr, fi, win, True, dtype_name(fr), backend)
    return (tr / win) * const(w, tr.device)


def _istft_planes(fr, fi, window_np: np.ndarray, hop: int, length: int,
                  backend: str):
    """frame spectra planes (..., F, win) -> real signal (..., length).
    The overlap-add and its normalization are a ``frame`` span."""
    win = window_np.shape[0]
    nf = fr.shape[-2]
    frames = _synthesis(fr, fi, window_np, win, backend)
    sp = (_obs.begin("frame")
          if _prof._is_profiler_enabled or _obs.switch else None)
    out = _pad_last(_ola_add(frames, win, hop, nf), length)[..., :length]
    out = out / const(_ola_den(window_np, nf, hop, length), out.device)
    if sp:
        _obs.end(sp)
    return out


def _resolve_planes_backend(backend: Optional[str]) -> str:
    """The JAX package sends its built-in FFT's name to the plain engines
    here; the port does the same with torch.fft's."""
    b = resolve_backend(backend)
    return "torch" if b == "cufft" else b


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(a[:0]).dtype


def _check_hop(hop: int) -> None:
    require(hop >= 1, InvalidHopSizeError, f"hop must be >= 1, got {hop}")


def _signal(signal, device):
    x = _as_tensor(signal, device)
    require(x.dim() >= 1 and x.shape[-1] >= 1, EmptyInputError,
            "signal must be non-empty")
    return x


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def stft_split(signal, window, hop: int, onesided: bool = False,
               backend: Optional[str] = None, device="cuda"):
    """STFT returning (re, im) planes (..., F, K), F = ceil(N/hop), K =
    win_len (or win_len//2 + 1 when ``onesided``)."""
    sp = (_obs.begin("stft_split")
          if _prof._is_profiler_enabled or _obs.switch else None)
    try:
        _check_hop(hop)
        sf = (_obs.begin("frame")
              if _prof._is_profiler_enabled or _obs.switch else None)
        w = _window_const(window)
        if sf:
            _obs.end(sf)
        return _stft_planes(_signal(signal, device), w, hop, onesided,
                            _resolve_planes_backend(backend))
    finally:
        if sp:
            _obs.end(sp)


def stft(signal, window, hop: int, onesided: bool = False,
         backend: Optional[str] = None, device="cuda"):
    """STFT of a real signal: (..., N) -> complex frames (..., F, K)."""
    return merge(*stft_split(signal, window, hop, onesided, backend,
                             device))


def istft_split(fr, fi, window, hop: int, length: Optional[int] = None,
                backend: Optional[str] = None, device="cuda"):
    """Inverse STFT from (re, im) planes (..., F, win) -> real (...,
    length), default length (F-1)*hop + win_len."""
    sp = (_obs.begin("istft_split")
          if _prof._is_profiler_enabled or _obs.switch else None)
    try:
        _check_hop(hop)
        sf = (_obs.begin("frame")
              if _prof._is_profiler_enabled or _obs.switch else None)
        w = _window_const(window)
        if sf:
            _obs.end(sf)
        fr, fi = _planes(fr, fi, device)
        require(fr.dim() >= 2, EmptyInputError,
                "frames must be (..., F, win)")
        require(fr.shape[-1] == w.shape[0], MismatchedLengthsError,
                f"frame length {fr.shape[-1]} != window length {w.shape[0]}")
        nf = fr.shape[-2]
        length = (length if length is not None
                  else (nf - 1) * hop + w.shape[0])
        return _istft_planes(fr.contiguous(), fi.contiguous(), w, hop,
                             length, _resolve_planes_backend(backend))
    finally:
        if sp:
            _obs.end(sp)


def istft(frames, window, hop: int, length: Optional[int] = None,
          backend: Optional[str] = None, device="cuda"):
    """Inverse STFT with window-square overlap-add normalization.
    ``frames``: complex (..., F, win_len). Returns real (..., length)."""
    f = _as_tensor(frames, device)
    fr, fi = split(f)
    return istft_split(fr, fi, window, hop, length, backend, device)


def frame_split(signal, window, start: int, backend: Optional[str] = None,
                device="cuda"):
    """Single-frame STFT at ``start``: the frame zero-padded past the
    signal's end, (re, im) planes of length win_len."""
    w = _window_const(window)
    win = w.shape[0]
    x = _as_tensor(signal, device)
    n = x.shape[-1]
    avail = max(0, min(win, n - start))
    # the start as the JAX package's dynamic slice of the padded signal
    # takes it: a negative one counts from the end, then it is clamped
    s = min(max(start + n + win if start < 0 else start, 0), n)
    seg = F.pad(x, (0, win))[..., s: s + win]
    mask = (torch.arange(win, device=x.device) < avail).to(seg.dtype)
    fr = seg * const(w, x.device) * mask
    return _fft_planes(fr, torch.zeros_like(fr), win, False,
                       _resolve_planes_backend(backend), dtype_name(fr))


def inverse_frame_split(fr, fi, window, backend: Optional[str] = None,
                        device="cuda"):
    """Single-frame inverse: the windowed time samples of one spectrum,
    ready for overlap-add."""
    w = _window_const(window)
    win = w.shape[0]
    fr, fi = _planes(fr, fi, device)
    with _synthesis_tier():
        tr, _ = _fft_planes(fr, fi, win, True,
                            _resolve_planes_backend(backend), dtype_name(fr))
    return (tr / win) * const(w, tr.device)


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------

class StftStream:
    """Streaming STFT over a fixed 1-D signal: ``next_frame()`` yields one
    spectrum per hop until the signal is exhausted."""

    def __init__(self, signal, window, hop: int,
                 backend: Optional[str] = None, device="cuda"):
        _check_hop(hop)
        self._w = _window_const(window)
        self._sig = _as_tensor(signal, device).to(torch.float32)
        require(self._sig.dim() == 1, EmptyInputError,
                "streaming STFT takes a 1-D signal")
        self._hop = hop
        self._pos = 0
        self._backend = _resolve_planes_backend(backend)

    def next_frame(self):
        """Returns (re, im) planes of the next frame, or None when done."""
        if self._pos >= self._sig.shape[0]:
            return None
        pos, self._pos = self._pos, self._pos + self._hop
        return frame_split(self._sig, self._w, pos, self._backend)

    def __iter__(self):
        while True:
            f = self.next_frame()
            if f is None:
                return
            yield f


class StftPushStream:
    """Real-time chunked streaming STFT: ``push(samples)`` takes a chunk of
    any length and returns the spectra of all the frames it completes, in
    one batched transform. Frame f covers ``[f*hop, f*hop+win)``; a frame
    is emitted once its window is fully buffered; ``flush()`` zero-pads
    and emits the remaining partial frames, so push(whole signal) +
    flush() reproduces ``stft_split`` (F = ceil(N/hop) frames). The
    buffer lies on ``device``."""

    def __init__(self, window, hop: int, onesided: bool = False,
                 backend: Optional[str] = None, device="cuda"):
        _check_hop(hop)
        self._w = _window_const(window)
        self._hop = hop
        self._onesided = onesided
        self._backend = _resolve_planes_backend(backend)
        self._device = host_device(device)
        self._dtype = _torch_dtype(self._w)
        self._buf = self._fresh()
        # buf[0] sits at stream index _start; the next unemitted frame
        # begins at _pos (with hop > win the next frame can begin beyond
        # the buffer: _pos remembers the gap to skip)
        self._start = 0
        self._pos = 0

    def _fresh(self):
        return torch.zeros(0, dtype=self._dtype, device=self._device)

    @property
    def buffered(self) -> int:
        """Samples currently waiting for their frame to complete."""
        return int(self._buf.shape[0])

    def _run_chunk(self, seg, k: int):
        return _stft_planes(seg, self._w, self._hop, self._onesided,
                            self._backend, nf=k)

    def _empty(self):
        kdim = (self._w.shape[0] // 2 + 1 if self._onesided
                else self._w.shape[0])
        z = self._buf.new_zeros((0, kdim))
        return z, z.clone()

    def push(self, samples):
        """Buffer ``samples``; returns (re, im) planes of shape (k, K) for
        the k frames this chunk completed (k may be 0)."""
        s = _as_tensor(samples, self._device).to(self._device,
                                                 self._dtype).reshape(-1)
        self._buf = torch.cat([self._buf, s])
        win, hop = self._w.shape[0], self._hop
        end = self._start + self._buf.shape[0]
        if self._pos + win > end:
            return self._empty()
        k = (end - win - self._pos) // hop + 1
        off = self._pos - self._start
        out = self._run_chunk(self._buf[off: off + win + (k - 1) * hop], k)
        self._pos += k * hop
        drop = min(self._buf.shape[0], self._pos - self._start)
        self._start += drop
        self._buf = self._buf[drop:]
        return out

    def flush(self):
        """Zero-pad and emit the remaining partial frames, then reset:
        push + flush emits exactly ceil(total/hop) frames."""
        hop = self._hop
        end = self._start + self._buf.shape[0]
        if self._pos >= end:
            out = self._empty()
        else:
            k = -(-(end - self._pos) // hop)
            out = self._run_chunk(self._buf[self._pos - self._start:], k)
        self._buf = self._fresh()
        self._start = 0
        self._pos = 0
        return out


def stft_stream_scan(signal, window, hop: int, onesided: bool = False,
                     backend: Optional[str] = None, device="cuda"):
    """Device-side streaming forward STFT of a 1-D signal: the frames of
    :class:`StftStream` (frame f covers ``[f*hop, f*hop + win)`` of the
    zero-extended signal, F = ceil(N/hop)), computed in chunks of frames,
    each one batched transform of at most ``_SCAN_POINTS`` frame points.
    No (F, win) frame matrix of the whole signal is built: peak memory is
    O(N + F*K). Returns (re, im) planes (F, K), K = win (``win//2 + 1``
    when ``onesided``)."""
    _check_hop(hop)
    w = _window_const(window)
    win = w.shape[0]
    x = _as_tensor(signal, device)
    require(x.dim() == 1 and x.shape[0] >= 1, EmptyInputError,
            "stft_stream_scan takes a non-empty 1-D signal")
    nf = num_frames(x.shape[0], hop)
    b = _resolve_planes_backend(backend)
    step = max(1, _SCAN_POINTS // win)
    out = None
    for f0 in range(0, nf, step):
        c = min(step, nf - f0)
        seg = x[f0 * hop: f0 * hop + (c - 1) * hop + win]
        cr, ci = _stft_planes(seg, w, hop, onesided, b, nf=c)
        if out is None:
            out = (cr.new_empty((nf, cr.shape[-1])),
                   ci.new_empty((nf, ci.shape[-1])))
        out[0][f0: f0 + c] = cr
        out[1][f0: f0 + c] = ci
    return out


def istft_stream_scan(fr, fi, window, hop: int,
                      backend: Optional[str] = None, device="cuda"):
    """Device-side streaming ISTFT: what F successive
    :meth:`IstftStream.push_frame` calls followed by ``flush`` emit (F*hop
    streamed samples plus the ``win - hop`` tail), computed in chunks of
    frames: each chunk one batched inverse transform, its overlap-add
    carried into the output, and the accumulated window square divided
    out at the end. ``fr, fi``: (F, win) planes. Returns a
    (F*hop + win - hop,) real signal."""
    _check_hop(hop)
    w = _window_const(window)
    win = w.shape[0]
    fr, fi = _planes(fr, fi, device)
    require(fr.dim() == 2, MismatchedLengthsError,
            "istft_stream_scan takes (F, win) planes")
    require(fr.shape[-1] == win, MismatchedLengthsError,
            f"frame length {fr.shape[-1]} != window length {win}")
    require(hop <= win, InvalidHopSizeError,
            f"istft_stream_scan needs hop <= win, got {hop} > {win}")
    ct = torch.promote_types(fr.dtype, _torch_dtype(w))
    fr, fi = fr.to(ct), fi.to(ct)
    nf = fr.shape[0]
    length = (nf - 1) * hop + win
    b = _resolve_planes_backend(backend)
    step = max(1, _SCAN_POINTS // win)
    out = fr.new_zeros(length)
    for f0 in range(0, nf, step):
        c = min(step, nf - f0)
        y = _synthesis(fr[f0: f0 + c].contiguous(),
                       fi[f0: f0 + c].contiguous(), w, win, b)
        s = f0 * hop
        out[s: s + (c - 1) * hop + win] += _ola_add(y, win, hop, c)
    return out / const(_ola_den(w, nf, hop, length), out.device)


class IstftStream:
    """Streaming ISTFT with rolling overlap-add state on the device:
    ``push_frame`` returns the next ``hop`` normalized samples;
    ``flush`` returns the ``win_len - hop`` tail. Equal to the offline
    ``istft``, the flush tail included. Both return numpy."""

    def __init__(self, win_len: int, hop: int, window,
                 backend: Optional[str] = None, device="cuda"):
        _check_hop(hop)
        w = _window_const(window)
        require(w.shape[0] == win_len, MismatchedLengthsError,
                f"window length {w.shape[0]} != win_len {win_len}")
        self._w = w
        self._win = win_len
        self._hop = hop
        self._backend = _resolve_planes_backend(backend)
        self._device = host_device(device)
        self._w32 = _window_const(w.astype(np.float32))
        self._wt = const(self._w32, self._device)
        self._reset()

    def _reset(self):
        # carried OLA state: win_len accumulated samples and their norm
        self._buf = torch.zeros(self._win, device=self._device)
        self._norm = torch.zeros(self._win, device=self._device)
        self._count = 0

    def push_frame(self, fr, fi=None):
        """Push one spectrum (complex array or (re, im) planes); returns
        the next ``hop`` samples as numpy."""
        if fi is None:
            fr, fi = split(_as_tensor(fr, self._device))
        fr = _as_tensor(fr, self._device).to(self._device, torch.float32)
        fi = _as_tensor(fi, self._device).to(self._device, torch.float32)
        require(tuple(fr.shape) == (self._win,), MismatchedLengthsError,
                f"frame must have length {self._win}")
        hop, w = self._hop, self._wt
        buf = self._buf + inverse_frame_split(fr, fi.contiguous(), self._w32,
                                              self._backend)
        norm = self._norm + w * w
        head = norm[:hop]
        out = torch.where(head > 1e-8,
                          buf[:hop] / torch.where(head > 1e-8, head, 1.0),
                          buf[:hop])
        self._buf = torch.cat([buf[hop:], buf.new_zeros(hop)])
        self._norm = torch.cat([norm[hop:], norm.new_zeros(hop)])
        self._count += 1
        return out.cpu().numpy()

    def flush(self):
        """The remaining ``win_len - hop`` normalized tail samples
        (numpy)."""
        tail = self._win - self._hop
        if self._count == 0 or tail <= 0:
            self._reset()
            return np.zeros(0, dtype=np.float32)
        buf = self._buf[:tail].cpu().numpy()
        norm = self._norm[:tail].cpu().numpy()
        self._reset()
        out = np.where(norm > 1e-8, buf / np.where(norm > 1e-8, norm, 1.0),
                       buf)
        return out.astype(np.float32)
