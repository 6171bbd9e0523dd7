"""Streaming spectrogram state: push samples -> RGBA rows.

The counterpart of ``kofft_tpu.web.state`` (reference: the
web-spectrogram WASM ``State::compute_frame``,
``web-spectrogram/src/lib.rs:191-234``): WIN_LEN=1024, HOP=512,
FLOOR_DB=-80; accumulate samples, once >= WIN_LEN window-multiply + FFT,
take the half-spectrum magnitudes, track the running max (init 1e-12),
colorize each bin to RGBA (alpha=255), drain HOP samples. Default palette
Rainbow; ``set_colormap``/``reset`` mirror the WASM exports.

Device path: the port's :class:`kofft_tpu_torch.ops.stft.StftPushStream`
on ``device`` (default the card): every push computes all the frames it
completes as one batched transform, and their spectra come back to the
host for colorizing. The running max is applied sequentially per frame
(frame f is colorized against the max over frames <= f), as in the JAX
package, so k frames pushed at once paint what k single pushes would.
"""

from __future__ import annotations

import threading

import numpy as np

from ..ops import stft as _stft
from ..ops import window as _window
from ..ops._complex import host_device
from ..utils.transfer import asnumpy
from ..visual.spectrogram import Colormap, color_from_magnitude_u8

WIN_LEN = 1024
HOP = WIN_LEN // 2
FLOOR_DB = -80.0


class StreamingSpectrogram:
    """Stateful streaming spectrogram: ring buffer + chunked transform +
    running max (the streaming/stateful API contract from SURVEY.md §3.4)."""

    def __init__(self, win_len: int = WIN_LEN, hop: int = HOP,
                 floor_db: float = FLOOR_DB,
                 colormap: str = "rainbow", device="cuda"):
        self.win_len = win_len
        self.hop = hop
        self.floor_db = floor_db
        self.device = host_device(device)
        self._window = _window.hann(win_len)
        self._cmap = Colormap.parse(colormap)
        self._stream = self._new_stream()
        self._max_mag = 1e-12
        # one state instance is shared across ThreadingHTTPServer handler
        # threads; without the lock two concurrent pushes race on the
        # ring buffer (dropped samples / double-drained hop)
        self._lock = threading.Lock()

    def _new_stream(self):
        # one-sided: the spectrogram uses only win//2 bins
        return _stft.StftPushStream(self._window, self.hop, onesided=True,
                                    device=self.device)

    def set_colormap(self, name: str) -> None:
        with self._lock:
            self._cmap = Colormap.parse(name)

    def reset(self) -> None:
        with self._lock:
            self._stream = self._new_stream()
            self._max_mag = 1e-12
            self._cmap = Colormap.RAINBOW

    def compute_frame(self, samples) -> np.ndarray:
        """Push samples; returns the RGBA rows of every frame the chunk
        completed, flattened to (k * win_len//2 * 4,) uint8, empty when no
        frame completed. One batched transform per call whatever k is.
        Thread-safe (serialized on the instance lock)."""
        s = np.asarray(samples, dtype=np.float32).ravel()
        with self._lock:
            return self._compute_frames_locked(s)

    def _compute_frames_locked(self, s) -> np.ndarray:
        fr, fi = (asnumpy(p) for p in self._stream.push(s))
        k = fr.shape[0]
        if k == 0:
            return np.zeros((0,), dtype=np.uint8)
        half = self.win_len // 2
        mags = np.sqrt(fr[:, :half] ** 2 + fi[:, :half] ** 2)  # (k, half)
        # sequential running max: frame f sees max over frames <= f
        row_max = np.maximum.accumulate(
            np.maximum(mags.max(axis=1, initial=0.0), self._max_mag))
        self._max_mag = float(row_max[-1])
        rgb = color_from_magnitude_u8(mags, row_max[:, None],
                                      self.floor_db, self._cmap)
        rows = np.concatenate(
            [rgb, np.full((k, half, 1), 255, np.uint8)], axis=-1)
        return rows.reshape(-1)
