"""Plain reference of the one-sided STFT: NumPy in float64.

Written anew from the definitions that the program documents, not from
its code: the periodic Hann window w[i] = 0.5 - 0.5 cos(2 pi i / win);
F = ceil(N / hop) frames, frame f being x[f*hop : f*hop + win] with the
signal zero-padded past its end; each frame times the window, then its
DFT's first win // 2 + 1 bins. Imports NumPy alone.
"""

from __future__ import annotations

import numpy as np


def hann(win: int) -> np.ndarray:
    """Periodic Hann window in float64."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)


def stft_onesided(x: np.ndarray, win: int, hop: int,
                  block: int = 256) -> np.ndarray:
    """complex128 one-sided spectra (..., F, win // 2 + 1) of the hann-
    windowed frames, computed ``block`` frames at a time so that the frame
    matrix of a long signal is never whole in memory (the frames are a
    strided view of the padded signal until the window multiplies them)."""
    x = np.asarray(x, np.float64)
    w = hann(win)
    nf = -(-x.shape[-1] // hop)
    out = np.empty((*x.shape[:-1], nf, win // 2 + 1), np.complex128)
    pad = np.zeros((*x.shape[:-1], (nf - 1) * hop + win), np.float64)
    pad[..., :x.shape[-1]] = x
    frames = np.lib.stride_tricks.sliding_window_view(
        pad, win, axis=-1)[..., ::hop, :]
    for f0 in range(0, nf, block):
        f1 = min(nf, f0 + block)
        out[..., f0:f1, :] = np.fft.rfft(frames[..., f0:f1, :] * w, axis=-1)
    return out
