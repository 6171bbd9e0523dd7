"""Spectrogram utilities: STFT magnitudes, dB scaling, colormaps, log-bins.

The counterpart of ``kofft_tpu.visual.spectrogram`` (reference
``src/visual/spectrogram.rs``), with the same semantics and host numpy
arithmetic, so every function but ``stft_magnitudes`` is bit-equal to the
JAX package's:

  * ``stft_magnitudes``: Hann window, frames = ceil(N/hop), magnitude
    matrix of shape (frames, win_len/2) + the maximum, computed on
    ``device`` (default the card) as one batched rfft of the port's STFT
    and returned as numpy,
  * ``magnitude_to_db`` / ``db_scale``,
  * seven palettes: Fire/Legacy/Gray/Rainbow stop-lerp gradients and the
    Viridis/Plasma/Inferno 256-entry tables, which the port keeps as data
    (``_colormaps.py``, sampled from matplotlib once) where the JAX
    package samples matplotlib at first use,
  * ``map_bin_to_pixel`` / ``log_scale_bins`` log-frequency rebinning,
  * ``render_rgb8``/``render_rgb16``: whole-image colorization.
"""

from __future__ import annotations

import enum
import functools
from typing import Optional

import numpy as np

from ..errors import InvalidValueError, require
from ..ops import stft as _stft
from ..ops import window as _window
from ..utils.transfer import asnumpy
from ._colormaps import TABLES


class Colormap(enum.Enum):
    FIRE = "fire"
    LEGACY = "legacy"
    GRAY = "gray"
    VIRIDIS = "viridis"
    PLASMA = "plasma"
    INFERNO = "inferno"
    RAINBOW = "rainbow"

    @staticmethod
    def parse(s: str) -> "Colormap":
        """Parse a palette name; unknown names fall back to Fire
        (reference ``Colormap::parse``, ``spectrogram.rs:34-45``)."""
        try:
            return Colormap(str(s).lower())
        except ValueError:
            return Colormap.FIRE


def stft_magnitudes(samples, win_len: int, hop: int,
                    backend: Optional[str] = None, device="cuda"):
    """(mags, max_mag): Hann-windowed STFT magnitude matrix of shape
    (frames, win_len//2) as numpy (reference ``stft_magnitudes``,
    ``spectrogram.rs:52-75``). Runs as one batched rfft on ``device``."""
    require(win_len >= 2, InvalidValueError, "win_len must be >= 2")
    w = _window.hann(win_len)
    fr, fi = _stft.stft_split(np.asarray(samples, dtype=np.float32), w, hop,
                              onesided=True, backend=backend, device=device)
    fr = asnumpy(fr)[..., : win_len // 2]
    fi = asnumpy(fi)[..., : win_len // 2]
    mags = np.sqrt(fr * fr + fi * fi)
    return mags, float(mags.max(initial=0.0))


def magnitude_to_db(mag, max_mag, floor_db: float):
    """20*log10(mag/max) clamped at floor (spectrogram.rs:96-103).

    ``max_mag`` may be a scalar or an array broadcastable against ``mag``
    (the chunked streaming path colorizes k frames at once, each against
    its own sequential running max)."""
    mag = np.asarray(mag, dtype=np.float32)
    mx = np.asarray(max_mag, dtype=np.float32)
    db = 20.0 * np.log10(np.maximum(mag, 1e-30) / np.maximum(mx, 1e-30))
    db = np.maximum(db, floor_db)
    return np.where((mag <= 0.0) | (mx <= 0.0), np.float32(floor_db), db)


def db_scale(mag, max_mag: float, dynamic_range: float):
    """Magnitude -> [0,1] over a dynamic range in dB (spectrogram.rs:105-110)."""
    mag = np.asarray(mag, dtype=np.float32)
    db = 20.0 * np.log10(np.maximum(mag / max_mag, 1e-10))
    return np.clip((db + dynamic_range) / dynamic_range, 0.0, 1.0)


# --------------------------------------------------------------------------
# palettes
# --------------------------------------------------------------------------

_FIRE_STOPS = [(0.0, (0, 0, 0)), (0.25, (128, 0, 128)),
               (0.5, (255, 165, 0)), (0.75, (255, 255, 0)),
               (1.0, (255, 255, 255))]
_RAINBOW_STOPS = [(0.0, (0, 0, 0)), (0.25, (0, 0, 255)),
                  (0.5, (0, 255, 255)), (0.75, (255, 255, 0)),
                  (0.9, (255, 0, 0)), (1.0, (255, 255, 255))]


def _lerp_stops(t: np.ndarray, stops) -> np.ndarray:
    """Vectorized piecewise-linear gradient matching the reference's
    integer lerp (truncation, spectrogram.rs:162-164)."""
    t = np.clip(t, 0.0, 1.0)
    pos = np.array([s[0] for s in stops], dtype=np.float32)
    cols = np.array([s[1] for s in stops], dtype=np.float32)
    idx = np.clip(np.searchsorted(pos, t, side="right") - 1, 0,
                  len(stops) - 2)
    t0, t1 = pos[idx], pos[idx + 1]
    local = np.where(t1 > t0, (t - t0) / np.maximum(t1 - t0, 1e-12), 0.0)
    c0, c1 = cols[idx], cols[idx + 1]
    out = c0 + (c1 - c0) * local[..., None]
    return out.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _mpl_lut(name: str) -> np.ndarray:
    """256-entry RGB table for viridis/plasma/inferno (float32 values
    0 ... 255), the JAX package's ``_mpl_lut`` kept as data."""
    return np.frombuffer(bytes.fromhex("".join(TABLES[name])),
                         np.uint8).reshape(256, 3).astype(np.float32)


def _eval_lut(t: np.ndarray, name: str) -> np.ndarray:
    """Continuous evaluation over the 256-sample table (colorous
    ``eval_continuous`` semantics)."""
    t = np.clip(np.asarray(t, dtype=np.float32), 0.0, 1.0)
    lut = _mpl_lut(name)
    x = t * 255.0
    i0 = np.clip(np.floor(x).astype(np.int32), 0, 255)
    i1 = np.minimum(i0 + 1, 255)
    frac = (x - i0)[..., None]
    out = lut[i0] + (lut[i1] - lut[i0]) * frac
    return np.round(out).astype(np.uint8)


def map_color_u8(t, cmap: Colormap) -> np.ndarray:
    """[0,1] -> RGB8, vectorized (reference ``map_color_u8``,
    ``spectrogram.rs:113-160``). Accepts scalars or arrays."""
    t = np.asarray(t, dtype=np.float32)
    if cmap == Colormap.FIRE:
        return _lerp_stops(t, _FIRE_STOPS)
    if cmap == Colormap.LEGACY:
        tc = np.clip(t, 0.0, 1.0)
        r = 64.0 * (1.0 - tc) + 255.0 * tc
        g = 255.0 * tc
        b = 64.0 * (1.0 - tc) + 224.0 * tc
        return np.stack([r, g, b], axis=-1).astype(np.uint8)
    if cmap == Colormap.GRAY:
        g = np.round(np.clip(t, 0.0, 1.0) * 255.0).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    if cmap == Colormap.RAINBOW:
        return _lerp_stops(t, _RAINBOW_STOPS)
    if cmap in (Colormap.VIRIDIS, Colormap.PLASMA, Colormap.INFERNO):
        return _eval_lut(t, cmap.value)
    raise InvalidValueError(f"unknown colormap {cmap}")


def map_color_u16(t, cmap: Colormap) -> np.ndarray:
    """RGB16 = RGB8 * 257 (reference ``map_color_u16``)."""
    return map_color_u8(t, cmap).astype(np.uint16) * 257


def color_from_magnitude_u8(mag, max_mag: float, floor_db: float,
                            cmap: Colormap) -> np.ndarray:
    """dB-normalize then colorize (reference ``color_from_magnitude_u8``,
    ``spectrogram.rs:191-196``)."""
    db = magnitude_to_db(mag, max_mag, floor_db)
    t = (db - floor_db) / -floor_db
    return map_color_u8(t, cmap)


def color_from_magnitude_u16(mag, max_mag: float, floor_db: float,
                             cmap: Colormap) -> np.ndarray:
    return color_from_magnitude_u8(mag, max_mag, floor_db,
                                   cmap).astype(np.uint16) * 257


def map_bin_to_pixel(bin: int, max_bin: int) -> int:
    """Log-frequency pixel mapping (reference ``map_bin_to_pixel``,
    ``spectrogram.rs:209-218``)."""
    if max_bin == 0:
        return 0
    log_max = np.log(max_bin + 1.0)
    pos = np.log(bin + 1.0)
    return int(np.floor(max_bin * pos / log_max))


_PIXEL_MAPS: dict = {}


def _pixel_map(n_bins: int, max_bin: int) -> np.ndarray:
    """Vectorized map_bin_to_pixel for b in [0, n_bins) (cached: depends
    only on the geometry, not the data)."""
    key = (n_bins, max_bin)
    hit = _PIXEL_MAPS.get(key)
    if hit is None:
        if max_bin == 0:
            hit = np.zeros(n_bins, dtype=np.int64)
        else:
            b = np.arange(n_bins, dtype=np.float64)
            hit = np.floor(max_bin * np.log(b + 1.0)
                           / np.log(max_bin + 1.0)).astype(np.int64)
        _PIXEL_MAPS[key] = hit
    return hit


def log_scale_bins(values, max_bin: int) -> np.ndarray:
    """Log-average frequency bins into max_bin+1 pixels (reference
    ``log_scale_bins``, ``spectrogram.rs:221-241``). Vectorized:
    ``np.add.at`` accumulates in ascending-bin order, bit-matching the
    original per-element loop (the loop form cost ~10M interpreted
    iterations on a 4-minute render)."""
    values = np.asarray(values, dtype=np.float32)
    ys = _pixel_map(values.shape[-1], max_bin)
    accum = np.zeros(values.shape[:-1] + (max_bin + 1,), dtype=np.float32)
    if values.ndim == 1:
        np.add.at(accum, ys, values)
    else:
        rows = np.arange(values.shape[0])[:, None]
        np.add.at(accum, (rows, ys[None, :]), values)
    counts = np.bincount(ys, minlength=max_bin + 1)
    nz = counts > 0
    accum[..., nz] /= counts[nz]
    return accum


def render_rgb8(mags: np.ndarray, max_mag: float, floor_db: float,
                cmap: Colormap, log_scale: bool = False) -> np.ndarray:
    """Colorize a magnitude matrix (frames, bins) into an RGB8 image of
    shape (bins, frames, 3) — the sanity-check CLI's pixel pipeline
    (``sanity-check/src/main.rs:75-83``) as one vectorized pass, with
    low frequencies at the bottom row."""
    mags = np.asarray(mags, dtype=np.float32)
    if log_scale:
        mags = log_scale_bins(mags, mags.shape[1] - 1)
    img = color_from_magnitude_u8(mags, max_mag, floor_db, cmap)
    return img.transpose(1, 0, 2)[::-1]


def render_rgb16(mags: np.ndarray, max_mag: float, floor_db: float,
                 cmap: Colormap, log_scale: bool = False) -> np.ndarray:
    return render_rgb8(mags, max_mag, floor_db, cmap,
                       log_scale).astype(np.uint16) * 257
