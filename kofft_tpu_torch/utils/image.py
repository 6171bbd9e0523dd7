"""PNG (8/16-bit RGB) and SVG writers, dependency-free.

The port's copy of ``kofft_tpu.utils.image``, on the port's ``native``.

Reference surface: ``sanity-check/src/lib.rs:109-158`` — PNG via the image
crate at best compression (8-bit takes the high byte of each RGB16
channel), SVG as per-pixel 1x1 rects colored from the high bytes.

The PNG here is a minimal spec-compliant encoder (zlib level 9, filter 0);
byte-level output differs from the Rust image crate, and is the same as
the JAX package's.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..errors import InvalidValueError, require


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """RGB image (H, W, 3) uint8 or uint16 -> PNG bytes."""
    img = np.asarray(img)
    require(img.ndim == 3 and img.shape[2] == 3, InvalidValueError,
            f"expected (H, W, 3) RGB image, got {img.shape}")
    if img.dtype == np.uint8:
        depth = 8
        raw = img
    elif img.dtype == np.uint16:
        depth = 16
        raw = img.astype(">u2")
    else:
        raise InvalidValueError(f"unsupported dtype {img.dtype}")
    h, w, _ = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0)  # RGB
    rows = raw.reshape(h, -1).view(np.uint8) if depth == 16 else \
        raw.reshape(h, -1)
    scan = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))
    idat = zlib.compress(scan, level=9)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def save_png(img: np.ndarray, path, depth: str = "eight") -> None:
    """Save RGB16 image as 8- or 16-bit PNG (reference ``save_png``,
    ``sanity-check/src/lib.rs:109-134``: 8-bit takes the high byte).
    Uses the native C++ encoder when available (byte-identical output);
    falls back to the pure-Python encoder."""
    img = np.asarray(img)
    if depth in ("eight", 8):
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        img = img.astype(np.uint8)
    elif depth in ("sixteen", 16):
        if img.dtype == np.uint8:
            img = img.astype(np.uint16) * 257
        img = img.astype(np.uint16)
    else:
        raise InvalidValueError(f"png depth must be eight/sixteen, got "
                                f"{depth!r}")
    from ..native import png_encode as _native_png
    data = _native_png(img)
    if data is None:
        data = encode_png(img)
    Path(path).write_bytes(data)


def decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for round-trip tests (filter-0 RGB images only)."""
    require(data[:8] == b"\x89PNG\r\n\x1a\n", InvalidValueError,
            "not a PNG")
    pos = 8
    w = h = depth = None
    idat = b""
    while pos < len(data):
        ln = struct.unpack(">I", data[pos: pos + 4])[0]
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, color, *_ = struct.unpack(">IIBBBBB", payload)
            require(color == 2, InvalidValueError, "RGB PNGs only")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 * (depth // 8)
    rows = []
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        require(ftype == 0, InvalidValueError,
                "decoder supports filter 0 only")
        rows.append(raw[y * (stride + 1) + 1: (y + 1) * (stride + 1)])
    buf = b"".join(rows)
    if depth == 8:
        return np.frombuffer(buf, np.uint8).reshape(h, w, 3)
    return np.frombuffer(buf, ">u2").astype(np.uint16).reshape(h, w, 3)


def save_svg(img: np.ndarray, path) -> None:
    """Per-pixel 1x1 rect SVG from RGB16 high bytes (reference
    ``save_svg``, ``sanity-check/src/lib.rs:137-158``)."""
    img = np.asarray(img)
    if img.dtype == np.uint16:
        img8 = (img >> 8).astype(np.uint8)
    else:
        img8 = img.astype(np.uint8)
    h, w, _ = img8.shape
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" '
             f'viewBox="0 0 {w} {h}">']
    for y in range(h):
        for x in range(w):
            r, g, b = (int(v) for v in img8[y, x])
            parts.append(f'<rect x="{x}" y="{y}" width="1" height="1" '
                         f'fill="#{r:02x}{g:02x}{b:02x}"/>')
    parts.append("</svg>")
    Path(path).write_text("\n".join(parts))
