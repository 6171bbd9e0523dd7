"""kofft_tpu_torch.native: the C++ host runtime (ctypes bindings, built
at first use).

The port's copy of ``kofft_tpu.native``: PNG encoding, WAV PCM decode and
the streaming overlap-add core, with the same functions and the same
``None`` results when the library cannot be built, so that every caller
keeps its pure-Python path. g++ builds ``kofft_host.cpp`` into the port's
build directory (``build/kofft_tpu_torch/`` at the root of the checkout,
or where ``enable_compilation_cache`` points), under a name that hashes
the source and flags. It compiles to a name of its own and renames the
result into place, so that processes building at once (test workers)
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops import _cuda_build

_SRC = Path(__file__).resolve().parent / "kofft_host.cpp"
# no -march=native: the build directory may be carried to another host
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _cuda_build.BUILD_DIR / f"libkofft_host-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> bool:
    """Compile the shared library (g++ -O3 -lz) unless it is built.
    Returns success."""
    out = _path()
    if out.exists() and not force:
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-lz", "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        lib = ctypes.CDLL(str(_path()))
        lib.kofft_png_encode.restype = ctypes.c_int64
        lib.kofft_png_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.kofft_free.argtypes = [ctypes.c_void_p]
        lib.kofft_free.restype = None
        lib.kofft_wav_decode_i16.restype = ctypes.c_int64
        lib.kofft_wav_decode_i16.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.kofft_ola_new.restype = ctypes.c_void_p
        lib.kofft_ola_new.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p]
        lib.kofft_ola_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.kofft_ola_push.restype = None
        lib.kofft_ola_flush.restype = ctypes.c_int64
        lib.kofft_ola_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.kofft_ola_delete.argtypes = [ctypes.c_void_p]
        lib.kofft_ola_delete.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def png_encode(img: np.ndarray) -> Optional[bytes]:
    """RGB (H, W, 3) uint8/uint16 -> PNG bytes, or None if unavailable.
    Byte-identical to kofft_tpu_torch.utils.image.encode_png."""
    lib = _load()
    if lib is None:
        return None
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        return None
    if img.dtype == np.uint8:
        depth, raw = 8, np.ascontiguousarray(img)
    elif img.dtype == np.uint16:
        depth, raw = 16, np.ascontiguousarray(img.astype(">u2"))
    else:
        return None
    out = ctypes.c_void_p()
    n = lib.kofft_png_encode(raw.ctypes.data_as(ctypes.c_void_p),
                             img.shape[1], img.shape[0], depth,
                             ctypes.byref(out))
    if n <= 0:
        return None
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.kofft_free(out)


def wav_decode_i16(data: bytes):
    """WAV bytes -> (samples f32 interleaved, sample_rate, channels) or
    None. Reference hound i16 semantics."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(data, len(data))
    out = ctypes.c_void_p()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    n = lib.kofft_wav_decode_i16(buf, len(data), ctypes.byref(out),
                                 ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(
            ctypes.cast(out, ctypes.POINTER(ctypes.c_float)),
            shape=(n,)).copy()
    finally:
        lib.kofft_free(out)
    return arr, int(sr.value), int(ch.value)


class NativeOla:
    """Streaming overlap-add state in C++ (reference IstftStream rolling
    OLA, stft.rs:453-519). Push time-domain frames, receive hop chunks."""

    def __init__(self, win: int, hop: int, window: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        w = np.ascontiguousarray(window, dtype=np.float32)
        if w.shape != (win,):
            raise ValueError("window length must equal win")
        self._lib = lib
        self._st = lib.kofft_ola_new(win, hop,
                                     w.ctypes.data_as(ctypes.c_void_p))
        if not self._st:
            raise ValueError("invalid win/hop")
        self._win, self._hop = win, hop

    def push(self, frame: np.ndarray) -> np.ndarray:
        f = np.ascontiguousarray(frame, dtype=np.float32)
        if f.shape != (self._win,):
            raise ValueError(f"frame must have length {self._win}")
        out = np.empty(self._hop, np.float32)
        self._lib.kofft_ola_push(self._st,
                                 f.ctypes.data_as(ctypes.c_void_p),
                                 out.ctypes.data_as(ctypes.c_void_p))
        return out

    def flush(self) -> np.ndarray:
        out = np.empty(max(0, self._win - self._hop), np.float32)
        n = self._lib.kofft_ola_flush(
            self._st, out.ctypes.data_as(ctypes.c_void_p))
        return out[:n]

    def __del__(self):
        st = getattr(self, "_st", None)
        if st:
            self._lib.kofft_ola_delete(st)
            self._st = None
