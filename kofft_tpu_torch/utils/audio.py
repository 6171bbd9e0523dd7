"""Audio decoding (host side).

The port's copy of ``kofft_tpu.utils.audio``, on the port's ``native``.

Reference surface: ``sanity-check/src/lib.rs:26-107`` —
  * ``.wav``: hound reader, samples read as i16 / 32767, interleaved
    channels kept as-is (the reference does NOT downmix the wav path),
  * other formats (flac/mp3/...): symphonia probe/decode with stereo->mono
    mean downmix and truncation to the declared frame count.

Here: wav via the stdlib ``wave`` module with identical i16 semantics;
other formats decode through ffmpeg when available (the environment has no
symphonia equivalent), with the same mean downmix.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import wave
from pathlib import Path

import numpy as np

from ..errors import InvalidValueError


def read_wav(path) -> tuple[np.ndarray, int]:
    """(samples_f32, sample_rate): i16 semantics, channels interleaved
    (reference ``read_wav``, ``sanity-check/src/lib.rs:99-107``).
    16-bit PCM files decode through the native C++ parser when available."""
    raw_bytes = Path(path).read_bytes()
    from ..native import wav_decode_i16
    native_out = wav_decode_i16(raw_bytes)
    if native_out is not None:
        samples, sr, _ch = native_out
        return samples, sr
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 127.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / (2**31 - 1)
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float((1 << 23) - 1)
    else:
        raise InvalidValueError(f"unsupported wav sample width {width}")
    return data, sr


def write_wav(path, samples, sample_rate: int, channels: int = 1) -> None:
    """i16 PCM writer (test fixture generation)."""
    x = np.asarray(samples, dtype=np.float32)
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def _read_via_ffmpeg(path) -> tuple[np.ndarray, int]:
    ffprobe = shutil.which("ffprobe")
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise InvalidValueError(
            f"cannot decode {path}: only .wav is supported without ffmpeg "
            f"in this environment")
    sr = None
    if ffprobe:
        try:
            out = subprocess.run(
                [ffprobe, "-v", "error", "-select_streams", "a:0",
                 "-show_entries", "stream=sample_rate", "-of", "csv=p=0",
                 str(path)], capture_output=True, text=True, check=True)
            sr = int(out.stdout.strip())
        except Exception:
            sr = None
    # mono mean downmix (reference downmix, sanity-check/src/lib.rs:76-84).
    # Without a trustworthy probed rate, force-resample to 44100 so the
    # returned data actually matches the rate we report (a silently wrong
    # rate skews every downstream time/frequency mapping).
    cmd = [ffmpeg, "-v", "error", "-i", str(path), "-f", "f32le", "-ac", "1"]
    if sr is None:
        sr = 44100
        cmd += ["-ar", str(sr)]
    out = subprocess.run(cmd + ["-"], capture_output=True, check=True)
    return np.frombuffer(out.stdout, dtype="<f4").copy(), sr


def read_audio(path) -> tuple[np.ndarray, int]:
    """Decode any supported audio file (reference ``read_audio``,
    ``sanity-check/src/lib.rs:26-97``)."""
    p = Path(path)
    if p.suffix.lower() == ".wav":
        return read_wav(p)
    return _read_via_ffmpeg(p)
