"""The port's host utilities against kofft_tpu and plain references on
the CPU, following tests/test_native.py: the PNG/SVG writers and the WAV
reader (``kofft_tpu_torch.utils.image``/``audio``), the port's own native
host library (``kofft_tpu_torch.native``) and the observability helpers
(``trace``, ``enable_compilation_cache``, ``prewarm``).

The PNG and SVG bytes equal the JAX package's pure-Python writers; the
native PNG encoder equals the zlib encoder byte for byte; the native WAV
decoder equals the i16 * (1/32767 in float32) product of numpy on the
samples that ``wave`` reads; ``NativeOla`` equals a float32 numpy
overlap-add loop. These tests never import ``kofft_tpu.native``, whose
build writes into the JAX package's tree.
"""

import ctypes
import json
import threading
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kofft_tpu.utils import image as JI  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu_torch import native  # noqa: E402
from kofft_tpu_torch.errors import InvalidValueError  # noqa: E402
from kofft_tpu_torch.ops import _cuda_build  # noqa: E402
from kofft_tpu_torch.utils import audio as TA  # noqa: E402
from kofft_tpu_torch.utils import image as TI  # noqa: E402
from kofft_tpu_torch.utils import observability as TO  # noqa: E402


def _img(rng, shape, dtype):
    top = 255 if dtype == np.uint8 else 65535
    return (rng.random(shape) * top).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(20, 30, 3), (1, 1, 3), (7, 5, 3)])
def test_png_bytes_and_round_trip(rng, dtype, shape):
    img = _img(rng, shape, dtype)
    data = TI.encode_png(img)
    assert data == JI.encode_png(img)
    np.testing.assert_array_equal(TI.decode_png(data), img)
    np.testing.assert_array_equal(JI.decode_png(data), img)


def test_png_rejects_bad_input(tmp_path):
    with pytest.raises(InvalidValueError):
        TI.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(InvalidValueError):
        TI.encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(InvalidValueError):
        TI.decode_png(b"GIF89a")
    with pytest.raises(InvalidValueError):
        TI.save_png(np.zeros((2, 2, 3), np.uint8), tmp_path / "x.png",
                    depth="four")


@pytest.mark.parametrize("depth", ["eight", "sixteen"])
def test_save_png_as_the_jax_encoder(tmp_path, rng, depth):
    """save_png (the native encoder) writes what the JAX package's
    pure-Python encoder gives for the same depth conversion."""
    img = _img(rng, (9, 11, 3), np.uint16)
    TI.save_png(img, tmp_path / "a.png", depth)
    want = (img >> 8).astype(np.uint8) if depth == "eight" else img
    assert (tmp_path / "a.png").read_bytes() == JI.encode_png(want)


def test_save_svg_as_the_jax_writer(tmp_path, rng):
    img = _img(rng, (3, 4, 3), np.uint16)
    TI.save_svg(img, tmp_path / "t.svg")
    JI.save_svg(img, tmp_path / "j.svg")
    assert (tmp_path / "t.svg").read_bytes() == \
        (tmp_path / "j.svg").read_bytes()


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip(tmp_path, rng, channels):
    """write_wav -> read_wav returns the samples quantized to i16 / 32767,
    and ``wave`` reads the same frames."""
    x = rng.uniform(-0.9, 0.9, 441 * channels).astype(np.float32)
    p = tmp_path / "x.wav"
    TA.write_wav(p, x, 22050, channels)
    got, sr = TA.read_wav(p)
    assert sr == 22050 and got.dtype == np.float32
    q = np.clip(np.round(x * 32767.0), -32768, 32767)
    np.testing.assert_allclose(got, q / 32767.0, atol=1e-7)
    got2, sr2 = TA.read_audio(p)
    np.testing.assert_array_equal(got2, got)
    with wave.open(str(p), "rb") as w:
        assert w.getnchannels() == channels and w.getframerate() == 22050
        raw = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    np.testing.assert_array_equal(raw, q.astype(np.int16))


def test_native_builds_into_the_build_dir():
    assert native.available()
    path = native._path()
    assert path.parent == _cuda_build.BUILD_DIR and path.exists()
    assert path.name.startswith("libkofft_host-")


def test_native_concurrent_builds_leave_a_whole_library():
    """Builds racing on one output (as test workers would) each compile to
    a name of their own and rename into place: the library loads after
    them and no temporary file stays behind."""
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(native.build(force=True)))
        for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert results == [True, True, True]
    lib = ctypes.CDLL(str(native._path()))
    assert hasattr(lib, "kofft_png_encode")
    assert not list(native._path().parent.glob("libkofft_host-*.tmp"))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_native_png_equals_zlib_encoder(rng, dtype):
    img = _img(rng, (20, 30, 3), dtype)
    assert native.png_encode(img) == TI.encode_png(img)
    assert native.png_encode(np.zeros((4, 4), np.uint8)) is None
    assert native.png_encode(np.zeros((4, 4, 3), np.float32)) is None


def test_native_wav_decode(tmp_path, rng):
    p = tmp_path / "s.wav"
    x = rng.uniform(-1.0, 1.0, 2 * 301).astype(np.float32)
    TA.write_wav(p, x, 16000, 2)
    samples, sr, ch = native.wav_decode_i16(p.read_bytes())
    assert (sr, ch) == (16000, 2)
    with wave.open(str(p), "rb") as w:
        raw = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    scale = np.float32(1.0) / np.float32(32767.0)
    np.testing.assert_array_equal(samples, raw.astype(np.float32) * scale)
    assert native.wav_decode_i16(b"not a wav file at all") is None
    assert native.wav_decode_i16(b"RIFF" + b"\0" * 60) is None


@pytest.mark.parametrize("win,hop", [(16, 4), (8, 8), (12, 5)])
def test_native_ola_equals_numpy(rng, win, hop):
    """Push frames, pop hop samples each; flush the win - hop tail: the
    float32 overlap-add divided by the accumulated window square where it
    exceeds 1e-8."""
    w = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)).astype(
        np.float32)
    frames = rng.standard_normal((9, win)).astype(np.float32)
    ola = native.NativeOla(win, hop, w)
    got = [ola.push(f) for f in frames] + [ola.flush()]
    buf = np.zeros(win, np.float32)
    nrm = np.zeros(win, np.float32)
    want = []

    def emit(k):
        return np.divide(buf[:k], nrm[:k], out=buf[:k].copy(),
                         where=nrm[:k] > np.float32(1e-8))
    for f in frames:
        buf += f * w
        nrm += w * w
        want.append(emit(hop))
        buf = np.concatenate([buf[hop:], np.zeros(hop, np.float32)])
        nrm = np.concatenate([nrm[hop:], np.zeros(hop, np.float32)])
    want.append(emit(win - hop))
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate(want))
    assert ola.flush().size == 0
    with pytest.raises(ValueError):
        native.NativeOla(win, win + 1, w)
    with pytest.raises(ValueError):
        ola.push(np.zeros(win + 1, np.float32))


def test_trace_writes_a_trace(tmp_path):
    with tk.trace(tmp_path / "t"):
        tk.fft(np.ones(64, np.float32), device="cpu")
    files = list((tmp_path / "t").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("fft" in str(e.get("name", "")).lower() or
               "matmul" in str(e.get("name", "")).lower() for e in events)


def test_enable_compilation_cache_sets_and_restores(tmp_path):
    old = _cuda_build.BUILD_DIR
    try:
        p = tk.enable_compilation_cache(tmp_path / "cache")
        assert p == str(tmp_path / "cache")
        assert _cuda_build.BUILD_DIR == tmp_path / "cache"
        assert (tmp_path / "cache").is_dir()
        assert native._path().parent == tmp_path / "cache"
    finally:
        _cuda_build.BUILD_DIR = old
    assert native._path().parent == old


def test_prewarm_runs_the_entries():
    TO.prewarm([64, 100], batch_shape=(2,), rfft_sizes=[64],
               ndfft_shapes=[(4, 8)], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TO.prewarm([64])


def test_asnumpy_gathers_a_dtensor(rng):
    """asnumpy of the sharded programs' DTensor output is the gathered
    global value (a world of one gloo rank in this process, torn down
    after)."""
    import torch.distributed as dist
    from kofft_tpu_torch.parallel import fftn_sharded, make_mesh
    started = not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        xr = rng.standard_normal((8, 16)).astype(np.float32)
        yr, yi = fftn_sharded(xr, np.zeros_like(xr), mesh=mesh)
        got = tk.asnumpy(yr) + 1j * tk.asnumpy(yi)
        assert got.shape == (8, 16)
        np.testing.assert_allclose(got, np.fft.fft2(xr), rtol=1e-4,
                                   atol=1e-4)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
