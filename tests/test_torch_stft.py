"""The port's STFT / ISTFT against kofft_tpu and a float64 oracle on the
CPU, following the cases of tests/test_stft.py and the STFT cases of
tests/test_f64.py.

The same seeded numpy inputs go through both packages; the port's
entries get ``device="cpu"``. Tolerances: float32 spectra >= 100 dB
against the JAX package and against the float64 oracle; an ISTFT's
interior (samples win ... N - win, away from the window's onset) >= 90
dB; the streaming forms against the offline ones >= 110 dB (the same
transforms in another batch shape or summation order); float64 (which
the port keeps and the JAX package without x64 downcasts) >= 250 dB
against numpy, as tests/test_f64.py holds it. At win = 2^14 with
``backend="cuda"`` the port runs the stage kernels' plain versions on CPU
tensors, held against the JAX package on ``xla``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kofft_tpu as jk  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu.ops import stft as JS  # noqa: E402
from kofft_tpu_torch.ops import stft as TS  # noqa: E402
from kofft_tpu_torch.ops import window as TW  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

SNR = 100.0
ISTFT_DB = 90.0
STREAM_DB = 110.0
F64_DB = 250.0
CPU = {"device": "cpu"}


def _sig(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _c(r, i):
    return np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64)


def ref_stft(x, w, hop):
    """Reference-semantics STFT in float64 numpy."""
    n, win = len(x), len(w)
    nf = -(-n // hop)
    frames = np.zeros((nf, win))
    for f in range(nf):
        seg = x[f * hop: f * hop + win]
        frames[f, : len(seg)] = seg
    return np.fft.fft(frames * w, axis=-1)


def ref_istft(frames, w, hop, length):
    """Reference-semantics ISTFT in float64 numpy."""
    win = len(w)
    out = np.zeros(length)
    norm = np.zeros(length)
    t = np.fft.ifft(frames, axis=-1).real * w
    for f in range(frames.shape[0]):
        s = f * hop
        e = min(s + win, length)
        out[s:e] += t[f, : e - s]
        norm[s:e] += (w * w)[: e - s]
    mask = norm > 1e-8
    out[mask] /= norm[mask]
    return out


@pytest.mark.parametrize("n,win,hop", [(1000, 64, 16), (512, 128, 32),
                                       (333, 64, 64), (100, 32, 8),
                                       (64, 8, 3)])
def test_stft_vs_jax_and_reference(n, win, hop):
    x = _sig(n, n + win)
    w = TW.hann(win)
    got = tk.stft(x, w, hop, **CPU).numpy()
    ref = ref_stft(x.astype(np.float64), w.astype(np.float64), hop)
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert snr_db(ref, got) > SNR
    assert snr_db(np.asarray(jk.stft(x, w, hop)), got) > SNR


def test_stft_istft_roundtrip():
    n, win, hop = 2048, 256, 64
    x = _sig(n, 1)
    w = TW.hann(win)
    frames = tk.stft(x, w, hop, **CPU)
    back = tk.istft(frames, w, hop, length=n, **CPU).numpy()
    assert back.shape == (n,) and back.dtype == np.float32
    assert snr_db(x[win:-win], back[win:-win]) > ISTFT_DB
    jback = np.asarray(jk.istft(np.asarray(jk.stft(x, w, hop)), w, hop,
                                length=n))
    assert snr_db(jback[win:-win], back[win:-win]) > SNR


@pytest.mark.parametrize("n,win,hop", [(777, 64, 16), (64, 8, 3)])
def test_istft_vs_jax_and_reference(n, win, hop):
    """win % hop == 0 takes the k-shifted adds, 8/3 the index add."""
    x = _sig(n, 2)
    w64 = TW.hann(win).astype(np.float64)
    frames = ref_stft(x.astype(np.float64), w64, hop)
    ref = ref_istft(frames, w64, hop, n)
    f32 = frames.astype(np.complex64)
    got = tk.istft(f32, TW.hann(win), hop, length=n, **CPU).numpy()
    assert snr_db(ref, got) > SNR
    assert snr_db(np.asarray(jk.istft(f32, TW.hann(win), hop, length=n)),
                  got) > SNR


def test_stft_onesided():
    n, win, hop = 512, 64, 16
    x = _sig(n, 3)
    w = TW.hann(win)
    full = tk.stft(x, w, hop, **CPU).numpy()
    one = tk.stft(x, w, hop, onesided=True, **CPU).numpy()
    assert one.shape == (32, win // 2 + 1)
    np.testing.assert_allclose(one, full[..., : win // 2 + 1], rtol=1e-4,
                               atol=1e-3)
    assert snr_db(np.asarray(jk.stft(x, w, hop, onesided=True)), one) > SNR


def test_stft_batched():
    x = _sig((3, 500), 4)
    w = TW.hann(64)
    got = tk.stft(x, w, 16, **CPU).numpy()
    assert got.shape == (3, 32, 64)
    for b in range(3):
        ref = ref_stft(x[b].astype(np.float64), w.astype(np.float64), 16)
        assert snr_db(ref, got[b]) > SNR
    assert snr_db(np.asarray(jk.stft(x, w, 16)), got) > SNR


def test_streaming_stft_matches_batch():
    n, win, hop = 400, 64, 16
    x = _sig(n, 5)
    w = TW.hann(win)
    batch = tk.stft(x, w, hop, **CPU).numpy()
    frames = [_c(fr, fi) for fr, fi in TS.StftStream(x, w, hop, **CPU)]
    assert len(frames) == batch.shape[0]
    assert snr_db(batch, np.stack(frames)) > STREAM_DB
    jframes = [_c(fr, fi) for fr, fi in JS.StftStream(x, w, hop)]
    assert snr_db(np.stack(jframes), np.stack(frames)) > SNR


def test_streaming_istft_matches_offline():
    n, win, hop = 512, 64, 16
    x = _sig(n, 6)
    w = TW.hann(win)
    frames = tk.stft(x, w, hop, **CPU).numpy()
    nf = frames.shape[0]
    offline = tk.istft(frames, w, hop, length=(nf - 1) * hop + win,
                       **CPU).numpy()
    stream = TS.IstftStream(win, hop, w, **CPU)
    chunks = [stream.push_frame(frames[f]) for f in range(nf)]
    chunks.append(stream.flush())
    assert all(isinstance(c, np.ndarray) for c in chunks)
    got = np.concatenate(chunks)
    assert got.shape == offline.shape
    assert snr_db(offline, got) > STREAM_DB
    js = JS.IstftStream(win, hop, w)
    jgot = np.concatenate([js.push_frame(frames[f]) for f in range(nf)]
                          + [js.flush()])
    assert snr_db(jgot, got) > SNR


def test_frame_apis():
    n, win = 200, 64
    x = _sig(n, 7)
    w = TW.hann(win)
    for start in (32, n - 10, n + 5):
        fr, fi = TS.frame_split(x, w, start=start, **CPU)
        seg = np.zeros(win)
        avail = max(0, min(win, n - start))
        seg[:avail] = x[start: start + avail]
        assert snr_db(np.fft.fft(seg * w), _c(fr, fi)) > SNR, start
        assert snr_db(_c(*JS.frame_split(x, w, start=start)),
                      _c(fr, fi)) > SNR, start
    # a negative start counts from the end of the padded signal, as the
    # JAX package's dynamic slice takes it
    fr, fi = TS.frame_split(x, w, start=-3, **CPU)
    np.testing.assert_array_equal(_c(fr, fi),
                                  _c(*JS.frame_split(x, w, start=-3)))


def test_bad_hop_raises():
    with pytest.raises(tk.KofftError):
        tk.stft(np.zeros(64, np.float32), TW.hann(16), 0, **CPU)
    with pytest.raises(tk.InvalidHopSizeError):
        tk.istft(np.zeros((4, 16), np.complex64), TW.hann(16), 0, **CPU)
    with pytest.raises(tk.InvalidHopSizeError):
        TS.StftPushStream(TW.hann(16), 0, **CPU)


def test_istft_frame_window_mismatch_raises():
    with pytest.raises(tk.MismatchedLengthsError):
        tk.istft(np.zeros((4, 32), np.complex64), TW.hann(16), 8, **CPU)
    with pytest.raises(tk.MismatchedLengthsError):
        TS.IstftStream(32, 8, TW.hann(16), **CPU)


def test_istft_stream_scan_matches_push_flush():
    win, hop, nf = 64, 16, 12
    x = _sig(nf * hop + win, 8)
    w = TW.hann(win)
    frames = tk.stft(x[: nf * hop], w, hop, **CPU).numpy()[:nf]
    fr = np.ascontiguousarray(frames.real)
    fi = np.ascontiguousarray(frames.imag)
    st = TS.IstftStream(win, hop, w, **CPU)
    ref = np.concatenate([st.push_frame(fr[k], fi[k]) for k in range(nf)]
                         + [st.flush()])
    got = TS.istft_stream_scan(fr, fi, w, hop, **CPU).numpy()
    assert got.shape == ref.shape == (nf * hop + win - hop,)
    assert snr_db(ref, got) > STREAM_DB
    assert snr_db(np.asarray(JS.istft_stream_scan(fr, fi, w, hop)),
                  got) > SNR


def test_stft_stream_scan_matches_offline():
    win, hop = 64, 16
    n = 50 * hop + 7
    x = _sig(n, 9)
    w = TW.hann(win)
    for onesided in (False, True):
        rr, ri = tk.stft_split(x, w, hop, onesided=onesided, **CPU)
        yr, yi = TS.stft_stream_scan(x, w, hop, onesided=onesided, **CPU)
        k = win // 2 + 1 if onesided else win
        assert yr.shape == (TS.num_frames(n, hop), k)
        assert snr_db(_c(rr, ri), _c(yr, yi)) > STREAM_DB
        jr, ji = JS.stft_stream_scan(x, w, hop, onesided=onesided)
        assert snr_db(_c(jr, ji), _c(yr, yi)) > SNR


@pytest.mark.parametrize("win,hop,n", [(64, 16, 1000), (64, 24, 777),
                                       (32, 32, 300)])
def test_stream_scans_across_chunks(monkeypatch, win, hop, n):
    """Chunks of 3 frames: the forward scan against stft_split, the
    inverse (overlap-add carried across chunks) against the offline
    istft of the same frames."""
    monkeypatch.setattr(TS, "_SCAN_POINTS", 3 * win)
    x = _sig(n, win + hop)
    w = TW.hann(win) if hop < win else np.ones(win, np.float32)
    rr, ri = tk.stft_split(x, w, hop, **CPU)
    yr, yi = TS.stft_stream_scan(x, w, hop, **CPU)
    assert snr_db(_c(rr, ri), _c(yr, yi)) > STREAM_DB
    nf = yr.shape[0]
    offline = tk.istft_split(rr, ri, w, hop, **CPU).numpy()
    got = TS.istft_stream_scan(yr, yi, w, hop, **CPU).numpy()
    assert got.shape == offline.shape == ((nf - 1) * hop + win,)
    assert snr_db(offline, got) > STREAM_DB


def test_stft_stream_scan_matches_streaming_class():
    win, hop, n = 32, 8, 100
    x = _sig(n, 10)
    w = TW.hamming(win)
    yr, yi = TS.stft_stream_scan(x, w, hop, **CPU)
    frames = list(TS.StftStream(x, w, hop, **CPU))
    assert len(frames) == yr.shape[0]
    for f, (fr, fi) in enumerate(frames):
        assert snr_db(_c(fr, fi), _c(yr[f], yi[f])) > STREAM_DB


def _push_all(st, x, cuts):
    parts, pos = [], 0
    for c in cuts:
        parts.append(st.push(x[pos: pos + c]))
        pos += c
    parts.append(st.push(x[pos:]))
    parts.append(st.flush())
    return _c(torch.cat([p[0] for p in parts]),
              torch.cat([p[1] for p in parts]))


def test_stft_push_stream_chunked_parity():
    """Irregular chunks, then flush, reproduce stft_split: exactly k frames
    per push (no power-of-two bucket)."""
    win, hop = 64, 16
    n = 37 * hop + 5
    x = _sig(n, 11)
    w = TW.hann(win)
    ref = _c(*tk.stft_split(x, w, hop, **CPU))
    st = TS.StftPushStream(w, hop, **CPU)
    got = _push_all(st, x, (3, 200, 1, 64, 500, 10))
    assert got.shape == ref.shape
    assert snr_db(ref, got) > STREAM_DB
    assert st.buffered == 0
    jst = JS.StftPushStream(w, hop)
    parts, pos = [], 0
    for c in (3, 200, 1, 64, 500, 10):
        parts.append(jst.push(x[pos: pos + c]))
        pos += c
    parts += [jst.push(x[pos:]), jst.flush()]
    jgot = _c(np.concatenate([p[0] for p in parts]),
              np.concatenate([p[1] for p in parts]))
    assert snr_db(jgot, got) > SNR


def test_stft_push_stream_onesided_and_empty():
    win, hop = 32, 8
    w = TW.hann(win)
    st = TS.StftPushStream(w, hop, onesided=True, **CPU)
    fr, fi = st.push(np.zeros(4, np.float32))
    assert fr.shape == (0, win // 2 + 1)
    x = _sig(win + 3 * hop, 12)
    fr, fi = st.push(x)
    assert fr.shape == (4, win // 2 + 1)
    rr, ri = tk.stft_split(np.concatenate([np.zeros(4, np.float32), x]), w,
                           hop, onesided=True, **CPU)
    assert snr_db(_c(rr, ri)[:4], _c(fr, fi)) > STREAM_DB


def test_stft_push_stream_hop_greater_than_win():
    """hop > win: the drain can exceed the buffer and the gap between
    frames is remembered."""
    win, hop, n = 32, 100, 405
    x = _sig(n, 13)
    w = TW.hann(win)
    ref = _c(*tk.stft_split(x, w, hop, **CPU))
    st = TS.StftPushStream(w, hop, **CPU)
    got = _push_all(st, x, (135, 165))
    assert got.shape == ref.shape
    assert snr_db(ref, got) > STREAM_DB


def test_istft_length_longer_than_ola_pads():
    x = _sig(64, 14)
    w = TW.hann(16)
    y = tk.stft(x, w, hop=8, **CPU)
    out = tk.istft(y, w, hop=8, length=200, **CPU).numpy()
    assert out.shape[-1] == 200
    assert np.all(out[100:] == 0.0)
    jout = np.asarray(jk.istft(y.numpy(), w, hop=8, length=200))
    assert snr_db(jout, out) > SNR


def test_tensor_input_and_gradient():
    """A tensor is computed where it lies; the gradient of a spectral
    energy through stft equals the JAX package's."""
    x = _sig(128, 15)
    w = TW.hann(16)
    xt = torch.tensor(x, requires_grad=True)
    y = tk.stft(xt, w, hop=8)
    assert y.device.type == "cpu"
    y.abs().square().sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnp.abs(jk.stft(v, w, hop=8)) ** 2))(
        jnp.asarray(x))
    assert snr_db(np.asarray(jg), xt.grad.numpy()) > SNR
    back = tk.istft(y, w, hop=8, length=128)
    rback = ref_istft(ref_stft(x.astype(np.float64), w.astype(np.float64),
                               8), w.astype(np.float64), 8, 128)
    assert snr_db(rback, back.detach().numpy()) > SNR


def test_host_input_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tk.stft(_sig(64, 16), TW.hann(16), 8)


def test_inverse_frame_split_roundtrip():
    x = _sig(64, 17)
    w = TW.hann(16)
    fr, fi = TS.frame_split(x, w, start=8, **CPU)
    tr = TS.inverse_frame_split(fr, fi, w, **CPU).numpy()
    ref = (x[8:24].astype(np.float64) * w) * w
    assert snr_db(ref, tr) > SNR
    jtr = np.asarray(JS.inverse_frame_split(*JS.frame_split(x, w, start=8),
                                            w))
    assert snr_db(jtr, tr) > SNR


def test_istft_stream_scan_hop_equals_win():
    x = _sig(64, 18)
    w = np.ones(8, dtype=np.float32)
    y = tk.stft(x, w, hop=8, **CPU)
    out = TS.istft_stream_scan(y.real.contiguous(), y.imag.contiguous(), w,
                               hop=8, **CPU).numpy()
    assert snr_db(x.astype(np.float64), out) > SNR


def test_istft_stream_flush_edge_cases():
    w = np.ones(8, dtype=np.float32)
    s = TS.IstftStream(8, 8, w, **CPU)
    s.push_frame(np.ones(8, np.float32), np.zeros(8, np.float32))
    assert s.flush().shape == (0,)
    s2 = TS.IstftStream(8, 4, w, **CPU)
    assert s2.flush().shape == (0,)
    with pytest.raises(tk.MismatchedLengthsError):
        s2.push_frame(np.zeros(4, np.float32), np.zeros(4, np.float32))


def test_istft_synthesis_tier_floor():
    """The synthesis never runs below `high`: `default` is lifted inside
    the context and restored after, also when the body raises; the other
    tiers pass through."""
    from kofft_tpu_torch.config import get_config, set_precision
    set_precision("default")
    try:
        with TS._synthesis_tier():
            assert get_config().precision == "high"
        assert get_config().precision == "default"
        with pytest.raises(ValueError):
            with TS._synthesis_tier():
                raise ValueError("inside")
        assert get_config().precision == "default"
    finally:
        set_precision(None)
    set_precision("highest")
    try:
        with TS._synthesis_tier():
            assert get_config().precision == "highest"
    finally:
        set_precision(None)


def test_istft_roundtrip_on_the_default_tier():
    from kofft_tpu_torch.config import set_precision
    n, win, hop = 4096, 256, 64
    x = _sig(n, 19)
    w = TW.hann(win)
    set_precision("default")
    try:
        back = tk.istft(tk.stft(x, w, hop, **CPU), w, hop, length=n,
                        **CPU).numpy()
    finally:
        set_precision(None)
    assert snr_db(x[win:-win], back[win:-win]) > ISTFT_DB


@pytest.mark.parametrize("onesided", [False, True])
def test_stft_on_the_kernel_path_at_2_14(onesided):
    """win = 2^14 with backend='cuda': the stage kernels' plain versions on
    CPU tensors (stage1/stage2, or stage1_real/stage2_half), against the
    JAX package on xla and the float64 oracle; the ISTFT through the
    complex pair."""
    win, hop = 1 << 14, 1 << 13
    n = 3 * hop + 5
    x = _sig(n, 20)
    w = TW.hann(win)
    yr, yi = tk.stft_split(x, w, hop, onesided=onesided, backend="cuda",
                           **CPU)
    ref = ref_stft(x.astype(np.float64), w.astype(np.float64), hop)
    k = win // 2 + 1 if onesided else win
    assert snr_db(ref[:, :k], _c(yr, yi)) > SNR
    jr, ji = JS.stft_split(x, w, hop, onesided=onesided, backend="xla")
    assert snr_db(_c(jr, ji), _c(yr, yi)) > SNR
    if not onesided:
        back = tk.istft_split(yr, yi, w, hop, length=n, backend="cuda",
                              **CPU).numpy()
        assert snr_db(x[win:-win], back[win:-win]) > ISTFT_DB
        rback = ref_istft(ref, w.astype(np.float64), hop, n)
        assert snr_db(rback[win:-win], back[win:-win]) > SNR


def test_stft_istft_f64_roundtrip():
    """float64 stays float64 (the JAX package without x64 downcasts it):
    held against numpy, as tests/test_f64.py does."""
    x = np.random.default_rng(21).standard_normal(8192)
    w = TW.hann(512, dtype="float64")
    frames = tk.stft(x, w, hop=256, **CPU)
    assert frames.dtype == torch.complex128
    assert snr_db(ref_stft(x, w, 256), frames.numpy()) > F64_DB
    back = tk.istft(frames, w, hop=256, length=8192, **CPU)
    assert back.dtype == torch.float64
    assert snr_db(x[512:-512], back.numpy()[512:-512]) > F64_DB


def test_istft_stream_scan_mixed_dtype():
    """float64 frame planes with a float32 window compute in float64."""
    win, hop, nf = 64, 16, 8
    x = np.random.default_rng(22).standard_normal(nf * hop)
    w32 = TW.hann(win)
    frames = tk.stft(x, w32.astype(np.float64), hop, **CPU).numpy()[:nf]
    fr = np.ascontiguousarray(frames.real)
    fi = np.ascontiguousarray(frames.imag)
    out = TS.istft_stream_scan(fr, fi, w32, hop, **CPU)
    assert out.dtype == torch.float64
    ref = tk.istft(frames, w32.astype(np.float64), hop, length=nf * hop,
                   **CPU).numpy()
    assert snr_db(ref, out.numpy()[: nf * hop]) > ISTFT_DB
