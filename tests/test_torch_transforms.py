"""The port's composite transforms (DCT/DST, Hartley, Hilbert, CZT,
Goertzel, cepstrum/MFCC) against kofft_tpu and float64 oracles built from
the reference library's formulas, on the CPU, following the cases of
tests/test_transforms.py.

The same seeded numpy inputs go through both packages; the port's
entries get ``device="cpu"``. Tolerances: float32 outputs >= 100 dB
against the JAX package and against the float64 oracle (a round trip
too); the FFT-composed DCT/DST paths against the matrix forms as
tests/test_transforms.py holds them (max error < 2e-4 of the largest
value); Goertzel magnitudes rel 1e-3, as the reference test. At n = 2^14
with ``backend="cuda"`` the port runs the stage kernels' plain versions
on CPU tensors, held against the JAX package on ``xla``; the
``goertzel_scan`` wrapper runs its plain version on CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kofft_tpu as jk  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu.ops import (cepstrum as JCe, czt as JC, dct as JD,  # noqa: E402
                           dst as JS, goertzel as JG, hartley as JHa,
                           hilbert as JH)
from kofft_tpu_torch.ops import (cepstrum as Ce, czt as C,  # noqa: E402
                                 dct as D, dst as S, goertzel as G,
                                 hartley as Ha, hilbert as H)
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402
from scipy_free_ref import analytic_ref  # noqa: E402

SNR = 100.0
CPU = {"device": "cpu"}


def _sig(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().numpy()


def ref_dct(x, kind):
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    if kind == 1:
        if n == 1:
            return 2.0 * x
        m = 2 * np.cos(np.pi * i * k / (n - 1))
        m[0] = 1.0
        m[-1] = (-1.0) ** np.arange(n)
        return x @ m
    if kind == 2:
        return x @ np.cos(np.pi * (i + .5) * k / n)
    if kind == 3:
        m = np.cos(np.pi * i * (k + .5) / n)
        m[0] = 0.5
        return x @ m
    return x @ np.cos(np.pi * (i + .5) * (k + .5) / n)


def ref_dst(x, kind):
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    if kind == 1:
        return x @ np.sin(np.pi * (i + 1) * (k + 1) / (n + 1))
    if kind == 2:
        return x @ np.sin(np.pi * (i + .5) * (k + 1) / n)
    if kind == 3:
        m = np.sin(np.pi * (k + .5) * i / n)
        m[0] = 0.5
        return x @ m
    return x @ np.sin(np.pi * (i + .5) * (k + .5) / n)


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 8, 64, 256, 1000])
def test_dct_parity(kind, n):
    x = _sig((2, n), 10 * n + kind)
    got = _np(D.dct(x, kind, **CPU))
    assert got.shape == (2, n) and got.dtype == np.float32
    if kind == 1 and n == 1:
        np.testing.assert_allclose(got, 2 * x, rtol=1e-6)
        return
    assert snr_db(ref_dct(x, kind), got) > SNR
    assert snr_db(np.asarray(JD.dct(x, kind)), got) > SNR


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
def test_idct_roundtrip(kind):
    x = _sig((2, 64), kind)
    back = _np(D.idct(D.dct(x, kind, **CPU), kind, **CPU))
    assert snr_db(x, back) > SNR
    assert snr_db(np.asarray(JD.idct(JD.dct(x, kind), kind)), back) > SNR


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [2, 8, 64, 256, 1000])
def test_dst_parity(kind, n):
    x = _sig((2, n), 10 * n + kind + 5)
    got = _np(S.dst(x, kind, **CPU))
    assert snr_db(ref_dst(x, kind), got) > SNR
    assert snr_db(np.asarray(JS.dst(x, kind)), got) > SNR


def test_dst3_constant_term():
    """DST-III keeps the reference library's x_0/2 term (a contract
    item): the transform of a unit impulse is 1/2 in every bin."""
    e0 = np.zeros(16, np.float32)
    e0[0] = 1.0
    np.testing.assert_array_equal(_np(S.dst3(e0, **CPU)), np.full(16, 0.5))
    np.testing.assert_array_equal(np.asarray(JS.dst3(e0)), np.full(16, 0.5))


@pytest.mark.parametrize("n", [4, 16, 128, 1000, 31])
def test_dht_parity(n):
    x = _sig((2, n), n)
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    cas = np.cos(2 * np.pi * i * k / n) + np.sin(2 * np.pi * i * k / n)
    got = _np(Ha.dht(x, **CPU))
    assert snr_db(x.astype(np.float64) @ cas, got) > SNR
    assert snr_db(np.asarray(JHa.dht(x)), got) > SNR


def test_dht_involution_and_aliases():
    """DHT(DHT(x)) == n * x; the batch and multi-channel aliases."""
    n = 256
    x = _sig((3, n), 1)
    y = _np(Ha.dht(Ha.dht(x, **CPU), **CPU))
    assert snr_db(x, y / n) > SNR
    base = _np(Ha.dht(x, **CPU))
    np.testing.assert_array_equal(_np(Ha.dht_batch(x, **CPU)), base)
    np.testing.assert_array_equal(_np(Ha.dht_multi_channel(x, **CPU)), base)


@pytest.mark.parametrize("n", [8, 64, 256, 100, 31])
def test_hilbert_analytic(n):
    x = _sig(n, n + 1)
    got = _np(H.hilbert_analytic(x, **CPU))
    assert got.dtype == np.complex64
    assert snr_db(analytic_ref(x), got) > SNR
    assert snr_db(x, got.real) > SNR
    assert snr_db(np.asarray(JH.hilbert_analytic(x)), got) > SNR


def test_hilbert_public_entries():
    x = _sig((2, 64), 2)
    zr, zi = H.hilbert_analytic_split(x, **CPU)
    np.testing.assert_array_equal(_np(H.hilbert(x, **CPU)), _np(zi))
    z = _np(tk.hilbert_analytic(x, **CPU))
    np.testing.assert_array_equal(z.real, _np(zr))
    spec = np.fft.fft(z.astype(np.complex128))
    assert np.max(np.abs(spec[:, 64 // 2 + 1:])) < 1e-2 * np.max(np.abs(spec))
    jr, ji = JH.hilbert_analytic_split(x)
    assert snr_db(np.asarray(jr) + 1j * np.asarray(ji), z) > SNR


def test_czt_matches_dft():
    n = 64
    x = _sig(n, 3)
    got = _np(C.czt(x, n, np.exp(-2j * np.pi / n), **CPU))
    assert snr_db(np.fft.fft(x.astype(np.float64)), got) > SNR
    assert snr_db(np.asarray(JC.czt(x, n, np.exp(-2j * np.pi / n))),
                  got) > SNR


def test_czt_fast_matches_czt():
    n, m = 100, 60
    x = _sig((2, n), 4)
    w = np.exp(-2j * np.pi * 0.8 / m)
    a = np.exp(1j * 0.3)
    i = np.arange(n)[:, None]
    k = np.arange(m)[None, :]
    ref = x.astype(np.complex128) @ (a ** (-i) * w ** (i * k))
    slow = _np(C.czt(x, m, w, a, **CPU))
    fast = _np(C.czt_fast(x, m, w, a, **CPU))
    assert snr_db(ref, slow) > SNR
    assert snr_db(ref, fast) > SNR
    assert snr_db(np.asarray(JC.czt_fast(x, m, w, a)), fast) > SNR
    with pytest.raises(tk.InvalidValueError):
        C.czt_fast(x, m, 1.02 * w, **CPU)


def test_czt_nonunit_w():
    n, m = 16, 10
    x = _sig(n, 5)
    w, a = 1.02 * np.exp(-0.5j), 0.9 + 0.1j
    i = np.arange(n)[:, None]
    k = np.arange(m)[None, :]
    ref = (x.astype(np.complex128)[None, :]
           @ (a ** (-i) * w ** (i * k))).ravel()
    yr, yi = C.czt_split(x, m, w, a, **CPU)
    got = _np(yr) + 1j * _np(yi)
    assert snr_db(ref, got) > SNR
    assert snr_db(np.asarray(JC.czt(x, m, w, a)), got) > SNR


def test_goertzel_detects_tone():
    sr, f, n = 8000.0, 1000.0, 256
    x = np.sin(2 * np.pi * f * np.arange(n) / sr).astype(np.float32)
    mag_on = float(G.goertzel(x, sr, f, **CPU))
    mag_off = float(G.goertzel(x, sr, 1703.0, **CPU))
    assert mag_on > 10 * mag_off
    k = int(np.floor(f * n / sr))
    ref = abs(np.fft.fft(x.astype(np.float64))[k])
    assert mag_on == pytest.approx(ref, rel=1e-3)
    scan = float(G.goertzel_scan(x, sr, f, **CPU))
    assert scan == pytest.approx(mag_on, rel=1e-3)
    assert scan == pytest.approx(float(JG.goertzel_scan(x, sr, f)),
                                 rel=1e-3)
    assert mag_on == pytest.approx(float(JG.goertzel(x, sr, f)), rel=1e-3)


def test_goertzel_bins_batch():
    x = _sig((3, 128), 6)
    out = _np(G.goertzel_bins(x, [3, 17, 40], **CPU))
    ref = np.abs(np.fft.fft(x.astype(np.float64)))[:, [3, 17, 40]]
    assert snr_db(ref, out) > SNR
    assert snr_db(np.asarray(JG.goertzel_bins(x, [3, 17, 40])), out) > SNR


@pytest.mark.parametrize("shape,freq", [((4, 256), 1000.0), ((2, 3, 77),
                                                            440.0)])
def test_goertzel_scan_rows(shape, freq):
    """goertzel_scan over leading dims against the DFT bin (rel 1e-3) and
    the JAX scan; the wrapper's plain version on CPU tensors is the
    recurrence itself, so it equals a float32 numpy loop exactly."""
    sr = 8000.0
    x = _sig(shape, 7)
    got = _np(G.goertzel_scan(x, sr, freq, **CPU))
    assert got.shape == shape[:-1]
    n = shape[-1]
    k = int(np.floor(freq * n / sr))
    ref = np.abs(np.fft.fft(x.astype(np.float64))[..., k])
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    np.testing.assert_allclose(got, np.asarray(JG.goertzel_scan(x, sr,
                                                                freq)),
                               rtol=1e-3)
    coeff = np.float32(2.0 * np.cos(2.0 * np.pi * k / n))
    s1 = np.zeros(shape[:-1], np.float32)
    s2 = np.zeros(shape[:-1], np.float32)
    for i in range(n):
        s1, s2 = x[..., i] + coeff * s1 - s2, s1
    mag = np.sqrt(np.maximum(s2 * s2 + s1 * s1 - coeff * s1 * s2, 0))
    np.testing.assert_array_equal(got, mag.astype(np.float32))


def test_goertzel_scan_wrapper_counts_no_cpu_launch():
    before = dict(G.launches)
    G.scan_rows(torch.zeros(2, 8), 1.0)
    assert G.launches == before
    with pytest.raises(tk.InvalidValueError):
        G.scan_rows(torch.zeros(2, 8, dtype=torch.float64), 1.0)
    with pytest.raises(tk.InvalidValueError):
        G.goertzel(np.zeros(8, np.float32), 0.0, 1.0, **CPU)


def test_real_cepstrum():
    n = 256
    x = _sig((2, n), 8)
    got = _np(Ce.real_cepstrum(x, **CPU))
    f = np.fft.fft(x.astype(np.float64))
    ref = np.fft.ifft(np.log(np.abs(f) + 1e-12)).real
    assert snr_db(ref, got) > SNR
    assert snr_db(np.asarray(JCe.real_cepstrum(x)), got) > SNR


def test_mel_mfcc():
    n_mags, sr, n_mel = 257, 16000.0, 26
    mags = np.abs(_sig((2, n_mags), 9))
    np.testing.assert_array_equal(Ce.mel_filterbank_matrix(n_mags, sr,
                                                           n_mel),
                                  JCe.mel_filterbank_matrix(n_mags, sr,
                                                            n_mel))
    mel = _np(Ce.mel_filterbank(mags, sr, n_mel, **CPU))
    assert mel.shape == (2, n_mel) and np.all(mel >= 0)
    assert snr_db(np.asarray(JCe.mel_filterbank(mags, sr, n_mel)), mel) > SNR
    co = _np(Ce.mfcc(mags, sr, n_mel, 13, **CPU))
    assert co.shape == (2, 13)
    ref = ref_dct(np.log(mags.astype(np.float64)
                         @ Ce.mel_filterbank_matrix(n_mags, sr, n_mel)
                         + 1e-12), 2)[..., :13]
    assert snr_db(ref, co) > SNR
    assert snr_db(np.asarray(JCe.mfcc(mags, sr, n_mel, 13)), co) > SNR


def test_mfcc_too_many_coeffs_raises():
    with pytest.raises(tk.KofftError):
        Ce.mfcc(np.ones(64, np.float32), 8000.0, 10, 11, **CPU)


@pytest.mark.parametrize("mod", [D, S])
@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [384, 777, 1024])
def test_fast_path_matches_matrix(monkeypatch, mod, kind, n):
    """The FFT-composed route against the matrix route and float64 (smooth,
    rough -> Bluestein, and pow2 n), and at the rough n, whose Bluestein
    route is the longest, against the JAX package's fast route (each JAX
    case is one XLA compile; at all three sizes they took most of this
    file's time)."""
    jmod = JD if mod is D else JS
    x = _sig((3, n), n + kind)
    want = _np(mod.dct(x, kind, **CPU) if mod is D
               else mod.dst(x, kind, **CPU))
    monkeypatch.setattr(mod, "FAST_CUTOFF", 16)
    monkeypatch.setattr(jmod, "FAST_CUTOFF", 16)
    fn = (lambda v: mod.dct(v, kind, **CPU)) if mod is D else (
        lambda v: mod.dst(v, kind, **CPU))
    got = _np(fn(x))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-4 * max(scale, 1.0)
    ref = ref_dct(x, kind) if mod is D else ref_dst(x, kind)
    assert snr_db(ref, got) > SNR
    if n == 777:
        jgot = np.asarray(jmod.dct(x, kind) if mod is D
                          else jmod.dst(x, kind))
        assert snr_db(jgot, got) > SNR


def test_large_dct_runs_without_matrix():
    """Above the cutoff no n^2 table is built: a 2^15-point DCT-II."""
    n = 1 << 15
    ones = np.ones(n, np.float32)
    g0 = _np(D.dct(ones, type=2, **CPU))
    assert g0.shape == (n,)
    assert abs(g0[0] - n) < 1e-2 * n
    assert np.abs(g0[1:]).max() < 0.2
    assert not any(k[0] == "dct" and k[2] == n for k in
                   D.tables._store)


def test_public_alias_surface():
    x = _sig(32, 11)
    for fn, kind in ((tk.dct1, 1), (tk.dct2, 2), (tk.dct3, 3),
                     (tk.dct4, 4)):
        assert snr_db(ref_dct(x, kind), _np(fn(x, **CPU))) > SNR
    for fn, kind in ((tk.dst1, 1), (tk.dst2, 2), (tk.dst3, 3),
                     (tk.dst4, 4)):
        assert snr_db(ref_dst(x, kind), _np(fn(x, **CPU))) > SNR
    xb = _sig((2, 3, 16), 12)
    for name in ("dct_batch", "dct_multi_channel"):
        np.testing.assert_array_equal(_np(getattr(D, name)(xb, 3, **CPU)),
                                      _np(D.dct(xb, 3, **CPU)))
    for name in ("dst_batch", "dst_multi_channel"):
        np.testing.assert_array_equal(_np(getattr(S, name)(xb, **CPU)),
                                      _np(S.dst(xb, 1, **CPU)))
    with pytest.raises(tk.InvalidValueError):
        D.dct(x, 5, **CPU)
    with pytest.raises(tk.InvalidValueError):
        S.dst(x, 0, **CPU)
    with pytest.raises(tk.InvalidValueError):
        D.idct(np.ones(1, np.float32), 1, **CPU)


def test_f64_stays_f64():
    """float64 input computes in float64 (the JAX package without x64
    downcasts it): held against the oracles at 250 dB, as
    tests/test_f64.py holds its float64 paths."""
    x = np.random.default_rng(13).standard_normal((2, 256))
    for got, ref in ((D.dct(x, 2, **CPU), ref_dct(x, 2)),
                     (S.dst(x, 2, **CPU), ref_dst(x, 2))):
        assert got.dtype == torch.float64
        assert snr_db(ref, _np(got)) > 250.0
    back = D.idct(D.dct(x, 2, **CPU), 2, **CPU)
    assert snr_db(x, _np(back)) > 250.0
    z = H.hilbert_analytic(x[0], **CPU)
    assert z.dtype == torch.complex128
    assert snr_db(analytic_ref(x[0]), _np(z)) > 250.0
    yr, yi = C.czt_split(x, 64, np.exp(-2j * np.pi / 256), **CPU)
    assert yr.dtype == torch.float64


def test_kernel_path_at_2_14():
    """n = 2^14 with backend='cuda': Hilbert and DHT through the stage
    kernels' plain versions, DCT-II and DST-IV's fast paths (m = 2^15)
    through the real and complex pairs, against the JAX package on xla
    and the float64 oracles."""
    n = 1 << 14
    x = _sig((2, n), 14)
    z = _np(H.hilbert_analytic(x, backend="cuda", **CPU))
    assert snr_db(analytic_ref(x[0]), z[0]) > SNR
    assert snr_db(np.asarray(JH.hilbert_analytic(x, backend="xla")),
                  z) > SNR
    d = _np(Ha.dht(x, backend="cuda", **CPU))
    f = np.fft.fft(x.astype(np.float64))
    assert snr_db(f.real - f.imag, d) > SNR
    assert snr_db(np.asarray(JHa.dht(x, backend="xla")), d) > SNR
    old = tk.get_config().backend
    tk.set_backend("cuda")
    try:
        c2 = _np(D.dct2(x, **CPU))
        s4 = _np(S.dst4(x, **CPU))
    finally:
        tk.set_backend(old)
    assert snr_db(np.asarray(jk.dct2(x)), c2) > SNR
    assert snr_db(np.asarray(jk.dst4(x)), s4) > SNR
