"""The port's wavelets against kofft_tpu and the float64 reference-
semantics oracles (tests/scipy_free_ref.py) on the CPU, following the
cases of tests/test_wavelet.py.

The same seeded numpy inputs go through both packages; the port's
entries get ``device="cpu"``. Tolerances: >= 100 dB against the JAX
package and against the float64 oracles (float32 outputs); perfect
reconstruction of dwt/idwt >= 100 dB and at test_wavelet.py's rtol
1e-4 / atol 1e-5; the Haar halves at its rtol 1e-6. ``wavelet_forward``
/ ``wavelet_inverse`` are not perfect reconstruction for db4, sym4 and
coif1 (a contract item): they are held to the JAX package and the
oracle, not to the input.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu.ops import wavelet as JW  # noqa: E402
from kofft_tpu_torch.ops import wavelet as W  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402
from scipy_free_ref import (wavelet_forward_ref,  # noqa: E402
                            wavelet_inverse_ref)

SNR = 100.0
CPU = {"device": "cpu"}
FAMS = ["db2", "db4", "sym4", "coif1"]


def _sig(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().numpy()


def test_families_equal_the_jax_package():
    assert W.FAMILIES == JW.FAMILIES


@pytest.mark.parametrize("shape", [(64,), (3, 32), (2, 3, 10), (9,)])
def test_haar_roundtrip(shape):
    x = _sig(shape, shape[-1])
    a, d = W.haar_forward(x, **CPU)
    h = shape[-1] // 2
    np.testing.assert_allclose(_np(a), (x[..., 0:2 * h:2]
                                        + x[..., 1:2 * h:2]) / 2, rtol=1e-6)
    np.testing.assert_allclose(_np(d), (x[..., 0:2 * h:2]
                                        - x[..., 1:2 * h:2]) / 2, rtol=1e-6)
    ja, jd = JW.haar_forward(x)
    np.testing.assert_array_equal(_np(a), ja)
    np.testing.assert_array_equal(_np(d), jd)
    back = _np(W.haar_inverse(a, d, **CPU))
    np.testing.assert_allclose(back, x[..., :2 * h], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [64, 65, 8])
@pytest.mark.parametrize("family", FAMS)
def test_analysis_matches_reference(family, n):
    """n >= 2*taps takes the stride-2 conv1d, n = 8 the gather for the
    longer filters (several reflections per window)."""
    x = _sig((2, n), n)
    h, g, _, _ = W.FAMILIES[family]
    a, d = W.wavelet_forward(x, family, **CPU)
    ja, jd = JW.wavelet_forward(x, family)
    for b in range(2):
        ra, rd = wavelet_forward_ref(x[b], h, g)
        assert snr_db(ra, _np(a)[b]) > SNR, family
        assert snr_db(rd, _np(d)[b]) > SNR, family
    assert snr_db(np.asarray(ja), _np(a)) > SNR
    assert snr_db(np.asarray(jd), _np(d)) > SNR


@pytest.mark.parametrize("n_half", [32, 4, 2])
@pytest.mark.parametrize("family", FAMS)
def test_synthesis_matches_reference(family, n_half):
    """2*n_half >= 2*taps takes conv_transpose1d with the folded tail,
    shorter ones the index-add scatter."""
    a = _sig((2, n_half), n_half)
    d = _sig((2, n_half), n_half + 1)
    _, _, gs, hs = W.FAMILIES[family]
    got = _np(W.wavelet_inverse(a, d, family, **CPU))
    for b in range(2):
        ref = wavelet_inverse_ref(a[b], d[b], gs, hs)
        assert snr_db(ref, got[b]) > SNR, family
    assert snr_db(np.asarray(JW.wavelet_inverse(a, d, family)), got) > SNR


def test_multi_level_haar_roundtrip():
    x = _sig(64, 1)
    approx, details = W.multi_level_forward(x, 3, "haar", **CPU)
    assert approx.shape[-1] == 8 and len(details) == 3
    back = _np(W.multi_level_inverse(approx, details, "haar", **CPU))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["haar", "db2"])
def test_multi_level_odd_length(family):
    """Odd-length levels repeat the last sample; the inverse drops the
    padded tail, as the JAX package does."""
    x = _sig(10, 2)
    approx, details = W.multi_level_forward(x, 2, family, **CPU)
    ja, jds = JW.multi_level_forward(x, 2, family)
    assert approx.shape[-1] == 3
    assert snr_db(np.asarray(ja), _np(approx)) > SNR
    back = _np(W.multi_level_inverse(approx, details, family, **CPU))
    jback = np.asarray(JW.multi_level_inverse(ja, jds, family))
    assert back.shape == jback.shape
    assert snr_db(jback, back) > SNR
    if family == "haar":
        np.testing.assert_allclose(back[:10], x, rtol=1e-4, atol=1e-5)


def test_unknown_family_raises():
    with pytest.raises(tk.KofftError):
        W.wavelet_forward(np.zeros(8, np.float32), "db17", **CPU)
    with pytest.raises(tk.KofftError):
        W.dwt(np.zeros(8, np.float32), "db17", **CPU)
    with pytest.raises(tk.InvalidValueError):
        W.dwt(np.zeros(7, np.float32), "db2", **CPU)


@pytest.mark.parametrize("family", ["haar", "db2", "db4", "sym4", "coif1"])
def test_dwt_perfect_reconstruction(family):
    x = _sig((3, 64), 3)
    a, d = W.dwt(x, family, **CPU)
    ja, jd = JW.dwt(x, family)
    assert snr_db(np.asarray(ja), _np(a)) > SNR
    assert snr_db(np.asarray(jd), _np(d)) > SNR
    back = _np(W.idwt(a, d, family, **CPU))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-5)
    assert snr_db(x, back) > SNR


@pytest.mark.parametrize("family", ["haar", "db4"])
def test_dwt_multi_roundtrip(family):
    x = _sig(128, 4)
    a, ds = W.dwt_multi(x, 3, family, **CPU)
    assert a.shape[-1] == 16
    ja, _ = JW.dwt_multi(x, 3, family)
    assert snr_db(np.asarray(ja), _np(a)) > SNR
    back = _np(W.idwt_multi(a, ds, family, **CPU))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-5)


def test_dwt_energy_preserved():
    x = _sig(256, 5)
    a, d = W.dwt(x, "db4", **CPU)
    e = float((a.double() ** 2).sum() + (d.double() ** 2).sum())
    assert e == pytest.approx(float(np.sum(x.astype(np.float64) ** 2)),
                              rel=1e-4)


def test_wavelet_pair_is_not_perfect_reconstruction():
    """The reference library's synthesis banks for db4/sym4/coif1 do not
    invert its analysis (a contract item); db2's do, in the interior."""
    x = _sig(64, 6)
    for family in ("db4", "sym4", "coif1"):
        back = _np(W.wavelet_inverse(*W.wavelet_forward(x, family, **CPU),
                                     family, **CPU))
        jback = np.asarray(JW.wavelet_inverse(*JW.wavelet_forward(x,
                                                                  family),
                                              family))
        assert snr_db(x, back) < 20.0
        assert snr_db(jback, back) > SNR


def test_f64_stays_f64():
    """float64 input computes in float64 with float64 taps."""
    x = np.random.default_rng(7).standard_normal((2, 64))
    a, d = W.dwt(x, "db4", **CPU)
    assert a.dtype == torch.float64
    assert snr_db(x, _np(W.idwt(a, d, "db4", **CPU))) > 250.0
    fa, fd = W.wavelet_forward(x, "db2", **CPU)
    ra, rd = wavelet_forward_ref(x[0], *W.FAMILIES["db2"][:2])
    assert fa.dtype == torch.float64 and snr_db(ra, _np(fa)[0]) > 250.0
