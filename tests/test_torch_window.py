"""The port's window tables against kofft_tpu's, and the reference cases
of tests/test_window.py on the port.

Both packages build each table on the host in float64 from the same
formula and cast it once, so the tables are held bit-equal (float32 and
float64). The reference cases keep test_window.py's tolerances.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from kofft_tpu.ops import window as JW  # noqa: E402
from kofft_tpu_torch.ops import window as TW  # noqa: E402
from kofft_tpu_torch.plan import tables  # noqa: E402

PLAIN = ["hann", "hamming", "blackman", "bartlett", "bohman", "nuttall"]
PARAM = [("kaiser", 8.6), ("kaiser", 0.0), ("tukey", 0.5), ("tukey", 0.0),
         ("tukey", 1.0), ("tukey", 1.7)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 65, 1024])
@pytest.mark.parametrize("name", PLAIN)
def test_plain_windows_bit_equal(name, n, dtype):
    got = getattr(TW, name)(n, dtype=dtype)
    want = getattr(JW, name)(n, dtype=dtype)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 16, 33, 1024])
@pytest.mark.parametrize("name,param", PARAM)
def test_param_windows_bit_equal(name, param, n):
    np.testing.assert_array_equal(getattr(TW, name)(n, param),
                                  getattr(JW, name)(n, param))
    np.testing.assert_array_equal(TW.get_window((name, param), n),
                                  JW.get_window((name, param), n))


def test_hann_periodic():
    w = TW.hann(8)
    assert w.shape == (8,)
    assert abs(w[0]) < 1e-6
    assert abs(w[4] - 1.0) < 1e-6


def test_hamming_range():
    w = TW.hamming(64)
    assert np.all(w >= 0.0) and np.all(w <= 1.0)
    assert abs(w[0] - 0.08) < 1e-6


def test_blackman_matches_formula():
    n = 32
    i = np.arange(n) / n
    ref = 0.42 - 0.5 * np.cos(2 * np.pi * i) + 0.08 * np.cos(4 * np.pi * i)
    np.testing.assert_allclose(TW.blackman(n), ref, atol=1e-6)


def test_kaiser_matches_numpy():
    np.testing.assert_allclose(TW.kaiser(33, beta=8.6), np.kaiser(33, 8.6),
                               rtol=1e-5, atol=1e-6)


def test_bartlett_matches_numpy():
    np.testing.assert_allclose(TW.bartlett(17), np.bartlett(17),
                               rtol=1e-6, atol=1e-6)


def test_tukey_limits():
    np.testing.assert_allclose(TW.tukey(16, 0.0), np.ones(16))
    w = TW.tukey(65, 1.0)
    assert abs(w[0]) < 1e-6 and abs(w[32] - 1.0) < 1e-6


def test_bohman_standard():
    """The standard Bohman formula (a contract item: the reference
    library's text omits an abs and goes negative)."""
    w = TW.bohman(65)
    assert abs(w[0]) < 1e-6 and abs(w[64]) < 1e-6
    assert abs(w[32] - 1.0) < 1e-6
    assert np.all(w >= -1e-7)


def test_nuttall_endpoints():
    w = TW.nuttall(65)
    assert w[0] == pytest.approx(0.0, abs=1e-6)
    assert w[32] == pytest.approx(1.0, abs=1e-5)


def test_get_window_dispatch():
    import kofft_tpu_torch as kt
    np.testing.assert_array_equal(TW.get_window("hann", 16), TW.hann(16))
    np.testing.assert_array_equal(TW.get_window(("kaiser", 5.0), 16),
                                  TW.kaiser(16, 5.0))
    np.testing.assert_array_equal(TW.get_window("Tukey", 16, 0.25),
                                  TW.tukey(16, 0.25))
    with pytest.raises(kt.InvalidValueError):
        TW.get_window("nope", 16)
    with pytest.raises(kt.InvalidValueError):
        TW.get_window("kaiser", 16)
    with pytest.raises(kt.InvalidValueError):
        TW.hann(0)


def test_window_cache_identity_and_clear():
    """The warm call returns the same table; tables.clear() drops it."""
    a = TW.hann(128)
    assert TW.hann(128) is a
    tables.clear()
    b = TW.hann(128)
    assert b is not a
    np.testing.assert_array_equal(a, b)


def test_window_is_the_package_submodule():
    import kofft_tpu_torch as kt
    import kofft_tpu_torch.ops as ops
    assert kt.window is TW and ops.window is TW
