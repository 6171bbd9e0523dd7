"""The port's spectrogram utilities (``kofft_tpu_torch.visual``) against
kofft_tpu.visual on the CPU, following tests/test_spectrogram.py.

Everything but ``stft_magnitudes`` is host numpy arithmetic copied from
the JAX package, so it is held bit-equal: the dB helpers, the seven
palettes (u8 and u16), colorizing, the log-frequency rebinning and the
whole-image renders. The viridis/plasma/inferno tables, which the port
keeps as data, equal the JAX package's ``_mpl_lut`` (sampled from
matplotlib). ``stft_magnitudes`` runs the port's STFT (``device="cpu"``)
and is held at >= 100 dB against the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kofft_tpu.visual as JV  # noqa: E402
from kofft_tpu.visual import spectrogram as JS  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
import kofft_tpu_torch.visual as TV  # noqa: E402
from kofft_tpu_torch.errors import InvalidValueError  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402
from kofft_tpu_torch.visual import spectrogram as TS  # noqa: E402

SNR = 100.0
NAMES = ["Colormap", "stft_magnitudes", "magnitude_to_db", "db_scale",
         "map_color_u8", "map_color_u16", "color_from_magnitude_u8",
         "color_from_magnitude_u16", "map_bin_to_pixel", "log_scale_bins",
         "render_rgb8", "render_rgb16"]
CMAPS = [c.value for c in JV.Colormap]


def _mags(seed, shape=(12, 40)):
    """Magnitudes spanning > 100 dB, with exact zeros."""
    rng = np.random.default_rng(seed)
    m = (np.abs(rng.standard_normal(shape))
         * 10.0 ** rng.uniform(-6, 0, shape)).astype(np.float32)
    m[0, :3] = 0.0
    return m


@pytest.fixture(scope="module")
def jax_mags():
    """The JAX package's stft_magnitudes at three (N, win, hop)."""
    out = {}
    for n, win, hop in ((8000, 512, 128), (1000, 64, 16), (333, 2, 1)):
        x = np.sin(2 * np.pi * 440 * np.arange(n) / 8000).astype(
            np.float32) + np.random.default_rng(n).standard_normal(
                n).astype(np.float32)
        out[(n, win, hop)] = (x, JS.stft_magnitudes(x, win, hop))
    return out


def test_public_names():
    assert set(NAMES) <= set(vars(TV))
    assert tk.visual is TV
    assert [c.value for c in TV.Colormap] == CMAPS


@pytest.mark.parametrize("name", ["viridis", "plasma", "inferno"])
def test_tables_equal_matplotlib(name):
    want = JS._mpl_lut(name)
    got = TS._mpl_lut(name)
    assert got.dtype == want.dtype == np.float32 and got.shape == (256, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cmap", CMAPS)
def test_colormaps_bit_equal(cmap):
    """map_color_u8/u16 over [0, 1], out of range and at scalars."""
    t = np.concatenate([np.linspace(-0.2, 1.2, 1001),
                        np.random.default_rng(3).random(500)]).astype(
                            np.float32)
    jc, tc = JV.Colormap(cmap), TV.Colormap(cmap)
    for fn in ("map_color_u8", "map_color_u16"):
        want = getattr(JV, fn)(t, jc)
        got = getattr(TV, fn)(t, tc)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for s in (0.0, 0.25, 0.5, 1.0):
            np.testing.assert_array_equal(getattr(TV, fn)(s, tc),
                                          getattr(JV, fn)(s, jc))
    assert TV.Colormap.parse(cmap.upper()) is tc
    assert TV.Colormap.parse("bogus") is TV.Colormap.FIRE


@pytest.mark.parametrize("cmap", CMAPS)
def test_color_from_magnitude_bit_equal(cmap):
    """Scalar and per-row maxima (the streaming path's)."""
    m = _mags(7)
    row_max = np.maximum.accumulate(m.max(axis=1))[:, None]
    jc, tc = JV.Colormap(cmap), TV.Colormap(cmap)
    for mx in (float(m.max()), row_max):
        for fn in ("color_from_magnitude_u8", "color_from_magnitude_u16"):
            np.testing.assert_array_equal(
                getattr(TV, fn)(m, mx, -80.0, tc),
                getattr(JV, fn)(m, mx, -80.0, jc))


def test_db_helpers_bit_equal():
    m = _mags(8)
    for floor in (-120.0, -80.0):
        for mx in (1.0, float(m.max()), 0.0):
            np.testing.assert_array_equal(
                TV.magnitude_to_db(m, mx, floor),
                JV.magnitude_to_db(m, mx, floor))
    for dr in (60.0, 100.0):
        np.testing.assert_array_equal(TV.db_scale(m, float(m.max()), dr),
                                      JV.db_scale(m, float(m.max()), dr))
    assert TV.magnitude_to_db(0.0, 1.0, -120.0) == -120.0


def test_log_bins_bit_equal():
    for max_bin in (0, 1, 7, 15, 255):
        for b in range(0, max_bin + 1, max(1, max_bin // 16)):
            assert TV.map_bin_to_pixel(b, max_bin) == \
                JV.map_bin_to_pixel(b, max_bin)
    m = _mags(9, (6, 257))
    for max_bin in (256, 511):
        np.testing.assert_array_equal(TV.log_scale_bins(m, max_bin),
                                      JV.log_scale_bins(m, max_bin))
        np.testing.assert_array_equal(TV.log_scale_bins(m[2], max_bin),
                                      JV.log_scale_bins(m[2], max_bin))


@pytest.mark.parametrize("cmap", CMAPS)
@pytest.mark.parametrize("log_scale", [False, True])
def test_render_bit_equal(cmap, log_scale):
    m = _mags(10, (10, 33))
    jc, tc = JV.Colormap(cmap), TV.Colormap(cmap)
    for fn in ("render_rgb8", "render_rgb16"):
        want = getattr(JV, fn)(m, float(m.max()), -80.0, jc, log_scale)
        got = getattr(TV, fn)(m, float(m.max()), -80.0, tc, log_scale)
        assert got.dtype == want.dtype and got.shape == (33, 10, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [(8000, 512, 128), (1000, 64, 16),
                                  (333, 2, 1)])
def test_stft_magnitudes(jax_mags, case):
    x, (want, want_max) = jax_mags[case]
    n, win, hop = case
    got, got_max = TV.stft_magnitudes(x, win, hop, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (-(-n // hop), win // 2)
    assert snr_db(want, got) > SNR
    assert got_max == pytest.approx(want_max, rel=1e-5)
    if case == (8000, 512, 128):
        got, _ = TV.stft_magnitudes(x, win, hop, backend="torch",
                                    device="cpu")
        assert snr_db(want, got) > SNR


def test_stft_magnitudes_errors():
    with pytest.raises(InvalidValueError):
        TV.stft_magnitudes(np.ones(8, np.float32), 1, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TV.stft_magnitudes(np.ones(64, np.float32), 16, 8)
