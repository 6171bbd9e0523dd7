"""The port's sanity-check CLI and media index against kofft_tpu's, on the
CPU, following tests/test_cli.py.

The CLI runs with ``KOFFT_TPU_TORCH_PLATFORM=cpu`` (as a subprocess, and
in-process with the variable set). In place of the JAX package's golden
test (its example script against its CLI), the port's CLI PNG is held
against the JAX CLI's PNG of the same WAV (10 s at 16 kHz: a chirp, two
tones and seeded noise) and against a float64 numpy render: within one
colour level (1 in an 8-bit PNG, 257 in a 16-bit one, whose channels are
the 8-bit level times 257), with fewer than 2 pixels in 10^4 differing.
Each float32 engine alone departs from the float64 render in 0.2-1.4
pixels in 10^4 at these flags (a rounding moves a dB value across a
colour level), so two of them differ in up to about twice that: 0.4-1.6
in 10^4 between the two CLIs, where 1 in 10^4 was asked (ROADMAP C;
``tools/cli_parity.py``). A pure tone is no test of this: most of its
bins sit near float32's own noise floor inside the 120 dB range, where
either engine departs from float64 in 0.5-4.6 % of the pixels.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import chirp_wav, level_diff, spectrogram_f64  # noqa: E402
from kofft_tpu.cli.sanity_check import main as jax_main  # noqa: E402
from kofft_tpu_torch.cli import sanity_check as SC  # noqa: E402
from kofft_tpu_torch.media import SongId, SongIndex  # noqa: E402
from kofft_tpu_torch.utils.audio import read_audio, write_wav  # noqa: E402
from kofft_tpu_torch.utils.image import decode_png  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SUBENV = dict(os.environ, KOFFT_TPU_TORCH_PLATFORM="cpu")
# share of pixels whose channels may differ by one colour level from the
# JAX CLI's or from the float64 render (see above)
PIXEL_SHARE = 2e-4
CHIRP_SEED = 130


@pytest.fixture(scope="module")
def wav_440(tmp_path_factory):
    """A 440 Hz tone, 1 s at 8 kHz (tests/test_cli.py's fixture)."""
    p = tmp_path_factory.mktemp("audio") / "tone440.wav"
    sr = 8000
    t = np.arange(sr) / sr
    write_wav(p, 0.5 * np.sin(2 * np.pi * 440 * t), sr)
    return p


@pytest.fixture(scope="module")
def wav_chirp(tmp_path_factory):
    """10 s at 16 kHz, 16-bit: a 100 Hz -> 7 kHz chirp, two tones and
    seeded noise (``chip_smoke.chirp_wav``, as phase 9(d) writes it)."""
    p = tmp_path_factory.mktemp("audio") / "chirp.wav"
    chirp_wav(p, CHIRP_SEED)
    return p


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "kofft_tpu_torch.cli.sanity_check",
         *map(str, args)], cwd=REPO, env=SUBENV, capture_output=True,
        text=True, timeout=300)


def test_cli_renders_png(tmp_path, wav_440):
    out = tmp_path / "spec.png"
    r = _cli(wav_440, out, "--win-len", "256")
    assert r.returncode == 0, r.stderr
    img = decode_png(out.read_bytes())
    assert img.shape == (128, int(np.ceil(8000 / 128)), 3)
    # the 440 Hz band must light up: row = height-1 - round(440*256/8000)
    band = img.shape[0] - 1 - round(440 * 256 / 8000)
    assert img[band].astype(int).sum() > 1.5 * img[10].astype(int).sum()


def test_cli_log_scale_and_depth(tmp_path, wav_440):
    out = tmp_path / "log16.png"
    r = _cli(wav_440, out, "--win-len", "128", "--scale-mode", "log",
             "--png-depth", "sixteen", "--colormap", "viridis")
    assert r.returncode == 0, r.stderr
    assert decode_png(out.read_bytes()).dtype == np.uint16


def test_cli_missing_file_errors(tmp_path):
    r = _cli(tmp_path / "missing.wav", tmp_path / "o.png")
    assert r.returncode == 1
    assert "error" in r.stderr.lower()


def test_sanity_check_main_inprocess(tmp_path, wav_440, monkeypatch):
    """The CLI entry in-process, through every flag branch."""
    monkeypatch.setenv("KOFFT_TPU_TORCH_PLATFORM", "cpu")
    out8 = tmp_path / "t8.png"
    rc = SC.main([str(wav_440), str(out8), "--win-len", "128",
                  "--colormap", "fire", "--scale-mode", "log",
                  "--dynamic-range", "90"])
    assert rc == 0 and out8.exists() and out8.stat().st_size > 0
    out16 = tmp_path / "t16.png"
    rc = SC.main([str(wav_440), str(out16),
                  "--win-len", "128", "--png-depth", "sixteen"])
    assert rc == 0 and out16.exists()
    svg = tmp_path / "t.svg"
    rc = SC.main([str(wav_440), str(svg), "--win-len", "128"])
    assert rc == 0 and b"<svg" in svg.read_bytes()
    # error path: unreadable input
    rc = SC.main([str(tmp_path / "missing.wav"), str(tmp_path / "x.png")])
    assert rc == 1


def test_parser_matches_jax_cli():
    """The same flags, choices and defaults as the JAX CLI's parser."""
    from kofft_tpu.cli.sanity_check import build_parser as jax_parser

    def spec(p):
        return [(a.dest, a.default, a.choices, a.type)
                for a in p._actions if a.dest != "help"]
    assert spec(SC.build_parser()) == spec(jax_parser())


def test_platform_variable(tmp_path, wav_440, monkeypatch):
    """Unset means the card, which raises without one; ``cuda`` and ``cpu``
    name a device; anything else raises."""
    monkeypatch.delenv("KOFFT_TPU_TORCH_PLATFORM", raising=False)
    assert SC.platform_device() == "cuda"
    monkeypatch.setenv("KOFFT_TPU_TORCH_PLATFORM", "CPU")
    assert SC.platform_device() == "cpu"
    monkeypatch.setenv("KOFFT_TPU_TORCH_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="KOFFT_TPU_TORCH_PLATFORM"):
        SC.main([str(wav_440), str(tmp_path / "x.png")])
    if not torch.cuda.is_available():
        monkeypatch.setenv("KOFFT_TPU_TORCH_PLATFORM", "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SC.main([str(wav_440), str(tmp_path / "x.png")])


def _close(got, want):
    """Within one colour level, fewer than PIXEL_SHARE of the pixels
    differing."""
    big, share = level_diff(got, want)
    return big <= 1 and share < PIXEL_SHARE


@pytest.mark.parametrize("flags,args", [
    ([], (1024, "inferno", "linear")),
    (["--scale-mode", "log", "--png-depth", "sixteen", "--colormap",
      "viridis"], (1024, "viridis", "log")),
    (["--win-len", "256", "--colormap", "fire"], (256, "fire", "linear"))])
def test_cli_png_matches_jax_cli(tmp_path, wav_chirp, monkeypatch, flags,
                                 args):
    """The port's CLI PNG against the JAX CLI's on the same WAV and
    against the float64 render: within one colour level, fewer than
    2 pixels in 10^4 differing."""
    monkeypatch.setenv("KOFFT_TPU_TORCH_PLATFORM", "cpu")
    want_p, got_p = tmp_path / "jax.png", tmp_path / "port.png"
    assert jax_main([str(wav_chirp), str(want_p), *flags]) == 0
    assert SC.main([str(wav_chirp), str(got_p), *flags]) == 0
    want = decode_png(want_p.read_bytes())
    got = decode_png(got_p.read_bytes())
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _close(got, want)
    assert _close(got, spectrogram_f64(read_audio(wav_chirp)[0], *args,
                                       120.0))


# ------------------------------------------------------------- media index
def test_media_index_metadata_skips_hash(tmp_path):
    """identify() by name works after the file is deleted."""
    idx = SongIndex()
    p = tmp_path / "song.bin"
    p.write_bytes(b"song data")
    sid = idx.index_song(p)
    p.unlink()
    assert idx.identify(p) == sid


def test_media_index_same_content_same_id(tmp_path):
    idx = SongIndex()
    p1 = tmp_path / "a.bin"
    p2 = tmp_path / "b.bin"
    p1.write_bytes(b"data")
    p2.write_bytes(b"data")
    id1 = idx.index_song(p1)
    assert idx.identify(p2) == id1


def test_media_index_auto_insert(tmp_path):
    idx = SongIndex()
    p = tmp_path / "u.bin"
    p.write_bytes(b"unique")
    id1 = idx.identify(p)
    p.unlink()
    assert idx.identify(p) == id1


def test_media_index_matches_jax(tmp_path):
    """The same ids from the same calls as the JAX package's index, with
    its default hasher (blake2b, 32 bytes) and with a given one."""
    from kofft_tpu.media import SongIndex as JIndex
    from kofft_tpu.media.index import _blake2b_file as jhash
    from kofft_tpu_torch.media.index import _blake2b_file
    files = []
    for i, data in enumerate([b"a", b"b", b"a", b"c" * 20000]):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(data)
        files.append(p)
        assert _blake2b_file(p) == jhash(p)
    for hasher in (None, lambda p: p.read_bytes()[:1]):
        ours, theirs = SongIndex(hasher), JIndex(hasher)
        assert ours.index_song(files[0]).path == theirs.index_song(
            files[0]).path
        for p in files + [files[1]]:
            got, want = ours.identify(p), theirs.identify(p)
            assert isinstance(got, SongId) and got.path == want.path
