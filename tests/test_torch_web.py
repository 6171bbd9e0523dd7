"""The port's streaming spectrogram service (``kofft_tpu_torch.web``)
against kofft_tpu.web on the CPU, following tests/test_web.py.

The port's server runs with ``device="cpu"`` beside the JAX package's
server, and the same requests go to both. The contracts of
tests/test_web.py hold for the port: health and CORS, static files with
the SPA fallback, ``compute_frame``, ``stft``, ``set_colormap``/``reset``,
the error paths, OPTIONS and the route table.

Tolerances. The colour pipeline is held bit-equal: the port's
``StreamingSpectrogram`` fed the JAX stream's spectra paints the JAX
rows exactly. End to end the two packages' FFTs round float32 apart
(~135 dB), which can move a value sitting on a u8 boundary, so there
the rows agree within 1 LSB and differ in at most 1 byte in 1000 (the
same allowance tests/test_web.py gives the JAX package's own batched and
per-frame launches); ``/api/stft`` magnitudes >= 100 dB.
"""

import json
import re
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kofft_tpu.web import StreamingSpectrogram as JState  # noqa: E402
from kofft_tpu.web import server as JSrv  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402
from kofft_tpu_torch.visual import spectrogram as TV  # noqa: E402
from kofft_tpu_torch.web import StreamingSpectrogram as TState  # noqa: E402
from kofft_tpu_torch.web import server as TSrv  # noqa: E402
from kofft_tpu_torch.web import state as TS  # noqa: E402

CPU = {"device": "cpu"}
STATIC = Path(TS.__file__).parent / "static"
JSTATIC = Path(JSrv.__file__).parent / "static"


def _servers():
    (psrv, pport), (jsrv, jport) = (TSrv.serve_background(0, **CPU),
                                    JSrv.serve_background(0))
    return psrv, f"http://127.0.0.1:{pport}", jsrv, \
        f"http://127.0.0.1:{jport}"


@pytest.fixture(scope="module")
def both():
    psrv, port, jsrv, jax = _servers()
    yield port, jax
    for srv in (psrv, jsrv):
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def server(both):
    return both[0]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post_raw(url, data, method="POST"):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method=method)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    return ei.value.code, ei.value.read()


def _pushes(seed, n=20000, cuts=12):
    """A rising-level signal cut at random points (irregular pushes)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.linspace(0.01, 3, n)).astype(
        np.float32)
    return np.split(x, np.sort(rng.integers(0, n, cuts)))


def _close_rows(got, want):
    """Within 1 LSB, and at most 1 byte in 1000 apart."""
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1
    assert np.count_nonzero(d) <= max(1, got.size // 1000)


# -- the streaming state --------------------------------------------------

def test_streaming_state_contract():
    """Short pushes return empty; after win_len samples a full RGBA row;
    hop-sized drain (reference lib.rs:211-234, :353)."""
    st = TState(**CPU)
    assert st.compute_frame(np.zeros(512, np.float32)).size == 0
    row = st.compute_frame(np.random.randn(512).astype(np.float32))
    assert row.shape == (512 * 4,) and row.dtype == np.uint8
    assert np.all(row[3::4] == 255)
    row2 = st.compute_frame(np.random.randn(512).astype(np.float32))
    assert row2.shape == (512 * 4,)


def test_streaming_running_max_monotone():
    st = TState(**CPU)
    st.compute_frame(0.01 * np.random.randn(1024).astype(np.float32))
    m1 = st._max_mag
    st.compute_frame(10.0 * np.random.randn(512).astype(np.float32))
    assert st._max_mag >= m1


def test_streaming_state_chunked_multi_row():
    """A push completing k frames returns k rows from one transform,
    painting what per-hop pushes paint (the running max is sequential)."""
    x = np.random.default_rng(4).standard_normal(2048).astype(np.float32)
    rows = TState(**CPU).compute_frame(x)
    assert rows.shape == (3 * 512 * 4,)
    st2 = TState(**CPU)
    seq = [st2.compute_frame(x[i: i + 512]) for i in range(0, x.size, 512)]
    _close_rows(np.concatenate(seq), rows)


class _Feed:
    """A push stream that returns the JAX stream's spectra as tensors."""

    def __init__(self, jstream):
        self._j = jstream

    def push(self, s):
        return tuple(torch.as_tensor(np.array(p))
                     for p in self._j.push(s))


@pytest.mark.parametrize("cmap", ["rainbow", "viridis", "fire", "gray"])
@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_rows_against_jax(cmap, seed):
    """The same irregular pushes through both packages' state: bit-equal
    RGBA rows from the same spectra, and end to end within 1 LSB."""
    chunks = _pushes(seed)
    j, t, fed = (JState(colormap=cmap), TState(colormap=cmap, **CPU),
                 TState(colormap=cmap, **CPU))
    ref = JState(colormap=cmap)
    fed._stream = _Feed(ref._stream)
    want = [j.compute_frame(c) for c in chunks]
    got = [t.compute_frame(c) for c in chunks]
    same = [fed.compute_frame(c) for c in chunks]
    assert [g.size for g in got] == [w.size for w in want]
    np.testing.assert_array_equal(np.concatenate(same),
                                  np.concatenate(want))
    _close_rows(np.concatenate(got), np.concatenate(want))
    assert t._max_mag == pytest.approx(j._max_mag, rel=1e-5)


def test_streaming_state_concurrent_pushes():
    """Handler threads share one state: 16 threads each pushing 8 hops
    lose no sample and drain no hop twice (the lock)."""
    st = TState(**CPU)
    rows = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda: [
            rows.append(st.compute_frame(np.ones(512, np.float32)).size)
            for _ in range(8)]) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    frames = (16 * 8 * 512 - 1024) // 512 + 1
    assert sum(rows) == frames * 512 * 4 and len(rows) == 128


def test_set_colormap_and_reset_state():
    st = TState(colormap="viridis", **CPU)
    assert st._cmap is TV.Colormap.VIRIDIS
    st.set_colormap("nope")
    assert st._cmap is TV.Colormap.FIRE
    st.compute_frame(np.ones(2048, np.float32))
    st.reset()
    assert st._cmap is TV.Colormap.RAINBOW and st._max_mag == 1e-12
    assert st._stream.buffered == 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TState()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSrv.make_server(0)


# -- the server -------------------------------------------------------------

def test_health(server):
    status, headers, _ = _get(server + "/health")
    assert status == 200
    assert headers.get("Access-Control-Allow-Origin") == "*"


def test_static_index_and_spa_fallback(both):
    server, jax = both
    status, _, body = _get(server + "/")
    assert status == 200 and b"spectrogram" in body
    status, _, body2 = _get(server + "/some/client/route")
    assert status == 200 and body2 == body
    assert _get(jax + "/")[2] == body
    status, _, body3 = _get(server + "/../../etc/passwd")
    assert status == 200 and body3 == body


def test_static_files_as_the_jax_package():
    """The port's copy of web/static: the same five files, equal but for
    local.mjs's comments, which name the port."""
    names = sorted(p.name for p in STATIC.iterdir())
    assert names == sorted(p.name for p in JSTATIC.iterdir())
    assert len(names) == 5
    for name in names:
        a, b = (STATIC / name).read_text(), (JSTATIC / name).read_text()
        if name == "local.mjs":
            def code(s):
                return [ln for ln in s.splitlines()
                        if not ln.lstrip().startswith("//")]
            a, b = code(a), code(b)
        assert a == b, name


def test_api_compute_frame_against_jax(both):
    """The same pushes to both servers (fresh state after reset): the
    same row counts, rows within 1 LSB."""
    server, jax = both
    for url in both:
        assert _post(url + "/api/reset", {})[1]["ok"]
    status, out = _post(server + "/api/compute_frame",
                        {"samples": [0.0] * 512})
    assert status == 200 and out["row"] == [] and out["rows"] == 0
    _post(jax + "/api/compute_frame", {"samples": [0.0] * 512})
    for chunk in _pushes(3, n=6000, cuts=4):
        _, p = _post(server + "/api/compute_frame",
                     {"samples": chunk.tolist()})
        _, j = _post(jax + "/api/compute_frame",
                     {"samples": chunk.tolist()})
        assert p["rows"] == j["rows"] == len(p["row"]) // (512 * 4)
        _close_rows(np.asarray(p["row"], np.uint8),
                    np.asarray(j["row"], np.uint8))


def test_api_stft_against_jax(both):
    server, jax = both
    sig = list(np.sin(np.arange(256) * 0.3))
    status, out = _post(server + "/api/stft",
                        {"samples": sig, "win_len": 64, "hop": 16})
    assert status == 200
    assert len(out["mags"]) == 16 and len(out["mags"][0]) == 32
    assert out["max_mag"] > 0
    _, want = _post(jax + "/api/stft",
                    {"samples": sig, "win_len": 64, "hop": 16})
    assert snr_db(np.asarray(want["mags"]), np.asarray(out["mags"])) > 100.0
    assert out["max_mag"] == pytest.approx(want["max_mag"], rel=1e-5)
    # defaults: win 1024, hop win // 2
    x = np.random.default_rng(5).standard_normal(4096).tolist()
    _, a = _post(server + "/api/stft", {"samples": x})
    _, b = _post(jax + "/api/stft", {"samples": x})
    assert len(a["mags"]) == 8 and len(a["mags"][0]) == 512
    assert snr_db(np.asarray(b["mags"]), np.asarray(a["mags"])) > 100.0


def test_api_set_colormap_reset(server):
    assert _post(server + "/api/set_colormap", {"name": "viridis"})[1]["ok"]
    assert _post(server + "/api/reset", {})[1]["ok"]
    assert _post(server + "/api/set_colormap", {"name": "nope"})[1]["ok"]


def test_api_error_paths(both):
    """400 for invalid json, a non-object body, ragged samples and a bad
    hop; 404 for an unknown endpoint; the same codes as the JAX server."""
    for url in both:
        code, body = _post_raw(url + "/api/compute_frame", b"{not json")
        assert code == 400 and "error" in json.loads(body)
        assert _post_raw(url + "/api/compute_frame", b"[1,2,3]")[0] == 400
        assert _post_raw(url + "/api/set_colormap", b"{not json")[0] == 400
        code, body = _post_raw(
            url + "/api/compute_frame",
            json.dumps({"samples": [[1.0], [1, 2]]}).encode())
        assert code == 400 and "error" in json.loads(body)
        code, body = _post_raw(
            url + "/api/stft", json.dumps({"samples": [0.0] * 256,
                                           "win_len": 64,
                                           "hop": 0}).encode())
        assert code == 400 and "error" in json.loads(body)
        assert _post_raw(url + "/api/nonexistent", b"{}")[0] == 404


def test_options_preflight(server):
    req = urllib.request.Request(server + "/api/stft", method="OPTIONS")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 204
        assert r.headers.get("Access-Control-Allow-Origin") == "*"


def test_app_routes_table():
    assert TSrv.app_routes() == JSrv.app_routes()


def test_service_worker_served(server):
    status, headers, body = _get(server + "/sw.js")
    assert status == 200
    assert headers.get("Content-Type") == "text/javascript"
    assert b"addEventListener(\"install\"" in body
    assert b"addEventListener(\"fetch\"" in body


def test_service_worker_shell_entries_resolvable(server):
    """Every precache entry of sw.js is served as itself, not as the SPA
    fallback."""
    _, _, index_body = _get(server + "/index.html")
    _, _, body = _get(server + "/sw.js")
    entries = re.findall(r'"\./([^"]*)"', body.decode())
    assert entries
    for e in entries:
        status, _, ebody = _get(server + "/" + e)
        assert status == 200, e
        if e not in ("", "index.html"):
            assert ebody != index_body, e


def test_static_pipeline_constants():
    """local.mjs (the offline path) and app.mjs track the port's state:
    window, hop, floor, palette stops, the service worker's rules."""
    src = (STATIC / "local.mjs").read_text()
    assert f"WIN_LEN = {TS.WIN_LEN}" in src
    assert f"HOP = {TS.HOP}" in src
    assert f"FLOOR_DB = {TS.FLOOR_DB}" in src
    assert "1e-12" in src
    body = src[src.index("const STOPS"):src.index("};") + 1]
    starts = {name: body.index(name + ":") for name in ("fire", "rainbow")}
    bounds = sorted(starts.values()) + [len(body)]
    for stops, name in ((TV._RAINBOW_STOPS, "rainbow"),
                        (TV._FIRE_STOPS, "fire")):
        s0 = starts[name]
        s1 = min(b for b in bounds if b > s0)
        got = re.findall(r"\[([\d.]+), \[(\d+), (\d+), (\d+)\]\]",
                         body[s0:s1])
        assert [(float(p), (int(r), int(g), int(b)))
                for p, r, g, b in got] == stops, name
    sw = (STATIC / "sw.js").read_text()
    assert "/api/" in sw and "network only" in sw
    assert 'req.method !== "GET"' in sw and "./local.mjs" in sw
    app = (STATIC / "app.mjs").read_text()
    assert "serviceWorker" in app and "register" in app
    assert 'from "./local.mjs"' in app and "goLocal" in app
