"""The one-sided STFT's frame kernel (csrc/stft_frames.cu) on the CPU: its
plain version (``hopper_kernels.stft_frames_plain``) against float64 numpy
and against the engines' path of ``ops/stft.py``; a numpy emulation of the
kernel's indexing (the tile's samples in shared memory, the packed line,
radix_line.cuh's passes, the split pass through the half-line buffer, the
stores) against float64 numpy, with its host plan, fit and bank conflicts;
and the route in ``_stft_planes``: which calls reach the kernel and which
keep their engines, bit for bit. The kernel itself runs only on the card
(tests/test_torch_gpu.py).

Tolerances: the plain version against float64 > 100 dB (SNR_FLOOR_DB of
tests/test_fft.py; it reads 130-136 dB) and against the engines' float32
path >= 110 dB (two float32 evaluations of one function); the emulation
runs in float64 on the float32 tables, window and split twiddle, so it
differs from the float64 STFT of the float32 window only by the tables'
rounding: > 140 dB, as the axis kernels' emulation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops import stft as S  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402
from kofft_tpu_torch.ops.window import hann  # noqa: E402

from test_torch_axis import _c64, _run_block, _wavefronts  # noqa: E402

ORACLE_DB = 100.0
PORT_DB = 110.0
EMU_DB = 140.0
WINS = [64, 128, 256, 512, 1024, 2048]
BATCHES = [(), (3,), (2, 3)]


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _oracle(x, w, hop, nf=None):
    """float64 one-sided STFT of (..., n) signals with the float32 window
    ``w``: frame f = x[f*hop : f*hop + win] zero-padded past the end."""
    x = np.asarray(x, np.float64)
    win, n = w.size, x.shape[-1]
    nf = -(-n // hop) if nf is None else nf
    pad = np.zeros((*x.shape[:-1], max(n, (nf - 1) * hop + win)))
    pad[..., :n] = x
    idx = np.arange(nf)[:, None] * hop + np.arange(win)[None, :]
    return np.fft.rfft(pad[..., idx] * w.astype(np.float64), axis=-1)


def _c(pair):
    return pair[0].double().numpy() + 1j * pair[1].double().numpy()


# -------------------------------------------------------------------------
# the plain version
# -------------------------------------------------------------------------

@pytest.mark.parametrize("win", [64, 256, 1024, 2048])
@pytest.mark.parametrize("hop_of", ["1", "7", "win/4", "win", "win+3"])
def test_plain_against_float64_and_engines(win, hop_of):
    """N = 1003 (a multiple of no hop but 1, and below 1024 and 2048), one
    batch shape per hop."""
    hop = {"1": 1, "7": 7, "win/4": win // 4, "win": win,
           "win+3": win + 3}[hop_of]
    lead = BATCHES[["1", "7", "win/4", "win", "win+3"].index(hop_of) % 3]
    x = _signal((*lead, 1003), win + hop)
    w = hann(win)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    got = HK.stft_frames(xt, wt, hop)
    nf = -(-1003 // hop)
    assert got[0].shape == got[1].shape == (*lead, nf, win // 2 + 1)
    assert got[0].dtype == torch.float32
    assert snr_db(_oracle(x, w, hop), _c(got)) > ORACLE_DB
    eng = S._stft_planes(xt, w, hop, True, "torch")
    assert snr_db(_c(eng), _c(got)) >= PORT_DB


@pytest.mark.parametrize("win,n", [(1024, 300), (256, 100), (64, 1)])
def test_plain_signal_shorter_than_the_window(win, n):
    x = _signal((2, n), n)
    w = hann(win)
    got = HK.stft_frames(torch.as_tensor(x), torch.as_tensor(w), win // 4)
    assert snr_db(_oracle(x, w, win // 4), _c(got)) > ORACLE_DB


@pytest.mark.parametrize("nf", [1, 5, 40])
def test_plain_frame_count_override(nf):
    """``nf`` below, at and above ceil(N/hop) = 10: the chunked streams'
    segments."""
    win, hop = 256, 100
    x = _signal((3, 1000), nf)
    w = hann(win)
    xt = torch.as_tensor(x)
    got = HK.stft_frames(xt, torch.as_tensor(w), hop, nf)
    assert got[0].shape == (3, nf, win // 2 + 1)
    assert snr_db(_oracle(x, w, hop, nf), _c(got)) > ORACLE_DB
    eng = S._stft_planes(xt, w, hop, True, "torch", nf=nf)
    assert snr_db(_c(eng), _c(got)) >= PORT_DB


@pytest.mark.parametrize("bad", ["float64", "window64", "strided", "win32",
                                 "win4096", "win1000", "hop0", "empty"])
def test_stft_frames_rejects(bad):
    x = torch.as_tensor(_signal((2, 512), 0))
    w = torch.as_tensor(hann(256))
    hop = 64
    if bad == "float64":
        x = x.double()
    elif bad == "window64":
        w = w.double()
    elif bad == "strided":
        x = x.t().contiguous().t()
    elif bad.startswith("win"):
        w = torch.ones(int(bad[3:]))
    elif bad == "hop0":
        hop = 0
    else:
        x = x[:0]
    with pytest.raises(HK.InvalidValueError):
        HK.stft_frames(x, w, hop)


# -------------------------------------------------------------------------
# the kernel's host plan and its indexing, emulated
# -------------------------------------------------------------------------

def _emu_frames(x, w, hop, nf):
    """stft_frames_kernel over (rows, n) float32 signals, block by block as
    the kernel indexes: the tile's samples in shared memory, the packed
    line, radix_line.cuh's passes (``_run_block``), the half-line buffer
    at stride S and the stores. Unwritten output stays NaN."""
    rows, n = x.shape
    win = w.size
    m, h = win // 2, win // 4
    t, s_ = HK._frames_tile(win)
    tpl = m // 16
    stw = _c64(HK._frames_twiddle(win))
    tid = np.arange(HK._FRAMES_THREADS)
    c, ti = tid // tpl, tid % tpl
    hstep = min(hop, win)
    work = 2 * t * max(m, s_)
    y = np.full((rows, nf, m + 1), np.nan, complex)
    tiles = -(-nf // t)
    for blk in range(rows * tiles):
        row, f0 = blk // tiles, (blk % tiles) * t
        sm = np.full(work, np.nan)
        if hop < win:
            i = np.arange((t - 1) * hop + win)
            g = f0 * hop + i
        else:
            i = np.arange(t * win)
            g = (f0 + i // win) * hop + i % win
        sm[i] = np.where(g < n, x[row, np.minimum(g, n - 1)], 0.0)
        j = ti[:, None] + np.arange(16)[None, :] * tpl
        base = (c * hstep)[:, None]
        v = (sm[base + 2 * j] * w[2 * j]
             + 1j * sm[base + 2 * j + 1] * w[2 * j + 1])
        v = _run_block("row", m, t, 16, v)
        half = np.full(2 * t * s_, np.nan, complex)
        for s in range(8, 16):
            half[c * s_ + ti + (s - 8) * tpl] = v[:, s]
        f = f0 + c
        live = f < nf
        for s in range(8):
            k = ti + s * tpl
            a = v[:, s]
            b = np.where(k == 0, a, half[np.where(k == 0, 0, c * s_ + h - k)])
            e, o = (a + b.conj()) / 2, (a - b.conj()) / 2
            p = stw[k] * o
            y[row, f[live], k[live]] = (e - 1j * p)[live]
            y[row, f[live], (m - k)[live]] = (e + 1j * p).conj()[live]
        z = live & (ti == 0)
        y[row, f[z], h] = v[z, 8].conj()
    return y


@pytest.mark.parametrize("win", WINS)
@pytest.mark.parametrize("hop,n", [(7, 1003), ("win+3", 777)])
def test_emulated_kernel_is_the_stft(win, hop, n):
    """Every window the route takes, an odd hop and a ragged N, hop > win
    (the frames layout) included; every bin written once."""
    hop = win + 3 if hop == "win+3" else hop
    x = _signal((2, n), win)
    w = hann(win)
    nf = -(-n // hop)
    got = _emu_frames(x, w, hop, nf)
    assert not np.isnan(got).any()
    assert snr_db(_oracle(x, w, hop), got) > EMU_DB


def test_emulated_kernel_at_the_cell_tile():
    """hann(1024), hop 256 (4-frame tiles sharing 768 samples with the
    next), 2 rows and a frame count that leaves the last tile part-filled,
    via ``nf``."""
    x = _signal((2, 20000), 1)
    w = hann(1024)
    got = _emu_frames(x, w, 256, 70)
    assert snr_db(_oracle(x, w, 256, 70), got) > EMU_DB


@pytest.mark.parametrize("win", WINS)
def test_frames_plan_fits(win):
    """128 threads of whole lines, eight blocks per SM (64 registers a
    thread) within the SM's 228 KB, and the one shared region holds the
    tile's samples at any hop, the exchange and the half lines."""
    t, s = HK._frames_tile(win)
    m = win // 2
    assert t * (m // 16) == 128 and t & (t - 1) == 0
    assert s >= m // 2
    # the launch's bytes as kofft_stft_frames sizes them: the window, then
    # one region of 2*T*max(m, S) floats
    region = 2 * t * max(m, s)
    smem = 4 * (win + region)
    assert smem <= 227 * 1024 and 8 * (smem + 1024) <= 228 * 1024
    assert max((t - 1) * (win - 1) + win, t * win) <= region
    steps, _ = HK._axis_plan("row", m, t, 16)
    assert steps.size // 7 >= 2 and int(np.prod(steps[0::7])) == m
    tw = _c64(HK._frames_twiddle(win))
    k = np.arange(win // 4)
    assert np.abs(tw - np.exp(-2j * np.pi * k / win)).max() < 1e-7


def _split_addrs(win):
    """Words of the split pass's half-line buffer (threads, 8): written
    (point k = ti + s*tpl, s >= 8, at c*S + k - m/2) and read (Z[m-k] for
    k = ti + s*tpl, s < 8, at c*S + m/2 - k; the k = 0 thread reads
    nothing, shown as its neighbour's word)."""
    m = win // 2
    t, s_ = HK._frames_tile(win)
    tpl = m // 16
    tid = np.arange(HK._FRAMES_THREADS)
    c, ti = tid // tpl, tid % tpl
    wr = np.stack([c * s_ + ti + q * tpl for q in range(8)], 1)
    rd = np.stack([c * s_ + m // 2 - ti - q * tpl for q in range(8)], 1)
    idle = (ti == 0)[:, None] & (np.arange(8) == 0)[None, :]
    # the idle lane as its neighbour (ti = 1, the same warp): one word
    return wr, np.where(idle, np.roll(rd, -1, axis=0), rd)


@pytest.mark.parametrize("win", WINS)
def test_exchange_has_no_bank_conflicts(win):
    """Whole blocks: every warp-wide write and read of the line FFT's
    exchanges (the plan's swizzles) and of the split pass's half-line
    buffer (stride S) is one wavefront, and no two points share a word."""
    m = win // 2
    t, _ = HK._frames_tile(win)
    steps = HK._axis_plan("row", m, t, 16)[0].reshape(-1, 7)
    for radix, ns, _, *sw in steps[:-1]:
        w, r = HK._exchange_addrs("row", m, t, 16, radix, ns)
        for acc in (w, r):
            phys = HK._swizzle(acc, tuple(sw))
            assert _wavefronts(phys) == (acc.shape[0] // 32) * acc.shape[1]
            assert np.unique(phys).size == phys.size
    wr, rd = _split_addrs(win)
    assert _wavefronts(wr) == (wr.shape[0] // 32) * 8
    assert _wavefronts(rd) == (rd.shape[0] // 32) * 8
    assert np.unique(wr).size == wr.size


# -------------------------------------------------------------------------
# the route in _stft_planes
# -------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reads as on the card (``is_cuda``), for the route's
    predicate alone: torch ops on it give plain tensors."""
    __torch_function__ = torch._C._disabled_torch_function_impl
    is_cuda = True


def _route_closed(x, window_np, backend):
    return False


@pytest.fixture
def cpu_route(monkeypatch):
    """The route's own predicate, asked of the CPU signal as if it lay on
    the card: the calls it admits run the kernel's plain version."""
    route = S._frames_route
    monkeypatch.setattr(S, "_frames_route", lambda x, window_np, backend:
                        route(x.as_subclass(_OnCard), window_np, backend))
    HK.reset_counts()
    yield
    HK.reset_counts()


def test_cpu_calls_keep_the_engines():
    """Without a card nothing reaches the kernel: CPU tensors keep the
    engines' path."""
    HK.reset_counts()
    x = _signal((2, 4096), 3)
    S.stft_split(x, hann(1024), 256, onesided=True, device="cpu")
    assert HK.classes["stft_frames"] == 0


@pytest.mark.parametrize("win", WINS)
@pytest.mark.parametrize("backend", [None, "auto", "cuda"])
def test_route_takes_eligible_calls(cpu_route, win, backend):
    """One-sided float32 calls at every power-of-two window in [64, 2048]
    under `auto` (the default) or `cuda` reach the kernel, once per call,
    with the kernel function's answer."""
    x = _signal((2, 3000), win)
    w = hann(win)
    got = S.stft_split(x, w, win // 4 + 1, onesided=True, backend=backend,
                       device="cpu")
    assert HK.classes["stft_frames"] == 1
    want = HK.stft_frames_plain(torch.as_tensor(x), torch.as_tensor(w),
                                win // 4 + 1, got[0].shape[-2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert snr_db(_oracle(x, w, win // 4 + 1), _c(got)) > ORACLE_DB


def _engines_call(case):
    """(function of no argument, label) of a call the route must leave to
    the engines."""
    x = _signal((2, 40000), 9)
    w, hop, kw = hann(1024), 256, {"onesided": True}
    if case == "two-sided":
        kw = {}
    elif case == "bf16":
        x = torch.as_tensor(x).to(torch.bfloat16)
    elif case == "float64":
        x = x.astype(np.float64)
    elif case == "torch":
        kw["backend"] = "torch"
    elif case == "float64 window":
        w = hann(1024, "float64")
    elif case in ("win32", "win1000", "win4096", "win16384"):
        w = hann(int(case[3:]))
        hop = w.size // 4
    return (lambda: S.stft_split(x, w, hop, device="cpu", **kw))


@pytest.mark.parametrize("case", ["two-sided", "bf16", "float64", "torch",
                                  "float64 window", "win32", "win1000",
                                  "win4096", "win16384"])
def test_route_leaves_other_calls_bit_for_bit(cpu_route, monkeypatch, case):
    """Two-sided, bf16 and float64 signals, ``backend="torch"``, a float64
    window, windows outside the powers of two in [64, 2048]: the engines'
    path, bit for bit as with the route closed."""
    fn = _engines_call(case)
    got = fn()
    assert HK.classes["stft_frames"] == 0
    monkeypatch.setattr(S, "_frames_route", _route_closed)
    want = fn()
    assert got[0].dtype == want[0].dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_route_leaves_tracked_calls_with_their_gradient(cpu_route,
                                                        monkeypatch):
    """A signal that requires grad keeps the differentiable torch ops: no
    kernel call, and the same values and gradient as with the route
    closed; an untracked call of the same shape takes the kernel."""
    x0 = _signal((2, 4096), 11)
    w = hann(512)
    g = torch.as_tensor(_signal((2, 16, 257), 12))

    def grad():
        x = torch.as_tensor(x0).requires_grad_()
        yr, yi = S.stft_split(x, w, 256, onesided=True, device="cpu")
        (yr * g + yi * g).sum().backward()
        return yr.detach(), x.grad

    got = grad()
    assert HK.classes["stft_frames"] == 0
    route = S._frames_route
    monkeypatch.setattr(S, "_frames_route", _route_closed)
    want = grad()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    monkeypatch.setattr(S, "_frames_route", route)
    with torch.no_grad():
        x = torch.as_tensor(x0).requires_grad_()
        S.stft_split(x, w, 256, onesided=True, device="cpu")
    assert HK.classes["stft_frames"] == 1


def test_streams_through_the_route(cpu_route):
    """``stft_stream_scan`` (chunks with ``nf`` set, through a lowered
    ``_SCAN_POINTS``) and ``StftPushStream`` (pushes of 4800 samples and
    the flush) against the offline call, all through the kernel's
    function."""
    x = _signal((20000,), 13)
    w = hann(1024)
    off = S.stft_split(x, w, 256, onesided=True, device="cpu")
    n0 = HK.classes["stft_frames"]
    old = S._SCAN_POINTS
    S._SCAN_POINTS = 1 << 14
    try:
        scan = S.stft_stream_scan(x, w, 256, onesided=True, device="cpu")
    finally:
        S._SCAN_POINTS = old
    assert HK.classes["stft_frames"] - n0 == -(-off[0].shape[0] // 16)
    assert snr_db(_c(off), _c(scan)) >= PORT_DB
    st = S.StftPushStream(w, 256, onesided=True, device="cpu")
    parts = [st.push(x[i: i + 4800]) for i in range(0, x.size, 4800)]
    parts.append(st.flush())
    got = (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    assert got[0].shape == off[0].shape
    assert snr_db(_c(off), _c(got)) >= PORT_DB
