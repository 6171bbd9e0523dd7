"""The stage kernels of the 1-D four-step FFT (csrc/fft_stages.cu on the
register radix line of csrc/radix_line.cuh), emulated in numpy as the
kernels index memory: stage 1's column tiles with the four-step twiddle
fused into the store (float2 factor tables), its column four-step above
2048 points with the split twiddle and the digit-swapped store, stage 2's
whole-line tiles with the transposed store through the swizzled exchange
buffer, its cluster of CTAs at lines of 4096 and 8192 (each point sent to
the CTA that stores its output row), the one-sided store with the
Nyquist bin, and conj on both sides. Smooth n1 keeps the dense chain of
csrc/smooth_stage.cu, emulated as tests/test_torch_kernels.py does. Over
every split that ``_pow2_split`` gives from 2^14 to 2^26 the launches fit
a block, every warp's global loads and stores cover >= 32-byte runs, and
every shared-memory exchange is one wavefront per warp access. The
kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances: the emulation runs in float64 on the float32 tables, so it
differs from the float64 FFT only by the tables' rounding: > 140 dB. The
JAX Pallas kernels (interpret mode) are float32 evaluations: >= 110 dB
against the emulation, as port against JAX elsewhere.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_axis import _c64, _wavefronts  # noqa: E402
from test_torch_axis import _data as _data32  # noqa: E402
from test_torch_kernels import _emulate_chain  # noqa: E402

from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

EMU_DB = 140.0
PORT_DB = 110.0
E = HK._STAGE_E
SMEM_MAX = 227 * 1024
POW2_SPLITS = [HK._pow2_split(1 << k) for k in range(14, 27)]


def _data(shape, seed):
    """Seeded float32-valued complex input, held in complex128 so that the
    references are float64 FFTs."""
    return _data32(shape, seed).astype(complex)


def _radix_blocks(kind, m, t, v, plan):
    """radix_line.cuh's line_fft on a stack of blocks: v (blocks, threads,
    E) holds point ti + s*tpl of each thread's line; returns the same
    after the passes (the method of test_torch_axis._run_block)."""
    steps, tab = plan
    tab = _c64(tab)
    c, ti = HK._axis_lanes(kind, m, t, E)
    tpl = m // E
    steps = steps.reshape(-1, 7)
    for p, (radix, ns, off, *sw) in enumerate(steps):
        q_n = E // radix
        for q in range(q_n):
            j = ti + q * tpl
            u = np.stack([v[:, :, q + r * q_n] for r in range(radix)], -1)
            if ns > 1:
                u[:, :, 1:] *= tab[off + (j % ns)[:, None] * (radix - 1)
                                   + np.arange(radix - 1)]
            u = np.fft.fft(u, axis=-1)
            for r in range(radix):
                v[:, :, q + r * q_n] = u[:, :, r]
        if p == len(steps) - 1:
            return v
        sm = np.full((v.shape[0], m * t), np.nan, complex)
        for q in range(q_n):
            j = ti + q * tpl
            k0 = (j // ns) * ns * radix + j % ns
            for r in range(radix):
                a = HK._swizzle(HK._axis_addr(kind, m, t, c, k0 + r * ns),
                                tuple(sw))
                sm[:, a] = v[:, :, q + r * q_n]
        for s in range(E):
            a = HK._swizzle(HK._axis_addr(kind, m, t, c, ti + s * tpl),
                            tuple(sw))
            v[:, :, s] = sm[:, a]


# ---------------------------------------------------------------------------
# stage 1: column tiles (one launch, or the column four-step's two)
# ---------------------------------------------------------------------------

def _s1_index(rows, m, inner, swap, blocks):
    """stage1_kernel's indexing over the (rows, m, inner) view for the
    given blocks: (T, block row (blocks, 1), column (blocks, threads),
    line point k (threads, E), load offsets and store offsets (blocks,
    threads, E))."""
    t, e = HK._axis_tile("col", m, inner)
    assert e == E
    c, ti = HK._axis_lanes("col", m, t, E)
    tpl = m // E
    tiles = inner // t
    row = (blocks // tiles)[:, None]
    col = (blocks % tiles)[:, None] * t + c
    s = np.arange(E) * tpl
    g = (row * m * inner + ti * inner + col)[..., None] + s * inner
    o = ((row // swap) * swap * m * inner + (row % swap) * inner
         + ti * swap * inner + col)[..., None] + s * swap * inner
    return t, row, col, ti[:, None] + s, g, o


def _emu_s1_launch(a, out, conj=False, tw=None, tw_div=1, swap=1, w=None):
    """One stage1_kernel launch over the (rows, m, inner) view ``a``, into
    the flat ``out``: conj on load, the split twiddle ``tw`` (flat
    float2 table), the digit swap and the four-step twiddle ``w = (base,
    col)`` (float2 factor tables) as the kernel indexes them."""
    rows, m, inner = a.shape
    t, _ = HK._axis_tile("col", m, inner)
    blocks = np.arange(rows * (inner // t))
    t, row, col, k, g, o = _s1_index(rows, m, inner, swap, blocks)
    v = a.reshape(-1)[g]
    if conj:
        v = v.conj()
    v = _radix_blocks("col", m, t, v, HK._axis_plan("col", m, t, E))
    if tw is not None:
        v = v * tw[k[None] * (inner // tw_div) + (col // tw_div)[..., None]]
    if w is not None:
        base, fac = (_c64(x) for x in w)
        tw_t = w[0].size // 2 // (m * swap)
        k1 = k[None] * swap + (row % swap)[..., None]
        cc = col[..., None]
        v = v * (fac[k1 * (inner // tw_t) + cc // tw_t]
                 * base[k1 * tw_t + cc % tw_t])
    out[o] = v


def _emu_stage1(a, conj=False):
    """stage1 on (b, n1, n2): the launches of ``HK._stage1_views`` (the
    dense chain of smooth_stage.cu for a smooth n1), into C."""
    b, n1, n2 = a.shape
    w = HK._stage1_twiddle(n1, n2)
    if n1 & (n1 - 1):
        x = a.conj() if conj else a
        y = _emulate_chain(x.transpose(1, 0, 2).reshape(n1, -1), n1,
                           b * n2, 8).reshape(n1, b, n2).transpose(1, 0, 2)
        base, fac = (_c64(x).reshape(n1, -1) for x in w)
        j2 = np.arange(n2)
        return y * (fac[:, j2 // 128] * base[:, j2 % 128])
    views = HK._stage1_views(n1, n2)
    src = a
    for i, (rows, m, inner, tw, tw_div, swap) in enumerate(views):
        out = np.full(a.size, np.nan, complex)
        _emu_s1_launch(src.reshape(b * rows, m, inner), out,
                       conj and i == 0, None if tw is None else _c64(tw),
                       tw_div, swap, w if i == len(views) - 1 else None)
        src = out
    return src.reshape(a.shape)


def _ref_stage1(a, conj=False):
    b, n1, n2 = a.shape
    y = np.fft.fft(a.conj() if conj else a, axis=1)
    k1, j2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    return y * np.exp(-2j * np.pi * ((k1 * j2) % (n1 * n2)) / (n1 * n2))


# ---------------------------------------------------------------------------
# stage 2: whole-line tiles, the transposed store, clusters
# ---------------------------------------------------------------------------

def _s2_index(b, n1, m, blocks):
    """stage2_kernel's indexing for the given blocks (CTAs): T, Tc, the
    cluster size, each CTA's rank, load offsets (blocks, threads, E), the
    transposed exchange's destination CTA and logical word of each point
    (blocks, threads, E), and the flat output bin (within its batch row)
    and batch row of each word read back (blocks, threads, E)."""
    t, tc = HK._stage2_tile(m)
    cs = t // tc
    cl, ti = HK._axis_lanes("row", m, tc, E)
    tpl = m // E
    rank = blocks % cs
    tiles = n1 // t
    row = (blocks // cs) // tiles
    k1_0 = ((blocks // cs) % tiles) * t
    c = rank[:, None] * tc + cl
    s = np.arange(E)
    g = (row[:, None] * n1 * m + (k1_0[:, None] + c) * m + ti)[..., None] \
        + s * tpl
    sl = m // cs
    k2 = ti[:, None] + s * tpl
    dest = (blocks - rank)[:, None, None] + k2 // sl
    word = c[..., None] * sl + k2 % sl
    n_thr = tc * tpl
    idx = np.arange(n_thr)[:, None] + s * n_thr
    k = ((rank[:, None, None] * sl + idx // t) * n1 + k1_0[:, None, None]
         + idx % t)
    return t, tc, cs, rank, g, dest, word, idx, k, row


def _emu_stage2(c, conj=False, half=False):
    """stage2 on C (b, n1, n2): (b, n2, n1), or the one-sided (b, n/2 + 1)
    planes for ``half``, as the kernel loads, exchanges and stores."""
    b, n1, m = c.shape
    t, tc = HK._stage2_tile(m)
    blocks = np.arange(b * (n1 // t) * (t // tc))
    t, tc, cs, rank, g, dest, word, idx, k, row = _s2_index(b, n1, m,
                                                             blocks)
    plan = HK._stage2_plan(m, t, tc)
    sw = tuple(plan[0].reshape(-1, 7)[-1, 3:])
    sl = m * tc // t
    v = _radix_blocks("row", m, tc, c.reshape(-1)[g], plan)
    buf = np.full((blocks.size, tc * m), np.nan, complex)
    buf[dest, HK._swizzle(word, sw)] = v
    got = buf[blocks[:, None, None], HK._swizzle((idx % t) * sl + idx // t,
                                                 sw)]
    n = n1 * m
    if half:
        out = np.full((b, n // 2 + 1), np.nan, complex)
        keep = k <= n // 2
        rows = np.broadcast_to(row[:, None, None], k.shape)
        out[rows[keep], k[keep]] = got[keep]
        return out
    out = np.full(b * n, np.nan, complex)
    out[row[:, None, None] * n + k] = got.conj() if conj else got
    return out.reshape(b, m, n1)


def _ref_stage2(c, conj=False):
    y = np.fft.fft(c, axis=2).transpose(0, 2, 1)
    return y.conj() if conj else y


# ---------------------------------------------------------------------------
# the emulations compute the transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("b,n", [(2, 1 << 14), (1, 1 << 15), (1, 1 << 16),
                                 (1, 1 << 18), (1, 1 << 20), (1, 3 << 14),
                                 (2, 9 << 14)])
def test_pair_emulation_is_the_fft(b, n, conj):
    """stage1 then stage2, as they launch: the flat (b, n2, n1) output is
    the DFT of each length-n line (conj on both sides: the unnormalized
    inverse)."""
    n1, n2 = HK._pow2_split(n)
    x = _data((b, n), n + b)
    y = _emu_stage2(_emu_stage1(x.reshape(b, n1, n2), conj), conj)
    want = np.fft.ifft(x, axis=-1) * n if conj else np.fft.fft(x, axis=-1)
    assert snr_db(want, y.reshape(b, n)) > EMU_DB


@pytest.mark.parametrize("b,n", [(2, 1 << 14), (1, 1 << 16), (3, 1 << 17),
                                 (1, 1 << 20), (1, 3 << 14)])
def test_real_pair_emulation_is_the_rfft(b, n):
    """stage1_real (imaginary part zero in registers) then stage2_half:
    the one-sided spectrum with the Nyquist bin from the k1 = 0 line."""
    n1, n2 = HK._pow2_split(n)
    x = _data((b, n), n).real
    y = _emu_stage2(_emu_stage1(x.reshape(b, n1, n2).astype(complex)),
                    half=True)
    want = np.fft.rfft(x, axis=-1)
    assert y.shape == want.shape
    assert snr_db(want, y) > EMU_DB
    assert snr_db(want[:, -1], y[:, -1]) > EMU_DB


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("n", [1 << 14, 3 << 14])
def test_pair_emulation_vs_jax(n, real):
    """The emulated kernels against the JAX Pallas kernels in interpret
    mode, as tests/test_torch_kernels.py runs them: the complex pair
    against fused_multilevel_fft at (2, n), the real pair against
    fused_multilevel_rfft."""
    b = 2
    n1, n2 = HK._pow2_split(n)
    x = _data((b, n), n + 7)
    if real:
        xr = x.real.astype(np.float32)
        jr, ji = PK.fused_multilevel_rfft(jnp.asarray(xr), n, interpret=True)
        got = _emu_stage2(_emu_stage1(
            xr.reshape(b, n1, n2).astype(complex)), half=True)
    else:
        jr, ji = PK.fused_multilevel_fft(
            jnp.asarray(x.real.astype(np.float32)),
            jnp.asarray(x.imag.astype(np.float32)), n, interpret=True)
        got = _emu_stage2(_emu_stage1(x.reshape(b, n1, n2))).reshape(b, n)
    jax_y = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
    assert snr_db(jax_y, got) >= PORT_DB


@pytest.mark.parametrize("real,conj", [(False, False), (False, True),
                                       (True, False)])
@pytest.mark.parametrize("b,n1,n2", [(1, 4096, 128), (2, 4096, 256),
                                     (1, 8192, 128)])
def test_stage1_column_four_step(b, n1, n2, real, conj):
    """Stage 1 above 2048 points: lines of m1 with w_n1^(k1a*j1b) fused into
    the first store, lines of m2 stored to row k1b*m1 + k1a with W fused
    into the same store; complex forward and inverse, and real input."""
    assert len(HK._stage1_views(n1, n2)) == 2
    a = _data((b, n1, n2), n1 + n2)
    if real:
        a = a.real.astype(complex)
    assert snr_db(_ref_stage1(a, conj), _emu_stage1(a, conj)) > EMU_DB


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("b,n1,n2", [(1, 8, 4096), (2, 16, 4096),
                                     (1, 8, 8192), (2, 8, 8192),
                                     (1, 8, 2048)])
def test_stage2_cluster(b, n1, n2, conj):
    """Stage 2 at lines of 4096 and 8192: a cluster of T/Tc CTAs, each point
    sent to the CTA that stores its output row; the one-sided store from
    the same exchange."""
    c = _data((b, n1, n2), n1 + n2)
    assert snr_db(_ref_stage2(c, conj), _emu_stage2(c, conj)) > EMU_DB
    want = _ref_stage2(c).reshape(b, -1)[:, :n1 * n2 // 2 + 1]
    assert snr_db(want, _emu_stage2(c, half=True)) > EMU_DB


@pytest.mark.parametrize("n2", [4096, 8192])
def test_cluster_slices_cover_the_rows(n2):
    """Each CTA r of a cluster receives exactly the points of its slice of
    output rows, k2 in [r*slice, (r+1)*slice), one per word of its
    buffer, and stores every (k2, k1) of the tile once."""
    n1 = 16
    t, tc = HK._stage2_tile(n2)
    cs = t // tc
    assert (t, cs) == {4096: (8, 4), 8192: (8, 8)}[n2]
    blocks = np.arange(cs)
    _, _, _, rank, _, dest, word, idx, k, _ = _s2_index(1, n1, n2, blocks)
    sl = n2 // cs
    for r in range(cs):
        got = np.sort(word[dest == r])
        assert np.array_equal(got, np.arange(sl * t))
        assert np.all(k[r] // n1 // sl == r)
    assert np.array_equal(np.sort(k.ravel()),
                          np.sort((np.arange(n2)[:, None] * n1
                                   + np.arange(t)).ravel()))


# ---------------------------------------------------------------------------
# every split the routes use: fit, coalescing, bank conflicts
# ---------------------------------------------------------------------------

def _stage1_launches(n1, n2):
    """(rows per batch row, m, inner, swap) of each stage-1 launch."""
    return [(rows, m, inner, swap)
            for rows, m, inner, _, _, swap in HK._stage1_views(n1, n2)]


@pytest.mark.parametrize("n1,n2", POW2_SPLITS)
def test_stage_launches_fit(n1, n2):
    """Every stage launch fits a block: <= 1024 threads and <= 227 KB of
    shared memory, stage 2 in a cluster of <= 8 CTAs from lines of 4096;
    stage 1 tiles >= 8 columns, stage 2 tiles >= 8 lines; stage 1 splits
    above 2048 points."""
    views = _stage1_launches(n1, n2)
    assert len(views) == (1 if n1 <= 2048 else 2)
    for _, m, inner, _ in views:
        t, e = HK._axis_tile("col", m, inner)
        assert e == E and t >= 8 and inner % t == 0
        assert t * m // E <= 1024 and HK._axis_smem(m, t) <= SMEM_MAX
    t, tc = HK._stage2_tile(n2)
    assert t >= 8 and n1 % t == 0 and t % tc == 0
    assert (t // tc > 1) == (n2 > 2048) and t // tc <= 8
    assert tc * n2 // E <= 1024 and 8 * n2 * tc <= SMEM_MAX


def _min_run_bytes(addr, elt=4, mask=None):
    """The shortest run of consecutive elements any warp instruction
    touches, in bytes: addr (blocks, threads, E) element offsets (lanes
    where ``mask`` is False do not access)."""
    nb, n, e = addr.shape
    a = addr.reshape(nb, n // 32, 32, e).transpose(0, 1, 3, 2)
    a = a.reshape(-1, 32)
    m = (np.ones(addr.shape, bool) if mask is None else mask)
    m = m.reshape(nb, n // 32, 32, e).transpose(0, 1, 3, 2).reshape(-1, 32)
    best = None
    for lanes, on in zip(a, m):
        u = np.unique(lanes[on])
        if u.size == 0:
            continue
        cuts = np.flatnonzero(np.diff(u) != 1)
        runs = np.diff(np.concatenate([[0], cuts + 1, [u.size]]))
        best = runs.min() if best is None else min(best, runs.min())
    return int(best) * elt


def _sectors_ideal(addr, elt=4):
    """Whether every warp instruction touches only the 32-byte sectors its
    bytes fill (addr (blocks, threads, E) element offsets)."""
    nb, n, e = addr.shape
    a = addr.reshape(nb, n // 32, 32, e).transpose(0, 1, 3, 2)
    a = a.reshape(-1, 32) * elt
    sectors = np.array([np.unique(x // 32).size for x in a])
    return bool(np.all(sectors * 32 == 32 * elt))


def _edge_blocks(total):
    return np.unique([0, 1, total // 2, total - 1])


@pytest.mark.parametrize("n1,n2", POW2_SPLITS)
def test_stage1_accesses_coalesce(n1, n2):
    """Each warp of each stage-1 launch loads and stores float32 planes in
    32-byte runs that fill whole sectors (T >= 8 consecutive columns)."""
    for rows, m, inner, swap in _stage1_launches(n1, n2):
        t, _ = HK._axis_tile("col", m, inner)
        blocks = _edge_blocks(rows * 2 * (inner // t))
        _, _, _, _, g, o = _s1_index(rows * 2, m, inner, swap, blocks)
        for addr in (g, o):
            assert _min_run_bytes(addr) >= 32
            assert _sectors_ideal(addr)


@pytest.mark.parametrize("n1,n2", POW2_SPLITS)
def test_stage2_accesses_coalesce(n1, n2):
    """Each warp of a stage-2 launch loads whole-row runs and stores 32 /
    T output rows of T >= 8 consecutive k1 (32-byte runs filling whole
    sectors); the one-sided store at the odd row stride n/2 + 1 keeps
    the runs (the Nyquist bin aside), though a run may straddle a
    sector."""
    b = 3
    t, tc = HK._stage2_tile(n2)
    total = b * (n1 // t) * (t // tc)
    cs = t // tc
    blocks = np.unique(np.concatenate(
        [np.arange(cs), total - cs + np.arange(cs), [total // 2]]))
    _, _, _, _, g, _, _, _, k, row = _s2_index(b, n1, n2, blocks)
    assert _min_run_bytes(g) >= 32 and _sectors_ideal(g)
    n = n1 * n2
    full = row[:, None, None] * n + k
    assert _min_run_bytes(full) >= 32 and _sectors_ideal(full)
    half = row[:, None, None] * (n // 2 + 1) + k
    keep = k < n // 2          # the Nyquist bin is one scalar per row
    assert _min_run_bytes(half, mask=keep) >= 32


@pytest.mark.parametrize("n1,n2", POW2_SPLITS)
def test_stage_exchanges_have_no_bank_conflicts(n1, n2):
    """Whole blocks: every warp-wide write and read of every exchange of
    both stages, stage 2's transposed exchange included (its writes from
    every CTA of a cluster), is one wavefront under the plan's swizzle."""
    def check(w, r, sw):
        warps = -(-w.shape[0] // 32)
        for acc in (w, r):
            phys = HK._swizzle(acc, tuple(sw))
            assert _wavefronts(phys) == warps * acc.shape[1]

    for _, m, inner, _ in _stage1_launches(n1, n2):
        t, e = HK._axis_tile("col", m, inner)
        steps = HK._axis_plan("col", m, t, e)[0].reshape(-1, 7)
        for radix, ns, _, *sw in steps[:-1]:
            check(*HK._exchange_addrs("col", m, t, e, radix, ns), sw)
    t, tc = HK._stage2_tile(n2)
    steps = HK._stage2_plan(n2, t, tc)[0].reshape(-1, 7)
    for radix, ns, _, *sw in steps[:-1]:
        check(*HK._exchange_addrs("row", n2, tc, E, radix, ns), sw)
    for rank in range(t // tc):
        w, r = HK._transpose_addrs(n2, t, tc, rank)
        check(w, r, steps[-1, 3:])
        phys = HK._swizzle(r, tuple(steps[-1, 3:]))
        assert np.unique(phys).size == phys.size == n2 * tc


def test_smooth_n1_keeps_the_dense_chain():
    """A smooth n1 is no power of two: stage 1 runs the dense chain
    (_kernel_tile, _line_plan), and its stage 2 the radix kernel."""
    for n in (3 << 18, 9 << 14, 23 << 14):
        n1, n2 = HK._pow2_split(n)
        assert n1 & (n1 - 1) and not n2 & (n2 - 1)
        assert HK._kernel_tile(n1) >= 1
        assert HK._stage2_tile(n2)[0] >= 8


def test_stage1_twiddle_tables_interleave_the_factors():
    """The float2 factor tables hold _twiddle_factors' planes, re and im
    interleaved: base (n1, t) and col (n1, n2/t)."""
    n1, n2 = 256, 1024
    base, fac = HK._stage1_twiddle(n1, n2)
    br, bi, cr, ci = HK._twiddle_factors(n1, n2, 128, "float32")
    assert base.dtype == fac.dtype == np.float32
    assert np.array_equal(base[0::2], br.ravel())
    assert np.array_equal(base[1::2], bi.ravel())
    assert np.array_equal(fac[0::2], cr.ravel())
    assert np.array_equal(fac[1::2], ci.ravel())
