"""The host plan of the N-D axis kernels (csrc/axis_fft.cu on the register
radix line FFT of csrc/radix_line.cuh), emulated in numpy as the kernels
index it: the radix list, the twiddle tables and their offsets, the
Stockham index maps of every pass with the swizzled shared-memory
exchange, each thread's loads and stores in device memory, col_fft's
cluster path at lines of 4096 and 8192 (each CTA's line FFT, the twiddle,
the exchange between the cluster's CTAs and the radix-C pass), which
stage 1 takes at the same line lengths (tests/test_torch_stage.py
emulates its kernel). The kernels themselves run only on the card
(tests/test_torch_gpu.py).

Tolerance: the emulation runs in float64 on the float32 tables, so it
differs from the float64 FFT only by the tables' rounding: > 140 dB.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops import ndfft as ND  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

EMU_DB = 140.0
CSRC = Path(HK.__file__).resolve().parent / "csrc"


def _c64(tab):
    return tab[0::2].astype(np.float64) + 1j * tab[1::2]


def _run_block(kind, m, t, e, v):
    """radix_line.cuh's line_fft on one block: v (threads, E) holds point
    ti + s*tpl of each thread's line; returns the same after the passes."""
    steps, tab = HK._axis_plan(kind, m, t, e)
    tab = _c64(tab)
    c, ti = HK._axis_lanes(kind, m, t, e)
    tpl = m // e
    sm = np.full(m * t, np.nan, complex)
    steps = steps.reshape(-1, 7)
    for p, (radix, ns, off, *sw) in enumerate(steps):
        sw = tuple(sw)
        q_n = e // radix
        for q in range(q_n):
            j = ti + q * tpl
            u = np.stack([v[:, q + r * q_n] for r in range(radix)], 1)
            if ns > 1:
                for r in range(1, radix):
                    u[:, r] *= tab[off + (j % ns) * (radix - 1) + r - 1]
            u = np.fft.fft(u, axis=1)
            for r in range(radix):
                v[:, q + r * q_n] = u[:, r]
        if p == len(steps) - 1:
            return v
        for q in range(q_n):
            j = ti + q * tpl
            k0 = (j // ns) * ns * radix + j % ns
            for r in range(radix):
                a = HK._axis_addr(kind, m, t, c, k0 + r * ns)
                sm[HK._swizzle(a, sw)] = v[:, q + r * q_n]
        for s in range(e):
            a = HK._axis_addr(kind, m, t, c, ti + s * tpl)
            v[:, s] = sm[HK._swizzle(a, sw)]
        sm[:] = np.nan


def _emu_row(x):
    """row_fft_kernel over (lines, m): T lines per block."""
    lines, m = x.shape
    t, e = HK._axis_tile("row", m, lines)
    c, ti = HK._axis_lanes("row", m, t, e)
    tpl = m // e
    y = np.full((lines, m), np.nan, complex)
    for blk in range(-(-lines // t)):
        line = blk * t + c
        live = line < lines
        safe = np.where(live, line, 0)
        v = np.stack([np.where(live, x[safe, ti + s * tpl], 0)
                      for s in range(e)], 1)
        v = _run_block("row", m, t, e, v)
        for s in range(e):
            y[line[live], (ti + s * tpl)[live]] = v[live, s]
    return y


def _emu_col_launch(a, out):
    """One col_fft_kernel launch over the (rows, m, inner) view ``a``,
    storing into the flat ``out`` as the kernel does."""
    rows, m, inner = a.shape
    t, e = HK._axis_tile("col", m, inner)
    c, ti = HK._axis_lanes("col", m, t, e)
    tpl = m // e
    flat = a.reshape(-1)
    tiles = -(-inner // t)
    for blk in range(rows * tiles):
        row, col = blk // tiles, (blk % tiles) * t + c
        live = col < inner
        g = row * m * inner + ti * inner + np.where(live, col, 0)
        v = np.stack([np.where(live, flat[g + s * tpl * inner], 0)
                      for s in range(e)], 1)
        v = _run_block("col", m, t, e, v)
        for s in range(e):
            out[(g + s * tpl * inner)[live]] = v[live, s]


def _emu_col(a):
    """col_fft on (b, m, inner) in one launch of the one-block kernel."""
    out = np.full(a.size, np.nan, complex)
    _emu_col_launch(a, out)
    return out.reshape(a.shape)


def _cluster_addrs(m, csize, t):
    """Shared-memory words of col_cluster_kernel's exchange between the
    CTAs of a cluster: those the threads of CTA r write (point i of thread
    ti, k = ti + i*tpl, goes to word (r*slice + k // C)*T + c of CTA
    k mod C = ti mod C), as (threads, E) in issue order, with each
    thread's destination CTA, and those every CTA reads back for its
    radix-C butterflies (butterfly p, input r at word (r*slice + ti +
    p*tpl)*T + c), as (threads, P*C)."""
    mc = m // csize
    e = 16
    c, ti = HK._axis_lanes("col", mc, t, e)
    tpl, sl, p_n = mc // e, mc // csize, e // csize

    def write(r):
        return np.stack([(r * sl + (ti + i * tpl) // csize) * t + c
                         for i in range(e)], 1)

    read = np.stack([(r * sl + ti + p * tpl) * t + c
                     for p in range(p_n) for r in range(csize)], 1)
    return write, ti % csize, read


def _emu_col_cluster(a, csize, tile):
    """col_cluster_kernel over (b, m, inner) as it indexes: per tile and
    CTA r, rows r + C*j loaded, the line FFT of m / C (``_run_block``),
    the twiddle w_m^(r*k), the push into the C CTAs' buffers (every word
    written exactly once, all before any read: the cluster barrier), then
    per CTA q the radix-C DFTs and the stores to rows q + C*j' + s*m/C.
    Asserts that every output element is stored exactly once."""
    b, m, inner = a.shape
    mc = m // csize
    t = min(tile, 1 << max(0, inner - 1).bit_length())
    e = 16
    c, ti = HK._axis_lanes("col", mc, t, e)
    tpl, p_n = mc // e, e // csize
    assert tpl % csize == 0
    ctw = _c64(HK._split_twiddle(csize, mc)).reshape(csize, mc)
    write, dest, read = _cluster_addrs(m, csize, t)
    flat = a.reshape(-1)
    out = np.full(a.size, np.nan, complex)
    stores = np.zeros(a.size, np.int64)
    tiles = -(-inner // t)
    for row in range(b):
        for tile_i in range(tiles):
            col = tile_i * t + c
            live = col < inner
            base = row * m * inner + np.where(live, col, 0)
            buf = np.full((csize, mc * t), np.nan, complex)
            hits = np.zeros((csize, mc * t), np.int64)
            for r in range(csize):
                g = base + (r + csize * ti) * inner
                v = np.stack([np.where(live, flat[g + i * csize * tpl * inner],
                                       0) for i in range(e)], 1)
                v = _run_block("col", mc, t, e, v)
                v = v * ctw[r][ti[:, None] + tpl * np.arange(e)[None, :]]
                w = write(r)
                for i in range(e):
                    np.add.at(hits, (dest, w[:, i]), 1)
                    buf[dest, w[:, i]] = v[:, i]
            assert (hits == 1).all()
            for q in range(csize):
                u = buf[q][read].reshape(-1, p_n, csize)
                assert not np.isnan(u).any()
                u = np.fft.fft(u, axis=2)
                for p in range(p_n):
                    for s in range(csize):
                        o = (base + (q + csize * (ti + p * tpl) + mc * s)
                             * inner)[live]
                        np.add.at(stores, o, 1)
                        out[o] = u[live, p, s]
    assert (stores == 1).all()
    return out.reshape(a.shape)


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32)
            + 1j * rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("m,radices", [
    (2, [2]), (4, [4]), (8, [8]), (16, [16]), (32, [8, 4]), (64, [8, 8]),
    (128, [16, 8]), (256, [16, 16]), (512, [8, 8, 8]), (1024, [16, 8, 8]),
    (2048, [16, 16, 8]), (4096, [16, 16, 16]), (8192, [16, 8, 8, 8])])
def test_radix_list(m, radices):
    assert HK._radices(m) == radices
    assert int(np.prod(radices)) == m


@pytest.mark.parametrize("kind", ["row", "col"])
@pytest.mark.parametrize("m", [2, 16, 128, 1024, 2048])
def test_plan_offsets_and_tables(kind, m):
    """Each pass's Ns is the product of the radices before it, and pass p
    reads its (Ns, R-1) table w^(jj*r), exp(-2 pi i / (Ns R)), at its
    offset, the tables packed back to back."""
    t, e = HK._axis_tile(kind, m, 1 << 16)
    steps, tab = HK._axis_plan(kind, m, t, e)
    steps = steps.reshape(-1, 7)
    tab = _c64(tab)
    ns, off = 1, 0
    for radix, ns_p, off_p, *_ in steps:
        assert ns_p == ns and radix <= e
        if ns > 1:
            assert off_p == off
            jj, r = np.meshgrid(np.arange(ns), np.arange(1, radix),
                                indexing="ij")
            want = np.exp(-2j * np.pi * jj * r / (ns * radix)).ravel()
            got = tab[off:off + ns * (radix - 1)]
            assert np.abs(got - want).max() < 1e-7
            off += ns * (radix - 1)
        ns *= radix
    assert ns == m and tab.size == max(off, 1)


@pytest.mark.parametrize("lines", [1, 3, 64])
@pytest.mark.parametrize("m", [2, 4, 8, 16, 128, 1024, 2048, 4096, 8192])
def test_row_emulation_is_the_line_fft(m, lines):
    if m * lines > (1 << 17):
        lines = (1 << 17) // m
    x = _data((lines, m), m + lines)
    got = _emu_row(x)
    assert snr_db(np.fft.fft(x, axis=1), got) > EMU_DB


@pytest.mark.parametrize("b,inner", [(1, 1), (2, 5), (1, 64)])
@pytest.mark.parametrize("m", [2, 4, 8, 16, 128, 1024, 2048, 4096, 8192])
def test_col_emulation_is_the_line_fft(m, b, inner):
    """col_fft as it launches: one kernel up to 2048, a cluster of 16
    CTAs per tile of 16 columns at 4096 and 8192."""
    if m * inner * b > (1 << 16):
        inner = max(1, (1 << 16) // (m * b))
    a = _data((b, m, inner), m + inner)
    cluster = HK._COL_CLUSTER.get(m)
    assert cluster == ((16, 16) if m > 2048 else None)
    got = _emu_col(a) if cluster is None else _emu_col_cluster(a, *cluster)
    assert snr_db(np.fft.fft(a, axis=1), got) > EMU_DB


# (m, C, T) of the cluster path: the routes' (16, 16) at both lengths,
# and two other shapes of the same indexing
CLUSTER_CASES = [(4096, 16, 16), (8192, 16, 16), (4096, 8, 8),
                 (4096, 16, 32)]


@pytest.mark.parametrize("inner", [1, 5, 8, 64])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("m,csize,tile", CLUSTER_CASES)
def test_col_cluster_emulation(m, csize, tile, b, inner):
    """col_cluster_kernel, with T capped at ``inner``: every output
    element stored exactly once, every exchange word written once before
    the reads, and the result is the line FFT."""
    a = _data((b, m, inner), m + 7 * csize + inner)
    got = _emu_col_cluster(a, csize, tile)
    assert snr_db(np.fft.fft(a, axis=1), got) > EMU_DB


@pytest.mark.parametrize("inner", [1, 5, 8, 4096])
@pytest.mark.parametrize("m,csize,tile", CLUSTER_CASES)
def test_cluster_exchange_has_no_bank_conflicts(m, csize, tile, inner):
    """Every warp-wide write into a CTA's buffer and every read back of
    the cluster's exchange is one wavefront (32 consecutive words), and
    the C CTAs' writes cover each buffer once."""
    t = min(tile, 1 << max(0, inner - 1).bit_length())
    write, dest, read = _cluster_addrs(m, csize, t)
    warps = -(-read.shape[0] // 32)
    assert _wavefronts(read) == warps * read.shape[1]
    lanes = np.arange(read.shape[0])
    for r in range(csize):
        w = write(r)
        for i in range(w.shape[1]):
            # each CTA's share of a warp store: distinct banks
            key = (lanes // 32) * csize + dest
            for k in np.unique(key):
                banks = w[key == k, i] & 31
                assert np.unique(banks).size == banks.size
    for q in range(csize):
        words = np.concatenate([write(r)[dest == q].ravel()
                                for r in range(csize)])
        assert np.array_equal(np.sort(words), np.arange(m // csize * t))
    assert np.array_equal(np.sort(read.ravel()), np.arange(m // csize * t))


@pytest.mark.parametrize("m", [2048, 4096, 8192, 1024])
def test_column_four_step(m):
    """col_fft and stage 1 take the cluster path, the column FFT as a
    four-step across a cluster of 16 CTAs in one launch, at the same line
    lengths (4096 and 8192), with one tile, plan, table and twiddle
    w_m^(r*k) (the same cached pointers), where one block's (m, 8) tile
    does not fit; up to 2048 both run one block per tile of the same
    width, and no cluster."""
    cpu = torch.device("cpu")
    inner = 256
    if m in HK._COL_CLUSTER:
        assert m > 2048
        col = HK._build_args("cluster", 1, m, inner, cpu)
        s1 = HK._build_args("stage1_cluster", 1, m, inner, cpu)
        assert s1[:len(col)] == col and len(s1) == len(col) + 2
        with pytest.raises(ValueError):
            HK._axis_tile("col", m, inner)
    else:
        assert m <= 2048
        with pytest.raises(KeyError):
            HK._cluster_tile(m, inner)
        t, e = HK._axis_tile("col", m, inner)
        assert HK._build_args("stage1", 1, m, inner, cpu)[2] == t


def _route_axis_launches():
    """(kind, m, count) of every axis launch the N-D route makes, over
    its zone's shapes (one batch row; a batch multiplies only the grid):
    kind ``row``, ``col`` (one block per tile) or ``cluster``."""
    out = set()

    def col(m, inner):
        out.add(("cluster" if m in HK._COL_CLUSTER else "col", m, inner))

    p2 = [1 << k for k in range(7, 14)]
    for n1 in p2:
        for n2 in p2:
            if n1 * n2 <= 1 << 26:
                col(n1, n2)
                out.add(("row", n2, n1))
    for shape in [(a, b) for a in (128, 256, 512) for b in (128, 256, 512)] \
            + [(a, b, c) for a in (128, 256, 512) for b in (128, 256, 512)
               for c in (128, 256, 512)]:
        if ND._kernel_nd_zone(shape, tuple(range(len(shape)))):
            for i, m in enumerate(shape[:-1]):
                col(m, int(np.prod(shape[i + 1:])))
            out.add(("row", shape[-1], int(np.prod(shape[:-1]))))
    return sorted(out)


def _block_tile(kind, m, count):
    """(m, T, E) of one block of an axis launch: for the cluster path a
    CTA's lines of m / C."""
    if kind == "cluster":
        csize, t = HK._cluster_tile(m, count)
        return m // csize, t, 16
    return (m, *HK._axis_tile(kind, m, count))


def test_route_tiles_coalesce_and_fit():
    """Every col_fft launch of the routes reads >= 8 columns (>= 32-byte
    row runs) and every axis block fits a block's 227 KB and 1024
    threads."""
    launches = _route_axis_launches()
    assert ("cluster", 8192, 8192) in launches       # 8192^2 columns
    for kind, m, count in launches:
        m, t, e = _block_tile(kind, m, count)
        if kind != "row":
            assert t >= 8, (m, count, t)
        assert HK._axis_smem(m, t) <= 227 * 1024
        assert t * m // e <= 1024 and e == min(m, 16)


def _wavefronts(addr) -> int:
    """Shared-memory wavefronts of the accesses (threads, instructions):
    per warp and instruction, the most distinct words in one bank."""
    n, i = addr.shape
    pad = -n % 32
    a = np.concatenate([addr, np.repeat(addr[-1:], pad, axis=0)])
    a = np.sort(a.reshape(-1, 32, i).transpose(0, 2, 1).reshape(-1, 32), 1)
    new = np.ones(a.shape, bool)
    new[:, 1:] = a[:, 1:] != a[:, :-1]
    rows = np.repeat(np.arange(a.shape[0]), 32)[new.ravel()]
    hits = np.zeros((a.shape[0], 32), np.int64)
    np.add.at(hits, (rows, (a & 31).ravel()[new.ravel()]), 1)
    return int(hits.max(axis=1).sum())


@pytest.mark.parametrize("kind,m,count", _route_axis_launches()[::3]
                         + [("col", 2048, 1 << 20), ("row", 32, 1 << 10),
                            ("row", 64, 1 << 10)]
                         # lines of 64 over wide column counts
                         + [("col", 64, n) for n in (128, 1024, 8192,
                                                     1 << 16, 1 << 19)])
def test_exchange_has_no_bank_conflicts(kind, m, count):
    """Whole blocks: every warp-wide write and read of every exchange is
    one wavefront under the chosen swizzle (the cluster path's CTAs: the
    exchanges of their own line FFT, a col tile of m / C)."""
    m, t, e = _block_tile(kind, m, count)
    kind = "row" if kind == "row" else "col"
    steps = HK._axis_plan(kind, m, t, e)[0].reshape(-1, 7)
    for radix, ns, _, *sw in steps[:-1]:
        w, r = HK._exchange_addrs(kind, m, t, e, radix, ns)
        warps = -(-w.shape[0] // 32)
        for acc in (w, r):
            phys = HK._swizzle(acc, tuple(sw))
            assert _wavefronts(phys) == warps * acc.shape[1]
            # a permutation of the buffer: no two points share a word
            assert np.unique(phys).size == phys.size


def test_butterfly_constants():
    """radix_line.cuh's hard-coded butterfly constants are the float64
    values rounded to float32, and its radix-2 split of dft<8> and
    dft<16> with them (-i where k = R/4) is the DFT."""
    src = (CSRC / "radix_line.cuh").read_text()
    consts = {name: np.float32(float(v)) for name, v in re.findall(
        r"constexpr float (\w+) = ([0-9.]+)f;", src)}
    assert consts == {"c8": np.float32(np.cos(np.pi / 4)),
                      "c16": np.float32(np.cos(np.pi / 8)),
                      "s16": np.float32(np.sin(np.pi / 8))}
    c8, c16, s16 = (float(consts[k]) for k in ("c8", "c16", "s16"))
    w = {8: {1: c8 - 1j * c8, 3: -c8 - 1j * c8},
         16: {1: c16 - 1j * s16, 2: c8 - 1j * c8, 3: s16 - 1j * c16,
              5: -s16 - 1j * c16, 6: -c8 - 1j * c8, 7: -c16 - 1j * s16}}

    def dft(u):
        n = len(u)
        if n <= 4:
            return np.fft.fft(u)
        e, o = dft(u[0::2]), dft(u[1::2])
        t = np.array([o[k] * (1 if k == 0 else -1j if k == n // 4
                              else w[n][k]) for k in range(n // 2)])
        return np.concatenate([e + t, e - t])

    for n in (8, 16):
        u = _data((n,), n)
        assert snr_db(np.fft.fft(u), dft(u)) > EMU_DB
