"""The dense four-step pair's tensor-core kernels (csrc/dense_dft.cu),
emulated in numpy as the kernels index memory: the host-split F tables,
each thread's cp.async chunks of a K slice (the F planes into 128-byte
swizzled rows, the raw data tile into its padded global layout), the
wgmma B operand read through the descriptor and the swizzle, the A
fragments loaded from the raw tile and split (tf32x3) or rounded (bf16x1)
in registers, the per-slice fold of each Gauss product, and the
epilogue's transpose through a padded shared tile, twiddle and row
stores. Shared-memory accesses are counted in wavefronts, global ones in
contiguous runs. The kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py). Also: the precision tier's
routing to the kernels' instances, and the `default` tier's plain pair
against float64 and against an independent bf16 emulation.

Tolerances: the emulation multiplies in float32 matmuls, as a float32
evaluation of the same split operands: >= 110 dB against the float32
plain version on `highest` (PORT_DB of the other port tests), the pair
>= 100 dB against the float64 FFT; on `default` the emulation and the
plain version round the same operands to bf16 and differ in float32
summation order only: >= 100 dB. The `default` tier's pair, port and JAX
alike, >= 42 dB against float64 (the tier's floor; one bf16 rounding of
each operand, ~47 dB).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_axis import CSRC, _wavefronts  # noqa: E402

from kofft_tpu import config as jcfg  # noqa: E402
from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu_torch import config as tcfg  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402
from kofft_tpu_torch.plan import tables  # noqa: E402

PORT_DB = 110.0
ORACLE_DB = 100.0
BF16_PLAIN_DB = 100.0
DEFAULT_DB = 42.0
SMEM_MAX = 232448
SRC = (CSRC / "dense_dft.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS = _const("kThreads")
TILE_D = _const("kTileD")
TILE_F = _const("kTileF")
ROW_BYTES = _const("kRowBytes")
OUT_LD = TILE_D + int(re.search(r"kOutLd = kTileD \+ (\d+);", SRC).group(1))
# the raw tile's row pads: stage b (bf16, tf32), stage a (bf16, tf32)
_PADS = [int(v) for v in re.search(
    r"kStageB \? T::kBK \+ \(kBf16 \? (\d+) : (\d+)\) : kTileD \+ "
    r"\(kBf16 \? (\d+) : (\d+)\)", SRC).groups()]
POW2_SPLITS = [HK._pow2_split(1 << k) for k in range(14, 27)]
SMOOTH_SPLITS = [HK._pow2_split(n) for n in (3 << 14, 9 << 14, 23 << 14,
                                             3 << 18)]


def _geo(mode, stage_b):
    """The kernel instance's geometry (dense_dft.cu Tier and Geo)."""
    bf16 = mode == "bf16x1"
    esize = 2 if bf16 else 4
    bk = ROW_BYTES // esize
    ld = (bk + _PADS[1 - bf16] if stage_b else TILE_D + _PADS[3 - bf16])
    rows = TILE_D if stage_b else bk
    planes = 3 if bf16 else 6
    f_bytes = planes * TILE_F * ROW_BYTES
    stage = -(-(f_bytes + 2 * rows * ld * 4) // 1024) * 1024
    kc = bk // 4 if stage_b else TILE_D // 4
    return dict(bf16=bf16, esize=esize, bk=bk, step=16 if bf16 else 8,
                planes=planes, ld=ld, rows=rows, kc=kc, tr=THREADS // kc,
                stage=stage, smem=2 * stage + 1024, stage_b=stage_b)


def _lanes():
    tid = np.arange(THREADS)
    lane = tid % 32
    return tid, lane // 4, lane % 4, 64 * (tid // 128) + 16 * (tid // 32 % 4)


# ---------------------------------------------------------------------------
# the kernel's maps, built from its address formulas
# ---------------------------------------------------------------------------

def _f_image(g):
    """cp.async of one slice's F planes: per thread, plane p and half h,
    16 bytes of row fr0 + 32 h at chunk c ^ (row & 7). Returns the
    element image (plane, element) -> (row, k) of the tile, and the
    (threads, instructions) destination and source byte addresses."""
    tid = np.arange(THREADS)
    fr0, c = tid >> 3, tid & 7
    per = 16 // g["esize"]
    n = TILE_F * ROW_BYTES // g["esize"]
    row = np.full((g["planes"], n), -1)
    kk = np.full((g["planes"], n), -1)
    dst, src = [], []
    for p in range(g["planes"]):
        for h in range(2):
            r = fr0 + 32 * h
            d = h * 32 * ROW_BYTES + fr0 * ROW_BYTES + ((c ^ (fr0 & 7)) << 4)
            dst.append(p * TILE_F * ROW_BYTES + d)
            src.append((p, r, c * 16))
            for e in range(per):
                assert (row[p, d // g["esize"] + e] == -1).all()
                row[p, d // g["esize"] + e] = r
                kk[p, d // g["esize"] + e] = c * per + e
    return row, kk, np.stack(dst, 1), src


def _b_read(g, row, kk):
    """The wgmma B operand of k step j, plane p, as the hardware reads it:
    descriptor start + 32 j, rows 128 bytes apart, element kk at + kk *
    esize, and the 128-byte swizzle on the address (bits 4-6 ^= bits
    7-9). Returns (planes, steps, 64, step) tile rows and k of each
    operand element."""
    e = g["esize"]
    j = np.arange(g["bk"] // g["step"])[:, None, None]
    r = np.arange(TILE_F)[None, :, None]
    k = np.arange(g["step"])[None, None, :]
    logical = 32 * j + r * ROW_BYTES + k * e
    phys = logical ^ (((logical >> 7) & 7) << 4)
    return row[:, phys // e], kk[:, phys // e]


def _data_image(g):
    """cp.async of one slice's raw data tile: per thread, plane p and pass
    h, 16 bytes of row dr0 + kTR h at word dc. Returns the image (word) ->
    (k, line) of the tile (-1 at pads), and the (threads, instructions)
    destination words and source element offsets (rows of ``row_len``
    elements)."""
    tid = np.arange(THREADS)
    dr0, dc = tid // g["kc"], 4 * (tid % g["kc"])
    words = g["rows"] * g["ld"]
    img_k = np.full(words, -1)
    img_n = np.full(words, -1)
    dst, src = [], []
    for h in range(g["rows"] // g["tr"]):
        r = dr0 + g["tr"] * h
        w = r * g["ld"] + dc
        dst.append(w)
        src.append((r, dc))
        for e in range(4):
            assert (img_k[w + e] == -1).all()
            if g["stage_b"]:
                img_n[w + e], img_k[w + e] = r, dc + e
            else:
                img_k[w + e], img_n[w + e] = r, dc + e
    return img_k, img_n, np.stack(dst, 1), src


def _frag_words(g):
    """Words per A fragment load: bf16 stage b loads k and k + 1 at once."""
    return 2 if g["bf16"] and g["stage_b"] else 1


def _frag_addrs(g):
    """Word addresses of the A fragment loads (threads, instructions; the
    first word of an 8-byte load) and the (line, k) of each word loaded:
    tf32 register v holds line ln + 8 (v & 1), k = 8 j + t + 4 (v >> 1);
    bf16 the pair k = 16 j + 2t + 8 (v >> 1) and k + 1, one 8-byte load
    in stage b's [n][k] rows, two loads in stage a's [k][n] rows."""
    _, gq, t, base = _lanes()
    ln = base + gq
    words = _frag_words(g)
    addrs, lines, ks = [], [], []
    for j in range(g["bk"] // g["step"]):
        for v in range(4):
            for half in range(0, 2 if g["bf16"] else 1, words):
                n = ln + 8 * (v & 1)
                if g["bf16"]:
                    k = j * g["step"] + 2 * t + 8 * (v >> 1) + half
                else:
                    k = j * g["step"] + t + 4 * (v >> 1)
                addrs.append(n * g["ld"] + k if g["stage_b"]
                             else k * g["ld"] + n)
                for e in range(words):
                    lines.append(n)
                    ks.append(k + e)
    return np.stack(addrs, 1), np.stack(lines, 1), np.stack(ks, 1)


def _epilogue():
    """Accumulator q of each thread into the (64, kOutLd) tile (words, and
    the (line, row) it holds), then each warp's float4 row reads: returns
    the write words (threads, 32), the read words (threads, passes) of
    each float4's first word, and the output (row m, column) each read
    lands at."""
    tid, gq, t, base = _lanes()
    q = np.arange(32)
    m = 8 * (q >> 2)[None] + 2 * t[:, None] + (q & 1)[None]
    n = (base + gq)[:, None] + 8 * ((q >> 1) & 1)[None]
    writes = m * OUT_LD + n
    tile = np.full((TILE_F, OUT_LD), -1)
    tile.ravel()[writes.ravel()] = (n * TILE_F + m).ravel()
    passes = TILE_F // (THREADS // 32)
    rm = (tid // 32)[:, None] + (THREADS // 32) * np.arange(passes)[None]
    reads = rm * OUT_LD + 4 * (tid % 32)[:, None]
    return writes, tile, reads, rm, 4 * (tid % 32)


def _vector_wavefronts(addr, words):
    """Wavefronts of ``words``-word accesses (threads, instructions): per
    warp and instruction, lanes in groups of 32 / words, each group's most
    distinct words in one bank."""
    n, i = addr.shape
    per = 32 // words
    a = addr.reshape(-1, 32, i).transpose(0, 2, 1).reshape(-1, per)
    a = (a[:, :, None] + np.arange(words)).reshape(a.shape[0], -1)
    total = 0
    for row in a:
        u = np.unique(row)
        total += np.bincount(u % 32, minlength=32).max()
    return total


def _runs(byte_addr, nbytes):
    """Shortest contiguous run of bytes one warp instruction touches:
    byte_addr (threads, instructions) of ``nbytes``-byte accesses."""
    a = byte_addr.reshape(-1, 32, byte_addr.shape[1]).transpose(0, 2, 1)
    best = None
    for row in a.reshape(-1, 32):
        s = np.unique(row)
        cuts = np.flatnonzero(np.diff(s) != nbytes)
        lens = np.diff(np.concatenate([[-1], cuts, [len(s) - 1]]))
        best = min(best or 1 << 30, int(lens.min()) * nbytes)
    return best


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_tf32_rna_rounds_ties_away():
    """Hand-picked ties and near-ties, as cvt.rna.tf32.f32 rounds: the 13
    dropped bits add half an ulp to the magnitude and are cleared."""
    cases = {0x3F801000: 0x3F802000,   # tie -> away from zero
             0xBF801000: 0xBF802000,   # negative tie -> away from zero
             0x3F800FFF: 0x3F800000,   # below the tie -> down
             0x3F801001: 0x3F802000,   # above -> up
             0x3F803000: 0x3F804000,   # tie from an odd tf32 -> away
             0x3F802000: 0x3F802000,   # exact
             0x3FFFF000: 0x40000000,   # carry into the exponent
             0x00000000: 0x00000000}
    x = np.array(list(cases), np.uint32).view(np.float32)
    got = _bits(HK._tf32_rna(x))
    assert got.tolist() == list(cases.values())


@pytest.mark.parametrize("m", [128, 384, 1024])
def test_tf32_tables(m):
    """Six planes: big and small of Fr, Fi, Fr + Fi; low 13 bits zero,
    big + small = F to 2^-22 relative, each rounded as cvt.rna rounds."""
    planes = HK._dense_tables(m, "tf32x3")
    assert planes.shape == (6, m, m) and planes.dtype == np.float32
    assert not (_bits(planes) & 0x1FFF).any()
    for x, big, small in zip(HK._dense_dft(m), planes[0::2], planes[1::2]):
        assert np.array_equal(big, HK._tf32_rna(x))
        assert np.array_equal(small, HK._tf32_rna(x - big))
        err = np.abs(big.astype(np.float64) + small - x)
        assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("m", [128, 384])
def test_bf16_tables(m):
    """Three planes: Fr, Fi and their float32 sum rounded to bf16, bit for
    bit torch's float32 -> bfloat16 (round to nearest even)."""
    planes = HK._dense_tables(m, "bf16x1")
    assert planes.shape == (3, m, m) and planes.dtype == np.int16
    for got, x in zip(planes, HK._dense_dft(m)):
        want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
        assert np.array_equal(got, want.numpy())
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F80FFFF],
                    np.uint32).view(np.float32)
    want = torch.from_numpy(ties).to(torch.bfloat16).view(torch.int16)
    assert np.array_equal(HK._bf16_bits(ties), want.numpy())


def test_tables_clear_drops_dense_tables():
    """tables.clear() drops the split planes and their device copies."""
    from kofft_tpu_torch.ops import _complex
    HK.const(HK._dense_tables(128, "tf32x3"), "cpu")
    HK._dense_tables(128, "bf16x1")
    assert len(tables) > 0 and _complex._CONST
    tables.clear()
    assert len(tables) == 0 and not _complex._CONST
    assert HK._dense_tables(128, "tf32x3").shape == (6, 128, 128)


# ---------------------------------------------------------------------------
# the emulated kernels
# ---------------------------------------------------------------------------

def _rna(x):
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16_np(x):
    """float32 -> bf16 values (float32), round to nearest even, by bit
    arithmetic independent of the port."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def _f_planes(nf, mode):
    t = HK._dense_tables(nf, mode)
    if mode == "bf16x1":
        return (t.astype(np.int32) << 16).astype(np.uint32).view(np.float32)
    return t


def _emulate(xr, xi, mode, stage_b, w=None):
    """One dense kernel launch over (b, ...) float32 planes, as the kernel
    indexes memory: stage a reads X (b, nf, nd), stage b X (b, nd, nf);
    returns Y (b, nf, nd)."""
    g = _geo(mode, stage_b)
    b = xr.shape[0]
    nf = xr.shape[2] if stage_b else xr.shape[1]
    nd = xr.shape[1] if stage_b else xr.shape[2]
    nb, mb, bk = nd // TILE_D, nf // TILE_F, g["bk"]
    f = _f_planes(nf, mode)
    frow, fk, _, _ = _f_image(g)
    brow, bkk = _b_read(g, frow, fk)
    img_k, img_n, _, _ = _data_image(g)
    addrs, lines, ks = _frag_addrs(g)
    words = _frag_words(g)
    every = (addrs[:, :, None] + np.arange(words)).reshape(THREADS, -1)
    # the fragment values: each (line, k) of the warpgroups' 128 lines
    ak = np.full((TILE_D, bk), -1)
    an = np.full((TILE_D, bk), -1)
    ak[lines, ks] = img_k[every]
    an[lines, ks] = img_n[every]
    assert (ak == np.arange(bk)[None]).all()
    assert (an == np.arange(TILE_D)[:, None]).all()
    re_ = np.zeros((b, nb * TILE_D, mb * TILE_F))
    im_ = np.zeros_like(re_)
    nglob = np.arange(nb)[:, None, None] * TILE_D + an[None]
    # the B operand of plane q as (bk, 64): element (j step + kk, r) is the
    # tile's (row, k) that the descriptor read of k step j finds
    rows = brow.transpose(0, 1, 3, 2).reshape(g["planes"], bk, TILE_F)
    cols = bkk.transpose(0, 1, 3, 2).reshape(g["planes"], bk, TILE_F)
    mglob = np.arange(mb)[:, None, None] * TILE_F
    for s in range(nf // bk):
        kglob = s * bk + ak[None]
        if stage_b:
            dr, di = xr[:, nglob, kglob], xi[:, nglob, kglob]
        else:
            dr, di = xr[:, kglob, nglob], xi[:, kglob, nglob]
        # (bk, mb * 64): block mb's operand in columns mb * 64 + r
        bmat = [f[q][mglob + rows[q][None], s * bk + cols[q][None]]
                .transpose(1, 0, 2).reshape(bk, mb * TILE_F)
                for q in range(g["planes"])]
        ops = []
        for p in range(3):
            x = (dr, di, dr + di)[p].reshape(b, nb * TILE_D, bk)
            if g["bf16"]:
                t_ = _bf16_np(x) @ bmat[p]
            else:
                big = _rna(x)
                small = _rna(x - big)
                fb, fs = bmat[2 * p], bmat[2 * p + 1]
                t_ = big @ (fb + fs) + small @ fb
            ops.append(t_.astype(np.float64))
        re_ += ops[0] - ops[1]
        im_ += ops[2] - ops[0] - ops[1]
    # epilogue: the tile written by the accumulators, read back in rows
    _, tile, _, rm, col = _epilogue()
    ln_n = tile[rm[:, :, None], col[:, None, None] + np.arange(4)] // TILE_F
    ln_m = tile[rm[:, :, None], col[:, None, None] + np.arange(4)] % TILE_F
    assert (ln_m == rm[:, :, None]).all()
    assert (ln_n == col[:, None, None] + np.arange(4)).all()
    yr = re_.transpose(0, 2, 1)
    yi = im_.transpose(0, 2, 1)
    if w is not None:
        wr, wi = (a.astype(np.float64) for a in w)
        yr, yi = yr * wr - yi * wi, yr * wi + yi * wr
    return yr, yi


def _c(r, i):
    return np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2,) + tuple(shape)).astype(np.float32)
    return a[0], a[1]


@pytest.fixture
def tier():
    yield lambda name: (tcfg.set_precision(name), jcfg.set_precision(name))
    tcfg.set_precision(None)
    jcfg.set_precision(None)


@pytest.mark.parametrize("b,n1,n2", [(1, 128, 128), (2, 384, 128),
                                     (1, 1024, 1024)])
def test_emulated_pair_vs_plain_and_numpy(b, n1, n2):
    """`highest` (tf32x3): each emulated stage against its plain version,
    the emulated pair against np.fft."""
    ar, ai = _planes((b, n1, n2), n1 + b)
    w = tables.twiddle(n1, n2)
    cr, ci = _emulate(ar, ai, "tf32x3", False, w)
    pr, pi = HK.dense_stage_a_plain(torch.as_tensor(ar), torch.as_tensor(ai))
    assert snr_db(_c(pr, pi), _c(cr, ci)) >= PORT_DB
    c32 = (cr.astype(np.float32), ci.astype(np.float32))
    yr, yi = _emulate(*c32, "tf32x3", True)
    qr, qi = HK.dense_stage_b_plain(*(torch.as_tensor(a) for a in c32))
    assert yr.shape == (b, n2, n1)
    assert snr_db(_c(qr, qi), _c(yr, yi)) >= PORT_DB
    ref = np.fft.fft(_c(ar, ai).reshape(b, -1), axis=-1)
    assert snr_db(ref, _c(yr, yi).reshape(b, -1)) >= ORACLE_DB


@pytest.mark.parametrize("b,n1,n2", [(1, 128, 128), (2, 384, 128)])
def test_emulated_bf16_pair_vs_plain(tier, b, n1, n2):
    """`default` (bf16x1): the emulated stages against the plain versions,
    which round the same operands."""
    tier("default")
    ar, ai = _planes((b, n1, n2), n2 + b)
    cr, ci = _emulate(ar, ai, "bf16x1", False, tables.twiddle(n1, n2))
    pr, pi = HK.dense_stage_a_plain(torch.as_tensor(ar), torch.as_tensor(ai))
    assert snr_db(_c(pr, pi), _c(cr, ci)) >= BF16_PLAIN_DB
    c32 = (pr.numpy(), pi.numpy())
    yr, yi = _emulate(*c32, "bf16x1", True)
    qr, qi = HK.dense_stage_b_plain(pr, pi)
    assert snr_db(_c(qr, qi), _c(yr, yi)) >= BF16_PLAIN_DB


@pytest.mark.parametrize("mode", ["tf32x3", "bf16x1"])
@pytest.mark.parametrize("stage_b", [False, True])
def test_shared_memory_is_conflict_free(mode, stage_b):
    """Every 4-byte fragment load and epilogue write is one wavefront per
    warp, every 8-byte fragment load two, every 16-byte cp.async write and
    float4 epilogue read four; the operand images are permutations of
    their tiles."""
    g = _geo(mode, stage_b)
    warps = THREADS // 32
    addrs, _, _ = _frag_addrs(g)
    words = _frag_words(g)
    assert _vector_wavefronts(addrs, words) == words * warps * addrs.shape[1]
    img_k, _, dwords, _ = _data_image(g)
    assert (img_k >= 0).sum() == g["rows"] * (g["bk"] if g["stage_b"]
                                             else TILE_D)
    assert _vector_wavefronts(dwords, 4) == 4 * warps * dwords.shape[1]
    frow, _, fbytes, _ = _f_image(g)
    assert (frow >= 0).all()
    assert _vector_wavefronts(fbytes // 4, 4) == 4 * warps * fbytes.shape[1]
    writes, tile, reads, _, _ = _epilogue()
    assert _wavefronts(writes) == warps * 32
    assert np.unique(writes).size == writes.size
    assert (tile[:, :TILE_D] >= 0).all()
    assert _vector_wavefronts(reads, 4) == 4 * warps * reads.shape[1]


@pytest.mark.parametrize("mode", ["tf32x3", "bf16x1"])
@pytest.mark.parametrize("stage_b", [False, True])
def test_global_runs_and_fit(mode, stage_b):
    """Every warp's cp.async sources and row stores cover >= 128-byte
    runs, the B read sees exactly the F tile, and two stages fit a
    block's shared memory with the epilogue tile inside one."""
    g = _geo(mode, stage_b)
    nf = nd = 1024
    frow, fk, _, fsrc = _f_image(g)
    brow, bkk = _b_read(g, frow, fk)
    steps = g["bk"] // g["step"]
    assert (brow == np.arange(TILE_F)[None, None, :, None]).all()
    assert (bkk == (g["step"] * np.arange(steps)[:, None, None]
                    + np.arange(g["step"]))[None]).all()
    f_bytes = np.stack([(r * nf * g["esize"] + c) for _, r, c in fsrc], 1)
    assert _runs(f_bytes, 16) >= 128
    _, _, _, dsrc = _data_image(g)
    row_len = nf if stage_b else nd
    d_bytes = np.stack([(r * row_len + c) * 4 for r, c in dsrc], 1)
    assert _runs(d_bytes, 16) >= 128
    _, _, reads, rm, col = _epilogue()
    out = (rm * nd + col[:, None]) * 4
    assert _runs(out, 16) >= 512
    assert g["smem"] <= SMEM_MAX
    assert 2 * TILE_F * OUT_LD * 4 <= g["stage"]


def test_served_shapes_fit_the_tiles():
    """Every split the pair serves divides into the kernel's tiles and K
    slices; other shapes are refused."""
    for n1, n2 in POW2_SPLITS + SMOOTH_SPLITS:
        for nf, nd in ((n1, n2), (n2, n1)):
            assert nd % TILE_D == 0 and nf % TILE_F == 0
            assert nf % _geo("bf16x1", False)["bk"] == 0
            assert max(nf, nd) <= 8192
        HK._check_dense(torch.empty((1, n1, n2), device="meta"), "dense")
    with pytest.raises(HK.InvalidValueError):
        HK._check_dense(torch.empty((1, 192, 128), device="meta"), "dense")
    with pytest.raises(HK.InvalidValueError):
        HK._check_dense(torch.empty((1, 128, 16384), device="meta"), "dense")


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mode", [("highest", "tf32x3"),
                                       ("high", "tf32x3"),
                                       ("default", "bf16x1")])
def test_tier_selects_the_instance(tier, name, mode):
    """Each tier selects its instance and launch-count name; the CPU runs
    the plain versions and launches nothing."""
    tier(name)
    assert HK._dense_mode() == mode
    want = {"tf32x3": ("dense_stage_a", "dense_stage_b"),
            "bf16x1": ("dense_stage_a_bf16x1", "dense_stage_b_bf16x1")}
    assert tuple(HK._dense_name(k, mode) for k in
                 ("dense_stage_a", "dense_stage_b")) == want[mode]
    assert set(want[mode]) <= set(HK.launches)
    HK.reset_counts()
    xr, xi = (torch.as_tensor(a) for a in _planes((1 << 14,), 5))
    HK.fused_four_step_fft(xr, xi, 1 << 14)
    assert HK.classes["four_step"] == 1
    assert all(v == 0 for v in HK.launches.values())


@pytest.mark.parametrize("shape", [(1 << 14,), (2, 3 << 14)])
def test_default_tier_pair_vs_float64(tier, shape):
    """`default`: the port's plain pair and JAX's _build(..., "default")
    each against float64 at the tier's floor, and each of the port's plain
    stages against an independent numpy bf16 emulation of the kernel's
    rounding."""
    tier("default")
    n = shape[-1]
    b = shape[0] if len(shape) == 2 else 1
    xr, xi = _planes(shape, n)
    ref = np.fft.fft(_c(xr, xi), axis=-1)
    tr, ti = HK.fused_four_step_fft(torch.as_tensor(xr),
                                    torch.as_tensor(xi), n)
    got = _c(tr, ti)
    assert snr_db(ref, got) >= DEFAULT_DB
    n1, n2, stage_a, stage_b = PK._build(n, "float32", True, "default")
    ar, ai = (jnp.asarray(a.reshape(b, n1, n2)) for a in (xr, xi))
    jr, ji = stage_b(b, *stage_a(b, ar, ai))
    assert snr_db(ref, _c(jr, ji).reshape(shape)) >= DEFAULT_DB
    # numpy: bf16 operands and Gauss sums, float64 products and sums
    f1r, f1i = (a.astype(np.float64) for a in tables.dft_matrix(n1))
    f2r, f2i = (a.astype(np.float64) for a in tables.dft_matrix(n2))
    wr, wi = (a.astype(np.float64) for a in tables.twiddle(n1, n2))

    def gauss(fr, fi, dr, di):
        bf = _bf16_np
        fs = (fr + fi).astype(np.float32)
        t1 = bf(fr).T @ bf(dr)
        t2 = bf(fi).T @ bf(di)
        t3 = bf(fs).T @ bf((dr + di).astype(np.float32))
        return t1 - t2, t3 - t1 - t2

    # each plain stage on the same input as the emulation: a C that
    # differs in its last float32 bit may round to another bf16 value
    a3 = [torch.as_tensor(a.reshape(b, n1, n2)) for a in (xr, xi)]
    pr, pi = HK.dense_stage_a_plain(*a3)
    qr, qi = HK.dense_stage_b_plain(pr, pi)
    for z in range(b):
        cr, ci = gauss(f1r, f1i, xr.reshape(b, n1, n2)[z],
                       xi.reshape(b, n1, n2)[z])
        emu = (cr * wr - ci * wi) + 1j * (cr * wi + ci * wr)
        assert snr_db(emu, _c(pr[z], pi[z])) >= BF16_PLAIN_DB
        emu = _c(*gauss(f2r, f2i, pr[z].numpy().T, pi[z].numpy().T))
        assert snr_db(emu, _c(qr[z], qi[z])) >= BF16_PLAIN_DB
