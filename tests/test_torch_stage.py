"""The stage kernels of the 1-D four-step FFT (csrc/fft_stages.cu on the
register radix line of csrc/radix_line.cuh), emulated in numpy as the
kernels index memory: stage 1's column tiles with the four-step twiddle
fused into the store (float2 factor tables), its cluster of 16 CTAs per
16-column tile at n1 = 4096 and 8192 (each CTA's line FFT of n1 / 16, the
twiddle w_n1^(r k), the exchange between the CTAs, the radix-16 DFTs and
W, factored at n1 / 16, on the store to the rows each CTA loaded), stage 2's
whole-line tiles with the transposed store through the swizzled exchange
buffer, its cluster of eight one-line CTAs at lines of 4096 and 8192
(each point sent to the CTA that stores its output row, the cluster's
first barrier arrived at after the last exchange), the one-sided store
with the
Nyquist bin, and conj on both sides; and stage 1 of a smooth n1 = o * q
(csrc/stage1_odd.cu): the sub-lines of q in thread groups, exchanged in
their sub-tiles, and the odd pass with its own thread map and the pair-form
butterfly on the header's float32 constants. Over every split that
``_pow2_split`` gives from 2^14 to 2^26, and every smooth n1 it gives,
the launches fit a block, every warp's global loads and stores cover
>= 32-byte runs, and every shared-memory exchange is one wavefront per
warp access. The kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: the emulation runs in float64 on the float32 tables, so it
differs from the float64 FFT only by the tables' rounding: > 140 dB. The
JAX Pallas kernels (interpret mode) are float32 evaluations: >= 110 dB
against the emulation, as port against JAX elsewhere.
"""

import re

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_axis import CSRC, _c64, _wavefronts  # noqa: E402
from test_torch_axis import _cluster_addrs  # noqa: E402
from test_torch_axis import _data as _data32  # noqa: E402

from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

EMU_DB = 140.0
PORT_DB = 110.0
E = HK._STAGE_E
SMEM_MAX = 227 * 1024
POW2_SPLITS = [HK._pow2_split(1 << k) for k in range(14, 27)]
# every smooth n1 = o * 2^a of _pow2_split from 3*2^14 to 2^26
SMOOTH_N1 = [384, 768, 1536, 3072, 640, 1280, 2560, 896, 1792, 1152, 2304,
             1408, 2816, 1664, 1920, 2176, 2432, 2688, 2944]


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
# stage 1: column tiles of one block, or a cluster of 16 CTAs per tile
# ---------------------------------------------------------------------------

def _s1_index(rows, m, inner, blocks):
    """stage1_kernel's indexing over the (rows, m, inner) view for the
    given blocks: (T, block row (blocks, 1), column (blocks, threads),
    line point k (threads, E), and the load offsets (blocks, threads, E),
    which are also the store offsets)."""
    t, e = HK._axis_tile("col", m, inner)
    assert e == E
    c, ti = HK._axis_lanes("col", m, t, E)
    tpl = m // E
    tiles = inner // t
    row = (blocks // tiles)[:, None]
    col = (blocks % tiles)[:, None] * t + c
    s = np.arange(E) * tpl
    g = (row * m * inner + ti * inner + col)[..., None] + s * inner
    return t, row, col, ti[:, None] + s, g


def _emu_s1_launch(a, out, conj, w):
    """One stage1_kernel launch over the (rows, m, inner) view ``a``, into
    the flat ``out``: conj on load and the four-step twiddle ``w = (base,
    col)`` (float2 factor tables) on the store, as the kernel indexes
    them."""
    rows, m, inner = a.shape
    t, _ = HK._axis_tile("col", m, inner)
    blocks = np.arange(rows * (inner // t))
    t, row, col, k, g = _s1_index(rows, m, inner, blocks)
    v = a.reshape(-1)[g]
    if conj:
        v = v.conj()
    v = _radix_blocks("col", m, t, v, HK._axis_plan("col", m, t, E))
    out[g] = v * _w_factor(w, m, inner, k[None], col[..., None])


def _s1_cluster_index(b, m, inner, ctas):
    """stage1_cluster_kernel's indexing over (b, m, inner) for the given
    CTAs (blockIdx.x): (C, T, M = m / C, each CTA's rank (ctas,), column
    (ctas, threads), the load offsets (ctas, threads, E), which are also
    the store offsets (load i and store s of a thread: row rank + C*ti +
    M*i), the exchange's destination CTA (ctas, threads, E) and word of
    each point there, and the words each thread reads back (threads,
    C))."""
    csize, t = HK._cluster_tile(m, inner)
    mc = m // csize
    c, ti = HK._axis_lanes("col", mc, t, E)
    tpl = mc // E
    rank = ctas % csize
    tiles = inner // t
    row = (ctas // csize) // tiles
    col = ((ctas // csize) % tiles)[:, None] * t + c
    g = ((row[:, None] * m * inner + col + (rank[:, None] + csize * ti)
          * inner)[..., None] + np.arange(E) * mc * inner)
    k = ti[:, None] + np.arange(E) * tpl
    # a0 + i * kstep of the kernel: word (rank*tpl + ti/C + i*tpl/C)*T + c
    # of CTA ti mod C, the point's k / C in its slice
    word = ((rank[:, None, None] * tpl + k[None] // csize) * t
            + c[None, :, None])
    dest = (ctas - rank)[:, None, None] + (ti % csize)[None, :, None]
    dest = np.broadcast_to(dest, word.shape)
    read = (np.arange(csize)[None, :] * tpl + ti[:, None]) * t + c[:, None]
    return csize, t, mc, rank, col, g, dest, word, read


def _emu_s1_cluster(a, conj=False):
    """stage1_cluster_kernel over (b, n1, n2) as it indexes: per CTA r of
    each cluster, rows r + C*(ti + i*tpl) loaded (conj on load), the line
    FFT of n1 / C (``_radix_blocks``), the twiddle w_n1^(r*k), the push
    into the C CTAs' buffers (every word written exactly once, all before
    any read: the cluster barrier), then per CTA q one radix-C DFT a
    thread over the words it reads back, and output s stored times
    wk[k, col] * ws[s, col] (k = q + C*ti) to row k + M*s. Asserts that
    every element of C is stored exactly once."""
    b, m, inner = a.shape
    csize, t = HK._cluster_tile(m, inner)
    ctas = np.arange(b * (inner // t) * csize)
    csize, t, mc, rank, col, g, dest, word, read = _s1_cluster_index(
        b, m, inner, ctas)
    c, ti = HK._axis_lanes("col", mc, t, E)
    v = a.reshape(-1)[g]
    if conj:
        v = v.conj()
    v = _radix_blocks("col", mc, t, v, HK._axis_plan("col", mc, t, E))
    ctw = _c64(HK._split_twiddle(csize, mc)).reshape(csize, mc)
    k = ti[:, None] + np.arange(E) * (mc // E)
    v = v * ctw[rank[:, None, None], k[None]]
    buf = np.full((ctas.size, mc * t), np.nan, complex)
    hits = np.zeros(buf.shape, np.int64)
    np.add.at(hits, (dest, word), 1)
    assert (hits == 1).all()
    buf[dest, word] = v
    u = buf[ctas[:, None, None], read[None]]
    assert not np.isnan(u).any()
    x = np.fft.fft(u, axis=-1)
    wk, ws = (_c64(f).reshape(-1, inner)
              for f in HK._stage1_cluster_twiddle(m, inner))
    kq = (rank[:, None] + csize * ti)[..., None]
    x = x * wk[kq, col[..., None]] * ws[np.arange(E), col[..., None]]
    out = np.full(a.size, np.nan, complex)
    stores = np.zeros(a.size, np.int64)
    np.add.at(stores, g, 1)
    assert (stores == 1).all()
    out[g] = x
    return out.reshape(a.shape)


def _w_factor(w, m, inner, k1, col):
    """W[k1, col] as the kernels form it from the float2 factor tables
    ``w = (base, col)``."""
    base, fac = (_c64(x) for x in w)
    tw_t = base.size // m
    return fac[k1 * (inner // tw_t) + col // tw_t] * base[k1 * tw_t
                                                         + col % tw_t]


def _odd_consts():
    """radix_line.cuh's odd_w table: {(o, k): (cos, sin)} as float32."""
    src = (CSRC / "radix_line.cuh").read_text()
    found = re.findall(r"case (\d+) \* 32 \+ (\d+):\s*return make_float2"
                       r"\(([-0-9.e]+)f, ([-0-9.e]+)f\);", src)
    return {(int(o), int(k)): (np.float32(c), np.float32(s))
            for o, k, c, s in found}


ODD_W = _odd_consts()
# stage1_odd.cu: up to this o the butterflies store C with W themselves
FUSED_MAX_O = int(re.search(r"constexpr int kFusedMaxO = (\d+);", (
    CSRC / "stage1_odd.cu").read_text()).group(1))


def _dft_odd(u, o):
    """radix_line.cuh's dft_odd<o> along the last axis of u: the pair form
    on the header's float32 constants, in float64 arithmetic."""
    h = o // 2
    a = [u[..., j] + u[..., o - j] for j in range(1, h + 1)]
    d = [u[..., j] - u[..., o - j] for j in range(1, h + 1)]
    x = np.empty(u.shape, complex)
    x[..., 0] = u[..., 0] + sum(a)
    for k in range(1, h + 1):
        big_a, big_b = u[..., 0].copy(), 0
        for j in range(1, h + 1):
            t = j * k % o
            c, s = ODD_W.get((o, min(t, o - t)), (1.0, 0.0))
            big_a = big_a + a[j - 1] * float(c)
            big_b = big_b + d[j - 1] * float(s if t <= h else -s)
        x[..., k] = big_a - 1j * big_b
        x[..., o - k] = big_a + 1j * big_b
    return x


def _odd_layout(m):
    """stage1_odd_kernel's block: (T, P, o, q, threads per sub-line q / 16,
    group size, block threads, and each group thread's column c and line
    thread ti)."""
    t, groups = HK._odd_tile(m)
    o = HK._odd_part(m)
    q = m // o
    tpl = q // E
    gsize = t * tpl
    lt = np.arange(gsize)
    return t, groups, o, q, tpl, gsize, groups * gsize, lt % t, lt // t


def _odd_loads(m, inner, row, col0, i):
    """Element offsets (blocks, group threads, E) of sub-line i's loads:
    rows i + o*(ti + s*q/16) of column col0 + c."""
    t, _, o, q, tpl, _, _, c, ti = _odd_layout(m)
    s = np.arange(E) * tpl
    return ((row * m * inner + col0)[:, None, None] + c[None, :, None]
            + (i + o * (ti[None, :, None] + s)) * inner)


def _odd_butterflies(m):
    """The odd pass's butterflies bi = k'*T + c of each block thread,
    (threads, reps), -1 where the thread has none."""
    t, _, _, q, _, _, n, _, _ = _odd_layout(m)
    bi = np.arange(n)[:, None] + np.arange(-(-q * t // n))[None, :] * n
    return np.where(bi < q * t, bi, -1)


def _odd_store_words(m):
    """The store's words k1*T + c of each block thread, (threads, reps):
    column c = thread mod T, rows k1 = thread / T + rep * threads / T
    while k1 < m, -1 after (whole warps: 32 / T rows divide m); each
    word once."""
    t, _, _, _, _, _, n, _, _ = _odd_layout(m)
    tid = np.arange(n)[:, None]
    k1 = tid // t + np.arange(-(-m * t // n))[None, :] * (n // t)
    words = np.where(k1 < m, k1 * t + tid % t, -1)
    live = words[words >= 0]
    assert np.unique(live).size == live.size == m * t
    warps = (words >= 0).reshape(n // 32, 32, -1)
    assert np.all(warps.all(axis=1) | ~warps.any(axis=1))
    return words


def _emu_s1_odd_launch(a, out, conj, w):
    """One stage1_odd_kernel launch over the (rows, m, inner) view ``a``
    (smooth m = o * q), into the flat ``out``: each group's sub-lines i
    loaded from rows i + o*l, the power-of-two passes of the plan on each
    (q, T) sub-tile, the natural-order store times w_m^(i*k') to word
    k'*T + c of the sub-tile, then the odd pass (pair-form butterfly):
    up to FUSED_MAX_O each butterfly stores row k' + q*r times W, above
    it the butterflies write X[k' + q*r] back to word bi of sub-tile r
    and a store pass with W follows."""
    rows, m, inner = a.shape
    t, groups, o, q, tpl, gsize, n, c, ti = _odd_layout(m)
    steps, tab = HK._axis_plan("col", m, t, E)
    steps = steps.reshape(-1, 7)
    radix, ns, off = steps[-1, :3]
    assert (radix, ns) == (o, q)
    otw = _c64(tab)[off:off + q * (o - 1)].reshape(q, o - 1)
    tiles = inner // t
    blocks = np.arange(rows * tiles)
    row, col0 = blocks // tiles, (blocks % tiles) * t
    flat = a.reshape(-1)
    sm = np.full((blocks.size, m * t), np.nan, complex)
    done = []
    k = ti[:, None] + np.arange(E) * tpl
    for g in range(groups):
        for i in range(g, o, groups):
            done.append(i)
            v = flat[_odd_loads(m, inner, row, col0, i)]
            if conj:
                v = v.conj()
            v = _radix_blocks("col", q, t, v, (steps[:-1].ravel(), tab))
            if i:
                v = v * otw[k, i - 1]
            sm[:, i * q * t + k * t + c[:, None]] = v
    assert sorted(done) == list(range(o))
    bi = _odd_butterflies(m)
    bi = bi[bi >= 0]
    words = bi[:, None] + np.arange(o) * q * t
    if o <= FUSED_MAX_O:
        k1 = (bi // t)[:, None] + np.arange(o) * q
        col = col0[:, None, None] + (bi % t)[None, :, None]
        dest = (row * m * inner)[:, None, None] + k1[None] * inner + col
        out[dest] = (_dft_odd(sm[:, words], o)
                     * _w_factor(w, m, inner, k1[None], col))
        return
    sm[:, words] = _dft_odd(sm[:, words], o)
    st = _odd_store_words(m)
    st = st[st >= 0]
    k1, col = st // t, col0[:, None] + st % t
    dest = (row * m * inner)[:, None] + k1 * inner + col
    out[dest] = sm[:, st] * _w_factor(w, m, inner, k1, col)


def _emu_stage1(a, conj=False):
    """stage1 on (b, n1, n2) as it launches: the cluster kernel at the n1
    of ``HK._COL_CLUSTER``, the odd kernel for a smooth n1, else the
    one-block kernel, into C."""
    b, n1, n2 = a.shape
    if n1 in HK._COL_CLUSTER:
        return _emu_s1_cluster(a, conj)
    w = HK._stage1_twiddle(n1, n2)
    out = np.full(a.size, np.nan, complex)
    if n1 & (n1 - 1):
        _emu_s1_odd_launch(a, out, conj, w)
    else:
        _emu_s1_launch(a, out, conj, w)
    return out.reshape(a.shape)


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
                                 (2, 9 << 14), (1, 5 << 14), (1, 7 << 14),
                                 (1, 23 << 14)])
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
                                 (1, 1 << 20), (1, 3 << 14), (1, 5 << 14),
                                 (1, 7 << 14), (1, 23 << 14)])
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
@pytest.mark.parametrize("n", [1 << 14, 3 << 14, 9 << 14])
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
    """Stage 1 above 2048 points: the column FFT as a four-step across a
    cluster of 16 CTAs in one launch (lines of n1 / 16 per CTA, w_n1^(r*k),
    the exchange, radix-16 DFTs), W on the store to the rows each CTA
    loaded; complex forward and inverse, and real input."""
    assert HK._COL_CLUSTER[n1] == HK._cluster_tile(n1, n2) == (16, 16)
    a = _data((b, n1, n2), n1 + n2)
    if real:
        a = a.real.astype(complex)
    assert snr_db(_ref_stage1(a, conj), _emu_stage1(a, conj)) > EMU_DB


@pytest.mark.parametrize("n1", [4096, 8192])
def test_stage1_cluster_exchange_words_written_once_before_read(n1):
    """The push of one cluster of stage 1 writes every word of every CTA's
    exchange buffer exactly once, all before the cluster barrier, and the
    read-back after it reads every word of its CTA once: no word is read
    unwritten or overwritten before it is read. The words are those of
    col_fft's cluster (test_torch_axis._cluster_addrs)."""
    csize, t, mc, rank, _, _, dest, word, read = _s1_cluster_index(
        1, n1, 16, np.arange(16))
    writes = np.zeros((csize, mc * t), np.int64)
    np.add.at(writes, (dest, word), 1)
    assert np.all(writes == 1)
    reads = np.zeros(mc * t, np.int64)
    np.add.at(reads, read.ravel(), 1)
    assert np.all(reads == 1)
    aw, ad, ar = _cluster_addrs(n1, csize, t)
    assert np.array_equal(ar, read)
    for r in range(csize):
        assert np.array_equal(aw(r), word[r])
        assert np.array_equal(np.broadcast_to(ad[:, None], word[r].shape),
                              dest[r])


@pytest.mark.parametrize("n1", [4096, 8192])
def test_stage1_cluster_exchange_has_no_bank_conflicts(n1):
    """Every warp store of the push puts its words for each destination
    CTA in distinct banks, and every warp read-back is one wavefront (the
    exchanges of each CTA's own line FFT: test_stage_exchanges_have_no_
    bank_conflicts)."""
    csize, t, mc, rank, _, _, dest, word, read = _s1_cluster_index(
        1, n1, 16, np.arange(16))
    warps = read.shape[0] // 32
    assert _wavefronts(read) == warps * csize
    lane_warp = np.arange(read.shape[0]) // 32
    for r in range(csize):
        for i in range(E):
            key = lane_warp * csize + dest[r, :, i] % csize
            for kk in np.unique(key):
                banks = word[r, key == kk, i] & 31
                assert np.unique(banks).size == banks.size


@pytest.mark.parametrize("b,n1,n2", [(2, 4096, 32), (1, 8192, 48)])
def test_stage1_cluster_stores_every_row_once(b, n1, n2):
    """Over every CTA of a launch, each element of C (b, n1, n2) is loaded
    once and stored once: every row of each column tile, by the CTA that
    loaded it."""
    csize, t = HK._cluster_tile(n1, n2)
    ctas = np.arange(b * (n2 // t) * csize)
    *_, g, _, _, _ = _s1_cluster_index(b, n1, n2, ctas)
    assert np.array_equal(np.bincount(g.ravel(), minlength=b * n1 * n2),
                          np.ones(b * n1 * n2, np.int64))


@pytest.mark.parametrize("n1,n2", [(4096, 128), (4096, 4096),
                                   (4096, 8192), (8192, 8192)])
def test_stage1_cluster_twiddle_factors_are_w(n1, n2):
    """The cluster's W factors: wk[k, j2] * ws[s, j2] is w_n^((k + M*s) *
    j2), M = n1 / 16, in float64 within the float32 rounding of its two
    factors (each <= 2^-24 * sqrt(2) off), over every k1 = k + M*s and
    j2 (at 8192^2 a sample of rows); each factor is its float64 value
    rounded once to float32."""
    wk, ws = (_c64(f).reshape(-1, n2)
              for f in HK._stage1_cluster_twiddle(n1, n2))
    m = n1 // 16
    assert wk.shape == (m, n2) and ws.shape == (16, n2)
    n = n1 * n2
    j2 = np.arange(n2)
    ks = np.arange(m) if n1 * n2 <= 1 << 24 else np.arange(0, m, 7)
    exact = np.exp(-2j * np.pi * np.mod(np.outer(ks, j2), n) / n)
    assert np.array_equal(wk[ks], exact.astype(np.complex64))
    bound = 2 * np.sqrt(2) * 2.0 ** -24
    for s in range(16):
        k1 = ks + m * s
        want = np.exp(-2j * np.pi * np.mod(np.outer(k1, j2), n) / n)
        assert np.abs(wk[ks] * ws[s] - want).max() <= bound


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
    assert (t, cs) == (8, 8)
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


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("n2", [4096, 8192])
def test_cluster8_stores_every_bin_once(n2, half):
    """Over every CTA of a (2, 16, n2) launch on the cluster of eight
    one-line CTAs, each output bin is stored exactly once: every (k2, k1)
    of (b, n2, n1), or, one-sided, every flat bin k <= n/2 of (b, n/2 +
    1), the Nyquist bin of each batch row included."""
    b, n1 = 2, 16
    t, tc = HK._stage2_tile(n2)
    blocks = np.arange(b * (n1 // t) * (t // tc))
    *_, k, row = _s2_index(b, n1, n2, blocks)
    rows = np.broadcast_to(row[:, None, None], k.shape)
    n = n1 * n2
    if half:
        keep = k <= n // 2
        flat = rows[keep] * (n // 2 + 1) + k[keep]
        size = b * (n // 2 + 1)
    else:
        flat = (rows * n + k).ravel()
        size = b * n
    assert np.array_equal(np.bincount(flat, minlength=size),
                          np.ones(size, np.int64))


@pytest.mark.parametrize("n2", [4096, 8192])
def test_cluster8_exchange_words_written_once_before_read(n2):
    """The push of one cluster (eight CTAs, one line each) writes every
    word of every CTA's exchange buffer exactly once, and the read-back
    after the second barrier reads every word once, each of them written:
    no word is read unwritten or overwritten before it is read."""
    n1 = 8
    t, tc = HK._stage2_tile(n2)
    cs = t // tc
    assert tc == 1 and cs == 8
    blocks = np.arange(cs)
    _, _, _, _, _, dest, word, idx, _, _ = _s2_index(1, n1, n2, blocks)
    sw = tuple(HK._stage2_plan(n2, t, tc)[0].reshape(-1, 7)[-1, 3:])
    words = tc * n2
    writes = np.zeros((cs, words), np.int64)
    np.add.at(writes, (dest, HK._swizzle(word, sw)), 1)
    assert np.all(writes == 1)
    sl = n2 // cs
    reads = np.zeros((cs, words), np.int64)
    phys = np.broadcast_to(HK._swizzle((idx % t) * sl + idx // t, sw),
                           (cs,) + idx.shape)
    np.add.at(reads, (np.broadcast_to(blocks[:, None, None], phys.shape),
                      phys), 1)
    assert np.all(reads == 1)


@pytest.mark.parametrize("n2", [4096, 8192])
def test_cluster8_ctas_share_an_sm_as_row_fft_blocks(n2):
    """Each CTA of the cluster holds one whole line: n2/16 threads and
    8 * n2 bytes of exchange buffer, as row_fft's block for the same line;
    at 64 registers a thread (the cluster instances' launch bound of 512
    threads, two per SM) four CTAs of lines of 4096 fit an SM's 65536
    registers and 227 KB, and two of lines of 8192."""
    t, tc = HK._stage2_tile(n2)
    threads = tc * n2 // E
    smem = 8 * n2 * tc
    assert (threads, smem) == (n2 // E, 8 * n2)
    assert (threads, smem) == (HK._axis_tile("row", n2, 1 << 20)[0] * n2
                               // E, HK._axis_smem(n2, 1))
    per_sm = min(65536 // (64 * threads), SMEM_MAX // smem, 2048 // threads)
    assert per_sm == {4096: 4, 8192: 2}[n2]


@pytest.mark.parametrize("n2", [4096, 8192])
def test_cluster_arrival_follows_the_last_exchange(n2):
    """The cluster kernel arrives at its first cluster barrier on the
    block barrier numbered 2 * npass - 2 of line_fft: each pass but the
    last exchanges through the buffer between two block barriers
    (radix_line.cuh), so that one is the barrier after the last
    exchange's read-back, when the buffer is free for the peers' push;
    the wait comes after the last radix pass, before the push."""
    steps, _ = HK._stage2_plan(n2, *HK._stage2_tile(n2))
    npass = len(steps) // 7
    line = (CSRC / "radix_line.cuh").read_text()
    body = line[line.index("radix_pass(float2"):line.index("// The whole line")]
    assert body.count("sync();") == 2
    assert body.index("if (last) return;") < body.index("sync();")
    src = (CSRC / "fft_stages.cu").read_text()
    assert "ArriveAfterLastExchange{2 * plan.npass - 2}" in src
    assert 2 * npass - 2 == 2 * (npass - 1) >= 2
    kern = src[src.index("stage2_kernel(const TIn*"):]
    assert (kern.index("ArriveAfterLastExchange{")
            < kern.index("barrier.cluster.wait.acquire.aligned")
            < kern.index("each_from<0>(push)"))


# ---------------------------------------------------------------------------
# every split the routes use: fit, coalescing, bank conflicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n1,n2", POW2_SPLITS)
def test_stage_launches_fit(n1, n2):
    """Every stage launch fits: stage 1 one block of <= 1024 threads and
    <= 227 KB of shared memory tiling >= 8 columns up to 2048 points, and
    above (4096, 8192) one launch of a cluster of 16 CTAs per 16-column
    tile, each CTA <= 512 threads and 64 KB (four CTAs per SM at 4096 and
    two at 8192 at 64 registers a thread, the launch bound), where one
    block's tile would not fit; stage 2 tiles >= 8 lines, in a cluster of
    <= 8 CTAs from lines of 4096."""
    if n1 in HK._COL_CLUSTER:
        csize, t = HK._cluster_tile(n1, n2)
        assert (csize, t) == (16, 16) and n2 % t == 0 and n1 > 2048
        threads, smem = t * n1 // csize // E, 8 * (n1 // csize) * t
        assert threads <= 512 and smem <= SMEM_MAX
        per_sm = min(65536 // (64 * threads), SMEM_MAX // smem,
                     2048 // threads)
        assert per_sm == {4096: 4, 8192: 2}[n1]
        with pytest.raises(ValueError):
            HK._axis_tile("col", n1, n2)
    else:
        assert n1 <= 2048
        t, e = HK._axis_tile("col", n1, n2)
        assert e == E and t >= 8 and n2 % t == 0
        assert t * n1 // E <= 1024 and HK._axis_smem(n1, t) <= SMEM_MAX
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
    """Each warp of the stage-1 launch loads and stores float32 planes in
    runs of >= 32 bytes that fill whole sectors (T >= 8 consecutive
    columns of a row; the cluster's 16 columns of two rows); the cluster's
    W factor loads are runs of 16 float2 (128 bytes)."""
    if n1 not in HK._COL_CLUSTER:
        t, _ = HK._axis_tile("col", n1, n2)
        blocks = _edge_blocks(2 * (n2 // t))
        g = _s1_index(2, n1, n2, blocks)[-1]
        assert _min_run_bytes(g) >= 32 and _sectors_ideal(g)
        return
    csize, t = HK._cluster_tile(n1, n2)
    ctas = _edge_blocks(2 * (n2 // t) * csize)
    _, _, mc, rank, col, g, _, _, _ = _s1_cluster_index(2, n1, n2, ctas)
    assert _min_run_bytes(g) >= 64 and _sectors_ideal(g)
    _, ti = HK._axis_lanes("col", mc, t, E)
    wk = ((rank[:, None] + csize * ti) * n2 + col)[..., None]
    ws = col[..., None] + np.arange(E) * n2
    assert _min_run_bytes(wk, elt=8) >= 128
    assert _min_run_bytes(ws, elt=8) >= 128


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
    both stages (stage 1's of each CTA's line FFT on the cluster path),
    stage 2's transposed exchange included (its writes from every CTA of a
    cluster), is one wavefront under the plan's swizzle."""
    def check(w, r, sw):
        warps = -(-w.shape[0] // 32)
        for acc in (w, r):
            phys = HK._swizzle(acc, tuple(sw))
            assert _wavefronts(phys) == warps * acc.shape[1]

    if n1 in HK._COL_CLUSTER:
        csize, t = HK._cluster_tile(n1, n2)
        m = n1 // csize
    else:
        m, t = n1, HK._axis_tile("col", n1, n2)[0]
    steps = HK._axis_plan("col", m, t, E)[0].reshape(-1, 7)
    for radix, ns, _, *sw in steps[:-1]:
        check(*HK._exchange_addrs("col", m, t, E, radix, ns), sw)
    t, tc = HK._stage2_tile(n2)
    steps = HK._stage2_plan(n2, t, tc)[0].reshape(-1, 7)
    for radix, ns, _, *sw in steps[:-1]:
        check(*HK._exchange_addrs("row", n2, tc, E, radix, ns), sw)
    for rank in range(t // tc):
        w, r = HK._transpose_addrs(n2, t, tc, rank)
        check(w, r, steps[-1, 3:])
        phys = HK._swizzle(r, tuple(steps[-1, 3:]))
        assert np.unique(phys).size == phys.size == n2 * tc


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


# ---------------------------------------------------------------------------
# stage 1 of a smooth n1: the odd butterflies, and at every smooth n1 the
# plan, the fit, the coalescing and the bank conflicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("o", list(range(3, 24, 2)))
def test_odd_butterfly_is_the_dft(o):
    """dft_odd<o>'s constants are cos and sin(2 pi k / o) rounded once from
    float64 to float32, and its pair form with them is the DFT of o points
    (float64 arithmetic: > 140 dB)."""
    for k in range(1, o // 2 + 1):
        assert ODD_W[(o, k)] == (np.float32(np.cos(2 * np.pi * k / o)),
                                 np.float32(np.sin(2 * np.pi * k / o)))
    u = _data((64, o), o)
    assert snr_db(np.fft.fft(u, axis=-1), _dft_odd(u, o)) > EMU_DB


def test_smooth_n1_are_the_splits():
    """The smooth n1 of every n = o * 2^k that _pow2_split serves are the
    19 lengths o * 2^a, 2^a in [128, 1024], o * 2^a <= 3072, and stage 1
    runs each as one launch of the odd plan (P > 0 sub-line groups), not
    on the cluster path."""
    got = {HK._pow2_split(o << k)[0] for o in range(3, 24, 2)
           for k in range(7, 27) if HK._pow2_split(o << k) is not None}
    assert sorted(x for x in got if x & (x - 1)) == sorted(SMOOTH_N1)
    cpu = torch.device("cpu")
    for n1 in SMOOTH_N1:
        assert n1 not in HK._COL_CLUSTER
        t, groups = HK._build_args("stage1", 1, n1, 128, cpu)[2:4]
        assert (t, groups) == HK._odd_tile(n1) and groups > 0
    for bad in (3 * 64, 25 * 128, 3 * 2048, 5 * 1024):
        with pytest.raises(ValueError):
            HK._odd_tile(bad)


@pytest.mark.parametrize("n1", SMOOTH_N1)
def test_odd_plan_fits_a_block(n1):
    """The plan's radices multiply to n1 (power-of-two passes of q, Ns
    their product, then radix o at Ns = q); the block has <= 768 threads
    (80 registers each) in P <= 15 groups of whole warps that cover the o
    sub-lines in the fewest rounds, its (n1, 8) buffer <= 227 KB."""
    t, groups, o, q, _, gsize, n, _, _ = _odd_layout(n1)
    steps = HK._axis_plan("col", n1, t, E)[0].reshape(-1, 7)
    assert list(steps[:, 0]) == HK._radices(q) + [o]
    assert int(np.prod(steps[:, 0])) == n1
    assert list(steps[:, 1]) == list(np.cumprod([1, *steps[:-1, 0]]))
    assert t >= 8 and gsize % 32 == 0 and n <= 768
    assert 1 <= groups <= min(o, 15)
    assert -(-o // groups) == -(-o // min(o, 15, 768 // gsize))
    assert 8 * n1 * t <= SMEM_MAX
    assert HK._axis_smem(n1, t) == 8 * n1 * t


@pytest.mark.parametrize("n1", SMOOTH_N1)
def test_odd_accesses_coalesce(n1):
    """Each warp loads every sub-line and stores C (from the butterflies up
    to FUSED_MAX_O, from the store pass above) in float32 runs of >= 32
    bytes that fill whole sectors: 8 consecutive columns per row."""
    inner = 256
    t, groups, o, q, _, gsize, n, _, _ = _odd_layout(n1)
    blocks = _edge_blocks(2 * (inner // t))
    tiles = inner // t
    row, col0 = blocks // tiles, (blocks % tiles) * t
    for i in range(o):
        g = _odd_loads(n1, inner, row, col0, i)
        assert _min_run_bytes(g) >= 32 and _sectors_ideal(g)
    if o <= FUSED_MAX_O:
        bi = _odd_butterflies(n1)
        for rep in range(bi.shape[1]):
            live = bi[:, rep] >= 0
            kp, cc = bi[:, rep] // t, bi[:, rep] % t
            for r in range(o):
                dest = ((row * n1 * inner + col0)[:, None]
                        + (kp + r * q) * inner + cc)[..., None]
                mask = np.broadcast_to(live[None, :, None], dest.shape)
                assert _min_run_bytes(dest, mask=mask) >= 32
                if live.all():
                    assert _sectors_ideal(dest)
        return
    st = _odd_store_words(n1)
    live = st[:, (st >= 0).all(axis=0)]
    dest = ((row * n1 * inner + col0)[:, None, None]
            + (live // t)[None] * inner + (live % t)[None])
    assert _min_run_bytes(dest) >= 32 and _sectors_ideal(dest)
    mask = np.broadcast_to((st >= 0)[None], (row.size,) + st.shape)
    dest = ((row * n1 * inner + col0)[:, None, None]
            + (st // t)[None] * inner + (st % t)[None])
    assert _min_run_bytes(dest, mask=mask) >= 32


@pytest.mark.parametrize("n1", SMOOTH_N1)
def test_odd_exchanges_have_no_bank_conflicts(n1):
    """Whole blocks: every warp-wide access to the shared tile is one
    wavefront: the power-of-two passes' exchanges in a sub-tile under the
    plan's swizzles, the store of Y_i[k'] to word k'*T + c of sub-tile i,
    the odd pass's reads of word i*q*T + bi, and above FUSED_MAX_O its
    writes there and the store pass's reads."""
    t, groups, o, q, tpl, gsize, n, c, ti = _odd_layout(n1)
    steps = HK._axis_plan("col", n1, t, E)[0].reshape(-1, 7)
    for radix, ns, _, *sw in steps[:-2]:
        for acc in HK._exchange_addrs("col", q, t, E, radix, ns):
            phys = HK._swizzle(acc, tuple(sw))
            assert _wavefronts(phys) == (gsize // 32) * acc.shape[1]
            assert np.unique(phys).size == phys.size
    sub = q * t
    for g in range(groups):
        for i in range(g, o, groups):
            st = i * sub + (ti[:, None] + np.arange(E) * tpl) * t + c[:, None]
            assert _wavefronts(st) == (gsize // 32) * E
    assert tuple(steps[-2, 3:]) == tuple(steps[-1, 3:]) == (0, 5, 0, 5)
    bi = _odd_butterflies(n1)
    for i in range(o):
        rd = np.where(bi >= 0, i * sub + bi, i * sub)
        assert _wavefronts(rd) == (n // 32) * bi.shape[1]
    if o <= FUSED_MAX_O:
        return
    st = _odd_store_words(n1)
    for rep in range(st.shape[1]):
        live = st[st[:, rep] >= 0, rep]
        assert _wavefronts(live[:, None]) == live.size // 32
