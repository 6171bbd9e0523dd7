"""Hand-written Hopper kernels of the 1-D complex and real FFT and of the
N-D FFT, their host plan, their plain PyTorch versions, and the port's
routes onto them: the counterparts of
``kofft_tpu.ops.pallas_kernels.fused_multilevel_fft``,
``fused_multilevel_rfft``, its three N-D kernel entries and
``fused_four_step_fft``.

The JAX package runs the Bailey four-step X = F_n2 . ((F_n1 . A) o W)
through three Pallas forms that differ only in where the TPU kept the
inter-stage matrix C and in layouts Mosaic forced on them. On Hopper every
shape runs the same two CUDA kernels (``csrc/fft_stages.cu``) on the
register radix line FFT (``csrc/radix_line.cuh``): ``stage1`` (column
FFTs of length n1 in tiles of >= 8 columns, the twiddle fused into the
store; columns of 4096 and 8192 in one launch of a thread-block cluster
that holds the column tile, as ``col_fft``'s, also counted as
``stage1_cluster``) and
``stage2`` (row FFTs of length n2, stored transposed through the
exchange buffer; lines of 4096 and 8192 through a thread-block cluster
of eight CTAs, one line each, also counted as ``stage2_cluster8``).
A smooth n1 = o * 2^a is one more radix plan of stage 1: the power-of-two
passes of 2^a on the o sub-lines, then one pass of radix o, in the kernel
of ``csrc/stage1_odd.cu`` (``_odd_tile``). The real FFT runs two more
instances of the same kernels, ``stage1_real`` (one real input plane)
and ``stage2_half`` (only the one-sided bins k <= n/2 stored, the Nyquist
bin included).

The N-D FFT's three Pallas kernels (the one-call 2-D kernel, the two-call
2-D pair and the fused all-axes kernel) compute DFTs along axes with no
twiddle between the passes. On Hopper they are one route
(``axes_fft_planes``) on two kernels of their own (``csrc/axis_fft.cu``)
on a register radix line FFT (``csrc/radix_line.cuh``): ``col_fft`` (line
FFTs along axis 1 of (b, m, inner) planes, stored in the input layout;
lines of 4096 and 8192 in one launch of a thread-block cluster that
holds the column tile, also counted as ``col_cluster``) on every
transformed axis but the last, then ``row_fft`` (line FFTs along the last
axis, stored in natural order). Its zone is ``ndfft._kernel_nd_zone``.

``classes`` counts the routes a call takes: ``stages`` and
``stages_real`` (the stage pair), ``axes`` (the axis kernels),
``four_step`` (the dense pair) and ``stft_frames`` (the frame kernel);
``launches`` counts the wrapper calls that launched a kernel.

bfloat16 planes: the four stage kernels also run in bf16 I/O forms (bf16
loads and stores, float32 arithmetic), named by the element types they
load and store (``_IO_FORMS``): ``stage1_bf`` reads bf16 planes and
writes a float32 C, ``stage2_fb`` reads a float32 C and writes bf16, and
so on. ``_stage_types`` sends bf16 planes and the `default` tier's casts
to them where the JAX package sends them to its bf16 forms of the phased
kernel and of the two-call pair (``io``, ``sdt``, ``cdt``).

The dense four-step pair (``_build``, whose entry ``fused_four_step_fft``
only tests call in the JAX package) is two more CUDA kernels
(``csrc/dense_dft.cu``): ``dense_stage_a`` (C = (F_n1^T A) o W, one
complex DFT-matrix product per batch row) and ``dense_stage_b`` (X =
F_n2^T C^T), the Gauss three-product on the tensor cores (``wgmma``) and
no line recursion; the route count is ``four_step``. Their arithmetic
follows the precision tier as ``_build``'s ``mode`` does (``_dense_mode``):
3xTF32 on `highest` and `high` (counted under the kernels' names), one
bf16 pass on `default` (``dense_stage_a_bf16x1``, ``dense_stage_b_bf16x1``).

Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; any other device raises. The plain
versions (``fft_axis0_plain``, ``stage1_plain``, ``stage2_plain``,
``stage1_real_plain``, ``stage2_half_plain``, ``col_fft_plain``,
``row_fft_plain``) are the JAX routine's recursion with the Gauss
three-product of ``_cdot`` at the `highest` tier, in float32 matmuls (bf16
operands widened first, results rounded to the requested type last);
``fused_nd_plain``, ``dense_stage_a_plain`` and ``dense_stage_b_plain``
are their kernels' own math, dense Gauss products (the dense pair's in
float32, or on `default` from operands rounded to bf16 as its kernel
rounds them).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.autograd import profiler as _prof

from ..config import get_config
from ..errors import InvalidValueError, require
from ..plan import tables
from ..utils import observability as _obs
from ._complex import const

_TILE = 128
_MAX_N = 1 << 26
_MIN_FACTOR = _TILE
_MAX_ODD = 23
_ML_LEAF = 128            # dense DFT leaves up to 128 points
_ML_TILE = 128            # twiddle factor tile t of _twiddle_factors
_PHASED_MAX_N = 1 << 22   # phased one-call cap, 6-pass tiers
_PHASED_MAX_N_DEFAULT = 1 << 24   # phased cap, `default` tier
_PHASED_FLAT_MAX_N = 1 << 21      # flat (rank-1 output) phased cap
_PHASED_FLAT_REAL_MAX_N = 1 << 23  # the same for the real form

# the longest line col_fft and row_fft take (the N-D zones' longest axis)
_LINE_MAX = 8192

_F32 = torch.float32
_BF16 = torch.bfloat16
_IO_DTYPES = (_F32, _BF16)

# The I/O forms of the stage kernels that the routing launches, as the
# element types (f float32, b bfloat16) each loads and stores. The f32 form
# keeps the kernel's name, the others add "_" and the two letters. Stage 1
# never loads f32 and stores bf16: the `default` tier casts its input
# planes whenever it keeps C in bf16.
_IO_FORMS = {"stage1": ("ff", "bf", "bb"), "stage2": ("ff", "fb", "bb", "bf"),
             "stage1_real": ("ff", "bf", "bb"),
             "stage2_half": ("ff", "fb", "bb", "bf")}
_LETTER_DTYPE = {"f": _F32, "b": _BF16}
_FORM_NAMES = {(base, _LETTER_DTYPE[f[0]], _LETTER_DTYPE[f[1]]):
               base if f == "ff" else f"{base}_{f}"
               for base, forms in _IO_FORMS.items() for f in forms}

# the launch and route counts are two groups of the port's one counter
# registry (utils/observability.py)
launches = _obs.counter_group("launches")
launches.update({"stage1": 0, "stage2": 0, "stage1_real": 0,
                 "stage2_half": 0, "stage2_cluster8": 0, "stage1_cluster": 0,
                 "col_fft": 0, "col_cluster": 0, "row_fft": 0,
                 "dense_stage_a": 0, "dense_stage_b": 0,
                 "dense_stage_a_bf16x1": 0, "dense_stage_b_bf16x1": 0,
                 "stft_frames": 0})
launches.update({name: 0 for name in _FORM_NAMES.values()})
classes = _obs.counter_group("classes")
classes.update({"stages": 0, "stages_real": 0, "axes": 0, "four_step": 0,
                "stft_frames": 0})
# table_builds and alloc_bytes (bytes of the buffers allocated here)
_COUNTS = _obs.counts


def reset_counts() -> None:
    """Set every count of the port's counter registry (``launches``,
    ``classes``, ``utils.observability.counts``, ...) and the span totals
    to 0."""
    _obs.reset()


# ---------------------------------------------------------------------------
# host plan (same rules as the JAX package; the zone thresholds and caps
# were measured on a TPU v5e and are re-measured on the H100 later)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pow2_split(n: int):
    """n = n1 * n2 for smooth n = o * 2^k (odd o <= 23), both factors
    multiples of 128 and n2 a power of two; None otherwise. Pow2 n: the
    balanced split with n1 capped at 2048 through 2^23 and n2 at 8192.
    Smooth n: the odd factor stays in n1 <= 3072, most balanced split."""
    if n < _MIN_FACTOR * _MIN_FACTOR or n > _MAX_N:
        return None
    tz = (n & -n).bit_length() - 1
    o = n >> tz
    if o == 1:
        k = n.bit_length() - 1
        n1 = 1 << (k // 2)
        if n <= (1 << 23):
            n1 = min(n1, 2048)
        n1 = max(n1, n // 8192)
        n2 = n // n1
        if n1 < _MIN_FACTOR or n2 < _MIN_FACTOR:
            return None
        return n1, n2
    if o > _MAX_ODD:
        return None
    best = None
    for a in range(7, tz - 6):
        n1 = o << a
        n2 = 1 << (tz - a)
        if n1 > 3072:
            break
        if n2 > 8192:
            continue
        if best is None or abs(n1 - n2) < abs(best[0] - best[1]):
            best = (n1, n2)
    return best


def _ml_split(m: int):
    """Split a line m = a * b toward <= 128 leaves: pow2 m balanced; smooth
    m keeps its odd factor in b; larger odd factors take the largest
    divisor <= sqrt(m)."""
    tz = (m & -m).bit_length() - 1
    o = m >> tz
    if o == 1:
        k = m.bit_length() - 1
        a = 1 << (k // 2)
        return a, m // a
    if o <= _MAX_ODD:
        a = 1 << max(1, tz // 2)
        return a, m // a
    best = None
    for a in range(2, int(m ** 0.5) + 1):
        if m % a == 0:
            best = a
    return best, m // best


def _ml_const_keys(m: int) -> list:
    """Ordered table keys of the length-m line FFT."""
    out = []

    def walk(mm):
        if mm <= _ML_LEAF:
            key = ("dft", mm)
            if key not in out:
                out.append(key)
            return
        a, b = _ml_split(mm)
        key = ("tw", a, b)
        if key not in out:
            out.append(key)
        walk(a)
        walk(b)

    walk(m)
    return out


def _ml_const_arrays(keys: list, dtype: str) -> list:
    arrs = []
    for key in keys:
        if key[0] == "dft":
            re, im = tables.dft_matrix(key[1], dtype)
        else:
            re, im = tables.twiddle(key[1], key[2], dtype)
        arrs += [re, im]
    return arrs


def _twiddle_factors(n1: int, n2: int, t: int, dtype: str):
    """Factored four-step twiddle W[k1, j*t + u] = col[k1, j] * base[k1, u]
    (exact integer phases; the float32 product adds <= 1 ulp). Returns
    (base_re, base_im, col_re, col_im), base (n1, t), col (n1, n2/t)."""
    def build():
        n = n1 * n2
        k1 = np.arange(n1, dtype=np.int64)
        u = np.arange(t, dtype=np.int64)
        j = np.arange(n2 // t, dtype=np.int64) * t
        ang_b = (-2.0 * np.pi / n) * np.mod(np.outer(k1, u), n).astype(
            np.float64)
        ang_c = (-2.0 * np.pi / n) * np.mod(np.outer(k1, j), n).astype(
            np.float64)
        return (np.cos(ang_b).astype(dtype), np.sin(ang_b).astype(dtype),
                np.cos(ang_c).astype(dtype), np.sin(ang_c).astype(dtype))

    return tables.custom(("twfac", n1, n2, t, dtype), build)


def _ml_batch_tile(b: int, n1: int, n2: int) -> int:
    """Batch rows the JAX two-call pair folds into one grid block (powers
    of two, ~0.5 MB blocks). bt > 1 takes a shape off the JAX package's
    phased grid (``_use_phased``)."""
    t = min(_ML_TILE, n2)
    target = (1 << 19) // (n1 * t * 4)
    bt = 1
    while bt * 2 <= min(b, max(1, target)) and b % (bt * 2) == 0:
        bt *= 2
    return bt


def _use_phased(n: int, bt: int) -> bool:
    """Whether the JAX package serves the shape with the phased one-call
    kernel: bt == 1 and n up to the per-tier cap."""
    cap = (_PHASED_MAX_N_DEFAULT if get_config().precision == "default"
           else _PHASED_MAX_N)
    return bt == 1 and n <= cap


def _phased_sdt(n: int) -> torch.dtype:
    """Element type of C on the phased route (``_phased_sdt``,
    pallas_kernels.py:734, with the device's answer): bfloat16 on the
    `default` tier above 2^23, where the TPU's f32 scratch would not fit,
    else float32. The port's C always crosses device memory, so the JAX
    scratch type (``sdt``) and the two-call pair's C type (``cdt``) both
    name the type C has between the two launches."""
    if get_config().precision == "default" and n > (1 << 23):
        return _BF16
    return _F32


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _line_consts(m: int, device) -> dict:
    keys = _ml_const_keys(m)
    arrs = _ml_const_arrays(keys, "float32")
    return {k: (const(arrs[2 * i], device), const(arrs[2 * i + 1], device))
            for i, k in enumerate(keys)}


def _cdot(fr, fi, xr, xi):
    """y[k, c] = sum_j F[j, k] x[j, c] by the Gauss three-product (the
    `highest` tier of the JAX ``_cdot``)."""
    t1 = torch.matmul(fr.T, xr)
    t2 = torch.matmul(fi.T, xi)
    t3 = torch.matmul((fr + fi).T, xr + xi)
    return t1 - t2, t3 - t1 - t2


def fft_axis0_plain(xr, xi, m: int, consts: dict | None = None):
    """FFT along axis 0 of (m, t) float32 planes: the recursion of
    ``_fft_axis0_traced``, m = a*b, j = ja*b + jb, output k = ka + a*kb.
    ``xi=None`` is a real input: the first leaf takes two real products
    instead of three."""
    if consts is None:
        consts = _line_consts(m, xr.device)
    if m <= _ML_LEAF:
        fr, fi = consts[("dft", m)]
        if xi is None:
            return torch.matmul(fr.T, xr), torch.matmul(fi.T, xr)
        return _cdot(fr, fi, xr, xi)
    a, b = _ml_split(m)
    t = xr.shape[-1]
    yr, yi = fft_axis0_plain(xr.reshape(a, b * t),
                             None if xi is None else xi.reshape(a, b * t),
                             a, consts)
    yr = yr.reshape(a, b, t)
    yi = yi.reshape(a, b, t)
    twr, twi = consts[("tw", a, b)]
    cr = yr * twr[:, :, None] - yi * twi[:, :, None]
    ci = yr * twi[:, :, None] + yi * twr[:, :, None]
    cr = cr.transpose(0, 1).reshape(b, a * t)
    ci = ci.transpose(0, 1).reshape(b, a * t)
    zr, zi = fft_axis0_plain(cr, ci, b, consts)
    return zr.reshape(m, t), zi.reshape(m, t)


def _twiddle_plane(n1: int, n2: int, device):
    """W[k1, j2] = col[k1, j2 // t] * base[k1, j2 % t], the product the
    stage-1 kernel forms from the factored tables."""
    def build():
        t = min(_ML_TILE, n1)
        br, bi, cr, ci = _twiddle_factors(n1, n2, t, "float32")
        cr = np.repeat(cr, t, axis=1)
        ci = np.repeat(ci, t, axis=1)
        br = np.tile(br, (1, n2 // t))
        bi = np.tile(bi, (1, n2 // t))
        return cr * br - ci * bi, cr * bi + ci * br

    wr, wi = tables.custom(("twplane", n1, n2), build)
    return const(wr, device), const(wi, device)


def _col_lines(ar, ai, conj: bool):
    """FFTs of length m along axis 1 of (b, m, inner) planes, as (b, m,
    inner) views. ``ai=None``: real input."""
    b, m, inner = ar.shape
    xr = ar.permute(1, 0, 2).reshape(m, b * inner)
    xi = None
    if ai is not None:
        xi = (-ai if conj else ai).permute(1, 0, 2).reshape(m, b * inner)
    yr, yi = fft_axis0_plain(xr, xi, m)
    return (yr.reshape(m, b, inner).permute(1, 0, 2),
            yi.reshape(m, b, inner).permute(1, 0, 2))


def _row_lines(cr, ci):
    """FFTs of length n2 along the last axis of (b, n1, n2) planes, as
    (n2, b, n1) tensors."""
    b, n1, n2 = cr.shape
    xr = cr.permute(2, 0, 1).reshape(n2, b * n1)
    xi = ci.permute(2, 0, 1).reshape(n2, b * n1)
    yr, yi = fft_axis0_plain(xr, xi, n2)
    return yr.reshape(n2, b, n1), yi.reshape(n2, b, n1)


def stage1_plain(ar, ai, conj: bool = False, c_dtype=_F32):
    """Plain version of the stage-1 kernel: (b, n1, n2) -> C (b, n1, n2),
    column FFTs of length n1 then the twiddle W, in float32 from float32
    or bfloat16 planes, C rounded to ``c_dtype``. ``ai=None``: real
    input."""
    b, n1, n2 = ar.shape
    yr, yi = _col_lines(ar.float(), None if ai is None else ai.float(), conj)
    wr, wi = _twiddle_plane(n1, n2, ar.device)
    return ((yr * wr - yi * wi).contiguous().to(c_dtype),
            (yr * wi + yi * wr).contiguous().to(c_dtype))


def stage2_plain(cr, ci, conj: bool = False, dtype=_F32):
    """Plain version of the stage-2 kernel: C (b, n1, n2) -> (b, n2, n1),
    row FFTs of length n2 written transposed, in float32 from a float32 or
    bfloat16 C, rounded to ``dtype``."""
    yr, yi = _row_lines(cr.float(), ci.float())
    yr = yr.permute(1, 0, 2).contiguous()
    yi = yi.permute(1, 0, 2).contiguous()
    if conj:
        yi = -yi
    return yr.to(dtype), yi.to(dtype)


def col_fft_plain(ar, ai, conj: bool = False):
    """Plain version of the col_fft kernel: (b, m, inner) -> (b, m, inner),
    line FFTs of length m along axis 1 in the input layout (stage 1 with
    no twiddle); ``conj`` negates the imaginary part of the input."""
    yr, yi = _col_lines(ar, ai, conj)
    return yr.contiguous(), yi.contiguous()


def row_fft_plain(xr, xi, conj: bool = False):
    """Plain version of the row_fft kernel: (b, n1, m) -> (b, n1, m), line
    FFTs of length m along the last axis in natural order (stage 2 with no
    transpose); ``conj`` negates the imaginary part of the output."""
    yr, yi = _row_lines(xr, xi)
    yr = yr.permute(1, 2, 0).contiguous()
    yi = yi.permute(1, 2, 0).contiguous()
    if conj:
        yi = -yi
    return yr, yi


def fused_nd_plain(xr, xi, conj: bool = False):
    """Plain version of the fused all-axes kernel with its own math
    (``_build_fused_nd``, pallas_kernels.py:1415-1429): one dense Gauss
    product per axis, last axis first. Each product contracts the grid's
    current last axis with DFT_m and puts the output axis first, a cyclic
    rotation of the axes, so after d products the grid is back in natural
    order. ``conj``: the conjugation identity (the unnormalized
    inverse)."""
    shape = tuple(xr.shape)
    total = xr.numel()
    if conj:
        xi = -xi
    for m in reversed(shape):
        fr, fi = (const(a, xr.device) for a in tables.dft_matrix(m))
        xr, xi = _cdot(fr, fi, xr.reshape(total // m, m).T,
                       xi.reshape(total // m, m).T)
    yr, yi = xr.reshape(shape), xi.reshape(shape)
    return (yr, -yi) if conj else (yr, yi)


def stage1_real_plain(ar, c_dtype=_F32):
    """Plain version of the real-input stage-1 kernel: one real
    (b, n1, n2) plane -> C (b, n1, n2), the first leaf with two real
    products."""
    return stage1_plain(ar, None, c_dtype=c_dtype)


def stage2_half_plain(cr, ci, dtype=_F32):
    """Plain version of the one-sided stage-2 kernel: the flat spectrum of
    ``stage2_plain`` cut to the bins k <= n/2 (rows k2 < n2/2 and the
    Nyquist bin), as (b, n/2 + 1) planes, every bin computed in float32
    and rounded once to ``dtype``."""
    b, n1, n2 = cr.shape
    h = n1 * n2 // 2 + 1
    yr, yi = stage2_plain(cr, ci)
    return (yr.reshape(b, -1)[:, :h].contiguous().to(dtype),
            yi.reshape(b, -1)[:, :h].contiguous().to(dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_line(m: int, what: str) -> None:
    """col_fft and row_fft take pow2 lines of 2 ... _LINE_MAX points."""
    if m & (m - 1) or not 2 <= m <= _LINE_MAX:
        raise InvalidValueError(
            f"{what}: lines must be a power of two in [2, {_LINE_MAX}]; "
            f"got {m}")


# ---------------------------------------------------------------------------
# the axis kernels' host plan: the radix passes of csrc/radix_line.cuh and
# the tiles of csrc/axis_fft.cu
# ---------------------------------------------------------------------------

_AXIS_THREADS = 256       # threads per axis block where the tile allows
_AXIS_MAX_THREADS = 1024  # a block's most (col_fft's (2048, 8) tile)
_COL_MIN_TILE = 8         # columns per col_fft tile: >= 32-byte row runs
_SMEM_MAX = 227 * 1024    # shared memory one Hopper block may have
# The cluster paths by line length, where one (m, 8) tile would need 256 KB
# or more, over a block's 227 KB: col_fft's (csrc/axis_fft.cu
# col_cluster_kernel) and stage 1's (csrc/fft_stages.cu
# stage1_cluster_kernel, built for (16, 16) alone). (C, T): C CTAs per
# cluster, each running lines of m / C points, and T columns per tile;
# (16, 16) measured fastest at both lengths for col_fft, of C = 2 ... 16
# and T = 8 ... 32 (PERF.md section 6)
_COL_CLUSTER = {4096: (16, 16), 8192: (16, 16)}


def _odd_part(m: int) -> int:
    """The odd factor o of m = o * 2^a."""
    return m >> ((m & -m).bit_length() - 1)


def _radices(m: int) -> list:
    """The radix passes of a line m = o * 2^a: ceil(a / 4) passes of 16, 8,
    4 or 2 points, the bits spread evenly, largest first (128 = 16*8, 1024 =
    16*8*8, 8192 = 16*8*8*8), then one pass of radix o for odd o > 1 (768 =
    16*16*3)."""
    o = _odd_part(m)
    p = (m // o).bit_length() - 1
    n = -(-p // 4)
    return [1 << (p // n + (i < p % n)) for i in range(n)] + [o][:o > 1]


def _axis_tile(kind: str, m: int, count: int) -> tuple:
    """(T, E) of an axis launch: T lines per block (``row``: whole lines of
    the last axis; ``col``: consecutive columns of the (b, m, inner) view,
    at least 8 so that every row access covers 32 bytes) and E points per
    thread (16, or m below 16). A block has T*m/E threads: 256 where the
    tile allows (several blocks per SM), more for col_fft's (m, 8) tiles
    from lines of 512 (1024 threads at 2048). ``count`` (lines, or
    columns) caps T at the next power of two."""
    e = min(m, 16)
    t = max(1 if kind == "row" else _COL_MIN_TILE, _AXIS_THREADS * e // m)
    t = min(t, 1 << max(0, count - 1).bit_length())
    require(t * m // e <= _AXIS_MAX_THREADS and _axis_smem(m, t) <= _SMEM_MAX,
            InvalidValueError, f"{kind}_fft: no tile of lines of {m}")
    return t, e


def _axis_smem(m: int, t: int) -> int:
    """Shared memory of an axis block: one (re, im) exchange buffer of T
    lines, none for a single pass (m <= 16)."""
    return 8 * m * t if len(_radices(m)) > 1 else 0


def _axis_lanes(kind: str, m: int, t: int, e: int):
    """(line c, thread in line) of every thread of an axis block: ``row``
    puts a line's m/E threads together, ``col`` the T columns fastest."""
    tid = np.arange(t * m // e)
    tpl = m // e
    if kind == "row":
        return tid // tpl, tid % tpl
    return tid % t, tid // t


def _axis_addr(kind: str, m: int, t: int, c, k):
    """Logical shared-memory word of point k of block line c (before the
    swizzle): line-major for ``row``, (m, T) with the column fastest for
    ``col``."""
    return c * m + k if kind == "row" else k * t + c


def _swizzle(a, sw):
    """The exchange's physical word of logical word a under the swizzle
    sw = (x1, y1, x2, y2): a ^ (((h >> x1) << y1) ^ ((h >> x2) << y2)) & 31
    with h = a >> 5, a permutation inside each row of 32 words
    (radix_line.cuh); y = 5 turns a term off."""
    x1, y1, x2, y2 = sw
    h = a >> 5
    return a ^ ((((h >> x1) << y1) ^ ((h >> x2) << y2)) & 31)


def _exchange_addrs(kind: str, m: int, t: int, e: int, radix: int, ns: int):
    """Logical words written by pass (radix, ns) and read by the next pass,
    each (threads, E), in the order radix_line.cuh issues them."""
    c, ti = _axis_lanes(kind, m, t, e)
    tpl = m // e
    wk = []
    for q in range(e // radix):
        j = ti + q * tpl
        for r in range(radix):
            wk.append((j // ns) * ns * radix + j % ns + r * ns)
    rk = [ti + s * tpl for s in range(e)]
    return (np.stack([_axis_addr(kind, m, t, c, k) for k in wk], axis=1),
            np.stack([_axis_addr(kind, m, t, c, k) for k in rk], axis=1))


def _pick_swizzle(kind: str, m: int, t: int, e: int, radix: int, ns: int):
    """The swizzle (x1, y1, x2, y2) of the exchange after pass (radix, ns)
    with the fewest bank conflicts over its writes and the next pass's
    reads (``_best_swizzle``)."""
    return _best_swizzle(*_exchange_addrs(kind, m, t, e, radix, ns), m * t)


def _best_swizzle(w, r, words: int):
    """The swizzle (x1, y1, x2, y2) with the fewest bank conflicts over the
    logical words ``w`` written and ``r`` read (each (threads, E), in
    issue order) of a buffer of ``words`` words, one term where one
    suffices. Every address is an XOR of disjoint bit fields (lane,
    instruction, warp), and the swizzle is linear over GF(2), so the first
    warp's first write and read show the conflicts of all of them
    (tests/test_torch_axis.py and tests/test_torch_stage.py check whole
    blocks)."""
    lanes = np.stack([w[:32, 0], r[:32, 0]])
    hi = max(0, words.bit_length() - 6)
    cands = np.array([(x1, y1, x2, y2) for x2 in range(hi + 1)
                      for y2 in (5, 0, 1, 2, 3, 4) for x1 in range(hi + 1)
                      for y1 in range(5) if y2 == 5 or x2 > x1])
    banks = _swizzle(lanes[None], tuple(cands.T[:, :, None, None])) & 31
    hits = np.zeros(banks.shape[:2] + (32,), np.int64)
    idx = np.indices(banks.shape)
    np.add.at(hits, (idx[0], idx[1], banks), 1)
    cost = hits.max(axis=2).sum(axis=1)
    return tuple(int(v) for v in cands[int(np.argmin(cost))])


def _axis_plan(kind: str, m: int, t: int, e: int):
    """The radix plan of an axis launch: an int32 array of (R, Ns, tw_off,
    x1, y1, x2, y2) per pass (the RadixPlan of radix_line.cuh) and the
    float2-interleaved float32 twiddle table the offsets point into. Pass p
    with Ns > 1 reads w[jj*(R-1) + r-1] = exp(-2 pi i jj r / (Ns R)),
    built in float64 with the phase jj*r reduced mod Ns*R in integers. A
    smooth m = o * q (stage 1 only, ``kind="col"``) plans the passes of
    its sub-lines of q, exchanged in (q, t) sub-tiles, then the odd pass
    (Ns = q, its (q, o-1) table over m; no swizzle: stage1_odd.cu's
    exchange before it is unswizzled)."""
    def build():
        steps, chunks, off, ns = [], [], 0, 1
        rs = _radices(m)
        q = m // _odd_part(m)
        n_pow2 = len(_radices(q))
        for p, radix in enumerate(rs):
            sw = (0, 5, 0, 5)
            if p + 1 < n_pow2:
                sw = _pick_swizzle(kind, q, t, e, radix, ns)
            steps += [radix, ns, off, *sw]
            if ns > 1:
                ph = np.mod(np.outer(np.arange(ns, dtype=np.int64),
                                     np.arange(1, radix, dtype=np.int64)),
                            ns * radix)
                ang = (-2.0 * np.pi / (ns * radix)) * ph.astype(np.float64)
                chunks.append(np.stack([np.cos(ang).ravel(),
                                        np.sin(ang).ravel()], axis=1).ravel())
                off += ns * (radix - 1)
            ns *= radix
        tab = (np.concatenate(chunks) if chunks else np.zeros(2))
        return np.asarray(steps, np.int32), tab.astype(np.float32)

    return tables.custom(("axisplan", kind, m, t, e), build)


def _cluster_tile(m: int, count: int) -> tuple:
    """(C, T) of a cluster path on lines of m (``_COL_CLUSTER``): T
    columns per tile, capped at the next power of two of ``count``
    columns."""
    csize, t = _COL_CLUSTER[m]
    return csize, min(t, 1 << max(0, count - 1).bit_length())


def _split_twiddle(m1: int, m2: int):
    """The twiddle w_m^(k1*j2), m = m1*m2, (m1, m2) float2-interleaved
    float32 (the ``tables.twiddle`` pair): with (m1, m2) = (C, m / C) the
    cluster paths' w_m^(r*k)."""
    def build():
        re, im = tables.twiddle(m1, m2)
        return np.stack([re.ravel(), im.ravel()], axis=1).ravel()

    return tables.custom(("splittw", m1, m2), build)


# ---------------------------------------------------------------------------
# the stage kernels' host plan (csrc/fft_stages.cu): stage 1 on col_fft's
# tiles and cluster, stage 2 on whole-line tiles with the transposed store
# through the exchange buffer or a cluster of 8 CTAs
# ---------------------------------------------------------------------------

_STAGE_E = 16             # points per thread: stage lines have >= 128 points
_ROW_MIN_TILE = 8         # lines k1 per stage-2 tile: >= 32-byte store runs
_ROW_CLUSTER_ABOVE = 2048  # longer stage-2 lines: a cluster holds the tile
_ODD_TILE = 8             # columns per smooth-n1 stage-1 tile: 32-byte runs
_ODD_MAX_GROUPS = 15      # sub-line groups: named barriers 1 ... 15
_ODD_MAX_LINE = 3072      # the longest smooth n1 of _pow2_split
_ODD_MAX_THREADS = 768    # a block of the odd plan (80 registers a thread)


def _stage2_tile(m: int) -> tuple:
    """(T, Tc) of a stage-2 launch on lines of m points: a tile of T >= 8
    consecutive lines k1, so that the transposed store writes >= 32-byte
    runs of k1 into each output row k2, and Tc of them per CTA. Up to
    _ROW_CLUSTER_ABOVE one block holds the tile (T*m/16 threads: 256 up to
    lines of 512, 512 at 1024, 1024 at 2048; T = 32 at 128 and 16 at 256).
    Longer lines: a cluster of T = 8 CTAs, each holding one whole line
    (m/16 threads: 256 at 4096, four CTAs per SM; 512 at 8192), so that
    as many CTAs share an SM as row_fft's blocks do (the earlier 4 CTAs of
    two lines of 4096 ran two per SM and took 17 % longer)."""
    if m > _ROW_CLUSTER_ABOVE:
        return _ROW_MIN_TILE, 1
    t = max(_ROW_MIN_TILE, _AXIS_THREADS * _STAGE_E // m)
    return t, t


def _odd_tile(m: int) -> tuple:
    """(T, P) of a stage-1 launch on smooth lines m = o * q
    (``csrc/stage1_odd.cu``): T = 8 consecutive columns per block, and P
    groups of T*q/16 threads, each running its share of the o sub-lines of
    q in turn: the fewest rounds ceil(o / P) that keep the block at <= 768
    threads and P <= 15, with P = ceil(o / rounds) (768 = 3*256: 3 groups
    of 128; 3072 = 3*1024: one group of 512, 3 rounds; 2944 = 23*128: 12
    groups of 64, 2 rounds). Any other line raises."""
    o = _odd_part(m)
    q = m // o
    require(3 <= o <= _MAX_ODD and _MIN_FACTOR <= q <= 1024
            and m <= _ODD_MAX_LINE, InvalidValueError,
            f"stage1: no kernel for lines of {m} (smooth lines o * 2^a take "
            f"odd o <= {_MAX_ODD}, 2^a in [128, 1024], o * 2^a <= "
            f"{_ODD_MAX_LINE})")
    t = _ODD_TILE
    gsize = t * q // _STAGE_E
    most = min(_ODD_MAX_GROUPS, _ODD_MAX_THREADS // gsize, o)
    rounds = -(-o // most)
    return t, -(-o // rounds)


def _transpose_addrs(m: int, t: int, tc: int, rank: int = 0):
    """Logical words of stage 2's transposed exchange, each (threads, E) in
    issue order: those the threads of CTA ``rank`` write (point k2 of tile
    line c = rank*Tc + line to word c*slice + k2 mod slice of CTA k2 //
    slice, slice = m*Tc/T: a warp writes one 128-byte row) and those every
    CTA reads back (read i = thread + s*threads is output row i // T,
    column i mod T of its slice: word (i mod T)*slice + i // T)."""
    cl, ti = _axis_lanes("row", m, tc, _STAGE_E)
    tpl = m // _STAGE_E
    sl = m * tc // t
    w = np.stack([(rank * tc + cl) * sl + (ti + s * tpl) % sl
                  for s in range(_STAGE_E)], axis=1)
    n = tc * tpl
    i = np.arange(n)[:, None] + np.arange(_STAGE_E)[None, :] * n
    return w, (i % t) * sl + i // t


def _stage2_plan(m: int, t: int, tc: int):
    """The radix plan of a stage-2 launch: ``_axis_plan`` of Tc lines of m
    per CTA, with the last pass's swizzle (which radix_line.cuh does not
    use) set to that of the transposed exchange after it."""
    def build():
        steps, tab = _axis_plan("row", m, tc, _STAGE_E)
        steps = steps.copy()
        steps[-4:] = _best_swizzle(*_transpose_addrs(m, t, tc), m * tc)
        return steps, tab

    return tables.custom(("stage2plan", m, t, tc), build)


def _stage1_twiddle(n1: int, n2: int):
    """The four-step twiddle's factored tables (``_twiddle_factors``, t =
    min(128, n1)) float2-interleaved, so that each factor is one 8-byte
    load: base (n1, t) and col (n1, n2/t)."""
    def build():
        br, bi, cr, ci = _twiddle_factors(n1, n2, min(_ML_TILE, n1),
                                          "float32")
        return (np.stack([br, bi], axis=-1).ravel(),
                np.stack([cr, ci], axis=-1).ravel())

    return tables.custom(("stage1tw", n1, n2), build)


def _stage1_cluster_twiddle(n1: int, n2: int):
    """The four-step twiddle W[k1, j2] = w_n^(k1*j2), n = n1*n2, of stage
    1's cluster path (``_COL_CLUSTER``), factored at M = n1 / C for its
    store of row k1 = k + M*s: wk[k, j2] = w_n^(k*j2) (M, n2) and ws[s, j2]
    = w_n^(M*s*j2) (C, n2), each built in float64 from the exact integer
    phase mod n, rounded once to float32 and float2-interleaved."""
    def build():
        csize = _COL_CLUSTER[n1][0]
        m = n1 // csize
        n = n1 * n2
        j2 = np.arange(n2, dtype=np.int64)

        def table(k):
            ang = (-2.0 * np.pi / n) * np.mod(np.outer(k, j2), n).astype(
                np.float64)
            return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(
                np.float32).ravel()

        return (table(np.arange(m, dtype=np.int64)),
                table(np.arange(csize, dtype=np.int64) * m))

    return tables.custom(("stage1cltw", n1, n2), build)


def _check_planes(xr, xi, what: str, dtypes: tuple = (_F32,)) -> None:
    # one condition, message built only on failure: this runs on every
    # launch, and formatting eagerly cost ~25 us of host time per call
    if not (xr.dim() == 3 and xr.shape == xi.shape
            and xr.dtype in dtypes and xi.dtype == xr.dtype
            and xr.device == xi.device and xr.device.type in ("cpu", "cuda")
            and xr.is_contiguous() and xi.is_contiguous()):
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise InvalidValueError(
            f"{what}: planes must be contiguous {names} (b, n1, n2) "
            f"tensors of one type and shape on one cpu or cuda device; got "
            f"{tuple(xr.shape)} {xr.dtype} on {xr.device} (contiguous "
            f"{xr.is_contiguous()}) and {tuple(xi.shape)} {xi.dtype} on "
            f"{xi.device} (contiguous {xi.is_contiguous()})")


def _form(base: str, loads, stores) -> str:
    """The launch-count name of stage kernel ``base``'s form that loads
    ``loads`` and stores ``stores`` elements (``_IO_FORMS``)."""
    name = _FORM_NAMES.get((base, loads, stores))
    if name is None:
        raise InvalidValueError(
            f"{base}: no kernel form loads {loads} and stores {stores}")
    return name


# launch arguments by shape: raw host pointers into the table cache's
# plans and device pointers of its copies, dropped with them
_ARGS: dict = {}
tables.on_clear(_ARGS.clear)


def _static_args(kind: str, b: int, n1: int, n2: int, dev) -> tuple:
    """The launch arguments that depend only on the kernel kind (below),
    the (b, n1, n2) shape and the device, built once; the cached host and
    device tables keep every pointer alive.
    - "col" (lines of n1 along axis 1, tiles of n2 columns) and "row"
      (lines of n2, b*n1 of them): (T, E, plan pointer, pass count, table
      pointer) of ``_axis_tile`` and ``_axis_plan``.
    - "cluster" (col_fft's cluster path on lines of n1, tiles of n2
      columns): (T, C, plan pointer, pass count, table pointer, twiddle
      pointer) of ``_cluster_tile``, the plan of lines of n1 / C and the
      (C, n1 / C) ``_split_twiddle``.
    - "stage1_cluster" (stage 1's cluster path): the same and the
      pointers of W's factors wk, ws (``_stage1_cluster_twiddle``).
    - "stage2": (T, Tc, plan pointer, pass count, table pointer) of
      ``_stage2_tile`` and ``_stage2_plan``.
    - "stage1": (base twiddle pointer, col twiddle pointer, T, P, plan
      pointer, pass count, table pointer): T of ``_axis_tile`` and P = 0
      for a power-of-two n1, (T, P) of ``_odd_tile`` for a smooth one,
      and ``_axis_plan``.
    The host side of a launch is on the 2^20 critical path (the transform
    was host-bound there), so nothing is rebuilt per call. Timed as an
    ``args`` span; a build is a ``table`` span in it."""
    sp = (_obs.begin("args")
          if _prof._is_profiler_enabled or _obs.switch else None)
    key = (kind, b, n1, n2, dev.index)
    hit = _ARGS.get(key)
    if hit is None:
        hit = _ARGS[key] = _obs.table_build(_build_args, kind, b, n1, n2,
                                            dev)
    if sp:
        _obs.end(sp)
    return hit


def _build_args(kind: str, b: int, n1: int, n2: int, dev) -> tuple:
    """The entry of ``_static_args`` for (kind, b, n1, n2, dev)."""
    if kind in ("col", "row"):
        m, count = (n1, n2) if kind == "col" else (n2, b * n1)
        t, e = _axis_tile(kind, m, count)
        steps, tab = _axis_plan(kind, m, t, e)
        hit = (t, e, steps.ctypes.data, len(steps) // 7,
               const(tab, dev).data_ptr())
    elif kind in ("cluster", "stage1_cluster"):
        csize, t = _cluster_tile(n1, n2)
        m = n1 // csize
        steps, tab = _axis_plan("col", m, t, _STAGE_E)
        hit = (t, csize, steps.ctypes.data, len(steps) // 7,
               const(tab, dev).data_ptr(),
               const(_split_twiddle(csize, m), dev).data_ptr())
        if kind == "stage1_cluster":
            hit += tuple(const(a, dev).data_ptr()
                         for a in _stage1_cluster_twiddle(n1, n2))
    elif kind == "stage2":
        t, tc = _stage2_tile(n2)
        steps, tab = _stage2_plan(n2, t, tc)
        hit = (t, tc, steps.ctypes.data, len(steps) // 7,
               const(tab, dev).data_ptr())
    else:
        wb, wc = (const(a, dev).data_ptr() for a in _stage1_twiddle(n1, n2))
        t, groups = (_odd_tile(n1) if n1 & (n1 - 1)
                     else (_axis_tile("col", n1, n2)[0], 0))
        steps, tab = _axis_plan("col", n1, t, _STAGE_E)
        hit = (wb, wc, t, groups, steps.ctypes.data, len(steps) // 7,
               const(tab, dev).data_ptr())
    return hit


def _stream(dev) -> int:
    # the current stream's raw handle; torch.cuda.current_stream(dev)
    # costs ~14 us of host time per call on the card's host
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _stage1_kernel(ar, ai, conj: bool, c_dtype):
    """Stage 1 on CUDA planes (``ai=None``: one real plane) into a new C of
    ``c_dtype``: one launch of the one-block kernel (a smooth n1's odd plan
    among them) or, at the lines of ``_COL_CLUSTER``, of the cluster
    kernel, also counted as ``stage1_cluster`` (``_static_args``)."""
    from ._cuda_build import check, lib
    b, n1, n2 = ar.shape
    dev = ar.device
    cluster = n1 in _COL_CLUSTER
    args = _static_args("stage1_cluster" if cluster else "stage1", b, n1, n2,
                        dev)
    # the flags read once for the alloc and launch spans: the 2^20 path's
    # host time counts every bytecode
    on = _prof._is_profiler_enabled or _obs.switch
    sp = _obs.begin("alloc") if on else None
    cr = torch.empty(ar.shape, dtype=c_dtype, device=dev)
    ci = torch.empty(ar.shape, dtype=c_dtype, device=dev)
    if sp:
        _obs.end(sp)
    _COUNTS["alloc_bytes"] += 2 * cr.nbytes
    planes = (ar.data_ptr(), None if ai is None else ai.data_ptr(),
              cr.data_ptr(), ci.data_ptr(), b, n1, n2)
    forms = (int(ai is None), int(ar.dtype == _BF16), int(c_dtype == _BF16),
             dev.index, _stream(dev))
    sp = _obs.begin("launch") if on else None
    if cluster:
        t, csize, steps, npass, tab, ctw, wk, ws = args
        err = lib().kofft_stage1_cluster(*planes, t, csize, steps, npass, tab,
                                         int(conj), ctw, wk, ws, *forms)
        launches["stage1_cluster"] += 1
    else:
        wb, wc, t, groups, steps, npass, tab = args
        err = lib().kofft_stage1(*planes, t, groups, steps, npass, tab,
                                 int(conj), wb, wc, min(_ML_TILE, n1), *forms)
    check(err, "stage1 launch")
    if sp:
        _obs.end(sp)
    return cr, ci


def _stage2_kernel(cr, ci, yr, yi, conj: bool, half: bool) -> None:
    """Stage 2 on CUDA planes into yr, yi: (b, n2, n1), or the one-sided
    (b, n/2 + 1) planes for ``half``; a launch on lines of 4096 or 8192
    (the cluster of ``_stage2_tile``) also counts as
    ``stage2_cluster8``."""
    from ._cuda_build import check, lib
    b, n1, n2 = cr.shape
    dev = cr.device
    t, tc, steps, npass, tab = _static_args("stage2", b, n1, n2, dev)
    sp = (_obs.begin("launch")
          if _prof._is_profiler_enabled or _obs.switch else None)
    check(lib().kofft_stage2(
        cr.data_ptr(), ci.data_ptr(), yr.data_ptr(), yi.data_ptr(), b, n1,
        n2, t, tc, steps, npass, tab, int(conj), int(half),
        int(cr.dtype == _BF16), int(yr.dtype == _BF16), dev.index,
        _stream(dev)), "stage2 launch")
    if sp:
        _obs.end(sp)
    if n2 > _ROW_CLUSTER_ABOVE:
        launches["stage2_cluster8"] += 1


def _plain_span(plain, *args):
    """A kernel's plain version on CPU tensors, a plain PyTorch engine, as
    a ``tree`` span."""
    sp = (_obs.begin("tree")
          if _prof._is_profiler_enabled or _obs.switch else None)
    out = plain(*args)
    if sp:
        _obs.end(sp)
    return out


def stage1(ar, ai, conj: bool = False, c_dtype=_F32):
    """Stage 1: (b, n1, n2) float32 or bfloat16 planes -> C (b, n1, n2) of
    ``c_dtype`` (the forms of ``_IO_FORMS``). CUDA tensors launch the
    kernel once (one count in ``launches`` under the form's name; at n1 =
    4096 and 8192 the cluster kernel, also counted as ``stage1_cluster``);
    CPU tensors run ``stage1_plain`` (a ``tree`` span)."""
    _check_planes(ar, ai, "stage1", _IO_DTYPES)
    name = _form("stage1", ar.dtype, c_dtype)
    if ar.device.type == "cpu":
        return _plain_span(stage1_plain, ar, ai, conj, c_dtype)
    cr, ci = _stage1_kernel(ar, ai, conj, c_dtype)
    launches[name] += 1
    return cr, ci


def stage2(cr, ci, conj: bool = False, out=None, dtype=_F32):
    """Stage 2: a float32 or bfloat16 C (b, n1, n2) -> (b, n2, n1) planes
    of ``dtype`` (the forms of ``_IO_FORMS``). ``out`` is an optional pair
    of contiguous tensors of b*n1*n2 elements of ``dtype`` that receive
    the result (the donated input planes; another type raises). CUDA
    tensors launch the kernel; CPU tensors run ``stage2_plain`` (a
    ``tree`` span)."""
    _check_planes(cr, ci, "stage2", _IO_DTYPES)
    name = _form("stage2", cr.dtype, dtype)
    b, n1, n2 = cr.shape
    if out is not None:
        yr, yi = out[0].view(b, n2, n1), out[1].view(b, n2, n1)
        _check_planes(yr, yi, "stage2 out", (dtype,))
    if cr.device.type == "cpu":
        pr, pi = _plain_span(stage2_plain, cr, ci, conj, dtype)
        if out is None:
            return pr, pi
        yr.copy_(pr)
        yi.copy_(pi)
        return yr, yi
    if out is None:
        sp = (_obs.begin("alloc")
              if _prof._is_profiler_enabled or _obs.switch else None)
        yr = torch.empty((b, n2, n1), dtype=dtype, device=cr.device)
        yi = torch.empty((b, n2, n1), dtype=dtype, device=cr.device)
        if sp:
            _obs.end(sp)
        _COUNTS["alloc_bytes"] += 2 * yr.nbytes
    _stage2_kernel(cr, ci, yr, yi, conj, False)
    launches[name] += 1
    return yr, yi


def stage1_real(ar, c_dtype=_F32):
    """Real-input stage 1: one real float32 or bfloat16 (b, n1, n2) plane
    -> C (b, n1, n2) of ``c_dtype``. CUDA tensors launch the kernel once
    (one count in ``launches`` under the form's name; at n1 = 4096 and
    8192 the cluster kernel, also counted as ``stage1_cluster``); CPU
    tensors run ``stage1_real_plain`` (a ``tree`` span)."""
    _check_planes(ar, ar, "stage1_real", _IO_DTYPES)
    name = _form("stage1_real", ar.dtype, c_dtype)
    if ar.device.type == "cpu":
        return _plain_span(stage1_real_plain, ar, c_dtype)
    cr, ci = _stage1_kernel(ar, None, False, c_dtype)
    launches[name] += 1
    return cr, ci


def stage2_half(cr, ci, dtype=_F32):
    """One-sided stage 2: a float32 or bfloat16 C (b, n1, n2) -> (b, n/2 +
    1) planes of ``dtype``, the flat spectrum's bins k <= n/2 (the Nyquist
    bin written by the kernel). CUDA tensors launch the kernel; CPU
    tensors run ``stage2_half_plain`` (a ``tree`` span)."""
    _check_planes(cr, ci, "stage2_half", _IO_DTYPES)
    name = _form("stage2_half", cr.dtype, dtype)
    if cr.device.type == "cpu":
        return _plain_span(stage2_half_plain, cr, ci, dtype)
    b, n1, n2 = cr.shape
    h = n1 * n2 // 2 + 1
    sp = (_obs.begin("alloc")
          if _prof._is_profiler_enabled or _obs.switch else None)
    yr = torch.empty((b, h), dtype=dtype, device=cr.device)
    yi = torch.empty((b, h), dtype=dtype, device=cr.device)
    if sp:
        _obs.end(sp)
    _COUNTS["alloc_bytes"] += 2 * yr.nbytes
    _stage2_kernel(cr, ci, yr, yi, False, True)
    launches[name] += 1
    return yr, yi


def _col_launch(ar, ai, yr, yi, conj: bool) -> None:
    """One launch of col_fft on (b, m, inner) planes into yr, yi: the
    one-block kernel, or at the lines of ``_COL_CLUSTER`` the cluster
    kernel, also counted as ``col_cluster`` (axis_fft.cu)."""
    from ._cuda_build import check, lib
    b, m, inner = ar.shape
    dev = ar.device
    planes = (ar.data_ptr(), ai.data_ptr(), yr.data_ptr(), yi.data_ptr(), b,
              m, inner)
    if m in _COL_CLUSTER:
        t, csize, steps, npass, tab, ctw = _static_args("cluster", b, m,
                                                        inner, dev)
        sp = (_obs.begin("launch")
              if _prof._is_profiler_enabled or _obs.switch else None)
        err = lib().kofft_col_cluster(*planes, t, csize, steps, npass, tab,
                                      int(conj), ctw, dev.index,
                                      _stream(dev))
        launches["col_cluster"] += 1
    else:
        t, e, steps, npass, tab = _static_args("col", b, m, inner, dev)
        sp = (_obs.begin("launch")
              if _prof._is_profiler_enabled or _obs.switch else None)
        err = lib().kofft_col_fft(*planes, t, e, steps, npass, tab,
                                  int(conj), None, 1, 1, dev.index,
                                  _stream(dev))
    check(err, "col_fft launch")
    if sp:
        _obs.end(sp)


def _alloc_like(ar, ai):
    """New planes like ``ar`` and ``ai``, as an ``alloc`` span, counted in
    ``alloc_bytes``."""
    sp = (_obs.begin("alloc")
          if _prof._is_profiler_enabled or _obs.switch else None)
    yr = torch.empty_like(ar)
    yi = torch.empty_like(ai)
    if sp:
        _obs.end(sp)
    _COUNTS["alloc_bytes"] += yr.nbytes + yi.nbytes
    return yr, yi


def col_fft(ar, ai, conj: bool = False):
    """Line FFTs of length m along axis 1 of (b, m, inner) planes, written
    in the input layout (the column pass of the N-D routes); ``conj``
    negates the imaginary part on load. CUDA tensors launch the kernel
    once: one block per column tile up to lines of 2048, a thread-block
    cluster per tile at the longer lines of ``_COL_CLUSTER``
    (4096 and 8192; also counted as ``col_cluster``); each call counts
    once in ``launches["col_fft"]``. CPU tensors run ``col_fft_plain`` (a
    ``tree`` span)."""
    _check_planes(ar, ai, "col_fft")
    b, m, inner = ar.shape
    _check_line(m, "col_fft")
    if ar.device.type == "cpu":
        return _plain_span(col_fft_plain, ar, ai, conj)
    yr, yi = _alloc_like(ar, ai)
    _col_launch(ar, ai, yr, yi, conj)
    launches["col_fft"] += 1
    return yr, yi


def row_fft(xr, xi, conj: bool = False):
    """Line FFTs of length m along the last axis of (b, n1, m) planes,
    written in natural order (b, n1, m); ``conj`` negates the imaginary
    part on store. CUDA tensors launch the kernel (one count in
    ``launches``); CPU tensors run ``row_fft_plain`` (a ``tree`` span)."""
    _check_planes(xr, xi, "row_fft")
    b, n1, m = xr.shape
    _check_line(m, "row_fft")
    if xr.device.type == "cpu":
        return _plain_span(row_fft_plain, xr, xi, conj)
    from ._cuda_build import check, lib
    dev = xr.device
    yr, yi = _alloc_like(xr, xi)
    t, e, steps, npass, tab = _static_args("row", b, n1, m, dev)
    sp = (_obs.begin("launch")
          if _prof._is_profiler_enabled or _obs.switch else None)
    err = lib().kofft_row_fft(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), b * n1,
        m, t, e, steps, npass, tab, int(conj), dev.index, _stream(dev))
    check(err, "row_fft launch")
    if sp:
        _obs.end(sp)
    launches["row_fft"] += 1
    return yr, yi


# ---------------------------------------------------------------------------
# the 1-D routes: the stage kernels with the JAX package's element types
# ---------------------------------------------------------------------------

def _stage_types(n: int, b: int, flat: bool, dtype, real: bool = False):
    """(input type, C type) of the stage kernels for b transforms of n
    points on planes of ``dtype``, the element types of ``kofft_tpu``'s
    routing (pallas_kernels.py:1160-1243, :1260-1345); None runs the
    float32 types and rounds back. ``flat``: a rank-1 transform.
    - float32 planes off the `default` tier: float32 throughout.
    - bfloat16 planes: bf16 in and C per ``_phased_sdt`` where the JAX
      phased grid serves the shape (``_use_phased``), else None.
    - float32 planes on `default`: where the phased grid serves the shape,
      a flat transform up to the flat cap (2^21, 2^23 for the real form)
      stays float32, any other reads bf16 planes with C per
      ``_phased_sdt``; elsewhere bf16 planes and a bf16 C (the two-call
      pair's ``cdt``). The output keeps the planes' type."""
    if dtype == _F32 and get_config().precision != "default":
        return _F32, _F32
    n1, n2 = _pow2_split(n)
    phased = _use_phased(n, _ml_batch_tile(b, n1, n2))
    if dtype == _BF16:
        return (_BF16, _phased_sdt(n)) if phased else None
    if not phased:
        return _BF16, _BF16
    if flat and n <= (_PHASED_FLAT_REAL_MAX_N if real else _PHASED_FLAT_MAX_N):
        return _F32, _F32
    return _BF16, _phased_sdt(n)


def _batch(x):
    """(leading dims, their product) of (..., n) planes."""
    batch = tuple(x.shape[:-1])
    return batch, math.prod(batch)


def fused_multilevel_fft(xr, xi, n: int, inverse: bool = False,
                         donate: bool = False):
    """Unnormalized DFT (inverse: n * ifft) of (..., n) float32 or bfloat16
    planes through the two stage kernels, counted as the route
    ``stages``, with the element types of ``_stage_types``: bf16 planes
    keep bf16 I/O or, where the JAX phased grid does not serve them, run
    the float32 types and round back; the `default` tier casts float32
    input planes and C to bf16 where the JAX package does. The output has
    the planes' type. ``donate=True`` writes the result into the input
    planes' storage (stage 2 reads only C), and the inputs must not be
    used afterwards."""
    batch, b = _batch(xr)
    sp = (_obs.begin("route")
          if _prof._is_profiler_enabled or _obs.switch else None)
    types = _stage_types(n, b, batch == (), xr.dtype)
    if sp:
        _obs.end(sp)
    if types is None:
        # pallas_kernels.py:1177-1179; the float32 copies are temporaries
        yr, yi = fused_multilevel_fft(xr.float(), xi.float(), n, inverse,
                                      donate=True)
        if donate:
            return xr.copy_(yr), xi.copy_(yi)
        return yr.to(xr.dtype), yi.to(xi.dtype)
    in_dt, c_dt = types
    n1, n2 = _pow2_split(n)
    classes["stages"] += 1
    cr, ci = stage1(xr.reshape(b, n1, n2).to(in_dt),
                    xi.reshape(b, n1, n2).to(in_dt), conj=inverse,
                    c_dtype=c_dt)
    yr, yi = stage2(cr, ci, conj=inverse,
                    out=(xr, xi) if donate else None, dtype=xr.dtype)
    return yr.reshape(*batch, n), yi.reshape(*batch, n)


def fused_multilevel_rfft(x, n: int):
    """One-sided unnormalized DFT (..., n//2 + 1) of a real (..., n) float32
    or bfloat16 plane through ``stage1_real`` and ``stage2_half``, counted
    as the route ``stages_real``, with the element types of
    ``_stage_types``: bf16 planes that the JAX phased grid does not serve
    run the float32 types and round back (pallas_kernels.py:1268-1271)."""
    batch, b = _batch(x)
    sp = (_obs.begin("route")
          if _prof._is_profiler_enabled or _obs.switch else None)
    types = _stage_types(n, b, batch == (), x.dtype, real=True)
    if sp:
        _obs.end(sp)
    if types is None:
        yr, yi = fused_multilevel_rfft(x.float(), n)
        return yr.to(x.dtype), yi.to(x.dtype)
    in_dt, c_dt = types
    n1, n2 = _pow2_split(n)
    classes["stages_real"] += 1
    cr, ci = stage1_real(x.reshape(b, n1, n2).to(in_dt), c_dtype=c_dt)
    yr, yi = stage2_half(cr, ci, dtype=x.dtype)
    h = n // 2 + 1
    return yr.reshape(*batch, h), yi.reshape(*batch, h)


# ---------------------------------------------------------------------------
# the dense four-step pair (_build, pallas_kernels.py:185-292): each stage
# one complex DFT-matrix product, no line recursion
# ---------------------------------------------------------------------------

def fused_four_step_supported(n: int) -> bool:
    """Whether the dense pair serves n: the sizes ``_pow2_split`` splits
    (``fused_four_step_supported``, pallas_kernels.py:135)."""
    return _pow2_split(n) is not None


def _dense_dft(m: int):
    """(re, im, re + im) host planes of DFT_m: the ``tables.dft_matrix``
    pair and its float32 sum, the third operand of the Gauss product,
    built once per length."""
    fr, fi = tables.dft_matrix(m)
    return fr, fi, tables.custom(("dftsum", m), lambda: fr + fi)


def _dense_mode() -> str:
    """The dense pair's arithmetic on the current tier, as ``_build``'s
    ``mode``: ``bf16x1`` (one bf16 pass) on `default`, else ``tf32x3``
    (`high` rides the `highest` instance, as every kernel of the port
    runs `high` at `highest` arithmetic)."""
    return "bf16x1" if get_config().precision == "default" else "tf32x3"


def _dense_name(base: str, mode: str) -> str:
    """Launch-count name of a dense kernel's instance."""
    return base if mode == "tf32x3" else f"{base}_{mode}"


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds: the low 13 bits zero."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_split(x: np.ndarray):
    """(big, small) = (tf32(x), tf32(x - big)), the kernel's 3xTF32 split:
    big + small is x to about 2^-22 relative."""
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (int16), rounded to nearest even,
    as ``__float2bfloat16_rn`` rounds."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
    return (r >> np.uint32(16)).astype(np.uint16).view(np.int16)


def _dense_tables(m: int, mode: str) -> np.ndarray:
    """The F_m planes the tensor-core kernel reads, (planes, m, m), built
    once per length and tier: ``tf32x3`` the big and small TF32 parts of
    Fr, Fi and Fr + Fi (six float32 planes, low 13 bits zero), ``bf16x1``
    the bf16 bit patterns of the same three planes, each rounded once."""
    def build():
        planes = _dense_dft(m)
        if mode == "bf16x1":
            return np.stack([_bf16_bits(p) for p in planes])
        return np.stack([h for p in planes for h in _tf32_split(p)])

    return tables.custom(("dense_tc", m, mode), build)


def _bf16_round(x):
    return x.to(_BF16).float()


def _dense_cdot(m: int, xr, xi, mode: str):
    """y[k, c] = sum_j F_m[j, k] x[j, c] by the Gauss three-product in
    float32 matmuls: on ``tf32x3`` of the float32 operands (the `highest`
    tier's product, which the kernel's split evaluates), on ``bf16x1`` of
    the operands and both Gauss sums rounded to bf16 first, as the
    kernel rounds them."""
    if mode == "tf32x3":
        fr, fi = (const(a, xr.device) for a in tables.dft_matrix(m))
        return _cdot(fr, fi, xr, xi)
    fr, fi, fs = (_bf16_round(const(a, xr.device)) for a in _dense_dft(m))
    t1 = torch.matmul(fr.T, _bf16_round(xr))
    t2 = torch.matmul(fi.T, _bf16_round(xi))
    t3 = torch.matmul(fs.T, _bf16_round(xr + xi))
    return t1 - t2, t3 - t1 - t2


def dense_stage_a_plain(ar, ai):
    """Plain version of the dense stage-a kernel (``_stage_a_kernel``):
    (b, n1, n2) -> C = (F_n1^T A) o W, the Gauss product of the current
    tier (``_dense_cdot``) and the full twiddle plane
    ``tables.twiddle(n1, n2)``."""
    b, n1, n2 = ar.shape
    wr, wi = (const(a, ar.device) for a in tables.twiddle(n1, n2))
    br, bi = _dense_cdot(n1, ar, ai, _dense_mode())
    return br * wr - bi * wi, br * wi + bi * wr


def dense_stage_b_plain(cr, ci):
    """Plain version of the dense stage-b kernel (``_stage_b_kernel``):
    C (b, n1, n2) -> X = F_n2^T C^T, (b, n2, n1), the Gauss product of
    the current tier."""
    return _dense_cdot(cr.shape[2], cr.mT, ci.mT, _dense_mode())


def _check_dense(x, what: str) -> None:
    b, n1, n2 = x.shape
    require(all(d % 128 == 0 and 128 <= d <= _LINE_MAX for d in (n1, n2)),
            InvalidValueError,
            f"{what}: both plane dims must be multiples of 128 (the "
            f"kernel's tile) in [128, {_LINE_MAX}]; got {tuple(x.shape)}")


def dense_stage_a(ar, ai):
    """Dense stage a: (b, n1, n2) float32 planes -> C (b, n1, n2). CUDA
    tensors launch the tier's instance (one count in ``launches``, under
    ``_dense_name``); CPU tensors run ``dense_stage_a_plain``."""
    _check_planes(ar, ai, "dense_stage_a")
    _check_dense(ar, "dense_stage_a")
    if ar.device.type == "cpu":
        return dense_stage_a_plain(ar, ai)
    from ._cuda_build import check, lib
    b, n1, n2 = ar.shape
    dev = ar.device
    mode = _dense_mode()
    f = const(_dense_tables(n1, mode), dev)
    wr, wi = (const(a, dev) for a in tables.twiddle(n1, n2))
    cr, ci = _alloc_like(ar, ai)
    name = _dense_name("dense_stage_a", mode)
    sp = (_obs.begin("launch")
          if _prof._is_profiler_enabled or _obs.switch else None)
    err = lib().kofft_dense_stage_a(
        ar.data_ptr(), ai.data_ptr(), f.data_ptr(), wr.data_ptr(),
        wi.data_ptr(), cr.data_ptr(), ci.data_ptr(), b, n1, n2,
        int(mode == "bf16x1"), dev.index, _stream(dev))
    check(err, f"{name} launch")
    if sp:
        _obs.end(sp)
    launches[name] += 1
    return cr, ci


def dense_stage_b(cr, ci):
    """Dense stage b: C (b, n1, n2) float32 -> (b, n2, n1), the transposed
    layout whose row-major flattening is the spectrum. CUDA tensors launch
    the tier's instance (one count in ``launches``, under
    ``_dense_name``); CPU tensors run ``dense_stage_b_plain``."""
    _check_planes(cr, ci, "dense_stage_b")
    _check_dense(cr, "dense_stage_b")
    if cr.device.type == "cpu":
        return dense_stage_b_plain(cr, ci)
    from ._cuda_build import check, lib
    b, n1, n2 = cr.shape
    dev = cr.device
    mode = _dense_mode()
    f = const(_dense_tables(n2, mode), dev)
    sp = (_obs.begin("alloc")
          if _prof._is_profiler_enabled or _obs.switch else None)
    yr = torch.empty((b, n2, n1), dtype=cr.dtype, device=dev)
    yi = torch.empty((b, n2, n1), dtype=cr.dtype, device=dev)
    if sp:
        _obs.end(sp)
    _COUNTS["alloc_bytes"] += 2 * yr.nbytes
    name = _dense_name("dense_stage_b", mode)
    sp = (_obs.begin("launch")
          if _prof._is_profiler_enabled or _obs.switch else None)
    err = lib().kofft_dense_stage_b(
        cr.data_ptr(), ci.data_ptr(), f.data_ptr(), yr.data_ptr(),
        yi.data_ptr(), b, n1, n2, int(mode == "bf16x1"), dev.index,
        _stream(dev))
    check(err, f"{name} launch")
    if sp:
        _obs.end(sp)
    launches[name] += 1
    return yr, yi


def fused_four_step_fft(xr, xi, n: int):
    """Forward unnormalized DFT of (..., n) float32 planes through the
    dense pair (``fused_four_step_fft``, pallas_kernels.py:278), batch
    folded, counted as the route ``four_step``: ``dense_stage_a`` then
    ``dense_stage_b``, in the current tier's arithmetic."""
    require(fused_four_step_supported(n), InvalidValueError,
            f"fused_four_step_fft serves smooth n = odd * 2^k (odd <= 23) "
            f"in [2^14, 2^26] that split into factors >= 128; got {n}")
    batch, b = _batch(xr)
    n1, n2 = _pow2_split(n)
    classes["four_step"] += 1
    cr, ci = dense_stage_a(xr.reshape(b, n1, n2), xi.reshape(b, n1, n2))
    yr, yi = dense_stage_b(cr, ci)
    return yr.reshape(*batch, n), yi.reshape(*batch, n)


# ---------------------------------------------------------------------------
# the N-D route: the axis kernels over the trailing dims
# ---------------------------------------------------------------------------

def axes_fft_planes(xr, xi, inverse: bool = False, lead: int = 0):
    """Unnormalized DFT over every dim after the first ``lead`` (batch
    dims) of contiguous float32 planes, d >= 2 of them (inverse: N * ifftn
    over those dims), counted as the route ``axes``: ``col_fft`` on the
    (prod(shape[:a]), shape[a], prod(shape[a+1:])) view of each
    transformed dim a but the last, then ``row_fft`` on the last, the
    conjugation on the first load and the last store (the axis DFTs
    commute). Over the last two dims of (b..., n1, n2), lead = nd - 2:
    ``col_fft`` on (b, n1, n2), then ``row_fft`` on its b*n1 lines. Its
    ``route`` span, the count and the views, closes before the axis
    kernels, as on the 1-D routes."""
    shape = tuple(xr.shape)
    if len(shape) - lead < 2:
        raise InvalidValueError(
            f"axes_fft_planes needs >= 2 dims after {lead} batch dims, "
            f"got {shape}")
    sp = (_obs.begin("route")
          if _prof._is_profiler_enabled or _obs.switch else None)
    classes["axes"] += 1
    total = xr.numel()
    rows = math.prod(shape[:lead])
    views = []
    for m in shape[lead:-1]:
        views.append((rows, m, total // (rows * m)))
        rows *= m
    ar, ai = xr.reshape(views[0]), xi.reshape(views[0])
    if sp:
        _obs.end(sp)
    for a, v in enumerate(views):
        if a:
            ar, ai = ar.reshape(v), ai.reshape(v)
        ar, ai = col_fft(ar, ai, conj=inverse and a == 0)
    # the last view is (rows / m, m, shape[-1]): row_fft's rows lines
    yr, yi = row_fft(ar, ai, conj=inverse)
    return yr.reshape(shape), yi.reshape(shape)


# ---------------------------------------------------------------------------
# the one-sided STFT's frame kernel (csrc/stft_frames.cu): framing, window,
# the real line FFT by the half-length trick and the one-sided store in one
# pass, for power-of-two windows below _cufft_zone and the stage kernels
# ---------------------------------------------------------------------------

_FRAMES_THREADS = 128       # threads per block: T frames of m/16 threads
_FRAMES_MIN_WIN = 1 << 6     # m = win/2 >= 32: a line of two radix passes
_FRAMES_MAX_WIN = 1 << 11    # below _cufft_zone (2^12) and kernel_supported


def _frames_tile(win: int) -> tuple:
    """(T, S) of a frame-kernel launch at window ``win``, m = win/2 complex
    points and tpl = m/16 threads per frame: T = 128/tpl frames per block
    (4 at win 1024), and S, the stride in words between the lines of the
    split pass's half-line buffer: m/2 where a warp holds one line (tpl >=
    32), else the least S >= m/2 with S = tpl (mod 32), so that the 32/tpl
    lines of a warp fall on distinct banks."""
    m = win // 2
    tpl = m // _STAGE_E
    s = m // 2
    if tpl < 32:
        s += (tpl - s) % 32
    return _FRAMES_THREADS // tpl, s


def _frames_twiddle(win: int) -> np.ndarray:
    """The split pass's w^k = exp(-2 pi i k / win), k < win/4, float2-
    interleaved float32: built in float64 (k < win, so the phase needs no
    reduction) and rounded once."""
    def build():
        ang = (-2.0 * np.pi / win) * np.arange(win // 4, dtype=np.float64)
        return np.stack([np.cos(ang), np.sin(ang)], axis=1).ravel().astype(
            np.float32)

    return tables.custom(("framestw", win), build)


def _frames_args(win: int, dev) -> tuple:
    """(pointer, words) of the frame kernel's launch plan at window ``win``
    on ``dev``: the int64 words (win, T, S, line plan pointer, pass count,
    line table pointer, split table pointer, device) that
    ``kofft_stft_frames`` reads through the pointer. They depend on nothing
    else, so they are built once (``_ARGS``). Timed as an ``args`` span; a
    build is a ``table`` span in it."""
    sp = (_obs.begin("args")
          if _prof._is_profiler_enabled or _obs.switch else None)
    key = ("stft_frames", win, dev.index)
    hit = _ARGS.get(key)
    if hit is None:
        hit = _ARGS[key] = _obs.table_build(_build_frames_args, win, dev)
    if sp:
        _obs.end(sp)
    return hit


def _build_frames_args(win: int, dev) -> tuple:
    """The entry of ``_frames_args`` for (win, dev); the line plan and the
    tables it points to are cached host arrays and device copies, which
    outlive it (``tables.on_clear`` drops both)."""
    t, s = _frames_tile(win)
    steps, tab = _axis_plan("row", win // 2, t, _STAGE_E)
    words = np.array([win, t, s, steps.ctypes.data, len(steps) // 7,
                      const(tab, dev).data_ptr(),
                      const(_frames_twiddle(win), dev).data_ptr(),
                      dev.index], dtype=np.int64)
    return words.ctypes.data, words


def _check_frames(x, window, hop: int, nf) -> None:
    win = window.shape[0] if window.dim() == 1 else 0
    if not (x.dtype == _F32 and window.dtype == _F32 and x.dim() >= 1
            and x.numel() > 0 and x.is_contiguous()
            and window.is_contiguous() and x.device == window.device
            and x.device.type in ("cpu", "cuda") and win & (win - 1) == 0
            and _FRAMES_MIN_WIN <= win <= _FRAMES_MAX_WIN
            and hop >= 1 and (nf is None or nf >= 1)):
        raise InvalidValueError(
            f"stft_frames: takes a non-empty contiguous float32 signal "
            f"(..., N) and a contiguous float32 window of a power of two in "
            f"[{_FRAMES_MIN_WIN}, {_FRAMES_MAX_WIN}] points on one cpu or "
            f"cuda device, hop >= 1 and nf >= 1; got {tuple(x.shape)} "
            f"{x.dtype} on {x.device} (contiguous {x.is_contiguous()}), "
            f"window {tuple(window.shape)} {window.dtype} on "
            f"{window.device}, hop {hop}, nf {nf}")


def stft_frames_plain(x, window, hop: int, nf: int):
    """Plain version of the frame kernel, its algorithm in torch ops: the
    windowed frames packed as m = win/2 complex points z[j] = x[2j] w[2j] +
    i x[2j+1] w[2j+1], their line FFT Z (``row_fft_plain``), then the split
    pass with E = (Z[k] + Z[m-k]*)/2 and P = w^k (Z[k] - Z[m-k]*)/2:
    X[k] = E - iP and X[m-k] = (E + iP)* for k < m/2, X[m/2] = Z[m/2]*."""
    win = window.shape[0]
    m, h = win // 2, win // 4
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    xs = x.reshape(-1, n)
    if (nf - 1) * hop + win > n:
        xs = torch.nn.functional.pad(xs, (0, (nf - 1) * hop + win - n))
    idx = (torch.arange(nf, device=x.device)[:, None] * hop
           + torch.arange(win, device=x.device)[None, :])
    fr = xs[:, idx] * window                              # (rows, nf, win)
    zr, zi = row_fft_plain(fr[..., 0::2].contiguous(),
                           fr[..., 1::2].contiguous())
    kb = (m - torch.arange(h, device=x.device)) % m
    ar, ai, br, bi = zr[..., :h], zi[..., :h], zr[..., kb], zi[..., kb]
    tw = const(_frames_twiddle(win), x.device).view(h, 2)
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    od, oi = 0.5 * (ar - br), 0.5 * (ai + bi)
    pr = tw[:, 0] * od - tw[:, 1] * oi
    pi = tw[:, 0] * oi + tw[:, 1] * od
    yr = torch.cat([er + pi, zr[..., h:h + 1], torch.flip(er - pi, (-1,))],
                   dim=-1)
    yi = torch.cat([ei - pr, -zi[..., h:h + 1],
                    torch.flip(-(ei + pr), (-1,))], dim=-1)
    return yr.reshape(*lead, nf, m + 1), yi.reshape(*lead, nf, m + 1)


def stft_frames(x, window, hop: int, nf: int | None = None):
    """One-sided STFT frames of real float32 signals (..., N) -> (re, im)
    planes (..., F, win/2 + 1): frame f starts at f*hop and is zero-padded
    past the signal's end, times ``window`` (float32, win a power of two
    in [64, 2048]), and keeps bins 0 ... win/2 of its DFT. F = ceil(N /
    hop) unless ``nf`` sets it. CUDA tensors launch the frame kernel, one
    launch per call into one allocation that holds both planes; CPU tensors
    run ``stft_frames_plain``. Every call
    counts once in ``classes``, every launch in ``launches``."""
    _check_frames(x, window, hop, nf)
    nf = -(-x.shape[-1] // hop) if nf is None else nf
    classes["stft_frames"] += 1
    if not x.is_cuda:
        return stft_frames_plain(x, window, hop, nf)
    from ._cuda_build import check, lib
    dev = x.device
    plan = _frames_args(window.shape[0], dev)[0]
    lead, n = x.shape[:-1], x.shape[-1]
    on = _prof._is_profiler_enabled or _obs.switch
    sp = _obs.begin("alloc") if on else None
    y = torch.empty((2, *lead, nf, window.shape[0] // 2 + 1), dtype=_F32,
                    device=dev)
    if sp:
        _obs.end(sp)
    _COUNTS["alloc_bytes"] += y.nbytes
    sp = _obs.begin("launch") if on else None
    check(lib().kofft_stft_frames(
        x.data_ptr(), window.data_ptr(), y.data_ptr(), math.prod(lead), n,
        nf, hop, plan, _stream(dev)), "stft_frames launch")
    if sp:
        _obs.end(sp)
    launches["stft_frames"] += 1
    return y.unbind(0)
