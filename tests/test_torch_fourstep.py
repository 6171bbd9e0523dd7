"""The dense four-step pair, the bfloat16 I/O forms and the tests-only
phased forms of the port against kofft_tpu on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_pallas.py
does. The same seeded numpy inputs go through both.

Tolerances:
- float32: port vs JAX >= 110 dB (float32 evaluations of one algorithm
  with bit-equal tables, differing only in summation order); each vs the
  float64 FFT >= 100 dB (tests/test_pallas.py:53).
- bfloat16 planes: each side >= 30 dB against the float64 FFT of the bf16
  input (tests/test_pallas.py:650); port vs JAX >= 40 dB, because each
  rounds its float32 result to bf16 once, so the two differ by at most one
  bf16 ulp where their sums round differently.
- the `default` tier: each side >= 42 dB against float64 (the tier's
  floor), not against the other: the JAX package skips that tier's bf16
  casts in interpret mode (pallas_kernels.py:1204, :1223).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import kofft_tpu as jk  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu import config as jcfg  # noqa: E402
from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu.plan import tables as jax_tables  # noqa: E402
from kofft_tpu_torch import config as tcfg  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402
from kofft_tpu_torch.plan import tables  # noqa: E402

PORT_DB = 110.0
ORACLE_DB = 100.0
BF16_ORACLE_DB = 30.0
BF16_PORT_DB = 40.0
DEFAULT_DB = 42.0
BF16 = torch.bfloat16


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2,) + tuple(shape)).astype(np.float32)
    return a[0], a[1]


def _c(r, i):
    return np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64)


def _t(*arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def _np(*ts):
    return _c(*(t.float().numpy() for t in ts))


# ---------------------------------------------------------------------------
# the dense four-step pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1 << 14,), (1 << 15,), (3, 1 << 14),
                                   (3 << 14,)])
def test_fused_four_step_vs_jax(shape):
    n = shape[-1]
    xr, xi = _planes(shape, n + len(shape))
    jr, ji = PK.fused_four_step_fft(jnp.asarray(xr), jnp.asarray(xi), n,
                                    interpret=True)
    HK.reset_counts()
    tr, ti = HK.fused_four_step_fft(*_t(xr, xi), n)
    assert HK.classes == {k: int(k == "four_step") for k in HK.classes}
    assert HK.launches == {k: 0 for k in HK.launches}   # CPU: plain versions
    assert tuple(tr.shape) == shape
    got = _np(tr, ti)
    ref = np.fft.fft(_c(xr, xi), axis=-1)
    assert snr_db(_c(jr, ji), got) >= PORT_DB
    assert snr_db(ref, got) >= ORACLE_DB
    assert snr_db(ref, _c(jr, ji)) >= ORACLE_DB


@pytest.mark.parametrize("b,n", [(1, 1 << 14), (2, 3 << 14)])
def test_dense_stages_plain_vs_jax(b, n):
    n1, n2, stage_a, stage_b = PK._build(n, "float32", True, "highest")
    assert (n1, n2) == HK._pow2_split(n)
    ar, ai = _planes((b, n1, n2), 3 + b)
    jr, ji = stage_a(b, jnp.asarray(ar), jnp.asarray(ai))
    cr, ci = HK.dense_stage_a_plain(*_t(ar, ai))
    assert snr_db(_c(jr, ji), _np(cr, ci)) >= PORT_DB
    c_r, c_i = cr.numpy(), ci.numpy()
    jr, ji = stage_b(b, jnp.asarray(c_r), jnp.asarray(c_i))
    yr, yi = HK.dense_stage_b_plain(*_t(c_r, c_i))
    assert tuple(yr.shape) == (b, n2, n1)
    assert snr_db(_c(jr, ji), _np(yr, yi)) >= PORT_DB
    ref = np.fft.fft(_c(ar, ai).reshape(b, n), axis=-1)
    assert snr_db(ref, _np(yr, yi).reshape(b, n)) >= ORACLE_DB


SUPPORT_SIZES = ([1 << k for k in range(10, 28)]
                 + [3 << 14, 5 << 16, 9 << 14, 23 << 14, 25 << 14, 1000,
                    3 << 12, 7 << 20, (1 << 14) + 1, 3 << 24])


def test_four_step_supported_vs_jax():
    got = [HK.fused_four_step_supported(n) for n in SUPPORT_SIZES]
    assert got == [PK.fused_four_step_supported(n) for n in SUPPORT_SIZES]
    assert any(got) and not all(got)


def test_dense_tables_bit_equal():
    """The pair's state is its constant tables: the DFT planes and the
    twiddle plane are bit for bit kofft_tpu's, and the third Gauss operand
    is their float32 sum."""
    for m in (128, 384, 1024):
        fr, fi, fs = HK._dense_dft(m)
        jr, ji = jax_tables.dft_matrix(m, "float32")
        assert np.array_equal(fr, jr) and np.array_equal(fi, ji)
        assert fs.dtype == np.float32
        assert np.array_equal(fs, (jr + ji).astype(np.float32))
        # symmetric bit for bit: the kernel reads F[j, k] as F[k, j]
        assert np.array_equal(fr, fr.T) and np.array_equal(fi, fi.T)
    for n1, n2 in ((128, 128), (384, 128), (1024, 2048)):
        mine = tables.twiddle(n1, n2, "float32")
        theirs = jax_tables.twiddle(n1, n2, "float32")
        for a, b in zip(mine, theirs):
            assert a.dtype == np.float32 and np.array_equal(a, b)


def test_dense_wrappers_reject_other_planes():
    a = torch.zeros((1, 128, 128), dtype=BF16)
    with pytest.raises(tk.InvalidValueError):
        HK.dense_stage_a(a, a)
    b = torch.zeros((1, 96, 128))
    with pytest.raises(tk.InvalidValueError):
        HK.dense_stage_b(b, b)
    with pytest.raises(tk.InvalidValueError):
        HK.fused_four_step_fft(torch.zeros(1000), torch.zeros(1000), 1000)


# ---------------------------------------------------------------------------
# the tests-only phased forms: wide rows and complex flat with b > 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,wide,flat", [(2, True, False),
                                            (4, True, False),
                                            (1, False, True)])
def test_phased_forms_vs_port(rows, wide, flat):
    """``_build_phased(wide=True)`` and complex flat with b = 4 compute the
    function the port's stage pair computes."""
    n, b = 1 << 14, 4
    n1, n2 = HK._pow2_split(n)
    ar, ai = _planes((b, n1, n2), 20 + rows)
    run = PK._build_phased(n, "float32", True, "highest", rows=rows,
                           wide=wide, flat=flat)
    jr, ji = run(b, jnp.asarray(ar), jnp.asarray(ai))
    want = _c(jr, ji).reshape(b, n)
    tr, ti = HK.fused_multilevel_fft(*_t(ar.reshape(b, n), ai.reshape(b, n)),
                                     n)
    got = _np(tr, ti)
    assert snr_db(want, got) >= PORT_DB
    assert snr_db(np.fft.fft(_c(ar, ai).reshape(b, n), axis=-1), got) \
        >= ORACLE_DB


def test_real_wide_form_vs_port():
    """The real wide form's one-sided rows plus the Nyquist bin from its
    C[k1 = 0] rows, assembled as tests/test_pallas.py:813-821 does."""
    n, b = 1 << 14, 4
    n1, n2 = HK._pow2_split(n)
    x, _ = _planes((b, n1, n2), 30)
    run = PK._build_phased(n, "float32", True, "highest", real=True,
                           rows=2, wide=True)
    hr, hi, c0r, c0i = run(b, jnp.asarray(x))
    signs = np.where(np.arange(n2) % 2 == 0, 1.0, -1.0).astype(np.float32)
    nr = (np.asarray(c0r)[:, 0, :] * signs).sum(-1)[:, None]
    ni = (np.asarray(c0i)[:, 0, :] * signs).sum(-1)[:, None]
    want = (np.concatenate([np.asarray(hr, np.float64).reshape(b, n // 2),
                            nr], -1)
            + 1j * np.concatenate(
                [np.asarray(hi, np.float64).reshape(b, n // 2), ni], -1))
    tr, ti = HK.fused_multilevel_rfft(torch.as_tensor(x.reshape(b, n)), n)
    got = _np(tr, ti)
    assert snr_db(want, got) >= PORT_DB
    assert snr_db(np.fft.rfft(x.reshape(b, n).astype(np.float64)), got) \
        >= ORACLE_DB


# ---------------------------------------------------------------------------
# bfloat16 planes
# ---------------------------------------------------------------------------

def _bf16(a):
    """(torch bf16 tensor, jax bf16 array, float64 numpy of the bf16
    values) of a float32 array."""
    t = torch.as_tensor(a).to(BF16)
    return t, jnp.asarray(a, jnp.bfloat16), t.double().numpy()


@pytest.mark.parametrize("entry", ["fft_split", "rfft_split"])
@pytest.mark.parametrize("shape,types", [((1 << 14,), (BF16, torch.float32)),
                                         ((3, 1 << 14), (BF16, torch.float32)),
                                         ((2, 1 << 14), None)])
def test_bf16_public_vs_jax(entry, shape, types):
    """The 1-D entries take bf16 planes to the kernels' bf16 forms where
    the JAX phased grid serves the shape (bf16 in, a float32 C, also for a
    flat transform) and run the float32 types otherwise (the batch-folded
    (2, 2^14)); the output is bf16 either way."""
    xr, xi = _planes(shape, 40 + len(shape))
    tr, jr, r64 = _bf16(xr)
    ti, ji, i64 = _bf16(xi)
    cls = "stages_real" if entry == "rfft_split" else "stages"
    b = 1 if len(shape) == 1 else shape[0]
    assert HK._stage_types(shape[-1], b, len(shape) == 1, BF16,
                           real=entry == "rfft_split") == types
    HK.reset_counts()
    if entry == "fft_split":
        yr, yi = tk.fft_split(tr, ti)
        wr, wi = jk.fft_split(jr, ji)
        ref = np.fft.fft(r64 + 1j * i64, axis=-1)
    else:
        yr, yi = tk.rfft_split(tr)
        wr, wi = jk.rfft_split(jr)
        ref = np.fft.rfft(r64, axis=-1)
    assert HK.classes == {k: int(k == cls) for k in HK.classes}
    assert yr.dtype == yi.dtype == BF16
    assert wr.dtype == jnp.bfloat16
    got = _np(yr, yi)
    want = _c(np.asarray(wr, np.float32), np.asarray(wi, np.float32))
    assert snr_db(ref, got) >= BF16_ORACLE_DB
    assert snr_db(ref, want) >= BF16_ORACLE_DB
    assert snr_db(want, got) >= BF16_PORT_DB


@pytest.mark.parametrize("real,shape", [(False, (1 << 14,)),
                                        (False, (8, 1 << 14)),
                                        (True, (1 << 14,))])
def test_bf16_multilevel_vs_jax(real, shape):
    """fused_multilevel_fft / _rfft on bf16 planes against the JAX entries
    in interpret mode (tests/test_pallas.py:634-663): the served shape
    rides the bf16-I/O phased form, the batch-folded one the float32
    route rounded back."""
    n = shape[-1]
    xr, xi = _planes(shape, 50 + len(shape))
    tr, jr, r64 = _bf16(xr)
    ti, ji, i64 = _bf16(xi)
    if real:
        wr, wi = PK.fused_multilevel_rfft(jr, n, interpret=True)
        yr, yi = HK.fused_multilevel_rfft(tr, n)
        ref = np.fft.rfft(r64, axis=-1)
    else:
        wr, wi = PK.fused_multilevel_fft(jr, ji, n, interpret=True)
        yr, yi = HK.fused_multilevel_fft(tr, ti, n)
        ref = np.fft.fft(r64 + 1j * i64, axis=-1)
    assert yr.dtype == BF16 and wr.dtype == jnp.bfloat16
    assert tuple(yr.shape) == tuple(wr.shape)
    got = _np(yr, yi)
    want = _c(np.asarray(wr, np.float32), np.asarray(wi, np.float32))
    assert snr_db(ref, got) >= BF16_ORACLE_DB
    assert snr_db(ref, want) >= BF16_ORACLE_DB
    assert snr_db(want, got) >= BF16_PORT_DB


def test_bf16_grad_vs_jax():
    """The backward of fft_split on bf16 planes runs the bf16 forms on the
    bf16 cotangent: a bf16 gradient against the JAX package's, and
    against the unnormalized inverse of the cotangent."""
    import jax
    n = 1 << 14
    xr, xi = _planes((n,), 80)
    gr, gi = _planes((n,), 81)
    tr, jr, _ = _bf16(xr)
    ti, ji, _ = _bf16(xi)
    tgr, jgr, g64r = _bf16(gr)
    tgi, jgi, g64i = _bf16(gi)
    tr.requires_grad_(True)
    ti.requires_grad_(True)
    yr, yi = tk.fft_split(tr, ti)
    (yr * tgr + yi * tgi).float().sum().backward()
    assert tr.grad.dtype == ti.grad.dtype == BF16

    def loss(a, b):
        wr, wi = jk.fft_split(a, b)
        return (wr * jgr + wi * jgi).astype(jnp.float32).sum()

    jgr_x, jgi_x = jax.grad(loss, argnums=(0, 1))(jr, ji)
    want = _c(np.asarray(jgr_x, np.float32), np.asarray(jgi_x, np.float32))
    got = _np(tr.grad, ti.grad)
    ref = np.fft.ifft(g64r + 1j * g64i) * n
    assert snr_db(ref, got) >= BF16_ORACLE_DB
    assert snr_db(ref, want) >= BF16_ORACLE_DB
    assert snr_db(want, got) >= BF16_PORT_DB


def test_bf16_forms_and_donation():
    """Only the kernels' I/O forms are accepted; a donated bf16 transform
    writes into the bf16 input storage, on the bf16 route and on the
    float32 route alike, and a donated buffer of another type raises."""
    a = torch.zeros((1, 128, 128))
    with pytest.raises(tk.InvalidValueError):
        HK.stage1(a, a, c_dtype=BF16)                # no f32 -> bf16 form
    with pytest.raises(tk.InvalidValueError):
        HK.col_fft(a.to(BF16), a.to(BF16))           # N-D kernels: f32 only
    with pytest.raises(tk.InvalidValueError):
        HK.stage2(a, a, out=(a.to(BF16), a.to(BF16)))
    n = 1 << 14
    for shape in ((n,), (2, n)):
        xr, xi = _planes(shape, 60)
        want = HK.fused_multilevel_fft(*_t(xr, xi), n)
        dr, di = (t.to(BF16) for t in _t(xr, xi))
        pr, pi = dr.data_ptr(), di.data_ptr()
        zr, zi = HK.fused_multilevel_fft(dr, di, n, donate=True)
        assert zr.data_ptr() == pr and zi.data_ptr() == pi
        assert zr.dtype == BF16
        assert snr_db(_np(*want), _np(zr, zi)) >= BF16_PORT_DB


# ---------------------------------------------------------------------------
# the `default` tier's float32 route
# ---------------------------------------------------------------------------

@pytest.fixture
def default_tier():
    tcfg.set_precision("default")
    jcfg.set_precision("default")
    yield
    tcfg.set_precision(None)
    jcfg.set_precision(None)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("shape,loads,c_dtype", [
    ((1 << 14,), torch.float32, torch.float32),
    ((3, 1 << 14), BF16, torch.float32),
    ((8, 1 << 14), BF16, BF16),
])
def test_default_tier_route(default_tier, monkeypatch, real, shape, loads,
                            c_dtype):
    """On the `default` tier the float32 planes of a batch that the JAX
    phased grid serves and of one that its two-call pair folds are read as
    bf16, C is bf16 on the folded batch (and on the phased shapes above
    2^23), a flat transform stays float32, and the output is float32
    >= 42 dB against float64 on both sides."""
    n = shape[-1]
    xr, xi = _planes(shape, 70 + len(shape))
    seen = {}
    names = ("stage1_real", "stage2_half") if real else ("stage1", "stage2")

    def spy(name):
        fn = getattr(HK, name)

        def wrapped(*args, **kw):
            seen[name] = args[0].dtype
            out = fn(*args, **kw)
            seen[name + " out"] = out[0].dtype
            return out
        return wrapped

    for name in names:
        monkeypatch.setattr(HK, name, spy(name))
    cls = "stages_real" if real else "stages"
    HK.reset_counts()
    if real:
        yr, yi = HK.fused_multilevel_rfft(torch.as_tensor(xr), n)
        jr, ji = PK.fused_multilevel_rfft(jnp.asarray(xr), n, interpret=True)
        ref = np.fft.rfft(xr.astype(np.float64), axis=-1)
    else:
        yr, yi = HK.fused_multilevel_fft(*_t(xr, xi), n)
        jr, ji = PK.fused_multilevel_fft(jnp.asarray(xr), jnp.asarray(xi), n,
                                         interpret=True)
        ref = np.fft.fft(_c(xr, xi), axis=-1)
    assert HK.classes == {k: int(k == cls) for k in HK.classes}
    assert seen == {names[0]: loads, names[0] + " out": c_dtype,
                    names[1]: c_dtype, names[1] + " out": torch.float32}
    assert yr.dtype == torch.float32
    assert snr_db(ref, _np(yr, yi)) >= DEFAULT_DB
    assert snr_db(ref, _c(jr, ji)) >= DEFAULT_DB


def test_route_types_at_the_large_sizes(monkeypatch):
    """The stage kernels' (input type, C type) where only large sizes
    reach: the phased bf16 C above 2^23 on the `default` tier, and bf16
    planes above the phased cap (the float32 types, None here)."""
    f32 = torch.float32
    types = HK._stage_types
    assert types(1 << 24, 1, True, f32) == (f32, f32)
    assert types(1 << 24, 1, True, BF16) is None
    assert types(1 << 20, 8, False, BF16) == (BF16, f32)
    assert types(1 << 20, 1, True, BF16, real=True) == (BF16, f32)
    monkeypatch.setattr(tcfg.get_config(), "precision", "default")
    monkeypatch.setattr(jcfg.get_config(), "precision", "default")
    assert types(1 << 24, 1, True, f32) == (BF16, BF16)
    assert types(1 << 24, 1, True, BF16) == (BF16, BF16)
    assert types(1 << 23, 1, True, f32, real=True) == (f32, f32)
    assert types(1 << 23, 2, False, f32) == (BF16, f32)
    assert types(1 << 26, 1, True, f32, real=True) == (BF16, BF16)
    assert types(1 << 26, 1, True, BF16) is None
    for n in (1 << 22, 1 << 24, 1 << 25):
        for b in (1, 2):
            n1, n2 = HK._pow2_split(n)
            bt = PK._ml_batch_tile(b, n1, n2)
            # bf16 planes keep bf16 I/O where the JAX phased grid serves
            # the shape
            assert (types(n, b, False, BF16) is not None) == \
                PK._use_phased(n, bt) == HK._use_phased(n, bt)
