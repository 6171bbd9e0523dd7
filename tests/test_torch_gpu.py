"""The port's CUDA kernels (the complex and real stage kernels with their
bfloat16 I/O forms, the N-D axis kernels and the dense four-step pair)
against their plain PyTorch versions, and the public entries, on the
card. Every test here carries the ``gpu`` marker and skips without a
CUDA device; whether one exists is decided inside the fixture. Run on the
card with ``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
(``--noconftest``: the shared conftest imports jax, which the port does
not need).

Tolerances: kernel vs plain >= 110 dB (both are float32 evaluations of the
same recursion with equal tables; the kernel sums with direct complex
FMAs, the plain version with the Gauss three-product, so they differ only
in rounding order); each vs the float64 numpy FFT > 100 dB
(SNR_FLOOR_DB of tests/test_fft.py), the N-D routes included. A bf16 form
that stores bf16 is held against its plain version in bf16 at >= 40 dB
(both round the same float32 sums once, so they differ by at most one
bf16 ulp where the sums round differently); bf16 routes >= 40 dB against
the float64 FFT of their bf16 input, and the `default` tier's float32
route >= 42 dB (its floor). The dense pair's `default` instances (one
bf16 pass) are held against their bf16-rounding plain versions at
>= 100 dB and against float64 at the tier's 42 dB.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

pytestmark = pytest.mark.gpu

PORT_DB = 110.0
ORACLE_DB = 100.0
BF16_DB = 40.0
# a bf16-stored kernel against its plain version: both round the same
# float32 sums to nearest even (~88 dB on the card); a truncating store or
# bf16 sums would read 45-55 dB
BF16_PLAIN_DB = 70.0
DEFAULT_DB = 42.0
# the dense pair's bf16x1 instances against their plain versions, which
# round the same operands to bf16: float32 summation order only
DENSE_BF16_DB = 100.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest -m gpu --noconftest "
                    "tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np(r, i):
    return r.double().cpu().numpy() + 1j * i.double().cpu().numpy()


def _planes(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2,) + shape).astype(np.float32)
    return torch.as_tensor(a[0], device=dev), torch.as_tensor(a[1], device=dev)


@pytest.mark.parametrize("b,n,conj", [
    (1, 1 << 14, False), (8, 1 << 14, False), (2, 1 << 16, False),
    (1, 3 << 18, False), (1, 23 << 14, False), (1, 9 << 14, False),
    (1, 5 << 16, False), (1, 7 << 14, False), (1, 11 << 14, False),
    (1, 13 << 14, False), (1, 15 << 14, False), (1, 17 << 14, False),
    (1, 19 << 14, False), (1, 21 << 14, False), (2, 3 << 23, False),
    (1, 1 << 22, False), (1, 1 << 23, False), (1, 1 << 26, False),
    (2, 1 << 16, True), (1, 3 << 18, True), (1, 23 << 14, True),
    (1, 1 << 23, True), (1, 1 << 26, True)])
def test_stages_match_plain(cuda, b, n, conj):
    """Both stages against their plain versions at one-launch columns,
    smooth n1 (the odd plan, one n per odd o = 3 ... 23, and 3072 x 8192),
    a stage-2 cluster (2^23) and the column four-step (2^26), forward and
    inverse; one count per wrapper call."""
    n1, n2 = HK._pow2_split(n)
    ar, ai = _planes((b, n1, n2), cuda)
    before = dict(HK.launches)
    cr, ci = HK.stage1(ar, ai, conj)
    pr, pi = HK.stage1_plain(ar, ai, conj)
    assert snr_db(_np(pr, pi), _np(cr, ci)) >= PORT_DB
    yr, yi = HK.stage2(cr, ci, conj)
    qr, qi = HK.stage2_plain(cr, ci, conj)
    torch.cuda.synchronize()
    assert snr_db(_np(qr, qi), _np(yr, yi)) >= PORT_DB
    assert HK.launches["stage1"] == before["stage1"] + 1
    assert HK.launches["stage2"] == before["stage2"] + 1
    x = _np(ar, ai).reshape(b, n)
    ref = np.fft.ifft(x, axis=-1) * n if conj else np.fft.fft(x, axis=-1)
    assert snr_db(ref, _np(yr, yi).reshape(b, n)) > ORACLE_DB


def test_inverse_and_donate(cuda):
    n = 1 << 16
    xr, xi = _planes((2, n), cuda, seed=1)
    x = _np(xr, xi)
    yr, yi = HK.fused_multilevel_fft(xr, xi, n, inverse=True)
    assert snr_db(np.fft.ifft(x, axis=-1) * n, _np(yr, yi)) > ORACLE_DB
    dr, di = xr.clone(), xi.clone()
    zr, zi = HK.fused_multilevel_fft(dr, di, n, donate=True)
    torch.cuda.synchronize()
    assert zr.data_ptr() == dr.data_ptr() and zi.data_ptr() == di.data_ptr()
    assert snr_db(np.fft.fft(x, axis=-1), _np(zr, zi)) > ORACLE_DB


def test_public_grad_on_card(cuda):
    import kofft_tpu_torch as kt
    n = 1 << 14
    xr, xi = _planes((n,), cuda, seed=2)
    gr, gi = _planes((n,), cuda, seed=3)
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    yr, yi = kt.fft_split(xr, xi)
    (yr * gr + yi * gi).sum().backward()
    want = np.fft.ifft(_np(gr, gi)) * n
    assert snr_db(want, _np(xr.grad, xi.grad)) > ORACLE_DB


@pytest.mark.parametrize("b,n", [(1, 1 << 14), (4, 1 << 14), (1, 1 << 16),
                                 (2, 3 << 14)])
def test_real_stages_match_plain(cuda, b, n):
    n1, n2 = HK._pow2_split(n)
    ar, _ = _planes((b, n1, n2), cuda, seed=4)
    before = dict(HK.launches)
    cr, ci = HK.stage1_real(ar)
    pr, pi = HK.stage1_real_plain(ar)
    assert snr_db(_np(pr, pi), _np(cr, ci)) >= PORT_DB
    yr, yi = HK.stage2_half(cr, ci)
    qr, qi = HK.stage2_half_plain(cr, ci)
    torch.cuda.synchronize()
    assert tuple(yr.shape) == (b, n // 2 + 1)
    assert snr_db(_np(qr, qi), _np(yr, yi)) >= PORT_DB
    assert HK.launches["stage1_real"] == before["stage1_real"] + 1
    assert HK.launches["stage2_half"] == before["stage2_half"] + 1
    ref = np.fft.rfft(ar.double().cpu().numpy().reshape(b, n), axis=-1)
    assert snr_db(ref, _np(yr, yi)) > ORACLE_DB
    assert snr_db(ref[:, -1], _np(yr, yi)[:, -1]) > ORACLE_DB   # Nyquist


def test_public_rfft_irfft_on_card(cuda):
    import kofft_tpu_torch as kt
    n = 1 << 16
    x = np.random.default_rng(5).standard_normal((3, n)).astype(np.float32)
    before = dict(HK.launches)
    y = kt.rfft(x)                  # host input, default device: the card
    assert y.device.type == "cuda"
    assert HK.launches["stage1_real"] > before["stage1_real"]
    ref = np.fft.rfft(x.astype(np.float64))
    assert snr_db(ref, y.cpu().numpy()) > ORACLE_DB
    back = kt.irfft(y, n=n)
    assert snr_db(x, back.cpu().numpy()) > ORACLE_DB
    yr, yi = kt.rfft_split(torch.as_tensor(x[0], device=cuda))
    assert snr_db(ref[0], _np(yr, yi)) > ORACLE_DB


def test_rfft_grad_on_card(cuda):
    import kofft_tpu_torch as kt
    n = 1 << 16
    h = n // 2 + 1
    x, _ = _planes((n,), cuda, seed=6)
    gr, gi = _planes((h,), cuda, seed=7)
    x.requires_grad_(True)
    yr, yi = kt.rfft_split(x)
    (yr * gr + yi * gi).sum().backward()
    full = np.zeros(n, np.complex128)
    full[:h] = _np(gr, gi)
    want = (np.fft.ifft(full) * n).real
    assert snr_db(want, x.grad.double().cpu().numpy()) > ORACLE_DB


def test_rejects_bad_planes(cuda):
    ar, ai = _planes((1, 128, 128), cuda)
    with pytest.raises(ValueError):
        HK.stage1(ar.double(), ai.double())
    with pytest.raises(ValueError):
        HK.stage1(ar.transpose(1, 2), ai.transpose(1, 2))


@pytest.mark.parametrize("shape", [(1, 1024, 1024), (8, 512, 512),
                                   (2, 128, 256), (1, 8192, 128),
                                   (1, 128, 8192), (1, 2048, 256),
                                   (1, 4096, 128)])
@pytest.mark.parametrize("conj", [False, True])
def test_axis_kernels_match_plain(cuda, shape, conj):
    ar, ai = _planes(shape, cuda, seed=8)
    before = dict(HK.launches)
    cr, ci = HK.col_fft(ar, ai, conj)
    pr, pi = HK.col_fft_plain(ar, ai, conj)
    yr, yi = HK.row_fft(ar, ai, conj)
    qr, qi = HK.row_fft_plain(ar, ai, conj)
    torch.cuda.synchronize()
    assert snr_db(_np(pr, pi), _np(cr, ci)) >= PORT_DB
    assert snr_db(_np(qr, qi), _np(yr, yi)) >= PORT_DB
    assert HK.launches["col_fft"] == before["col_fft"] + 1
    assert HK.launches["row_fft"] == before["row_fft"] + 1
    x = _np(ar, ai)
    x = np.conj(x) if conj else x
    assert snr_db(np.fft.fft(x, axis=1), _np(cr, ci)) > ORACLE_DB
    want = np.fft.fft(_np(ar, ai), axis=2)
    assert snr_db(np.conj(want) if conj else want, _np(yr, yi)) > ORACLE_DB


@pytest.mark.parametrize("shape,axes,cls", [
    ((1024, 1024), (0, 1), "fft2"),
    ((4, 512, 512), (1, 2), "fft2"),
    ((2048, 2048), (0, 1), "fft2_big"),
    ((128, 128, 128), None, "fused_nd"),
    ((512, 256), None, "fused_nd"),
])
def test_nd_routes_on_card(cuda, shape, axes, cls):
    import kofft_tpu_torch as kt
    xr, xi = _planes(shape, cuda, seed=9)
    x = _np(xr, xi)
    HK.reset_counts()
    yr, yi = kt.fftn_split(xr, xi, axes=axes)
    assert HK.classes[cls] == 1
    assert HK.launches["col_fft"] == (len(shape) - 1 if axes is None else 1)
    assert HK.launches["row_fft"] == 1
    assert snr_db(np.fft.fftn(x, axes=axes), _np(yr, yi)) > ORACLE_DB
    br, bi = kt.fftn_split(yr, yi, axes=axes, inverse=True)
    assert snr_db(x, _np(br, bi)) > ORACLE_DB


@pytest.mark.parametrize("shape", [(512, 256), (128, 128, 128)])
def test_fused_nd_route_matches_plain(cuda, shape):
    xr, xi = _planes(shape, cuda, seed=10)
    for inverse in (False, True):
        yr, yi = HK.fused_ndfft_planes(xr, xi, inverse)
        pr, pi = HK.fused_nd_plain(xr, xi, conj=inverse)
        torch.cuda.synchronize()
        assert snr_db(_np(pr, pi), _np(yr, yi)) > ORACLE_DB


def test_nd_grad_on_card(cuda):
    import kofft_tpu_torch as kt
    shape = (1024, 256)
    xr, xi = _planes(shape, cuda, seed=11)
    gr, gi = _planes(shape, cuda, seed=12)
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    yr, yi = kt.fftn_split(xr, xi)
    (yr * gr + yi * gi).sum().backward()
    want = np.fft.ifftn(_np(gr, gi)) * xr.numel()
    assert snr_db(want, _np(xr.grad, xi.grad)) > ORACLE_DB


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
@pytest.mark.parametrize("b,n", [(1, 1 << 14), (3, 1 << 14), (1, 3 << 14),
                                 (2, 1 << 16)])
def test_dense_stages_match_plain(cuda, b, n, tier):
    """The tier's tensor-core instance of each dense stage against its
    plain version (on `default` the bf16-rounding one), counted under the
    instance's name; the pair against float64 at the tier's floor."""
    from kofft_tpu_torch import config
    n1, n2 = HK._pow2_split(n)
    ar, ai = _planes((b, n1, n2), cuda, seed=13)
    config.set_precision(tier)
    try:
        mode = HK._dense_mode()
        names = [HK._dense_name(k, mode) for k in ("dense_stage_a",
                                                    "dense_stage_b")]
        assert mode == ("bf16x1" if tier == "default" else "tf32x3")
        before = dict(HK.launches)
        cr, ci = HK.dense_stage_a(ar, ai)
        pr, pi = HK.dense_stage_a_plain(ar, ai)
        yr, yi = HK.dense_stage_b(cr, ci)
        qr, qi = HK.dense_stage_b_plain(cr, ci)
        torch.cuda.synchronize()
        floor = DENSE_BF16_DB if mode == "bf16x1" else PORT_DB
        assert snr_db(_np(pr, pi), _np(cr, ci)) >= floor
        assert snr_db(_np(qr, qi), _np(yr, yi)) >= floor
        assert all(HK.launches[k] == before[k] + 1 for k in names)
        assert sum(HK.launches.values()) == sum(before.values()) + 2
        ref = np.fft.fft(_np(ar, ai).reshape(b, n), axis=-1)
        oracle = DEFAULT_DB if mode == "bf16x1" else ORACLE_DB
        assert snr_db(ref, _np(yr, yi).reshape(b, n)) > oracle
        HK.reset_counts()
        fr, fi = HK.fused_four_step_fft(ar.reshape(b, n), ai.reshape(b, n),
                                        n)
        assert HK.classes["four_step"] == 1
        assert [HK.launches[k] for k in names] == [1, 1]
        assert snr_db(ref, _np(fr, fi)) > oracle
    finally:
        config.set_precision(None)


def _form_cases():
    return [(base, f) for base, forms in HK._IO_FORMS.items()
            for f in forms if f != "ff"]


@pytest.mark.parametrize("shape", [(2, 256, 512), (1, 2048, 4096)])
@pytest.mark.parametrize("base,form", _form_cases())
def test_bf16_forms_match_plain(cuda, base, form, shape):
    """Each bf16 I/O form against its plain version on the same input, at
    whole-block tiles and at 2048 x 4096 (a stage-2 cluster): float32
    outputs >= 110 dB, bf16 outputs >= 70 dB in bf16."""
    loads, stores = (HK._LETTER_DTYPE[c] for c in form)
    ar, ai = _planes(shape, cuda, seed=14)
    ar, ai = ar.to(loads), ai.to(loads)
    if base == "stage1":
        got = HK.stage1(ar, ai, c_dtype=stores)
        want = HK.stage1_plain(ar, ai, c_dtype=stores)
    elif base == "stage1_real":
        got = HK.stage1_real(ar, c_dtype=stores)
        want = HK.stage1_real_plain(ar, c_dtype=stores)
    elif base == "stage2":
        got = HK.stage2(ar, ai, dtype=stores)
        want = HK.stage2_plain(ar, ai, dtype=stores)
    else:
        got = HK.stage2_half(ar, ai, dtype=stores)
        want = HK.stage2_half_plain(ar, ai, dtype=stores)
    torch.cuda.synchronize()
    assert got[0].dtype == got[1].dtype == stores
    floor = PORT_DB if stores == torch.float32 else BF16_PLAIN_DB
    assert snr_db(_np(*want), _np(*got)) >= floor
    assert HK.launches[f"{base}_{form}"] >= 1


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("shape,forms", [
    ((1 << 16,), ("_bf", "_fb")),
    ((3, 1 << 16), ("_bf", "_fb")),
])
def test_bf16_routes_on_card(cuda, real, shape, forms):
    """bf16 planes on a phased-served shape launch the bf16 forms and
    return bf16."""
    import kofft_tpu_torch as kt
    xr, xi = _planes(shape, cuda, seed=15)
    xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
    HK.reset_counts()
    if real:
        yr, yi = kt.rfft_split(xr)
        ref = np.fft.rfft(xr.double().cpu().numpy(), axis=-1)
        names = ("stage1_real", "stage2_half")
    else:
        yr, yi = kt.fft_split(xr, xi)
        ref = np.fft.fft(_np(xr, xi), axis=-1)
        names = ("stage1", "stage2")
    assert yr.dtype == yi.dtype == torch.bfloat16
    assert HK.classes["phased_tiled_real" if real else "phased_tiled"] == 1
    for name, form in zip(names, forms):
        assert HK.launches[name + form] == 1
    assert snr_db(ref, _np(yr, yi)) > BF16_DB


@pytest.mark.parametrize("real", [False, True])
def test_default_tier_routes_on_card(cuda, real):
    """The `default` tier reads float32 planes as bf16 and keeps C bf16 on
    the `ml` pair, with float32 output, >= 42 dB."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch import config
    shape = (8, 1 << 14)                      # batch-folded: class ml
    xr, xi = _planes(shape, cuda, seed=16)
    HK.reset_counts()
    config.set_precision("default")
    try:
        if real:
            yr, yi = kt.rfft_split(xr)
        else:
            yr, yi = kt.fft_split(xr, xi)
    finally:
        config.set_precision(None)
    if real:
        ref = np.fft.rfft(xr.double().cpu().numpy(), axis=-1)
        assert HK.launches["stage1_real_bb"] == HK.launches[
            "stage2_half_bf"] == 1
    else:
        ref = np.fft.fft(_np(xr, xi), axis=-1)
        assert HK.launches["stage1_bb"] == HK.launches["stage2_bf"] == 1
    assert yr.dtype == torch.float32
    assert snr_db(ref, _np(yr, yi)) > DEFAULT_DB


def test_bf16_grad_on_card(cuda):
    import kofft_tpu_torch as kt
    n = 1 << 16
    xr, xi = (t.to(torch.bfloat16) for t in _planes((n,), cuda, seed=17))
    gr, gi = (t.to(torch.bfloat16) for t in _planes((n,), cuda, seed=18))
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    yr, yi = kt.fft_split(xr, xi)
    (yr * gr + yi * gi).float().sum().backward()
    assert xr.grad.dtype == torch.bfloat16
    want = np.fft.ifft(_np(gr, gi)) * n
    assert snr_db(want, _np(xr.grad, xi.grad)) > BF16_DB


def test_vmap_over_kernel_paths(cuda):
    """torch.func.vmap over the entries runs the kernels through the ops'
    vmap rules and matches a loop over the slices."""
    import kofft_tpu_torch as kt
    xr, xi = _planes((3, 1 << 14), cuda, seed=19)
    HK.reset_counts()
    yr, yi = torch.func.vmap(kt.fft_split)(xr, xi)
    assert HK.launches["stage1"] == 1
    for k in range(3):
        lr, li = kt.fft_split(xr[k], xi[k])
        assert snr_db(_np(lr, li), _np(yr[k], yi[k])) > ORACLE_DB
    yr, yi = torch.func.vmap(kt.rfft_split)(xr)
    assert HK.launches["stage1_real"] == 1
    for k in range(3):
        lr, li = kt.rfft_split(xr[k])
        assert snr_db(_np(lr, li), _np(yr[k], yi[k])) > ORACLE_DB
    for shape in [(1024, 1024), (128, 128, 128)]:
        xr, xi = _planes((2,) + shape, cuda, seed=20)
        yr, yi = torch.func.vmap(kt.fftn_split)(xr, xi)
        for k in range(2):
            lr, li = kt.fftn_split(xr[k], xi[k])
            assert snr_db(_np(lr, li), _np(yr[k], yi[k])) > ORACLE_DB
            assert snr_db(np.fft.fftn(_np(xr[k], xi[k])),
                          _np(yr[k], yi[k])) > ORACLE_DB


def test_tables_clear_then_transform(cuda):
    """tables.clear() drops the host tables, their device copies and the
    cached launch arguments; the next transforms rebuild them and give
    the same result."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.plan import tables
    xr, xi = _planes((1 << 16,), cuda, seed=21)
    gr, gi = _planes((128, 128, 128), cuda, seed=22)
    before = (kt.fft_split(xr, xi), kt.fftn_split(gr, gi))
    tables.clear()
    assert len(tables) == 0
    after = (kt.fft_split(xr, xi), kt.fftn_split(gr, gi))
    assert len(tables) > 0
    for (ar, ai), (br, bi) in zip(before, after):
        assert torch.equal(ar, br) and torch.equal(ai, bi)
