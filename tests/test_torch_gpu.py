"""The port's CUDA kernels (the complex and real stage kernels with their
bfloat16 I/O forms, the N-D axis kernels, the dense four-step pair and
the goertzel_scan recurrence) against their plain PyTorch versions, and
the public entries (the STFT, its streams and the composite transforms
among them), on the card. Every test here carries the ``gpu`` marker and
skips without a CUDA device; whether one exists is decided inside the
fixture. Run on the card with ``python -m pytest -m gpu --noconftest
tests/test_torch_gpu.py``
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
>= 100 dB and against float64 at the tier's 42 dB. The STFT and the
composite transforms: >= 100 dB against float64, an ISTFT's interior
>= 90 dB, the streams against the offline entries >= 110 dB; the
goertzel_scan kernel against its plain version within 1e-5 relative (the
same float32 operations in the same order: equal but for the plain
version's own rounding of its three tensor ops, which it does not fuse).
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


def _cat(ks):
    return {k: HK.launches[k] for k in ks}


def test_stft_on_card(cuda):
    """win = 2^14 with backend='cuda': the one-sided STFT on the real
    pair, the full one on the complex pair, the ISTFT on the complex pair
    (the inverse), each against float64; the same call on the CPU."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.ops.window import hann
    win, hop = 1 << 14, 1 << 12
    x = torch.as_tensor(np.random.default_rng(23).standard_normal(
        1 << 17, dtype=np.float32), device=cuda)
    w = hann(win)
    xn = x.double().cpu().numpy()
    nf = -(-xn.size // hop)
    fr = np.zeros((nf, win))
    for f in range(nf):
        seg = xn[f * hop: f * hop + win]
        fr[f, : seg.size] = seg
    ref = np.fft.fft(fr * w, axis=-1)
    HK.reset_counts()
    one = kt.stft(x, w, hop, onesided=True, backend="cuda")
    assert _cat(("stage1_real", "stage2_half")) == {"stage1_real": 1,
                                                    "stage2_half": 1}
    full = kt.stft_split(x, w, hop, backend="cuda")
    assert _cat(("stage1", "stage2")) == {"stage1": 1, "stage2": 1}
    assert snr_db(ref[:, : win // 2 + 1], one.cpu().numpy()) > ORACLE_DB
    assert snr_db(ref, _np(*full)) > ORACLE_DB
    back = kt.istft_split(*full, w, hop, length=xn.size, backend="cuda")
    assert HK.launches["stage1"] == 2
    assert snr_db(xn[win:-win], back.cpu().numpy()[win:-win]) > 90.0
    cpu = kt.stft(x.cpu(), w, hop, onesided=True, backend="cuda")
    assert snr_db(cpu.numpy(), one.cpu().numpy()) > PORT_DB


def test_stft_streams_on_card(cuda):
    """The chunked stream scans against the offline entries, the push
    stream in 4800-sample chunks and the per-frame ISTFT stream."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.ops import stft as S
    from kofft_tpu_torch.ops.window import hann
    win, hop = 1024, 256
    x = torch.as_tensor(np.random.default_rng(24).standard_normal(
        1 << 16, dtype=np.float32), device=cuda)
    w = hann(win)
    rr, ri = kt.stft_split(x, w, hop)
    yr, yi = kt.stft_stream_scan(x, w, hop)
    assert snr_db(_np(rr, ri), _np(yr, yi)) > PORT_DB
    st = S.StftPushStream(w, hop)
    parts = [st.push(x[i: i + 4800]) for i in range(0, x.numel(), 4800)]
    parts.append(st.flush())
    got = (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    assert snr_db(_np(rr, ri), _np(*got)) > PORT_DB
    off = kt.istft_split(rr, ri, w, hop)
    scan = kt.istft_stream_scan(rr, ri, w, hop)
    assert snr_db(off.cpu().numpy(), scan.cpu().numpy()) > PORT_DB
    ist = S.IstftStream(win, hop, w)
    pushed = np.concatenate([ist.push_frame(rr[f], ri[f])
                             for f in range(rr.shape[0])] + [ist.flush()])
    assert snr_db(off.cpu().numpy(), pushed) > PORT_DB


def test_composites_on_card(cuda):
    """The composite transforms at 2^16 (the DCT/DST fast paths and the
    FFT composites on the stage kernels) against float64 oracles."""
    import kofft_tpu_torch as kt
    n = 1 << 16
    xn = np.random.default_rng(25).standard_normal(n)
    x = torch.as_tensor(xn, dtype=torch.float32, device=cuda)
    f = np.fft.fft(xn)
    HK.reset_counts()
    assert snr_db(f.real - f.imag, kt.dht(x).cpu().numpy()) > ORACLE_DB
    assert HK.launches["stage1"] > 0
    g = np.zeros(n)
    g[0] = g[n // 2] = 1.0
    g[1: n // 2] = 2.0
    assert snr_db(np.fft.ifft(f * g),
                  kt.hilbert_analytic(x).cpu().numpy()) > ORACLE_DB
    ceps = np.fft.ifft(np.log(np.abs(f) + 1e-12)).real
    assert snr_db(ceps, kt.real_cepstrum(x).cpu().numpy()) > ORACLE_DB
    k = np.arange(n)
    dct2 = np.real(np.exp(-1j * np.pi * k / (2 * n))
                   * np.fft.fft(xn, 2 * n)[:n])
    assert snr_db(dct2, kt.dct2(x).cpu().numpy()) > ORACLE_DB
    assert HK.launches["stage1_real"] > 0
    back = kt.idct(kt.dct(x, 2), 2)
    assert snr_db(xn, back.cpu().numpy()) > ORACLE_DB
    m = 512
    w = np.exp(-2j * np.pi * 0.25 / m)
    got = kt.czt_fast(x[:60000], m, w).cpu().numpy()
    want = kt.czt_fast(x[:60000].double(), m, w).cpu().numpy()
    assert snr_db(want, got) > ORACLE_DB
    bins = [3, 1000, 30000]
    assert snr_db(np.abs(f)[bins],
                  kt.goertzel_bins(x, bins).cpu().numpy()) > ORACLE_DB


def test_wavelets_on_card(cuda):
    """dwt/idwt and the conv forms of wavelet_forward/_inverse on the
    card against the same entries on the CPU."""
    import kofft_tpu_torch as kt
    x = torch.as_tensor(np.random.default_rng(26).standard_normal(
        (2, 1 << 16), dtype=np.float32), device=cuda)
    a, d = kt.dwt(x, "db4")
    assert snr_db(x.cpu().numpy(), kt.idwt(a, d, "db4").cpu().numpy()) \
        > ORACLE_DB
    ga, gd = kt.wavelet_forward(x, "sym4")
    ca, cd = kt.wavelet_forward(x.cpu(), "sym4")
    assert snr_db(ca.numpy(), ga.cpu().numpy()) > PORT_DB
    assert snr_db(cd.numpy(), gd.cpu().numpy()) > PORT_DB
    gi = kt.wavelet_inverse(ga, gd, "sym4")
    ci = kt.wavelet_inverse(ca, cd, "sym4")
    assert snr_db(ci.numpy(), gi.cpu().numpy()) > PORT_DB


@pytest.mark.parametrize("rows,n", [(64, 4096), (130, 1001), (3, 31)])
def test_goertzel_scan_kernel_matches_plain(cuda, rows, n):
    """The goertzel_scan kernel against its plain version on the same
    CUDA tensor (1e-5 relative), one launch counted."""
    from kofft_tpu_torch.ops import goertzel as G
    x = torch.as_tensor(np.random.default_rng(27).standard_normal(
        (rows, n), dtype=np.float32), device=cuda)
    coeff = float(np.float32(2 * np.cos(2 * np.pi * 7 / n)))
    before = G.launches["goertzel_scan"]
    got = G.scan_rows(x, coeff)
    assert G.launches["goertzel_scan"] == before + 1
    want = G.scan_rows_plain(x, coeff)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_models_on_card(cuda):
    """SpectralNet and SpectralDenoiser at the entry widths with weights
    drawn from a seed, on the card against the port on the CPU: logits
    and the denoiser's interior >= 90 dB; entry() on the card likewise."""
    from kofft_tpu_torch.entry import entry
    from kofft_tpu_torch.models import SpectralDenoiser, SpectralNet
    rng = np.random.default_rng(31)
    x = rng.standard_normal((8, 16000)).astype(np.float32)
    for cls in (SpectralNet, SpectralDenoiser):
        cpu, card = cls(device="cpu"), cls()
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(torch.as_tensor(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32)) * 0.1)
        card.load_state_dict(cpu.state_dict())
        assert all(p.is_cuda for p in card.parameters())
        want = cpu(x).detach().numpy()
        got = card(x)
        assert got.is_cuda
        got = got.detach().cpu().numpy()
        if cls is SpectralDenoiser:
            want, got = want[:, 256:-256], got[:, 256:-256]
        assert snr_db(want, got) > 90.0, cls.__name__
    fn, args = entry()
    fc, ac = entry("cpu")
    assert all(a.is_cuda for a in args)
    assert snr_db(fc(*ac).numpy(), fn(*args).cpu().numpy()) > 90.0


def test_server_on_card(cuda):
    """The server on the card (default device) answers as the CPU state
    does: compute_frame rows within 1 LSB, stft magnitudes >= 100 dB."""
    import json
    import urllib.request
    from kofft_tpu_torch.visual import stft_magnitudes
    from kofft_tpu_torch.web import StreamingSpectrogram
    from kofft_tpu_torch.web.server import serve_background

    def post(path, obj):
        req = urllib.request.Request(
            url + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    srv, port = serve_background(0)
    url = f"http://127.0.0.1:{port}"
    try:
        assert srv.RequestHandlerClass.state.device.type == "cuda"
        ref = StreamingSpectrogram(device="cpu")
        rng = np.random.default_rng(32)
        for _ in range(3):
            x = rng.standard_normal(2048).astype(np.float32)
            got = np.asarray(post("/api/compute_frame",
                                  {"samples": x.tolist()})["row"], np.int16)
            want = ref.compute_frame(x).astype(np.int16)
            assert got.shape == want.shape
            d = np.abs(got - want)
            assert d.max(initial=0) <= 1 and np.count_nonzero(d) <= \
                max(1, d.size // 1000)
        x = rng.standard_normal(16384).astype(np.float32)
        out = post("/api/stft", {"samples": x.tolist(), "win_len": 1024})
        want, _ = stft_magnitudes(x, 1024, 512, device="cpu")
        assert snr_db(want, np.asarray(out["mags"])) > 100.0
        assert post("/api/set_colormap", {"name": "viridis"})["ok"]
        assert post("/api/reset", {})["ok"]
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("which", ["net", "denoiser"])
def test_train_step_on_card(cuda, which):
    """One train_step of each model at the entry widths on the card against
    the same step of the port on the CPU, from init(0) (SpectralNet's six
    empty mel bands: the |x| derivative at 0) on an (8, 16000) batch:
    loss >= 110 dB, new parameters >= 100 dB (mel >= 80), no kernel
    launched (win 256 lies below the stage kernels)."""
    from kofft_tpu_torch.models import (SpectralDenoiser, SpectralNet,
                                        denoiser_train_step, train_step)
    rng = np.random.default_rng(33)
    x = rng.standard_normal((8, 16000)).astype(np.float32)
    if which == "net":
        cls, step, lr = SpectralNet, train_step, 1e-3
        b = rng.integers(0, 8, 8).astype(np.int32)
    else:
        cls, step, lr = SpectralDenoiser, denoiser_train_step, 1.0
        b = rng.standard_normal((8, 16000)).astype(np.float32)
    cpu, card = cls(device="cpu"), cls()
    params = cpu.init(0)
    want, want_l = step(cpu, params, x, b, lr)
    HK.reset_counts()
    got, got_l = step(card, params, torch.as_tensor(x, device=cuda),
                      torch.as_tensor(b, device=cuda), lr)
    assert not any(HK.launches.values()), HK.launches
    assert got_l.is_cuda and got_l.dim() == 0
    assert snr_db(want_l.item(), got_l.item()) >= 110.0
    for f, w, g in zip(params._fields, want, got):
        assert g.is_cuda
        floor = 80.0 if f == "mel" else 100.0
        assert snr_db(w.numpy(), g.cpu().numpy()) >= floor, f


def test_training_backward_launches_stage_kernels(cuda):
    """chip_smoke.py phase 9(c) at a smaller batch: the denoiser at win
    2^14 under backend "cuda"; stage1 and stage2 launch during backward()
    itself (counts reset after the forward), and the gradients match the
    plain backend on the card >= 100 dB on `highest`."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.models import SpectralDenoiser
    from kofft_tpu_torch.models import denoiser as TD
    win = 1 << 14
    model = SpectralDenoiser(win, win // 2, 64)
    rng = np.random.default_rng(34)
    p0 = model.init(0)
    params = type(p0)(p0.w1, 0.1 * rng.standard_normal(64).astype(np.float32),
                      rng.standard_normal((64, win)).astype(np.float32) / 8,
                      rng.standard_normal(win).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((2, 1 << 17)).astype(np.float32),
                        device=cuda)
    c = torch.as_tensor(rng.standard_normal((2, 1 << 17)).astype(np.float32),
                        device=cuda)
    grads = {}
    try:
        for backend in ("cuda", "torch"):
            kt.set_backend(backend)
            leaves = type(params)(*(torch.as_tensor(p, device=cuda)
                                    .requires_grad_() for p in params))
            loss = TD.loss_fn(model, leaves, x, c)
            HK.reset_counts()
            loss.backward()
            torch.cuda.synchronize()
            if backend == "cuda":
                assert HK.launches["stage1"] > 0, HK.launches
                assert HK.launches["stage2"] > 0, HK.launches
            else:
                assert not any(HK.launches.values()), HK.launches
            grads[backend] = [p.grad.cpu().numpy() for p in leaves]
    finally:
        kt.set_backend(None)
    for w, g in zip(grads["torch"], grads["cuda"]):
        assert snr_db(w, g) >= 100.0


@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1-D mesh on a world of one NCCL rank (NCCL refuses two ranks on
    one device), torn down after the module if this fixture started it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest -m gpu --noconftest "
                    "tests/test_torch_gpu.py")
    import torch.distributed as dist
    from kofft_tpu_torch.parallel import make_mesh
    started = not dist.is_initialized()
    mesh = make_mesh(device="cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("restore,overlap", [(False, 1), (True, 1),
                                             (True, 4)])
def test_fft_sharded_nccl_against_fft_split(cuda, nccl_mesh, restore,
                                            overlap):
    """fft_sharded at 2^22 on the NCCL world (all_to_alls as device
    copies, the plain engine's local DFTs) against fft_split and float64
    (digit order undone for restore_layout=False)."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.parallel import fft_sharded
    from kofft_tpu_torch.parallel.fft_sharded import _split_for_mesh
    n = 1 << 22
    xr, xi = _planes((n,), cuda, 40)
    yr, yi = (p.to_local() for p in fft_sharded(
        xr, xi, mesh=nccl_mesh, restore_layout=restore, overlap=overlap))
    if not restore:
        n1, n2 = _split_for_mesh(n, 1)
        yr, yi = (p.reshape(n1, n2).t().reshape(n) for p in (yr, yi))
    want = kt.fft_split(xr, xi)
    assert snr_db(_np(*want), _np(yr, yi)) >= PORT_DB
    assert snr_db(np.fft.fft(_np(xr, xi)), _np(yr, yi)) > ORACLE_DB


@pytest.mark.parametrize("restore,overlap", [(False, 1), (True, 4)])
def test_fftn_sharded_nccl_cuda_backend(cuda, nccl_mesh, restore, overlap):
    """fftn_sharded with backend='cuda' on (256, 512, 512) on the NCCL
    world against fftn_split and float64; the sequential program's local
    512^2 slabs launch col_fft and row_fft."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.parallel import fftn_sharded
    xr, xi = _planes((256, 512, 512), cuda, 41)
    HK.reset_counts()
    yr, yi = (p.to_local() for p in fftn_sharded(
        xr, xi, mesh=nccl_mesh, backend="cuda", restore_layout=restore,
        overlap=overlap))
    torch.cuda.synchronize()
    if overlap == 1:
        assert HK.launches["col_fft"] and HK.launches["row_fft"], HK.launches
    want = kt.fftn_split(xr, xi)
    assert snr_db(_np(*want), _np(yr, yi)) >= PORT_DB
    assert snr_db(np.fft.fftn(_np(xr, xi)), _np(yr, yi)) > ORACLE_DB


@pytest.mark.parametrize("win,hop", [(1024, 256), (16384, 4096)])
def test_stft_sharded_nccl_against_stft_split(cuda, nccl_mesh, win, hop):
    """stft_sharded / istft_sharded on 2^22 samples on the NCCL world
    against the two-sided stft_split and istft_split (the interior:
    dividing by the window-square sum near 0 at the ends magnifies the
    engines' rounding)."""
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.parallel import istft_sharded, stft_sharded
    x = torch.as_tensor(np.random.default_rng(42).standard_normal(
        1 << 22).astype(np.float32), device=cuda)
    w = kt.window.hann(win)
    fr, fi = (p.to_local() for p in stft_sharded(x, w, hop, mesh=nccl_mesh))
    assert snr_db(_np(*kt.stft_split(x, w, hop)), _np(fr, fi)) >= PORT_DB
    out = istft_sharded(fr, fi, w, hop, mesh=nccl_mesh).to_local()
    want = kt.istft_split(fr, fi, w, hop, length=fr.shape[0] * hop)
    assert snr_db(want[win:-win].cpu().numpy(),
                  out[win:-win].cpu().numpy()) >= PORT_DB
    assert snr_db(x[win:-win].cpu().numpy(),
                  out[win:-win].cpu().numpy()) >= 90.0


def test_timeit_chained_agrees_with_graph_time(cuda):
    """timeit_chained of fft_split 2^20 on the card (a CUDA graph of the
    chain, the slope between two lengths) within 15 % of the same call's
    CUDA-graph time (chip_smoke.graph_ms), measured as a slope."""
    import kofft_tpu_torch as kt
    from chip_smoke import graph_ms
    from kofft_tpu_torch.bench import last_measurement_mode, timeit_chained
    xr, xi = _planes((1 << 20,), cuda, seed=14)
    t = timeit_chained(lambda p: kt.fft_split(p[0], p[1]), (xr, xi),
                       iters=200)
    assert last_measurement_mode() == "slope"
    g = graph_ms(lambda: kt.fft_split(xr, xi)) * 1e-3
    assert abs(t / g - 1) <= 0.15, (t, g)


def test_timeit_chained_raises_on_an_op_it_cannot_capture(cuda):
    """An op that waits on the host cannot be captured in a CUDA graph:
    timeit_chained raises instead of timing it eagerly."""
    from kofft_tpu_torch.bench import timeit_chained

    def waits(p):
        return (p[0] + float(p[0].sum().item()) * 0.0,)

    with pytest.raises(RuntimeError):
        timeit_chained(waits, (torch.zeros(1024, device=cuda),), iters=4,
                       target_time=0.001)
    torch.cuda.synchronize()
    assert float((torch.ones(8, device=cuda) * 2).sum()) == 16.0
