"""The port's real FFT against kofft_tpu on the CPU.

The same seeded numpy inputs go through both packages; the port's entries
get ``device="cpu"`` (they default to the card). Tolerances: SNR >= 100 dB
between the two and against the float64 oracle (SNR of
tests/test_rfft.py), 90 dB where that file uses SNR - 10 (irfft of a
random spectrum, whose DC and Nyquist imaginary parts are dropped). The
real kernel path (plain versions on CPU tensors) against the JAX Pallas
kernels in interpret mode: >= 110 dB, as tests/test_torch_kernels.py
holds the complex path (float32 evaluations of one recursion with
bit-equal tables).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kofft_tpu as jk  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu_torch.ops import fft as tfft  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

SNR = 100.0
LOOSE = SNR - 10
PORT_DB = 110.0
SIZES = [1, 2, 7, 128, 1000, 4099, 1 << 14, 3 << 14]
CPU = {"device": "cpu"}


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _c(r, i):
    return np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64)


@pytest.mark.parametrize("n", SIZES)
def test_rfft_irfft_vs_jax(n):
    x = _real((2, n), n)
    got = tk.rfft(x, **CPU).numpy()
    want = np.asarray(jk.rfft(x))
    ref = np.fft.rfft(x.astype(np.float64))
    assert got.shape == (2, n // 2 + 1) and got.dtype == np.complex64
    assert snr_db(want, got) >= SNR
    assert snr_db(ref, got) >= SNR
    back = tk.irfft(got, n=n, **CPU).numpy()
    jback = np.asarray(jk.irfft(want, n=n))
    assert back.shape == (2, n) and back.dtype == np.float32
    assert snr_db(jback, back) >= SNR
    assert snr_db(x, back) >= SNR


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [7, 1 << 14])
def test_norms_vs_jax(norm, n):
    x = _real((n,), 3)
    got = tk.rfft(x, norm=norm, **CPU).numpy()
    assert snr_db(np.asarray(jk.rfft(x, norm=norm)), got) >= SNR
    assert snr_db(np.fft.rfft(x.astype(np.float64), norm=norm), got) >= SNR
    back = tk.irfft(got, n=n, norm=norm, **CPU).numpy()
    assert snr_db(np.asarray(jk.irfft(got, n=n, norm=norm)), back) >= SNR
    assert snr_db(x, back) >= SNR


@pytest.mark.parametrize("axis,n", [(1, None), (1, 128), (1, 32), (0, None),
                                    (-3, 6)])
def test_axis_pad_truncate_vs_jax(axis, n):
    x = _real((3, 64, 2), 20 + axis)
    got = tk.rfft(x, n=n, axis=axis, **CPU).numpy()
    want = np.asarray(jk.rfft(x, n=n, axis=axis))
    ref = np.fft.rfft(x.astype(np.float64), n=n, axis=axis)
    assert got.shape == ref.shape
    assert snr_db(want, got) >= SNR
    assert snr_db(ref, got) >= SNR
    m = n or x.shape[axis]
    back = tk.irfft(got, n=m, axis=axis, **CPU).numpy()
    assert snr_db(np.asarray(jk.irfft(want, n=m, axis=axis)), back) >= SNR
    assert snr_db(np.fft.irfft(ref, n=m, axis=axis), back) >= SNR


@pytest.mark.parametrize("k,n", [(20, 64), (33, 32), (33, None), (4, 7),
                                 (501, 1001), (24577, 3 << 14)])
def test_irfft_spectra_vs_jax(k, n):
    """Short spectra are zero-padded, long ones truncated, default
    n = 2(k-1), odd n; the spectrum is random (imaginary DC/Nyquist parts
    included, which irfft drops as numpy does)."""
    rng = np.random.default_rng(k)
    y = (rng.standard_normal((2, k))
         + 1j * rng.standard_normal((2, k))).astype(np.complex64)
    got = tk.irfft(y, n=n, **CPU).numpy()
    want = np.asarray(jk.irfft(y, n=n))
    ref = np.fft.irfft(y.astype(np.complex128), n=n)
    assert got.shape == ref.shape
    assert snr_db(want, got) >= SNR
    assert snr_db(ref, got) >= LOOSE


@pytest.mark.parametrize("n", [1000, 1 << 14, 3 << 14])
def test_split_forms_vs_jax(n):
    x = _real((2, n), n + 1)
    tr, ti = tk.rfft_split(x, **CPU)
    jr, ji = jk.rfft_split(x)
    assert tuple(tr.shape) == (2, n // 2 + 1)
    assert snr_db(_c(jr, ji), _c(tr, ti)) >= SNR
    assert snr_db(np.fft.rfft(x.astype(np.float64)), _c(tr, ti)) >= SNR
    back = tk.irfft_split(tr, ti, n=n, **CPU)
    jback = np.asarray(jk.irfft_split(jr, ji, n=n))
    assert snr_db(jback, back.numpy()) >= SNR
    assert snr_db(x, back.numpy()) >= SNR


@pytest.mark.parametrize("backend,n", [("auto", 1 << 14), ("cuda", 1 << 14),
                                       ("torch", 1 << 14),
                                       ("cufft", 1 << 14), ("naive", 1000)])
def test_backends_agree(backend, n):
    x = _real((2, n), 30)
    HK.reset_counts()
    yr, yi = tk.rfft_split(x, backend=backend, **CPU)
    # the kernel backends take the real stage route
    kernel = backend in ("auto", "cuda")
    assert HK.classes == {k: int(kernel and k == "stages_real")
                          for k in HK.classes}
    assert snr_db(np.fft.rfft(x.astype(np.float64)), _c(yr, yi)) >= SNR
    back = tk.irfft_split(yr, yi, n=n, backend=backend, **CPU)
    assert snr_db(x, back.numpy()) >= SNR


def test_cufft_zone_vs_jax():
    """(64, 2^12) lies in the cufft zone (batched mid-size pow2)."""
    x = _real((64, 1 << 12), 31)
    assert tfft._cufft_zone(x.shape, x.shape[-1])
    HK.reset_counts()
    got = tk.rfft(x, **CPU).numpy()
    assert HK.classes == {k: 0 for k in HK.classes}
    assert snr_db(np.asarray(jk.rfft(x)), got) >= SNR


def test_errors_match_jax_classes():
    z = np.zeros(8, np.float32)
    cases = [
        (lambda m, kw: m.rfft(np.zeros(8, np.complex64), **kw)),
        (lambda m, kw: m.rfft(np.zeros(0, np.float32), **kw)),
        (lambda m, kw: m.rfft(z, n=0, **kw)),
        (lambda m, kw: m.rfft(z, axis=2, **kw)),
        (lambda m, kw: m.rfft(z, norm="bogus", **kw)),
        (lambda m, kw: m.irfft(np.zeros(1, np.complex64), **kw)),
        (lambda m, kw: m.irfft_split(z, np.zeros(4, np.float32), **kw)),
    ]
    for case in cases:
        with pytest.raises(jk.KofftError) as ej:
            case(jk, {})
        with pytest.raises(tk.KofftError) as et:
            case(tk, CPU)
        assert type(et.value).__name__ == type(ej.value).__name__
    with pytest.raises(tk.InvalidValueError):
        tk.rfft_split(torch.zeros(8, dtype=torch.complex64))
    with pytest.raises(tk.InvalidValueError):
        tk.irfft_split(torch.zeros(3), torch.zeros(3), n=8)


def test_bfloat16():
    """bfloat16 planes reach the real kernels; (2, 2^14) is batch-folded
    by the JAX two-call pair, a shape its phased grid does not serve, so
    it computes in float32 and rounds back: the rounding of the
    output to 8 mantissa bits bounds the SNR near 50 dB (floor 40, as
    tests/test_torch_fft.py::test_dtypes)."""
    n = 1 << 14
    xb = torch.as_tensor(_real((2, n), 32)).to(torch.bfloat16)
    HK.reset_counts()
    yr, yi = tk.rfft_split(xb)
    assert HK.classes["stages_real"] == 1
    assert HK._stage_types(n, 2, False, torch.bfloat16, real=True) is None
    assert yr.dtype == torch.bfloat16 and tuple(yr.shape) == (2, n // 2 + 1)
    x64 = xb.double().numpy()
    got = _c(tk.asnumpy(yr), tk.asnumpy(yi))
    assert snr_db(np.fft.rfft(x64), got) > 40.0
    jr, ji = jk.rfft_split(jnp.asarray(x64, jnp.bfloat16))
    assert snr_db(_c(jk.asnumpy(jr), jk.asnumpy(ji)), got) > 40.0
    back = tk.irfft_split(yr, yi, n=n)
    assert back.dtype == torch.bfloat16
    assert snr_db(x64, tk.asnumpy(back)) > 40.0


@pytest.mark.parametrize("shape", [
    (1 << 14,),          # the JAX phased kernel's flat real form
    (3 << 14,),
    (1, 1 << 16),        # its tiled grid
    (4, 1 << 14),        # the two-call pair, which folds the batch
])
def test_fused_multilevel_rfft_vs_jax(shape):
    """Every shape the JAX package splits among its three real forms runs
    the real stage pair (route ``stages_real``)."""
    n = shape[-1]
    x = _real(shape, n + len(shape))
    jr, ji = PK.fused_multilevel_rfft(jnp.asarray(x), n, interpret=True)
    HK.reset_counts()
    tr, ti = HK.fused_multilevel_rfft(torch.as_tensor(x), n)
    assert HK.classes == {k: int(k == "stages_real") for k in HK.classes}
    assert HK.launches == {k: 0 for k in HK.launches}  # CPU: plain versions
    assert tuple(tr.shape) == shape[:-1] + (n // 2 + 1,)
    got = _c(tr, ti)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert snr_db(_c(jr, ji), got) >= PORT_DB
    assert snr_db(ref, got) > SNR
    assert snr_db(ref[..., -1], got[..., -1]) > SNR     # the Nyquist bin


@pytest.mark.parametrize("b,n", [(1, 1 << 14), (2, 3 << 14)])
def test_real_stages_plain_vs_complex(b, n):
    """stage1_real is stage1 of (x, 0); stage2_half is stage2's flat
    spectrum cut to the bins k <= n/2."""
    n1, n2 = HK._pow2_split(n)
    ar = torch.as_tensor(_real((b, n1, n2), n))
    cr, ci = HK.stage1_real(ar)
    pr, pi = HK.stage1(ar, torch.zeros_like(ar))
    assert snr_db(_c(pr, pi), _c(cr, ci)) >= PORT_DB
    hr, hi = HK.stage2_half(cr, ci)
    yr, yi = HK.stage2(cr, ci)
    full = _c(yr, yi).reshape(b, n)
    assert tuple(hr.shape) == (b, n // 2 + 1)
    assert snr_db(full[:, : n // 2 + 1], _c(hr, hi)) >= PORT_DB


@pytest.mark.parametrize("n", [1000, 1 << 14])
def test_grad_and_jvp_vs_jax(n):
    import torch.autograd.forward_ad as fwAD
    x = _real((2, n), 40)
    h = n // 2 + 1
    gr, gi = _real((2, h), 41), _real((2, h), 42)
    t = _real((2, n), 43)

    def loss(a):
        yr, yi = jk.rfft_split(a)
        return (yr * gr + yi * gi).sum()

    jgrad = np.asarray(jax.grad(loss)(x))
    (jtr, jti) = jax.jvp(jk.rfft_split, (x,), (t,))[1]
    a = torch.tensor(x, requires_grad=True)
    yr, yi = tk.rfft_split(a)
    (yr * torch.as_tensor(gr) + yi * torch.as_tensor(gi)).sum().backward()
    assert snr_db(jgrad, a.grad.numpy()) >= SNR
    full = np.zeros((2, n), np.complex128)
    full[:, :h] = _c(gr, gi)
    assert snr_db((np.fft.ifft(full, axis=-1) * n).real,
                  a.grad.numpy()) >= SNR
    with fwAD.dual_level():
        d = fwAD.make_dual(torch.as_tensor(x), torch.as_tensor(t))
        dr, di = (fwAD.unpack_dual(v).tangent for v in tk.rfft_split(d))
    assert snr_db(_c(jtr, jti), _c(dr, di)) >= SNR
    assert snr_db(np.fft.rfft(t.astype(np.float64)), _c(dr, di)) >= SNR

