"""The port's public 1-D entries against kofft_tpu on the CPU.

The same seeded numpy inputs go through both packages. Tolerance: SNR
>= 100 dB between the two and against the float64 oracle (SNR_FLOOR_DB of
tests/test_fft.py), 80 dB where tests/test_fft.py uses 80 for the same
entry (host complex input, batch aliases, zone reroute). Both packages
compute in float32 with bit-equal tables, so they differ only in
summation order. The port's entries put host data on the card unless
asked otherwise, so every host-data call here passes ``**CPU``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import kofft_tpu as jk  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu.ops import fft as jfft  # noqa: E402
from kofft_tpu_torch.ops import fft as tfft  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import dft, snr_db  # noqa: E402

FLOOR = 100.0
LOOSE = 80.0
SIZES = [1, 2, 7, 128, 1000, 4099, 1 << 14, 3 << 14]
CPU = {"device": "cpu"}


def _cx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _np(y):
    return tk.asnumpy(y) if isinstance(y, torch.Tensor) else np.asarray(y)


def _both(fn_t, fn_j):
    return _np(fn_t()), np.asarray(jk.asnumpy(fn_j()))


@pytest.mark.parametrize("n", SIZES)
def test_fft_ifft_vs_jax(n):
    x = _cx((2, n), n)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    got, want = _both(lambda: tk.fft(x, **CPU), lambda: jk.fft(x))
    assert got.dtype == np.complex64 and got.shape == (2, n)
    assert snr_db(want, got) >= FLOOR
    assert snr_db(ref, got) >= FLOOR
    back, jback = _both(lambda: tk.ifft(got, **CPU), lambda: jk.ifft(want))
    assert snr_db(jback, back) >= FLOOR
    assert snr_db(x, back) >= FLOOR


def test_cufft_zone_vs_jax():
    """(32, 2^13) lies in the cufft zone (batched mid-size pow2)."""
    assert tfft._cufft_zone((32, 1 << 13), 1 << 13)
    x = _cx((32, 1 << 13), 5)
    HK.reset_counts()
    got, want = _both(lambda: tk.fft(x, **CPU), lambda: jk.fft(x))
    assert HK.classes == {k: 0 for k in HK.classes}
    assert snr_db(want, got) >= FLOOR


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [7, 1 << 14])
def test_norms_vs_jax(norm, n):
    x = _cx((n,), 3)
    for inv in (False, True):
        f_t, f_j = (tk.ifft, jk.ifft) if inv else (tk.fft, jk.fft)
        got, want = _both(lambda: f_t(x, norm=norm, **CPU),
                          lambda: f_j(x, norm=norm))
        assert snr_db(want, got) >= FLOOR, (norm, inv)


@pytest.mark.parametrize("axis", [0, 1, -3])
def test_axis_vs_jax(axis):
    x = _cx((6, 5, 4), axis + 10)
    got, want = _both(lambda: tk.fft(x, axis=axis, **CPU),
                      lambda: jk.fft(x, axis=axis))
    assert got.shape == x.shape
    assert snr_db(want, got) >= FLOOR
    assert snr_db(np.fft.fft(x.astype(np.complex128), axis=axis),
                  got) >= FLOOR


@pytest.mark.parametrize("n", [5, 12, 1 << 14])
def test_pad_trim_vs_jax(n):
    x = _cx((3, 9), 4)
    got, want = _both(lambda: tk.fft(x, n=n, **CPU),
                      lambda: jk.fft(x, n=n))
    assert got.shape == (3, n)
    assert snr_db(want, got) >= FLOOR
    assert snr_db(np.fft.fft(x.astype(np.complex128), n=n, axis=-1),
                  got) >= FLOOR


@pytest.mark.parametrize("strategy", ["auto", "dft", "four_step",
                                      "bluestein"])
def test_strategies_vs_jax(strategy):
    n = 256
    x = _cx((2, n), 6)
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)
    jr, ji = jax.jit(lambda a, b: jfft._fft_planes(
        a, b, n, False, "xla", "float32", strategy))(xr, xi)
    tr, ti = tfft._fft_planes(torch.as_tensor(xr), torch.as_tensor(xi), n,
                              False, "torch", "float32", strategy)
    got = tr.numpy() + 1j * ti.numpy()
    assert snr_db(np.asarray(jr) + 1j * np.asarray(ji), got) >= FLOOR
    assert snr_db(dft(x), got) >= FLOOR


@pytest.mark.parametrize("n", [1000, 1 << 14, 3 << 14])
def test_fft_split_vs_jax(n):
    x = _cx((2, n), 8)
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)
    tr, ti = tk.fft_split(xr, xi, **CPU)
    jr, ji = jk.fft_split(xr, xi)
    got = tr.numpy() + 1j * ti.numpy()
    assert snr_db(np.asarray(jr) + 1j * np.asarray(ji), got) >= FLOOR
    br, bi = tk.ifft_split(tr, ti)
    assert snr_db(x, br.numpy() + 1j * bi.numpy()) >= FLOOR


def test_fft_split_donate():
    n = 1 << 14
    x = _cx((n,), 9)
    xr = torch.as_tensor(np.ascontiguousarray(x.real))
    xi = torch.as_tensor(np.ascontiguousarray(x.imag))
    pr, pi = xr.data_ptr(), xi.data_ptr()
    yr, yi = tk.fft_split(xr, xi, norm="ortho", donate=True)
    assert (yr.data_ptr(), yi.data_ptr()) == (pr, pi)
    ref = np.fft.fft(x.astype(np.complex128)) / np.sqrt(n)
    assert snr_db(ref, yr.numpy() + 1j * yi.numpy()) >= FLOOR


def test_tiled_vs_jax():
    m, m2 = tk.tiled_shape(1 << 14)
    assert (m, m2) == jk.tiled_shape(1 << 14)
    x = _cx((2, m * m), 12)
    ar = np.ascontiguousarray(x.real).reshape(2, m, m)
    ai = np.ascontiguousarray(x.imag).reshape(2, m, m)
    tr, ti = tk.fft_split_tiled(ar, ai, **CPU)
    jr, ji = jk.fft_split_tiled(ar, ai)
    got = (tr.numpy() + 1j * ti.numpy()).reshape(2, -1)
    want = (np.asarray(jr) + 1j * np.asarray(ji)).reshape(2, -1)
    assert snr_db(want, got) >= FLOOR
    assert snr_db(np.fft.fft(x.astype(np.complex128), axis=-1), got) >= FLOOR
    br, bi = tk.ifft_split_tiled(tr, ti)
    assert snr_db(x.reshape(2, m, m), br.numpy() + 1j * bi.numpy()) >= FLOOR
    dr, di = tr.clone(), ti.clone()
    zr, zi = tk.ifft_split_tiled(dr, di, donate=True)
    assert (zr.data_ptr(), zi.data_ptr()) == (dr.data_ptr(), di.data_ptr())
    assert snr_db(x.reshape(2, m, m), zr.numpy() + 1j * zi.numpy()) >= FLOOR


def test_freq_shift_batch_vs_jax():
    for n in (1, 7, 8):
        assert np.array_equal(tk.fftfreq(n, 0.5), jk.fftfreq(n, 0.5))
        assert np.array_equal(tk.rfftfreq(n, 0.5), jk.rfftfreq(n, 0.5))
    a = np.arange(15.0).reshape(3, 5)
    for axes in (None, 0, (0, 1)):
        assert np.array_equal(tk.fftshift(a, axes), jk.fftshift(a, axes))
        assert np.array_equal(tk.ifftshift(a, axes), jk.ifftshift(a, axes))
        ta = torch.as_tensor(a)
        assert np.array_equal(tk.fftshift(ta, axes).numpy(),
                              np.fft.fftshift(a, axes))
        assert np.array_equal(tk.ifftshift(ta, axes).numpy(),
                              np.fft.ifftshift(a, axes))
    xs = _cx((4, 32), 13)
    got, want = _both(lambda: tk.fft_batch(xs, **CPU),
                      lambda: jk.fft_batch(xs))
    assert snr_db(want, got) >= LOOSE
    back = _np(tk.ifft_batch(got, **CPU))
    assert snr_db(xs, back) >= LOOSE


def test_plan_and_strided_vs_jax():
    n = 96
    x = _cx((3, n), 14)
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)
    p = tk.FftPlan(n, norm="ortho").warmup((3,), **CPU)
    q = jk.FftPlan(n, norm="ortho")
    assert repr(p) == repr(q)
    tr, ti = p(xr, xi, **CPU)
    jr, ji = q(xr, xi)
    assert snr_db(np.asarray(jr) + 1j * np.asarray(ji),
                  tr.numpy() + 1j * ti.numpy()) >= FLOOR
    br, bi = p.inverse(tr, ti)
    assert snr_db(x, br.numpy() + 1j * bi.numpy()) >= FLOOR
    for inverse in (False, True):
        sr, si = tk.fft_strided_split(xr, xi, 4, inverse=inverse, **CPU)
        kr, ki = jk.fft_strided_split(xr, xi, 4, inverse=inverse)
        assert snr_db(np.asarray(kr) + 1j * np.asarray(ki),
                      sr.numpy() + 1j * si.numpy()) >= FLOOR


def test_errors_match_jax_classes():
    z = np.zeros(8, np.float32)
    # kw: the port's entries get **CPU, the JAX package's nothing
    cases = [
        (lambda m, kw: m.fft(z, norm="bogus", **kw)),
        (lambda m, kw: m.fft(np.zeros(0, np.complex64), **kw)),
        (lambda m, kw: m.fft(z, n=0, **kw)),
        (lambda m, kw: m.fft(z, axis=3, **kw)),
        (lambda m, kw: m.fft_split(z, np.zeros(4, np.float32), **kw)),
        (lambda m, kw: m.tiled_shape(1000)),
        (lambda m, kw: m.fft_split_tiled(np.zeros((4, 8), np.float32),
                                         np.zeros((4, 8), np.float32),
                                         **kw)),
        (lambda m, kw: m.FftPlan(0)),
        (lambda m, kw: m.fft_strided_split(z, z, 3, **kw)),
        (lambda m, kw: m.fft_strided_split(z, z, 0, **kw)),
        (lambda m, kw: m.fftfreq(0)),
    ]
    for case in cases:
        with pytest.raises(jk.KofftError) as ej:
            case(jk, {})
        with pytest.raises(tk.KofftError) as et:
            case(tk, CPU)
        assert type(et.value).__name__ == type(ej.value).__name__
    zt = torch.zeros(4)
    for strategy, n in (("stockham", 4), ("four_step", 101)):
        with pytest.raises(tk.InvalidValueError):
            tfft._fft_planes(torch.zeros(n), torch.zeros(n), n, False,
                             "torch", "float32", strategy)
    with pytest.raises(tk.InvalidValueError):
        tk.fft_split(zt, torch.zeros(4, dtype=torch.float64))


@pytest.mark.parametrize("n", [1000, 1 << 14])
def test_grad_vs_jax(n):
    x = _cx((2, n), 15)
    g = _cx((2, n), 16)
    xr, xi = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    gr, gi = np.ascontiguousarray(g.real), np.ascontiguousarray(g.imag)

    def loss(a, b):
        yr, yi = jk.fft_split(a, b)
        return (yr * gr + yi * gi).sum()

    jgr, jgi = jax.grad(loss, argnums=(0, 1))(xr, xi)
    ar = torch.tensor(xr, requires_grad=True)
    ai = torch.tensor(xi, requires_grad=True)
    yr, yi = tk.fft_split(ar, ai)
    (yr * torch.as_tensor(gr) + yi * torch.as_tensor(gi)).sum().backward()
    got = ar.grad.numpy() + 1j * ai.grad.numpy()
    assert snr_db(np.asarray(jgr) + 1j * np.asarray(jgi), got) >= FLOOR
    assert snr_db(np.fft.ifft(g.astype(np.complex128), axis=-1) * n,
                  got) >= FLOOR


def test_forward_ad_through_kernel_path():
    """jvp of the linear map = the same transform of the tangent."""
    import torch.autograd.forward_ad as fwAD
    n = 1 << 14
    x = _cx((n,), 17)
    t = _cx((n,), 18)
    with fwAD.dual_level():
        ar = fwAD.make_dual(torch.as_tensor(x.real.copy()),
                            torch.as_tensor(t.real.copy()))
        ai = fwAD.make_dual(torch.as_tensor(x.imag.copy()),
                            torch.as_tensor(t.imag.copy()))
        yr, yi = tk.fft_split(ar, ai)
        dr = fwAD.unpack_dual(yr).tangent
        di = fwAD.unpack_dual(yi).tangent
    assert snr_db(np.fft.fft(t.astype(np.complex128)),
                  dr.numpy() + 1j * di.numpy()) >= FLOOR


def test_dtypes():
    """float64 stays float64 (plain engines); bfloat16 planes of a size
    the JAX phased grid serves take the stage kernels' bf16 forms (route
    ``stages``, bf16 in and a float32 C, float32 arithmetic, each result
    rounded to bf16 once)."""
    n = 1 << 14
    x = _cx((n,), 19).astype(np.complex128)
    y = tk.fft(x, **CPU)
    assert y.dtype == torch.complex128
    assert snr_db(np.fft.fft(x), y.numpy()) > 250.0
    br = torch.as_tensor(x.real, dtype=torch.bfloat16)
    bi = torch.as_tensor(x.imag, dtype=torch.bfloat16)
    HK.reset_counts()
    yr, yi = tk.fft_split(br, bi)
    assert HK.classes["stages"] == 1
    assert HK._stage_types(n, 1, True, torch.bfloat16) == (torch.bfloat16,
                                                           torch.float32)
    assert yr.dtype == torch.bfloat16
    ref = np.fft.fft(br.double().numpy() + 1j * bi.double().numpy())
    assert snr_db(ref, tk.asnumpy(yr) + 1j * tk.asnumpy(yi)) > 40.0


_HOST_CALLS = {
    "fft": lambda x: tk.fft(x),
    "ifft": lambda x: tk.ifft(x),
    "fft_batch": lambda x: tk.fft_batch(x),
    "ifft_batch": lambda x: tk.ifft_batch(x),
    "fft_split": lambda x: tk.fft_split(x, x),
    "ifft_split": lambda x: tk.ifft_split(x, x),
    "fft_split_tiled": lambda x: tk.fft_split_tiled(x, x),
    "ifft_split_tiled": lambda x: tk.ifft_split_tiled(x, x),
    "fft_strided_split": lambda x: tk.fft_strided_split(x, x, 2),
    "FftPlan.forward": lambda x: tk.FftPlan(8).forward(x, x),
    "FftPlan.inverse": lambda x: tk.FftPlan(8).inverse(x, x),
    "FftPlan.warmup": lambda x: tk.FftPlan(8).warmup(),
    "planes_from_numpy": lambda x: tk.planes_from_numpy(x, x),
    "rfft": lambda x: tk.rfft(x),
    "irfft": lambda x: tk.irfft(x),
    "rfft_split": lambda x: tk.rfft_split(x),
    "irfft_split": lambda x: tk.irfft_split(x, x),
}


@pytest.mark.parametrize("entry", sorted(_HOST_CALLS))
def test_host_input_defaults_to_the_card(entry):
    """With no ``device``, host data goes to the card; without one the
    entry raises and names ``device=`` instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: host data computes there")
    with pytest.raises(RuntimeError, match="device="):
        _HOST_CALLS[entry](np.zeros(8, np.float32))


def test_vmap_runs_through_the_kernel_ops(monkeypatch):
    """torch.func.vmap over fft_split, rfft_split and fftn_split (a shape
    of the JAX one-call 2-D kernel and one of its fused all-axes kernel)
    on CPU tensors: each call reaches its
    kernel op's vmap rule, which folds the mapped dim into the batch; each
    slice matches numpy (> 100 dB, SNR_FLOOR_DB of tests/test_fft.py)."""
    import torch
    from kofft_tpu_torch.ops import hopper_fft as HF
    seen = []
    for cls in (HF._KernelFFT, HF._KernelRFFT, HF._KernelND):
        rule = cls.vmap

        def spy(info, in_dims, *args, _rule=rule, _name=cls.__name__):
            seen.append(_name)
            return _rule(info, in_dims, *args)

        monkeypatch.setattr(cls, "vmap", staticmethod(spy))
    rng = np.random.default_rng(23)
    n = 1 << 14
    xr, xi = (torch.as_tensor(a) for a in
              rng.standard_normal((2, 3, n)).astype(np.float32))
    x = xr.double().numpy() + 1j * xi.double().numpy()
    yr, yi = torch.func.vmap(tk.fft_split)(xr, xi)
    got = yr.double().numpy() + 1j * yi.double().numpy()
    for k in range(3):
        assert snr_db(np.fft.fft(x[k]), got[k]) > 100.0
    yr, yi = torch.func.vmap(tk.rfft_split)(xr)
    got = yr.double().numpy() + 1j * yi.double().numpy()
    for k in range(3):
        assert snr_db(np.fft.rfft(x[k].real), got[k]) > 100.0
    assert seen == ["_KernelFFT", "_KernelRFFT"]
    for shape in [(512, 512), (512, 256)]:
        gr, gi = (torch.as_tensor(a) for a in
                  rng.standard_normal((2, 2) + shape).astype(np.float32))
        g = gr.double().numpy() + 1j * gi.double().numpy()
        HK.reset_counts()
        yr, yi = torch.func.vmap(tk.fftn_split)(gr, gi)
        assert HK.classes["axes"] == 1
        got = yr.double().numpy() + 1j * yi.double().numpy()
        for k in range(2):
            assert snr_db(np.fft.fftn(g[k]), got[k]) > 100.0
    assert seen[2:] == ["_KernelND", "_KernelND"]
