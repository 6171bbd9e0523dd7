"""The port's N-D FFT against kofft_tpu on the CPU.

Four groups: the public entries, the kernel route (``axes``) through the
public entries with its route counter, over the shapes of the JAX
package's three N-D kernels (the one-call 2-D kernel, the two-call 2-D
pair and the fused all-axes kernel), the route's plain versions against
those Pallas kernels in interpret mode (called directly, as
tests/test_pallas.py and tests/test_ndfft.py call them), and the zone
predicates and gradients. On a CPU tensor every
kernel wrapper runs its plain PyTorch version, so no launch is counted.
The same seeded numpy inputs go through both packages.

Tolerances:
- public entries and routes vs kofft_tpu and vs the float64 numpy oracle:
  >= 100 dB (tests/test_ndfft.py's bound for its kernel routes);
- the route over the last two axes vs the JAX 2-D kernels: >= 110 dB.
  Both run the same line-FFT recursion with bit-equal tables in float32,
  so they differ only in summation order (as tests/test_torch_kernels.py
  holds the 1-D kernels);
- the route over every axis vs the JAX fused kernel: >= 100 dB, because
  the JAX kernel sums with one dense DFT matrix per axis and the port's
  route with the line recursion. ``fused_nd_plain``, which repeats the
  JAX kernel's dense math, is held at >= 110 dB;
- gradients and jvps vs the Parseval oracle d/dx sum|Fx|^2 = 2*N*x:
  >= 100 dB.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import kofft_tpu as jk  # noqa: E402
import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu.ops import ndfft as jnd  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops import ndfft as tnd  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

FLOOR = 100.0
PORT_DB = 110.0
CPU = {"device": "cpu"}


def _cx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _planes(shape, seed):
    x = _cx(shape, seed)
    return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)


def _c(r, i):
    return np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8), (16, 32), (4, 100), (30, 7),
                                   (3, 8, 16)])
def test_fft2_ifft2_vs_jax(shape):
    x = _cx(shape, 1)
    got = tk.fft2(x, **CPU).numpy()
    want = np.asarray(jk.fft2(x))
    ref = np.fft.fft2(x.astype(np.complex128))
    assert got.dtype == np.complex64 and got.shape == shape
    assert snr_db(want, got) >= FLOOR
    assert snr_db(ref, got) >= FLOOR
    back = tk.ifft2(got, **CPU).numpy()
    assert snr_db(np.asarray(jk.ifft2(want)), back) >= FLOOR
    assert snr_db(x, back) >= FLOOR


@pytest.mark.parametrize("shape,axes", [
    ((4, 8, 16), None), ((4, 8, 16), (0, 2)), ((4, 8, 16), (-1, 0)),
    ((3, 5, 7), (1,)), ((6, 300), None), ((2, 3, 4, 5), (-3, -1)),
])
def test_fftn_ifftn_vs_jax(shape, axes):
    x = _cx(shape, 2)
    got = tk.fftn(x, axes=axes, **CPU).numpy()
    ref = np.fft.fftn(x.astype(np.complex128), axes=axes)
    assert snr_db(np.asarray(jk.fftn(x, axes=axes)), got) >= FLOOR
    assert snr_db(ref, got) >= FLOOR
    back = tk.ifftn(got, axes=axes, **CPU).numpy()
    assert snr_db(x, back) >= FLOOR


@pytest.mark.parametrize("shape", [(4, 8, 16), (8, 8, 8), (3, 5, 7),
                                   (2, 3, 4, 5)])
def test_fft3_ifft3_vs_jax(shape):
    x = _cx(shape, 3)
    got = tk.fft3(x, **CPU).numpy()
    ref = np.fft.fftn(x.astype(np.complex128), axes=(-3, -2, -1))
    assert snr_db(np.asarray(jk.fft3(x)), got) >= FLOOR
    assert snr_db(ref, got) >= FLOOR
    assert snr_db(x, tk.ifft3(got, **CPU).numpy()) >= FLOOR


@pytest.mark.parametrize("inverse", [False, True])
def test_fftn_split_vs_jax(inverse):
    xr, xi = _planes((6, 10, 16), 4)
    yr, yi = tk.fftn_split(xr, xi, axes=(0, 2), inverse=inverse, **CPU)
    jr, ji = jk.fftn_split(xr, xi, axes=(0, 2), inverse=inverse)
    fn = np.fft.ifftn if inverse else np.fft.fftn
    ref = fn(_c(xr, xi), axes=(0, 2))
    assert snr_db(_c(jr, ji), _c(yr, yi)) >= FLOOR
    assert snr_db(ref, _c(yr, yi)) >= FLOOR


@pytest.mark.parametrize("backend,jax_backend", [
    ("auto", "auto"), ("cuda", "pallas"), ("torch", "xla"),
    ("naive", "naive"), ("cufft", "jnpfft")])
@pytest.mark.parametrize("shape,axes", [((16, 32), None),
                                        ((4, 8, 100), (0, 2))])
def test_backends_vs_jax(backend, jax_backend, shape, axes):
    xr, xi = _planes(shape, 5)
    yr, yi = tk.fftn_split(xr, xi, axes=axes, backend=backend, **CPU)
    jr, ji = jk.fftn_split(xr, xi, axes=axes, backend=jax_backend)
    assert snr_db(_c(jr, ji), _c(yr, yi)) >= FLOOR
    assert snr_db(np.fft.fftn(_c(xr, xi), axes=axes), _c(yr, yi)) >= FLOOR


def test_cufft_backend_takes_torch_fft(monkeypatch):
    """An explicit 'cufft' backend computes with torch.fft.fftn over the
    axes (the JAX package maps 'jnpfft' to its XLA engines instead)."""
    seen = []
    real = torch.fft.fftn
    monkeypatch.setattr(torch.fft, "fftn",
                        lambda x, dim=None: seen.append(dim) or real(x,
                                                                     dim=dim))
    xr, xi = _planes((4, 8, 16), 6)
    yr, yi = tk.fftn_split(xr, xi, axes=(2, 0), backend="cufft", **CPU)
    assert seen == [(2, 0)]
    assert snr_db(np.fft.fftn(_c(xr, xi), axes=(2, 0)), _c(yr, yi)) >= FLOOR


def test_rfftn_irfftn_vs_jax():
    x = np.random.default_rng(7).standard_normal((6, 10, 16)).astype(
        np.float32)
    got = tk.rfftn(x, **CPU).numpy()
    assert got.shape == (6, 10, 9)
    assert snr_db(np.asarray(jk.rfftn(x)), got) >= FLOOR
    assert snr_db(np.fft.rfftn(x.astype(np.float64)), got) >= FLOOR
    back = tk.irfftn(got, n=16, **CPU).numpy()
    assert snr_db(np.asarray(jk.irfftn(got, n=16)), back) >= FLOOR
    assert snr_db(x.astype(np.float64), back) >= FLOOR
    # partial axes in a non-default order
    got2 = tk.rfftn(x, axes=(2, 0), **CPU).numpy()
    ref2 = np.fft.rfftn(x.astype(np.float64), axes=(2, 0))
    assert got2.shape == ref2.shape
    assert snr_db(np.asarray(jk.rfftn(x, axes=(2, 0))), got2) >= FLOOR
    assert snr_db(ref2, got2) >= FLOOR
    back2 = tk.irfftn(got2, n=6, axes=(2, 0), **CPU).numpy()
    assert snr_db(x.astype(np.float64), back2) >= FLOOR


def test_rfftn_split_vs_jax():
    x = np.random.default_rng(8).standard_normal((4, 32)).astype(np.float32)
    yr, yi = tk.rfftn_split(x, **CPU)
    jr, ji = jk.rfftn_split(x)
    assert snr_db(_c(jr, ji), _c(yr, yi)) >= FLOOR
    assert snr_db(np.fft.rfftn(x.astype(np.float64)), _c(yr, yi)) >= FLOOR
    back = tk.irfftn_split(yr, yi, n=32, **CPU)
    assert snr_db(x.astype(np.float64), back.numpy()) >= FLOOR


def test_dtypes():
    """float64 stays float64; bfloat16 planes compute in float32 and round
    back (the N-D entries have no bf16 kernel form, as the JAX N-D kernels
    have none; only the 1-D entries route bf16 to the kernels)."""
    x = _cx((16, 32), 9).astype(np.complex128)
    y = tk.fft2(x, **CPU)
    assert y.dtype == torch.complex128
    assert snr_db(np.fft.fft2(x), y.numpy()) > 250.0
    br = torch.as_tensor(x.real, dtype=torch.bfloat16)
    bi = torch.as_tensor(x.imag, dtype=torch.bfloat16)
    yr, yi = tk.fftn_split(br, bi)
    assert yr.dtype == torch.bfloat16
    ref = np.fft.fft2(br.double().numpy() + 1j * bi.double().numpy())
    assert snr_db(ref, tk.asnumpy(yr) + 1j * tk.asnumpy(yi)) > 40.0


def test_errors_match_jax_classes():
    z1 = np.zeros(8, np.float32)
    z2 = np.zeros((4, 4), np.float32)
    zc = _cx((8, 16), 10)
    # kw: the port's entries get **CPU, the JAX package's nothing
    cases = [
        (lambda m, kw: m.fft2(z1, **kw)),                      # rank
        (lambda m, kw: m.ifft2(z1, **kw)),
        (lambda m, kw: m.fft3(z2, **kw)),
        (lambda m, kw: m.ifft3(z2, **kw)),
        (lambda m, kw: m.fftn(z2, axes=(0, -2), **kw)),        # repeated
        (lambda m, kw: m.fftn_split(z2, z2, axes=(1, 1), **kw)),
        (lambda m, kw: m.fftn(np.zeros((0, 4), np.float32), **kw)),
        (lambda m, kw: m.rfftn(zc, **kw)),                     # complex
        (lambda m, kw: m.rfftn(z2, axes=(), **kw)),            # no axes
        (lambda m, kw: m.irfftn(zc, axes=(), **kw)),
        (lambda m, kw: m.irfftn_split(np.zeros((4, 17), np.float32),
                                      np.zeros((3, 17), np.float32), **kw)),
    ]
    for case in cases:
        with pytest.raises(jk.KofftError) as ej:
            case(jk, {})
        with pytest.raises(tk.KofftError) as et:
            case(tk, CPU)
        assert type(et.value).__name__ == type(ej.value).__name__
    with pytest.raises(tk.InvalidValueError):
        tk.rfftn_split(torch.as_tensor(zc))
    with pytest.raises(tk.MismatchedLengthsError):
        tk.fftn_split(torch.zeros(4, 4), torch.zeros(4, 3))


_HOST_CALLS = {
    "fft2": lambda x: tk.fft2(x),
    "ifft2": lambda x: tk.ifft2(x),
    "fft3": lambda x: tk.fft3(x),
    "ifft3": lambda x: tk.ifft3(x),
    "fftn": lambda x: tk.fftn(x),
    "ifftn": lambda x: tk.ifftn(x),
    "fftn_split": lambda x: tk.fftn_split(x, x),
    "rfftn": lambda x: tk.rfftn(x),
    "irfftn": lambda x: tk.irfftn(x),
    "rfftn_split": lambda x: tk.rfftn_split(x),
    "irfftn_split": lambda x: tk.irfftn_split(x, x),
}


@pytest.mark.parametrize("entry", sorted(_HOST_CALLS))
def test_host_input_defaults_to_the_card(entry):
    """With no ``device``, host data goes to the card; without one the
    entry raises and names ``device=`` instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: host data computes there")
    with pytest.raises(RuntimeError, match="device="):
        _HOST_CALLS[entry](np.zeros((8, 8, 8), np.float32))


# ---------------------------------------------------------------------------
# the kernel routes through the public entries
# ---------------------------------------------------------------------------

def _route_case(shape, axes):
    xr, xi = _planes(shape, sum(shape))
    HK.reset_counts()
    yr, yi = tk.fftn_split(xr, xi, axes=axes, **CPU)
    assert HK.classes == {k: int(k == "axes") for k in HK.classes}
    assert HK.launches == {k: 0 for k in HK.launches}  # CPU: plain versions
    jr, ji = jk.fftn_split(xr, xi, axes=axes)
    assert snr_db(_c(jr, ji), _c(yr, yi)) >= FLOOR
    assert snr_db(np.fft.fftn(_c(xr, xi), axes=axes), _c(yr, yi)) >= FLOOR
    # the inverse: the route's unnormalized inverse scaled by 1/N
    br, bi = tk.fftn_split(yr, yi, axes=axes, inverse=True)
    assert HK.classes["axes"] == 2
    assert snr_db(_c(xr, xi), _c(br, bi)) >= FLOOR


@pytest.mark.parametrize("shape,axes", [
    ((1024, 256), (-2, -1)),        # the one-call 2-D kernel's zone
    ((2, 256, 1024), (-2, -1)),
    ((512, 256), None),             # the fused all-axes kernel's zone
    ((128, 128, 128), None),
])
def test_routes_vs_jax(shape, axes):
    _route_case(shape, axes)


def test_big_2d_route_vs_jax():
    """A shape of the JAX two-call 2-D pair's zone (2^21 points, rows of
    8192 above the one-call cap) rides the axis kernels on the CPU, where
    col_fft and row_fft run their plain versions."""
    assert PK.fused_2d_big_zone((256, 8192), (-2, -1))
    assert not PK.fused_2d_zone((256, 8192), (-2, -1))
    _route_case((256, 8192), (-2, -1))


@pytest.mark.parametrize("shape,axes,in_jax", [
    ((512, 512), None, (PK.fused_2d_zone, PK.fused_nd_zone)),
    ((1024, 1024), None, (PK.fused_2d_zone,)),      # and the cuFFT zone
    ((2048, 2048), None, (PK.fused_2d_big_zone,)),
])
def test_zone_order(shape, axes, in_jax):
    """The zones overlap, and the JAX order decides: the kernel zone, then
    the cuFFT zone (kofft_tpu/ops/ndfft.py:146-152); a shape in two of the
    JAX package's kernel zones runs the one route once."""
    ax = tuple(range(len(shape)))
    for zone in (PK.fused_2d_zone, PK.fused_2d_big_zone, PK.fused_nd_zone):
        assert zone(shape, ax) == (zone in in_jax)
    assert tnd._kernel_nd_zone(shape, ax)
    if shape == (1024, 1024):
        assert tnd._nd_cufft_zone(shape, ax)
    HK.reset_counts()
    x = torch.zeros(shape)
    tk.fftn_split(x, x, axes=axes)
    assert HK.classes == {k: int(k == "axes") for k in HK.classes}


def test_cufft_and_einsum_zones(monkeypatch):
    """'auto' sends >= 2 pow2 axes in [2^10, 2^16] at >= 2^20 points to
    torch.fft.fftn and small axes to the einsum route; neither counts a
    kernel class."""
    seen = []
    real_fftn = torch.fft.fftn
    monkeypatch.setattr(torch.fft, "fftn",
                        lambda x, dim=None: seen.append("fftn")
                        or real_fftn(x, dim=dim))
    real_ein = tnd._axis_einsum_planes
    monkeypatch.setattr(tnd, "_axis_einsum_planes",
                        lambda *a: seen.append("einsum") or real_ein(*a))
    HK.reset_counts()
    xr, xi = _planes((1024, 4, 1024), 11)
    yr, yi = tk.fftn_split(xr, xi, axes=(0, 2), **CPU)
    assert snr_db(np.fft.fftn(_c(xr, xi), axes=(0, 2)), _c(yr, yi)) >= FLOOR
    xr, xi = _planes((4, 64, 64), 12)
    yr, yi = tk.fftn_split(xr, xi, axes=(1, 2), **CPU)
    assert snr_db(np.fft.fftn(_c(xr, xi), axes=(1, 2)), _c(yr, yi)) >= FLOOR
    assert seen == ["fftn", "einsum"]
    assert HK.classes == {k: 0 for k in HK.classes}


def test_per_axis_route_reaches_the_stage_kernels():
    """Axes outside every zone go one by one through the 1-D ladder; a
    2^14-point axis there takes the stage kernels' class."""
    xr, xi = _planes((4, 3, 1 << 14), 13)
    HK.reset_counts()
    yr, yi = tk.fftn_split(xr, xi, axes=(0, 2), **CPU)
    assert HK.classes == {k: int(k == "stages") for k in HK.classes}
    assert snr_db(np.fft.fftn(_c(xr, xi), axes=(0, 2)), _c(yr, yi)) >= FLOOR
    jr, ji = jk.fftn_split(xr, xi, axes=(0, 2))
    assert snr_db(_c(jr, ji), _c(yr, yi)) >= FLOOR


# ---------------------------------------------------------------------------
# the routes' plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry,shape,floor", [
    ("fused_fft2_planes", (128, 256), PORT_DB),
    ("fused_fft2_planes", (2, 256, 128), PORT_DB),
    ("fused_fft2_big_planes", (256, 128), PORT_DB),
    ("fused_ndfft_planes", (512, 256), FLOOR),
    ("fused_ndfft_planes", (128, 128, 128), FLOOR),
])
@pytest.mark.parametrize("inverse", [False, True])
def test_route_vs_pallas_interpret(entry, shape, floor, inverse):
    """The axis route against each JAX N-D kernel entry (``entry`` names
    the JAX function): over every axis for the fused all-axes kernel, over
    the last two (lead = nd - 2) for the 2-D kernels."""
    xr, xi = _planes(shape, len(shape) + shape[-1])
    jr, ji = getattr(PK, entry)(jnp.asarray(xr), jnp.asarray(xi), inverse,
                                interpret=True)
    every = entry == "fused_ndfft_planes"
    HK.reset_counts()
    tr, ti = HK.axes_fft_planes(_t(xr), _t(xi), inverse,
                                0 if every else len(shape) - 2)
    assert HK.classes == {k: int(k == "axes") for k in HK.classes}
    got = _c(tr, ti)
    axes = tuple(range(len(shape))) if every else (-2, -1)
    x = _c(xr, xi)
    ref = (np.fft.ifftn(x, axes=axes) * np.prod([shape[a] for a in axes])
           if inverse else np.fft.fftn(x, axes=axes))
    assert snr_db(_c(jr, ji), got) >= floor
    assert snr_db(ref, got) >= FLOOR
    assert snr_db(ref, _c(jr, ji)) >= FLOOR


def test_fft2_route_vs_bt_folded_kernel():
    """The one-call 2-D kernel's bt > 1 form (reached only from
    tests/test_pallas.py:824-836) computes the same batched 2-D DFT, which
    the port's route serves for any batch."""
    xr, xi = _planes((8, 128, 128), 18)
    run = PK._build_fft2(128, 128, "float32", True, "highest", bt=4)
    jr, ji = run(8, jnp.asarray(xr), jnp.asarray(xi))
    tr, ti = HK.axes_fft_planes(_t(xr), _t(xi), lead=1)
    assert snr_db(_c(jr, ji), _c(tr, ti)) >= PORT_DB
    assert snr_db(np.fft.fft2(_c(xr, xi)), _c(tr, ti)) >= FLOOR


@pytest.mark.parametrize("shape", [(512, 256), (128, 128, 128)])
def test_fused_nd_plain_is_the_jax_kernel_math(shape):
    xr, xi = _planes(shape, 14)
    for inverse in (False, True):
        jr, ji = PK.fused_ndfft_planes(jnp.asarray(xr), jnp.asarray(xi),
                                       inverse, interpret=True)
        pr, pi = HK.fused_nd_plain(_t(xr), _t(xi), conj=inverse)
        assert snr_db(_c(jr, ji), _c(pr, pi)) >= PORT_DB


@pytest.mark.parametrize("shape", [(2, 128, 256), (1, 8192, 4),
                                   (3, 16, 8)])
@pytest.mark.parametrize("conj", [False, True])
def test_axis_wrappers_on_cpu(shape, conj):
    """col_fft / row_fft on CPU tensors: their plain versions, the column
    pass in the input layout (conj on the input), the row pass in natural
    order (conj on the output), no launch counted."""
    xr, xi = _planes(shape, 15)
    x = _c(xr, xi)
    before = dict(HK.launches)
    cr, ci = HK.col_fft(_t(xr), _t(xi), conj)
    yr, yi = HK.row_fft(_t(xr), _t(xi), conj)
    assert HK.launches == before
    assert snr_db(np.fft.fft(np.conj(x) if conj else x, axis=1),
                  _c(cr, ci)) >= FLOOR
    want = np.fft.fft(x, axis=2)
    assert snr_db(np.conj(want) if conj else want, _c(yr, yi)) >= FLOOR


def test_axis_wrappers_reject_bad_input():
    a = torch.zeros((1, 96, 128))
    with pytest.raises(tk.InvalidValueError):
        HK.col_fft(a, a)                        # line of 96: not pow2
    b = torch.zeros((1, 2, 16384))
    with pytest.raises(tk.InvalidValueError):
        HK.row_fft(b, b)                        # line above 8192
    c = torch.zeros((1, 128, 128), dtype=torch.float64)
    with pytest.raises(tk.InvalidValueError):
        HK.row_fft(c, c)
    d = torch.zeros((1, 128, 256))
    with pytest.raises(tk.InvalidValueError):
        HK.col_fft(d.transpose(1, 2), d.transpose(1, 2))
    with pytest.raises(tk.InvalidValueError):
        HK.axes_fft_planes(torch.zeros(128), torch.zeros(128))
    with pytest.raises(tk.InvalidValueError):
        HK.axes_fft_planes(torch.zeros(2, 128), torch.zeros(2, 128), lead=1)


# ---------------------------------------------------------------------------
# zones and gradients
# ---------------------------------------------------------------------------

# (shape, axes, precision): cases of tests/test_ndfft.py:213-243, 391-420
# and tests/test_pallas.py:537-548; precision None is the default tier
_ZONE_CASES = [
    ((1024, 1024), (0, 1), None), ((1024, 1024), (-2, -1), None),
    ((512, 1024), (0, 1), None), ((8, 512, 512), (1, 2), None),
    ((512, 512), (0, 1), None), ((256, 1024), (0, 1), None),
    ((1024, 2048), (0, 1), None), ((2048, 2048), (0, 1), None),
    ((1024, 2048), (0, 1), "default"), ((2048, 2048), (0, 1), "default"),
    ((2048, 4096), (0, 1), "default"), ((1024, 2048), (0, 1), "high"),
    ((1024, 256), (0,), None), ((1024, 1000), (0, 1), None),
    ((64, 4096), (0, 1), None), ((8, 1024, 1024), (0, 1), None),
    ((1024,), (0,), None),
    ((4096, 4096), (0, 1), None), ((4096, 4096), (-2, -1), None),
    ((2, 2048, 4096), (1, 2), None), ((8192, 8192), (0, 1), None),
    ((16384, 16384), (0, 1), None), ((4096, 4000), (0, 1), None),
    ((64, 1 << 20), (0, 1), None), ((4096, 4096), (0,), None),
    ((2048, 4096), (0, 1), None), ((4096, 4096), (0, 1), "default"),
    ((1024, 1024), (0, 1), "default"),
    ((128, 128, 128), (0, 1, 2), None), ((512, 512), (0, 1), None),
    ((512, 256), (0, 1), None), ((512, 256), (1, -2), None),
    ((256, 256), (0, 1), None), ((64, 64, 64), (0, 1, 2), None),
    ((256, 256, 128), (0, 1, 2), None), ((512, 512), (0,), None),
    ((512, 384), (0, 1), None),
]


@pytest.mark.parametrize("shape,axes,prec", _ZONE_CASES)
def test_zones_match_jax(shape, axes, prec):
    from kofft_tpu.config import set_precision as jset
    try:
        jset(prec)
        tk.set_precision(prec)
        want = (PK.fused_2d_zone(shape, axes)
                or PK.fused_2d_big_zone(shape, axes)
                or PK.fused_nd_zone(shape, axes))
        assert tnd._kernel_nd_zone(shape, axes) == want, (shape, axes, prec)
        assert tnd._nd_cufft_zone(shape, axes) == \
            jnd._nd_jnp_zone(shape, axes)
        assert tnd._small_axes_zone(shape, axes) == \
            jnd._small_axes_zone(shape, axes)
    finally:
        jset(None)
        tk.set_precision(None)


def test_2d_zones_tile_the_range():
    """Over the last two axes of a batch of images (outside the all-axes
    zone), the kernel zone holds every shape of either JAX 2-D zone at
    both tiers and leaves the same shapes out: no gap at the one-call cap,
    8192^2 in, and 4096 x 128 (below the cap, a side above 2048) out at
    both, as 4096 x 512 is on `default`."""
    from kofft_tpu.config import set_precision as jset
    p2 = [1 << k for k in range(6, 15)]
    assert tnd._kernel_nd_zone((8192, 8192), (0, 1))
    for prec in (None, "default"):
        try:
            jset(prec)
            tk.set_precision(prec)
            for shape in [(3, a, b) for a in p2 for b in p2]:
                ax = (-2, -1)
                jax2d = (PK.fused_2d_zone(shape, ax)
                         or PK.fused_2d_big_zone(shape, ax))
                assert tnd._kernel_nd_zone(shape, ax) == jax2d, (shape, prec)
            for shape in [(1024, 1024), (1024, 2048), (2048, 2048),
                          (2048, 4096), (4096, 4096)]:
                assert tnd._kernel_nd_zone(shape, (0, 1)), (shape, prec)
            assert not tnd._kernel_nd_zone((4096, 128), (0, 1))
            assert tnd._kernel_nd_zone((4096, 512), (0, 1)) == (prec is None)
        finally:
            jset(None)
            tk.set_precision(None)


@pytest.mark.parametrize("shape", [(1024, 256), (512, 256)])
def test_route_grad_and_jvp(shape):
    """grad and jvp through the route against Parseval: for the
    unnormalized DFT, d/dx sum|Fx|^2 = 2*N*x, and its jvp along t is
    2*N*<x, t>."""
    import torch.autograd.forward_ad as fwAD
    n = shape[0] * shape[1]
    xr, xi = _planes(shape, 16)
    tr, ti = _planes(shape, 17)
    ar = torch.tensor(xr, requires_grad=True)
    ai = torch.tensor(xi, requires_grad=True)
    HK.reset_counts()
    yr, yi = tk.fftn_split(ar, ai)
    (yr * yr + yi * yi).sum().backward()
    assert HK.classes["axes"] == 2       # forward, then the backward route
    assert snr_db(2.0 * n * xr.astype(np.float64), ar.grad.numpy()) >= FLOOR
    assert snr_db(2.0 * n * xi.astype(np.float64), ai.grad.numpy()) >= FLOOR
    with fwAD.dual_level():
        dr = fwAD.make_dual(_t(xr), _t(tr))
        di = fwAD.make_dual(_t(xi), _t(ti))
        zr, zi = tk.fftn_split(dr, di)
        loss = (zr * zr + zi * zi).sum()
        got = float(fwAD.unpack_dual(loss).tangent)
    want = 2.0 * n * float(np.sum(xr.astype(np.float64) * tr)
                           + np.sum(xi.astype(np.float64) * ti))
    # float32 accuracy against the largest value the inner product can
    # take, 2N*|x|*|t| (Cauchy-Schwarz); <x, t> itself cancels
    scale = 2.0 * n * np.sqrt(np.sum(np.abs(_c(xr, xi)) ** 2)
                              * np.sum(np.abs(_c(tr, ti)) ** 2))
    assert abs(got - want) <= 1e-6 * scale, (got, want)
    assert HK.classes["axes"] == 4       # the primal and the tangent
