"""The port's kernel module against the JAX Pallas kernels on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_pallas.py
does. The same seeded numpy inputs go through both.

Tolerances: port vs JAX >= 110 dB — both are float32 evaluations of the
same recursion with bit-equal tables, so they differ only in summation
order; each vs the float64 oracle > 100 dB (SNR_FLOOR_DB of
tests/test_fft.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu_torch.ops import hopper_fft as HF  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

PORT_DB = 110.0
ORACLE_DB = 100.0


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2,) + tuple(shape)).astype(np.float32)
    return a[0], a[1]


def _c(r, i):
    return np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64)


@pytest.mark.parametrize("m", [16, 48, 128, 768, 1024])
def test_line_fft_plain_vs_jax(m):
    xr, xi = _planes((m, 8), m)
    keys = PK._ml_const_keys(m)
    arrs = PK._ml_const_arrays(keys, "float32")
    consts = {k: (jnp.asarray(arrs[2 * i]), jnp.asarray(arrs[2 * i + 1]))
              for i, k in enumerate(keys)}
    jr, ji = PK._fft_axis0_traced(jnp.asarray(xr), jnp.asarray(xi), m,
                                  consts)
    tr, ti = HK.fft_axis0_plain(torch.as_tensor(xr), torch.as_tensor(xi), m)
    ref = np.fft.fft(_c(xr, xi), axis=0)
    got = _c(tr.numpy(), ti.numpy())
    assert snr_db(_c(jr, ji), got) >= PORT_DB
    assert snr_db(ref, got) > ORACLE_DB
    assert snr_db(ref, _c(jr, ji)) > ORACLE_DB


@pytest.mark.parametrize("shape", [
    (1 << 14,),          # the JAX phased kernel's flat form
    (1, 1 << 14),        # its tiled grid
    (8, 1 << 14),        # the two-call pair, which folds the batch
    (3 << 14,),
])
def test_fused_multilevel_vs_jax(shape):
    """Every shape the JAX package splits among its three forms runs the
    stage pair (route ``stages``), float32 throughout on `highest`."""
    n = shape[-1]
    b = 1 if len(shape) == 1 else shape[0]
    assert HK._stage_types(n, b, len(shape) == 1, torch.float32) == (
        torch.float32, torch.float32)
    xr, xi = _planes(shape, n + len(shape))
    jr, ji = PK.fused_multilevel_fft(jnp.asarray(xr), jnp.asarray(xi), n,
                                     interpret=True)
    HK.reset_counts()
    tr, ti = HK.fused_multilevel_fft(torch.as_tensor(xr),
                                     torch.as_tensor(xi), n)
    assert HK.classes == {k: int(k == "stages") for k in HK.classes}
    assert HK.launches == {k: 0 for k in HK.launches}  # CPU: plain versions
    assert tuple(tr.shape) == shape
    got = _c(tr.numpy(), ti.numpy())
    ref = np.fft.fft(_c(xr, xi), axis=-1)
    assert snr_db(_c(jr, ji), got) >= PORT_DB
    assert snr_db(ref, got) > ORACLE_DB
    assert snr_db(ref, _c(jr, ji)) > ORACLE_DB


@pytest.mark.parametrize("b", [1, 2])
def test_phased_tiled_vs_jax(b):
    """``kernel_tiled_planes`` holds the JAX tiled entry's contract on
    (b, m, m) planes, n = m*m, through the stage pair."""
    ar, ai = _planes((b, 128, 128), 7 + b)
    jr, ji = PK.phased_tiled_fft(jnp.asarray(ar), jnp.asarray(ai),
                                 interpret=True)
    HK.reset_counts()
    tr, ti = HF.kernel_tiled_planes(torch.as_tensor(ar), torch.as_tensor(ai))
    assert HK.classes == {k: int(k == "stages") for k in HK.classes}
    got = _c(tr.numpy(), ti.numpy())
    ref = np.fft.fft(_c(ar, ai).reshape(b, -1), axis=-1).reshape(b, 128, 128)
    assert snr_db(_c(jr, ji), got) >= PORT_DB
    assert snr_db(ref, got) > ORACLE_DB


def test_inverse_and_donate_plain():
    """conj flag = the conjugation identity; donate writes the result into
    the input planes' storage."""
    n = 1 << 14
    xr, xi = _planes((2, n), 11)
    x = _c(xr, xi)
    yr, yi = HK.fused_multilevel_fft(torch.as_tensor(xr),
                                     torch.as_tensor(xi), n, inverse=True)
    assert snr_db(np.fft.ifft(x, axis=-1) * n,
                  _c(yr.numpy(), yi.numpy())) > ORACLE_DB
    dr, di = torch.as_tensor(xr.copy()), torch.as_tensor(xi.copy())
    zr, zi = HK.fused_multilevel_fft(dr, di, n, donate=True)
    assert zr.data_ptr() == dr.data_ptr() and zi.data_ptr() == di.data_ptr()
    assert snr_db(np.fft.fft(x, axis=-1), _c(zr.numpy(), zi.numpy())) \
        > ORACLE_DB


def test_wrappers_reject_bad_planes():
    a = torch.zeros((1, 128, 128), dtype=torch.float64)
    with pytest.raises(ValueError):
        HK.stage1(a, a)
    b = torch.zeros((1, 128, 256), dtype=torch.float32)
    with pytest.raises(ValueError):
        HK.stage1(b.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError):
        HK.stage2(b, b[:, :64])
    meta = torch.zeros((1, 128, 128), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        HK.stage1(meta, meta)
