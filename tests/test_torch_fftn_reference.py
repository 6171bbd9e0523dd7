"""The port's 2-D FFT against the benchmark's plain float64 reference
(``portbench/reference/fftn2d.py``), on the CPU.

- The reference (``numpy.fft.fft2`` / ``ifft2`` in complex128) against
  the 2-D DFT from its definition at small sizes, X = F_{n1} x F_{n2}
  with each DFT matrix built in float64 from the exact integer products
  j k mod n: both are float64 evaluations of the same sums (a radix FFT
  against a matrix product), so they agree to a few units of float64
  rounding relative to the answer's RMS; 1e-12 leaves three orders of
  magnitude of room and catches any wrong phase, sign or scale, which
  reads O(1).
- ``fftn_split`` over the last two axes in both zones of the JAX 2-D
  kernels, the one-call kernel's (512², and a batch of 512²) and the
  two-call pair's with columns longer than 2048 as in the cell (4096 ×
  512), forward and inverse, on seeded standard normal planes: on CPU
  planes the port's route ``axes`` runs ``col_fft_plain`` and
  ``row_fft_plain``. Held to the limits of the benchmark cell
  ``fftn_c32.4096sq_stream`` (rms_err <= 1e-5, max_err <= 5e-5, relative
  to the reference's RMS; read from the cell's file), which the float32
  route passes by a factor of about 30 (it reads 3e-7 / 1.6e-6 here).
- The cell's control, the reference's function computed in TF32, breaks
  both limits by more than 10×, so a route that computed in TF32 could
  not pass them.
- The reference imports NumPy alone, and importing it loads no torch.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kofft_tpu_torch as kt  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from portbench import check  # noqa: E402
from portbench.adapters import fftn as adapter  # noqa: E402
from portbench.reference import fftn2d  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = json.loads((ROOT / "portbench" / "workloads"
                   / "fftn_c32.4096sq_stream.json").read_text())
CFG = json.loads((ROOT / "portbench" / "configs" / "fftn_c32.json")
                 .read_text())
LIMITS = CELL["check"]["limits"]
# the reference against the definition: rounding of float64 alone
REF_TOL = 1e-12


def _planes(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g), torch.randn(shape, generator=g))


def _reference(xr, xi, inverse=False):
    return fftn2d.fft2(xr.numpy(), xi.numpy(), inverse)


def _dft_matrix(n, inverse):
    """F_n[j, k] = exp(-+2 pi i ((j k) mod n) / n) in complex128."""
    jk = np.outer(np.arange(n), np.arange(n)) % n
    return np.exp((2j if inverse else -2j) * np.pi * jk / n)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (8, 12), (2, 16, 16),
                                   (64, 32), (7, 128)])
@pytest.mark.parametrize("inverse", [False, True])
def test_reference_against_the_definition(shape, inverse):
    xr, xi = _planes(shape, sum(shape))
    x = xr.double().numpy() + 1j * xi.double().numpy()
    n1, n2 = shape[-2:]
    want = _dft_matrix(n1, inverse) @ x @ _dft_matrix(n2, inverse)
    if inverse:
        want /= n1 * n2
    got = _reference(xr, xi, inverse)
    assert got.dtype == np.complex128 and got.shape == want.shape
    e = check.errors(got, want)
    assert e["rms_err"] <= REF_TOL and e["max_err"] <= REF_TOL, e


@pytest.mark.parametrize("shape", [(512, 512), (2, 512, 512), (4096, 512)])
@pytest.mark.parametrize("inverse", [False, True])
def test_port_against_the_reference(shape, inverse):
    xr, xi = _planes(shape, 22)
    before = HK.classes["axes"]
    yr, yi = kt.fftn_split(xr, xi, axes=(-2, -1), inverse=inverse,
                           device="cpu")
    assert HK.classes["axes"] == before + 1
    e = check.errors(check.planes((yr, yi)), _reference(xr, xi, inverse))
    assert e["rms_err"] <= LIMITS["rms_err"], e
    assert e["max_err"] <= LIMITS["max_err"], e


def test_the_adapters_call_is_the_entry():
    """The cell's call is fftn_split over the last two axes, as the
    configuration states it; its answer is the reference's within the
    limits."""
    cell = dict(CELL, shape=[4096, 512], pool=1)
    inp = adapter.make_pool(CFG, cell, 5, "cpu")[0]
    try:
        got = adapter.answer(adapter.entry(CFG, cell)(inp))
    finally:
        kt.set_precision(None)          # the entry sets the tier
    want = adapter.expected(CFG, cell, inp)
    ok, failed, _ = check.judge([check.errors(got, want)], LIMITS)
    assert ok and failed == 0
    assert adapter.work(CFG, CELL)["bound_s"] == pytest.approx(80.13e-6,
                                                              rel=1e-4)


@pytest.mark.parametrize("shape", [(512, 512), (4096, 512)])
def test_the_tf32_control_breaks_the_cells_limits(shape):
    cell = dict(CELL, shape=list(shape), pool=1)
    inp = adapter.make_pool(CFG, cell, 9, "cpu")[0]
    e = check.errors(adapter.answer(adapter.control(CFG, cell, inp)),
                     adapter.expected(CFG, cell, inp))
    assert e["rms_err"] > 10 * LIMITS["rms_err"], e
    assert e["max_err"] > 10 * LIMITS["max_err"], e


def test_the_reference_imports_numpy_alone():
    tree = ast.parse((ROOT / "portbench" / "reference" / "fftn2d.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"__future__", "numpy"}
    # the modules that importing it adds to those the interpreter starts with
    loaded = subprocess.run(
        [sys.executable, "-c", "import sys; a = set(sys.modules); "
         "import portbench.reference.fftn2d; "
         "print(' '.join(set(sys.modules) - a))"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout.split()
    assert "portbench.reference.fftn2d" in loaded
    assert not {n.split(".")[0] for n in loaded} & {
        "torch", "kofft_tpu_torch", "kofft_tpu", "jax"}
