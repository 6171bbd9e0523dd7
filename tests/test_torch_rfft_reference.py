"""The port's real FFT against the benchmark's plain float64 reference
(``portbench/reference/rfft1d.py``), on the CPU.

- The reference (``numpy.fft.rfft`` of the signal widened to float64)
  against the one-sided DFT from its definition at small even and odd n,
  X[k] = sum_j x[j] exp(-2 pi i ((j k) mod n) / n) for k <= n // 2, the
  matrix built in float64 from the exact integer products: both are
  float64 evaluations of the same sums, so they agree to a few units of
  float64 rounding relative to the answer's RMS; 1e-12 leaves three orders
  of magnitude of room and catches any wrong phase, sign, scale or bin
  count, which reads O(1) or gives another shape.
- ``rfft_split`` on seeded standard normal signals at 2^14 (the cell's
  ``cpu_sizes``), 2^16, 2^20 and a batch of three 2^14 signals: on CPU
  tensors the port's route ``stages_real`` runs ``stage1_real_plain`` and
  ``stage2_half_plain``, once a call. Held to the limits of the benchmark
  cell ``rfft_f32.2p24_stream`` (rms_err <= 1e-5, max_err <= 5e-5,
  relative to the reference's RMS; read from the cell's file), which the
  float32 route passes by a factor of about 30.
- The cell's control, the reference's function computed in TF32, breaks
  both limits by more than 10x, so a route that computed in TF32 could not
  pass them.
- The reference imports NumPy alone, and importing it loads no torch.
- A traced CPU call records the plain stage versions as ``tree`` spans,
  and the cell's three span metrics (entry, ladder, launch) add up to the
  root span's inclusive time.
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
from kofft_tpu_torch.utils import observability as obs  # noqa: E402
from portbench import check, loader  # noqa: E402
from portbench.adapters import rfft1d as adapter  # noqa: E402
from portbench.reference import rfft1d  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAME = "rfft_f32.2p24_stream"
CELL = json.loads((ROOT / "portbench" / "workloads" / f"{NAME}.json")
                  .read_text())
CFG = json.loads((ROOT / "portbench" / "configs" / "rfft_f32.json")
                 .read_text())
LIMITS = CELL["check"]["limits"]
# the reference against the definition: rounding of float64 alone
REF_TOL = 1e-12
SPANS = ("entry_us_per_call", "ladder_us_per_call", "launch_us_per_call")


def _signal(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("shape", [(1,), (2,), (5,), (12,), (3, 17),
                                   (2, 2, 64), (100,), (129,)])
def test_reference_against_the_definition(shape):
    x = _signal(shape, sum(shape))
    n = shape[-1]
    jk = np.outer(np.arange(n), np.arange(n // 2 + 1)) % n
    want = x.double().numpy() @ np.exp(-2j * np.pi * jk / n)
    got = rfft1d.rfft(x.numpy())
    assert got.dtype == np.complex128 and got.shape == want.shape
    e = check.errors(got, want)
    assert e["rms_err"] <= REF_TOL and e["max_err"] <= REF_TOL, e


@pytest.mark.parametrize("shape", [(1 << 14,), (1 << 16,), (1 << 20,),
                                   (3, 1 << 14)])
def test_port_against_the_reference(shape):
    x = _signal(shape, 26)
    before = HK.classes["stages_real"]
    yr, yi = kt.rfft_split(x, device="cpu")
    assert HK.classes["stages_real"] == before + 1
    e = check.errors(check.planes((yr, yi)), rfft1d.rfft(x.numpy()))
    assert e["rms_err"] <= LIMITS["rms_err"], e
    assert e["max_err"] <= LIMITS["max_err"], e


def test_the_adapters_call_is_the_entry():
    """The cell's call is rfft_split as the configuration states it; its
    answer is the reference's within the limits; its units are the real
    input points and its bound the real transform's."""
    cell = dict(CELL, **CFG["cpu_sizes"])
    inp = adapter.make_pool(CFG, cell, 5, "cpu")[0]
    assert isinstance(inp, torch.Tensor) and inp.shape == (1 << 14,)
    try:
        got = adapter.answer(adapter.entry(CFG, cell)(inp))
    finally:
        kt.set_precision(None)          # the entry sets the tier
    want = adapter.expected(CFG, cell, inp)
    ok, failed, _ = check.judge([check.errors(got, want)], LIMITS)
    assert ok and failed == 0
    w = adapter.work(CFG, CELL)
    assert w["units"] == 1 << 24 and w["bound_by"] == "bytes"
    assert w["bound_s"] == pytest.approx(40.06e-6, rel=1e-3)


@pytest.mark.parametrize("shape", [(1 << 14,), (2, 1 << 12)])
def test_the_tf32_control_breaks_the_cells_limits(shape):
    cell = dict(CELL, shape=list(shape), pool=1)
    inp = adapter.make_pool(CFG, cell, 9, "cpu")[0]
    e = check.errors(adapter.answer(adapter.control(CFG, cell, inp)),
                     adapter.expected(CFG, cell, inp))
    assert e["rms_err"] > 10 * LIMITS["rms_err"], e
    assert e["max_err"] > 10 * LIMITS["max_err"], e


def test_the_reference_imports_numpy_alone():
    tree = ast.parse((ROOT / "portbench" / "reference" / "rfft1d.py")
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
         "import portbench.reference.rfft1d; "
         "print(' '.join(set(sys.modules) - a))"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout.split()
    assert "portbench.reference.rfft1d" in loaded
    assert not {n.split(".")[0] for n in loaded} & {
        "torch", "kofft_tpu_torch", "kofft_tpu", "jax"}


def test_a_traced_call_splits_its_root_among_the_span_metrics():
    """One traced CPU rfft_split at the cell's CPU size: the plain stage
    versions are ``tree`` spans (one each) under the ladder, and the cell's
    entry, ladder and launch span metrics, read by the benchmark's own
    readers, add up to the root span's inclusive time."""
    x = _signal((1 << 14,), 3)
    kt.rfft_split(x, device="cpu")
    HK.reset_counts()
    with obs.record_spans():
        kt.rfft_split(x, device="cpu")
    snap = obs.snapshot()
    assert snap["roots"]["count"] == 1
    assert snap["spans"]["rfft_split"]["count"] == 1
    assert snap["spans"]["tree"]["count"] == 2     # stage1_real, stage2_half
    readers = {n.split(".")[0]: r
               for n, _, r in loader.load(ROOT, NAME).per_layer
               if n.split(".")[0] in SPANS}
    assert set(readers) == set(SPANS)
    got = {n: r(None) for n, r in readers.items()}
    assert got["launch_us_per_call"] > 0.0
    whole = snap["roots"]["incl_ns"] * 1e-3
    assert sum(got.values()) == pytest.approx(whole, rel=1e-9)
    HK.reset_counts()
