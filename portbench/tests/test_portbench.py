"""CPU tests of the port's benchmark (run: python -m pytest portbench/tests).

Cells run here at small sizes on the CPU, through the same harness, with
the program's plain CPU paths; a test that needs the card decides so
inside the test and skips without one.
"""

from __future__ import annotations

import ast
import builtins
import json
import math
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
sys.path.insert(0, str(ROOT))

from portbench import check, harness, loader, roofline, tf32  # noqa: E402
from portbench.reference import fft1d as ref_fft  # noqa: E402
from portbench.reference import stft as ref_stft  # noqa: E402
from portbench.traffic import closed  # noqa: E402


def _spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


CELLS = [w["name"] for w in _spec(ROOT)["workloads"]]


def _small_root(tmp: Path, src: Path = ROOT) -> Path:
    """A copy of ``src``'s BENCHMARK.json and portbench/ whose cells run at
    the sizes a CPU test holds: each cell's traffic takes the
    ``cpu_sizes`` of its configuration's file; everything else as
    committed."""
    shutil.copy(src / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(src / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = _spec(tmp)
    files = {c["name"]: c["file"] for c in spec["configs"]}
    for w in spec["workloads"]:
        cfg = json.loads((tmp / files[w["config"]]).read_text())
        if "cpu_sizes" not in cfg:
            raise KeyError(f"{files[w['config']]} has no cpu_sizes")
        f = tmp / "portbench" / "workloads" / f"{w['name']}.json"
        d = json.loads(f.read_text())
        d.update(cfg["cpu_sizes"])
        f.write_text(json.dumps(d))
    return tmp


def _run(root, cell, seed=7, seconds=0.2, trace=False, **kw):
    return harness.run_cell(root, cell, seed, seconds, trace, device="cpu",
                            log=lambda *a: None, **kw)


def _modules(code: str) -> set:
    """Top-level module names a fresh interpreter holds after ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})"
         f"\n{code}\nprint(sorted({{m.split('.')[0] for m in sys.modules}}))"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


# ---------------------------------------------------------------------------
# what the benchmark may import and read
# ---------------------------------------------------------------------------

def test_no_module_is_jax_or_the_jax_package(tmp_path):
    """Every module under portbench/, and what it imports, running a cell
    of each configuration: no top-level name is jax or kofft_tpu (whole
    names; kofft_tpu_torch begins with kofft_tpu and is allowed)."""
    root = _small_root(tmp_path)
    code = ("import importlib, pathlib\n"
            "from portbench import harness, loader\n"
            f"for p in sorted(pathlib.Path({str(BENCH)!r}).rglob('*.py')):\n"
            f"    rel = p.relative_to({str(ROOT)!r})\n"
            "    if 'tests' in p.parts: continue\n"
            "    if '.' in p.stem: loader._module(p, 'metric')\n"
            "    else: importlib.import_module(\n"
            "        '.'.join(rel.with_suffix('').parts))\n"
            f"for c in {CELLS!r}:\n"
            f"    harness.run_cell({str(root)!r}, c, 3, 0.05, True, 'cpu',"
            " log=lambda *a: None)\n"
            "assert not harness.forbidden_modules()")
    names = _modules(code)
    assert "kofft_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "kofft_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kofft_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kofft_tpu.ops", sys)
    assert harness.forbidden_modules() == ["kofft_tpu"]


def test_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert all(n.split(".")[0] in ("numpy", "__future__")
                       for n in names), (p.name, names)
    names = _modules("import portbench.reference.fft1d, "
                     "portbench.reference.stft")
    assert "kofft_tpu_torch" not in names and "torch" not in names


def test_nothing_reads_the_old_benchmark_material(tmp_path, monkeypatch):
    old = ("benchmarks", "bench.py", "BENCH_", "MULTICHIP_", "BASELINE")
    for p in _sources():
        text = p.read_text()
        assert not any(o in text for o in old), p.name
    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(str(file))
        return real_open(file, *a, **kw)
    monkeypatch.setattr(builtins, "open", spy)
    root = _small_root(tmp_path)
    for c in CELLS:
        _run(root, c, seconds=0.05)
    assert opened
    assert not [f for f in opened if any(o in f for o in old)]


# ---------------------------------------------------------------------------
# the yardstick
# ---------------------------------------------------------------------------

def test_roofline_by_hand_at_the_cells_shapes():
    # complex FFT: 2 planes in + 2 out of 4 bytes per point at 3.35 TB/s
    for n in (1 << 24, 1 << 20):
        ms, by = roofline.transform_bound(False, 1, n)
        assert by == "bytes"
        assert ms == pytest.approx(16 * n / 3.35e12 * 1e3)
        assert 5 * n * math.log2(n) / 67e12 * 1e3 < ms
    assert roofline.transform_bound(False, 1, 1 << 24)[0] == \
        pytest.approx(0.08013, rel=1e-4)
    assert roofline.transform_bound(False, 1, 1 << 20)[0] == \
        pytest.approx(0.005008, rel=1e-3)
    # one-sided STFT: the signal once, 2 planes of F x (win/2 + 1) once
    for n, win, hop, frames, us in ((1 << 20, 1024, 256, 4096, 6.272),
                                    (1 << 22, 16384, 4096, 1024, 25.04)):
        nbytes = 4 * n + 8 * frames * (win // 2 + 1)
        ms, by = roofline.stft_bound(1, n, win, hop)
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
        assert ms * 1e3 == pytest.approx(us, rel=1e-3)
        assert frames * 2.5 * win * math.log2(win) / 67e12 * 1e3 < ms
    # a batch of b signals is b times one signal's work
    assert roofline.stft_bound(8, 1 << 20, 1024, 256)[0] * 1e3 == \
        pytest.approx(8 * 6.272, rel=1e-3)
    # the adapters hand these bounds and units to the readers
    for c in CELLS:
        _check_work(loader.load(ROOT, c))


# hand counts of a call's work units for the units of today's adapters;
# an adapter with another unit is held to a positive count alone
UNITS = {"points": lambda tr: math.prod(tr["shape"]),
         "frames": lambda tr: math.prod(tr["shape"][:-1])
         * -(-tr["shape"][-1] // tr["hop"])}


def _check_work(cell):
    w = cell.adapter.work(cell.cfg, cell.traffic)
    assert w["units"] > 0 and w["bound_s"] > 0
    count = UNITS.get(cell.adapter.UNIT)
    if count is not None:
        assert w["units"] == count(cell.traffic)


def test_an_adapter_of_another_unit_needs_no_hand_count(tmp_path):
    """A cell whose adapter counts a unit these tests do not know is held
    to a positive count and bound, with no test file edited."""
    root = _small_root(tmp_path)
    c = loader.load(root, CELLS[0])
    c.adapter = types.SimpleNamespace(
        UNIT="signals", work=lambda cfg, tr: {"units": 3, "bound_s": 1e-3})
    _check_work(c)


@pytest.mark.parametrize("shape", [(3, 5000), (2, 2, 777), (777,)])
def test_the_stft_expected_is_the_reference_of_the_whole_batch(shape):
    from portbench.adapters import stft
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    cell = {"win": 256, "hop": 64}
    got = stft.expected({}, cell, x)
    want = ref_stft.stft_onesided(x.numpy(), 256, 64)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_the_stft_answer_is_the_planes_as_check_joins_them():
    from portbench.adapters import stft
    g = torch.Generator().manual_seed(5)
    out = (torch.randn(2, 9, 17, generator=g),
           torch.randn(2, 9, 17, generator=g))
    got, want = stft.answer(out), check.planes(out)
    assert got.dtype == want.dtype == np.complex128
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 12, 64, 100])
def test_reference_fft_against_a_direct_dft(n):
    rng = np.random.default_rng(n)
    xr, xi = rng.standard_normal((2, 3, n))
    jk = np.outer(np.arange(n), np.arange(n))
    f = np.exp(-2j * np.pi * jk / n)
    want = (xr + 1j * xi) @ f
    np.testing.assert_allclose(ref_fft.fft(xr, xi), want, atol=1e-10)
    np.testing.assert_allclose(ref_fft.fft(xr, xi, inverse=True),
                               (xr + 1j * xi) @ f.conj() / n, atol=1e-10)


@pytest.mark.parametrize("n,win,hop", [(100, 16, 4), (64, 16, 16),
                                       (37, 8, 3), (5, 8, 2)])
def test_reference_stft_against_numpy_by_frame(n, win, hop):
    x = np.random.default_rng(n).standard_normal(n)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    nf = -(-n // hop)
    want = []
    for f in range(nf):
        seg = np.zeros(win)
        part = x[f * hop: f * hop + win]
        seg[: part.size] = part
        want.append(np.fft.fft(seg * w)[: win // 2 + 1])
    got = ref_stft.stft_onesided(x, win, hop, block=3)
    assert got.shape == (nf, win // 2 + 1)
    np.testing.assert_allclose(got, np.array(want), atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -11), 1 + 2 ** -11 + 2 ** -20])
    want = [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -1.0, 1 + 2 ** -10]
    assert tf32.round_tf32(x).tolist() == want


@pytest.mark.parametrize("n", [8, 2048, 4096, 1 << 13])
def test_tf32_dft_is_the_dft_to_tf32_accuracy(n):
    g = torch.Generator().manual_seed(n)
    xr, xi = torch.randn((2, 2, n), generator=g)
    yr, yi = tf32.dft(xr, xi)
    want = ref_fft.fft(xr.numpy(), xi.numpy())
    e = check.errors(yr.double().numpy() + 1j * yi.double().numpy(), want)
    assert 1e-5 < e["rms_err"] < 2e-3
    br, bi = tf32.dft(xr, xi, n // 2 + 1)
    assert torch.equal(br, yr[..., : n // 2 + 1])


# ---------------------------------------------------------------------------
# correct: the control and the planted faults fail, the program passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_the_limits(tmp_path, cell):
    _passes_and_control_fails(_small_root(tmp_path), cell)


def _passes_and_control_fails(root, cell):
    """The program on the CPU passes the cell's limits; the reference in
    TF32 put in its place fails them (on the card: ``readings.py``)."""
    res = _run(root, cell, seed=11)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    c = loader.load(root, cell)
    ad, cfg, tr = c.adapter, c.cfg, c.traffic
    for seed in (5, 6, 7):
        inp = ad.make_pool(cfg, tr, seed, "cpu")[0]
        e = check.errors(ad.answer(ad.control(cfg, tr, inp)),
                         ad.expected(cfg, tr, inp))
        ok, failed, _ = check.judge([e], tr["check"]["limits"])
        assert not ok and failed == 1, e


def _faults():
    def same(out, inp):          # a step that returns its state unchanged
        return inp if isinstance(inp, tuple) else (inp, torch.zeros_like(inp))

    def half(out, inp):          # half of the batch (frames, points) left out
        yr, yi = (t.clone() for t in out)
        k = yr.shape[-2] // 2 if yr.dim() > 1 else yr.shape[-1] // 2
        if yr.dim() > 1:
            yr[..., k:, :] = 0
            yi[..., k:, :] = 0
        else:
            yr[k:] = 0
            yi[k:] = 0
        return yr, yi

    def altered(out, inp):       # one answer altered where it is produced
        yr, yi = (t.clone() for t in out)
        yr.view(-1)[yr.numel() // 3] += yr.pow(2).mean().sqrt()
        return yr, yi
    return {"unchanged": same, "half": half, "altered": altered}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    """The harness's run, the look for a chip skipped, with the timed
    path broken underneath: ``correct`` comes out false."""
    root = _small_root(tmp_path)
    brk = _faults()[fault]
    real_load = loader.load

    def load(r, w):
        c = real_load(r, w)
        real_entry = c.adapter.entry

        def entry(cfg, tr):
            call = real_entry(cfg, tr)
            return lambda inp: brk(call(inp), inp)
        monkeypatch.setattr(c.adapter, "entry", entry)
        return c
    monkeypatch.setattr(loader, "load", load)
    res = _run(root, cell, seed=13)
    assert res["correct"] is False and res["failed"] >= 1, res["checks"]


# ---------------------------------------------------------------------------
# driven by data
# ---------------------------------------------------------------------------

def test_a_configuration_cell_and_metric_added_as_files(tmp_path):
    root = _small_root(tmp_path)
    b = root / "portbench"
    cfg = json.loads((b / "configs" / "fft1d_c32.json").read_text())
    cfg.update(name="fft1d_c32_inv", inverse=True)
    (b / "configs" / "fft1d_c32_inv.json").write_text(json.dumps(cfg))
    (b / "workloads" / "fft1d_c32_inv.small.json").write_text(json.dumps({
        "config": "fft1d_c32_inv", "traffic": "small", "loop": "closed",
        "shape": [4, 256], "inflight": 3, "pool": 2,
        "check": {"samples": 2, "limits": {"rms_err": 1e-5}}}))
    (b / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return run.calls\n")
    spec = _spec(root)
    spec["configs"].append({"name": "fft1d_c32_inv", "source": "test",
                            "file": "portbench/configs/fft1d_c32_inv.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "fft1d_c32_inv.small",
                              "config": "fft1d_c32_inv", "traffic": "small",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("fft1d_c32_inv.small")
    spec["per_layer"].append({"name": "calls_seen", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "points_per_s",
                              "workloads": ["fft1d_c32_inv.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    c = loader.load(root, "fft1d_c32_inv.small")
    assert c.cfg["inverse"] and c.traffic["inflight"] == 3
    assert [m[0] for m in c.per_layer] == ["calls_seen"]
    res = _run(root, "fft1d_c32_inv.small", trace=True)
    assert res["correct"], res["checks"]
    # read over the untraced half of the window
    assert 0 < res["metrics"]["calls_seen"]["value"] < res["attempted"]
    res = _run(root, "fft1d_c32_inv.small")
    assert set(res["metrics"]) == {"points_per_s", "setup_s"}
    assert res["metrics"]["points_per_s"]["value"] > 0


def test_a_new_configuration_joins_these_tests_by_files_alone(tmp_path):
    """A configuration added as files (its file with ``cpu_sizes``, an
    adapter of its own), a cell of it and metric entries for the cell:
    the suite's helpers run over it with no test file edited."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", src / "BENCHMARK.json")
    shutil.copytree(BENCH, src / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = src / "portbench"
    shutil.copy(b / "adapters" / "fft1d.py", b / "adapters" / "fft1d_twin.py")
    cfg = json.loads((b / "configs" / "fft1d_c32.json").read_text())
    cfg.update(name="twin_c32", adapter="fft1d_twin",
               cpu_sizes={"shape": [2, 512], "pool": 2})
    (b / "configs" / "twin_c32.json").write_text(json.dumps(cfg))
    cell = "twin_c32.4x2p22_stream"
    (b / "workloads" / f"{cell}.json").write_text(json.dumps({
        "config": "twin_c32", "traffic": "4x2p22_stream", "loop": "closed",
        "shape": [4, 1 << 22], "inflight": 2, "pool": 2,
        "check": {"samples": 2,
                  "limits": {"rms_err": 1e-5, "max_err": 5e-5}}}))
    spec = _spec(src)
    spec["configs"].append({"name": "twin_c32", "source": "test",
                            "file": "portbench/configs/twin_c32.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": "twin_c32",
                              "traffic": "4x2p22_stream", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "points_per_s":
            m["workloads"].append(cell)
    for name, source in (("host_us_per_call.twin", "host_clock"),
                         ("entry_us_per_call.twin", "program_span")):
        spec["per_layer"].append({"name": name, "unit": "us",
                                  "better": "lower", "source": source,
                                  "layer": "public entries",
                                  "moves": "points_per_s",
                                  "workloads": [cell]})
    (src / "BENCHMARK.json").write_text(json.dumps(spec))

    (tmp_path / "small").mkdir()
    root = _small_root(tmp_path / "small", src)
    c = loader.load(root, cell)
    assert c.adapter.__name__.endswith("fft1d_twin")
    assert c.traffic["shape"] == [2, 512] and c.traffic["pool"] == 2
    _check_work(c)
    for trace in (False, True):
        res = _run(root, cell, trace=trace)
        _check_line(_spec(root), cell, res, trace)
        assert set(res["metrics"]) == (
            {"host_us_per_call.twin", "entry_us_per_call.twin"} if trace
            else {"points_per_s", "setup_s"})
    _passes_and_control_fails(root, cell)


def test_a_suffixed_metric_is_read_by_its_base_name_reader(tmp_path):
    """``<name>.<suffix>`` without a file of its own is read by
    ``metrics/<name>.py``; a file of its own wins."""
    root = _small_root(tmp_path)
    b = root / "portbench" / "metrics"
    (b / "calls_seen.py").write_text("def read(run):\n    return 1.0\n")
    (b / "calls_seen.own.py").write_text("def read(run):\n    return 2.0\n")
    spec = _spec(root)
    cell = CELLS[0]
    for name in ("calls_seen.any", "calls_seen.own"):
        spec["per_layer"].append({"name": name, "unit": "calls",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "test", "moves": "setup_s",
                                  "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    c = loader.load(root, cell)
    got = {n: r(None) for n, _, r in c.per_layer if n.startswith("calls")}
    assert got == {"calls_seen.any": 1.0, "calls_seen.own": 2.0}
    # every metric of the committed benchmark finds its reader
    for w in CELLS:
        c = loader.load(ROOT, w)
        assert c.end_to_end and c.per_layer


def test_the_harness_names_no_configuration_or_cell():
    names = {w for w in CELLS} | {w.split(".")[0] for w in CELLS} | \
        {w.split(".")[1] for w in CELLS}
    for f in ("run.py", "harness.py", "loader.py", "trace.py", "check.py",
              "readers.py", "ranks.py", "traffic/closed.py"):
        text = (BENCH / f).read_text()
        assert not [n for n in names if n in text], f


# ---------------------------------------------------------------------------
# the result line and the loop's accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(tmp_path, trace):
    root = _small_root(tmp_path)
    for cell in CELLS:
        _check_line(_spec(root), cell, _run(root, cell, trace=trace), trace)


def _check_line(spec, cell, res, trace):
    """The result line of a CPU run of ``cell``, as ``spec`` lists it."""
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res) <= {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "checks"}
    assert isinstance(res["correct"], bool)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m for m in spec[kind]
              if cell in m.get("workloads", [cell])}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert m["unit"] == listed[name]["unit"]
        assert isinstance(m["value"], float)
    if trace:
        # no device on the CPU: the device readers find nothing; the host
        # clock's readers read the untraced half of the window, and the
        # program's spans and counters are read as on the card
        host = {n for n, m in listed.items() if m["source"] == "host_clock"}
        program = {n for n, m in listed.items()
                   if m["source"] in ("program_span", "program_counter")}
        assert host <= set(res["metrics"]) <= host | program
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == set(listed)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(res))


class _FakeClock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1000
        return self.t


class _FakeEvent:
    """An end event stamped with the call it follows; a start event
    stamped with the call it precedes."""

    def __init__(self, log, k, start=False):
        self.log, self.k, self.start, self.call = log, k, start, None

    def record(self):
        self.call = len(self.log["issued"]) - (0 if self.start else 1)

    def synchronize(self):
        self.log["waited"].append(self.call)

    def elapsed_time(self, end):
        assert end.call == self.call
        self.log["read"].append(self.call)
        return 0.5 + self.call


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_closed_loop_accounting(inflight):
    log = {"issued": [], "waited": [], "read": []}
    pool = ["a", "b", "c"]

    def call(inp):
        log["issued"].append(len(log["issued"]))
        return inp
    events = [_FakeEvent(log, k) for k in range(inflight)]
    kept = []
    clock = _FakeClock()
    rec = closed.run(call, pool, inflight, events, lambda: None,
                     seconds=20e-6, clock=clock,
                     keep=lambda i, j, o: kept.append((i, j, o)))
    n = rec["calls"]
    # 4 clock reads per call; the window stops once 20 us have passed
    assert n == 5
    assert log["issued"] == list(range(n))
    # before call i the caller waited on call i - inflight, and on no other
    assert log["waited"] == list(range(n - inflight))
    assert kept == [(i, i % 3, pool[i % 3]) for i in range(n)]
    assert rec["start"] < rec["entry"][0, 0]
    assert rec["end"] > rec["entry"][-1, 1]
    assert rec["sync"][1] == rec["end"]
    assert (np.diff(rec["entry"], axis=1) > 0).all()
    assert rec["latency_ms"] is None
    rec = closed.run(call, pool, inflight, events, lambda: None, calls=7,
                     clock=_FakeClock())
    assert rec["calls"] == 7


@pytest.mark.parametrize("inflight,ring", [(1, 1), (1, 4), (2, 3)])
def test_closed_loop_latency_stamps(inflight, ring):
    """Every call's start and end stamps are read once, after the call was
    waited on, and in call order."""
    log = {"issued": [], "waited": [], "read": []}

    def call(inp):
        i = len(log["issued"])
        log["issued"].append(i)
        # only calls already waited on are read
        assert all(k <= i - inflight for k in log["read"])
        return inp
    events = [_FakeEvent(log, k) for k in range(ring)]
    starts = [_FakeEvent(log, k, start=True) for k in range(ring)]
    rec = closed.run(call, ["a", "b"], inflight, events, lambda: None,
                     starts=starts, calls=11, clock=_FakeClock())
    assert log["read"] == list(range(11))
    assert rec["latency_ms"].tolist() == [0.5 + k for k in range(11)]
    with pytest.raises(ValueError):
        closed.run(call, ["a"], 2, events[:1], lambda: None, calls=1)
    with pytest.raises(ValueError):
        closed.run(call, ["a"], 1, events, lambda: None, starts=starts[:-1],
                   calls=1)


def test_call_p95_reads_every_call_of_the_window(tmp_path):
    """A cell whose traffic asks for latency reports the 95th percentile
    of its calls' stamps, on the CPU from the host clock."""
    root = _small_root(tmp_path)
    spec = _spec(root)
    cells = [c for m in spec["end_to_end"] if m["name"] == "call_p95_ms"
             for c in m["workloads"]]
    assert cells
    for cell in cells:
        assert loader.load(root, cell).traffic.get("latency") is True
        res = _run(root, cell, seconds=0.3)
        assert res["correct"], res["checks"]
        assert res["metrics"]["call_p95_ms"]["value"] > 0
    from portbench import readers
    run = harness.Run(setup_s=1, window_s=1, calls=100, units=1, unit="p",
                      bound_s=1, entry_ns=np.ones(100),
                      latency_ms=np.arange(1.0, 101.0), trace=None)
    assert readers.call_p95_ms(run) == pytest.approx(95.05)
    run.latency_ms = None
    assert readers.call_p95_ms(run) is None


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(20)
    for s in range(2000):
        r = harness._Reservoir(3, s)
        for i in range(20):
            r(i, i % 4, i)
        assert len(r.kept) == 3
        for i, _, _ in r.kept:
            counts[i] += 1
    assert counts.min() > 0.7 * counts.mean()
    a, b = harness._Reservoir(3, 9), harness._Reservoir(3, 9)
    for i in range(50):
        a(i, 0, i)
        b(i, 0, i)
    assert a.kept == b.kept
    assert harness.seeds(2 ** 31 + 5) == harness.seeds(2 ** 31 + 5)
    assert harness.seeds(1)[0] != harness.seeds(2)[0]


def test_trace_reduction_by_hand():
    from portbench import trace as tracing
    loop = {"start": 0, "end": 100, "sync": (90, 100), "calls": 2,
            "pick_input": np.array([[0, 5], [40, 45]]),
            "wait_event": np.array([[5, 10], [45, 50]]),
            "entry": np.array([[10, 30], [50, 70]])}
    # "edge" starts 2 ns before the window as the profiler's clock reads it:
    # counted, and clipped to the window for the busy time
    recs = [("edge", 998, 4, "kernel"), ("k1", 1010, 20, "kernel"),
            ("k2", 1020, 20, "kernel"), ("copy", 1060, 10, "gpu_memcpy")]
    assert tracing.pick_offset(recs, 0, 100, {"a": 1000, "b": 0}) == 1000
    t = tracing.reduce(recs, 1000, loop)
    assert (t.kernels, t.ops, t.calls) == (3, 4, 2)
    assert t.busy_s == pytest.approx(42e-9)   # [0, 2], [10, 40], [60, 70]
    assert t.op_sum_s == pytest.approx(54e-9)
    assert t.window_s == pytest.approx(100e-9)
    idle = {k: v / 1e-9 for k, v in t.idle_by_span.items()}
    # idle [2, 10], [40, 60], [70, 100]
    assert idle == pytest.approx({"pick_input": 8, "wait_event": 10,
                                  "entry": 10, "sync": 10,
                                  "between spans": 20})
    b = tracing.breakdown(t)
    assert b["device_ops"][0][0] in ("k1", "k2")
    assert len(b["device_ops"]) == 4


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def test_the_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode == 2 and p.stdout == ""


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, env=env)
    assert p.returncode != 0 and p.stdout == ""


def test_cells_on_the_card():
    """On a card: each cell's command, briefly, prints a correct result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            cell, "--seed", "2147483700", "--seconds", "1",
                            "--trace", "0"], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-4000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
