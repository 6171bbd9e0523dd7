"""The port's bench harness (``kofft_tpu_torch.bench``) against
``kofft_tpu.bench``, on the CPU, and the port's module surface against
every module of ``kofft_tpu``.

On CPU tensors a chain is an eager loop timed by the harness's clock
(``harness._clock``); the card's path (a CUDA graph of the chain, timed
by CUDA events) is held in ``tests/test_torch_gpu.py``. The slope tests
replace the clock with a deterministic one whose times are exact binary
fractions, so the slope is compared for equality.
"""

import ast
import dataclasses
import importlib
import importlib.util
import json
import pkgutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import kofft_tpu  # noqa: E402
from kofft_tpu.bench import harness as JH  # noqa: E402
import kofft_tpu_torch  # noqa: E402
from kofft_tpu_torch.bench import harness as TH  # noqa: E402


def test_bench_harness_inprocess_torch(tmp_path):
    """The counterpart of tests/test_cli.py::test_bench_harness_inprocess
    on CPU tensors: timeit_chained's slope machinery and the history's
    rotation."""
    from kofft_tpu_torch.bench import (BenchRecord, last_measurement_mode,
                                       run_history, timeit_chained,
                                       timeit_chained_scalar)
    t = timeit_chained(lambda p: (p[0] + 1.0,),
                       (torch.zeros(8, dtype=torch.float32),), iters=4,
                       target_time=0.002)
    assert t > 0 and last_measurement_mode() in ("slope", "upper_bound")
    ts = timeit_chained_scalar(
        lambda a, acc: acc + torch.sum(a) * 1e-9,
        torch.ones(8, dtype=torch.float32), iters=4, target_time=0.002)
    assert ts > 0
    rec = BenchRecord("kofft_tpu_torch", "unit", 8, "test", t * 1e9,
                      1.0 / t, "cpu", snr_db=100.0)
    doc1 = run_history([rec], out_dir=tmp_path)
    assert doc1["records"][0]["prev_time_per_op_ns"] is None
    assert doc1["environment"]["shard_threshold"] > 0
    rec2 = BenchRecord("kofft_tpu_torch", "unit", 8, "test", t * 2e9,
                       0.5 / t, "cpu")
    doc2 = run_history([rec2], out_dir=tmp_path)
    r2 = doc2["records"][0]
    assert r2["prev_time_per_op_ns"] == rec.time_per_op_ns
    assert abs(r2["change_vs_prev"] - 1.0) < 1e-6
    assert (tmp_path / "previous.json").exists()


def test_snr_tier_policy_check_torch():
    """The counterpart of tests/test_cli.py::test_snr_tier_policy_check:
    rows clearing their floor pass, a row under it fails loudly with the
    reference's message, unannotated and unpoliced rows are ignored."""
    from kofft_tpu_torch.bench import (BenchRecord, SNR_POLICY_DB,
                                       check_snr_policy)
    ok = BenchRecord("kofft_tpu_torch", "complex", 1 << 20, "single_fast",
                     1.0, 1.0, "cuda", snr_db=44.1)
    unannotated = BenchRecord("kofft_tpu_torch", "complex", 1 << 20,
                              "single", 1.0, 1.0, "cuda")
    unpoliced = BenchRecord("kofft_tpu_torch", "bluestein", 4099, "single",
                            1.0, 1.0, "cuda", snr_db=10.0)
    check_snr_policy([ok, unannotated, unpoliced])
    floor = SNR_POLICY_DB[("istft_frames", "single_fast")]
    bad = BenchRecord("kofft_tpu_torch", "istft_frames", 4096, "single_fast",
                      1.0, 1.0, "cuda", snr_db=floor - 5.0)
    with pytest.raises(AssertionError, match="istft_frames") as port:
        check_snr_policy([ok, bad])
    jbad = JH.BenchRecord("kofft_tpu_torch", "istft_frames", 4096,
                          "single_fast", 1.0, 1.0, "cuda",
                          snr_db=floor - 5.0)
    with pytest.raises(AssertionError) as ref:
        JH.check_snr_policy([jbad])
    assert str(port.value) == str(ref.value)


def test_policy_and_record_schema_as_kofft_tpu():
    """SNR_POLICY_DB equals the reference's (the port keeps its numeric
    contract); BenchRecord has the reference's fields, in order, with the
    same defaults, and the package exports the same names."""
    import kofft_tpu.bench as JB
    import kofft_tpu_torch.bench as TB
    assert TH.SNR_POLICY_DB == JH.SNR_POLICY_DB
    assert len(TH.SNR_POLICY_DB) == 9

    def schema(cls):
        return [(f.name, f.default,
                 f.default_factory is not dataclasses.MISSING)
                for f in dataclasses.fields(cls)]

    assert schema(TH.BenchRecord) == schema(JH.BenchRecord)
    args = ("lib", "complex", 8, "single", 1.0, 2.0)
    t, j = TH.BenchRecord(*args), JH.BenchRecord(*args)
    t.measurement_mode = j.measurement_mode = "slope"
    assert t.to_dict() == j.to_dict()

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")
                and n != "harness"}

    assert public(TB) == public(JB)


def _records(cls, times, modes):
    """Rows of both packages from the same numbers."""
    keys = [("lib", "complex", 1 << 20, "single"),
            ("lib", "complex", 1 << 20, "single_fast"),
            ("lib", "real", 1 << 20, "single_fast"),
            ("other", "complex", 1 << 20, "single")]
    out = []
    for (lib, tr, n, mode), t, mm in zip(keys, times, modes):
        r = cls(lib, tr, n, mode, t, 1e9 / t, "cpu", snr_db=50.0)
        r.measurement_mode = mm
        out.append(r)
    return out


def test_run_history_as_kofft_tpu(tmp_path):
    """The same records through both run_history calls, twice, give the
    same rows (prev_time_per_op_ns, change_vs_prev: none across a change
    of measurement mode) and the same rotation; only the environment
    differs."""
    docs = {}
    for name, mod in (("jax", JH), ("torch", TH)):
        out = tmp_path / name
        first = mod.run_history(
            _records(mod.BenchRecord, [100.0, 50.0, 40.0, 80.0],
                     ["slope"] * 4), out_dir=out)
        second = mod.run_history(
            _records(mod.BenchRecord, [90.0, 60.0, 44.0, 80.0],
                     ["slope", "upper_bound", "slope", "slope"]),
            out_dir=out)
        prev = json.loads((out / "previous.json").read_text())
        latest = json.loads((out / "latest.json").read_text())
        assert prev == first and latest == second
        docs[name] = (first, second)
    for i in range(2):
        assert docs["torch"][i]["records"] == docs["jax"][i]["records"]
    rows = docs["torch"][1]["records"]
    assert [r["prev_time_per_op_ns"] for r in rows] == [100.0, 50.0, 40.0,
                                                         80.0]
    assert [r["change_vs_prev"] for r in rows] == [
        pytest.approx(-0.1), None, pytest.approx(0.1), 0.0]
    tenv, jenv = docs["torch"][1]["environment"], docs["jax"][1]["environment"]
    cfg = kofft_tpu_torch.get_config()
    for key in ("backend", "precision", "shard_threshold", "dft_cutoff",
                "overlap_chunks"):
        assert key in jenv and tenv[key] == getattr(cfg, key)
    assert tenv["platform"] == "cpu" and tenv["nvidia_smi"] is None
    assert tenv["torch_version"] == torch.__version__
    assert tenv["cuda_version"] == torch.version.cuda
    assert set(tenv) - set(jenv) == {"torch_version", "cuda_version",
                                     "nvidia_smi"}


def test_run_history_carries_a_partial_run_forward(tmp_path):
    """A run that measures a subset keeps the rows it skipped: they are
    carried forward unchanged and tagged stale, after the re-measured
    rows, which behave as in the reference. The reference drops them (the
    one listed difference)."""
    docs = {}
    for name, mod in (("jax", JH), ("torch", TH)):
        out = tmp_path / name
        mod.run_history(_records(mod.BenchRecord, [100.0, 50.0, 40.0, 80.0],
                                 ["slope"] * 4), out_dir=out)
        first = json.loads((out / "latest.json").read_text())
        part = _records(mod.BenchRecord, [110.0, 55.0, 40.0, 80.0],
                        ["slope"] * 4)[:2]
        docs[name] = (first, mod.run_history(part, out_dir=out))
    jfirst, jdoc = docs["jax"]
    tfirst, tdoc = docs["torch"]
    assert len(jdoc["records"]) == 2                 # the reference drops
    fresh, stale = tdoc["records"][:2], tdoc["records"][2:]
    assert fresh == jdoc["records"]
    assert stale == [dict(r, stale=True) for r in tfirst["records"][2:]]
    # a third run re-measures a stale row: its previous time is the
    # carried one, and the row is fresh again
    third = TH.run_history(_records(TH.BenchRecord, [1.0, 1.0, 36.0, 1.0],
                                    ["slope"] * 4)[2:3],
                           out_dir=tmp_path / "torch")
    assert third["records"][0]["prev_time_per_op_ns"] == 40.0
    assert third["records"][0]["change_vs_prev"] == pytest.approx(-0.1)
    assert "stale" not in third["records"][0]
    assert [r["mode"] for r in third["records"][1:]] == [
        "single", "single_fast", "single"]
    assert all(r["stale"] for r in third["records"][1:])


def test_history_default_folder_is_under_build():
    """The default history folder is bench/ under the port's build
    directory (git-ignored), never the reference's benchmarks/."""
    from kofft_tpu_torch.ops._cuda_build import BUILD_DIR
    import inspect
    default = inspect.signature(TH.run_history).parameters["out_dir"].default
    assert Path(default) == BUILD_DIR / "bench"
    repo = Path(__file__).resolve().parent.parent
    assert Path(default).relative_to(repo).parts[0] == "build"
    assert "build/" in (repo / ".gitignore").read_text().split()


class _Clock:
    """A deterministic clock in ticks of 2^-40 s: a read costs
    ``fixed`` ticks (so a run, two reads, has that fixed cost), an
    application ``op`` ticks, and a read returns the time rounded down to
    ``resolution`` ticks."""

    TICK = 2.0 ** -40

    def __init__(self, fixed: int, op: int, resolution: int = 1):
        self.now, self.fixed, self.op, self.res = 0, fixed, op, resolution

    def __call__(self) -> float:
        self.now += self.fixed
        return (self.now // self.res) * self.res * self.TICK

    def apply(self, x):
        self.now += self.op
        return x


def _time(clock, scalar: bool, **kw):
    a = torch.ones(4)
    if scalar:
        return TH.timeit_chained_scalar(
            lambda x, acc: clock.apply(acc + x[0] * 0.0), a, **kw)
    return TH.timeit_chained(lambda p: clock.apply(p), (a,), **kw)


@pytest.mark.parametrize("scalar", [False, True])
def test_slope_on_a_deterministic_clock(monkeypatch, scalar):
    """Each application costs exactly t and each run a fixed cost F: the
    harness returns t (the fixed cost cancels), mode "slope"."""
    t, fixed = 1 << 20, 1 << 30                     # 2^-20 s, 2^-10 s
    clock = _Clock(fixed, t)
    monkeypatch.setattr(TH, "_clock", clock)
    assert _time(clock, scalar) == t * _Clock.TICK
    assert TH.last_measurement_mode() == "slope"
    assert TH.BenchRecord("l", "t", 1, "m", 1.0, 1.0).measurement_mode \
        == "slope"


@pytest.mark.parametrize("scalar", [False, True])
def test_upper_bound_on_a_noise_swamped_clock(monkeypatch, capsys, scalar):
    """An op far below the clock's resolution (2^-40 s per application
    against ~1 ms ticks): no chain reads longer than another, the slope
    sits under the noise floor, and the harness returns the pilot's
    launch-inclusive bound F / N1 with mode "upper_bound"."""
    res = 1 << 30
    fixed = 2 * res
    clock = _Clock(fixed, 1, resolution=res)
    monkeypatch.setattr(TH, "_clock", clock)
    assert _time(clock, scalar, iters=4) == fixed * _Clock.TICK / TH._N1
    assert TH.last_measurement_mode() == "upper_bound"
    assert "upper bound" in capsys.readouterr().err
    assert TH.BenchRecord("l", "t", 1, "m", 1.0, 1.0).measurement_mode \
        == "upper_bound"


def test_operands_tensor_tuple_list_and_one_device(monkeypatch):
    """An operand may be a tensor, a tuple or a list of tensors (fn
    returns the same structure); tensors on two devices are refused."""
    clock = _Clock(1 << 30, 1 << 20)
    monkeypatch.setattr(TH, "_clock", clock)
    a = torch.ones(4)
    seen = []

    def fn(p):
        seen.append(type(p))
        return clock.apply(p)

    for op in (a, (a, a), [a, a]):
        seen.clear()
        assert TH.timeit_chained(fn, op) == 2.0 ** -20
        assert set(seen) == {type(op)}
    with pytest.raises(ValueError, match="devices"):
        TH.timeit_chained(fn, (a, torch.ones(4, device="meta")))


# --------------------------------------------------------------------------
# the module surface
# --------------------------------------------------------------------------

# the port's names of the reference's Pallas modules
_RENAMED = {"pallas_kernels": "hopper_kernels", "pallas_fft": "hopper_fft"}

# public names of kofft_tpu modules that only JAX has, each with the
# reason the port has no counterpart
_JAX_ONLY = {
    "kofft_tpu.config": {
        # a jax.lax.Precision for the tier; the port's tiers act through
        # config.precision in its routes and kernels
        "lax_precision",
        # JAX's jax_enable_x64 flag; torch keeps float64 input float64
        "x64_active"},
    # whether a TPU attachment moves complex64 across the host boundary;
    # torch moves complex tensors on every device
    "kofft_tpu.ops.fft": {"complex_io_supported"},
    # the Pallas primitives and their availability check; the port's
    # autograd ops of hopper_fft and the kernel wrappers take their place
    "kofft_tpu.ops.pallas_fft": {
        "pallas_fft_planes", "pallas_tiled_planes", "pallas_rfft_planes",
        "pallas_fft2_planes", "pallas_fft2_big_planes",
        "pallas_fftn_planes", "pallas_supported"},
    # whether Mosaic lowers the multi-level kernel; the CUDA kernels
    # build for sm_90a or raise. The TPU's three N-D kernel entries and
    # their zones: the port runs one route on the axis kernels
    # (hopper_kernels.axes_fft_planes) over the union of the three zones
    # (ndfft._kernel_nd_zone). The tiled entry: hopper_fft's
    # kernel_tiled_planes
    "kofft_tpu.ops.pallas_kernels": {
        "multilevel_supported", "fused_fft2_planes", "fused_fft2_big_planes",
        "fused_ndfft_planes", "fused_2d_zone", "fused_2d_big_zone",
        "fused_nd_zone", "phased_tiled_fft"},
    # a shim over jax's shard_map across jax versions; the port's programs
    # work on DTensor local blocks with explicit collectives
    "kofft_tpu.parallel.ndfft_sharded": {"shard_map"},
    # parsers of compiled HLO text; the port's programs run eagerly and
    # its audits read a collective log (validate.comm_log)
    "kofft_tpu.parallel.validate": {
        "hlo_all_to_all_local_bytes", "hlo_a2a_independent_sources",
        "hlo_a2a_bytes_by_group_size", "hlo_ppermute_bytes_by_tier"},
}


def _defined(path: str, package: bool) -> set:
    """Public names a module's source binds at its top level (functions,
    classes, assignments, also under a top-level if/try but for a script's
    ``if __name__ == "__main__":`` block), and for a
    package's __init__ the names it re-exports from its submodules."""
    names = set()

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, ast.ImportFrom) and package \
                    and node.level > 0:
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.If) and "__main__" not in \
                    ast.unparse(node.test):
                walk(node.body)
                walk(node.orelse)
            elif isinstance(node, ast.Try):
                walk(node.body)
                for h in node.handlers:
                    walk(h.body)
                walk(node.orelse)

    walk(ast.parse(Path(path).read_text()).body)
    return {n for n in names if not n.startswith("_")}


def test_port_covers_every_module_of_kofft_tpu():
    """Every module of kofft_tpu (pkgutil.walk_packages, Python sources)
    has a counterpart module in kofft_tpu_torch (pallas_kernels ->
    hopper_kernels, pallas_fft -> hopper_fft) that has every public name
    the JAX module defines, but for the JAX-only names above."""
    missing, absent = [], {}
    walked = 0
    for info in pkgutil.walk_packages(kofft_tpu.__path__, "kofft_tpu."):
        origin = importlib.util.find_spec(info.name).origin
        if not origin.endswith(".py"):           # a built host library
            continue
        walked += 1
        port = "kofft_tpu_torch." + ".".join(
            _RENAMED.get(p, p) for p in info.name.split(".")[1:])
        try:
            mod = importlib.import_module(port)
        except ModuleNotFoundError:
            missing.append(port)
            continue
        lack = {n for n in _defined(origin, info.ispkg)
                if not hasattr(mod, n)} - _JAX_ONLY.get(info.name, set())
        if lack:
            absent[info.name] = sorted(lack)
    assert walked >= 50
    assert missing == [] and absent == {}, (missing, absent)
    # every allowed name is one the JAX module defines and the port lacks
    for name, allowed in _JAX_ONLY.items():
        spec = importlib.util.find_spec(name)
        assert allowed <= _defined(spec.origin, False), name
        mod = importlib.import_module("kofft_tpu_torch." + ".".join(
            _RENAMED.get(p, p) for p in name.split(".")[1:]))
        assert not any(hasattr(mod, n) for n in allowed), name


def test_module_walk_sees_a_missing_module(monkeypatch):
    """The walk's lookup fails for a module the port lacks: with
    kofft_tpu_torch.bench hidden, its two modules are reported."""
    import sys
    for m in ("kofft_tpu_torch.bench", "kofft_tpu_torch.bench.harness"):
        monkeypatch.setitem(sys.modules, m, None)
    with pytest.raises(AssertionError, match="kofft_tpu_torch.bench"):
        test_port_covers_every_module_of_kofft_tpu()
