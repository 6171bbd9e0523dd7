"""CPU tests of the readers of the program's own spans and counters
(``portbench/program.py`` and the five ``metrics/`` files that use it;
run: python -m pytest portbench/tests).

A ``--trace 1`` run of a small cell carries them, an untraced run does
not, and each reader returns None where the program keeps no snapshot.
"""

from __future__ import annotations

import sys
import types

import pytest

from test_portbench import CELLS, ROOT, _run, _small_root, _spec  # noqa: E402

from portbench import loader, program  # noqa: E402

SPAN = ("entry_us_per_call", "ladder_us_per_call", "launch_us_per_call")
COUNTER = ("table_builds_per_call", "alloc_mib_per_call")
NEW = SPAN + COUNTER


def _listed(cell: str) -> set:
    return {m["name"] for m in _spec(ROOT)["per_layer"]
            if cell in m.get("workloads", []) and m["name"].split(".")[0]
            in NEW}


def test_every_cell_lists_the_new_metrics_it_reads():
    """The metrics read by these readers are those that BENCHMARK.json
    says come from the program's spans and counters, cell by cell."""
    want = {cell: {m["name"] for m in _spec(ROOT)["per_layer"]
                   if m["source"] in ("program_span", "program_counter")
                   and cell in m.get("workloads", [])}
            for cell in CELLS}
    assert {cell: _listed(cell) for cell in CELLS} == want
    assert all(want.values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_carries_them_and_an_untraced_one_does_not(tmp_path,
                                                                cell):
    root = _small_root(tmp_path)
    res = _run(root, cell, trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert _listed(cell) <= set(m)
    val = {n.split(".")[0]: m[n]["value"] for n in _listed(cell)}
    for name in set(SPAN) & set(val):
        assert val[name] >= 0.0
    if "launch_us_per_call" in val:              # the plain engines' ops
        assert val["launch_us_per_call"] > 0.0
    if "table_builds_per_call" in val:           # every table warm
        assert val["table_builds_per_call"] == 0.0
    if "alloc_mib_per_call" in val:              # no kernel on the CPU
        assert val["alloc_mib_per_call"] == 0.0
    # the three span metrics split the root spans' inclusive time
    if set(SPAN) <= set(val):
        snap = program.snapshot()
        roots = snap["roots"]
        whole = roots["incl_ns"] * 1e-3 / roots["count"]
        assert sum(val[n] for n in SPAN) == pytest.approx(whole, rel=1e-9)
    res = _run(root, cell, trace=False)
    assert not set(res["metrics"]) & {n for n in m
                                      if n.split(".")[0] in NEW}


def test_the_readers_return_none_without_a_snapshot(tmp_path, monkeypatch):
    root = _small_root(tmp_path)
    cell = loader.load(root, "fft1d_c32.2p20_sync")
    readers = {n: r for n, _, r in cell.per_layer
               if n.split(".")[0] in NEW}
    assert len(readers) == len(NEW)
    run = types.SimpleNamespace(calls=10, trace=None)
    monkeypatch.delitem(sys.modules, program.MODULE, raising=False)
    assert all(r(run) is None for r in readers.values())
    # a program whose observability module has no snapshot (the parent's)
    monkeypatch.setitem(sys.modules, program.MODULE,
                        types.ModuleType(program.MODULE))
    assert all(r(run) is None for r in readers.values())
    # a snapshot with no root span: no span reading, the counters read 0
    empty = {"spans": {}, "roots": {"count": 0, "incl_ns": 0, "self_ns": 0},
             "counters": {"table_builds": 0, "alloc_bytes": 0}}
    sys.modules[program.MODULE].snapshot = lambda: empty
    got = {n.split(".")[0]: r(run) for n, r in readers.items()}
    assert all(got[n] is None for n in SPAN)
    assert got["table_builds_per_call"] == 0.0
    assert got["alloc_mib_per_call"] == 0.0
