"""CPU tests of a cell on more than one card (``portbench/ranks.py``, the
harness's ``group`` and ``check.partial``/``check.combine``; run: python
-m pytest portbench/tests).

The trial cell of ``trial_cell.py`` (the port's ``fftn_sharded`` on a 16^3
cube) runs on four gloo ranks on the CPU, each its own process, through
the same launcher the command uses on four cards.
"""

from __future__ import annotations

import json
import math
import multiprocessing as mp
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import trial_cell  # noqa: E402
from portbench import check, harness, ranks  # noqa: E402
from test_portbench import CELLS, _check_line, _run, _small_root  # noqa: E402

CELL = trial_cell.CELL


def _launch(root, trace=False, seed=7, **kw):
    """Rank 0's result of a run of the trial cell on 4 gloo ranks, the
    launcher's log lines and the ranks' pids."""
    lines = []
    res, found = ranks.launch(root, CELL, seed, 0.3, trace, "cpu", 4,
                              time.perf_counter(), lines.append, **kw)
    return res, found, lines


def _pids(lines) -> list:
    for line in lines:
        m = re.search(r"pids \[([\d, ]+)\]", line)
        if m:
            return [int(p) for p in m.group(1).split(",")]
    raise AssertionError(f"no pids in {lines}")


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


# ---------------------------------------------------------------------------
# the check over shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_the_parts_combine_to_the_whole_answers_errors(seed):
    """``combine`` of four parts' ``partial`` reads what ``errors`` reads
    on the whole array, at random shapes and splits (parts may be
    empty)."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(n) for n in rng.integers(1, 12, rng.integers(1, 4)))
    ref = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = ref + 1e-6 * (rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape))
    axis = int(rng.integers(len(shape)))
    parts = [check.partial(g, r) for g, r in
             zip(np.array_split(got, 4, axis), np.array_split(ref, 4, axis))]
    whole = check.errors(got, ref)
    # the whole array's numbers as one card has always read them
    d = np.abs(got - ref)
    scale = np.sqrt(np.mean(np.abs(ref) ** 2))
    assert whole == {"rms_err": float(np.sqrt(np.mean(d ** 2)) / scale),
                     "max_err": float(np.max(d)) / float(scale)}
    joined = check.combine(parts)
    assert set(joined) == set(whole) == set(check.NAMES)
    for k in check.NAMES:
        assert joined[k] == pytest.approx(whole[k], rel=1e-12, abs=0)


def test_a_part_of_another_shape_or_not_finite_fails_the_whole():
    """So does an empty answer, which no number would hold."""
    ref = np.ones((4, 3), complex)
    good = check.partial(ref, ref)
    assert check.combine([good, good]) == {"rms_err": 0.0, "max_err": 0.0}
    bad = check.partial(ref[:, :2], ref)
    assert check.combine([good, bad]) == {k: math.inf for k in check.NAMES}
    nan = ref.copy()
    nan[1, 1] = np.nan
    assert check.combine([good, check.partial(nan, ref)]) == \
        {k: math.inf for k in check.NAMES}
    empty = np.ones(0, complex)
    assert check.errors(empty, empty) == {k: math.inf for k in check.NAMES}
    out = check.judge([check.combine([good, bad])], {"rms_err": 1e-5})
    assert out[:2] == (False, 1)


# ---------------------------------------------------------------------------
# four gloo ranks through the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_four_ranks_run_the_sharded_trial_cell(tmp_path, capfd, trace):
    """Rank 0's result: correct against NumPy's float64 ``fftn``, four
    distinct devices, every card's peak, and (traced) every card's busy
    time; every rank issued the same calls; no rank is left."""
    root = trial_cell.make(tmp_path / "trial")
    res, found, lines = _launch(root, trace)
    err = capfd.readouterr().err
    spec = json.loads((root / "BENCHMARK.json").read_text())
    _check_line(spec, CELL, res, trace)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    dev = res["device"]
    assert (dev["platform"], dev["kind"], dev["count"]) == ("cpu", "cpu", 4)
    assert dev["memory_peak_bytes_per_device"] == [0] * 4
    if trace:
        assert len(dev["busy_s_per_device"]) == 4
        assert dev["window_s"] == dev["window_s_per_device"][0] > 0
    assert found == []
    calls = re.findall(r"\[rank 0\] calls issued by rank 0 \.\.\. 3: "
                       r"\[([\d, ]+)\]", err)
    assert len(calls) == 1
    per_rank = [int(c) for c in calls[0].split(",")]
    assert len(per_rank) == 4 and len(set(per_rank)) == 1
    assert per_rank[0] > res["attempted"]          # warm-up and pace too
    # only rank 0 read the metrics and built a result
    assert not re.search(r"\[rank [123]\] (check|untraced window)", err)
    assert all(_gone(p) for p in _pids(lines))
    assert not mp.active_children()


COUNT = '''
CALLS = [0]
_entry = entry


def entry(cfg, cell):
    call = _entry(cfg, cell)

    def counted(inp):
        CALLS[0] += 1
        return call(inp)
    return counted
'''


def _on_rank(root: str) -> tuple:
    """``harness.run_cell`` as rank r of the world it is called in: its
    return value and the calls the adapter saw."""
    import torch.distributed as dist
    r, d = dist.get_rank(), dist.get_world_size()
    ctrl = dist.new_group(backend="gloo")
    group = ranks.Group(r, d, ctrl, [ranks._card("cpu", k) for k in
                                     range(d)])
    res = harness.run_cell(root, CELL, 5, 0.2, False, "cpu",
                           log=lambda *a: None, group=group)
    return res, sys.modules["portbench_adapter_fftn_sharded"].CALLS[0]


def test_rank_zero_alone_returns_and_every_rank_issues_the_same_calls(
        tmp_path):
    from kofft_tpu_torch.parallel import _spawn
    root = trial_cell.make(tmp_path / "trial", patch=COUNT)
    out = _spawn.run(_on_rank, 4, str(root), timeout=120)
    results, calls = zip(*out)
    assert isinstance(results[0], dict) and results[0]["correct"]
    assert results[1:] == (None, None, None)
    assert len(set(calls)) == 1 and calls[0] > results[0]["attempted"]


CORRUPT = '''
_entry = entry


def entry(cfg, cell):
    call = _entry(cfg, cell)

    def altered(inp):
        import torch.distributed as dist
        yr, yi = call(inp)
        if dist.get_rank() == 2:
            loc = yr.to_local()
            loc.view(-1)[loc.numel() // 3] += loc.pow(2).mean().sqrt()
        return yr, yi
    return altered
'''


def test_one_altered_element_on_one_rank_is_not_correct(tmp_path):
    root = trial_cell.make(tmp_path / "trial", patch=CORRUPT)
    res, _, _ = _launch(root)
    assert res["correct"] is False and res["failed"] >= 1, res["checks"]
    assert res["checks"]["max_err"]["value"] > 0.1


FAULTS = {
    "raises": "raise RuntimeError('planted')",
    "exits": "import os; os._exit(3)",
    "hangs": "import time; time.sleep(3600)",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_failing_or_hanging_rank_ends_the_run_within_its_deadline(
        tmp_path, fault):
    """Rank 1 fails in its entry: the launcher raises within the
    deadline, and every rank has ended."""
    patch = ("\n_entry = entry\n\n\ndef entry(cfg, cell):\n"
             "    import torch.distributed as dist\n"
             "    if dist.get_rank() == 1:\n"
             f"        {FAULTS[fault]}\n"
             "    return _entry(cfg, cell)\n")
    root = trial_cell.make(tmp_path / "trial", patch=patch)
    lines = []
    deadline = 25.0
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailed) as e:
        ranks.launch(root, CELL, 3, 0.3, False, "cpu", 4,
                     time.perf_counter(), lines.append, deadline_s=deadline)
    took = time.monotonic() - t0
    assert took < deadline + 15, took
    if fault == "hangs":
        assert took >= deadline and "within" in str(e.value)
    else:
        assert took < deadline and "rank 1" in str(e.value)
    assert all(_gone(p) for p in _pids(lines))
    assert not mp.active_children()


def test_ranks_on_one_card_are_refused_and_cards_of_two_kinds_fail():
    card = {"index": 0, "name": "H100", "id": "GPU-a"}
    ranks._check_cards([card, dict(card, index=1, id="GPU-b")])
    with pytest.raises(ranks.Refused):
        ranks._check_cards([card, dict(card, index=1)])
    with pytest.raises(RuntimeError, match="differ"):
        ranks._check_cards([card, dict(card, id="GPU-b", name="A100")])


def test_the_command_without_four_cards_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without four")
    root = trial_cell.make(tmp_path / "trial")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=root, capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 4 CUDA device(s)" in p.stderr


# ---------------------------------------------------------------------------
# one card: as before
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_a_one_chip_cell_keeps_its_result(tmp_path, trace):
    """The result's keys in their order and its device as before, with
    the per-card lists beside them."""
    root = _small_root(tmp_path)
    for cell in CELLS:
        res = _run(root, cell, trace=trace)
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(res) == keys + (["breakdown"] if trace else []) + \
            ["checks"]
        dev = res["device"]
        want = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
        if trace:
            assert dev["busy_s_per_device"] == [dev["busy_s"]]
            assert dev["window_s_per_device"] == [dev["window_s"]]
            want.update(busy_s=dev["busy_s"], window_s=dev["window_s"],
                        busy_s_per_device=[dev["busy_s"]],
                        window_s_per_device=[dev["window_s"]])
        want["memory_peak_bytes_per_device"] = [0]
        assert dev == want
        assert res["correct"], res["checks"]


def test_a_one_chip_run_starts_no_rank_and_no_group(tmp_path):
    root = _small_root(tmp_path)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import multiprocessing as mp, torch.distributed as dist\n"
            "from portbench import harness\n"
            f"for c in {CELLS!r}:\n"
            f"    harness.run_cell({str(root)!r}, c, 3, 0.05, False, 'cpu',"
            " log=lambda *a: None)\n"
            "print('portbench.ranks' in sys.modules, dist.is_initialized(),"
            " len(mp.active_children()))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split()[-3:] == ["False", "False", "0"]
