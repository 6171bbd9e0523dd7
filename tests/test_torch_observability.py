"""The port's program spans and counters (``kofft_tpu_torch.utils.
observability``) on the CPU: spans are off by default and record nothing;
they record under ``torch.profiler`` and under the operator's switch;
self time is the duration less the children's; the spans of one call
share its call id; a 2-D call's ``route`` span closes before its axis
kernels; the ring of raw records stays bounded; threads keep
their own stacks; ``table_builds`` counts a first call's cache misses and
none on an identical second call; ``hopper_kernels.reset_counts`` zeroes
the whole registry and the span totals; and ``trace`` writes the
program's spans into the profiler's Chrome trace, on the profiler's
clock.
"""

import collections
import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kofft_tpu_torch as tk  # noqa: E402
from kofft_tpu_torch.errors import InvalidValueError  # noqa: E402
from kofft_tpu_torch.ops import goertzel as G  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.plan import tables  # noqa: E402
from kofft_tpu_torch.utils import observability as obs  # noqa: E402


@pytest.fixture
def clean():
    """Counters and span totals zeroed; the switch as it was found."""
    was = obs.switch
    HK.reset_counts()
    yield
    obs.switch = was
    HK.reset_counts()


def _planes(n, seed=0, batch=()):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((*batch, n), generator=g),
            torch.randn((*batch, n), generator=g))


def _calls(since):
    """The ring's records newer than id ``since``, by call id."""
    out = collections.defaultdict(list)
    for r in obs.records():
        if r[0] > since:
            out[r[5]].append(r)
    return out


def _last_id():
    """The largest span id in the ring (ids are given as spans open)."""
    return max((r[0] for r in obs.records()), default=-1)


def test_spans_are_off_by_default_and_record_nothing(clean):
    assert not obs.spans_on()
    before = obs.records()
    xr, xi = _planes(1 << 14)
    tk.fft_split(xr, xi)
    tk.stft_split(torch.randn(4096), tk.window.hann(256), 64,
                  onesided=True, device="cpu")
    snap = obs.snapshot()
    assert snap["spans"] == {} and snap["roots"]["count"] == 0
    assert obs.records() == before
    assert HK.classes["stages"] == 1          # counters are always on


def test_spans_record_under_the_profiler(clean):
    xr, xi = _planes(1 << 14)
    tk.fft_split(xr, xi)
    HK.reset_counts()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]):
        assert obs.spans_on()
        tk.fft_split(xr, xi)
    assert not obs.spans_on()
    snap = obs.snapshot()
    assert snap["roots"]["count"] == 1
    assert snap["spans"]["fft_split"]["count"] == 1
    assert snap["spans"]["ladder"]["count"] == 1
    assert snap["spans"]["route"]["count"] == 1


def test_spans_record_under_the_switch_and_stop_after_it(clean):
    xr, xi = _planes(1 << 12)
    with obs.record_spans():
        assert obs.spans_on()
        tk.fft_split(xr, xi)
        with obs.record_spans(False):
            tk.fft_split(xr, xi)
        tk.ifft_split(xr, xi)
    assert not obs.spans_on()
    tk.fft_split(xr, xi)
    snap = obs.snapshot()
    assert snap["roots"]["count"] == 2
    assert snap["spans"]["fft_split"]["count"] == 1
    assert snap["spans"]["ifft_split"]["count"] == 1
    assert snap["spans"]["tree"]["count"] == 2     # 4096 points: plain
    obs.record_spans()
    try:
        tk.rfft_split(xr)
    finally:
        obs.record_spans(False)
    assert obs.snapshot()["spans"]["rfft_split"]["count"] == 1


def test_self_time_is_the_duration_less_the_children(clean):
    with obs.record_spans():
        outer = obs.begin("outer")
        time.sleep(0.002)
        for _ in range(2):
            inner = obs.begin("inner")
            deep = obs.begin("deep")
            time.sleep(0.001)
            obs.end(deep)
            obs.end(inner)
        obs.end(outer)
    s = obs.snapshot()["spans"]
    assert s["outer"]["self_ns"] == (s["outer"]["incl_ns"]
                                     - s["inner"]["incl_ns"])
    assert s["inner"]["self_ns"] == (s["inner"]["incl_ns"]
                                     - s["deep"]["incl_ns"])
    assert s["deep"]["self_ns"] == s["deep"]["incl_ns"] >= 2_000_000
    assert s["outer"]["self_ns"] >= 2_000_000
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    roots = obs.snapshot()["roots"]
    assert roots == {"count": 1, "incl_ns": s["outer"]["incl_ns"],
                     "self_ns": s["outer"]["self_ns"]}


def test_an_entrys_spans_add_up_to_its_root(clean):
    """Every span of a call lies under its root, so the self times of all
    of them add up to the root's inclusive time, exactly."""
    xr, xi = _planes(1 << 14, batch=(2,))
    w = tk.window.hann(1024)
    with obs.record_spans():
        tk.fft_split(xr, xi)
        tk.stft_split(torch.randn(2, 8192), w, 256, onesided=True,
                      device="cpu")
    snap = obs.snapshot()
    assert snap["roots"]["count"] == 2
    assert sum(v["self_ns"] for v in snap["spans"].values()) == \
        snap["roots"]["incl_ns"]
    assert snap["spans"]["frame"]["count"] == 2   # window, framing
    assert snap["spans"]["stft_split"]["count"] == 1


@pytest.mark.parametrize("shape", [(512, 512), (2048, 1024)])
def test_a_2d_calls_route_span_closes_before_its_kernels(clean, shape):
    """fftn_split over the last two axes, in both JAX 2-D kernel zones: the
    ``route`` span (the count and the views) sits under the ladder and
    holds no span, as on the 1-D routes; the axis kernels (on the CPU
    their plain versions, a ``tree`` span each) sit under the ladder too;
    the self times of the call's spans add up to its root's inclusive
    time, exactly."""
    xr, xi = _planes(shape[-1], seed=3, batch=shape[:-1])
    since = _last_id()
    with obs.record_spans():
        tk.fftn_split(xr, xi, axes=(-2, -1), device="cpu")
    snap = obs.snapshot()
    assert HK.classes["axes"] == 1
    assert snap["roots"]["count"] == 1
    route = snap["spans"]["route"]
    assert route["count"] == 1 and route["self_ns"] == route["incl_ns"]
    assert snap["spans"]["tree"]["count"] == 2        # col_fft, row_fft
    assert sum(v["self_ns"] for v in snap["spans"].values()) == \
        snap["roots"]["incl_ns"]
    (recs,) = _calls(since).values()
    by_id = {r[0]: r for r in recs}
    (route,) = [r for r in recs if r[1] == "route"]
    assert by_id[route[4]][1] == "ladder"
    assert by_id[by_id[route[4]][4]][1] == "fftn_split"
    trees = [r for r in recs if r[1] == "tree"]
    assert [by_id[r[4]][1] for r in trees] == ["ladder"] * 2
    assert all(r[2] >= route[3] for r in trees)


def test_spans_of_one_call_share_its_call_id(clean):
    xr, xi = _planes(1 << 14)
    since = _last_id()
    with obs.record_spans():
        tk.fft_split(xr, xi)
        tk.fft_split(xr, xi)
    calls = _calls(since)
    assert len(calls) == 2
    for recs in calls.values():
        ids = {r[0]: r for r in recs}
        roots = [r for r in recs if r[4] == -1]
        assert [r[1] for r in roots] == ["fft_split"]
        for r in recs:
            if r[4] != -1:       # a parent is a span of the same call
                assert r[4] in ids
                parent = ids[r[4]]
                assert parent[2] <= r[2] and r[3] <= parent[3]
        assert {r[1] for r in recs} >= {"fft_split", "ladder", "route"}


def test_an_exception_leaves_no_span_open(clean):
    xr, xi = _planes(64)
    since = _last_id()
    with obs.record_spans():
        with pytest.raises(InvalidValueError):
            tk.fft_split(xr, xi, norm="bogus")
        with pytest.raises(InvalidValueError):
            tk.fft_split(xr.to(torch.complex64), xi)
        sp = obs.begin("outer")
        obs.begin("left_open")
        obs.end(sp)                 # ends what was opened above it too
        tk.fft_split(xr, xi)
    assert obs._thread_state()[0] == []
    calls = _calls(since)
    assert len(calls) == 4
    last = calls[max(calls)]
    assert [r[1] for r in last if r[4] == -1] == ["fft_split"]
    assert obs.snapshot()["roots"]["count"] == 4


def test_the_ring_stays_bounded(clean, monkeypatch):
    monkeypatch.setattr(obs, "_ring", collections.deque(maxlen=16))
    with obs.record_spans():
        for i in range(100):
            obs.end(obs.begin(f"s{i}"))
    recs = obs.records()
    assert len(recs) == 16
    assert [r[1] for r in recs] == [f"s{i}" for i in range(84, 100)]
    assert obs.snapshot()["roots"]["count"] == 100   # totals keep all
    assert obs.RING_RECORDS == obs.collections.deque(
        maxlen=obs.RING_RECORDS).maxlen


def test_threads_keep_their_own_stacks(clean):
    """More threads than cores, a short switch interval: no span total is
    lost, and every span's parent is of its own thread and call."""
    threads, each = 16, 300
    since = _last_id()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait(timeout=30)
        for _ in range(each):
            a = obs.begin("outer")
            b = obs.begin("inner")
            obs.end(obs.begin("leaf"))
            obs.end(b)
            obs.end(a)

    try:
        with obs.record_spans():
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = obs.snapshot()
    for name in ("outer", "inner", "leaf"):
        assert snap["spans"][name]["count"] == threads * each
    assert snap["roots"]["count"] == threads * each
    calls = _calls(since)
    assert len(calls) == threads * each
    for recs in calls.values():
        assert sorted(r[1] for r in recs) == ["inner", "leaf", "outer"]
        assert len({r[6] for r in recs}) == 1
        ids = {r[0] for r in recs}
        assert all(r[4] in ids for r in recs if r[1] != "outer")


def test_table_builds_count_a_first_calls_misses_only(clean):
    tables.clear()
    xr, xi = _planes(1 << 14)
    tk.fft_split(xr, xi)
    first = obs.counts["table_builds"]
    assert first > 0
    HK.reset_counts()
    with obs.record_spans():
        tk.fft_split(xr, xi)
    snap = obs.snapshot()
    assert snap["counters"]["table_builds"] == 0
    assert "table" not in snap["spans"]
    tables.clear()
    with obs.record_spans():
        tk.fft_split(xr, xi)
    snap = obs.snapshot()
    assert snap["counters"]["table_builds"] == first
    assert snap["spans"]["table"]["count"] == first


def test_reset_counts_zeroes_the_registry_and_the_span_totals(clean):
    xr, xi = _planes(1 << 14)
    with obs.record_spans():
        tk.fft_split(xr, xi)
    HK.launches["stage1"] += 3
    G.launches["goertzel_scan"] += 2
    obs.counts["alloc_bytes"] += 5
    obs.counts["table_builds"] += 1
    snap = obs.snapshot()
    assert snap["counters"]["launches"]["stage1"] == 3
    assert snap["counters"]["classes"]["stages"] == 1
    assert snap["counters"]["goertzel_launches"]["goertzel_scan"] == 2
    assert snap["roots"]["count"] == 1
    HK.reset_counts()
    snap = obs.snapshot()
    assert not any(snap["counters"][g][k] for g in
                   ("launches", "classes", "goertzel_launches")
                   for k in snap["counters"][g])
    assert snap["counters"]["alloc_bytes"] == 0
    assert snap["counters"]["table_builds"] == 0
    assert snap["spans"] == {}
    assert snap["roots"] == {"count": 0, "incl_ns": 0, "self_ns": 0}
    # the groups are the modules' own dicts, read as before
    assert obs._GROUPS["launches"] is HK.launches
    assert obs._GROUPS["classes"] is HK.classes
    assert obs._GROUPS["goertzel_launches"] is G.launches


def test_snapshot_is_plain_data(clean):
    tk.fft(np.ones(64, np.float32), device="cpu")
    with obs.record_spans():
        tk.fft(np.ones(64, np.float32), device="cpu")
    snap = obs.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert set(snap) == {"spans", "roots", "counters"}
    assert set(snap["spans"]) == {"fft", "ladder", "tree"}


def test_trace_writes_the_spans_on_the_profilers_clock(tmp_path, clean):
    """The ``tree`` span of an ``fft`` call encloses that call's
    ``aten::matmul`` events in the exported file."""
    with tk.trace(tmp_path / "t"):
        assert obs.spans_on()
        tk.fft(np.ones(64, np.float32), device="cpu")
    assert not obs.spans_on()
    files = list((tmp_path / "t").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "kofft_tpu_torch"]
    assert sorted(e["name"] for e in ours) == ["fft", "ladder", "tree"]
    assert len({e["pid"] for e in ours}) == 1
    assert ours[0]["pid"] not in {e.get("pid") for e in events
                                  if e.get("cat") != "kofft_tpu_torch"
                                  and e.get("ph") == "X"}
    (tree,) = [e for e in ours if e["name"] == "tree"]
    matmuls = [e for e in events if e.get("name") == "aten::matmul"
               and e.get("ph") == "X"]
    assert matmuls
    for e in matmuls:
        assert tree["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= tree["ts"] + tree["dur"]
    (root,) = [e for e in ours if e["name"] == "fft"]
    assert root["args"]["parent"] == -1
    assert {e["args"]["call"] for e in ours} == {root["args"]["call"]}
