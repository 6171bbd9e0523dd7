"""kofft_tpu_torch.parallel against kofft_tpu.parallel.

The counterpart of tests/test_parallel.py: each of its tests has one
here, with the same name and ``_torch`` appended. The same seeded numpy
inputs go through kofft_tpu's program on its 8 virtual CPU devices
(conftest) and through the port's program on a world of 8 gloo ranks,
spawned once for the module (``parallel._spawn.World``, 120 s timeout per
task, so that a hang fails the test). The rank side lives in
tests/_torch_parallel_ranks.py, which imports no jax.

Tolerances: values >= 110 dB against kofft_tpu's same program (both
float32 evaluations of the same algorithm: the JAX programs run XLA's
FFT engines, the port's its plain engines); >= 95 dB against float64
numpy (the JAX tests' floor); an ISTFT's push region >= 90 dB against
float64; error types equal on the same bad inputs. The communication
audits (from the port's collective log) equal the JAX audits of the
same program (from its compiled HLO) as exact integers.
"""

import numpy as np
import pytest
import jax

import _torch_parallel_ranks as R
from kofft_tpu.ops import stft as S, window as W
from kofft_tpu.ops.dft import snr_db
import kofft_tpu.parallel as JP
from kofft_tpu_torch.parallel._spawn import World

PORT_DB = 110.0
SNR = 95.0
PUSH_DB = 90.0


@pytest.fixture(scope="module")
def world():
    w = World(8, timeout=120.0)
    yield w
    w.close()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return JP.make_mesh(8)


def jx(out):
    """A kofft_tpu plane pair (or one plane) as numpy."""
    if isinstance(out, tuple):
        return np.asarray(out[0]) + 1j * np.asarray(out[1])
    return np.asarray(out)


def planes(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def f64(xr, xi):
    return xr.astype(np.float64) + 1j * xi.astype(np.float64)


def stft_f64(x, w, hop):
    n, win = x.shape[0], w.shape[0]
    nf = -(-n // hop)
    xp = np.zeros((nf - 1) * hop + win)
    xp[:n] = x
    idx = np.arange(nf)[:, None] * hop + np.arange(win)[None, :]
    return np.fft.fft(xp[idx] * w.astype(np.float64), axis=-1)


def istft_push_f64(frames, w, hop):
    """The first F * hop samples of the float64 windowed overlap-add."""
    nf, win = frames.shape
    w = w.astype(np.float64)
    y = np.fft.ifft(np.asarray(frames, np.complex128), axis=-1).real * w
    acc = np.zeros((nf - 1) * hop + win)
    norm = np.zeros_like(acc)
    for f in range(nf):
        acc[f * hop:f * hop + win] += y[f]
        norm[f * hop:f * hop + win] += w * w
    out = np.where(norm > 1e-8, acc / np.where(norm > 1e-8, norm, 1.0), acc)
    return out[:nf * hop]


def both(world, jax_out, name, *args, spec="flat", **kw):
    """The port's ``name`` on the world, checked against kofft_tpu's
    output of the same program (>= 110 dB); returns the port's value."""
    got = world.run(R.call, name, *args, spec=spec, **kw)[0]
    want = jx(jax_out)
    assert got.shape == want.shape
    assert snr_db(want, got) >= PORT_DB
    return got


def test_should_shard_threshold_torch():
    from kofft_tpu.config import set_shard_threshold as jset
    from kofft_tpu.parallel import should_shard as jshould
    from kofft_tpu_torch.config import set_shard_threshold
    from kofft_tpu_torch.parallel import should_shard
    try:
        set_shard_threshold(1000)
        jset(1000)
        for pts, d in ((999 * 8, 8), (1000 * 8, 8), (10 ** 9, 1)):
            assert should_shard(pts, d) == jshould(pts, d)
        assert not should_shard(999 * 8, 8)
        assert should_shard(1000 * 8, 8)
        assert not should_shard(10 ** 9, 1)
    finally:
        set_shard_threshold(None)
        jset(None)


def test_fftn_sharded_2d_torch(rng, mesh, world):
    xr, xi = planes(rng, (32, 64))
    got = both(world, JP.fftn_sharded(xr, xi, mesh=mesh), "fftn_sharded",
               xr, xi)
    assert snr_db(np.fft.fft2(f64(xr, xi)), got) > SNR


def test_fftn_sharded_3d_torch(rng, mesh, world):
    xr, xi = planes(rng, (16, 8, 24))
    got = both(world, JP.fftn_sharded(xr, xi, mesh=mesh), "fftn_sharded",
               xr, xi)
    assert snr_db(np.fft.fftn(f64(xr, xi)), got) > SNR


def test_fftn_sharded_roundtrip_restore_layout_torch(rng, mesh, world):
    xr, xi = planes(rng, (16, 16))
    back = world.run(R.chain, [
        ("fftn_sharded", {"restore_layout": True}),
        ("ifftn_sharded", {"restore_layout": True})], xr, xi)[0]
    yr, yi = JP.fftn_sharded(xr, xi, mesh=mesh, restore_layout=True)
    jback = jx(JP.ifftn_sharded(yr, yi, mesh=mesh, restore_layout=True))
    assert snr_db(jback, back) >= PORT_DB
    assert snr_db(f64(xr, xi), back) > SNR


def test_fftn_sharded_bad_divisibility_torch(mesh, world):
    import kofft_tpu as kt
    x = np.zeros((10, 16), np.float32)
    with pytest.raises(kt.KofftError) as e:
        JP.fftn_sharded(x, x, mesh=mesh)
    assert world.run(R.error, "fftn_sharded", x, x)[0] == type(
        e.value).__name__ == "InvalidValueError"


def test_stft_sharded_matches_single_torch(rng, mesh, world):
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    got = both(world, JP.stft_sharded(x, w, hop, mesh=mesh),
               "stft_sharded", x, w, hop)
    assert got.shape == np.asarray(S.stft(x, w, hop)).shape
    assert snr_db(stft_f64(x, w, hop), got) > SNR


def test_istft_sharded_matches_single_torch(rng, mesh, world):
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x, w, hop))
    fr = np.ascontiguousarray(frames.real)
    fi = np.ascontiguousarray(frames.imag)
    nf = frames.shape[0]
    got = both(world, JP.istft_sharded(fr, fi, w, hop, mesh=mesh),
               "istft_sharded", fr, fi, w, hop)
    assert got.shape == (nf * hop,)
    assert snr_db(istft_push_f64(frames, w, hop), got) >= PUSH_DB


def test_stft_istft_sharded_roundtrip_torch(rng, mesh, world):
    n, win, hop = 8 * 128, 128, 32
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    out = world.run(R.chain, [("stft_sharded", {}),
                              ("istft_sharded", {}, (w, hop))], x, w,
                    hop)[0]
    fr, fi = JP.stft_sharded(x, w, hop, mesh=mesh)
    jout = jx(JP.istft_sharded(fr, fi, w, hop, mesh=mesh))
    assert snr_db(jout, out) >= PORT_DB
    assert snr_db(x[win:n - win], out[win:n - win]) > SNR


def _jax_auto(fn, threshold, *args, **kw):
    from kofft_tpu.config import set_shard_threshold
    try:
        set_shard_threshold(threshold)
        return jx(fn(*args, **kw))
    finally:
        set_shard_threshold(None)


def test_fftn_auto_routes_torch(rng, mesh, world):
    xr, xi = planes(rng, (16, 16))
    ref = np.fft.fft2(f64(xr, xi))
    for thr, sharded in ((1, True), (10 ** 9, False)):
        is_dt, got = world.run(R.auto, "fftn_auto", xr, xi,
                               threshold=thr)[0]
        assert is_dt is sharded
        assert snr_db(_jax_auto(JP.fftn_auto, thr, xr, xi), got) >= PORT_DB
        assert snr_db(ref, got) > SNR


def test_stft_auto_routes_torch(rng, mesh, world):
    n, win, hop = 8 * 128, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    is_dt, got = world.run(R.auto, "stft_auto", x, w, hop, threshold=1)[0]
    assert is_dt
    assert snr_db(_jax_auto(JP.stft_auto, 1, x, w, hop), got) >= PORT_DB
    assert snr_db(stft_f64(x, w, hop), got) > SNR


def test_fft_sharded_natural_order_torch(rng, world):
    mesh = JP.make_mesh()
    n = 1 << 12
    xr, xi = planes(rng, n)
    got = both(world, JP.fft_sharded(xr, xi, mesh=mesh, restore_layout=True),
               "fft_sharded", xr, xi, restore_layout=True)
    assert snr_db(np.fft.fft(f64(xr, xi)), got) > 100.0


def test_fft_sharded_digit_layout_torch(rng, world):
    from kofft_tpu_torch.parallel.fft_sharded import _split_for_mesh
    from kofft_tpu.parallel.fft_sharded import _split_for_mesh as jsplit
    mesh = JP.make_mesh()
    n = 1 << 12
    n1, n2 = _split_for_mesh(n, 8)
    assert (n1, n2) == jsplit(n, 8)
    xr, xi = planes(rng, n)
    got = both(world, JP.fft_sharded(xr, xi, mesh=mesh), "fft_sharded",
               xr, xi)
    # undo the digit transpose: got[k1, k2] == X[k1 + n1*k2]
    unscrambled = got.reshape(n1, n2).T.reshape(n)
    assert snr_db(np.fft.fft(f64(xr, xi)), unscrambled) > 100.0


def test_fft_sharded_roundtrip_torch(rng, world):
    mesh = JP.make_mesh()
    n = 1 << 12
    xr, xi = planes(rng, n)
    back = world.run(R.chain, [
        ("fft_sharded", {"restore_layout": True}),
        ("ifft_sharded", {"restore_layout": True})], xr, xi)[0]
    yr, yi = JP.fft_sharded(xr, xi, mesh=mesh, restore_layout=True)
    jback = jx(JP.ifft_sharded(np.asarray(yr), np.asarray(yi), mesh=mesh,
                               restore_layout=True))
    assert snr_db(jback, back) >= PORT_DB
    assert np.abs(back - f64(xr, xi)).max() < 1e-4


def test_fft_sharded_matches_single_chip_torch(rng, world):
    import kofft_tpu_torch as kp
    mesh = JP.make_mesh()
    n = 3 * (1 << 10)    # non-pow2 smooth n: 3072 = 2^10 * 3
    xr, xi = planes(rng, n)
    got = both(world, JP.fft_sharded(xr, xi, mesh=mesh, restore_layout=True),
               "fft_sharded", xr, xi, restore_layout=True)
    single = kp.asnumpy(kp.fft(xr + 1j * xi, device="cpu"))
    assert snr_db(single, got) >= PORT_DB
    assert snr_db(np.fft.fft(f64(xr, xi)), got) > SNR


def test_fft_auto_routes_torch(rng, mesh, world):
    n = 1 << 12
    xr, xi = planes(rng, n)
    ref = np.fft.fft(f64(xr, xi))
    for thr, sharded in ((1, True), (10 ** 9, False)):
        is_dt, got = world.run(R.auto, "fft_auto", xr, xi, threshold=thr)[0]
        assert is_dt is sharded, "expected sharded output" if sharded \
            else "expected local output"
        assert snr_db(_jax_auto(JP.fft_auto, thr, xr, xi), got) >= PORT_DB
        assert snr_db(ref, got) > SNR


def test_istft_auto_routes_torch(rng, mesh, world):
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x, w, hop))
    nf = frames.shape[0]
    fr = np.ascontiguousarray(frames.real)
    fi = np.ascontiguousarray(frames.imag)
    ref = istft_push_f64(frames, w, hop)
    for thr, sharded in ((1, True), (10 ** 9, False)):
        is_dt, got = world.run(R.auto, "istft_auto", fr, fi, w, hop,
                               threshold=thr)[0]
        assert is_dt is sharded
        assert got.shape == (nf * hop,)
        assert snr_db(_jax_auto(JP.istft_auto, thr, fr, fi, w, hop),
                      got) >= PORT_DB
        assert snr_db(ref, got) >= PUSH_DB


def test_calibrate_shard_threshold_torch(mesh, world):
    """The probe runs on the live world, returns a positive threshold in
    points per rank, the same on every rank, and mutates the config only
    with apply=True."""
    res = world.run(R.calibrate, probe_points=1 << 12, apply=False)
    assert len(set(res)) == 1
    before, out, after = res[0]
    assert isinstance(out, int) and out > 0 and after == before
    res = world.run(R.calibrate, probe_points=1 << 12, apply=True)
    assert len(set(res)) == 1
    before, out2, after = res[0]
    assert after in (before, out2)


def test_fft_sharded_comm_volume_invariant_torch(mesh, world):
    """The log of the distributed FFT holds exactly the canonical
    all_to_all volume (2, or 3 with restore, x both planes x n/D local
    bytes), equal to kofft_tpu's HLO audit of the same program."""
    from kofft_tpu.parallel.validate import check_fft_sharded_comm_volume \
        as jcheck
    from kofft_tpu_torch.parallel.validate import \
        fft_sharded_expected_a2a_bytes
    for restore, want in ((True, 3 * 2 * (1 << 9) * 4),
                          (False, 2 * 2 * (1 << 9) * 4)):
        reps = world.run(R.comm_volume, 1 << 12, restore)
        assert all(r == reps[0] for r in reps)
        assert reps[0] == jcheck(1 << 12, mesh, restore_layout=restore)
        assert reps[0]["local_a2a_bytes"] == want == \
            fft_sharded_expected_a2a_bytes(1 << 12, 8, restore)


def test_hlo_a2a_bytes_counts_async_pairs_once_torch(world):
    """The log counts an all_to_all issued async once, at its issue, with
    its local bytes (16 x 16 float32 = 1024 B; the JAX audit counts the
    async start/done pair once at the done op); a re/im pair counts two
    collectives, both issued before the first wait."""
    one, pair = world.run(R.async_a2a_once)[0]
    assert one["a2a_bytes"] == 16 * 16 * 4 and one["total"] == 1
    assert one["independent_sources"] == 1
    assert pair["a2a_bytes"] == 2 * 16 * 16 * 4 and pair["total"] == 2
    assert pair["independent_sources"] == 2
    assert pair["in_flight"] == [1, 2]


def test_calibrate_shard_threshold_bounded_upward_scan_torch(mesh, world):
    res = world.run(R.calibrate, probe_points=1 << 12, apply=False,
                    max_points=1 << 12)
    assert len(set(res)) == 1
    before, out, after = res[0]
    assert isinstance(out, int) and out > 0 and after == before


def test_fft_sharded_overlap_parity_torch(mesh, rng, world):
    n = 1 << 13
    xr, xi = planes(rng, n)
    ref = np.fft.fft(f64(xr, xi))
    seq = both(world, JP.fft_sharded(xr, xi, mesh=mesh, restore_layout=True),
               "fft_sharded", xr, xi, restore_layout=True)
    for k in (2, 4):
        got = both(world, JP.fft_sharded(xr, xi, mesh=mesh,
                                         restore_layout=True, overlap=k),
                   "fft_sharded", xr, xi, restore_layout=True, overlap=k)
        assert snr_db(ref, got) > SNR
        assert snr_db(seq, got) > SNR
    back = both(world, JP.ifft_sharded(seq.real.astype(np.float32),
                                       seq.imag.astype(np.float32),
                                       mesh=mesh, restore_layout=True,
                                       overlap=4),
                "ifft_sharded", seq.real.astype(np.float32),
                seq.imag.astype(np.float32), restore_layout=True, overlap=4)
    assert snr_db(f64(xr, xi), back) > SNR - 5


def test_fftn_sharded_overlap_parity_torch(mesh, rng, world):
    for shape in ((32, 64), (16, 8, 32)):
        xr, xi = planes(rng, shape)
        got = both(world, JP.fftn_sharded(xr, xi, mesh=mesh,
                                          restore_layout=True, overlap=2),
                   "fftn_sharded", xr, xi, restore_layout=True, overlap=2)
        assert got.shape == shape
        assert snr_db(np.fft.fftn(f64(xr, xi)), got) > SNR


def test_overlap_comm_volume_and_independence_torch(mesh, world):
    """The overlap programs move the sequential program's bytes, in 6K
    all_to_alls of which 2K are issued before the first wait, exactly as
    kofft_tpu's HLO audit counts them (6 and 2 sequential)."""
    from kofft_tpu.parallel.validate import check_fft_sharded_comm_volume \
        as jcheck
    n = 1 << 13
    rep1 = world.run(R.comm_volume, n, True, 1)[0]
    assert rep1["total"] == 6 and rep1["independent_sources"] == 2
    assert rep1 == jcheck(n, mesh, restore_layout=True, overlap=1)
    for k in (2, 4):
        rep = world.run(R.comm_volume, n, True, k)[0]
        assert rep == jcheck(n, mesh, restore_layout=True, overlap=k)
        assert rep["local_a2a_bytes"] == rep1["local_a2a_bytes"]
        assert rep["total"] == 6 * k
        assert rep["independent_sources"] == 2 * k


def test_fftn_overlap_independence_torch(mesh, world):
    from kofft_tpu.config import trace_key
    from kofft_tpu.parallel.ndfft_sharded import _build, _mesh_key
    from kofft_tpu.parallel.validate import hlo_a2a_independent_sources
    fn, sh = _build(_mesh_key(mesh, "d"), 2, False, "xla", True,
                    trace_key(), 4)
    x = jax.device_put(np.zeros((32, 64), np.float32), sh)
    want = hlo_a2a_independent_sources(fn.lower(x, x).compile().as_text())
    assert want == {"total": 16, "independent_sources": 8}
    z = np.zeros((32, 64), np.float32)
    got = world.run(R.logged, "fftn_sharded", z, z, restore_layout=True,
                    overlap=4)
    for rep in got:
        assert rep["total"] == want["total"]
        assert rep["independent_sources"] == want["independent_sources"]
        assert max(rep["in_flight"]) == 8


def test_overlap_validation_errors_torch(mesh, world):
    x = np.zeros(1 << 12, np.float32)
    x2 = np.zeros((16, 16), np.float32)
    cases = [("fft_sharded", (x, x), {"overlap": 2}),
             ("fft_sharded", (x, x), {"restore_layout": True,
                                      "overlap": 64}),
             ("fftn_sharded", (x2, x2), {"restore_layout": True,
                                         "overlap": 4})]
    for name, args, kw in cases:
        with pytest.raises(Exception) as e:
            getattr(JP, name)(*args, mesh=mesh, **kw)
        assert type(e.value).__name__ == "InvalidValueError"
        assert world.run(R.error, name, *args, **kw)[0] == \
            "InvalidValueError"


def test_fft_auto_uses_overlap_when_divisible_torch(mesh, rng, world):
    from kofft_tpu.config import set_overlap_chunks
    n = 1 << 13
    xr, xi = planes(rng, n)
    ref = np.fft.fft(f64(xr, xi))
    for k in (1, 4):
        is_dt, got = world.run(R.auto, "fft_auto", xr, xi, threshold=1,
                               overlap=k)[0]
        assert is_dt
        try:
            set_overlap_chunks(k)
            want = _jax_auto(JP.fft_auto, 1, xr, xi)
        finally:
            set_overlap_chunks(None)
        assert snr_db(want, got) >= PORT_DB
        assert snr_db(ref, got) > SNR


def test_fft_sharded_hier_parity_torch(rng, world):
    n = 1 << 13
    xr, xi = planes(rng, n)
    ref = np.fft.fft(f64(xr, xi))
    for s, c in ((2, 4), (4, 2)):
        got = both(world, JP.fft_sharded_hier(
            xr, xi, mesh=JP.make_hier_mesh(s, c)), "fft_sharded_hier",
            xr, xi, spec=(s, c))
        assert snr_db(ref, got) > SNR
    h = JP.make_hier_mesh(2, 4)
    jback = jx(JP.ifft_sharded_hier(*JP.fft_sharded_hier(xr, xi, mesh=h),
                                    mesh=h))
    back = world.run(R.chain, [("fft_sharded_hier", {}),
                               ("ifft_sharded_hier", {})], xr, xi,
                     spec=(2, 4))[0]
    assert snr_db(jback, back) >= PORT_DB
    assert snr_db(f64(xr, xi), back) > SNR - 5


def test_fftn_sharded_hier_parity_torch(mesh, rng, world):
    h = JP.make_hier_mesh(2, 4)
    for shape in ((16, 4, 32), (32, 64)):
        xr, xi = planes(rng, shape)
        flat = jx(JP.fftn_sharded(xr, xi, mesh=mesh, restore_layout=True))
        for restore in (False, True):
            got = both(world, JP.fftn_sharded_hier(
                xr, xi, mesh=h, restore_layout=restore),
                "fftn_sharded_hier", xr, xi, spec=(2, 4),
                restore_layout=restore)
            assert got.shape == shape
            assert snr_db(flat, got) >= PORT_DB


def _jax_hier_hlo(n, n1, k):
    from kofft_tpu.config import trace_key
    from kofft_tpu.parallel.hier import _build_fft_hier, _mesh2_key
    fn, sh = _build_fft_hier(_mesh2_key(JP.make_hier_mesh(2, 4)), n, n1,
                             n // n1, "xla", trace_key(), "float32", k)
    x = jax.device_put(np.zeros(n, np.float32), sh)
    return fn.lower(x, x).compile().as_text()


def test_hier_per_axis_comm_volume_torch(rng, world):
    """On a (2, 4) mesh the log holds equal local bytes in groups of 4
    (the chip legs, ICI) and of 2 (the slice legs, DCN): 3 re-pencils x
    2 planes x n/d, as kofft_tpu's HLO audit by group size."""
    from kofft_tpu.parallel.validate import hlo_a2a_bytes_by_group_size
    n = 1 << 12
    want = hlo_a2a_bytes_by_group_size(_jax_hier_hlo(n, 64, 1))
    leg = 3 * 2 * (n // 8) * 4
    assert want == {4: leg, 2: leg}
    z = np.zeros(n, np.float32)
    for rep in world.run(R.logged, "fft_sharded_hier", z, z, spec=(2, 4),
                         n1=64):
        assert rep["by_group"] == want


def test_fft_sharded_hier_overlap_parity_torch(rng, world):
    n = 1 << 13
    xr, xi = planes(rng, n)
    ref = np.fft.fft(f64(xr, xi))
    for s, c in ((2, 4), (4, 2)):
        h = JP.make_hier_mesh(s, c)
        for k in (2, 4):
            got = both(world, JP.fft_sharded_hier(xr, xi, mesh=h,
                                                  overlap=k),
                       "fft_sharded_hier", xr, xi, spec=(s, c), overlap=k)
            assert snr_db(ref, got) > SNR
    back = world.run(R.chain, [("fft_sharded_hier", {"overlap": 2}),
                               ("ifft_sharded_hier", {"overlap": 2})],
                     xr, xi, spec=(2, 4))[0]
    assert snr_db(f64(xr, xi), back) > SNR - 5


def test_hier_overlap_audits_torch(rng, world):
    """The hierarchical overlap program keeps both audits: bytes per
    group size unchanged from the sequential hierarchy, 2K all_to_alls
    issued before the first wait, 12K in all, as kofft_tpu's HLO."""
    from kofft_tpu.parallel.validate import (hlo_a2a_bytes_by_group_size,
                                             hlo_a2a_independent_sources)
    n = 1 << 14
    z = np.zeros(n, np.float32)
    base = None
    for k in (1, 2):
        txt = _jax_hier_hlo(n, 128, k)
        per = hlo_a2a_bytes_by_group_size(txt)
        dep = hlo_a2a_independent_sources(txt)
        for rep in world.run(R.logged, "fft_sharded_hier", z, z,
                             spec=(2, 4), n1=128, overlap=k):
            assert rep["by_group"] == per
            assert rep["independent_sources"] == dep["independent_sources"]
            assert rep["total"] == dep["total"]
        if base is None:
            base = per
            assert dep["independent_sources"] == 2
        else:
            assert per == base
            assert dep["total"] == 24 and dep["independent_sources"] == 4


def test_fftn_sharded_hier_overlap_parity_torch(rng, world):
    h = JP.make_hier_mesh(2, 4)
    for shape in ((16, 4, 32), (32, 64)):
        ar, ai = planes(rng, shape)
        got = both(world, JP.fftn_sharded_hier(ar, ai, mesh=h,
                                               restore_layout=True,
                                               overlap=2),
                   "fftn_sharded_hier", ar, ai, spec=(2, 4),
                   restore_layout=True, overlap=2)
        assert got.shape == shape
        assert snr_db(np.fft.fftn(f64(ar, ai)), got) > SNR
    x2 = np.zeros((16, 16), np.float32)
    with pytest.raises(Exception) as e:
        JP.fftn_sharded_hier(x2, x2, mesh=h, overlap=2)
    assert world.run(R.error, "fftn_sharded_hier", x2, x2, spec=(2, 4),
                     overlap=2)[0] == type(e.value).__name__ == \
        "InvalidValueError"


def test_calibrate_scan_down_with_forced_win_torch(mesh, world):
    """With fft_sharded an instant winner the scan goes down to the
    smallest probed size, and apply=True stores points per rank on every
    rank."""
    res = world.run(R.calibrate_patched, "win", probe_points=1 << 13,
                    apply=True)
    assert len(set(res)) == 1
    _, out, after = res[0]
    assert isinstance(out, int) and out > 0
    assert out <= (1 << 13) // 8
    assert after == out


def test_calibrate_single_device_returns_current_torch(monkeypatch):
    from kofft_tpu_torch.config import get_config
    from kofft_tpu_torch.parallel import auto as A
    monkeypatch.setattr(A, "_usable_devices", lambda: 1)
    cur = get_config().shard_threshold
    assert A.calibrate_shard_threshold(probe_points=1 << 12) == cur


def test_calibrate_unprobeable_size_keeps_current_torch(mesh, world):
    res = world.run(R.calibrate_patched, "unprobeable",
                    probe_points=1 << 12)
    before, out, after = res[0]
    assert out == before == after


def test_stft_auto_falls_through_on_small_or_indivisible_torch(rng, mesh,
                                                                world):
    """40 % (8 * 4) != 0: the single-card route whatever the threshold."""
    import kofft_tpu as kt
    x = rng.standard_normal(40).astype(np.float32)
    w = np.asarray(W.hann(8))
    for thr in (None, 1):
        is_dt, got = world.run(R.auto, "stft_auto", x, w, 4,
                               threshold=thr)[0]
        assert not is_dt
        want = jx(kt.stft_split(x, w, hop=4))
        np.testing.assert_allclose(got.real, want.real, atol=1e-6)
        np.testing.assert_allclose(got.imag, want.imag, atol=1e-6)


def test_fft_auto_overlap_chunk_fallback_torch(rng, mesh, world):
    """overlap_chunks 64 halves until it divides both factors."""
    n = 1 << 14
    xr, xi = planes(rng, n)
    is_dt, got = world.run(R.auto, "fft_auto", xr, xi, threshold=1,
                           overlap=64)[0]
    assert is_dt
    assert snr_db(np.fft.fft(f64(xr, xi)), got) > SNR


def test_fftn_auto_wires_overlap_torch(rng, mesh, world):
    """fftn_auto passes the divisibility-degraded overlap chunking and
    restore_layout=True to fftn_sharded."""
    xr, xi = planes(rng, (16, 16))
    seen, got = world.run(R.spy_fftn_auto, xr, xi, 64)[0]
    assert snr_db(np.fft.fft2(f64(xr, xi)), got) > SNR
    k = seen.get("overlap")
    assert k is not None and k >= 1 and 16 % (8 * k) == 0
    assert seen.get("restore_layout") is True


def test_fft_sharded_hier_rejects_nondividing_n1_torch(world):
    """n1 = 16 does not divide 1092: the typed error, on every rank, of
    the (2, 2) mesh and of the ranks outside it."""
    x = np.zeros(1092, np.float32)
    with pytest.raises(Exception) as e:
        JP.fft_sharded_hier(x, x, mesh=JP.make_hier_mesh(2, 2), n1=16)
    got = world.run(R.error, "fft_sharded_hier", x, x, spec=(2, 2), n1=16)
    assert set(got) == {type(e.value).__name__} == {"InvalidValueError"}


def test_calibrate_scan_up_reaches_max_points_torch(mesh, world):
    """On a simulated clock on which sharding wins from 2^17, five octaves
    above the probe, the upward scan reaches it and applies it."""
    res = world.run(R.calibrate_patched, "up", probe_points=1 << 12,
                    apply=True, max_points=1 << 18)
    assert len(set(res)) == 1
    _, out, after = res[0]
    assert out == (1 << 17) // 8 == after


def test_stft_sharded_hier_matches_single_torch(rng, world):
    h = JP.make_hier_mesh(2, 4)
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    got = both(world, JP.stft_sharded_hier(x, w, hop, mesh=h),
               "stft_sharded_hier", x, w, hop, spec=(2, 4))
    assert got.shape == np.asarray(S.stft(x, w, hop)).shape
    assert snr_db(stft_f64(x, w, hop), got) > SNR


def test_istft_sharded_hier_matches_single_torch(rng, world):
    h = JP.make_hier_mesh(2, 4)
    n, win, hop = 8 * 64, 64, 16
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    frames = np.asarray(S.stft(x, w, hop))
    nf = frames.shape[0]
    fr = np.ascontiguousarray(frames.real)
    fi = np.ascontiguousarray(frames.imag)
    got = both(world, JP.istft_sharded_hier(fr, fi, w, hop, mesh=h),
               "istft_sharded_hier", fr, fi, w, hop, spec=(2, 4))
    assert got.shape == (nf * hop,)
    assert snr_db(istft_push_f64(frames, w, hop), got) >= PUSH_DB


def test_stft_istft_hier_roundtrip_torch(rng, world):
    h = JP.make_hier_mesh(4, 2)          # the other factorization too
    n, win, hop = 8 * 128, 128, 32
    x = rng.standard_normal(n).astype(np.float32)
    w = W.hann(win)
    out = world.run(R.chain, [("stft_sharded_hier", {}),
                              ("istft_sharded_hier", {}, (w, hop))], x, w,
                    hop, spec=(4, 2))[0]
    fr, fi = JP.stft_sharded_hier(x, w, hop, mesh=h)
    jout = jx(JP.istft_sharded_hier(fr, fi, w, hop, mesh=h))
    assert snr_db(jout, out) >= PORT_DB
    assert snr_db(x[win:n - win], out[win:n - win]) > SNR


def test_stft_hier_halo_bytes_by_tier_torch(rng, world):
    """The halo sends of every rank, by tier: s (c-1) in-slice pairs
    (ICI) and s-1 slice-boundary pairs (DCN) of win - hop float32
    samples, as kofft_tpu's HLO audit of its ppermutes."""
    from kofft_tpu.config import trace_key
    from kofft_tpu.ops.stft import _window_key, _window_const
    from kofft_tpu.parallel.hier import _mesh2_key
    from kofft_tpu.parallel.stft_sharded import _build_stft_hier
    from kofft_tpu.parallel.validate import hlo_ppermute_bytes_by_tier
    from kofft_tpu_torch.parallel.validate import send_bytes_by_tier
    s, c = 2, 4
    win, hop = 64, 16
    halo_b = (win - hop) * 4
    w = _window_const(W.hann(win))
    n_local = 8 * hop
    fn, sh = _build_stft_hier(_mesh2_key(JP.make_hier_mesh(s, c)), n_local,
                              win, hop, _window_key(w), "xla", trace_key())
    x = jax.device_put(np.zeros(8 * n_local, np.float32), sh)
    want = hlo_ppermute_bytes_by_tier(fn.lower(x).compile().as_text(),
                                      chips_per_slice=c)
    assert want == {"ici": s * (c - 1) * halo_b, "dcn": (s - 1) * halo_b}
    reps = world.run(R.logged, "stft_sharded_hier",
                     np.zeros(8 * n_local, np.float32), w, hop, spec=(s, c))
    assert send_bytes_by_tier([r["log"] for r in reps]) == want


# --------------------------------------------------------------------------
# beyond the JAX tests: the port's own contract
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,n1,n2,d,k", [(1 << 12, 64, 64, 8, 1),
                                          (1 << 13, 64, 128, 8, 4),
                                          (3072, 48, 64, 8, 2)])
def test_twiddle_tables_bit_equal_torch(n, n1, n2, d, k):
    """The sharded programs' twiddle tables (host float64, exact integer
    phase mod n, built in row blocks on threads) equal kofft_tpu's bit
    for bit, flat and (2, 4) / (4, 2) hierarchical."""
    from kofft_tpu.parallel.fft_sharded import _twiddle_consts as jflat
    from kofft_tpu.parallel.hier import _hier_twiddles as jhier
    from kofft_tpu_torch.parallel.fft_sharded import _twiddle_consts
    from kofft_tpu_torch.parallel.hier import _hier_twiddles
    for got, want in zip(_twiddle_consts(n, n1, n2, d, "float32", k),
                         jflat(n, n1, n2, d, "float32", k)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for s, c in ((2, 4), (4, 2)):
        for got, want in zip(_hier_twiddles(n, n1, n2, s, c, "float32", k),
                             jhier(n, n1, n2, s, c, "float32", k)):
            assert np.array_equal(got, want)


def test_ranks_import_no_jax_torch(world):
    """The rank side (the port, _spawn and the test helpers) never
    imports jax or kofft_tpu, after every program above ran on it."""
    assert world.run(R.jax_modules) == [[]] * 8


def test_cuda_mesh_never_falls_back_torch(world):
    """A CUDA mesh without a card raises; on a gloo world (a card faked
    present) it raises for want of NCCL: never gloo or the CPU."""
    from kofft_tpu_torch.parallel import make_mesh, make_hier_mesh
    with pytest.raises(RuntimeError):
        make_mesh(device="cuda")
    with pytest.raises(RuntimeError):
        make_hier_mesh(1, 1)
    kind, msg = world.run(R.cuda_mesh_on_gloo)[0]
    assert kind == "RuntimeError" and "nccl" in msg


def test_config_shard_setters_as_kofft_tpu_torch(monkeypatch):
    """set_shard_threshold / set_overlap_chunks: a value, None/0 revert to
    the env default, k < 1 refused; the env vars give the defaults."""
    from kofft_tpu import config as JC
    from kofft_tpu_torch import config as TC
    for mod in (JC, TC):
        mod.set_shard_threshold(123)
        assert mod.get_config().shard_threshold == 123
        mod.set_shard_threshold(0)
        assert mod.get_config().shard_threshold == 1 << 16
        mod.set_overlap_chunks(2)
        assert mod.get_config().overlap_chunks == 2
        mod.set_overlap_chunks(None)
        assert mod.get_config().overlap_chunks == 4
        with pytest.raises(ValueError):
            mod.set_overlap_chunks(-1)
    monkeypatch.setenv("KOFFT_TPU_TORCH_SHARD_THRESHOLD", "77")
    monkeypatch.setenv("KOFFT_TPU_TORCH_OVERLAP_CHUNKS", "8")
    monkeypatch.setenv("KOFFT_TPU_SHARD_THRESHOLD", "77")
    monkeypatch.setenv("KOFFT_TPU_OVERLAP_CHUNKS", "8")
    for mod in (JC, TC):
        cfg = mod._Config()
        assert (cfg.shard_threshold, cfg.overlap_chunks) == (77, 8)


def test_port_covers_every_public_name_torch():
    """No public name of kofft_tpu or kofft_tpu.parallel is missing from
    the port."""
    import kofft_tpu
    import kofft_tpu_torch
    import kofft_tpu_torch.parallel as TP

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")}

    assert public(kofft_tpu) - public(kofft_tpu_torch) == set()
    assert public(JP) - public(TP) == set()


def test_dryrun_multichip_torch():
    """dryrun_multichip(4) passes on 4 gloo ranks, and its dp x tp step
    equals the port's single-process train_step and kofft_tpu's
    jax.value_and_grad step on the same batch: loss within 1e-5
    relative, the updated parameters >= 80 dB."""
    import torch
    from kofft_tpu.models import SpectralNet as JNet
    from kofft_tpu.models.spectral_net import loss_fn as jloss
    from kofft_tpu_torch.entry import dryrun_multichip
    from kofft_tpu_torch.models.spectral_net import SpectralNet, train_step
    out = dryrun_multichip(4)
    assert (out["dp"], out["tp"]) == (2, 2)
    rng = np.random.default_rng(1)
    signal = rng.standard_normal((4, 256)).astype(np.float32)
    labels = rng.integers(0, 8, size=(4,)).astype(np.int32)
    model = SpectralNet(win_len=64, hop=32, n_mel=8, n_classes=8,
                        device="cpu")
    new, loss = train_step(model, model.init(seed=0),
                           torch.as_tensor(signal), labels, lr=1e-2)
    jm = JNet(win_len=64, hop=32, n_mel=8, n_classes=8)
    jp = jm.init(seed=0)
    jl, jg = jax.value_and_grad(lambda q: jloss(jm, q, signal, labels))(jp)
    jnew = jax.tree_util.tree_map(lambda a, g: a - 1e-2 * g, jp, jg)
    for ref in (float(loss), float(jl)):
        assert abs(out["loss"] - ref) <= 1e-5 * abs(ref)
    for k, field in enumerate(("mel", "w_head", "b_head")):
        for ref in (new[k].numpy(), np.asarray(jnew[k])):
            assert snr_db(ref, out[field]) >= 80.0, field
