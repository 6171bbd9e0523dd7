#!/usr/bin/env python3
"""Drive kofft_tpu_torch's main paths, the 1-D complex and real FFT and the
N-D FFT, on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN so the plain
   versions run in full float32;
2. build: nvcc builds every kernel source of the package (timed), and
   the ptxas register / shared-memory lines are printed;
3. kernels vs plain: stage1 and stage2 against their plain PyTorch
   versions on the same CUDA tensors, and the pair against a float64
   numpy FFT, at (8, 2^14), 2^20, 3*2^18, (8, 2^20), 2^24 and 2^26; then
   stage1_real and stage2_half the same way, the pair against the float64
   numpy rfft, at (4, 2^14), 2^20, 3*2^18, (8, 2^20), 2^24 and 2^26;
   then col_fft and row_fft the same way, the pair against the float64
   numpy fft2, at (1, 1024, 1024), (8, 512, 512), (1, 4096, 4096) and
   (1, 8192, 8192), the three axis passes of a 128^3 grid against its
   fftn, and the fused_nd route (d launches) against fused_nd_plain at
   128^3 and (512, 256); every SNR must exceed 100 dB;
4. main paths: the public entries (complex, then real, then N-D) with
   every count set to 0 just before each path; each case checks its
   output against a float64 oracle and that its TPU-kernel class count
   rose; the kernel launch counts are read just after each path; one
   real case passes numpy input with no device, which must land on the
   card; the N-D path runs all three N-D classes (fft2, fft2_big,
   fused_nd), the cuFFT zone and the per-axis route;
5. gradient: backward through fft_split and through rfft_split at 2^20,
   through fft2 at 1024^2 and through fftn_split at 128^3, against the
   analytic gradient (the unnormalized inverse of the cotangent,
   zero-padded to n for the real transform);
6. timing: CUDA events after warm-up, of the kernel path, the plain
   version and torch.fft (cuFFT) at 2^20, 8 x 2^20, 2^24 and 2^26 for the
   complex and the real FFT, and of each stage kernel and its plain
   version at (1, 1024, 1024). Three numbers each: the median of 20
   single calls, each between its own pair of events (this includes the
   host's enqueue time whenever the device would otherwise wait); the
   device time per call over 20 back-to-back calls between one pair of
   events (the host runs ahead; the kernels' JSON record carries this
   one); and the host's time per call to enqueue those 20 calls. The two
   kernel paths, fft_split and rfft_split, are timed in turns (fft, rfft,
   rfft, fft, three times) and reported as medians. Each transform row
   has its bound (``transform_bound``). Then the N-D rows: the kernel
   route (fftn_split), its plain version and torch.fft.fft2 / fftn at
   1024^2, (8, 512, 512), 4096^2, 8192^2 and 128^3 with their bound
   (``nd_bound``); col_fft and row_fft alone at (1, 1024, 1024), each
   beside torch.fft.fft along its axis; and the three axis passes of a
   128^3 grid alone (kernel, plain version, torch.fft.fft, bound).

A bound is the least time the card could take for the work: the larger
of the bytes the function must move (each input read once, each output
written once) over 3.35 TB/s, and 5 m log2 m float32 operations per
complex line of length m (half for real input or one-sided output) over
67 TFLOP/s; an N-D transform does that along each of its axes. The line
before the last is the kernels' JSON record
(launches on the main paths, max abs error against the plain version,
back-to-back ms of kernel and plain version at (1, 1024, 1024), the
bound there, and for col_fft and row_fft the back-to-back ms of
torch.fft.fft along the same axis, null for the four-step stages); the
last line is {"ok": true, "device": {...}}. Without a
CUDA device the script exits non-zero before it prints any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

FLOOR_DB = 100.0
SEED = 20261016
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FMA-pipe flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12


def log(*a):
    print(*a, flush=True)


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.complex128)
    got = np.asarray(got, np.complex128)
    den = np.sum(np.abs(ref - got) ** 2)
    return float("inf") if den == 0 else float(
        10 * np.log10(np.sum(np.abs(ref) ** 2) / den))


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card can take to
    move ``nbytes`` through device memory or to do ``flops`` float32
    operations, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_flops(points: int, m: int, real: bool) -> float:
    """Operations of FFTs of length m over ``points`` points: 5 m log2 m
    per complex line, half that for real input or one-sided output."""
    return (2.5 if real else 5.0) * points * math.log2(m)


def stage_bound(name: str, b: int, n1: int, n2: int):
    """bound_ms of what one launch of stage kernel ``name`` on (b, n1, n2)
    must do: its data planes read once and written once, and the FFT
    operations of its lines. The twiddle products and the dense leaves'
    extra MACs are left out: they are this algorithm's, not the
    function's."""
    pts = b * n1 * n2
    nbytes = {"stage1": 16 * pts, "stage2": 16 * pts,
              "stage1_real": 12 * pts,
              "stage2_half": 8 * pts + 8 * b * (pts // b // 2 + 1),
              "col_fft": 16 * pts, "row_fft": 16 * pts}[name]
    m = n1 if name.startswith("stage1") or name == "col_fft" else n2
    return bound_ms(nbytes, fft_flops(
        pts, m, name in ("stage1_real", "stage2_half")))


def transform_bound(real: bool, b: int, n: int):
    """bound_ms of b transforms of length n: input read once, output
    written once, 5 n log2 n operations per line (half for the rfft)."""
    nbytes = b * (4 * n + 8 * (n // 2 + 1)) if real else 16 * b * n
    return bound_ms(nbytes, fft_flops(b * n, n, real))


def nd_bound(shape, axes=None):
    """bound_ms of a complex N-D transform of ``shape`` over ``axes``
    (default all): the planes read once and written once, and 5 m log2 m
    operations per line along each transformed axis."""
    pts = math.prod(shape)
    axes = range(len(shape)) if axes is None else axes
    return bound_ms(16 * pts, sum(fft_flops(pts, shape[a], False)
                                  for a in axes))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this "
                         "script runs only on a card")
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.ops import _cuda_build as B
    from kofft_tpu_torch.ops import hopper_kernels as HK

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def planes(shape):
        a = rng.standard_normal((2,) + tuple(shape), dtype=np.float32)
        return (torch.as_tensor(a[0], device=dev),
                torch.as_tensor(a[1], device=dev))

    def real(shape):
        return torch.as_tensor(
            rng.standard_normal(tuple(shape), dtype=np.float32), device=dev)

    def host(r, i):
        return (r.detach().double().cpu().numpy()
                + 1j * i.detach().double().cpu().numpy())

    # -- 1. device ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("== phase 1: device")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    # -- 2. build -----------------------------------------------------
    log("== phase 2: build")
    t0 = time.perf_counter()
    B.lib()
    log(f"build {time.perf_counter() - t0:.3f} s "
        f"(nvcc {B.build_info['seconds']} s)")
    if B.build_info["seconds"] == 0.0:
        log(f"  library found in {B.BUILD_DIR}, built earlier from the same "
            f"sources (no ptxas output)")
    for line in B.build_info["log"].splitlines():
        if "registers" in line or "Function properties" in line \
                or "spill" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")

    # -- 3. kernels vs plain --------------------------------------------
    log("== phase 3: kernels vs plain on the card")
    err = {"stage1": 0.0, "stage2": 0.0}
    for b, n in [(8, 1 << 14), (1, 1 << 20), (1, 3 << 18), (8, 1 << 20),
                 (1, 1 << 24), (1, 1 << 26)]:
        n1, n2 = HK._pow2_split(n)
        ar, ai = planes((b, n1, n2))
        cr, ci = HK.stage1(ar, ai)
        pr, pi = HK.stage1_plain(ar, ai)
        yr, yi = HK.stage2(cr, ci)
        qr, qi = HK.stage2_plain(cr, ci)
        torch.cuda.synchronize()
        e1 = max((cr - pr).abs().max().item(), (ci - pi).abs().max().item())
        e2 = max((yr - qr).abs().max().item(), (yi - qi).abs().max().item())
        err["stage1"] = max(err["stage1"], e1)
        err["stage2"] = max(err["stage2"], e2)
        s1 = snr_db(host(pr, pi), host(cr, ci))
        s2 = snr_db(host(qr, qi), host(yr, yi))
        ref = np.fft.fft(host(ar, ai).reshape(b, n), axis=-1)
        so = snr_db(ref, host(yr, yi).reshape(b, n))
        log(f"({b}, {n}) split ({n1}, {n2}): stage1 vs plain {s1:.2f} dB "
            f"(max abs {e1:.3e}), stage2 vs plain {s2:.2f} dB "
            f"(max abs {e2:.3e}), kernels vs float64 oracle {so:.2f} dB")
        assert min(s1, s2, so) > FLOOR_DB, (b, n, s1, s2, so)
        del ar, ai, cr, ci, pr, pi, yr, yi, qr, qi

    err.update(stage1_real=0.0, stage2_half=0.0)
    for b, n in [(4, 1 << 14), (1, 1 << 20), (1, 3 << 18), (8, 1 << 20),
                 (1, 1 << 24), (1, 1 << 26)]:
        n1, n2 = HK._pow2_split(n)
        ar = real((b, n1, n2))
        cr, ci = HK.stage1_real(ar)
        pr, pi = HK.stage1_real_plain(ar)
        yr, yi = HK.stage2_half(cr, ci)
        qr, qi = HK.stage2_half_plain(cr, ci)
        torch.cuda.synchronize()
        e1 = max((cr - pr).abs().max().item(), (ci - pi).abs().max().item())
        e2 = max((yr - qr).abs().max().item(), (yi - qi).abs().max().item())
        err["stage1_real"] = max(err["stage1_real"], e1)
        err["stage2_half"] = max(err["stage2_half"], e2)
        s1 = snr_db(host(pr, pi), host(cr, ci))
        s2 = snr_db(host(qr, qi), host(yr, yi))
        ref = np.fft.rfft(ar.double().cpu().numpy().reshape(b, n), axis=-1)
        got = host(yr, yi)
        so = snr_db(ref, got)
        sq = snr_db(ref[:, -1], got[:, -1])
        log(f"({b}, {n}) split ({n1}, {n2}): stage1_real vs plain "
            f"{s1:.2f} dB (max abs {e1:.3e}), stage2_half vs plain "
            f"{s2:.2f} dB (max abs {e2:.3e}), real pair vs float64 rfft "
            f"{so:.2f} dB (Nyquist bin {sq:.2f} dB)")
        assert min(s1, s2, so, sq) > FLOOR_DB, (b, n, s1, s2, so, sq)
        del ar, cr, ci, pr, pi, yr, yi, qr, qi, ref, got

    err.update(col_fft=0.0, row_fft=0.0)

    def axis_pass(name, fn, plain_fn, ar, ai):
        """One col_fft / row_fft launch against its plain version on the
        same input: (output planes, SNR)."""
        yr, yi = fn(ar, ai)
        pr, pi = plain_fn(ar, ai)
        torch.cuda.synchronize()
        e = max((yr - pr).abs().max().item(), (yi - pi).abs().max().item())
        err[name] = max(err[name], e)
        return yr, yi, snr_db(host(pr, pi), host(yr, yi)), e

    for shape in [(1, 1024, 1024), (8, 512, 512), (1, 4096, 4096),
                  (1, 8192, 8192)]:
        ar, ai = planes(shape)
        cr, ci, s1, e1 = axis_pass("col_fft", HK.col_fft, HK.col_fft_plain,
                                   ar, ai)
        yr, yi, s2, e2 = axis_pass("row_fft", HK.row_fft, HK.row_fft_plain,
                                   cr, ci)
        so = snr_db(np.fft.fft2(host(ar, ai)), host(yr, yi))
        log(f"{shape}: col_fft vs plain {s1:.2f} dB (max abs {e1:.3e}), "
            f"row_fft vs plain {s2:.2f} dB (max abs {e2:.3e}), pair vs "
            f"float64 fft2 {so:.2f} dB")
        assert min(s1, s2, so) > FLOOR_DB, (shape, s1, s2, so)
        del ar, ai, cr, ci, yr, yi
    # the three axis passes of a 128^3 grid: axis 0 and 1 as col_fft views,
    # the last axis as a row_fft view
    ar, ai = planes((128, 128, 128))
    yr, yi = ar, ai
    snrs = []
    for view, name, fn, plain_fn in [
            ((1, 128, 16384), "col_fft", HK.col_fft, HK.col_fft_plain),
            ((128, 128, 128), "col_fft", HK.col_fft, HK.col_fft_plain),
            ((1, 16384, 128), "row_fft", HK.row_fft, HK.row_fft_plain)]:
        yr, yi, sv, _ = axis_pass(name, fn, plain_fn, yr.reshape(view),
                                  yi.reshape(view))
        snrs.append(sv)
    so = snr_db(np.fft.fftn(host(ar, ai)),
                host(yr, yi).reshape(128, 128, 128))
    log(f"(128, 128, 128) axis views: passes vs plain "
        f"{', '.join(f'{v:.2f}' for v in snrs)} dB, passes vs float64 fftn "
        f"{so:.2f} dB")
    assert min(*snrs, so) > FLOOR_DB, (snrs, so)
    for shape in [(128, 128, 128), (512, 256)]:
        xr, xi = planes(shape)
        yr, yi = HK.fused_ndfft_planes(xr, xi)
        pr, pi = HK.fused_nd_plain(xr, xi)
        torch.cuda.synchronize()
        sp = snr_db(host(pr, pi), host(yr, yi))
        so = snr_db(np.fft.fftn(host(xr, xi)), host(yr, yi))
        log(f"{shape}: fused_nd route ({len(shape)} launches) vs "
            f"fused_nd_plain {sp:.2f} dB, vs float64 fftn {so:.2f} dB")
        assert min(sp, so) > FLOOR_DB, (shape, sp, so)
    del ar, ai, xr, xi, yr, yi, pr, pi

    # -- 4. main path through the public entries --------------------------
    log("== phase 4: main paths through the public entries")
    log("-- the complex FFT")
    HK.reset_counts()

    def case(name, cls, fn, ref_fn):
        before = dict(HK.classes)
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        s = snr_db(ref_fn(), got)
        rose = cls is None or HK.classes[cls] > before[cls]
        log(f"{name}: {s:.2f} dB vs float64 oracle, class "
            f"{cls or 'none'} {'rose' if rose else 'DID NOT RISE'}, "
            f"{ms:.3f} ms host (first call)")
        assert s > FLOOR_DB and rose, (name, s, rose)

    def split_case(shape, cls):
        xr, xi = planes(shape)
        x = host(xr, xi)
        case(f"fft_split {shape}", cls,
             lambda: host(*kt.fft_split(xr, xi)),
             lambda: np.fft.fft(x, axis=-1))

    split_case((1 << 20,), "phased_flat")
    split_case((8, 1 << 20), "phased_tiled")
    tr, ti = planes((8, 1024, 1024))
    tx = host(tr, ti).reshape(8, -1)
    case("fft_split_tiled (8, 1024, 1024)", "phased_tiled",
         lambda: host(*kt.fft_split_tiled(tr, ti)).reshape(8, -1),
         lambda: np.fft.fft(tx, axis=-1))
    del tr, ti, tx
    split_case((1 << 24,), "ml")
    split_case((1 << 26,), "ml")
    split_case((8, 1 << 14), "ml")
    xr, xi = planes((1 << 20,))
    x = host(xr, xi)
    case("ifft_split(fft_split(x)) 2^20", "phased_flat",
         lambda: host(*kt.ifft_split(*kt.fft_split(xr, xi))), lambda: x)
    xc = torch.complex(xr, xi)
    case("fft complex64 2^20", "phased_flat",
         lambda: kt.fft(xc).cpu().numpy(), lambda: np.fft.fft(x))
    for n in (4099, 10 ** 6):
        br, bi = planes((n,))
        bx = host(br, bi)
        case(f"fft_split {n} (plain engine)", None,
             lambda: host(*kt.fft_split(br, bi)), lambda: np.fft.fft(bx))
    zr, zi = planes((64, 1 << 14))
    zx = host(zr, zi)
    case("fft_split (64, 16384) (cufft zone)", None,
         lambda: host(*kt.fft_split(zr, zi)),
         lambda: np.fft.fft(zx, axis=-1))
    torch.cuda.synchronize()
    launches = {k: HK.launches[k] for k in ("stage1", "stage2")}
    classes = {k: HK.classes[k] for k in ("phased_flat", "phased_tiled",
                                          "ml")}
    log(f"complex path counts: launches {launches}, classes {classes}")
    del xr, xi, xc, zr, zi

    log("-- the real FFT")
    HK.reset_counts()

    def rfft_case(shape, cls, entry):
        x = real(shape)
        xh = x.double().cpu().numpy()
        if entry == "rfft":
            fn = lambda: kt.rfft(x).cpu().numpy()       # noqa: E731
        else:
            fn = lambda: host(*kt.rfft_split(x))         # noqa: E731
        case(f"{entry} {shape}", cls, fn, lambda: np.fft.rfft(xh, axis=-1))

    rfft_case((1 << 20,), "phased_flat_real", "rfft")
    rfft_case((8, 1 << 20), "phased_tiled_real", "rfft_split")
    rfft_case((1 << 24,), "ml_real", "rfft")
    rfft_case((1 << 26,), "ml_real", "rfft")
    rfft_case((8, 1 << 14), "ml_real", "rfft")
    x = real((1 << 20,))
    xh = x.double().cpu().numpy()
    case("irfft(rfft(x)) 2^20", "phased_flat_real",
         lambda: kt.irfft(kt.rfft(x), n=1 << 20).cpu().numpy(), lambda: xh)
    xn = rng.standard_normal(1 << 20, dtype=np.float32)
    landed = []

    def numpy_rfft():
        y = kt.rfft(xn)               # numpy input, no device argument
        landed.append(y.device.type)
        return y.cpu().numpy()

    case("rfft of numpy input, default device, 2^20", "phased_flat_real",
         numpy_rfft, lambda: np.fft.rfft(xn.astype(np.float64)))
    assert landed == ["cuda"], landed
    x = real((10 ** 6,))
    xh = x.double().cpu().numpy()
    case("rfft 1000000 (plain engine)", None,
         lambda: kt.rfft(x).cpu().numpy(), lambda: np.fft.rfft(xh))
    torch.cuda.synchronize()
    launches.update({k: HK.launches[k] for k in ("stage1_real",
                                                 "stage2_half")})
    classes.update({k: HK.classes[k] for k in ("phased_flat_real",
                                               "phased_tiled_real",
                                               "ml_real")})
    log(f"real path counts: launches {HK.launches}, classes {HK.classes}")
    del x, xh, xn

    log("-- the N-D FFT")
    log(f"precision tier: {kt.get_config().precision}")
    HK.reset_counts()

    def nd_case(shape, cls, axes=None, entry="fftn"):
        x = host(*planes(shape))
        xc = torch.as_tensor(x.astype(np.complex64), device=dev)
        if entry == "fft2":
            axes = (-2, -1)
            fn = lambda: kt.fft2(xc)                        # noqa: E731
        else:
            fn = lambda: kt.fftn(xc, axes=axes)             # noqa: E731
        case(f"{entry} {shape} axes {axes}", cls,
             lambda: fn().cpu().numpy(), lambda: np.fft.fftn(x, axes=axes))

    nd_case((1024, 1024), "fft2", entry="fft2")
    nd_case((8, 512, 512), "fft2", entry="fft2")
    nd_case((2048, 2048), "fft2_big", entry="fft2")
    nd_case((4096, 4096), "fft2_big", entry="fft2")
    nd_case((8192, 8192), "fft2_big", entry="fft2")
    nd_case((128, 128, 128), "fused_nd")
    nd_case((512, 256), "fused_nd")
    xr, xi = planes((1024, 1024))
    x = host(xr, xi)
    xc = torch.complex(xr, xi)
    case("ifft2(fft2(x)) 1024^2", "fft2",
         lambda: kt.ifft2(kt.fft2(xc)).cpu().numpy(), lambda: x)
    xr, xi = planes((128, 128, 128))
    x = host(xr, xi)
    case("fftn_split inverse (128, 128, 128)", "fused_nd",
         lambda: host(*kt.fftn_split(xr, xi, inverse=True)),
         lambda: np.fft.ifftn(x))
    x = real((4, 8, 1 << 17))
    xh = x.double().cpu().numpy()
    case("rfftn (4, 8, 2^17)", "ml_real", lambda: kt.rfftn(x).cpu().numpy(),
         lambda: np.fft.rfftn(xh))
    nd_case((1024, 16384), None)            # cuFFT zone
    # per-axis: the 2^17-point axis takes the 1-D stage kernels
    nd_case((128, 2, 1 << 17), "ml", axes=(0, 2))
    torch.cuda.synchronize()
    nd_launches = dict(HK.launches)
    nd_classes = dict(HK.classes)
    log(f"N-D path counts: launches {nd_launches}, classes {nd_classes}")
    assert all(nd_launches[k] > 0 for k in HK.launches), nd_launches
    assert all(nd_classes[k] > 0 for k in ("fft2", "fft2_big", "fused_nd")), \
        nd_classes
    launches.update({k: nd_launches[k] for k in ("col_fft", "row_fft")})
    classes.update({k: nd_classes[k] for k in ("fft2", "fft2_big",
                                               "fused_nd")})
    log(f"main path counts: launches {launches}, classes {classes}")
    assert set(launches) == set(HK.launches), launches
    assert set(classes) == set(HK.classes), classes
    assert all(v > 0 for v in launches.values()), launches
    assert all(v > 0 for v in classes.values()), classes
    del x, xh, xr, xi, xc

    # -- 5. gradient --------------------------------------------------
    log("== phase 5: gradients through fft_split and rfft_split at 2^20, "
        "fft2 at 1024^2 and fftn_split at 128^3")
    n = 1 << 20
    xr, xi = planes((n,))
    gr, gi = planes((n,))
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    yr, yi = kt.fft_split(xr, xi)
    (yr * gr + yi * gi).sum().backward()
    s = snr_db(np.fft.ifft(host(gr, gi)) * n, host(xr.grad, xi.grad))
    log(f"fft_split grad vs unnormalized inverse of the cotangent: "
        f"{s:.2f} dB")
    assert s > FLOOR_DB, s
    del xr, xi, gr, gi, yr, yi
    h = n // 2 + 1
    x = real((n,))
    gr, gi = planes((h,))
    x.requires_grad_(True)
    yr, yi = kt.rfft_split(x)
    (yr * gr + yi * gi).sum().backward()
    full = np.zeros(n, np.complex128)
    full[:h] = host(gr, gi)
    s = snr_db((np.fft.ifft(full) * n).real,
               x.grad.detach().double().cpu().numpy())
    log(f"rfft_split grad vs real plane of the unnormalized inverse of the "
        f"zero-padded cotangent: {s:.2f} dB")
    assert s > FLOOR_DB, s
    del x, gr, gi, yr, yi, full
    xr, xi = planes((1024, 1024))
    gr, gi = planes((1024, 1024))
    xc = torch.complex(xr, xi).requires_grad_(True)
    y = kt.fft2(xc)
    (y.real * gr + y.imag * gi).sum().backward()
    s = snr_db(np.fft.ifft2(host(gr, gi)) * xr.numel(),
               xc.grad.detach().cpu().numpy())
    log(f"fft2 grad (1024^2, route fft2) vs unnormalized inverse of the "
        f"cotangent: {s:.2f} dB")
    assert s > FLOOR_DB, s
    xr, xi = planes((128, 128, 128))
    gr, gi = planes((128, 128, 128))
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    yr, yi = kt.fftn_split(xr, xi)
    (yr * gr + yi * gi).sum().backward()
    s = snr_db(np.fft.ifftn(host(gr, gi)) * xr.numel(),
               host(xr.grad, xi.grad))
    log(f"fftn_split grad (128^3, route fused_nd) vs unnormalized inverse "
        f"of the cotangent: {s:.2f} dB")
    assert s > FLOOR_DB, s
    del xr, xi, gr, gi, xc, y, yr, yi

    # -- 6. timing ----------------------------------------------------
    log("== phase 6: timing (CUDA events after 3 warm-up calls)")

    def time_ms(fn, runs=20, warm=3):
        """(median ms of single calls, device ms per call back-to-back,
        host ms per call enqueuing those back-to-back calls)"""
        for _ in range(warm):
            fn()
        ts = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            z.record()
            z.synchronize()
            ts.append(a.elapsed_time(z))
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        t = time.perf_counter()
        for _ in range(runs):
            fn()
        host = (time.perf_counter() - t) * 1e3 / runs
        z.record()
        z.synchronize()
        return statistics.median(ts), a.elapsed_time(z) / runs, host

    def report(shape, what, t):
        single, streamed, host = t
        log(f"{shape}: {what}: single call {single * 1e3:.1f} us, "
            f"back-to-back {streamed * 1e3:.1f} us/call = "
            f"{math.prod(shape) / (streamed * 1e-3):.4e} points/s, host "
            f"enqueue {host * 1e3:.1f} us/call [{smi}]")

    for shape in [(1 << 20,), (8, 1 << 20), (1 << 24,), (1 << 26,)]:
        b = shape[0] if len(shape) == 2 else 1
        n = shape[-1]
        n1, n2 = HK._pow2_split(n)
        xr, xi = planes(shape)
        xc = torch.complex(xr, xi)
        x = real(shape)
        a3r, a3i = xr.reshape(b, n1, n2), xi.reshape(b, n1, n2)
        a3 = x.reshape(b, n1, n2)
        # the two kernel paths in turns (fft, rfft, rfft, fft, three
        # times), so that the host's neighbours weigh on both alike; each
        # number reported is the median of the six
        paths = {"fft_split": lambda: kt.fft_split(xr, xi),
                 "rfft_split": lambda: kt.rfft_split(x)}
        turns = {k: [] for k in paths}
        for _ in range(3):
            for k in ("fft_split", "rfft_split", "rfft_split", "fft_split"):
                turns[k].append(time_ms(paths[k]))
        rows = (
            (False, "fft_split",
             "plain version (stage1_plain + stage2_plain)",
             lambda: HK.stage2_plain(*HK.stage1_plain(a3r, a3i)),
             "torch.fft.fft (cuFFT)", lambda: torch.fft.fft(xc)),
            (True, "rfft_split",
             "plain version (stage1_real_plain + stage2_half_plain)",
             lambda: HK.stage2_half_plain(*HK.stage1_real_plain(a3)),
             "torch.fft.rfft (cuFFT)", lambda: torch.fft.rfft(x)))
        for real_fft, k, plain_what, plain_fn, lib_what, lib_fn in rows:
            bd, by = transform_bound(real_fft, b, n)
            log(f"{shape}: {k} bound {bd * 1e3:.2f} us ({by})")
            report(shape, f"kernel path ({k}, median of 6 in turns)",
                   tuple(statistics.median(t[i] for t in turns[k])
                         for i in range(3)))
            report(shape, plain_what, time_ms(plain_fn))
            report(shape, lib_what, time_ms(lib_fn))
        del xr, xi, xc, x, a3r, a3i, a3, paths, rows
        torch.cuda.synchronize()

    for shape, axes in [((1024, 1024), (-2, -1)), ((8, 512, 512), (-2, -1)),
                        ((4096, 4096), (-2, -1)), ((8192, 8192), (-2, -1)),
                        ((128, 128, 128), None)]:
        xr, xi = planes(shape)
        xc = torch.complex(xr, xi)
        if axes is None:
            plain_what = "plain version (fused_nd_plain)"
            plain_fn = lambda: HK.fused_nd_plain(xr, xi)      # noqa: E731
            lib_what = "torch.fft.fftn (cuFFT)"
            lib_fn = lambda: torch.fft.fftn(xc)               # noqa: E731
        else:
            a3r = xr.reshape(-1, *shape[-2:])
            a3i = xi.reshape(-1, *shape[-2:])
            plain_what = "plain version (col_fft_plain + row_fft_plain)"
            plain_fn = lambda: HK.row_fft_plain(            # noqa: E731
                *HK.col_fft_plain(a3r, a3i))
            lib_what = "torch.fft.fft2 (cuFFT)"
            lib_fn = lambda: torch.fft.fft2(xc)               # noqa: E731
        bd, by = nd_bound(shape, axes)
        log(f"{shape}: fftn_split bound {bd * 1e3:.2f} us ({by})")
        report(shape, "kernel path (fftn_split)",
               time_ms(lambda: kt.fftn_split(xr, xi, axes=axes)))
        report(shape, plain_what, time_ms(plain_fn))
        report(shape, lib_what, time_ms(lib_fn))
        del xr, xi, xc, plain_fn, lib_fn
        torch.cuda.synchronize()

    shape = (1, 1024, 1024)
    ar, ai = planes(shape)
    cr, ci = HK.stage1(ar, ai)
    kern = {"stage1": time_ms(lambda: HK.stage1(ar, ai)),
            "stage2": time_ms(lambda: HK.stage2(cr, ci)),
            "stage1_real": time_ms(lambda: HK.stage1_real(ar)),
            "stage2_half": time_ms(lambda: HK.stage2_half(cr, ci)),
            "col_fft": time_ms(lambda: HK.col_fft(ar, ai)),
            "row_fft": time_ms(lambda: HK.row_fft(ar, ai))}
    plain = {"stage1": time_ms(lambda: HK.stage1_plain(ar, ai)),
             "stage2": time_ms(lambda: HK.stage2_plain(cr, ci)),
             "stage1_real": time_ms(lambda: HK.stage1_real_plain(ar)),
             "stage2_half": time_ms(lambda: HK.stage2_half_plain(cr, ci)),
             "col_fft": time_ms(lambda: HK.col_fft_plain(ar, ai)),
             "row_fft": time_ms(lambda: HK.row_fft_plain(ar, ai))}
    bound = {k: stage_bound(k, *shape) for k in kern}
    for k in kern:
        log(f"{shape} {k}: kernel single {kern[k][0] * 1e3:.1f} us,"
            f" back-to-back {kern[k][1] * 1e3:.1f} us/call; plain single "
            f"{plain[k][0] * 1e3:.1f} us, back-to-back "
            f"{plain[k][1] * 1e3:.1f} us/call; bound "
            f"{bound[k][0] * 1e3:.2f} us ({bound[k][1]}) [{smi}]")
    # one axis pass is one library call: torch.fft.fft along that axis of
    # the complex tensor (built once, outside the timed calls); the four
    # stage kernels have none (no PyTorch call computes one four-step stage)
    ac = torch.complex(ar, ai)
    library_ms = {}
    for k, dim in (("col_fft", 1), ("row_fft", 2)):
        t = time_ms(lambda: torch.fft.fft(ac, dim=dim))
        library_ms[k] = t[1]
        log(f"{shape} {k} library torch.fft.fft(complex, dim={dim}): "
            f"single {t[0] * 1e3:.1f} us, back-to-back {t[1] * 1e3:.1f} "
            f"us/call [{smi}]")
    ms = {k: v[1] for k, v in kern.items()}
    plain_ms = {k: v[1] for k, v in plain.items()}
    del ar, ai, cr, ci, ac
    # the three axis passes of a 128^3 grid alone: lines of 128, T = 16
    for view, k, dim in (((1, 128, 16384), "col_fft", 1),
                         ((128, 128, 128), "col_fft", 1),
                         ((1, 16384, 128), "row_fft", 2)):
        vr, vi = planes(view)
        vc = torch.complex(vr, vi)
        fn, plain_fn = {"col_fft": (HK.col_fft, HK.col_fft_plain),
                        "row_fft": (HK.row_fft, HK.row_fft_plain)}[k]
        tkern = time_ms(lambda: fn(vr, vi))
        tp = time_ms(lambda: plain_fn(vr, vi))
        tl = time_ms(lambda: torch.fft.fft(vc, dim=dim))
        bd, by = stage_bound(k, *view)
        log(f"{view} {k}: kernel back-to-back {tkern[1] * 1e3:.1f} us/call; "
            f"plain {tp[1] * 1e3:.1f}; torch.fft.fft(dim={dim}) "
            f"{tl[1] * 1e3:.1f}; bound {bd * 1e3:.2f} us ({by}) [{smi}]")
        del vr, vi, vc

    src = "kofft_tpu_torch/ops/csrc/fft_stages.cu"
    tpu = "kofft_tpu/ops/pallas_kernels.py"
    replaces = {
        "stage1": (547, ["847 (_build_phased kern, phase 1)"]),
        "stage2": (569, ["847 (_build_phased kern, phases 2-3)"]),
        "stage1_real": (558, ["847 (_build_phased kern, real=True, "
                              "phase 1)"]),
        "stage2_half": (579, ["847 (_build_phased kern, real=True, phases "
                              "2-3 and the Nyquist bin)"]),
        "col_fft": (1701, ["1597 (_build_fft2 kern, phase 1)",
                           "1415 (_build_fused_nd kern, the passes over "
                           "axes 0 ... d-2)"]),
        "row_fft": (1708, ["1597 (_build_fft2 kern, phase 2)",
                           "1415 (_build_fused_nd kern, the last-axis "
                           "pass)"])}
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src,
         "replaces": f"{tpu}:{line}",
         "also_replaces": [f"{tpu}:{a}" for a in also],
         "launches": launches[k], "max_abs_err": err[k],
         "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bound[k][0],
         "bound_by": bound[k][1], "library_ms": library_ms.get(k)}
        for k, (line, also) in replaces.items()]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
