#!/usr/bin/env python3
"""Drive kofft_tpu_torch's main path, the 1-D complex FFT, on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN so the plain
   versions run in full float32;
2. build: nvcc builds every kernel source of the package (timed), and
   the ptxas register / shared-memory lines are printed;
3. kernels vs plain: stage1 and stage2 against their plain PyTorch
   versions on the same CUDA tensors, and the pair against a float64
   numpy FFT, at (8, 2^14), 2^20, 3*2^18, (8, 2^20), 2^24 and 2^26;
   every SNR must exceed 100 dB;
4. main path: the public entries on CUDA tensors with every count set to
   0 just before; each case checks its output against a float64 oracle
   and that its TPU-kernel class count rose; the kernel launch counts are
   read just after;
5. gradient: backward through fft_split at 2^20 against the analytic
   gradient (the unnormalized inverse of the cotangent);
6. timing: CUDA events after warm-up, of the kernel path, the plain
   version and torch.fft (cuFFT) at 2^20, 8 x 2^20, 2^24 and 2^26, and
   of each stage kernel and its plain version at 2^20. Two numbers each: the
   median of 20 single calls, each between its own pair of events (this
   includes the host's enqueue time whenever the device would otherwise
   wait), and the device time per call over 20 back-to-back calls
   between one pair of events (the host runs ahead; the kernels' JSON
   record carries this one).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero before it prints any result.
"""

from __future__ import annotations

import json
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


def log(*a):
    print(*a, flush=True)


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.complex128)
    got = np.asarray(got, np.complex128)
    den = np.sum(np.abs(ref - got) ** 2)
    return float("inf") if den == 0 else float(
        10 * np.log10(np.sum(np.abs(ref) ** 2) / den))


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

    # -- 4. main path through the public entries --------------------------
    log("== phase 4: main path through the public entries")
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
    launches = dict(HK.launches)
    classes = dict(HK.classes)
    log(f"main path counts: launches {launches}, classes {classes}")
    assert all(v > 0 for v in launches.values()), launches
    assert all(v > 0 for v in classes.values()), classes
    del xr, xi, xc, zr, zi

    # -- 5. gradient --------------------------------------------------
    log("== phase 5: gradient through fft_split at 2^20")
    n = 1 << 20
    xr, xi = planes((n,))
    gr, gi = planes((n,))
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    yr, yi = kt.fft_split(xr, xi)
    (yr * gr + yi * gi).sum().backward()
    s = snr_db(np.fft.ifft(host(gr, gi)) * n, host(xr.grad, xi.grad))
    log(f"grad vs unnormalized inverse of the cotangent: {s:.2f} dB")
    assert s > FLOOR_DB, s
    del xr, xi, gr, gi, yr, yi

    # -- 6. timing ----------------------------------------------------
    log("== phase 6: timing (CUDA events after 3 warm-up calls)")

    def time_ms(fn, runs=20, warm=3):
        """(median ms of single calls, ms per call back-to-back)"""
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
        for _ in range(runs):
            fn()
        z.record()
        z.synchronize()
        return statistics.median(ts), a.elapsed_time(z) / runs

    for shape in [(1 << 20,), (8, 1 << 20), (1 << 24,), (1 << 26,)]:
        b = shape[0] if len(shape) == 2 else 1
        n = shape[-1]
        n1, n2 = HK._pow2_split(n)
        xr, xi = planes(shape)
        xc = torch.complex(xr, xi)
        a3r, a3i = xr.reshape(b, n1, n2), xi.reshape(b, n1, n2)
        rows = {
            "kernel path (fft_split)": lambda: kt.fft_split(xr, xi),
            "plain version (stage1_plain + stage2_plain)":
                lambda: HK.stage2_plain(*HK.stage1_plain(a3r, a3i)),
            "torch.fft.fft (cuFFT)": lambda: torch.fft.fft(xc),
        }
        for what, fn in rows.items():
            single, streamed = time_ms(fn)
            log(f"{shape}: {what}: single call {single * 1e3:.1f} us, "
                f"back-to-back {streamed * 1e3:.1f} us/call = "
                f"{b * n / (streamed * 1e-3):.4e} points/s [{smi}]")
        del xr, xi, xc, a3r, a3i

    ar, ai = planes((1, 1024, 1024))
    cr, ci = HK.stage1(ar, ai)
    kern = {"stage1": time_ms(lambda: HK.stage1(ar, ai)),
            "stage2": time_ms(lambda: HK.stage2(cr, ci))}
    plain = {"stage1": time_ms(lambda: HK.stage1_plain(ar, ai)),
             "stage2": time_ms(lambda: HK.stage2_plain(cr, ci))}
    for k in kern:
        log(f"(1, 1024, 1024) {k}: kernel single {kern[k][0] * 1e3:.1f} us,"
            f" back-to-back {kern[k][1] * 1e3:.1f} us/call; plain single "
            f"{plain[k][0] * 1e3:.1f} us, back-to-back "
            f"{plain[k][1] * 1e3:.1f} us/call [{smi}]")
    ms = {k: v[1] for k, v in kern.items()}
    plain_ms = {k: v[1] for k, v in plain.items()}

    src = "kofft_tpu_torch/ops/csrc/fft_stages.cu"
    tpu = "kofft_tpu/ops/pallas_kernels.py"
    record = {"kernels": [
        {"name": "stage1", "route": "cuda", "source": src,
         "replaces": f"{tpu}:547",
         "also_replaces": [f"{tpu}:847 (_build_phased kern, phase 1)"],
         "launches": launches["stage1"], "max_abs_err": err["stage1"],
         "ms": ms["stage1"], "plain_ms": plain_ms["stage1"]},
        {"name": "stage2", "route": "cuda", "source": src,
         "replaces": f"{tpu}:569",
         "also_replaces": [f"{tpu}:847 (_build_phased kern, phases 2-3)"],
         "launches": launches["stage2"], "max_abs_err": err["stage2"],
         "ms": ms["stage2"], "plain_ms": plain_ms["stage2"]},
    ]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
