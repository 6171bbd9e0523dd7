#!/usr/bin/env python3
"""Drive kofft_tpu_torch's main paths, the 1-D complex and real FFT (on
float32 and bfloat16 planes, on the `highest` and the `default` tier), the
dense four-step pair, the N-D FFT, the signal-processing entries (STFT,
its streams, the composite transforms), the models' forward passes, the
streaming spectrogram server, the models' training and the sanity-check
CLI, the sharded programs of ``parallel``, and the bench harness, on
one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN so the plain
   versions run in full float32;
2. build: nvcc builds every kernel source of the package, one process per
   source, all at once (timed), and the ptxas register / spill lines are
   printed, with a summary of the smooth-n1 stage-1 instances
   (stage1_odd.cu); cuobjdump -sass must show HGMMA (wgmma) in each of
   the dense pair's four tensor-core instances;
3. kernels vs plain: stage1 and stage2 against their plain PyTorch
   versions on the same CUDA tensors (above 110 dB), forward and inverse
   (conj), and the pair against a float64 numpy FFT / inverse FFT, at
   (8, 2^14), 2^20, the smooth 3*2^18, 9*2^14 and 23*2^14 (stage 1 on
   the odd plan), (8, 2^20), 2^22, 2^23 (stage 2's cluster), 2^24,
   2^25 and 2^26 (stage 1's column four-step), and phase 7's 2^21 (the
   DCT/DST fast paths) and (1024, 2^14) (the kernel-path STFT's 1024
   frames); then stage1_real and
   stage2_half the same way, the pair against the float64 numpy rfft, at
   (4, 2^14) and the same sizes; then stage 1 of every smooth n1 = o * 2^a
   (the 19 lengths at the smallest n that _pow2_split gives each, and
   3*2^23, 3072 x 8192), forward, inverse and real against the plain
   versions (above 110 dB), and its bf16 forms at (1, 768, 1024), (1,
   1152, 128) and (1, 2944, 128);
   then col_fft and row_fft the same way, forward and inverse (conj),
   above 110 dB against their plain versions, the pair against the
   float64 numpy fft2 / ifft2, at lines of 2 ... 8192 ((4096, 2, 16),
   (1, 16, 2048), (1, 1024, 1024), (8, 512, 512), (1, 2048, 4096) and
   (1, 4096, 2048) on both sides of col_fft's column four-step, (1, 4096,
   4096), (1, 8192, 8192)), the four-step at 2048 (as phase 6 times it),
   the three axis passes of a 128^3 grid against its fftn, and the
   fused_nd route (d launches) against fused_nd_plain at 128^3 and (512,
   256); then dense_stage_a and dense_stage_b on the `highest` tier
   (tf32x3) and the `default` tier (bf16x1) against their plain versions
   on that tier (100 dB), and fused_four_step_fft against a float64 FFT
   (100 dB, `default` 42 dB) with its peak device memory, at 2^14,
   (3, 2^14), 3*2^14, 2^20, (8, 2^20), 2^24 and 2^26; every other SNR
   against float64 must exceed 100 dB; last, every bf16 I/O form of the
   four stage kernels against its plain version with the same types at
   (8, 1024, 1024), (1, 2048, 2048),
   (1, 2048, 4096), (1, 4096, 4096), (1, 4096, 8192) and (1, 8192, 8192)
   (the `default` tier's 2^26 shape), above 110 dB where it stores
   float32 and 70 dB where it stores bf16;
4. main paths: the public entries (complex, then real, then N-D, then
   the dense pair, bf16 planes and the `default` tier, the dense pair on
   it included; the complex and the real path include the smooth 3*2^18,
   whose stage-1 launches on the odd plan are read apart) with every count
   set to 0 just before each path; each case checks its output against a
   float64 oracle and that its TPU-kernel class count rose; the kernel
   launch counts are read just after each path; one real case passes
   numpy input with no device, which must land on the card; the N-D path
   runs all three N-D classes (fft2, fft2_big, fused_nd), the cuFFT zone
   and the per-axis route; bf16 planes must come back bf16 (>= 40 dB), and
   the `default` tier's float32 route float32 (>= 42 dB); every kernel
   form and every class must have launched;
5. gradient: backward through fft_split and through rfft_split at 2^20,
   through fft2 at 1024^2, through fftn_split at 128^3 and through
   fft_split on bf16 planes at 2^20, against the analytic gradient (the
   unnormalized inverse of the cotangent, zero-padded to n for the real
   transform);
6. timing: CUDA events after warm-up, of the kernel path, the plain
   version and torch.fft (cuFFT) at 2^20, 8 x 2^20, 2^24 and 2^26 for the
   complex and the real FFT. Three numbers each: the median of 20
   single calls, each between its own pair of events (this includes the
   host's enqueue time whenever the device would otherwise wait); the
   device time per call over 20 back-to-back calls between one pair of
   events (the host runs ahead; the kernels' JSON record carries this
   one); and the host's time per call to enqueue those 20 calls. The two
   kernel paths, fft_split and rfft_split, are timed in turns (fft, rfft,
   rfft, fft, three times) and reported as medians. Each transform row
   has its bound (``transform_bound``). Then fused_four_step_fft at 2^20,
   8 x 2^20 and 2^24 on the `highest` and the `default` tier, each beside
   its plain version on that tier, beside the two products alone as
   complex64 torch.matmul (TF32 off) and cuFFT; the float32
   route, the bf16-planes route, the `default` tier and the bf16 planes'
   plain version (backend='torch') in turns at 8 x 2^20, 2^24 and 2^26
   for both 1-D transforms. Then the N-D rows: the
   kernel route (fftn_split), its plain version and torch.fft.fft2 / fftn
   at 1024^2, (8, 512, 512), 4096^2, 8192^2 and 128^3 with their bound
   (``nd_bound``); every kernel, bf16 form and dense instance alone at
   (1, 1024, 1024)
   beside its plain version, and the library call where one computes the
   same function, each back to back and as device time per call of a CUDA
   graph of 20 calls (``graph_ms``: no host time; at this size the
   back-to-back time can be the host's enqueue); the three axis passes
   of a 128^3 grid alone, col_fft and row_fft at (1, 4096, 4096) and
   (1, 8192, 8192), and stage1 and stage2 at (1, 2048, 2048), (1, 4096,
   4096) and (1, 8192, 8192) (kernel graph and back-to-back, plain
   version, torch.fft.fft along the same axis, bound); the smooth-n1
   stage 1 (the odd plan) alone at the splits of 3*2^18, 9*2^14,
   23*2^14, 5*2^16 and 3*2^23, and fft_split at 3*2^18 and 5*2^16 beside
   torch.fft.fft; and col_fft at lines of 2048 as one launch and as the
   column four-step;
7. the signal-processing entries, every count set to 0 first: the STFT at
   the JAX bench's shape (2^20 samples, hann(1024), hop 256, 4096 frames;
   the plain factor tree, no kernel launched), one-sided and full, against
   the float64 numpy STFT (100 dB), and its ISTFT's interior on the
   `highest` and the `default` tier (90 dB); 2^24 samples, hann(4096), hop
   1024 (the torch.fft zone) and its ISTFT; 2^22 samples, hann(16384), hop
   4096 with backend='cuda', whose one-sided, full and inverse transforms
   must each raise their stage kernels' launch counts; the stream scans,
   the push stream (4800-sample chunks) and 64 pushed ISTFT frames against
   the offline entries (110 dB), with the scans' peak device memory; the
   DCT/DST fast paths, idct round trips, dht, hilbert_analytic,
   real_cepstrum and czt_fast (n = 10^6, m = 4096) at 2^20 through the
   stage kernels, mfcc, goertzel_bins, and dwt/idwt and dwt_multi/
   idwt_multi at 2^24, each at 100 dB against a float64 oracle; the
   public goertzel_scan at (64, 2^20) (the kernel's launches on this path
   are read here) with its relative error against the float64 DFT
   magnitude, then the goertzel_scan kernel against its plain version at
   (64, 2^20) (the loop on a host copy) and (64, 4096) (1e-5 relative);
   last, stft_split (one-sided) and
   istft_split in frames per second at the bench shape and the kernel
   path beside torch.stft / torch.istft, and goertzel_scan at (64, 4096)
   and (64, 2^20) beside its bound;
8. the models and the server, every count set to 0 first: entry() (the
   flagship SpectralNet forward, win 256, hop 128, 32 mel bands, 8
   classes, a (4, 4096) signal) on the card against the port on the CPU
   and a float64 numpy forward (90 dB); SpectralNet and SpectralDenoiser
   (hidden 64) at a serving batch of 256 one-second clips at 16 kHz,
   weights drawn from the seed, against the port on the CPU (90 dB, the
   denoiser's interior), each timed per forward back to back and as a
   CUDA graph, with host enqueue and signals per second, beside the
   forward's STFT alone and torch.stft at the same frames (context); the
   path launches no kernel (win 256 lies below the stage kernels), which
   is asserted; then the streaming spectrogram server on the card
   (serve_background with its default device), called on 127.0.0.1:
   /health, four /api/compute_frame pushes of 2048 samples (the rows
   against the port's StreamingSpectrogram on the CPU, within 1 LSB),
   one /api/stft of 16384 samples at win 1024 (100 dB against the CPU),
   /api/set_colormap and /api/reset, each request's latency recorded;
   the phase's record is printed as one JSON line ({"phase8": ...});
9. the models' training, every count set to 0 first: (a) SpectralNet at
   the entry widths from init(0) (six empty mel bands: JAX's derivative
   of |x| at 0) on (256, 16000) with seeded labels: step 0's loss and
   gradients against the port on the CPU and against a float64 autograd
   reference (``spectral_net_loss_f64``) (loss >= 110 dB, mel >= 80,
   w_head and b_head >= 100); 10 steps at lr 1e-3, every loss finite and
   each step held against the CPU port's step from the same parameters
   (parameters >= 80 dB, loss >= 110), the free-running trajectories of
   the card, the CPU port and float64 recorded; (b) the denoiser (hidden
   64) on (256, 16000) of tones plus interferers in other bins
   (``denoiser_batch``): step 0 against the CPU port (>= 110 / 100 dB),
   60 steps at lr 1 must bring the loss below 0.3 of its first value;
   neither launches a kernel (asserted); (c) the denoiser at win 2^14,
   hop 2^13 on (16, 2^18) under backend "cuda": stage1 and stage2 must
   launch in the forward and inside backward() (counts reset between),
   the gradients against backend "torch" on the card (>= 100 dB on
   `highest`), `default` against `highest` recorded; (d) the
   sanity-check CLI as a subprocess on the card (defaults, and log scale
   with 16-bit viridis) on a seeded 10 s WAV, each PNG within one colour
   level of the CPU port's render, with its wall time and the share of
   differing pixels. (a), (b) and (c) time a step by CUDA events after 3
   warm-up steps, back to back with host enqueue and as a CUDA graph of
   10 steps where the step captures, in µs per step and signals per
   second; the record is printed as {"phase9": ...}, and phase 9(c)'s
   launches per step go on the stage1 and stage2 rows of the kernels'
   record under ``training_launches``;
10. the parallel programs (``phase_parallel``) on a world of one NCCL
   rank on the card (NCCL refuses two ranks on one device: the
   all_to_alls are device copies, no halo is sent), every count set to
   0 just before each driven call and read just after: (a)
   fft_sharded at 2^28 (2 GiB of planes), restore_layout False and
   True, overlap 1 and 4, forward and inverse, against a complex128
   torch.fft oracle on the card (100 dB; digit order undone for False),
   no kernel launched (its local DFTs run the plain engine, as
   kofft_tpu's), timed beside fft_split (cuFFT above 2^26) and the plain
   engine; (b) fftn_sharded on 512^3 with backend "cuda" and "torch",
   sequential and overlap=4, against complex128 fftn (100 dB), the
   sequential "cuda" run launching col_fft and row_fft (its 512^2 slabs
   are in fused_2d_zone), timed beside fftn_split and torch.fft.fftn;
   (c) stft_sharded / istft_sharded on 2^26 samples at hann(1024)/hop
   256 and hann(16384)/hop 4096 against the two-sided stft_split and
   istft_split (110 dB, the ISTFTs on the interior) and the push
   region's interior against the signal (90 dB), timed beside them; (d)
   the hierarchical programs on a (1, 1) mesh at those sizes; (e) the
   auto entries at d = 1 take the single-card entries: fft_auto 2^26
   (stage1, stage2) and fftn_auto 8192^2 (col_fft, row_fft) against
   complex128, stft_auto / istft_auto against stft_split / istft_split;
   (f) calibrate_shard_threshold() returns the current threshold; (g)
   check_fft_sharded_comm_volume on NCCL: the canonical bytes,
   cross_chip_bytes 0, independent_sources 2 and 2K; (h)
   entry.dryrun_multichip(4) on 4 gloo ranks of the host's CPU (not a
   card result). The record is printed as {"phase10": ...}; the driven
   calls' launches go on the kernels' record as ``sharded_launches``;
11. the bench harness (``phase_bench``, ``kofft_tpu_torch.bench``) at
   bench.py's shapes, every count set to 0 just before (a) and read just
   after (b): (a) the headline, ``fft_split`` at 2^20 chained unscaled
   through ``timeit_chained`` (a CUDA graph of the chain, timed by CUDA
   events; slope between two chain lengths), printed as
   c32_fft_2^20_points_per_sec_per_chip beside ``graph_ms`` of the same
   call (they must agree within 15 %) and >= 100 dB against float64, a
   ``torch.fft`` row (``torch.fft.fft`` on complex64) and ``fft_split``
   at 2^26 (the chain's device-memory bound at its largest); (b) the
   SNR-policy rows on the `default` tier: complex and real 2^20
   (``single_fast``), complex 8 x 2^20 (``batch8_fast``),
   ``fft_split_tiled`` on bf16 planes (``batch8_tiled_bf16``), ``fft2d``
   1024^2, ``fft3d`` 128^3, ``stft_frames`` and ``istft_frames`` (full
   and interior) at 2^20 samples, hann(1024), hop 256 through
   ``timeit_chained_scalar``, each SNR against float64 numpy, then
   ``check_snr_policy``; (c) ``run_history`` twice into a fresh
   build/phase11_history, the second run re-measuring (a) only: the
   rotation to previous.json and the stale carry-forward are asserted.
   Every row is logged with its chain (N1, delta, the graphs' pools);
   the record is printed as {"phase11": ...} and the launches of (a)
   and (b) go on the kernels' record as ``bench_launches``.

A bound is the least time the card could take for the work: the larger
of the bytes the function must move (each input read once, each output
written once) over 3.35 TB/s, and 5 m log2 m float32 operations per
complex line of length m (half for real input or one-sided output) over
67 TFLOP/s; an N-D transform does that along each of its axes. The
Goertzel recurrence's operations are a dependent chain: its bound is
three float32 operations per sample, one after the other, at 4 cycles
each and the card's highest SM clock (nvidia-smi clocks.max.sm). The line
before the last is the kernels' JSON record (launches on the main paths and, as
``sharded_launches``, in phase 10, and as ``bench_launches`` in phase 11
(each wrapper call counts once: a graph replay runs the captured launches
again without passing the wrapper), max abs error against the plain
version, and at (1, 1024, 1024) the bound
and the device ms per call of kernel, plain version and library call (or
null): back to back under ``ms``, ``plain_ms`` and ``library_ms``, as
since the first slice, and replayed from a CUDA graph under
``graph_ms``, ``plain_graph_ms`` and ``library_graph_ms``; the
goertzel_scan kernel's at (64, 4096), with its (64, 2^20) figures under
``long``); the last line
is {"ok": true, "device": {...}}. Without a CUDA device the script exits non-zero before it prints
any result.
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
# the axis kernels against their plain versions: two float32 evaluations
# of the DFT of each line (radix passes against the dense-leaf recursion)
AXIS_DB = 110.0
# bf16 outputs against float64: each rounds float32 sums once (8 mantissa
# bits, ~50 dB); a bf16-stored kernel against its plain version: both round
# the same float32 sums to nearest even, so they differ only where the two
# sums straddle a rounding boundary (~88 dB); a truncating store or bf16
# sums would read 45-55 dB; the `default` tier's floor for its float32 route
BF16_DB = 40.0
BF16_PLAIN_DB = 70.0
DEFAULT_DB = 42.0
# the dense pair's bf16x1 instances against their plain versions, which
# round the same operands to bf16: float32 summation order only (118-139
# dB measured on the card)
DENSE_BF16_DB = 100.0
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


def snr_db_card(ref, got) -> float:
    """snr_db of two (real, imag) plane pairs, summed in float64 on their
    device (no host copy of a 2^26-point pair)."""
    num = sum(r.double().square().sum() for r in ref).item()
    den = sum((g.double() - r.double()).square().sum()
              for r, g in zip(ref, got)).item()
    return float("inf") if den == 0 else 10 * math.log10(num / den)


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


def stage_bound(base: str, b: int, n1: int, n2: int, ld: int = 4,
                st: int = 4):
    """bound_ms of what one launch of the stage kernel that computes
    ``base``'s function on (b, n1, n2) must do, loading ``ld``-byte and
    storing ``st``-byte plane elements: its data planes read once and
    written once, and the FFT operations of its lines. The twiddle
    products and the dense leaves' extra MACs are left out: they are this
    algorithm's, not the function's."""
    pts = b * n1 * n2
    nbytes = {"stage1": 2 * (ld + st) * pts, "stage2": 2 * (ld + st) * pts,
              "stage1_real": (ld + 2 * st) * pts,
              "stage2_half": 2 * ld * pts + 2 * st * b * (pts // b // 2 + 1),
              "col_fft": 16 * pts, "row_fft": 16 * pts}[base]
    m = n1 if base.startswith("stage1") or base == "col_fft" else n2
    return bound_ms(nbytes, fft_flops(
        pts, m, base in ("stage1_real", "stage2_half")))


def transform_bound(real: bool, b: int, n: int, elt: int = 4):
    """bound_ms of b transforms of length n on planes of ``elt`` bytes per
    element: input read once, output written once, 5 n log2 n operations
    per line (half for the rfft)."""
    nbytes = (b * elt * (n + 2 * (n // 2 + 1)) if real
              else 4 * elt * b * n)
    return bound_ms(nbytes, fft_flops(b * n, n, real))


def nd_bound(shape, axes=None):
    """bound_ms of a complex N-D transform of ``shape`` over ``axes``
    (default all): the planes read once and written once, and 5 m log2 m
    operations per line along each transformed axis."""
    pts = math.prod(shape)
    axes = range(len(shape)) if axes is None else axes
    return bound_ms(16 * pts, sum(fft_flops(pts, shape[a], False)
                                  for a in axes))


def time_ms(fn, runs=20, warm=3):
    """(median ms of single calls, device ms per call back-to-back, host
    ms per call enqueuing those back-to-back calls), by CUDA events after
    ``warm`` calls."""
    import torch
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


def graph_runs(points: int) -> int:
    """Calls per CUDA graph for an input of ``points`` points: 20, or 5
    above 2^22 points (the captured calls' intermediates stay
    allocated)."""
    return 20 if points <= 1 << 22 else 5


def graph_ms(fn, runs=20):
    """Device ms per call with no host time in it: ``runs`` calls captured
    in one CUDA graph (after three calls on a side stream), the mean of
    three replays; the allocator's cache is emptied after. Where the
    host's enqueue is slower than the device (small shapes), the
    back-to-back time of ``time_ms`` is the host's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(runs):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(3):
        g.replay()
    z.record()
    z.synchronize()
    del g
    torch.cuda.empty_cache()
    return a.elapsed_time(z) / (3 * runs)


def on_tier(tier, fn):
    """``fn`` run on precision tier ``tier`` (of the imported
    kofft_tpu_torch), the default restored after."""
    def run():
        import kofft_tpu_torch as kt
        kt.set_precision(tier)
        try:
            return fn()
        finally:
            kt.set_precision(None)
    return run


def ptxas_summary(log_text: str, key: str) -> dict:
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    the entry functions whose name holds ``key``, from ptxas -v output."""
    import re
    out, name, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and key in name:
            out[name] = (int(m.group(1)), *spills)
    return out


def dense_sass_counts(build) -> dict:
    """{instance: {"HGMMA": n, "FFMA": n}} of the dense pair's kernel
    instances (dense_tc_kernel<bf16, stage b>) in the library that
    ``build.lib()`` loaded, from ``cuobjdump -sass``."""
    so = build.build_info["path"]
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    names = {"ILb0ELb0E": "dense_stage_a", "ILb0ELb1E": "dense_stage_b",
             "ILb1ELb0E": "dense_stage_a_bf16x1",
             "ILb1ELb1E": "dense_stage_b_bf16x1"}
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = next((v for k, v in names.items()
                       if "dense_tc_kernel" + k in line), None)
            if fn is not None:
                counts[fn] = {"HGMMA": 0, "FFMA": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    return counts


# the Goertzel recurrence's dependent chain: three float32 operations per
# sample (multiply, add, subtract, no contraction), each waiting for the
# one before; a dependent FP32 operation starts 4 cycles after its input
# on Hopper's FMA pipe (as on every NVIDIA architecture since Volta)
CHAIN_OPS = 3
CHAIN_CYCLES = 4


def stft_oracle(x, w, hop, onesided, frames=None):
    """float64 numpy STFT of the 1-D signal ``x``: frame f covers [f*hop,
    f*hop + win) of the zero-extended signal; ``frames`` picks some."""
    n, win = x.size, w.size
    nf = -(-n // hop)
    pad = np.zeros((nf - 1) * hop + win)
    pad[:n] = x
    f = np.arange(nf) if frames is None else np.asarray(frames)
    seg = pad[f[:, None] * hop + np.arange(win)[None, :]] * w
    return np.fft.rfft(seg) if onesided else np.fft.fft(seg)


def mel_oracle(n_mags: int, sample_rate: float, num_filters: int):
    """float64 (n_mags, num_filters) triangular mel weights: filter m rises
    over bins [b(m-1), b(m)) and falls over [b(m), b(m+1)), with the bin
    edges b = floor(f * (n_mags + 1) / sample_rate) of num_filters + 2
    frequencies equally spaced in mel from 0 to sample_rate / 2; a filter
    with two equal edges is left out (all zero)."""
    mel_max = 2595.0 * np.log10(1.0 + sample_rate / 2.0 / 700.0)
    mel = mel_max * np.arange(num_filters + 2) / (num_filters + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    b = np.floor(hz * (n_mags + 1.0) / sample_rate).astype(np.int64)
    lo, mid, hi = b[:-2], b[1:-1], b[2:]
    k = np.arange(n_mags)[:, None]
    up = (k - lo) / np.maximum(mid - lo, 1)
    down = (hi - k) / np.maximum(hi - mid, 1)
    w = np.where((k >= lo) & (k < mid), up, 0.0) + np.where(
        (k >= mid) & (k < hi), down, 0.0)
    w[:, (mid == lo) | (hi == mid)] = 0.0
    return w


def phase_signal(dev, smi) -> dict:
    """Phase 7: the STFT, its streams and the composite transforms at the
    JAX bench's shapes; returns the goertzel_scan kernel's record."""
    import torch
    import torch.nn.functional as F
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.ops import goertzel as GZ
    from kofft_tpu_torch.ops import hopper_kernels as HK
    from kofft_tpu_torch.ops import stft as ST
    from kofft_tpu_torch.ops.window import hann

    log("== phase 7: the signal-processing entries on the card")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    stage = ("stage1", "stage2", "stage1_real", "stage2_half")

    def sig(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return a.astype(np.float64), torch.as_tensor(a, device=dev)

    def h(r, i=None):
        r = r.detach().double().cpu().numpy()
        return r if i is None else r + 1j * i.detach().double().cpu().numpy()

    def counts():
        return {k: HK.launches[k] for k in stage}

    def check(name, s, floor, before=None, keys=()):
        after = counts()
        grew = all(after[k] > before[k] for k in keys) if keys else True
        grown = ", ".join(f"{k} +{after[k] - before[k]}" for k in keys)
        log(f"{name}: {s:.2f} dB (floor {floor})"
            + (f", launches {grown}" if keys else ""))
        assert s >= floor and grew, (name, s, floor, before, after)

    HK.reset_counts()
    GZ.launches["goertzel_scan"] = 0

    # 1. the bench shape: 2^20 samples, hann(1024), hop 256, 4096 frames;
    # under auto the plain factor tree, no kernel
    log("-- STFT at the bench shape (2^20 samples, hann(1024), hop 256)")
    x1n, x1 = sig(1 << 20)
    w1 = hann(1024)
    one1 = kt.stft_split(x1, w1, 256, onesided=True)
    full1 = kt.stft_split(x1, w1, 256)
    check("stft one-sided vs float64", snr_db(
        stft_oracle(x1n, w1.astype(np.float64), 256, True), h(*one1)),
        FLOOR_DB)
    check("stft full vs float64", snr_db(
        stft_oracle(x1n, w1.astype(np.float64), 256, False), h(*full1)),
        FLOOR_DB)
    for tier in ("highest", "default"):
        back = on_tier(tier, lambda: kt.istft_split(*full1, w1, 256,
                                                    length=1 << 20))()
        check(f"istft interior on `{tier}`", snr_db(
            x1n[1024:-1024], h(back)[1024:-1024]), 90.0)
    assert not any(counts().values()), counts()
    log("bench-shape STFT/ISTFT launched no kernel (plain factor tree)")

    # 2. a long recording: 2^24 samples, hann(4096), hop 1024, 16384 frames
    # (256 MB of frames; the torch.fft zone under auto); every 64th frame
    # against float64
    log("-- STFT of 2^24 samples, hann(4096), hop 1024")
    x2n, x2 = sig(1 << 24)
    w2 = hann(4096)
    sel = np.arange(0, 1 << 14, 64)
    one2 = kt.stft_split(x2, w2, 1024, onesided=True)
    check("stft one-sided, every 64th frame, vs float64", snr_db(
        stft_oracle(x2n, w2.astype(np.float64), 1024, True, sel),
        h(one2[0][sel], one2[1][sel])), FLOOR_DB)
    del one2
    full2 = kt.stft_split(x2, w2, 1024)
    back2 = kt.istft_split(*full2, w2, 1024, length=1 << 24)
    check("istft interior", snr_db(x2n[4096:-4096], h(back2)[4096:-4096]),
          90.0)
    del x2, full2, back2, x2n

    # 3. the kernel path: 2^22 samples, hann(16384), hop 4096, 1024 frames
    log("-- STFT of 2^22 samples, hann(16384), hop 4096, backend='cuda'")
    x3n, x3 = sig(1 << 22)
    w3 = hann(1 << 14)
    sel = np.arange(0, 1024, 16)
    b = counts()
    one3 = kt.stft_split(x3, w3, 4096, onesided=True, backend="cuda")
    check("stft one-sided (stage1_real + stage2_half), every 16th frame",
          snr_db(stft_oracle(x3n, w3.astype(np.float64), 4096, True, sel),
                 h(one3[0][sel], one3[1][sel])), FLOOR_DB, b,
          ("stage1_real", "stage2_half"))
    b = counts()
    full3 = kt.stft_split(x3, w3, 4096, backend="cuda")
    check("stft full (stage1 + stage2), every 16th frame", snr_db(
        stft_oracle(x3n, w3.astype(np.float64), 4096, False, sel),
        h(full3[0][sel], full3[1][sel])), FLOOR_DB, b, ("stage1", "stage2"))
    b = counts()
    back3 = kt.istft_split(*full3, w3, 4096, length=1 << 22, backend="cuda")
    check("istft interior (the complex pair inverse)", snr_db(
        x3n[1 << 14:-(1 << 14)], h(back3)[1 << 14:-(1 << 14)]), 90.0, b,
        ("stage1", "stage2"))
    del one3, back3

    # 4. the streams at the bench shape against the offline entries
    log("-- streams at the bench shape")
    def peak_mib(fn):
        """(result, peak device memory allocated above the inputs, MiB)"""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = fn()
        torch.cuda.synchronize()
        return got, (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    frame_mib = 4096 * 1024 * 4 / 2 ** 20
    for name, fn, offline in (
            ("stft_stream_scan", lambda: kt.stft_stream_scan(x1, w1, 256),
             lambda: kt.stft_split(x1, w1, 256)),
            ("istft_stream_scan",
             lambda: (kt.istft_stream_scan(*full1, w1, 256),),
             lambda: (kt.istft_split(*full1, w1, 256),))):
        want, peak_off = peak_mib(offline)
        got, peak = peak_mib(fn)
        log(f"{name}: peak device memory {peak:.1f} MiB above the inputs "
            f"(the offline entry {peak_off:.1f} MiB), beside the (4096, "
            f"1024) frame matrix's {frame_mib:.1f} MiB")
        check(f"{name} vs offline", snr_db(h(*want), h(*got)), 110.0)
        del want, got
    st = ST.StftPushStream(w1, 256, device=dev)
    parts = [st.push(x1[i: i + 4800]) for i in range(0, 1 << 20, 4800)]
    parts.append(st.flush())
    check(f"StftPushStream, {len(parts) - 1} pushes of 4800 samples + "
          f"flush, vs stft_split", snr_db(h(*full1), h(
              torch.cat([p[0] for p in parts]),
              torch.cat([p[1] for p in parts]))), 110.0)
    ist = ST.IstftStream(1024, 256, w1, device=dev)
    pushed = np.concatenate([ist.push_frame(full1[0][f], full1[1][f])
                             for f in range(64)] + [ist.flush()])
    check("64 IstftStream.push_frame + flush vs istft", snr_db(
        h(kt.istft_split(full1[0][:64], full1[1][:64], w1, 256)), pushed),
        110.0)

    # 5. the composite transforms at 2^20 (DST-I at 2^20 - 1, so that its
    # m = 2(n+1) is a kernel size): float64 numpy oracles by the same
    # identities, each through the stage kernels under auto
    log("-- composite transforms at 2^20")
    n = 1 << 20
    xn, x = sig(n)
    k = np.arange(n)
    c = np.exp(-1j * np.pi * k / (2 * n))
    q = np.exp(-1j * np.pi * (2 * k + 1) / (4 * n))
    f2 = np.fft.fft(xn, 2 * n)[:n + 1]
    xp = xn.copy()
    xp[0] *= 0.5
    fc = np.fft.fft(xn * c, 2 * n)[:n]
    real, cplx = ("stage1_real", "stage2_half"), ("stage1", "stage2")
    d1n, d1 = sig(n - 1)
    ext = np.concatenate([[0.0], d1n, [0.0], -d1n[::-1]])
    cases = (
        ("dct2", lambda: kt.dct2(x), np.real(c * f2[:n]), real),
        ("dct3", lambda: kt.dct3(x),
         np.real(np.fft.fft(xp * c, 2 * n)[:n]), cplx),
        ("dct4", lambda: kt.dct4(x), np.real(q * fc), cplx),
        ("dst1 (n = 2^20 - 1)", lambda: kt.dst1(d1),
         -0.5 * np.imag(np.fft.rfft(ext))[1:n], real),
        ("dst2", lambda: kt.dst2(x),
         -np.imag(np.exp(-1j * np.pi * (k + 1) / (2 * n)) * f2[1:]), real),
        ("dst4", lambda: kt.dst4(x), -np.imag(q * fc), cplx))
    for name, fn, ref, keys in cases:
        b = counts()
        check(f"{name} vs float64", snr_db(ref, h(fn())), FLOOR_DB, b, keys)
    for t in (2, 3, 4):
        b = counts()
        check(f"idct(dct(x, {t}), {t}) vs x",
              snr_db(xn, h(kt.idct(kt.dct(x, t), t))), FLOOR_DB, b,
              ("stage1",))
    del f2, fc, ext, d1
    f = np.fft.fft(xn)
    g = np.zeros(n)
    g[0] = g[n // 2] = 1.0
    g[1: n // 2] = 2.0
    for name, fn, ref in (
            ("dht", lambda: h(kt.dht(x)), f.real - f.imag),
            ("hilbert_analytic", lambda: kt.hilbert_analytic(x).cpu()
             .numpy(), np.fft.ifft(f * g)),
            ("real_cepstrum", lambda: h(kt.real_cepstrum(x)),
             np.fft.ifft(np.log(np.abs(f) + 1e-12)).real)):
        b = counts()
        check(f"{name} vs float64", snr_db(ref, fn()), FLOOR_DB, b, cplx)
    bins = [1, 4097, 99991, n // 2]
    check("goertzel_bins vs the float64 DFT bins", snr_db(
        np.abs(f[bins]), h(kt.goertzel_bins(x, bins))), FLOOR_DB)
    del f, g
    xz = x[: 10 ** 6]
    wz, az = np.exp(-2j * np.pi * 0.25 / 4096), np.exp(2j * np.pi * 0.1)
    b = counts()
    got = kt.czt_fast(xz, 4096, wz, az).cpu().numpy()
    check("czt_fast n = 10^6, m = 4096 (L = 2^20) vs czt_fast on float64",
          snr_db(kt.czt_fast(xz.double(), 4096, wz, az).cpu().numpy(), got),
          FLOOR_DB, b, cplx)
    mags = torch.sqrt(one1[0] ** 2 + one1[1] ** 2)
    mel = mel_oracle(513, 48000.0, 40)
    i40 = np.arange(40)
    d40 = np.cos(np.pi * (i40[:, None] + 0.5) * i40[None, :] / 40)
    ref = (np.log(h(mags) @ mel + 1e-12) @ d40)[:, :13]
    check("mfcc of the bench-shape magnitudes (40 mel, 13 coefficients)",
          snr_db(ref, h(kt.mfcc(mags, 48000.0, 40, 13))), FLOOR_DB)
    xwn, xw = sig(1 << 24)
    a, d = kt.dwt(xw, "db4")
    check("idwt(dwt(x, db4)) at 2^24 vs x",
          snr_db(xwn, h(kt.idwt(a, d, "db4"))), FLOOR_DB)
    a, ds = kt.dwt_multi(xw, 4, "db4")
    check("idwt_multi(dwt_multi(x, 4 levels, db4)) at 2^24 vs x",
          snr_db(xwn, h(kt.idwt_multi(a, ds, "db4"))), FLOOR_DB)
    del xw, xwn, a, d, ds

    # 6. goertzel_scan at (64, 2^20) through the public entry
    log("-- goertzel_scan")
    rows, n = 64, 1 << 20
    xgn, xg = sig(rows, n)
    sr, tone = 48000.0, 1000.0
    kb = int(math.floor(tone * n / sr))
    mag = h(kt.goertzel_scan(xg, sr, tone))
    ang = 2 * np.pi * kb * np.arange(n) / n
    ref = np.hypot(xgn @ np.cos(ang), xgn @ np.sin(ang))
    rel = float(np.max(np.abs(mag - ref) / ref))
    log(f"goertzel_scan (64, 2^20), bin {kb}: max relative error "
        f"{rel:.3e} against the float64 DFT magnitude (the reference "
        f"test's floor: 1e-3 at n = 256)")
    assert np.all(np.isfinite(mag)) and mag.shape == (rows,)
    launches = {**counts(), **GZ.launches}
    log(f"signal path counts: launches {launches}")
    assert launches["goertzel_scan"] > 0

    # the kernel against its plain version: the public entry's output at
    # (64, 2^20) against the plain loop on a host copy, then a launch at
    # (64, 4096) against the plain loop on the card (neither counted above)
    coeff_l = float(np.float32(2 * math.cos(2 * math.pi * kb / n)))
    t0 = time.perf_counter()
    plain_l = h(GZ.scan_rows_plain(xg.cpu(), coeff_l))
    errl = float(np.max(np.abs(mag - plain_l)))
    rell = float(np.max(np.abs(mag - plain_l) / np.abs(plain_l)))
    log(f"goertzel_scan (64, 2^20) kernel vs plain (host loop, "
        f"{time.perf_counter() - t0:.1f} s): max abs {errl:.3e}, max "
        f"relative {rell:.3e}")
    assert rell <= 1e-5, rell
    xs = xg[:, :4096].contiguous()
    coeff = float(np.float32(2 * math.cos(2 * math.pi * 85 / 4096)))
    kern, plain = GZ.scan_rows(xs, coeff), GZ.scan_rows_plain(xs, coeff)
    err = float((kern - plain).abs().max())
    relk = float(((kern - plain).abs() / plain.abs()).max())
    log(f"goertzel_scan (64, 4096) kernel vs plain: max abs {err:.3e}, "
        f"max relative {relk:.3e}")
    assert relk <= 1e-5, relk
    err = max(err, errl)

    # 7. timing: frames per second of stft_split (one-sided, the JAX
    # bench's stft_frames) and istft_split (its istft_frames) at the bench
    # shape and on the kernel path, beside torch.stft / torch.istft
    log("-- timing (CUDA events after 3 warm-up calls)")
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    for label, xx, w, hop, backend in (
            ("bench shape, auto", x1, w1, 256, None),
            ("kernel path, backend='cuda'", x3, w3, 4096, "cuda")):
        nsig, win = xx.numel(), w.size
        nf = ST.num_frames(nsig, hop)
        runs = graph_runs(nf * win)
        fr, fi = kt.stft_split(xx, w, hop, backend=backend)
        wt = torch.as_tensor(w, device=dev)
        xpad = F.pad(xx, (0, (nf - 1) * hop + win - nsig))
        spec = torch.complex(fr, fi).T.contiguous()
        # torch.istft reads its window envelope's minimum back to the
        # host, which a CUDA graph cannot capture: back to back only
        for what, fn, graph in (
                ("stft_split (one-sided)",
                 lambda: kt.stft_split(xx, w, hop, onesided=True,
                                       backend=backend), True),
                ("torch.stft (center=False, padded signal)",
                 lambda: torch.stft(xpad, win, hop, win, wt, center=False,
                                    onesided=True, return_complex=True),
                 True),
                ("istft_split",
                 lambda: kt.istft_split(fr, fi, w, hop, length=nsig,
                                        backend=backend), True),
                ("torch.istft (center=True: center=False refuses a window "
                 "whose envelope is 0 at sample 0)",
                 lambda: torch.istft(spec, win, hop, win, wt, center=True,
                                     onesided=False), False)):
            t = time_ms(fn)
            g = (f", graph {graph_ms(fn, runs) * 1e3:.1f} us/call"
                 if graph else "")
            log(f"{label} ({nf} frames of {win}): {what}: back-to-back "
                f"{t[1] * 1e3:.1f} us/call = {nf / (t[1] * 1e-3):.4e} "
                f"frames/s, host enqueue {t[2] * 1e3:.1f} us/call{g} "
                f"[{smi}]")
        del fr, fi, spec, xpad

    def chain_bound(r, m):
        return bound_ms(4 * r * m + 4 * r, 0.0)[0], \
            CHAIN_OPS * m * CHAIN_CYCLES / (clock * 1e6) * 1e3

    out = {}
    for shape, xx in (((64, 4096), xs), ((64, 1 << 20), xg)):
        kb_ = lambda: GZ.scan_rows(xx, coeff)  # noqa: E731
        t = time_ms(kb_)
        g = graph_ms(kb_, 5)
        by_bytes, by_chain = chain_bound(*shape)
        bd = max(by_bytes, by_chain)
        log(f"{shape} goertzel_scan kernel: back-to-back {t[1] * 1e3:.1f} "
            f"us/call, graph {g * 1e3:.1f} us/call; bound {bd * 1e3:.2f} us "
            f"(the dependent chain of {CHAIN_OPS} x {shape[1]} float32 "
            f"operations at {CHAIN_CYCLES} cycles and {clock:.0f} MHz; the "
            f"bytes {by_bytes * 1e3:.2f} us) [{smi}]")
        out[shape] = (t, g, bd)
    tp = time_ms(lambda: GZ.scan_rows_plain(xs, coeff), runs=3, warm=1)
    gp = graph_ms(lambda: GZ.scan_rows_plain(xs, coeff), 1)
    log(f"(64, 4096) goertzel_scan plain version: back-to-back "
        f"{tp[1] * 1e3:.1f} us/call, graph {gp * 1e3:.1f} us/call [{smi}]")
    log(f"phase 7 took {time.perf_counter() - t_phase:.1f} s")
    (t, g, bd), (tl, gl, bdl) = out[(64, 4096)], out[(64, 1 << 20)]
    return {"launches": launches["goertzel_scan"], "max_abs_err": err,
            "ms": t[1], "plain_ms": tp[1], "bound_ms": bd,
            "bound_by": "operations", "library_ms": None, "graph_ms": g,
            "plain_graph_ms": gp, "library_graph_ms": None,
            "shape": [64, 4096],
            "long": {"shape": [64, 1 << 20], "ms": tl[1], "graph_ms": gl,
                     "bound_ms": bdl, "bound_by": "operations"}}


def spectral_net_oracle(params, x, win, hop):
    """float64 numpy SpectralNet forward of the (B, N) signal ``x`` with
    ``params`` = (mel, w_head, b_head): one-sided STFT with a periodic
    Hann window, sqrt(|X|^2 + 1e-12), the mel product, log(|.| + 1e-6),
    the DCT-II matrix cos(pi (m + 1/2) c / M), the mean over frames and
    the head."""
    mel, w_head, b_head = (np.asarray(p, np.float64) for p in params)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    m = mel.shape[1]
    dct = np.cos(np.pi * (np.arange(m)[:, None] + 0.5)
                 * np.arange(m)[None, :] / m)
    out = []
    for row in np.asarray(x, np.float64):
        spec = stft_oracle(row, w, hop, True)
        mags = np.sqrt(np.abs(spec) ** 2 + 1e-12)
        feats = np.log(np.abs(mags @ mel) + 1e-6) @ dct
        out.append(feats.mean(axis=0) @ w_head + b_head)
    return np.stack(out)


def close_rows(got, want):
    """RGBA rows of two FFT engines: within 1 LSB and at most 1 byte in
    1000 apart (a float32 rounding can move a value on a u8 boundary)."""
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    return (d.shape == np.shape(want) and d.max(initial=0) <= 1
            and np.count_nonzero(d) <= max(1, d.size // 1000))


def phase_models(dev, smi) -> dict:
    """Phase 8: the models' serving path and the spectrogram server on the
    card; returns the phase's record."""
    import urllib.request

    import torch
    import torch.nn.functional as F
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.entry import entry
    from kofft_tpu_torch.models import SpectralDenoiser, SpectralNet
    from kofft_tpu_torch.models import convert
    from kofft_tpu_torch.models.denoiser import SpectralDenoiserParams
    from kofft_tpu_torch.models.spectral_net import SpectralNetParams
    from kofft_tpu_torch.ops import goertzel as GZ
    from kofft_tpu_torch.ops import hopper_kernels as HK
    from kofft_tpu_torch.visual import stft_magnitudes
    from kofft_tpu_torch.web import StreamingSpectrogram
    from kofft_tpu_torch.web.server import serve_background

    log("== phase 8: the models and the server on the card")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 8)
    rec = {"card": smi}
    HK.reset_counts()
    GZ.launches["goertzel_scan"] = 0

    # 1. entry(): the flagship forward at the JAX entry's arguments
    fn, args = entry()
    assert all(a.is_cuda for a in args)
    with torch.no_grad():
        got = fn(*args)
    assert got.is_cuda and got.shape == (4, 8)
    got = got.double().cpu().numpy()
    fc, ac = entry("cpu")
    with torch.no_grad():
        on_cpu = fc(*ac).double().numpy()
    oracle = spectral_net_oracle([a.cpu().numpy() for a in args[:3]],
                                 args[3].cpu().numpy(), 256, 128)
    rec["entry"] = {"snr_vs_cpu_db": snr_db(on_cpu, got),
                    "snr_vs_float64_db": snr_db(oracle, got)}
    log(f"entry() logits (4, 8): {rec['entry']['snr_vs_cpu_db']:.2f} dB "
        f"against the port on the CPU, "
        f"{rec['entry']['snr_vs_float64_db']:.2f} dB against float64 "
        f"(floor 90)")
    assert np.all(np.isfinite(got))
    assert min(rec["entry"].values()) >= 90.0, rec["entry"]

    # 2. both models at a serving batch: 256 one-second clips at 16 kHz,
    # weights drawn from the seed (the denoiser's w2 and b2 too: at init
    # its mask is the constant sigmoid(2))
    batch, n, win, hop = 256, 16000, 256, 128
    x = torch.as_tensor(rng.standard_normal((batch, n), dtype=np.float32),
                        device=dev)
    xc = x.cpu()
    net, den = SpectralNet(), SpectralDenoiser()
    p0 = net.init(0)
    convert.load_into(net, SpectralNetParams(
        p0.mel + 0.01 * rng.standard_normal(p0.mel.shape, np.float32),
        rng.standard_normal(p0.w_head.shape, np.float32),
        rng.standard_normal(p0.b_head.shape, np.float32)))
    d0 = den.init(0)
    convert.load_into(den, SpectralDenoiserParams(
        d0.w1, 0.1 * rng.standard_normal(d0.b1.shape, np.float32),
        rng.standard_normal(d0.w2.shape, np.float32) / 8,
        rng.standard_normal(d0.b2.shape, np.float32)))
    rec["models"] = {}
    for name, model, cls in (("SpectralNet", net, SpectralNet),
                             ("SpectralDenoiser", den, SpectralDenoiser)):
        assert all(p.is_cuda for p in model.parameters())
        cpu = cls(device="cpu")
        cpu.load_state_dict({k: v.cpu()
                             for k, v in model.state_dict().items()})
        with torch.no_grad():
            y = model(x)
            want = cpu(xc).double().numpy()
        assert y.is_cuda and torch.isfinite(y).all()
        y = y.double().cpu().numpy()
        if name == "SpectralDenoiser":
            y, want = y[:, win:-win], want[:, win:-win]
        s = snr_db(want, y)
        log(f"{name} ({batch}, {n}): {s:.2f} dB against the port on the "
            f"CPU (floor 90{', interior' if name != 'SpectralNet' else ''})")
        assert s >= 90.0, (name, s)

        def fwd(m=model):
            with torch.no_grad():
                return m(x)
        t = time_ms(fwd)
        g = graph_ms(fwd)
        rec["models"][name] = {
            "snr_vs_cpu_db": s, "ms": t[1], "graph_ms": g,
            "single_call_ms": t[0], "host_ms": t[2],
            "signals_per_s": batch / (t[1] * 1e-3),
            "graph_signals_per_s": batch / (g * 1e-3)}
        log(f"{name} forward ({batch}, {n}): back-to-back {t[1] * 1e3:.1f} "
            f"us/call ({batch / (t[1] * 1e-3):.4e} signals/s), graph "
            f"{g * 1e3:.1f} us/call ({batch / (g * 1e-3):.4e} signals/s), "
            f"single call {t[0] * 1e3:.1f} us, host enqueue "
            f"{t[2] * 1e3:.1f} us/call [{smi}]")
    # context, not a claim: the forward's STFT alone and torch.stft at the
    # same frames (center=False on the zero-padded signal)
    nf = -(-n // hop)
    wt = torch.as_tensor(net.window, device=dev)
    xpad = F.pad(x, (0, (nf - 1) * hop + win - n))
    for what, f in (
            ("stft_split (one-sided, SpectralNet's)",
             lambda: kt.stft_split(x, net.window, hop, onesided=True,
                                   backend="torch")),
            ("stft_split (two-sided, the denoiser's)",
             lambda: kt.stft_split(x, den.window, hop)),
            ("torch.stft (center=False, padded signal)",
             lambda: torch.stft(xpad, win, hop, win, wt, center=False,
                                onesided=True, return_complex=True))):
        t = time_ms(f)
        g = graph_ms(f)
        rec["models"].setdefault("context", {})[what] = {
            "ms": t[1], "graph_ms": g, "host_ms": t[2]}
        log(f"context: {what} ({batch} x {nf} frames of {win}): "
            f"back-to-back {t[1] * 1e3:.1f} us/call, graph "
            f"{g * 1e3:.1f} us/call, host enqueue {t[2] * 1e3:.1f} us/call "
            f"[{smi}]")
    del x, xc, xpad

    launches = {**HK.launches, **GZ.launches}
    log(f"models path counts: launches {launches}")
    # win 256 lies below the stage kernels (2^14 <= n): the plain factor
    # tree, as the JAX package takes its XLA engines there
    assert not any(launches.values()), launches
    rec["launches"] = {k: v for k, v in launches.items() if v}

    # 3. the server on the card (default device), called on 127.0.0.1
    srv, port = serve_background(0)
    url = f"http://127.0.0.1:{port}"
    lat = []

    def call(path, obj=None):
        data = None if obj is None else json.dumps(obj).encode()
        req = urllib.request.Request(
            url + path, data=data, method="GET" if obj is None else "POST",
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as r:
            body, status = r.read(), r.status
        lat.append({"request": path, "ms": (time.perf_counter() - t0) * 1e3})
        assert status == 200, (path, status)
        return json.loads(body) if obj is not None else body

    try:
        state = srv.RequestHandlerClass.state
        assert state.device.type == "cuda"
        ref = StreamingSpectrogram(device="cpu")
        call("/health")
        for i in range(4):
            s = rng.standard_normal(2048, dtype=np.float32)
            out = call("/api/compute_frame", {"samples": s.tolist()})
            want = ref.compute_frame(s)
            assert out["rows"] == want.size // (512 * 4), (i, out["rows"])
            assert close_rows(out["row"], want), i
        assert state._stream._buf.is_cuda
        s = rng.standard_normal(16384, dtype=np.float32)
        out = call("/api/stft", {"samples": s.tolist(), "win_len": 1024})
        want, want_max = stft_magnitudes(s, 1024, 512, device="cpu")
        mags = np.asarray(out["mags"])
        assert mags.shape == want.shape == (32, 512)
        stft_db = snr_db(want, mags)
        log(f"server /api/stft (16384 samples, win 1024): {stft_db:.2f} dB "
            f"against the port on the CPU (max abs difference "
            f"{np.abs(mags - want).max():.3e}, largest magnitude "
            f"{want_max:.3e}; floor 100); the four "
            f"compute_frame pushes painted the CPU state's rows (within "
            f"1 LSB)")
        assert stft_db >= 100.0
        assert call("/api/set_colormap", {"name": "viridis"})["ok"]
        assert call("/api/reset", {})["ok"]
    finally:
        srv.shutdown()
        srv.server_close()
    for r in lat:
        log(f"  {r['request']}: {r['ms']:.2f} ms (host clock, request to "
            f"response)")
    rec["server"] = {"requests": lat, "stft_snr_vs_cpu_db": stft_db}
    log(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return rec


def spectral_net_loss_f64(params, x, labels, win, hop):
    """(loss, [d loss / d mel, w_head, b_head]) of SpectralNet in float64 by
    torch autograd on the CPU: frames gathered by index from the
    zero-extended (B, N) signal ``x``, a periodic Hann window,
    torch.fft.rfft, sqrt(|X|^2 + 1e-12), the mel product, log(|.| + 1e-6)
    with |x| as where(x >= 0, x, -x) (JAX's derivative, +1 at 0), the
    DCT-II matrix cos(pi (m + 1/2) c / M), the mean over frames, the head,
    log-softmax and the mean cross-entropy against a one-hot built by
    comparison (a row of zeros outside [0, C))."""
    import torch
    f64 = torch.float64
    leaves = [torch.tensor(np.asarray(p, np.float64), requires_grad=True)
              for p in params]
    mel, w_head, b_head = leaves
    xs = torch.tensor(np.asarray(x, np.float64))
    n = xs.shape[-1]
    nf = -(-n // hop)
    pad = torch.zeros(xs.shape[0], (nf - 1) * hop + win, dtype=f64)
    pad[:, :n] = xs
    idx = torch.arange(nf)[:, None] * hop + torch.arange(win)[None, :]
    w = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(win, dtype=f64)
                              / win)
    spec = torch.fft.rfft(pad[:, idx] * w)
    mags = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)
    m = mags @ mel
    nm = mel.shape[1]
    dct = torch.cos(math.pi * (torch.arange(nm, dtype=f64)[:, None] + 0.5)
                    * torch.arange(nm, dtype=f64)[None, :] / nm)
    feats = torch.log(torch.where(m >= 0, m, -m) + 1e-6) @ dct
    logits = feats.mean(dim=1) @ w_head + b_head
    logp = torch.log_softmax(logits, dim=-1)
    onehot = (torch.as_tensor(np.asarray(labels))[:, None]
              == torch.arange(logits.shape[-1])).to(f64)
    loss = -(onehot * logp).sum(dim=-1).mean()
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), [g.numpy() for g in grads]


def denoiser_batch(rng, batch: int, n: int, win: int):
    """(noisy, clean) float32 (batch, n), tests/test_models.py's maskable
    objective for a batch: each clean signal a tone on a seeded bin
    (2 ... 31 cycles per win) with a seeded phase, plus an interferer of
    0.8 its amplitude on a seeded bin of the upper half (64 ... 119), so
    the two never share a bin."""
    t = np.arange(n)
    kc = rng.integers(2, 32, batch)[:, None]
    ki = rng.integers(64, 120, batch)[:, None]
    pc = rng.uniform(0, 2 * np.pi, batch)[:, None]
    pi = rng.uniform(0, 2 * np.pi, batch)[:, None]
    clean = np.sin(2 * np.pi * kc * t / win + pc).astype(np.float32)
    interf = (0.8 * np.sin(2 * np.pi * ki * t / win + pi)).astype(np.float32)
    return clean + interf, clean


def chirp_wav(path, seed: int, seconds: float = 10.0, rate: int = 16000):
    """A 16-bit mono WAV: a 100 Hz -> 7 kHz linear chirp, tones at 440 Hz
    and 3 kHz and seeded noise at 0.01."""
    import wave
    t = np.arange(int(seconds * rate)) / rate
    sweep = (7000.0 - 100.0) / (2 * seconds)
    x = (0.4 * np.sin(2 * np.pi * (100 * t + sweep * t * t))
         + 0.2 * np.sin(2 * np.pi * 440 * t)
         + 0.1 * np.sin(2 * np.pi * 3000 * t)
         + 0.01 * np.random.default_rng(seed).standard_normal(t.size))
    pcm = np.clip(np.round(x * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def spectrogram_f64(samples, win, colormap, scale_mode, dynamic_range):
    """The sanity-check CLI's RGB16 image of ``samples`` from a float64
    numpy STFT (periodic Hann, frames of the zero-extended signal every
    win/2), coloured as the CLI's ``render`` colours it."""
    from kofft_tpu_torch.visual.spectrogram import (
        Colormap, color_from_magnitude_u16, log_scale_bins)
    x = np.asarray(samples, np.float64)
    hop = h = win // 2
    nf = -(-x.size // hop)
    pad = np.zeros((nf - 1) * hop + win)
    pad[:x.size] = x
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    mags = np.abs(np.fft.rfft(
        pad[np.arange(nf)[:, None] * hop + np.arange(win)] * w))[:, :h]
    top = float(mags.max())
    if scale_mode == "log":
        mags = log_scale_bins(mags, h - 1)
    img = color_from_magnitude_u16(mags, top, -dynamic_range,
                                   Colormap.parse(colormap))
    return img.transpose(1, 0, 2)[::-1]


def level_diff(got, want):
    """(largest difference, share of pixels that differ) of two RGB
    images in colour levels 0 ... 255 (a 16-bit image's channels are the
    8-bit level times 257)."""
    def levels(img):
        return np.asarray(img).astype(np.int64) // (
            257 if np.asarray(img).dtype == np.uint16 else 1)
    d = np.abs(levels(got) - levels(want))
    return (int(d.max(initial=0)),
            np.count_nonzero(d.any(axis=-1)) / d[..., 0].size)


def grad_snrs(want, got, fields) -> dict:
    """{field: snr_db} of two lists of gradient (or parameter) arrays."""
    return {f: snr_db(np.asarray(w, np.float64), np.asarray(g, np.float64))
            for f, w, g in zip(fields, want, got)}


def step_times(step, batch: int, smi: str) -> dict:
    """A training step timed by CUDA events after 3 warm-up steps: back to
    back with its host enqueue (``time_ms``), and as a CUDA graph of 10
    steps (``graph_ms``) where the step captures (else None with the
    reason); µs per step and signals per second."""
    t = time_ms(step)
    try:
        g, why = graph_ms(step, runs=10), None
    except Exception as e:   # a step that syncs or allocates on the host
        import torch
        torch.cuda.synchronize()
        g, why = None, f"{type(e).__name__}: {str(e).splitlines()[0]}"
    rec = {"us": t[1] * 1e3, "single_call_us": t[0] * 1e3,
           "host_enqueue_us": t[2] * 1e3,
           "signals_per_s": batch / (t[1] * 1e-3),
           "graph_us": None if g is None else g * 1e3,
           "graph_signals_per_s": None if g is None else batch / (g * 1e-3),
           "graph_failed": why, "card": smi}
    log(f"  step: back-to-back {rec['us']:.1f} us ({rec['signals_per_s']:.4e}"
        f" signals/s), host enqueue {rec['host_enqueue_us']:.1f} us, single "
        f"call {rec['single_call_us']:.1f} us, graph "
        + ("not captured: " + why if g is None else
           f"{rec['graph_us']:.1f} us ({rec['graph_signals_per_s']:.4e} "
           f"signals/s)") + f" [{smi}]")
    return rec


def phase_training(dev, smi, batch: int = 256, kernel_batch: int = 16) \
        -> dict:
    """Phase 9: the models' training on the card (SpectralNet and the
    denoiser at the entry widths on ``batch`` one-second clips, the
    denoiser through the stage kernels' backward at win 2^14 on
    ``kernel_batch`` signals of 2^18) and the sanity-check CLI; returns the
    phase's record. Smaller batches serve a rehearsal."""
    import os
    import torch
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.cli.sanity_check import render
    from kofft_tpu_torch.models import (SpectralDenoiser, SpectralNet,
                                        denoiser_train_step, train_step)
    from kofft_tpu_torch.models import denoiser as TD
    from kofft_tpu_torch.models import spectral_net as TS
    from kofft_tpu_torch.ops import goertzel as GZ
    from kofft_tpu_torch.ops import hopper_kernels as HK
    from kofft_tpu_torch.utils.audio import read_audio
    from kofft_tpu_torch.utils.image import decode_png

    log("== phase 9: the models' training on the card")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    rec = {"card": smi}
    n = 16000

    def grads(loss, model, params, a, b):
        """(loss, gradients as float64 numpy) of ``loss`` at ``params`` on
        the model's device."""
        leaves = type(params)(*(torch.as_tensor(np.asarray(p),
                                                device=model.device)
                                .requires_grad_() for p in params))
        lv = loss(model, leaves, a, b)
        gs = torch.autograd.grad(lv, leaves)
        return lv.item(), [g.double().cpu().numpy() for g in gs]

    def hold(what, want, got, fields, floor_of=None):
        """SNRs of loss and gradients; each at its floor unless only
        recorded (``floor_of`` None)."""
        s = grad_snrs(want[1], got[1], fields)
        s["loss"] = snr_db(want[0], got[0])
        log(f"  {what}: " + ", ".join(f"{k} {v:.2f} dB" for k, v in
                                      s.items()))
        for k, v in s.items():
            assert floor_of is None or v >= floor_of(k), (what, k, v)
        return s

    def no_launch():
        launches = {**HK.launches, **GZ.launches}
        assert not any(launches.values()), launches

    # (a) SpectralNet at the entry widths from init(0) (6 of its 32 mel
    # bands empty: the |x| derivative at 0), labels seeded
    net, net_cpu = SpectralNet(), SpectralNet(device="cpu")
    p0 = net.init(0)
    assert np.count_nonzero(~p0.mel.any(axis=0)) == 6
    x_host = rng.standard_normal((batch, n), dtype=np.float32)
    y_host = rng.integers(0, 8, batch).astype(np.int32)
    x, y = torch.as_tensor(x_host, device=dev), torch.as_tensor(
        y_host, device=dev)
    HK.reset_counts()
    GZ.launches["goertzel_scan"] = 0
    on_card = grads(TS.loss_fn, net, p0, x, y)
    on_cpu = grads(TS.loss_fn, net_cpu, p0, x_host, y_host)
    oracle = spectral_net_loss_f64(p0, x_host, y_host, 256, 128)
    fields = list(p0._fields)

    def net_floor(k):
        return {"loss": 110.0, "mel": 80.0}.get(k, 100.0)
    log(f"SpectralNet step 0 at ({batch}, {n}), init(0), loss "
        f"{on_card[0]:.6f} (floors: loss 110, mel 80, others 100 dB)")
    a = {"vs_cpu_db": hold("card vs the port on the CPU", on_cpu, on_card,
                           fields, net_floor),
         "vs_float64_db": hold("card vs float64", oracle, on_card, fields,
                               net_floor),
         "cpu_vs_float64_db": grad_snrs(oracle[1], on_cpu[1], fields)}
    # 10 steps at lr 1e-3 on the card. Each step is held against the CPU
    # port's step from the same parameters (the card's before it). The
    # free-running trajectories are recorded, not held: from init(0) the
    # float32 steps leave a float64 run after 3-5 steps (the log-mel's
    # |x| kink and a saturated softmax amplify rounding; ROADMAP C.3)
    pg, pc, p64, losses = p0, p0, [np.asarray(q, np.float64) for q in p0], []
    forced = []
    for _ in range(10):
        nxt, lv = train_step(net, pg, x, y, 1e-3)
        want, wl = train_step(net_cpu, pg, x_host, y_host, 1e-3)
        forced.append(grad_snrs([q.double().numpy() for q in want],
                                [q.double().cpu().numpy() for q in nxt],
                                fields))
        forced[-1]["loss"] = snr_db(wl.item(), lv.item())
        pg = nxt
        losses.append(lv.item())
        pc, _ = train_step(net_cpu, pc, x_host, y_host, 1e-3)
        g64 = spectral_net_loss_f64(p64, x_host, y_host, 256, 128)[1]
        p64 = [q - 1e-3 * g for q, g in zip(p64, g64)]
    assert all(math.isfinite(v) for v in losses), losses
    a["losses"] = losses
    a["step_vs_cpu_db"] = forced
    a["params_after_10_db"] = forced[-1]
    card_p = [q.double().cpu().numpy() for q in pg]
    a["free_run_after_10_db"] = {
        "card_vs_cpu": grad_snrs([q.double().numpy() for q in pc], card_p,
                                 fields),
        "card_vs_float64": grad_snrs(p64, card_p, fields),
        "cpu_vs_float64": grad_snrs(p64, [q.double().numpy() for q in pc],
                                    fields)}
    worst = min(min(v for k, v in f.items() if k != "loss") for f in forced)
    worst_loss = min(f["loss"] for f in forced)
    log(f"  10 steps at lr 1e-3: losses {losses[0]:.4f} ... "
        f"{losses[-1]:.4f}; each step against the CPU port's step from the "
        f"same parameters: parameters worst {worst:.2f} dB (floor 80), "
        f"loss worst {worst_loss:.2f} dB (floor 110); after 10 steps "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in forced[-1].items()))
    for what, snrs in a["free_run_after_10_db"].items():
        log(f"  free-running after 10 steps, {what} (recorded): "
            + ", ".join(f"{k} {v:.2f} dB" for k, v in snrs.items()))
    assert worst >= 80.0 and worst_loss >= 110.0, forced
    no_launch()
    pt = tuple(torch.as_tensor(q, device=dev) for q in p0)
    a["time"] = step_times(lambda: train_step(net, pt, x, y, 1e-3), batch,
                           smi)
    no_launch()
    rec["spectral_net"] = a
    del x, pt

    # (b) the denoiser at the entry widths: the maskable objective
    den, den_cpu = SpectralDenoiser(), SpectralDenoiser(device="cpu")
    d0 = den.init(0)
    noisy_h, clean_h = denoiser_batch(rng, batch, n, 256)
    noisy, clean = (torch.as_tensor(noisy_h, device=dev),
                    torch.as_tensor(clean_h, device=dev))
    HK.reset_counts()
    on_card = grads(TD.loss_fn, den, d0, noisy, clean)
    on_cpu = grads(TD.loss_fn, den_cpu, d0, noisy_h, clean_h)
    log(f"SpectralDenoiser step 0 at ({batch}, {n}), init(0), loss "
        f"{on_card[0]:.6f} (floors: loss 110, gradients 100 dB; w1 and b1 "
        f"are exactly 0 at init, w2 = 0)")
    b_rec = {"vs_cpu_db": hold("card vs the port on the CPU", on_cpu,
                               on_card, list(d0._fields),
                               lambda k: 110.0 if k == "loss" else 100.0)}
    pg, losses = d0, []
    for _ in range(60):
        pg, lv = denoiser_train_step(den, pg, noisy, clean, lr=1.0)
        losses.append(lv.item())
    b_rec["losses"] = losses
    log(f"  60 steps at lr 1: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
        f"({losses[-1] / losses[0]:.4f} of the first; must be < 0.3)")
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < 0.3 * losses[0], losses
    no_launch()
    dt = tuple(torch.as_tensor(q, device=dev) for q in d0)
    b_rec["time"] = step_times(
        lambda: denoiser_train_step(den, dt, noisy, clean, lr=1.0), batch,
        smi)
    no_launch()
    rec["denoiser"] = b_rec
    del noisy, clean, dt

    # (c) the kernel path: win 2^14, hop 2^13, (16, 2^18): 512 two-sided
    # frames of 2^14 per STFT and ISTFT through the stage kernels; weights
    # drawn off init (at init w1 and b1 get no gradient)
    win, kb, kn = 1 << 14, kernel_batch, 1 << 18
    big = SpectralDenoiser(win, win // 2, 64)
    k0 = big.init(0)
    kp = type(k0)(k0.w1,
                  0.1 * rng.standard_normal(k0.b1.shape, np.float32),
                  rng.standard_normal(k0.w2.shape, np.float32) / 8,
                  rng.standard_normal(k0.b2.shape, np.float32))
    kx = torch.as_tensor(rng.standard_normal((kb, kn), dtype=np.float32),
                         device=dev)
    kc = torch.as_tensor(rng.standard_normal((kb, kn), dtype=np.float32),
                         device=dev)
    c_rec, got = {}, {}
    try:
        for backend, tier in (("cuda", "highest"), ("torch", "highest"),
                              ("cuda", "default")):
            kt.set_backend(backend)
            kt.set_precision(tier)
            leaves = type(kp)(*(torch.as_tensor(q, device=dev)
                                .requires_grad_() for q in kp))
            HK.reset_counts()
            lv = TD.loss_fn(big, leaves, kx, kc)
            fwd = dict(HK.launches)
            HK.reset_counts()
            lv.backward()
            torch.cuda.synchronize()
            bwd = dict(HK.launches)
            got[backend, tier] = (lv.item(), [q.grad.double().cpu().numpy()
                                              for q in leaves])
            if backend == "cuda":
                for k in ("stage1", "stage2"):
                    assert fwd[k] > 0 and bwd[k] > 0, (tier, fwd, bwd)
                c_rec[f"launches_{tier}"] = {
                    "forward": {k: v for k, v in fwd.items() if v},
                    "backward": {k: v for k, v in bwd.items() if v}}
                log(f"kernel path ({kb}, {kn}), win {win}, {tier}: launches "
                    f"per step, forward {c_rec[f'launches_{tier}']['forward']}"
                    f", backward() {c_rec[f'launches_{tier}']['backward']}")
            else:
                assert not any(fwd.values()) and not any(bwd.values())
        fields = list(kp._fields)
        c_rec["vs_plain_db"] = hold(
            "backend cuda vs torch on the card, highest",
            got["torch", "highest"], got["cuda", "highest"], fields,
            lambda k: 100.0)
        c_rec["default_vs_highest_db"] = hold(
            "backend cuda, default vs highest (recorded)",
            got["cuda", "highest"], got["cuda", "default"], fields)
        kt.set_backend("cuda")
        kt.set_precision("highest")
        kpt = tuple(torch.as_tensor(q, device=dev) for q in kp)
        HK.reset_counts()
        c_rec["time"] = step_times(
            lambda: denoiser_train_step(big, kpt, kx, kc), kb, smi)
    finally:
        kt.set_backend(None)
        kt.set_precision(None)
    rec["kernel_path"] = c_rec
    del kx, kc

    # (d) the CLI on the card against the port's render on the CPU
    work = ROOT / "build" / "phase9"
    work.mkdir(parents=True, exist_ok=True)
    wav = work / "chirp.wav"
    chirp_wav(wav, SEED + 9)
    samples = read_audio(wav)[0]
    win_cli = 1024
    env = {k: v for k, v in os.environ.items()
           if k != "KOFFT_TPU_TORCH_PLATFORM"}
    d_rec = {}
    for name, flags, args in (
            ("defaults", [], (win_cli, "inferno", "linear", 120.0)),
            ("log16", ["--scale-mode", "log", "--png-depth", "sixteen",
                       "--colormap", "viridis"],
             (win_cli, "viridis", "log", 120.0))):
        out = work / f"{name}.png"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "kofft_tpu_torch.cli.sanity_check", str(wav),
                            str(out), *flags], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        assert r.returncode == 0, r.stderr
        img = decode_png(out.read_bytes())
        assert img.shape == (win_cli // 2, -(-samples.size * 2 // win_cli),
                             3), img.shape
        big, share = level_diff(img, render(samples, *args, device="cpu"))
        big64, share64 = level_diff(img, spectrogram_f64(samples, *args))
        d_rec[name] = {"wall_s": wall, "shape": list(img.shape),
                       "dtype": str(img.dtype), "max_level_diff": big,
                       "differing_pixel_share": share,
                       "vs_float64": {"max_level_diff": big64,
                                      "differing_pixel_share": share64}}
        log(f"CLI {name} on the card: {img.shape} {img.dtype}, wall "
            f"{wall:.2f} s (process start, torch import and the read "
            f"included); against the port's render on the CPU: max {big} "
            f"colour level, {share:.3e} of the pixels differ (must be "
            f"within 1 level); against the float64 render (recorded): max "
            f"{big64}, {share64:.3e}")
        assert big <= 1, name
    rec["cli"] = d_rec
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return rec


def phase_parallel(dev, smi, n_fft: int = 1 << 28, cube: int = 512,
                   n_stft: int = 1 << 26, n_auto: int = 1 << 26,
                   side: int = 8192, dryrun: int = 4) -> dict:
    """Phase 10: the parallel programs on the card, on a world of one
    NCCL rank on ``dev`` (NCCL refuses two ranks on one device, so the
    all_to_alls are device copies; the buffers, the NCCL calls, the local
    DFTs and the kernels are real, at full size). Every count is set to 0
    just before each driven call and read just after; the launches of the
    driven calls are the phase's ``sharded_launches`` (the timing loops
    are not counted). Returns (the phase's record, sharded_launches).
    Smaller sizes serve a rehearsal."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    import kofft_tpu_torch as kt
    from kofft_tpu_torch import parallel as P
    from kofft_tpu_torch.entry import dryrun_multichip
    from kofft_tpu_torch.ops import hopper_kernels as HK
    from kofft_tpu_torch.parallel import validate as V
    from kofft_tpu_torch.parallel.fft_sharded import _split_for_mesh
    from kofft_tpu_torch.plan import tables

    log("== phase 10: the parallel programs on the card (a world of one "
        "NCCL rank)")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    started = not dist.is_initialized()
    mesh = P.make_mesh(device=dev)
    hmesh = P.make_hier_mesh(1, 1, device=dev)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1, \
        (dist.get_backend(), dist.get_world_size())
    rec = {"card": smi, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "mesh": str(mesh),
           "hier_mesh": str(hmesh)}
    sharded = {k: 0 for k in HK.launches}

    def drive(fn):
        """(fn()'s planes as local tensors, its launches)."""
        torch.cuda.synchronize()
        HK.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in HK.launches.items() if v}
        for k, v in got.items():
            sharded[k] += v
        out = out if isinstance(out, tuple) else (out,)
        return tuple(p.to_local() if isinstance(p, DTensor) else p
                     for p in out), got

    def timed(label, fn, runs=3):
        t = time_ms(fn, runs=runs, warm=1)
        log(f"  {label}: single {t[0]:.3f} ms, back-to-back {t[1]:.3f} "
            f"ms/call (host enqueue {t[2]:.3f}) [{smi}]")
        return {"single_ms": t[0], "ms": t[1], "host_ms": t[2]}

    def held(label, ref, got, floor, launches):
        s = snr_db_card(ref, got)
        log(f"  {label}: {s:.2f} dB (floor {floor}), launches {launches}")
        assert s >= floor, (label, s)
        return {"snr_db": s, "launches": launches}

    def plane(shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=dev)

    # -- (a) the 1-D four-step at n_fft, (d) its hierarchical form ---------
    n = n_fft
    n1, n2 = _split_for_mesh(n, 1)
    log(f"(a) fft_sharded at n = {n} = {n1} x {n2} ({8 * n >> 20} MiB of "
        f"planes): its local DFTs run on the plain engine _fft_planes "
        f"whatever the backend, as kofft_tpu's do; the complex128 "
        f"torch.fft oracle on the card")
    xr, xi = plane(n), plane(n)
    big = torch.fft.fft(torch.complex(xr.double(), xi.double()))
    ref = (big.real, big.imag)
    a, d = {"n": n, "split": [n1, n2]}, {}

    def digits(p):                      # [k1, k2] holds X[k1 + n1 k2]
        return p.reshape(n1, n2).t().reshape(n)

    for restore, k in ((False, 1), (True, 1), (True, 4)):
        (yr, yi), got = drive(lambda: P.fft_sharded(
            xr, xi, mesh=mesh, restore_layout=restore, overlap=k))
        if not restore:
            yr, yi = digits(yr), digits(yi)
        a[f"forward restore={restore} overlap={k}"] = held(
            f"fft_sharded restore_layout={restore} overlap={k}", ref,
            (yr, yi), FLOOR_DB, got)
        assert not got, "the 1-D sharded program launched a kernel"
        del yr, yi
    for k in (1, 4):
        (yr, yi), got = drive(lambda: P.fft_sharded_hier(
            xr, xi, mesh=hmesh, overlap=k))
        d[f"fft_sharded_hier n={n} overlap={k}"] = held(
            f"(d) fft_sharded_hier (1, 1) overlap={k}", ref, (yr, yi),
            FLOOR_DB, got)
        del yr, yi
    spec = (big.real.float(), big.imag.float())
    del big, ref
    inv = torch.fft.ifft(torch.complex(spec[0].double(), spec[1].double()))
    iref = (inv.real, inv.imag)
    for restore, k in ((False, 1), (True, 1), (True, 4)):
        (zr, zi), got = drive(lambda: P.ifft_sharded(
            *spec, mesh=mesh, restore_layout=restore, overlap=k))
        if not restore:
            zr, zi = digits(zr), digits(zi)
        a[f"inverse restore={restore} overlap={k}"] = held(
            f"ifft_sharded restore_layout={restore} overlap={k}", iref,
            (zr, zi), FLOOR_DB, got)
        del zr, zi
    (zr, zi), got = drive(lambda: P.ifft_sharded_hier(*spec, mesh=hmesh))
    d[f"ifft_sharded_hier n={n}"] = held("(d) ifft_sharded_hier (1, 1)",
                                         iref, (zr, zi), FLOOR_DB, got)
    del inv, iref, spec, zr, zi
    a["times"] = {
        "fft_sharded restore_layout=False": timed(
            "fft_sharded restore_layout=False",
            lambda: P.fft_sharded(xr, xi, mesh=mesh)),
        "fft_sharded restore_layout=True": timed(
            "fft_sharded restore_layout=True",
            lambda: P.fft_sharded(xr, xi, mesh=mesh, restore_layout=True)),
        "fft_sharded overlap=4": timed(
            "fft_sharded restore_layout=True overlap=4",
            lambda: P.fft_sharded(xr, xi, mesh=mesh, restore_layout=True,
                                  overlap=4)),
        "fft_sharded_hier (1, 1)": timed(
            "fft_sharded_hier (1, 1)",
            lambda: P.fft_sharded_hier(xr, xi, mesh=hmesh)),
        "fft_split (auto: cuFFT above 2^26)": timed(
            "fft_split (auto: cuFFT above 2^26)",
            lambda: kt.fft_split(xr, xi)),
        "fft_split plain engine (backend='torch')": timed(
            "fft_split plain engine (backend='torch')",
            lambda: kt.fft_split(xr, xi, backend="torch"))}
    a["bound_ms"], a["bound_by"] = transform_bound(False, 1, n)
    rec["a"] = a
    del xr, xi
    tables.clear()                      # the 2^28 twiddle tables
    torch.cuda.empty_cache()

    # -- (b) the N-D slab program on cube^3, (d) its hierarchical form ---
    shape = (cube,) * 3
    log(f"(b) fftn_sharded on {shape}: local slabs of {cube}^2 in "
        f"fused_2d_zone ({HK.fused_2d_zone(shape, (1, 2))}) take col_fft + "
        f"row_fft under backend='cuda'")
    br, bi = plane(shape), plane(shape)
    big = torch.fft.fftn(torch.complex(br.double(), bi.double()))
    ref = (big.real, big.imag)
    b = {"shape": list(shape)}
    for backend in ("cuda", "torch"):
        for restore, k in ((False, 1), (True, 4)):
            out, got = drive(lambda: P.fftn_sharded(
                br, bi, mesh=mesh, backend=backend, restore_layout=restore,
                overlap=k))
            b[f"{backend} overlap={k}"] = held(
                f"fftn_sharded backend={backend!r} restore_layout={restore} "
                f"overlap={k}", ref, out, FLOOR_DB, got)
            if backend == "cuda" and k == 1:
                assert got.get("col_fft") and got.get("row_fft"), got
            del out
    for restore in (False, True):
        out, got = drive(lambda: P.fftn_sharded_hier(
            br, bi, mesh=hmesh, backend="cuda", restore_layout=restore))
        d[f"fftn_sharded_hier {shape} cuda restore={restore}"] = held(
            f"(d) fftn_sharded_hier (1, 1) backend='cuda' "
            f"restore_layout={restore}", ref, out, FLOOR_DB, got)
        assert got.get("col_fft") and got.get("row_fft"), got
        del out
    del big, ref
    bc = torch.complex(br, bi)
    b["times"] = {
        "fftn_sharded cuda": timed(
            "fftn_sharded backend='cuda'",
            lambda: P.fftn_sharded(br, bi, mesh=mesh, backend="cuda")),
        "fftn_sharded torch": timed(
            "fftn_sharded backend='torch'",
            lambda: P.fftn_sharded(br, bi, mesh=mesh)),
        "fftn_sharded cuda overlap=4": timed(
            "fftn_sharded backend='cuda' overlap=4",
            lambda: P.fftn_sharded(br, bi, mesh=mesh, backend="cuda",
                                   restore_layout=True, overlap=4)),
        "fftn_split": timed("fftn_split (auto)",
                            lambda: kt.fftn_split(br, bi)),
        "torch.fft.fftn": timed("torch.fft.fftn (cuFFT)",
                                lambda: torch.fft.fftn(bc))}
    b["bound_ms"], b["bound_by"] = nd_bound(shape)
    rec["b"] = b
    del br, bi, bc
    torch.cuda.empty_cache()

    # -- (c) the STFT/ISTFT with the halo, (d) their hierarchical forms --
    c = {"samples": n_stft}
    x = plane(n_stft)
    for win, hop in ((1024, 256), (16384, 4096)):
        w = kt.window.hann(win)
        nf = n_stft // hop
        key = f"hann({win}) hop {hop}"
        log(f"(c) stft_sharded / istft_sharded, {n_stft} samples, {key}: "
            f"{nf} frames")
        want = kt.stft_split(x, w, hop)
        (fr, fi), got = drive(lambda: P.stft_sharded(x, w, hop, mesh=mesh))
        c[f"stft {key}"] = held(f"stft_sharded {key} against stft_split",
                                want, (fr, fi), AXIS_DB, got)
        (hr, hi), got = drive(lambda: P.stft_sharded_hier(x, w, hop,
                                                          mesh=hmesh))
        d[f"stft_sharded_hier {key}"] = held(
            f"(d) stft_sharded_hier {key} against stft_split", want,
            (hr, hi), AXIS_DB, got)
        del want, hr, hi
        # the ISTFTs on the interior (samples win ... N - win): at the
        # ends the window-square sum nears 0, and dividing by it magnifies
        # the rounding of whichever engine made the frames
        iwant = kt.istft_split(fr, fi, w, hop,
                               length=nf * hop)[win:-win]
        (out,), got = drive(lambda: P.istft_sharded(fr, fi, w, hop,
                                                    mesh=mesh))
        c[f"istft {key}"] = held(f"istft_sharded {key} against "
                                 f"istft_split, interior", (iwant,),
                                 (out[win:-win],), AXIS_DB, got)
        c[f"istft push region {key}"] = held(
            f"istft_sharded {key}: the push region's interior against the "
            f"signal", (x[win:-win],), (out[win:-win],), 90.0, {})
        (out,), got = drive(lambda: P.istft_sharded_hier(fr, fi, w, hop,
                                                         mesh=hmesh))
        d[f"istft_sharded_hier {key}"] = held(
            f"(d) istft_sharded_hier {key} against istft_split, interior",
            (iwant,), (out[win:-win],), AXIS_DB, got)
        del iwant, out
        c[f"times {key}"] = {
            "stft_sharded": timed(f"stft_sharded {key}",
                                  lambda: P.stft_sharded(x, w, hop,
                                                         mesh=mesh)),
            "stft_split": timed(f"stft_split {key}",
                                lambda: kt.stft_split(x, w, hop)),
            "istft_sharded": timed(f"istft_sharded {key}",
                                   lambda: P.istft_sharded(fr, fi, w, hop,
                                                           mesh=mesh)),
            "istft_split": timed(f"istft_split {key}",
                                 lambda: kt.istft_split(fr, fi, w, hop,
                                                        length=nf * hop))}
        del fr, fi
        torch.cuda.empty_cache()
    rec["c"], rec["d"] = c, d

    # -- (e) the auto entries at d = 1 take the single-card entries -------
    log("(e) the auto entries at d = 1: should_shard is False, so each "
        "takes its single-card entry")
    e = {}
    ar, ai = plane(n_auto), plane(n_auto)
    (yr, yi), got = drive(lambda: P.fft_auto(ar, ai))
    assert not isinstance(yr, DTensor)
    big = torch.fft.fft(torch.complex(ar.double(), ai.double()))
    e["fft_auto"] = held(f"fft_auto {n_auto}", (big.real, big.imag),
                         (yr, yi), FLOOR_DB, got)
    assert got.get("stage1") and got.get("stage2"), got
    del ar, ai, yr, yi, big
    gr, gi = plane((side, side)), plane((side, side))
    out, got = drive(lambda: P.fftn_auto(gr, gi))
    big = torch.fft.fft2(torch.complex(gr.double(), gi.double()))
    e["fftn_auto"] = held(f"fftn_auto {side}^2", (big.real, big.imag), out,
                          FLOOR_DB, got)
    assert got.get("col_fft") and got.get("row_fft"), got
    del gr, gi, out, big
    w, hop = kt.window.hann(1024), 256
    (fr, fi), got = drive(lambda: P.stft_auto(x, w, hop))
    assert not isinstance(fr, DTensor)
    want = kt.stft_split(x, w, hop)
    e["stft_auto"] = held("stft_auto hann(1024) hop 256 against stft_split",
                          want, (fr, fi), AXIS_DB, got)
    (out,), got = drive(lambda: P.istft_auto(fr, fi, w, hop))
    assert not isinstance(out, DTensor)
    e["istft_auto"] = held(
        "istft_auto against istft_split", (kt.istft_split(
            fr, fi, w, hop, length=fr.shape[0] * hop)[1024:-1024],),
        (out[1024:-1024],), AXIS_DB, got)
    rec["e"] = e
    del x, fr, fi, out, want
    torch.cuda.empty_cache()

    # -- (f) calibration at d = 1; (g) the communication audit on NCCL ----
    thr = kt.get_config().shard_threshold
    assert P.calibrate_shard_threshold() == thr
    rec["f"] = {"calibrated": thr, "current": thr}
    log(f"(f) calibrate_shard_threshold() at d = 1 returns the current "
        f"threshold {thr}")
    g = {}
    for restore, k in ((False, 1), (True, 1), (True, 4)):
        rep = V.check_fft_sharded_comm_volume(1 << 20, mesh,
                                              restore_layout=restore,
                                              overlap=k)
        assert rep["cross_chip_bytes"] == 0
        assert rep["independent_sources"] == 2 * k, rep
        g[f"restore={restore} overlap={k}"] = rep
        log(f"(g) check_fft_sharded_comm_volume on NCCL: {rep}")
    rec["g"] = g

    # -- (h) the multi-rank dry run on the host's CPU ---------------------
    log(f"(h) dryrun_multichip({dryrun}) on {dryrun} gloo ranks of the "
        f"host's CPU (not a card result):")
    t0 = time.perf_counter()
    dr = dryrun_multichip(dryrun)
    rec["h"] = {"ranks": dryrun, "where": "host CPU, gloo",
                "loss": dr["loss"], "dp": dr["dp"], "tp": dr["tp"],
                "wall_s": time.perf_counter() - t0}
    tables.clear()
    torch.cuda.empty_cache()
    rec["sharded_launches"] = {k: v for k, v in sharded.items() if v}
    if started:                         # the world of one this phase made
        dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 took {rec['seconds']:.1f} s; launches of the driven "
        f"calls {rec['sharded_launches']}")
    return rec, sharded


def phase_bench(dev, smi, n: int = 1 << 20, batch: int = 8,
                side: int = 1024, cube: int = 128, n_big: int = 1 << 26,
                win: int = 1024, hop: int = 256):
    """Phase 11: the bench harness (``kofft_tpu_torch.bench``) on the
    card, at bench.py's shapes. (a) the headline: ``fft_split`` at ``n``
    chained unscaled through ``timeit_chained`` (bench.py:219), held
    within 15 % of ``graph_ms`` of the same call, with ``torch.fft.fft``
    on complex64 beside it and ``fft_split`` at ``n_big`` (the chain's
    memory bound at its largest); (b) the SNR-policy rows on the
    `default` tier (bench.py:537-590, :648-732), each SNR against float64
    numpy, then ``check_snr_policy``; (c) ``run_history`` twice into a
    fresh folder under build/, the second run re-measuring (a) only: the
    rotation to previous.json and the stale carry-forward are asserted.
    Every count is set to 0 just before (a) and read just after (b).
    Returns (the phase's record, its launches). Smaller sizes serve a
    rehearsal."""
    import shutil

    import torch
    import kofft_tpu_torch as kt
    from kofft_tpu_torch import bench as KB
    from kofft_tpu_torch.bench import BenchRecord
    from kofft_tpu_torch.bench import harness as KH
    from kofft_tpu_torch.ops import hopper_kernels as HK
    from kofft_tpu_torch.ops import window as W

    log("== phase 11: the bench harness on the card")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    platform = dev.type
    rec = {"card": smi, "rows": []}

    def plane(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=dev).to(dtype)

    def f64(*p):
        """(re, im) planes -> a complex128 host array."""
        return (p[0].double().cpu().numpy()
                + (1j * p[1].double().cpu().numpy() if len(p) > 1 else 0))

    def row(library, transform, size, mode, t, snr=None, per=1):
        """A BenchRecord of ``t`` seconds per op (``per`` items each),
        logged with the chain it was measured on."""
        r = BenchRecord(library, transform, size, mode, t * 1e9 / per,
                        per / t, platform, snr_db=snr)
        chain = dict(KH.last_chain)
        log(f"  {library} {transform} {mode} n={size}: {t * 1e6:.2f} us/op "
            f"({r.measurement_mode}), {per / t:.6g} per s"
            + (f", SNR {snr:.2f} dB" if snr is not None else "")
            + f"; chain {chain} [{smi}]")
        rec["rows"].append({**r.to_dict(), "chain": chain})
        return r

    def measure_a(check: bool):
        """The rows of (a); ``check`` also holds the headline against
        graph_ms and float64."""
        xr, xi = plane(n), plane(n)
        t = KB.timeit_chained(lambda p: kt.fft_split(p[0], p[1]), (xr, xi),
                              iters=200)
        snr = None
        if check:
            snr = snr_db(np.fft.fft(f64(xr, xi)), f64(*kt.fft_split(xr, xi)))
            assert snr >= FLOOR_DB, ("fft_split headline", snr)
            g = graph_ms(lambda: kt.fft_split(xr, xi)) * 1e-3
            log(f"c32_fft_2^20_points_per_sec_per_chip {n / t:.6g} "
                f"(timeit_chained {t * 1e6:.2f} us/op, "
                f"{KB.last_measurement_mode()}); graph_ms "
                f"{g * 1e6:.2f} us/call, ratio {t / g:.4f} [{smi}]")
            rec["headline"] = {"points_per_sec": n / t, "chained_s": t,
                               "graph_s": g, "ratio": t / g}
            assert abs(t / g - 1) <= 0.15, ("chained vs graph_ms", t, g)
        rows = [row("kofft_tpu_torch", "complex", n, "single", t, snr)]
        xc = torch.complex(xr, xi)
        tj = KB.timeit_chained(torch.fft.fft, xc, iters=200)
        rows.append(row("torch.fft", "complex", n, "single", tj))
        del xr, xi, xc
        br, bi = plane(n_big), plane(n_big)
        tb = KB.timeit_chained(lambda p: kt.fft_split(p[0], p[1]), (br, bi),
                               iters=10, target_time=0.2)
        rows.append(row("kofft_tpu_torch", "complex", n_big, "single", tb))
        if dev.type == "cuda":
            c = KH.last_chain                 # the chain's memory bound
            assert c["pool_bytes"] <= KH._POOL_SHARE * c["free_bytes"], c
        del br, bi
        torch.cuda.empty_cache()
        return rows

    def scaled(fn):
        """``fn``'s planes times 1e-3: a chain that stays finite."""
        return lambda q: tuple(a * 1e-3 for a in fn(q[0], q[1]))

    # -- (a) and (b), counted -------------------------------------------
    torch.cuda.synchronize()
    HK.reset_counts()
    records = measure_a(True)
    kt.set_precision("default")
    try:
        # complex single_fast (bench.py:584-592)
        xr, xi = plane(n), plane(n)
        t = KB.timeit_chained(scaled(kt.fft_split), (xr, xi), iters=100)
        s = snr_db(np.fft.fft(f64(xr, xi)), f64(*kt.fft_split(xr, xi)))
        records.append(row("kofft_tpu_torch", "complex", n, "single_fast",
                           t, s))
        del xr, xi
        # real single_fast: the ping-pong chain of bench.py:500-504
        xrr = plane(n)

        def rfft_pp(p):
            yr, yi = kt.rfft_split(p[0])
            return (torch.cat([yr[..., : n // 2], yi[..., : n // 2]],
                              -1) * 1e-3,)

        t = KB.timeit_chained(rfft_pp, (xrr,), iters=100)
        s = snr_db(np.fft.rfft(f64(xrr).real), f64(*kt.rfft_split(xrr)))
        records.append(row("kofft_tpu_torch", "real", n, "single_fast", t,
                           s))
        del xrr
        # batch8_fast, unscaled (bench.py:606-618)
        xrb, xib = plane((batch, n)), plane((batch, n))
        t = KB.timeit_chained(lambda q: kt.fft_split(q[0], q[1]),
                              (xrb, xib), iters=30)
        s = snr_db(np.fft.fft(f64(xrb, xib)), f64(*kt.fft_split(xrb, xib)))
        records.append(row("kofft_tpu_torch", "complex", n, "batch8_fast",
                           t, s))
        # batch8_tiled_bf16: fft_split_tiled on bf16 planes (:623-636)
        m2 = kt.tiled_shape(n)
        art = xrb.reshape(batch, *m2).to(torch.bfloat16)
        ait = xib.reshape(batch, *m2).to(torch.bfloat16)
        t = KB.timeit_chained(lambda q: kt.fft_split_tiled(q[0], q[1]),
                              (art, ait), iters=30)
        tyr, tyi = kt.fft_split_tiled(art, ait)
        assert tyr.dtype == torch.bfloat16, tyr.dtype
        s = snr_db(np.fft.fft(f64(xrb, xib)),
                   f64(tyr, tyi).reshape(batch, n))
        records.append(row("kofft_tpu_torch", "complex", n,
                           "batch8_tiled_bf16", t, s))
        del xrb, xib, art, ait, tyr, tyi
        # fft2d and fft3d single_fast, unscaled (bench.py:361-372, :390-400)
        for transform, shape in (("fft2d", (side, side)),
                                 ("fft3d", (cube, cube, cube))):
            ar, ai = plane(shape), plane(shape)
            t = KB.timeit_chained(lambda q: kt.fftn_split(q[0], q[1]),
                                  (ar, ai))
            s = snr_db(np.fft.fftn(f64(ar, ai)),
                       f64(*kt.fftn_split(ar, ai)))
            records.append(row("kofft_tpu_torch", transform,
                               math.prod(shape), "single_fast", t, s))
            del ar, ai
        # the STFT and ISTFT through the scalar chain (bench.py:648-732)
        w = W.hann(win)
        sig = plane(n)
        nframes = n // hop

        def stft_step(x, acc):
            fr, _ = kt.stft_split(x * (1.0 + 1e-9 * acc), w, hop,
                                  onesided=True)
            return acc + fr[0, 0] * 1e-20

        t = KB.timeit_chained_scalar(stft_step, sig)
        s64 = sig.double().cpu().numpy()
        pad64 = np.zeros((nframes + win // hop - 1) * hop)
        pad64[:n] = s64
        fidx = np.arange(nframes)[:, None] * hop + np.arange(win)[None, :]
        st64 = np.fft.rfft(pad64[fidx] * w.astype(np.float64))
        s = snr_db(st64, f64(*kt.stft_split(sig, w, hop, onesided=True)))
        records.append(row("kofft_tpu_torch", "stft_frames", nframes,
                           "single_fast", t, s, nframes))
        sfr, sfi = kt.stft_split(sig, w, hop, onesided=False)

        def istft_step(p, acc):
            y = kt.istft_split(p[0] * (1.0 + 1e-9 * acc), p[1], w, hop,
                               length=n)
            return acc + y[0] * 1e-20

        t = KB.timeit_chained_scalar(istft_step, (sfr, sfi))
        y = kt.istft_split(sfr, sfi, w, hop, length=n).double().cpu().numpy()
        records.append(row("kofft_tpu_torch", "istft_frames", nframes,
                           "single_fast", t, snr_db(s64, y), nframes))
        records.append(row("kofft_tpu_torch", "istft_frames", nframes,
                           "single_fast_interior", t,
                           snr_db(s64[win:-win], y[win:-win]), nframes))
        del sig, sfr, sfi
    finally:
        kt.set_precision(None)
    torch.cuda.synchronize()
    launches = {k: v for k, v in HK.launches.items() if v}
    log(f"(a)+(b) launches {launches}")
    for k in ("stage1", "stage2", "col_fft", "row_fft"):
        assert launches.get(k, 0) > 0, (k, launches)
    KB.check_snr_policy(records)
    policed = [r for r in records if (r.transform, r.mode)
               in KB.SNR_POLICY_DB]
    assert {(r.transform, r.mode) for r in policed} == set(
        KB.SNR_POLICY_DB), policed
    log(f"check_snr_policy: {len(policed)} rows clear their floors")

    # -- (c) the history -------------------------------------------------
    hist = ROOT / "build" / "phase11_history"
    shutil.rmtree(hist, ignore_errors=True)
    doc1 = KB.run_history(records, out_dir=hist)
    again = measure_a(False)
    doc2 = KB.run_history(again, out_dir=hist)
    assert json.loads((hist / "previous.json").read_text()) == doc1
    assert json.loads((hist / "latest.json").read_text()) == doc2
    assert doc2["environment"]["nvidia_smi"] == smi, doc2["environment"]
    first = {(r["library"], r["transform"], r["size"], r["mode"]): r
             for r in doc1["records"]}
    fresh = [r for r in doc2["records"] if not r.get("stale")]
    stale = [r for r in doc2["records"] if r.get("stale")]
    assert len(fresh) == len(again) and len(stale) == len(records) - len(
        again), (len(fresh), len(stale))
    for r in fresh:
        old = first[(r["library"], r["transform"], r["size"], r["mode"])]
        assert r["prev_time_per_op_ns"] == old["time_per_op_ns"], r
        same = r["measurement_mode"] == old["measurement_mode"]
        assert (r["change_vs_prev"] is not None) == same, r
    assert stale == [dict(r, stale=True) for r in doc1["records"]
                     if (r["library"], r["transform"], r["size"], r["mode"])
                     not in {(a.library, a.transform, a.size, a.mode)
                             for a in again}], stale
    rec["history"] = {"path": str(hist), "fresh": len(fresh),
                      "stale": len(stale),
                      "change_vs_prev": [r["change_vs_prev"] for r in fresh]}
    log(f"history {hist}: previous.json = the first latest.json; "
        f"{len(fresh)} rows re-measured (change_vs_prev "
        f"{rec['history']['change_vs_prev']}), {len(stale)} carried "
        f"forward as stale")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 took {rec['seconds']:.1f} s")
    return rec, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this "
                         "script runs only on a card")
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.ops import _cuda_build as B
    from kofft_tpu_torch.ops import goertzel as GZ
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
    # the odd plan's instances (11 radices x 6 forms): registers and spills
    odd_fns = ptxas_summary(B.build_info["log"], "stage1_odd_kernel")
    if odd_fns:
        regs = [r for r, _, _ in odd_fns.values()]
        log(f"stage1_odd_kernel: {len(odd_fns)} instances, {min(regs)} ... "
            f"{max(regs)} registers, spill stores "
            f"{sum(st for _, st, _ in odd_fns.values())} bytes, spill loads "
            f"{sum(ld for _, _, ld in odd_fns.values())} bytes")
        for name, (r, st, ld) in sorted(odd_fns.items()):
            if st or ld:
                log(f"  spills: {name}: {r} registers, {st} / {ld} bytes")
    # the dense pair's four instances run on the tensor cores: HGMMA
    # (wgmma) in the SASS of each
    hgmma = dense_sass_counts(B)
    log(f"dense_tc_kernel instances, SASS counts of "
        f"{Path(B.build_info['path']).name}: {hgmma}")
    assert len(hgmma) == 4 and all(c["HGMMA"] > 0 for c in hgmma.values()), \
        hgmma

    # -- 3. kernels vs plain --------------------------------------------
    log("== phase 3: kernels vs plain on the card")

    def max_abs(got, want):
        return max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))

    # the stage kernels at every route shape class: one-launch stage 1 up
    # to 2^22 (2048-point columns), the column four-step from 2^24, the
    # stage-2 cluster from 2^23 (4096-point lines), smooth n1 (the odd
    # plan) at 3*2^18, 9*2^14 and 23*2^14; forward and inverse (conj on
    # stage 1's load and stage 2's store); phase 7's shapes last: the
    # DCT/DST fast paths' m = 2^21 and the kernel-path STFT's 1024 frames
    # of 2^14
    stage_sizes = [(8, 1 << 14), (1, 1 << 20), (1, 3 << 18), (1, 9 << 14),
                   (1, 23 << 14), (8, 1 << 20), (1, 1 << 22), (1, 1 << 23),
                   (1, 1 << 24), (1, 1 << 25), (1, 1 << 26), (1, 1 << 21),
                   (1024, 1 << 14)]
    err = {"stage1": 0.0, "stage2": 0.0}
    for b, n in stage_sizes:
        n1, n2 = HK._pow2_split(n)
        ar, ai = planes((b, n1, n2))
        x = host(ar, ai).reshape(b, n)
        for conj in (False, True):
            c = HK.stage1(ar, ai, conj)
            pc = HK.stage1_plain(ar, ai, conj)
            y = HK.stage2(*c, conj)
            py = HK.stage2_plain(*c, conj)
            torch.cuda.synchronize()
            e1, e2 = max_abs(c, pc), max_abs(y, py)
            err["stage1"] = max(err["stage1"], e1)
            err["stage2"] = max(err["stage2"], e2)
            s1, s2 = snr_db_card(pc, c), snr_db_card(py, y)
            del c, pc, py
            ref = (np.fft.ifft(x, axis=-1) * n if conj
                   else np.fft.fft(x, axis=-1))
            so = snr_db(ref, host(*y).reshape(b, n))
            log(f"({b}, {n}) split ({n1}, {n2}){' inverse' if conj else ''}"
                f": stage1 vs plain {s1:.2f} dB (max abs {e1:.3e}), stage2 "
                f"vs plain {s2:.2f} dB (max abs {e2:.3e}), kernels vs "
                f"float64 oracle {so:.2f} dB")
            assert min(s1, s2) > AXIS_DB and so > FLOOR_DB, (
                b, n, conj, s1, s2, so)
            del y, ref
        del ar, ai, x

    err.update(stage1_real=0.0, stage2_half=0.0)
    for b, n in [(4, 1 << 14)] + stage_sizes[1:]:
        n1, n2 = HK._pow2_split(n)
        ar = real((b, n1, n2))
        c = HK.stage1_real(ar)
        pc = HK.stage1_real_plain(ar)
        y = HK.stage2_half(*c)
        py = HK.stage2_half_plain(*c)
        torch.cuda.synchronize()
        e1, e2 = max_abs(c, pc), max_abs(y, py)
        err["stage1_real"] = max(err["stage1_real"], e1)
        err["stage2_half"] = max(err["stage2_half"], e2)
        s1, s2 = snr_db_card(pc, c), snr_db_card(py, y)
        ref = np.fft.rfft(ar.double().cpu().numpy().reshape(b, n), axis=-1)
        got = host(*y)
        so = snr_db(ref, got)
        sq = snr_db(ref[:, -1], got[:, -1])
        log(f"({b}, {n}) split ({n1}, {n2}): stage1_real vs plain "
            f"{s1:.2f} dB (max abs {e1:.3e}), stage2_half vs plain "
            f"{s2:.2f} dB (max abs {e2:.3e}), real pair vs float64 rfft "
            f"{so:.2f} dB (Nyquist bin {sq:.2f} dB)")
        assert min(s1, s2) > AXIS_DB and min(so, sq) > FLOOR_DB, (
            b, n, s1, s2, so, sq)
        del ar, c, pc, y, py, ref, got

    err.update(col_fft=0.0, row_fft=0.0)

    def axis_pass(name, fn, plain_fn, ar, ai, conj=False):
        """One col_fft / row_fft call against its plain version on the
        same input: (output planes, SNR, max abs error)."""
        yr, yi = fn(ar, ai, conj)
        pr, pi = plain_fn(ar, ai, conj)
        torch.cuda.synchronize()
        e = max((yr - pr).abs().max().item(), (yi - pi).abs().max().item())
        err[name] = max(err[name], e)
        return yr, yi, snr_db_card((pr, pi), (yr, yi)), e

    # lines of 2 ... 8192 along both axes: col_fft runs one launch up to
    # HK._COL_SPLIT_ABOVE (2048) and the column four-step above it, so
    # (1, 2048, 4096) and (1, 4096, 2048) hold both sides of the split;
    # every shape forward, then inverse (conj on col_fft's load and
    # row_fft's store: the unnormalized ifft2)
    for shape in [(4096, 2, 16), (1, 16, 2048), (1, 1024, 1024),
                  (8, 512, 512), (1, 2048, 4096), (1, 4096, 2048),
                  (1, 4096, 4096), (1, 8192, 8192)]:
        ar, ai = planes(shape)
        for conj in (False, True):
            cr, ci, s1, e1 = axis_pass("col_fft", HK.col_fft,
                                       HK.col_fft_plain, ar, ai, conj)
            yr, yi, s2, e2 = axis_pass("row_fft", HK.row_fft,
                                       HK.row_fft_plain, cr, ci, conj)
            x = host(ar, ai)
            ref = (np.fft.ifft2(x) * (shape[1] * shape[2]) if conj
                   else np.fft.fft2(x))
            so = snr_db(ref, host(yr, yi))
            log(f"{shape}{' inverse' if conj else ''}: col_fft vs plain "
                f"{s1:.2f} dB (max abs {e1:.3e}), row_fft vs plain "
                f"{s2:.2f} dB (max abs {e2:.3e}), pair vs float64 "
                f"{'ifft2' if conj else 'fft2'} {so:.2f} dB")
            assert min(s1, s2) > AXIS_DB and so > FLOOR_DB, (
                shape, conj, s1, s2, so)
            del cr, ci, yr, yi, x, ref
        del ar, ai
    # the column four-step below its threshold, as phase 6 times it
    ar, ai = planes((1, 2048, 2048))
    yr, yi = HK._col_fft_kernel(ar, ai, False, (32, 64))
    pr, pi = HK.col_fft_plain(ar, ai)
    sv = snr_db_card((pr, pi), (yr, yi))
    log(f"(1, 2048, 2048) col_fft as the column four-step (32, 64) vs "
        f"plain {sv:.2f} dB")
    assert sv > AXIS_DB, sv
    del ar, ai, yr, yi, pr, pi
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
    assert min(snrs) > AXIS_DB and so > FLOOR_DB, (snrs, so)
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

    # the dense four-step pair on both instances of its tier routing
    # (tf32x3 on `highest`, bf16x1 on `default`), each stage against its
    # plain version on the same input (on `default` the bf16-rounding one,
    # DENSE_BF16_DB); the pair, through fused_four_step_fft, against the
    # float64 FFT (on `default` at DEFAULT_DB); peak device memory of the
    # 2^26 pair
    for tier in ("highest", "default"):
        kt.set_precision(tier)
        mode = HK._dense_mode()
        na, nb = (HK._dense_name(k, mode) for k in ("dense_stage_a",
                                                     "dense_stage_b"))
        err.update({na: 0.0, nb: 0.0})
        floor = DENSE_BF16_DB if mode == "bf16x1" else FLOOR_DB
        oracle = DEFAULT_DB if mode == "bf16x1" else FLOOR_DB
        for b, n in [(1, 1 << 14), (3, 1 << 14), (1, 3 << 14), (1, 1 << 20),
                     (8, 1 << 20), (1, 1 << 24), (1, 1 << 26)]:
            n1, n2 = HK._pow2_split(n)
            ar, ai = planes((b, n1, n2))
            cr, ci = HK.dense_stage_a(ar, ai)
            pr, pi = HK.dense_stage_a_plain(ar, ai)
            yr, yi = HK.dense_stage_b(cr, ci)
            qr, qi = HK.dense_stage_b_plain(cr, ci)
            torch.cuda.synchronize()
            e1 = max_abs((cr, ci), (pr, pi))
            e2 = max_abs((yr, yi), (qr, qi))
            err[na] = max(err[na], e1)
            err[nb] = max(err[nb], e2)
            s1 = snr_db_card((pr, pi), (cr, ci))
            s2 = snr_db_card((qr, qi), (yr, yi))
            del cr, ci, pr, pi, yr, yi, qr, qi
            torch.cuda.reset_peak_memory_stats()
            fr, fi = HK.fused_four_step_fft(ar.reshape(b, n),
                                            ai.reshape(b, n), n)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            xc = torch.complex(ar.double(), ai.double()).reshape(b, n)
            want = torch.fft.fft(xc, dim=-1)
            so = snr_db_card((want.real, want.imag),
                             (fr.reshape(b, n), fi.reshape(b, n)))
            del xc, want
            log(f"[{tier}] ({b}, {n}) split ({n1}, {n2}): {na} vs plain "
                f"{s1:.2f} dB (max abs {e1:.3e}), {nb} vs plain {s2:.2f} dB "
                f"(max abs {e2:.3e}), fused_four_step_fft vs float64 "
                f"{so:.2f} dB; peak device memory allocated during the pair "
                f"(tables included) {peak:.2f} GiB")
            assert min(s1, s2) > floor and so > oracle, (tier, b, n, s1, s2,
                                                         so)
            del ar, ai, fr, fi
        kt.set_precision(None)

    # the bf16 I/O forms of the stage kernels against their plain versions
    # on the same input: float32 outputs above AXIS_DB, bf16 outputs
    # (compared in bf16) above BF16_PLAIN_DB; at one-launch columns and
    # whole-block rows, at 2048 x 4096 (a stage-2 cluster), and on both
    # sides of the column four-step at 4096 x 8192 and 8192 x 8192 (the
    # shape the `default` tier's 2^26 route gives them)
    def form_fns(base, xr, xi, stores):
        """(kernel call, plain call) of stage kernel ``base``'s form that
        loads the type of ``xr`` and stores ``stores``."""
        return {
            "stage1": (lambda: HK.stage1(xr, xi, c_dtype=stores),
                       lambda: HK.stage1_plain(xr, xi, c_dtype=stores)),
            "stage1_real": (
                lambda: HK.stage1_real(xr, c_dtype=stores),
                lambda: HK.stage1_real_plain(xr, c_dtype=stores)),
            "stage2": (lambda: HK.stage2(xr, xi, dtype=stores),
                       lambda: HK.stage2_plain(xr, xi, dtype=stores)),
            "stage2_half": (
                lambda: HK.stage2_half(xr, xi, dtype=stores),
                lambda: HK.stage2_half_plain(xr, xi, dtype=stores))}[base]

    # (base kernel, load dtype, store dtype, launch-count name) of each form
    forms = [(base, *(HK._LETTER_DTYPE[c] for c in f), f"{base}_{f}")
             for base, fs in HK._IO_FORMS.items() for f in fs if f != "ff"]
    for shape in [(8, 1024, 1024), (1, 2048, 2048), (1, 2048, 4096),
                  (1, 4096, 4096), (1, 4096, 8192), (1, 8192, 8192)]:
        ar, ai = planes(shape)
        lines = []
        for base, loads, stores, name in forms:
            fn, plain_fn = form_fns(base, ar.to(loads), ai.to(loads), stores)
            (yr, yi), (pr, pi) = fn(), plain_fn()
            torch.cuda.synchronize()
            assert yr.dtype == yi.dtype == stores, (name, yr.dtype)
            e = max((yr.float() - pr.float()).abs().max().item(),
                    (yi.float() - pi.float()).abs().max().item())
            err[name] = max(err.get(name, 0.0), e)
            sv = snr_db_card((pr, pi), (yr, yi))
            floor = AXIS_DB if stores == torch.float32 else BF16_PLAIN_DB
            lines.append(f"{name} {sv:.2f}")
            assert sv > floor, (shape, name, sv, floor)
            del yr, yi, pr, pi
        log(f"{shape}: bf16 forms vs plain (dB): {', '.join(lines)}")
        del ar, ai

    # stage 1 of every smooth n1 = o * q (csrc/stage1_odd.cu: the
    # power-of-two passes on the o sub-lines in thread groups, then the
    # odd pass) at the smallest n that _pow2_split gives it, and at 3*2^23
    # (3072 x 8192, the largest): forward, inverse and real against the
    # plain versions above AXIS_DB; then the bf16 forms of stage1 and
    # stage1_real at three of them (bf16 stores above BF16_PLAIN_DB)
    smooth = {}
    for o in range(3, HK._MAX_ODD + 1, 2):
        for k in range(14, 27):
            split = HK._pow2_split(o << k)
            if split and split[0] & (split[0] - 1):
                smooth.setdefault(split[0], split)
    smooth_shapes = sorted(smooth.values()) + [(3072, 8192)]
    assert len(smooth_shapes) == 20, smooth_shapes
    for n1, n2 in smooth_shapes:
        ar, ai = planes((1, n1, n2))
        vals = []
        for conj in (False, True):
            c, pc = HK.stage1(ar, ai, conj), HK.stage1_plain(ar, ai, conj)
            torch.cuda.synchronize()
            err["stage1"] = max(err["stage1"], max_abs(c, pc))
            vals.append(snr_db_card(pc, c))
        c, pc = HK.stage1_real(ar), HK.stage1_real_plain(ar)
        torch.cuda.synchronize()
        err["stage1_real"] = max(err["stage1_real"], max_abs(c, pc))
        vals.append(snr_db_card(pc, c))
        t, groups = HK._odd_tile(n1)
        log(f"smooth n1 {n1} x {n2} (o = {HK._odd_part(n1)}, {groups} "
            f"groups of {t * n1 // HK._odd_part(n1) // 16} threads): "
            f"stage1 vs plain {vals[0]:.2f} dB, inverse {vals[1]:.2f} dB, "
            f"stage1_real {vals[2]:.2f} dB")
        assert min(vals) > AXIS_DB, (n1, n2, vals)
        del ar, ai, c, pc
    for shape in [(1, 768, 1024), (1, 1152, 128), (1, 2944, 128)]:
        ar, ai = planes(shape)
        lines = []
        for base, loads, stores, name in forms:
            if base not in ("stage1", "stage1_real"):
                continue
            fn, plain_fn = form_fns(base, ar.to(loads), ai.to(loads), stores)
            (yr, yi), (pr, pi) = fn(), plain_fn()
            torch.cuda.synchronize()
            assert yr.dtype == yi.dtype == stores, (name, yr.dtype)
            sv = snr_db_card((pr, pi), (yr, yi))
            floor = AXIS_DB if stores == torch.float32 else BF16_PLAIN_DB
            lines.append(f"{name} {sv:.2f}")
            assert sv > floor, (shape, name, sv, floor)
            del yr, yi, pr, pi
        log(f"smooth {shape}: bf16 forms vs plain (dB): {', '.join(lines)}")
        del ar, ai

    # -- 4. main path through the public entries --------------------------
    log("== phase 4: main paths through the public entries")
    log("-- the complex FFT")
    HK.reset_counts()

    def case(name, cls, fn, ref_fn, floor=FLOOR_DB):
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
        assert s > floor and rose, (name, s, floor, rose)

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
    # a smooth n1 (768 = 3 * 2^8 at 3 * 2^18): stage 1 on the odd plan of
    # stage1_odd.cu, counted under stage1 and read apart here
    before = HK.launches["stage1"]
    split_case((3 << 18,), "phased_flat")
    smooth_launches = {"fft_split": HK.launches["stage1"] - before}
    assert smooth_launches["fft_split"] > 0
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
    before = HK.launches["stage1_real"]
    rfft_case((3 << 18,), "phased_flat_real", "rfft_split")
    smooth_launches["rfft_split"] = HK.launches["stage1_real"] - before
    log(f"smooth-n1 stage 1 (odd plan, stage1_odd.cu) launches on the "
        f"main paths at 3 * 2^18: {smooth_launches}")
    assert smooth_launches["rfft_split"] > 0
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
    assert all(nd_launches[k] > 0 for k in (
        "stage1", "stage2", "stage1_real", "stage2_half", "col_fft",
        "row_fft")), nd_launches
    assert all(nd_classes[k] > 0 for k in ("fft2", "fft2_big", "fused_nd")), \
        nd_classes
    launches.update({k: nd_launches[k] for k in ("col_fft", "row_fft")})
    classes.update({k: nd_classes[k] for k in ("fft2", "fft2_big",
                                               "fused_nd")})
    del x, xh, xr, xi, xc

    log("-- the dense four-step pair, bf16 planes and the `default` tier")
    HK.reset_counts()

    def typed(pair, dtype):
        """Host complex128 of output planes that must be of ``dtype``."""
        assert pair[0].dtype == pair[1].dtype == dtype, (pair[0].dtype, dtype)
        return host(*pair)

    for shape in [(1 << 20,), (8, 1 << 20)]:
        xr, xi = planes(shape)
        x = host(xr, xi)
        case(f"fused_four_step_fft {shape}", "four_step",
             lambda: host(*HK.fused_four_step_fft(xr, xi, shape[-1])),
             lambda: np.fft.fft(x, axis=-1))
    bf16 = torch.bfloat16

    def bf16_cases(shape, cls, floor=BF16_DB):
        """fft_split and rfft_split on bf16 planes: bf16 out, against the
        float64 FFT of the bf16 input."""
        br, bi = (t.to(bf16) for t in planes(shape))
        bx = host(br, bi)
        case(f"fft_split bf16 {shape}", cls,
             lambda: typed(kt.fft_split(br, bi), bf16),
             lambda: np.fft.fft(bx, axis=-1), floor)
        case(f"rfft_split bf16 {shape}", cls + "_real",
             lambda: typed(kt.rfft_split(br), bf16),
             lambda: np.fft.rfft(bx.real, axis=-1), floor)

    bf16_cases((1 << 20,), "phased_tiled")
    bf16_cases((8, 1 << 20), "phased_tiled")
    before = {k: HK.launches[k] for k in ("stage1", "stage2")}
    br, bi = (t.to(bf16) for t in planes((1 << 24,)))
    bx = host(br, bi)
    case("fft_split bf16 (16777216,), the float32 route", "ml",
         lambda: typed(kt.fft_split(br, bi), bf16),
         lambda: np.fft.fft(bx), BF16_DB)
    assert all(HK.launches[k] > v for k, v in before.items()), HK.launches
    del br, bi, bx
    kt.set_precision("default")
    log(f"precision tier: {kt.get_config().precision}")
    # the dense pair's bf16x1 instances (one bf16 pass, as _build's
    # `default` mode)
    for shape in [(1 << 20,), (8, 1 << 20)]:
        xr, xi = planes(shape)
        x = host(xr, xi)
        case(f"fused_four_step_fft default tier {shape}", "four_step",
             lambda: typed(HK.fused_four_step_fft(xr, xi, shape[-1]),
                           torch.float32),
             lambda: np.fft.fft(x, axis=-1), DEFAULT_DB)
        del xr, xi, x
    for shape, cls in [((8, 1 << 20), "phased_tiled"),
                       ((1 << 24,), "phased_tiled"), ((1 << 26,), "ml")]:
        xr, xi = planes(shape)
        x = host(xr, xi)
        case(f"fft_split default tier {shape}", cls,
             lambda: typed(kt.fft_split(xr, xi), torch.float32),
             lambda: np.fft.fft(x, axis=-1), DEFAULT_DB)
        del xr, xi, x
    for shape, cls in [((8, 1 << 20), "phased_tiled_real"),
                       ((1 << 26,), "ml_real")]:
        xr = real(shape)
        x = xr.double().cpu().numpy()
        case(f"rfft_split default tier {shape}", cls,
             lambda: typed(kt.rfft_split(xr), torch.float32),
             lambda: np.fft.rfft(x, axis=-1), DEFAULT_DB)
        del xr, x
    # bf16 planes above 2^23 on this tier: C stays bf16 (the phased sdt)
    bf16_cases((1 << 24,), "phased_tiled", DEFAULT_DB)
    kt.set_precision(None)
    log(f"precision tier: {kt.get_config().precision}")
    torch.cuda.synchronize()
    new = [k for k in HK.launches if k not in launches]
    launches.update({k: HK.launches[k] for k in new})
    classes["four_step"] = HK.classes["four_step"]
    log(f"dense, bf16 and default-tier path counts: launches {HK.launches}, "
        f"classes {HK.classes}")
    log(f"main path counts: launches {launches}, classes {classes}")
    assert set(launches) == set(HK.launches), launches
    assert set(classes) == set(HK.classes), classes
    assert all(v > 0 for v in launches.values()), launches
    assert all(v > 0 for v in classes.values()), classes

    # -- 5. gradient --------------------------------------------------
    log("== phase 5: gradients through fft_split and rfft_split at 2^20, "
        "fft2 at 1024^2, fftn_split at 128^3 and fft_split on bf16 planes "
        "at 2^20")
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
    # bf16 planes: the backward runs the bf16 forms on bf16 cotangents
    n = 1 << 20
    xr, xi = (t.to(torch.bfloat16) for t in planes((n,)))
    gr, gi = (t.to(torch.bfloat16) for t in planes((n,)))
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    yr, yi = kt.fft_split(xr, xi)
    (yr * gr + yi * gi).float().sum().backward()
    assert xr.grad.dtype == xi.grad.dtype == torch.bfloat16
    s = snr_db(np.fft.ifft(host(gr, gi)) * n, host(xr.grad, xi.grad))
    log(f"fft_split grad on bf16 planes (2^20) vs unnormalized inverse of "
        f"the cotangent: {s:.2f} dB")
    assert s > BF16_DB, s
    del xr, xi, gr, gi, yr, yi

    # -- 6. timing ----------------------------------------------------
    log("== phase 6: timing (CUDA events after 3 warm-up calls)")

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

    # the dense four-step pair on both tiers (tf32x3, bf16x1) against its
    # bound, its plain version on the same tier, complex64 torch.matmul of
    # its two products alone (context: TF32 off) and cuFFT
    assert not torch.backends.cuda.matmul.allow_tf32
    for shape in [(1 << 20,), (8, 1 << 20), (1 << 24,)]:
        b = shape[0] if len(shape) == 2 else 1
        n = shape[-1]
        n1, n2 = HK._pow2_split(n)
        xr, xi = planes(shape)
        xc = torch.complex(xr, xi)
        a3r, a3i = xr.reshape(b, n1, n2), xi.reshape(b, n1, n2)
        a3c = xc.reshape(b, n1, n2)
        f1, f2 = (torch.complex(*(torch.as_tensor(a, device=dev) for a in
                                  HK.tables.dft_matrix(m))) for m in (n1, n2))
        bd, by = transform_bound(False, b, n)
        log(f"{shape}: fused_four_step_fft bound {bd * 1e3:.2f} us ({by})")
        for tier in ("highest", "default"):
            report(shape, f"dense pair (fused_four_step_fft), {tier} tier",
                   time_ms(on_tier(tier, lambda: HK.fused_four_step_fft(
                       xr, xi, n))))
            report(shape, f"plain version, {tier} tier (dense_stage_a_plain"
                   " + dense_stage_b_plain)", time_ms(on_tier(
                       tier, lambda: HK.dense_stage_b_plain(
                           *HK.dense_stage_a_plain(a3r, a3i)))))
        report(shape, "context: the two products alone, complex64 "
               "torch.matmul(F1, A) and torch.matmul(F2, C^T) "
               "(allow_tf32 False)", time_ms(
                   lambda: torch.matmul(f2, torch.matmul(f1, a3c).mT)))
        report(shape, "torch.fft.fft (cuFFT)",
               time_ms(lambda: torch.fft.fft(xc)))
        del xr, xi, xc, a3r, a3i, a3c, f1, f2
        torch.cuda.synchronize()

    # the bf16 routes beside the float32 route, in turns (f32, bf16 planes,
    # default tier, the bf16 planes' plain version, then the reverse),
    # each the median of its two runs
    for shape in [(8, 1 << 20), (1 << 24,), (1 << 26,)]:
        b = shape[0] if len(shape) == 2 else 1
        n = shape[-1]
        xr, xi = planes(shape)
        br, bi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
        for real_fft, k in ((False, "fft_split"), (True, "rfft_split")):
            if real_fft:
                paths = {"float32": lambda: kt.rfft_split(xr),
                         "bf16 planes": lambda: kt.rfft_split(br),
                         "default tier, float32 planes": on_tier(
                             "default", lambda: kt.rfft_split(xr)),
                         "bf16 planes, plain version (backend='torch')":
                             lambda: kt.rfft_split(br, backend="torch")}
            else:
                paths = {"float32": lambda: kt.fft_split(xr, xi),
                         "bf16 planes": lambda: kt.fft_split(br, bi),
                         "default tier, float32 planes": on_tier(
                             "default", lambda: kt.fft_split(xr, xi)),
                         "bf16 planes, plain version (backend='torch')":
                             lambda: kt.fft_split(br, bi, backend="torch")}
            turns = {w: [] for w in paths}
            order = list(paths)
            for w in order + order[::-1]:
                turns[w].append(time_ms(paths[w]))
            for w, elt in zip(order, (4, 2, 4, 2)):
                bd, by = transform_bound(real_fft, b, n, elt)
                report(shape, f"{k}, {w} (median of 2 in turns; bound "
                       f"{bd * 1e3:.2f} us, {by})",
                       tuple(statistics.median(t[i] for t in turns[w])
                             for i in range(3)))
        del xr, xi, br, bi, paths
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
    calls = {"stage1": (lambda: HK.stage1(ar, ai),
                        lambda: HK.stage1_plain(ar, ai)),
             "stage2": (lambda: HK.stage2(cr, ci),
                        lambda: HK.stage2_plain(cr, ci)),
             "stage1_real": (lambda: HK.stage1_real(ar),
                             lambda: HK.stage1_real_plain(ar)),
             "stage2_half": (lambda: HK.stage2_half(cr, ci),
                             lambda: HK.stage2_half_plain(cr, ci)),
             "col_fft": (lambda: HK.col_fft(ar, ai),
                         lambda: HK.col_fft_plain(ar, ai)),
             "row_fft": (lambda: HK.row_fft(ar, ai),
                         lambda: HK.row_fft_plain(ar, ai)),
             "dense_stage_a": (lambda: HK.dense_stage_a(ar, ai),
                               lambda: HK.dense_stage_a_plain(ar, ai)),
             "dense_stage_b": (lambda: HK.dense_stage_b(cr, ci),
                               lambda: HK.dense_stage_b_plain(cr, ci)),
             "dense_stage_a_bf16x1": (
                 on_tier("default", lambda: HK.dense_stage_a(ar, ai)),
                 on_tier("default", lambda: HK.dense_stage_a_plain(ar, ai))),
             "dense_stage_b_bf16x1": (
                 on_tier("default", lambda: HK.dense_stage_b(cr, ci)),
                 on_tier("default",
                         lambda: HK.dense_stage_b_plain(cr, ci)))}
    # (function, load bytes, store bytes) of each timed kernel: a form
    # computes its base kernel's function, the dense pair stage1's and
    # stage2's; the bf16 forms run on the same data, loaded as each form
    # loads it (stage 1 forms read the input planes, stage 2 forms a C)
    work = {k: (k, 4, 4) for k in calls}
    work.update(dense_stage_a=("stage1", 4, 4),
                dense_stage_b=("stage2", 4, 4),
                dense_stage_a_bf16x1=("stage1", 4, 4),
                dense_stage_b_bf16x1=("stage2", 4, 4))
    for base, loads, stores, name in forms:
        xr, xi = (ar, ai) if base.startswith("stage1") else (cr, ci)
        calls[name] = form_fns(base, xr.to(loads), xi.to(loads), stores)
        work[name] = (base, loads.itemsize, stores.itemsize)
    kern = {k: time_ms(fn) for k, (fn, _) in calls.items()}
    plain = {k: time_ms(fn) for k, (_, fn) in calls.items()}
    kern_g = {k: graph_ms(fn) for k, (fn, _) in calls.items()}
    plain_g = {k: graph_ms(fn) for k, (_, fn) in calls.items()}
    bound = {k: stage_bound(work[k][0], *shape, *work[k][1:]) for k in kern}
    for k in kern:
        log(f"{shape} {k}: kernel single {kern[k][0] * 1e3:.1f} us,"
            f" back-to-back {kern[k][1] * 1e3:.1f} us/call, graph "
            f"{kern_g[k] * 1e3:.1f} us/call; plain single "
            f"{plain[k][0] * 1e3:.1f} us, back-to-back "
            f"{plain[k][1] * 1e3:.1f} us/call, graph "
            f"{plain_g[k] * 1e3:.1f} us/call; bound "
            f"{bound[k][0] * 1e3:.2f} us ({bound[k][1]}) [{smi}]")
    # library calls, on complex tensors built once outside the timed calls:
    # one axis pass is torch.fft.fft along that axis, and stage2 is
    # torch.fft.fft(C, dim=2) (its transposed store is a layout); so are
    # both instances of dense_stage_b, which compute stage2's function on
    # the same float32 planes. stage1, stage1_real and stage2_half have
    # none: twiddle and FFT, or FFT and slice, are two calls, as are
    # dense_stage_a's product and twiddle. The bf16 forms have none:
    # torch.fft takes no bf16 complex operands. As context, not as library
    # calls: the dense pair's two products as one complex64 matmul each
    # (F1 = F2 is symmetric; torch.backends.cuda.matmul.allow_tf32 False,
    # set in phase 1).
    assert not torch.backends.cuda.matmul.allow_tf32
    ac = torch.complex(ar, ai)
    cc = torch.complex(cr, ci)
    f1 = torch.complex(*(torch.as_tensor(a, device=dev) for a in
                         HK.tables.dft_matrix(1024)))
    library_ms, library_graph_ms = {}, {}
    for ks, what, fn in (
            (("col_fft",), "torch.fft.fft(complex, dim=1)",
             lambda: torch.fft.fft(ac, dim=1)),
            (("row_fft",), "torch.fft.fft(complex, dim=2)",
             lambda: torch.fft.fft(ac, dim=2)),
            (("stage2", "dense_stage_b", "dense_stage_b_bf16x1"),
             "torch.fft.fft(complex(C), dim=2)",
             lambda: torch.fft.fft(cc, dim=2)),
            ((), "dense_stage_b's product, torch.matmul(F2, complex(C).mT),"
             " complex64", lambda: torch.matmul(f1, cc.mT)),
            ((), "dense_stage_a's product alone, torch.matmul(F1, "
             "complex(A)), complex64", lambda: torch.matmul(f1, ac))):
        t = time_ms(fn)
        tg = graph_ms(fn)
        for k in ks:
            library_ms[k], library_graph_ms[k] = t[1], tg
        log(f"{shape} {'/'.join(ks) or 'context'} library {what}: single "
            f"{t[0] * 1e3:.1f} us, back-to-back {t[1] * 1e3:.1f} us/call, "
            f"graph {tg * 1e3:.1f} us/call [{smi}]")
    del ar, ai, cr, ci, ac, cc, f1, calls

    def axis_row(view, k, fn, plain_fn, xr, xi, lib_what, lib_fn):
        """One kernel alone at ``view``: graph and back-to-back time of
        the kernel, graph time of its plain version and of the library
        call (if any), and the bound. Five calls per graph from 2^24
        points (the captured calls' intermediates stay allocated)."""
        runs = graph_runs(math.prod(view))
        tk = time_ms(lambda: fn(xr, xi))
        gk = graph_ms(lambda: fn(xr, xi), runs)
        gp = graph_ms(lambda: plain_fn(xr, xi), runs)
        lib = "" if lib_fn is None else (
            f"; {lib_what} graph {graph_ms(lib_fn, runs) * 1e3:.1f}")
        bd, by = stage_bound(k, *view)
        log(f"{view} {k}: kernel graph {gk * 1e3:.1f} us/call, back-to-back "
            f"{tk[1] * 1e3:.1f} (host enqueue {tk[2] * 1e3:.1f}); plain graph "
            f"{gp * 1e3:.1f}{lib}; bound {bd * 1e3:.2f} us ({by}) [{smi}]")

    # the three axis passes of a 128^3 grid alone: lines of 128
    for view, k, dim in (((1, 128, 16384), "col_fft", 1),
                         ((128, 128, 128), "col_fft", 1),
                         ((1, 16384, 128), "row_fft", 2)):
        vr, vi = planes(view)
        vc = torch.complex(vr, vi)
        fn, plain_fn = {"col_fft": (HK.col_fft, HK.col_fft_plain),
                        "row_fft": (HK.row_fft, HK.row_fft_plain)}[k]
        axis_row(view, k, fn, plain_fn, vr, vi,
                 f"torch.fft.fft(dim={dim})",
                 lambda: torch.fft.fft(vc, dim=dim))
        del vr, vi, vc
    # the axis kernels at the 2-D routes' long lines (col_fft's column
    # four-step at 4096 and 8192), and the 1-D stage pair at lines of 2048
    # (one-launch stage 1, whole-block stage 2), 4096 and 8192 (stage 1's
    # column four-step, stage 2's cluster), each beside its library call
    # along the same axis
    for view in [(1, 2048, 2048), (1, 4096, 4096), (1, 8192, 8192)]:
        vr, vi = planes(view)
        if view[1] > 2048:
            vc = torch.complex(vr, vi)
            axis_row(view, "col_fft", HK.col_fft, HK.col_fft_plain, vr, vi,
                     "torch.fft.fft(dim=1)",
                     lambda: torch.fft.fft(vc, dim=1))
            axis_row(view, "row_fft", HK.row_fft, HK.row_fft_plain, vr, vi,
                     "torch.fft.fft(dim=2)",
                     lambda: torch.fft.fft(vc, dim=2))
            del vc
        axis_row(view, "stage1", HK.stage1, HK.stage1_plain, vr, vi,
                 None, None)
        cr, ci = HK.stage1(vr, vi)
        del vr, vi
        cc = torch.complex(cr, ci)
        axis_row(view, "stage2", HK.stage2, HK.stage2_plain, cr, ci,
                 "torch.fft.fft(C, dim=2)", lambda: torch.fft.fft(cc, dim=2))
        del cr, ci, cc
    # the smooth-n1 stage 1 (the odd plan of stage1_odd.cu) at the splits
    # of 3 * 2^18, 9 * 2^14, 23 * 2^14, 5 * 2^16 and 3 * 2^23, then the
    # complex path at 3 * 2^18 and 5 * 2^16 (the JAX bench's smooth sizes)
    # beside torch.fft.fft
    for n in (3 << 18, 9 << 14, 23 << 14, 5 << 16, 3 << 23):
        view = (1, *HK._pow2_split(n))
        vr, vi = planes(view)
        log(f"smooth n1 = {view[1]}, n = {n}, tile and groups "
            f"{HK._odd_tile(view[1])}:")
        axis_row(view, "stage1", HK.stage1, HK.stage1_plain, vr, vi, None,
                 None)
        del vr, vi
    for n in (3 << 18, 5 << 16):
        xr, xi = planes((n,))
        xc = torch.complex(xr, xi)
        bd, by = transform_bound(False, 1, n)
        log(f"({n},): fft_split bound {bd * 1e3:.2f} us ({by})")
        report((n,), "kernel path (fft_split)",
               time_ms(lambda: kt.fft_split(xr, xi)))
        report((n,), "torch.fft.fft (cuFFT)",
               time_ms(lambda: torch.fft.fft(xc)))
        del xr, xi, xc
    # col_fft at lines of 2048, one launch against the column four-step:
    # the measurement behind HK._COL_SPLIT_ABOVE
    vr, vi = planes((1, 2048, 2048))
    one = graph_ms(lambda: HK._col_fft_kernel(vr, vi, False, None))
    two = graph_ms(lambda: HK._col_fft_kernel(vr, vi, False, (32, 64)))
    log(f"(1, 2048, 2048) col_fft: one launch graph {one * 1e3:.1f} us/call, "
        f"column four-step (32, 64) {two * 1e3:.1f} us/call; split above "
        f"{HK._COL_SPLIT_ABOVE} [{smi}]")
    del vr, vi

    # -- 7. the signal-processing entries --------------------------------
    goertzel = phase_signal(dev, smi)

    # -- 8. the models and the server ------------------------------------
    log(json.dumps({"phase8": phase_models(dev, smi)}))

    # -- 9. the models' training and the CLI -----------------------------
    phase9 = phase_training(dev, smi)
    log(json.dumps({"phase9": phase9}))

    # -- 10. the parallel programs ----------------------------------------
    phase10, sharded = phase_parallel(dev, smi)
    log(json.dumps({"phase10": phase10}))

    # -- 11. the bench harness --------------------------------------------
    phase11, bench = phase_bench(dev, smi)
    log(json.dumps({"phase11": phase11}))

    stages = "kofft_tpu_torch/ops/csrc/fft_stages.cu"
    odd = "kofft_tpu_torch/ops/csrc/stage1_odd.cu"
    dense = "kofft_tpu_torch/ops/csrc/dense_dft.cu"
    axis = "kofft_tpu_torch/ops/csrc/axis_fft.cu"
    tpu = "kofft_tpu/ops/pallas_kernels.py"
    replaces = {
        "stage1": (stages, 547, ["847 (_build_phased kern, phase 1)"]),
        "stage2": (stages, 569, ["847 (_build_phased kern, phases 2-3)"]),
        "stage1_real": (stages, 558, ["847 (_build_phased kern, real=True, "
                                      "phase 1)"]),
        "stage2_half": (stages, 579, ["847 (_build_phased kern, real=True, "
                                      "phases 2-3 and the Nyquist bin)"]),
        "col_fft": (axis, 1701, ["1597 (_build_fft2 kern, phase 1)",
                                 "1415 (_build_fused_nd kern, the passes "
                                 "over axes 0 ... d-2)"]),
        "row_fft": (axis, 1708, ["1597 (_build_fft2 kern, phase 2)",
                                 "1415 (_build_fused_nd kern, the "
                                 "last-axis pass)"]),
        "dense_stage_a": (dense, 185, ["235 (its pallas_call in _build)"]),
        "dense_stage_b": (dense, 199, ["261 (its pallas_call in _build)"])}
    replaces["dense_stage_a_bf16x1"] = (dense, 185, [
        "235 (its pallas_call in _build, mode 'default')"])
    replaces["dense_stage_b_bf16x1"] = (dense, 199, [
        "261 (its pallas_call in _build, mode 'default')"])
    # the bf16 forms: _build_ml's calls with a bf16 C (cdt) and the phased
    # kernel's bf16 io / sdt forms
    call = {"stage1": 613, "stage1_real": 630, "stage2": 649,
            "stage2_half": 668}
    for base, _, _, name in forms:
        replaces[name] = (stages, call[base], [
            "1104 (_build_phased, io / sdt bfloat16)"])
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src,
         "replaces": f"{tpu}:{line}",
         "also_replaces": [f"{tpu}:{a}" for a in also],
         "launches": launches[k], "max_abs_err": err[k],
         "ms": kern[k][1], "plain_ms": plain[k][1], "bound_ms": bound[k][0],
         "bound_by": bound[k][1], "library_ms": library_ms.get(k),
         "graph_ms": kern_g[k], "plain_graph_ms": plain_g[k],
         "library_graph_ms": library_graph_ms.get(k),
         **({"also_source": [odd]} if k.startswith("stage1") else {})}
        for k, (src, line, also) in replaces.items()]}
    # not a TPU kernel: the JAX package runs this recurrence as a lax.scan
    record["kernels"].append({
        "name": "goertzel_scan", "route": "cuda",
        "source": "kofft_tpu_torch/ops/csrc/goertzel.cu",
        "replaces": "kofft_tpu/ops/goertzel.py:109", "also_replaces": [],
        **goertzel})
    per_step = phase9["kernel_path"]["launches_highest"]
    for k in record["kernels"]:
        k["sharded_launches"] = sharded.get(k["name"], 0)
        k["bench_launches"] = bench.get(k["name"], 0)
        if k["name"] in ("stage1", "stage2"):
            k["training_launches"] = {
                part: per_step[part].get(k["name"], 0)
                for part in ("forward", "backward")}
    names = {k["name"] for k in record["kernels"]}
    assert set(replaces) | {"goertzel_scan"} == names == set(
        HK.launches) | set(GZ.launches), (set(HK.launches)
                                          | set(GZ.launches)) ^ names
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
