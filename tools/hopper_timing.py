#!/usr/bin/env python3
"""Time kofft_tpu_torch's N-D axis kernels, N-D routes, 1-D paths, dense
four-step pair and STFT on one CUDA card, so that two trees of the port
can be compared in turns.

    python tools/hopper_timing.py [--root DIR] [--label NAME] [--out FILE]
                                  [--kinds kernel,split,route,path,dense,
                                           smooth,stft]

``--root`` is the checkout whose ``kofft_tpu_torch`` is imported (default:
this one), so a parent tree unpacked beside it can be timed by the same
script; run the two in turns (parent, change, change, parent) on one card.
The timers are ``chip_smoke.py``'s (``time_ms``, ``graph_ms``,
``graph_runs``), so a row here and the same row of its phase 6 are one
measurement. Every row gives three device figures, in microseconds per
call:

- ``graph``: calls captured in one CUDA graph and replayed (20 per graph,
  5 above 2^22 points), the event time of a replay over the calls (no
  host time: the kernels' own device time, plus the launch gaps inside
  the graph);
- ``b2b``: 20 calls back to back between one pair of events (the host's
  enqueue shows through wherever it is slower than the device);
- ``host``: the host's time per call to enqueue those 20 calls.

Row groups (``kind`` / ``name`` / ``shape``): ``kernel`` col_fft and
row_fft at the shapes of PERF.md section 6 ((1, 1024, 1024), the three
128^3 views, (8, 512, 512), (1, 4096, 4096), (1, 8192, 8192)), stage1 and
stage2 at (1, 1024, 1024), (1, 2048, 2048), (1, 4096, 4096) and (1, 8192,
8192); ``library`` torch.fft.fft
along the same axis of the complex tensor (for stage2 of its C); ``route``
fftn_split at 1024^2, (8, 512, 512), 4096^2, 8192^2 and 128^3, and
torch.fft.fftn beside each; ``path`` fft_split and rfft_split at 2^20,
8 x 2^20, 2^24 and 2^26; and, where the tree has the column four-step,
``split`` col_fft at (1, 2048, 2048) as one launch and as the split;
``dense`` the dense pair's stages at (1, 1024, 1024) on the `highest`
and the `default` tier (the tree's instance for each tier), beside
stage b's library call torch.fft.fft(C, dim=2) and, as ``context``, the
complex64 product torch.matmul(F2, C^T) (TF32 off), and fused_four_step_fft at
2^20, 8 x 2^20 and 2^24 on both tiers; ``smooth`` the smooth-n1 stage 1
at the splits of 3*2^18, 9*2^14, 23*2^14, 5*2^16 and 3*2^23 ((1, 768,
1024), (1, 1152, 128), (1, 2944, 128), (1, 640, 512), (1, 3072, 8192)),
fft_split at 3*2^18 and 5*2^16 beside torch.fft.fft, and, where the tree
has the odd plan (``HK._ODD_TILE``), stage 1 at (1, 1152, 128) and (1,
2944, 128) with tiles of 4 columns (``tile4``) beside the 8 it keeps;
``stft``, where the tree has the STFT, stft_split (one-sided) and
istft_split at the JAX bench's shape (2^20 samples, hann(1024), hop 256:
4096 frames, ``auto``) and on the kernel path (2^22 samples, hann(16384),
hop 4096: 1024 frames, ``backend="cuda"``), each beside torch.stft on the
same zero-padded signal (center=False) and torch.istft (center=True,
since center=False refuses a window whose envelope is 0 at sample 0;
back to back only: it reads the envelope's minimum back to the host,
which a graph cannot capture); a row's ``shape`` is (frames, win).
``--kinds`` lists the groups in the order they run, a group may come
twice (``path,kernel,path`` times the paths before and after the kernel
rows in one process); each row carries ``pos``, its group's place in that
list, and each group starts with a ``state`` row, the card's clocks,
temperature and power draw from nvidia-smi. Each row is one JSON line on
stdout; ``--out`` also writes them as a JSON list. The card's name and
power limit come first. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (SEED, graph_ms, graph_runs, on_tier,  # noqa: E402
                        time_ms)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kinds", default="kernel,split,route,path",
                    help="row groups in the order they run: kernel (with "
                         "its library rows), split, route, path, dense, "
                         "smooth, stft")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("hopper_timing: no CUDA device is available")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import kofft_tpu_torch as kt
    from kofft_tpu_torch.ops import hopper_kernels as HK
    assert Path(HK.__file__).resolve().is_relative_to(root), HK.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = []

    def planes(shape):
        a = rng.standard_normal((2,) + tuple(shape), dtype=np.float32)
        return (torch.as_tensor(a[0], device=dev),
                torch.as_tensor(a[1], device=dev))

    def emit(r):
        rows.append(r)
        print(json.dumps(r), flush=True)

    def row(pos, kind, name, shape, fn, graph=True):
        _, b2b, host = time_ms(fn)
        g = graph_ms(fn, graph_runs(math.prod(shape))) * 1e3 if graph \
            else None
        emit({"label": args.label, "pos": pos, "kind": kind, "name": name,
              "shape": list(shape), "graph": g, "b2b": b2b * 1e3,
              "host": host * 1e3, "device": card})

    def kernel_rows(pos):
        kernels = [("col_fft", 1, s) for s in
                   [(1, 1024, 1024), (1, 128, 16384), (128, 128, 128),
                    (8, 512, 512), (1, 4096, 4096), (1, 8192, 8192)]]
        kernels += [("row_fft", 2, s) for s in
                    [(1, 1024, 1024), (1, 16384, 128), (8, 512, 512),
                     (1, 4096, 4096), (1, 8192, 8192)]]
        for name, dim, shape in kernels:
            ar, ai = planes(shape)
            row(pos, "kernel", name, shape,
                lambda: getattr(HK, name)(ar, ai))
            ac = torch.complex(ar, ai)
            row(pos, "library", f"torch.fft.fft(dim={dim})", shape,
                lambda: torch.fft.fft(ac, dim=dim))
            del ar, ai, ac
        for shape in [(1, 1024, 1024), (1, 2048, 2048), (1, 4096, 4096),
                      (1, 8192, 8192)]:
            ar, ai = planes(shape)
            row(pos, "kernel", "stage1", shape, lambda: HK.stage1(ar, ai))
            cr, ci = HK.stage1(ar, ai)
            del ar, ai
            row(pos, "kernel", "stage2", shape, lambda: HK.stage2(cr, ci))
            cc = torch.complex(cr, ci)
            row(pos, "library", "torch.fft.fft(C, dim=2)", shape,
                lambda: torch.fft.fft(cc, dim=2))
            del cr, ci, cc

    def split_rows(pos):
        if not hasattr(HK, "_col_fft_kernel"):
            return
        shape = (1, 2048, 2048)
        ar, ai = planes(shape)
        row(pos, "split", "col_fft one launch", shape,
            lambda: HK._col_fft_kernel(ar, ai, False, None))
        row(pos, "split", "col_fft four-step (32, 64)", shape,
            lambda: HK._col_fft_kernel(ar, ai, False, (32, 64)))

    def route_rows(pos):
        for shape, axes in [((1024, 1024), (-2, -1)),
                            ((8, 512, 512), (-2, -1)),
                            ((4096, 4096), (-2, -1)),
                            ((8192, 8192), (-2, -1)),
                            ((128, 128, 128), None)]:
            xr, xi = planes(shape)
            row(pos, "route", "fftn_split", shape,
                lambda: kt.fftn_split(xr, xi, axes=axes))
            xc = torch.complex(xr, xi)
            row(pos, "library", "torch.fft.fftn", shape,
                lambda: torch.fft.fftn(xc, dim=axes))
            del xr, xi, xc

    def path_rows(pos):
        for shape in [(1 << 20,), (8, 1 << 20), (1 << 24,), (1 << 26,)]:
            xr, xi = planes(shape)
            row(pos, "path", "fft_split", shape,
                lambda: kt.fft_split(xr, xi))
            row(pos, "path", "rfft_split", shape,
                lambda: kt.rfft_split(xr))
            del xr, xi

    def dense_rows(pos):
        shape = (1, 1024, 1024)
        ar, ai = planes(shape)
        cr, ci = HK.dense_stage_a(ar, ai)
        for tier in ("highest", "default"):
            row(pos, "dense", f"dense_stage_a {tier}", shape,
                on_tier(tier, lambda: HK.dense_stage_a(ar, ai)))
            row(pos, "dense", f"dense_stage_b {tier}", shape,
                on_tier(tier, lambda: HK.dense_stage_b(cr, ci)))
        f2 = torch.complex(*(torch.as_tensor(a, device=dev) for a in
                             HK.tables.dft_matrix(1024)))
        cc = torch.complex(cr, ci)
        row(pos, "library", "torch.fft.fft(C, dim=2)", shape,
            lambda: torch.fft.fft(cc, dim=2))
        row(pos, "context", "torch.matmul(F2, C^T) complex64", shape,
            lambda: torch.matmul(f2, cc.mT))
        del ar, ai, cr, ci, cc, f2
        for shape in [(1 << 20,), (8, 1 << 20), (1 << 24,)]:
            xr, xi = planes(shape)
            for tier in ("highest", "default"):
                row(pos, "dense", f"fused_four_step_fft {tier}", shape,
                    on_tier(tier, lambda: HK.fused_four_step_fft(
                        xr, xi, shape[-1])))
            del xr, xi

    def smooth_rows(pos):
        for n in (3 << 18, 9 << 14, 23 << 14, 5 << 16, 3 << 23):
            shape = (1, *HK._pow2_split(n))
            ar, ai = planes(shape)
            row(pos, "smooth", "stage1", shape, lambda: HK.stage1(ar, ai))
            del ar, ai
        for n in (3 << 18, 5 << 16):
            xr, xi = planes((n,))
            row(pos, "smooth", "fft_split", (n,),
                lambda: kt.fft_split(xr, xi))
            xc = torch.complex(xr, xi)
            row(pos, "library", "torch.fft.fft", (n,),
                lambda: torch.fft.fft(xc))
            del xr, xi, xc
        if not hasattr(HK, "_ODD_TILE"):
            return
        keep = HK._ODD_TILE
        try:
            HK._ODD_TILE = 4
            HK._ARGS.clear()
            for shape in [(1, 1152, 128), (1, 2944, 128)]:
                ar, ai = planes(shape)
                row(pos, "smooth", "stage1 tile4", shape,
                    lambda: HK.stage1(ar, ai))
                del ar, ai
        finally:
            HK._ODD_TILE = keep
            HK._ARGS.clear()

    def stft_rows(pos):
        if not hasattr(kt, "stft_split"):
            return
        from kofft_tpu_torch.ops.window import hann
        for n, win, hop, backend in [(1 << 20, 1024, 256, None),
                                     (1 << 22, 1 << 14, 4096, "cuda")]:
            x = torch.as_tensor(rng.standard_normal(n, dtype=np.float32),
                                device=dev)
            w = hann(win)
            nf = -(-n // hop)
            shape = (nf, win)
            b = backend or "auto"
            row(pos, "stft", f"stft_split one-sided {b}", shape,
                lambda: kt.stft_split(x, w, hop, onesided=True,
                                      backend=backend))
            fr, fi = kt.stft_split(x, w, hop, backend=backend)
            row(pos, "stft", f"istft_split {b}", shape,
                lambda: kt.istft_split(fr, fi, w, hop, length=n,
                                       backend=backend))
            wt = torch.as_tensor(w, device=dev)
            xpad = torch.nn.functional.pad(x, (0, (nf - 1) * hop + win - n))
            row(pos, "library", "torch.stft", shape,
                lambda: torch.stft(xpad, win, hop, win, wt, center=False,
                                   onesided=True, return_complex=True))
            spec = torch.complex(fr, fi).T.contiguous()
            row(pos, "library", "torch.istft", shape,
                lambda: torch.istft(spec, win, hop, win, wt, center=True,
                                    onesided=False), graph=False)
            del x, fr, fi, xpad, spec

    groups = {"kernel": kernel_rows, "split": split_rows,
              "route": route_rows, "path": path_rows, "dense": dense_rows,
              "smooth": smooth_rows, "stft": stft_rows}
    for pos, kind in enumerate(args.kinds.split(",")):
        emit({"label": args.label, "pos": pos, "kind": "state", "name": kind,
              "state": smi("clocks.sm,clocks.mem,temperature.gpu,"
                           "power.draw")})
        groups[kind](pos)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
