"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 1] [--out file.jsonl]

For each seed of ``--seeds`` it makes one run of the cell at its own sizes
and load, with a short window, and reads the compared numbers of its
sampled answers (the program's readings). For each seed of
``--control-seeds`` it puts the control in the program's place, the
reference's function computed in TF32 (``tf32``), on as many of the seed's
inputs as a run samples, and reads the same numbers against the reference.
Every reading is a JSON line; the last line gives the program's largest
and the control's smallest reading of each number. One process, so the
program is loaded once.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from portbench import check, harness, loader
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    lines = []

    def emit(d):
        lines.append(d)
        print(json.dumps(d), flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, "cuda", log=lambda *a: None)
        emit({"side": "program", "seed": seed, "correct": res["correct"],
              "calls": res["attempted"],
              "seconds": time.perf_counter() - t0,
              **{k: v["value"] for k, v in res["checks"].items()}})
    cell = loader.load(ROOT, args.workload)
    ad, cfg, tr = cell.adapter, cell.cfg, cell.traffic
    for seed in (int(s) for s in args.control_seeds.split(",")):
        t0 = time.perf_counter()
        pool = ad.make_pool(cfg, tr, harness.seeds(seed)[0], "cuda")
        least = {}
        for k in range(tr["check"]["samples"]):
            inp = pool[k % len(pool)]
            e = check.errors(ad.answer(ad.control(cfg, tr, inp)),
                             ad.expected(cfg, tr, inp))
            least = {n: min(least.get(n, e[n]), e[n]) for n in e}
        del pool
        emit({"side": "control", "seed": seed,
              "seconds": time.perf_counter() - t0, **least})
    names = list(tr["check"]["limits"])
    summary = {"workload": args.workload,
               "program_max": {n: max(d[n] for d in lines
                                      if d["side"] == "program")
                               for n in names},
               "control_min": {n: min(d[n] for d in lines
                                      if d["side"] == "control")
                               for n in names}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for d in lines + [summary]:
                f.write(json.dumps(d) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
