"""The trial cell on four cards, as files in a copy of the benchmark.

    python3 portbench/tests/trial_cell.py <dst> [--shape 256,256,256]
        [--program]

writes ``<dst>/BENCHMARK.json`` and ``<dst>/portbench/``: the committed
benchmark with the configuration ``pfft_trial`` (its adapter is
``trial/fftn_sharded.py``), the cell ``pfft_trial.cube`` on four cards,
and the cell in the lists of ``points_per_s`` and three per-layer
metrics; ``--program`` copies ``kofft_tpu_torch`` beside them, so that

    python3 portbench/run.py --workload pfft_trial.cube --seed <n> \
        --seconds <s> --trace <0|1>

runs from ``<dst>``. The tests build it at the CPU's size, 16^3.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CONFIG, TRAFFIC = "pfft_trial", "cube"
CELL = f"{CONFIG}.{TRAFFIC}"
METRICS = ("host_us_per_call.fft", "kernels_per_call.fft", "idle_pct.fft")


def make(dst: Path, src: Path = ROOT, shape=(16, 16, 16), patch: str = "",
         program: bool = False) -> Path:
    """The trial's checkout at ``dst``; ``patch`` is source appended to
    the adapter (a fault planted in a test)."""
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    skip = shutil.ignore_patterns("__pycache__", "tests")
    shutil.copy(src / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(src / "portbench", dst / "portbench", ignore=skip)
    if program:
        shutil.copytree(src / "kofft_tpu_torch", dst / "kofft_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
    b = dst / "portbench"
    (b / "adapters" / "fftn_sharded.py").write_text(
        (HERE / "trial" / "fftn_sharded.py").read_text() + patch)
    (b / "configs" / f"{CONFIG}.json").write_text(json.dumps({
        "name": CONFIG, "adapter": "fftn_sharded",
        "entry": "kofft_tpu_torch.parallel.fftn_sharded",
        "dtype": "float32", "inverse": False, "precision": "highest",
        "backend": "cuda", "restore_layout": False, "overlap": 1,
        "reduced": [], "cpu_sizes": {"shape": [16, 16, 16], "pool": 2}},
        indent=1))
    (b / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "config": CONFIG, "traffic": TRAFFIC, "loop": "closed",
        "shape": list(shape), "inflight": 2, "pool": 2,
        "check": {"samples": 2,
                  "limits": {"rms_err": 1e-5, "max_err": 5e-5}}},
        indent=1))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": CONFIG, "source": "trial",
                            "file": f"portbench/configs/{CONFIG}.json",
                            "reduced": [], "why": "trial"})
    spec["workloads"].append({"name": CELL, "config": CONFIG,
                              "traffic": TRAFFIC, "chips": 4,
                              "why": "trial"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("points_per_s", *METRICS):
            m["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dst")
    ap.add_argument("--shape", default="16,16,16")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    make(Path(args.dst), shape=[int(s) for s in args.shape.split(",")],
         program=args.program)
    return 0


if __name__ == "__main__":
    sys.exit(main())
