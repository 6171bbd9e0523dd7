"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
With ``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from ``torch.profiler``
over the window. The last line of standard output is the result (JSON);
the numbers that decided ``correct`` are the last lines of standard error
and the result's last key. Exit codes: 0 a result was printed, 1 the run
failed, 2 no CUDA device or fewer than the cell asks for, or two ranks
on one card, 3 a forbidden module was loaded, 4 the program is not the
checkout's own. A cell on d > 1 cards runs as d ranks, one process per
card (``ranks``), and only rank 0's result is printed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program and of its libraries stays in the checkout, at
# fixed paths, so that only a checkout's first run builds anything
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)
sys.path.insert(0, str(ROOT))


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, loader, roofline
    chips = loader.load(ROOT, args.workload).chips
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        _say(f"needs {chips} CUDA device(s); torch sees {seen}")
        return 2
    import kofft_tpu_torch
    if ROOT not in Path(kofft_tpu_torch.__file__).resolve().parents:
        _say(f"kofft_tpu_torch comes from {kofft_tpu_torch.__file__}, "
             f"not from this checkout ({ROOT})")
        return 4
    _say(f"cell {args.workload}, seed {args.seed}, {args.seconds} s, "
         f"trace {args.trace}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}")
    found = []
    if chips == 1:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace), "cuda",
                                  T_START, _say)
        from kofft_tpu_torch.ops import _cuda_build
        _say(f"kernel library: built in {_cuda_build.build_info['seconds']}"
             f" s (0.0: found built; None: not loaded), "
             f"{_cuda_build.build_info['path']}")
    else:
        from portbench import ranks
        try:
            result, found = ranks.launch(ROOT, args.workload, args.seed,
                                         args.seconds, bool(args.trace),
                                         "cuda", chips, T_START, _say)
        except ranks.Refused as e:
            _say(f"refused: {e}")
            return 2
        except ranks.RankFailed as e:
            _say(f"failed: {e}")
            return 1
    _say(f"card: {_power_limit()}; peaks {roofline.PEAK_BYTES!r} B/s, "
         f"{roofline.PEAK_FLOPS!r} flop/s (H100 SXM at 700 W)")
    found = sorted(set(found) | set(harness.forbidden_modules()))
    if found:
        _say(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        _say(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
