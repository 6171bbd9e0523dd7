"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing here names a configuration, a cell or a metric: a cell's traffic
is ``portbench/workloads/<cell>.json``, its configuration the ``file``
that ``BENCHMARK.json`` gives, the configuration's adapter
``portbench/adapters/<adapter>.py``, the traffic's loop
``portbench/traffic/<loop>.py``, and each metric's reader
``portbench/metrics/<metric>.py``, or where there is no such file, the
reader of the name before its first dot (``idle_pct.stft`` is read by
``metrics/idle_pct.py``). A later change adds any of them as files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict        # the configuration's file
    traffic: dict    # the cell's file under workloads/
    adapter: object  # module
    loop: object     # module
    end_to_end: list  # [(name, unit, reader)]
    per_layer: list


def _module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{tag}: no file {path}")
    name = "portbench_" + re.sub(r"\W", "_", f"{tag}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _metrics(bench: Path, entries: list, cell: str, reported: set) -> list:
    out = []
    for m in entries:
        cells = m.get("workloads")
        if cells is not None and cell not in cells:
            continue
        if cells is None and "moves" in m and m["moves"] not in reported:
            continue
        path = bench / "metrics" / f"{m['name']}.py"
        if not path.is_file():
            path = bench / "metrics" / f"{m['name'].split('.')[0]}.py"
        reader = _module(path, "metric")
        out.append((m["name"], m["unit"], reader.read))
    return out


def load(root: Path, workload: str) -> Cell:
    """Everything one cell needs, found from the checkout's root."""
    if not _NAME.match(workload):
        raise KeyError(f"not a cell name: {workload!r}")
    root = Path(root)
    spec = _json(root / "BENCHMARK.json")
    bench = root / "portbench"
    w = _named(spec["workloads"], workload, "cell")
    c = _named(spec["configs"], w["config"], "configuration")
    cfg = _json(root / c["file"])
    traffic = _json(bench / "workloads" / f"{workload}.json")
    if traffic["config"] != w["config"] or traffic["traffic"] != w["traffic"]:
        raise ValueError(f"{workload}: its file names another configuration"
                         " or traffic than BENCHMARK.json")
    e2e = _metrics(bench, spec["end_to_end"], workload, set())
    per_layer = _metrics(bench, spec["per_layer"], workload,
                         {name for name, _, _ in e2e})
    return Cell(name=workload, chips=w["chips"], cfg=cfg, traffic=traffic,
                adapter=_module(
                    bench / "adapters" / f"{cfg['adapter']}.py", "adapter"),
                loop=_module(bench / "traffic" / f"{traffic['loop']}.py",
                             "traffic"),
                end_to_end=e2e, per_layer=per_layer)
