"""Finding a cell's files by name, loading readers and drivers, and the run's
last line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent          # perfbench/
# top-level module names that may not be loaded in a run (compared whole:
# ``alpro_tpu_torch`` is not ``alpro_tpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "alpro_tpu")


class HarnessError(RuntimeError):
    """A cell, file or device the run cannot go on without."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files its names point to."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_path: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root unless
    ``bench_path`` is given), its configuration and traffic files, its
    limits and the metrics it reports."""
    bench_path = bench_path or root.parent / "BENCHMARK.json"
    if not bench_path.is_file():
        raise HarnessError(f"no {bench_path}")
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise HarnessError(f"no workload {name!r} in {bench_path.name}; "
                           f"known: {', '.join(sorted(cells))}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root.parent / configs[w["config"]]["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    cell_file = root / "cells" / f"{name}.json"
    limits = load_json(cell_file)["limits"] if cell_file.is_file() else {}
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic,
        limits={k: float(v["limit"]) for k, v in limits.items()},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_module(path: Path):
    """Import the Python file at ``path`` (names may hold dots, so not by
    the import system's module path)."""
    mod_name = "perfbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(traffic: dict, root: Path = ROOT):
    return load_module(root / "drivers" / f"{traffic['driver']}.py")


def load_reader(metric_name: str, root: Path = ROOT):
    """The reader of a per-layer metric: ``metrics/<name>.py``, whose
    ``read(run)`` returns a number or None (nothing to read)."""
    return load_module(root / "metrics" / f"{metric_name}.py")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``ok`` when value <= limit. A
    number that could not be read (a crash, a missing answer) is inf."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Tuple[float, str]], device: dict,
                checks: List[Check], breakdown: Optional[dict] = None) -> str:
    """The run's last line of standard output. ``checks`` comes last, each
    number beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value),
                              "limit": c.limit} for c in checks}
    return json.dumps(out)


def checks_text(checks: List[Check]) -> str:
    return "\n".join(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
                     f"{'ok' if c.ok else 'FAILED'}" for c in checks)
