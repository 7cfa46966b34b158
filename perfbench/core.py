"""What every cell shares: finding a cell's files by name, running its
driver, reading its metrics and printing the one result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``perfbench/configs/<config>.json``: the configuration as it is run;
- ``perfbench/workloads/<cell>.json``: the cell's configuration, traffic
  mix, chips and the limits of its checks;
- ``perfbench/mixes/<traffic>.json``: a traffic mix's parameters, and the
  driver that runs it;
- ``perfbench/drivers/<driver>.py``: one kind of traffic (``run(cell)``);
- ``perfbench/metrics/<metric>.py``: one per-layer metric (``read(run)``,
  which returns None where it finds nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "msmctts_tpu"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload(name: str, here: Path = HERE) -> dict:
    return load_json(here / "workloads" / f"{name}.json")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def mix(name: str, here: Path = HERE) -> dict:
    return load_json(here / "mixes" / f"{name}.json")


def driver(name: str, here: Path = HERE):
    return _module(here / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def metric(name: str, here: Path = HERE):
    return _module(here / "metrics" / f"{name}.py", "perfbench_metric_" + name.replace(".", "_"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def cell_metrics(b: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    e2e_here = {m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in b[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


@dataclass
class Cell:
    """One run of one cell."""

    name: str
    workload: dict
    mix: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    log: Callable[[str], None] = field(default=lambda s: print(s, file=sys.stderr, flush=True))


class Run:
    """A driver's record with what every per-layer reader needs: the
    measurement window on the trace's clock, the task calls inside it."""

    def __init__(self, cell: Cell, record: dict):
        self.cell = cell
        self.rec = record
        self.task = record.get("task")
        self.trace = record.get("trace")
        self.start, self.end = record["window"]
        self.window_s = self.end - self.start
        self.calls = [s for s in record.get("spans", []) if self.start <= s[0] < self.end]
        self.offset = self._offset()
        if self.offset is None:  # no range of the benchmark's in it: nothing places it in the window
            self.trace = None
        self.untraced = record.get("untraced")

    def _offset(self) -> Optional[float]:
        """Trace clock minus host clock, from the task calls seen by both."""
        if self.trace is None:
            return None
        traced = self.trace.ranges.get(self.rec["call_range"], [])
        pairs = list(zip(traced, self.rec.get("spans", [])))
        return statistics.median(t[0] - s[0] for t, s in pairs) if pairs else None

    def on_trace(self, t: float) -> float:
        return t + self.offset

    @property
    def trace_window(self):
        return self.on_trace(self.start), self.on_trace(self.end)

    def device_time(self, ranges) -> float:
        lo, hi = self.trace_window
        return sum(t1 - t0 for _, t0, t1 in self.trace.kernels_in(ranges, lo, hi))

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.trace.busy(*self.trace_window))


def untraced_rest(resume: Optional[float], end: float):
    """The rest of a traced run's window after the tracer stopped, where the
    host runs at its untraced speed (None where there is under a second)."""
    return (resume, end) if resume is not None and end - resume >= 1.0 else None


def percentile(values: List[float], p: int) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def run_cell(cell: Cell, b: dict, here: Path = HERE) -> dict:
    """Run the cell's driver and build the result line's object."""
    out = driver(cell.mix["driver"], here).run(cell)
    checks = out["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    run = Run(cell, out["record"]) if cell.trace else None
    result["metrics"] = {}
    for m in cell_metrics(b, cell.name, "per_layer" if run is not None else "end_to_end"):
        value = metric(m["name"], here).read(run) if run is not None else out["e2e"][m["name"]]
        if value is not None and math.isfinite(value):  # a reader that finds nothing gives nothing
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
              "kind": torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda" else "cpu",
              "count": int(cell.workload["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if run is not None and run.trace is not None:
        device["busy_s"] = run.busy_s()
        device["window_s"] = run.window_s
        result["breakdown"] = run.trace.breakdown(*run.trace_window, out["record"]["idle_label"])
    result["device"] = device
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
