"""One run of one cell: set up, measure a window, check, read the metrics.

Everything a cell needs is found by name:
- BENCHMARK.json names the cell's configuration, traffic mix and metrics;
- configs/<config>.json holds the deployment's sizes, as run;
- workloads/<cell>.json holds the traffic mix's parameters, the traffic
  kind that runs it, and the limits of the comparison that decides correct;
- traffic/<kind>.py sets the system under test up, drives the window and
  compares what it produced with reference/;
- metrics/<metric>.py reads one metric of a run; roofline/<kernel>.py
  counts one kernel's operations and bytes.
A kind reads and writes its state on the Run it is given.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

from . import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hpfw_tpu")
# A traced run measures a window this long at most: the per-layer metrics
# are shares and ratios, and a trace of a whole window of a busy cell holds
# millions of events.
TRACE_WINDOW_S = 6.0


def load_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_module(*parts: str):
    """A module of this folder by its file path (names may hold dots)."""
    path = HERE.joinpath(*parts)
    name = "portbench._" + "_".join(parts).replace(".", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics a cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]
    return e2e, per


def jax_loaded() -> list[str]:
    """Modules whose top-level name is jax, jaxlib, flax or hpfw_tpu."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


class Run:
    """The state of one run: its cell, inputs, system under test and records."""

    def __init__(self, cell: str, seed: int, seconds: float, traced: bool, device,
                 t_process: float, overrides: dict | None = None):
        bench = benchmark()
        entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
        self.cell, self.seed, self.seconds, self.traced = cell, int(seed), seconds, traced
        self.device = device
        self.t_process = t_process
        self.bench = bench
        self.config = load_json("configs", entry["config"] + ".json")
        self.workload = load_json("workloads", cell + ".json")
        for key, value in (overrides or {}).items():   # tests shrink a cell to the CPU
            (self.config if key in self.config else self.workload)[key] = value
        self.kind = importlib.import_module(f"{__package__}.traffic.{self.workload['kind']}")
        self.state: dict = {}      # the system under test and its inputs
        self.records: dict = {}    # what the window measured
        self.t_window: float | None = None
        self.trace: tracing.Trace | None = None

    def window_starts(self) -> float:
        """Called at the first timed request; returns its time."""
        self.t_window = time.perf_counter()
        return self.t_window


def execute(run: Run) -> dict:
    """Set up, measure, check and read: the result line's fields."""
    import torch

    kind = run.kind
    kind.setup(run)
    if run.traced:
        run.seconds = min(run.seconds, TRACE_WINDOW_S)
    cuda = run.device.type == "cuda"
    if cuda:
        # The peak is that of serving: set-up's transients (rendering, the
        # planted tracks' reference prints) are freed and not counted.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)
        run.records["resident_bytes"] = torch.cuda.memory_allocated(run.device)
    holder: dict = {}
    with tracing.profiled(run.traced, holder):
        kind.window(run)
    run.trace = holder.get("trace")
    if run.trace is not None:
        run.records["trace_mb"] = holder["trace_mb"]
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    found = jax_loaded()
    if found:
        raise RuntimeError(f"the run loaded {', '.join(found)}")
    kind.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = kind.check(run)
    run.check_s = time.perf_counter() - t_check
    e2e, per = cell_metrics(run.bench, run.cell)
    metrics = {}
    for m in (per if run.traced else e2e):
        value = load_module("metrics", m["name"] + ".py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": int(run.records["attempted"]), "failed": int(run.records["failed"]),
           "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
