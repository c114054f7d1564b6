"""The device trace of a run's window: torch.profiler (CUPTI) on the card.

A traced run profiles the whole measured window inside a user annotation,
WINDOW, exports the Chrome trace to TMPDIR, reads it and deletes it. Times
in the trace are microseconds. Device operations are the events of category
kernel, gpu_memcpy and gpu_memset.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

from . import stats

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# Host operations longer than this (us) name no gap: they span many.
HOST_MAX_US = 50_000


class Trace:
    """The events of one traced window, and the window's bounds (us)."""

    def __init__(self, events: list, lo: float, hi: float):
        self.events = events
        self.lo, self.hi = lo, hi
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                       and e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        marks = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        if len(marks) != 1:
            raise RuntimeError(f"the trace holds {len(marks)} {WINDOW} annotations, not 1")
        return cls(events, marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return stats.busy(((e["ts"], e["ts"] + e["dur"]) for e in self.device),
                          self.lo, self.hi) / 1e6

    def kernels_named(self, pattern: str) -> list:
        """Kernel events in the window whose name matches the regex pattern."""
        rx = re.compile(pattern)
        return [e for e in self.kernels if rx.search(e["name"])]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the 500 longest gaps, each gap named by the innermost host operation
        running at its middle, summed by name."""
        by_op: dict[str, float] = {}
        for e in self.device:
            by_op[short(e["name"])] = by_op.get(short(e["name"]), 0.0) + e["dur"] / 1e6
        host = sorted((e for e in self.events if e.get("ph") == "X"
                       and e.get("cat") in HOST_CATS and e.get("dur", 0) <= HOST_MAX_US
                       and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo),
                      key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        longest = max((e["dur"] for e in host), default=0)
        idle = sorted(stats.gaps(((e["ts"], e["ts"] + e["dur"]) for e in self.device),
                                 self.lo, self.hi), key=lambda g: g[0] - g[1])
        by_host: dict[str, float] = {}
        for a, b in idle[:500]:
            mid = 0.5 * (a + b)
            name, best = "no torch or CUDA call (Python)", None
            i = bisect.bisect_right(starts, mid)
            while i > 0 and starts[i - 1] >= mid - longest:
                i -= 1
                e = host[i]
                if e["ts"] + e["dur"] >= mid and (best is None or e["dur"] < best):
                    name, best = short(e["name"]), e["dur"]
            by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
        return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                                    key=lambda kv: -kv[1])[:top]}


def short(name: str) -> str:
    """A kernel's or an operation's name without its argument list."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out and out[-1] not in " :":
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:120]


@contextlib.contextmanager
def profiled(on: bool, holder: dict):
    """Profile the body when on, and put the window's Trace in holder["trace"]."""
    if not on:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        holder["trace_mb"] = os.path.getsize(path) / 1e6
        with open(path) as f:
            doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    holder["trace"] = Trace.from_events(events)
