"""Tracing and profiling helpers on torch.profiler.

The counterpart of hpfw_tpu/utils/profiling.py. trace(name) marks a region
for the profiler (torch.profiler.record_function, a `user_annotation` event
in the trace) and adds its wall-clock time to the named scope;
scope_stats, reset_scopes and dump_metrics are copies of the reference's.
start_trace/stop_trace capture one profile of the host and, on a card, of
the kernels it runs, into logdir/trace.json (Chrome trace format: open it in
chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region for torch.profiler AND wall-clock stats."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _SCOPES[name].append((time.perf_counter() - t0) * 1e3)


_SCOPES: dict[str, list[float]] = defaultdict(list)


def scope_stats() -> dict[str, dict]:
    out = {}
    for name, xs in _SCOPES.items():
        xs_sorted = sorted(xs)
        out[name] = {
            "count": len(xs),
            "total_ms": round(sum(xs), 3),
            "p50_ms": round(xs_sorted[len(xs) // 2], 3),
            "max_ms": round(xs_sorted[-1], 3),
        }
    return out


def reset_scopes() -> None:
    _SCOPES.clear()


def dump_metrics(path: str, extra: dict | None = None) -> None:
    """Write structured per-run metrics JSON (BASELINE.md headline format)."""
    payload = {"scopes": scope_stats()}
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


_PROFILE: tuple[torch.profiler.profile, str] | None = None


def start_trace(logdir: str, device: str | torch.device | None = None) -> None:
    """Start capturing a trace: CPU activity, plus the card's kernels unless
    device is the CPU. With no device named the card is meant, and with no
    card visible this raises, as api.default_device() does."""
    global _PROFILE
    if _PROFILE is not None:
        raise RuntimeError("a trace is already running; call stop_trace() first")
    if device is None:
        from ..api import default_device

        device = default_device()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILE = (prof, logdir)


def stop_trace() -> None:
    """Stop the trace start_trace began and write logdir/trace.json."""
    global _PROFILE
    if _PROFILE is None:
        raise RuntimeError("no trace is running; call start_trace() first")
    prof, logdir = _PROFILE
    _PROFILE = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
