"""Spans, wall-clock scopes and torch.profiler traces.

The counterpart of hpfw_tpu/utils/profiling.py, with an in-memory span
recorder the port's hot paths write to:

- trace(name, **attrs) times a region that opens and closes on one thread;
  record(name, t0, t1, **attrs) files an interval whose ends were stamped
  elsewhere (a request's wait in a queue, stamped by the submitting thread
  and closed by a dispatcher). Both append one record to a ring of
  CAPACITY records, read by spans(), and the duration in ms to the named
  scope of scope_stats(). Times are time.perf_counter_ns().
- A span also enters torch.profiler.record_function (a `user_annotation`
  event in the trace, on the trace's clock) when a profiler records the
  current thread; elsewhere it costs two clock reads and two appends.
- The ring and every scope are bounded, so a server that runs for days
  keeps only its newest spans.

scope_stats, reset_scopes and dump_metrics are copies of the reference's.
start_trace/stop_trace capture one profile of the host and, on a card, of
the kernels it runs, into logdir/trace.json (Chrome trace format: open it in
chrome://tracing or Perfetto).
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch

# Spans kept: about 2 minutes of a live server at 80 queries a second.
CAPACITY = 1 << 16
# Durations kept a scope.
SCOPE_CAPACITY = 1 << 12


class Span(NamedTuple):
    """One record of the ring: name, start and end (perf_counter_ns), the
    recording thread's id, the span's id, the id of the span that caused it
    (or None), and its attributes."""
    name: str
    t0: int
    t1: int
    thread: int
    sid: int
    parent: int | None
    attrs: dict


_RING: deque = deque(maxlen=CAPACITY)
_IDS = itertools.count(1)


def new_id() -> int:
    """A fresh span id, for a span whose id its children need before it opens."""
    return next(_IDS)


def _put(name, t0, t1, sid, parent, attrs) -> None:
    _RING.append((name, t0, t1, threading.get_ident(), sid, parent, attrs))
    _SCOPES[name].append((t1 - t0) / 1e6)


class _Trace:
    __slots__ = ("name", "sid", "parent", "attrs", "t0", "_rf")

    def __init__(self, name, sid, parent, attrs):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.sid = next(_IDS) if sid is None else sid

    def __enter__(self):
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _put(self.name, self.t0, t1, self.sid, self.parent, self.attrs)


def trace(name: str, *, sid: int | None = None, parent: int | None = None, **attrs):
    """A context manager that records the region it wraps as a span (its id
    `sid` if given, else a fresh one, on the returned object's .sid; its
    start on .t0), and annotates it for torch.profiler where one records
    this thread."""
    return _Trace(name, sid, parent, attrs)


def record(name: str, t0: int, t1: int, *, parent: int | None = None, **attrs) -> None:
    """Record an interval stamped by time.perf_counter_ns(), possibly on
    other threads, as a span. Never a profiler annotation."""
    _put(name, t0, t1, next(_IDS), parent, attrs)


def spans() -> list[Span]:
    """The ring's records, oldest first. Once it holds CAPACITY, each new
    span pushes out the oldest."""
    return [Span(*r) for r in _RING.copy()]


# A deque a name (functools.partial, so that no thread switch can fall inside
# the creation of a name's deque).
_SCOPES: dict[str, deque] = defaultdict(functools.partial(deque, maxlen=SCOPE_CAPACITY))


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
