"""CUDA graphs of TwoStageDB's single-device dispatch.

A dispatch of B queries of N prints queues a few hundred operations on the
card (the phase views, K4's pass 1 and rescan, the pools' topk and sort,
K5, and the small ops between them), each a few microseconds of host time,
while the card idles between short kernels. Every shape in that chain is
fixed by (B, N) and the resolved knobs, and nothing in it reads device
memory on the host, so DispatchGraphs captures it once and replays it: one
graph launch in place of the chain, with the same kernels on the same
inputs and the same results.

Per key (the current stream, the queries' shape, strides and dtype, and the
resolved knobs), the first call runs eager, which loads the kernels and
lets the allocator settle; the second captures the chain and replays it;
later calls replay it. At most CAP keys of a DB hold a graph (or a capture
that failed, which leaves its key eager for good); past that, new keys run
eager, so one-off shapes do not pile up graphs. A server drops its
streams' graphs when it closes (drop()).

The graphs of one stream, over every DB, share a Pool: a memory pool, a
capture stream, and a lock held across each capture and across each
replay's copy in, launch and copy out. They replay in turn on that stream,
and no replay reuses another's scratch before that one's output is copied.
A thread that finds the lock held by a capture runs eager. A pool whose
graphs have all gone is not captured into again (PyTorch frees it): the
stream's next capture takes a fresh one.

A replay copies the queries into the graph's static input and returns a
copy of its static output, queued on the same stream: callers hold several
results at once, and the next replay overwrites the static output.
"""

from __future__ import annotations

import threading
import warnings
import weakref
from typing import Callable, NamedTuple

import torch

from ..ops import _build

# Keys a DispatchGraphs holds a graph (or a failed capture) for.
CAP = 16


class Graph(NamedTuple):
    """A captured dispatch: the graph, its static input and output, the
    launches it queues (counted at each replay), and its pool's lock, which
    keeps one caller's copy in, replay and copy out together."""
    graph: object
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: dict
    lock: threading.Lock

    def replay(self, queries: torch.Tensor) -> torch.Tensor:
        with self.lock:
            self.static_in.copy_(queries)
            self.graph.replay()
            out = self.static_out.clone()
        _build.count_launches(self.launches)
        return out


def current_stream(device: torch.device):
    """The stream a dispatch on device queues on now."""
    return torch.cuda.current_stream(device)


def new_pool(device: torch.device):
    """A memory pool handle and a capture stream on device."""
    return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)


class Pool:
    """What the graphs of one stream share: a memory pool (handle), a
    capture stream (side), the lock of their captures and replays, and weak
    references to the graphs captured into it (used once one was tried)."""

    def __init__(self, device: torch.device):
        self.handle, self.side = new_pool(device)
        self.lock = threading.Lock()
        self.graphs = weakref.WeakSet()
        self.used = False


_POOLS: dict = {}              # (device, stream handle) -> Pool
_POOLS_LOCK = threading.Lock()


def pool_of(device: torch.device, stream: int) -> tuple[Pool, list]:
    """The pool of a stream, and its live graphs: held until a capture into
    the pool ends, they keep PyTorch's count of the pool's users above 0."""
    with _POOLS_LOCK:
        pool = _POOLS.get((device, stream))
        live = list(pool.graphs) if pool is not None else []
        if pool is None or (pool.used and not live):
            pool = _POOLS[(device, stream)] = Pool(device)
        return pool, live


def capture(fn: Callable, queries: torch.Tensor, device: torch.device, pool: Pool) -> Graph:
    """fn captured on a static input on device with the shape, strides and
    dtype of queries (allocated on the current stream) into a CUDA graph on
    pool's capture stream and memory. Capture errors stay on this thread
    (thread_local), so other threads' eager work goes on."""
    static_in = torch.empty_strided(queries.shape, queries.stride(), dtype=queries.dtype,
                                    device=device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(pool.side), _build.captured_launches() as launches:
        graph.capture_begin(pool=pool.handle, capture_error_mode="thread_local")
        try:
            static_out = fn(static_in)
        finally:
            graph.capture_end()
    return Graph(graph, static_in, static_out, launches, pool.lock)


class DispatchGraphs:
    """The graphs of one TwoStageDB's dispatches, by key; safe to share
    between threads (a server's dispatchers and its callers share a DB)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: dict = {}      # keys called once (at most CAP), oldest first
        self._graphs: dict = {}    # key -> Graph; None while capturing or failed

    def __len__(self) -> int:
        """Keys that hold a graph."""
        with self._lock:
            return sum(g is not None for g in self._graphs.values())

    def drop(self, streams) -> None:
        """Forget the graphs and sightings of these stream handles."""
        with self._lock:
            for d in (self._graphs, self._seen):
                for key in [k for k in d if k[0] in streams]:
                    del d[key]

    def run(self, device: torch.device, key: tuple, queries: torch.Tensor,
            fn: Callable[[torch.Tensor], torch.Tensor]) -> tuple[torch.Tensor, bool]:
        """fn(queries), by the graph of (the current stream, key) where
        there is one: (the result, whether a graph ran)."""
        stream = current_stream(device).cuda_stream
        key = (stream,) + key
        pool = None
        with self._lock:
            graph = self._graphs.get(key)
            if key not in self._graphs and len(self._graphs) < CAP:
                if key in self._seen:
                    pool, live = pool_of(device, stream)
                    if pool.lock.acquire(blocking=False):
                        del self._seen[key]
                        self._graphs[key] = None      # capturing: eager meanwhile
                    else:                             # the stream's pool is capturing
                        pool = None
                else:
                    self._seen[key] = True
                    if len(self._seen) > CAP:
                        del self._seen[next(iter(self._seen))]
        if graph is not None:
            return graph.replay(queries), True
        if pool is None:
            return fn(queries), False
        try:
            graph = capture(fn, queries, device, pool)
        except Exception as e:                        # the key stays eager
            warnings.warn(f"a dispatch's CUDA graph capture failed ({e!r}); its shape "
                          "runs eager", RuntimeWarning, stacklevel=3)
        finally:
            with _POOLS_LOCK:
                pool.used = True
                if graph is not None:
                    pool.graphs.add(graph.graph)
            pool.lock.release()
            del live
        if graph is None:
            return fn(queries), False
        with self._lock:
            if key in self._graphs:                   # not dropped meanwhile
                self._graphs[key] = graph
        return graph.replay(queries), True
