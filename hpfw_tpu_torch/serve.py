"""Micro-batching match server: the serving loop around the batched matcher.

Counterpart of hpfw_tpu/serve.py's ServerSaturated and MatchServer. Callers
submit queries from any thread and get futures; one dispatcher thread groups
up to `max_batch` queries (waiting at most `max_wait_ms` for the batch to
fill), issues ONE TwoStageDB.dispatch_batch per group, and a pool of
`rank_workers` threads waits for each result and ranks it on the host.

  - Batches are bucketed in powers of 4 up to max_batch and padded with the
    last query; the pad rows are dropped before ranking.
  - At most `depth` batches are in flight on the device (a semaphore that a
    rank worker releases when its result has landed).
  - The submit queue is bounded (`max_queue`): a full queue fails the
    submission with ServerSaturated (after blocking `submit_timeout_ms`, if
    set) instead of building unbounded latency.
  - Queries share one print length (`query_prints`); a wrong length, or a
    submit after close(), fails fast.

On a CUDA device the dispatcher thread owns a torch.cuda.Stream, made
current for its launches; the stream waits once for the stream that built
the DB. Each batch uploads from pinned host memory without blocking, and its
(B, 3, K) result comes back by a non-blocking copy into a fresh pinned buffer
plus a recorded event, which the rank worker waits on: the dispatcher never
synchronises, so consecutive batches pipeline on the device. On the CPU the
same code runs with no streams.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .match.scaled import _rank_dedup


class ServerSaturated(RuntimeError):
    """Submit queue is full: the server is shedding load."""


class MatchServer:
    """Micro-batching wrapper around TwoStageDB.dispatch_batch."""

    def __init__(self, ts, query_prints: int, *, max_batch: int = 16,
                 max_wait_ms: float = 5.0, depth: int = 2,
                 top_k: int | None = None, pool: int | None = None,
                 max_queue: int = 256, submit_timeout_ms: float = 0.0,
                 rank_workers: int = 4):
        self.ts = ts
        self.n_q = int(query_prints)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.depth = int(depth)
        self.top_k = top_k
        self.pool = pool
        self.submit_timeout = submit_timeout_ms / 1e3
        self.device = ts.device
        self._cuda = self.device.type == "cuda"
        self._stream = None
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._stop = threading.Event()
        self._device_slots = threading.Semaphore(self.depth)
        self._rank_pool = ThreadPoolExecutor(
            max_workers=int(rank_workers), thread_name_prefix="hpfw-rank")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- client surface -------------------------------------------------
    def submit(self, query_prints: np.ndarray,
               timeout_ms: float | None = None) -> Future:
        """Queue one (N, 2)-uint32 query; resolves to (ids, scores, offs).

        When the bounded submit queue is full, blocks up to `timeout_ms`
        (default: the server's submit_timeout_ms) and then resolves the
        future with ServerSaturated.
        """
        q = np.asarray(query_prints, dtype=np.uint32)
        fut: Future = Future()
        if q.shape != (self.n_q, 2):
            fut.set_exception(ValueError(
                f"server is pinned to {self.n_q}-print queries, got {q.shape}"))
            return fut
        if self._stop.is_set():
            fut.set_exception(RuntimeError("server closed"))
            return fut
        wait = self.submit_timeout if timeout_ms is None else timeout_ms / 1e3
        try:
            if wait > 0:
                self._q.put((q, fut), timeout=wait)
            else:
                self._q.put_nowait((q, fut))
        except queue.Full:
            fut.set_exception(ServerSaturated(
                f"submit queue full ({self._q.maxsize} pending)"))
        return fut

    def match(self, query_prints: np.ndarray):
        """Blocking convenience wrapper."""
        return self.submit(query_prints, timeout_ms=None).result()

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 4
        return min(b, self.max_batch)

    def warmup(self, example_query: np.ndarray) -> None:
        """Run every batch bucket once, so that no first-use cost (the kernel
        build, the allocator's first blocks) falls inside a request."""
        q = np.asarray(example_query, dtype=np.uint32)
        b = 1
        while True:
            rows = [q] * min(b, self.max_batch)
            with self._on_stream():
                out, ready = self._dispatch(rows)
            self._wait(ready)
            if b >= self.max_batch:
                break
            b *= 4

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)       # wake the dispatcher
        except queue.Full:
            pass                           # dispatcher is draining; stop flag set
        self._thread.join()
        self._rank_pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- device side ----------------------------------------------------
    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def _dispatch(self, rows):
        """Upload one padded batch, queue its match, and start the copy back:
        ((B, 3, K) int32 host tensor, event to wait on or None). No sync."""
        host = torch.from_numpy(np.stack(rows).view(np.int32))
        if not self._cuda:
            return self.ts.dispatch_batch(host.to(self.device), pool=self.pool), None
        q = host.pin_memory().to(self.device, non_blocking=True)
        out_dev = self.ts.dispatch_batch(q, pool=self.pool)
        out = torch.empty(out_dev.shape, dtype=out_dev.dtype, pin_memory=True)
        out.copy_(out_dev, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(self._stream)
        return out, ready

    @staticmethod
    def _wait(ready) -> None:
        if ready is not None:
            ready.synchronize()

    # ---- dispatcher -----------------------------------------------------
    def _collect(self):
        """Block for one query, then soak up to max_batch within max_wait."""
        item = self._q.get()
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self):
        with self._on_stream():
            while not self._stop.is_set():
                batch = self._collect()
                if not batch:
                    break
                rows = [q for q, _ in batch]
                rows += [rows[-1]] * (self._bucket(len(rows)) - len(rows))
                # Bound the device queue: a slot frees when a result lands.
                acquired = False
                while not acquired and not self._stop.is_set():
                    acquired = self._device_slots.acquire(timeout=0.1)
                futs = [f for _, f in batch]
                if not acquired:
                    self._fail(futs, RuntimeError("server closed"))
                    break
                try:
                    out, ready = self._dispatch(rows)
                except Exception as e:             # a failed launch fails its batch
                    self._device_slots.release()
                    self._fail(futs, e)
                    continue
                self._rank_pool.submit(self._finish, out, ready, futs)
        # Fail anything still queued after close().
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("server closed"))

    @staticmethod
    def _fail(futs, exc) -> None:
        for fut in futs:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)

    def _finish(self, out, ready, futs):
        """Rank-worker side: wait for the batch's result, then rank each query."""
        try:
            self._wait(ready)
            host = out.numpy()
        except Exception as e:                     # device failure: fail futures
            self._device_slots.release()
            self._fail(futs, e)
            return
        self._device_slots.release()
        for b, fut in enumerate(futs):
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(self._rank(host[b]))
                except Exception as e:
                    fut.set_exception(e)

    def _rank(self, out_b: np.ndarray):
        cfg = self.ts.db.cfg
        scores, idx, offs = out_b
        real = idx < self.ts.n_real
        return _rank_dedup(scores[real], idx[real], offs[real], self.ts.db.track_ids,
                           self.top_k if self.top_k else cfg.top_k)
