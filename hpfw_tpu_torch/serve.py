"""Micro-batching match servers: the serving loops around the batched matcher.

Counterpart of hpfw_tpu/serve.py's ServerSaturated, MatchServer and
EscalatingMatchServer. Callers submit queries from any thread and get
futures; a dispatcher thread groups up to `max_batch` queries (waiting at
most `max_wait_ms` for the batch to fill), issues ONE TwoStageDB.dispatch_batch
per group, and a pool of `rank_workers` threads waits for each result and
ranks it on the host.

  - Batches are bucketed in powers of 4 up to max_batch and padded with the
    last query; the pad rows are dropped before ranking.
  - At most `depth` batches are in flight on the device (a semaphore that a
    rank worker releases when its result has landed).
  - The submit queue is bounded (`max_queue`): a full queue fails the
    submission with ServerSaturated (after blocking `submit_timeout_ms`, if
    set) instead of building unbounded latency.
  - Queries share one length; a wrong length, or a submit after close(),
    fails fast.

Each dispatch class is a _Lane: its queue, streams, batch cap, timers and
dispatcher thread, and the rank-worker half of its batches. MatchServer has
one lane; EscalatingMatchServer two, rigid and scan, which share its device
slots and rank pool.

On a CUDA device each dispatcher thread owns a torch.cuda.Stream on every
device the DB's shards sit on (one on one card), made current for its
launches; each stream waits once for the work that built the DB on its
device. Each batch uploads from pinned host memory to the first device
without blocking, every shard's match is queued on its own device's stream,
the shards' blocks meet on the first device after each shard's stream (the
copy in the gather waits on it), and the (B, 3, K) result comes back by a
non-blocking copy into a fresh pinned buffer plus an event recorded on the
first device's stream, which the rank worker waits on: a dispatcher never
synchronises, so consecutive batches pipeline on the devices. On the CPU the
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

from . import api
from .match.scaled import _rank_variants
from .ops import fine, frontend
from .ops import fingerprint as fp_ops
from .utils import profiling
from .utils.profiling import trace


class ServerSaturated(RuntimeError):
    """Submit queue is full: the server is shedding load."""


def _bucket(n: int, cap: int) -> int:
    """The padded batch size of n queries: the next power of 4, at most cap."""
    b = 1
    while b < n:
        b *= 4
    return min(b, cap)


def _buckets(cap: int):
    """Every batch size _bucket gives under cap, smallest first."""
    b = 1
    while b < cap:
        yield b
        b *= 4
    yield cap


def _collect(q: queue.Queue, max_n: int, max_wait: float, first_wait: float | None = None):
    """Block for one item (at most first_wait seconds, if given), then soak
    up to max_n within max_wait. [] on a timeout or the close marker."""
    try:
        item = q.get() if first_wait is None else q.get(timeout=first_wait)
    except queue.Empty:
        return []
    if item is None:
        return []
    batch = [item]
    deadline = time.monotonic() + max_wait
    while len(batch) < max_n:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            nxt = q.get(timeout=left)
        except queue.Empty:
            break
        if nxt is None:
            break
        batch.append(nxt)
    return batch


def _acquire(slots: threading.Semaphore, stop: threading.Event) -> bool:
    """Take one of the `depth` device slots, polling the stop flag: False
    once the server is closing."""
    while not stop.is_set():
        if slots.acquire(timeout=0.1):
            return True
    return False


def _fail(futs, exc) -> None:
    for fut in futs:
        if fut.set_running_or_notify_cancel():
            fut.set_exception(exc)


def _drain(q: queue.Queue) -> None:
    """Fail every future still queued after close(); an item's future is its
    last element."""
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            break
        if item is not None:
            _fail([item[-1]], RuntimeError("server closed"))


def _admitted(name: str, batch) -> int:
    """Record each request's wait from its stamp (an item's second element)
    to now, the close of its batch, as a span `name` whose parent is the
    batch (its dispatch span's id, returned) and whose `req` is the
    request's id (an item's third element)."""
    t1, bid = time.perf_counter_ns(), profiling.new_id()
    for item in batch:
        profiling.record(name, item[1], t1, parent=bid, req=item[2])
    return bid


def _request_done(t0: int, req: int):
    """A future's callback that records the request's life, from its submit
    stamp t0 to its answer or failure, as a `serve.request` span."""
    def done(fut: Future) -> None:
        t1 = time.perf_counter_ns()
        res = None if fut.cancelled() or fut.exception() is not None else fut.result()
        profiling.record("serve.request", t0, t1, req=req,
                         escalated=bool(res[3]) if res is not None else None)
    return done


def _new_streams(ts) -> list:
    """A dispatcher's streams, one a device of ts (its first device first),
    each ordered after the work queued so far on its device's current stream
    (the DB's build); [None] on the CPU."""
    streams = []
    for device in ts.devices:
        if device.type != "cuda":
            return [None]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        streams.append(stream)
    return streams


@contextlib.contextmanager
def _on(streams):
    """Make each stream current on its device."""
    with contextlib.ExitStack() as stack:
        for stream in streams:
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
        yield


class _Lane:
    """One dispatch class of a server: its queue (items whose row is first
    and whose future is last), its streams, its batch cap and timers, and
    its dispatcher thread.

    The dispatcher collects a batch, records its requests' waits as `admit`
    spans (where given), pads it to its bucket, takes one of the server's
    device slots, and runs launch(batch, rows, bid), which queues the batch
    on the lane's streams and returns (host result, event or None, context).
    A rank worker waits for the result, then runs rank(host, context, batch)
    inside a serve.rank span of class `cls` (where given). The slot frees in
    _settle, once the result has landed or the launch or the wait has
    failed; a failure fails that batch only."""

    def __init__(self, srv: "_Server", q: queue.Queue, cap: int, wait: float, launch, rank,
                 *, first_wait: float | None = None, admit: str | None = None,
                 cls: str | None = None):
        self.srv, self.q = srv, q
        self.cap, self.wait, self.first_wait = int(cap), wait, first_wait
        self.launch, self.rank = launch, rank
        self.admit, self.cls = admit, cls
        self.streams = _new_streams(srv.ts)
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        srv = self.srv
        with _on(self.streams):
            while not srv._stop.is_set():
                batch = _collect(self.q, self.cap, self.wait, self.first_wait)
                if not batch:
                    continue
                bid = _admitted(self.admit, batch) if self.admit else None
                rows = [item[0] for item in batch]
                rows += [rows[-1]] * (_bucket(len(rows), self.cap) - len(rows))
                # Bound the device queue: a slot frees when a result lands.
                if not _acquire(srv._device_slots, srv._stop):
                    _fail([item[-1] for item in batch], RuntimeError("server closed"))
                    break
                try:
                    out, ready, ctx = self.launch(batch, rows, bid)
                except Exception as e:             # a failed launch fails its batch
                    self._settle(batch, e)
                    continue
                srv._rank_pool.submit(self._finish, out, ready, ctx, batch, bid)

    def _finish(self, out, ready, ctx, batch, bid):
        """Rank-worker side: wait for the batch's result, then rank it."""
        try:
            api._wait(ready)
            host = out.numpy()
        except Exception as e:                     # device failure: fail futures
            self._settle(batch, e)
            return
        self._settle(batch)
        with (trace("serve.rank", parent=bid, cls=self.cls) if self.cls
              else contextlib.nullcontext()):
            self.rank(host, ctx, batch)

    def _settle(self, batch, exc: Exception | None = None) -> None:
        """Free the batch's device slot; with exc, fail its futures."""
        self.srv._device_slots.release()
        if exc is not None:
            _fail([item[-1] for item in batch], exc)


class _Server:
    """What both servers share around their lanes: the checks and timed put
    of submit, the device slots and rank pool, ranking a result, close and
    the context manager."""

    # Whether submit records serve.submit and serve.request spans; its items
    # then carry the submit stamp and the request's id.
    _SPANS = False

    def __init__(self, ts, *, max_queue: int, depth: int, submit_timeout_ms: float,
                 rank_workers: int, prefix: str):
        self.ts = ts
        self.device = ts.device
        self.submit_timeout = submit_timeout_ms / 1e3
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._stop = threading.Event()
        self._device_slots = threading.Semaphore(int(depth))
        self._rank_pool = ThreadPoolExecutor(max_workers=int(rank_workers),
                                             thread_name_prefix=prefix)

    def _start(self, *lanes: _Lane) -> None:
        self._lanes = lanes
        for lane in lanes:
            lane.thread.start()

    def _count(self, key: str) -> None:
        """Count a submission by its outcome (a class with stats)."""

    def _submit(self, x: np.ndarray, shape: tuple, unit: str,
                timeout_ms: float | None) -> Future:
        fut: Future = Future()
        if x.shape != shape:
            fut.set_exception(ValueError(
                f"server is pinned to {shape[0]}-{unit} queries, got {x.shape}"))
            return fut
        if self._stop.is_set():
            fut.set_exception(RuntimeError("server closed"))
            return fut
        wait = self.submit_timeout if timeout_ms is None else timeout_ms / 1e3
        with (trace("serve.submit") if self._SPANS else contextlib.nullcontext()) as span:
            item = (x, fut)
            if span is not None:
                # The request's id is this span's; the future stays last (_drain).
                item = (x, span.t0, span.sid, fut)
                fut.add_done_callback(_request_done(span.t0, span.sid))
            try:
                if wait > 0:
                    self._q.put(item, timeout=wait)
                else:
                    self._q.put_nowait(item)
                self._count("submitted")
            except queue.Full:
                self._count("shed")
                fut.set_exception(ServerSaturated(
                    f"submit queue full ({self._q.maxsize} pending)"))
        return fut

    def _k(self) -> int:
        return self.top_k if self.top_k else self.ts.db.cfg.top_k

    def _rank(self, out_v: np.ndarray, depth: int):
        """One query's (V, 3, K) result rows, ranked together `depth` deep."""
        return _rank_variants(out_v, len(out_v), self.ts.n_real, self.ts.db.track_ids,
                              depth)[0]

    def close(self) -> None:
        self._stop.set()
        for lane in self._lanes:
            try:
                lane.q.put_nowait(None)    # wake the dispatcher
            except queue.Full:
                pass                       # dispatcher is draining; stop flag set
        for lane in self._lanes:
            lane.thread.join()
        self._rank_pool.shutdown(wait=True)
        for lane in self._lanes:           # also what a rank worker queued late
            _drain(lane.q)
        self.ts._drop_graphs([s for lane in self._lanes for s in lane.streams])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MatchServer(_Server):
    """Micro-batching wrapper around TwoStageDB.dispatch_batch."""

    def __init__(self, ts, query_prints: int, *, max_batch: int = 16,
                 max_wait_ms: float = 5.0, depth: int = 2,
                 top_k: int | None = None, pool: int | None = None,
                 max_queue: int = 256, submit_timeout_ms: float = 0.0,
                 rank_workers: int = 4):
        self.n_q = int(query_prints)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.depth = int(depth)
        self.top_k = top_k
        self.pool = pool
        super().__init__(ts, max_queue=max_queue, depth=depth,
                         submit_timeout_ms=submit_timeout_ms, rank_workers=rank_workers,
                         prefix="hpfw-rank")
        self._lane = _Lane(self, self._q, self.max_batch, self.max_wait,
                           self._launch, self._rank_batch)
        self._thread = self._lane.thread
        self._start(self._lane)

    # ---- client surface -------------------------------------------------
    def submit(self, query_prints: np.ndarray,
               timeout_ms: float | None = None) -> Future:
        """Queue one (N, 2)-uint32 query; resolves to (ids, scores, offs).

        When the bounded submit queue is full, blocks up to `timeout_ms`
        (default: the server's submit_timeout_ms) and then resolves the
        future with ServerSaturated.
        """
        return self._submit(np.asarray(query_prints, dtype=np.uint32), (self.n_q, 2),
                            "print", timeout_ms)

    def match(self, query_prints: np.ndarray):
        """Blocking convenience wrapper."""
        return self.submit(query_prints, timeout_ms=None).result()

    def _bucket(self, n: int) -> int:
        return _bucket(n, self.max_batch)

    def warmup(self, example_query: np.ndarray) -> None:
        """Run every batch bucket, so that no first-use cost (the kernel
        build, the allocator's first blocks) falls inside a request; on one
        card twice, the second capturing the bucket's CUDA graph on the
        dispatcher's stream."""
        q = np.asarray(example_query, dtype=np.uint32)
        with _on(self._lane.streams):
            for b in _buckets(self.max_batch):
                for _ in range(2 if self.ts._graphed else 1):
                    out, ready = self._dispatch([q] * b)
                    api._wait(ready)

    # ---- device side ----------------------------------------------------
    def _dispatch(self, rows):
        """Upload one padded batch, queue its match, and start the copy back:
        ((B, 3, K) int32 host tensor, event to wait on or None). No sync."""
        host = torch.from_numpy(np.stack(rows).view(np.int32))
        out_dev = self.ts.dispatch_batch(api._upload(host, self.device), pool=self.pool)
        return api._to_host(out_dev, self._lane.streams[0])

    def _launch(self, batch, rows, bid):
        return (*self._dispatch(rows), None)

    def _rank_batch(self, host, ctx, batch):
        for out_b, (_, fut) in zip(host, batch):
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(self._rank(out_b[None], self._k()))
                except Exception as e:
                    fut.set_exception(e)


class EscalatingMatchServer(_Server):
    """PCM-in serving loop with identity-first rendition-scan escalation:
    api.match_scan_escalating as a service.

    Callers submit raw PCM windows of `query_samples` samples. The rigid
    dispatcher extracts each batch (K1, then K2 a row, keeping the (B, F,
    n_bins) spectra on the device) and makes one rigid dispatch_batch. A
    rank worker resolves the confident answers (api.rigid_confident, ranked
    one deeper than top_k), keeps the unconfident ones whose sub-window
    offsets are collinear when `structure_gate` is set (api.rigid_structured,
    over one copy of those rows' prints to the host), and queues the rest on
    a second dispatch class: the scan dispatcher runs api.scan_from_spec on
    the saved spectra (V K2 launches a query, no new K1), makes one
    dispatch_batch of the (B * V, n, 2) stack, ranks each query's V rows
    together, and overrides the rigid answer only under api.scan_overrides.
    Clean traffic never queues behind scans on the host.

    The two dispatchers own one CUDA stream each on every device of the DB
    (as MatchServer's). A spectrum made on the rigid stream of the first
    device is read on the scan stream there after that stream waits for the
    rigid batch's event, and is recorded on the scan stream so that its
    memory outlives the scan's kernels.

    Futures resolve to (ids, scores, offsets, escalated: bool); `stats`
    counts submitted, confident, structure_kept, escalated, overridden and
    shed queries. Batches pad to powers of 4 (max_batch for the rigid class,
    scan_batch, default max(1, 70 // V), for the scan class).

    Spans (utils/profiling.py; a request's id is its serve.submit span's,
    on the `req` attribute of its other spans; a batch's id is its
    serve.dispatch span's, the `parent` of its other spans):
      - serve.submit: the body of submit, on the caller's thread;
      - serve.admit / serve.scan_admit: a request's wait from submit / from
        its queueing for the scan to the close of its rigid / scan batch;
      - serve.extract, serve.dispatch (rows: queries, padded: bucket rows)
        and serve.rank, a batch each, with cls "rigid" or "scan": K1/K2 or
        the variants' K2, the match queued with its copy back, and the
        ranking once the result has landed;
      - serve.request: submit to the answer or failure, `escalated`.
    """

    _SPANS = True

    def __init__(self, ts, filters, query_samples: int, *,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 scan_batch: int | None = None,
                 scan_wait_ms: float | None = None,
                 depth: int = 2, top_k: int | None = None,
                 pool: int | None = None, max_queue: int = 256,
                 submit_timeout_ms: float = 0.0, rank_workers: int = 4,
                 threshold: float = 0.62, margin: float = 0.04,
                 hi_sim: float = 0.78, override: float = 0.02,
                 span: float | None = None, step: float | None = None,
                 pitch_span_bins: int | None = None,
                 structure_gate: float | None = None,
                 structure_slope_tol: float = 0.005,
                 override_unstructured: float | None = None,
                 interp: str = "linear"):
        cfg = ts.db.cfg
        self.cfg = cfg
        self.n_samples = int(query_samples)
        self.n_q = cfg.n_hashprints(self.n_samples)
        if self.n_q <= 0:
            raise ValueError(f"query window of {query_samples} samples "
                             "yields no hashprints")
        if interp not in ("linear", "nearest"):
            raise ValueError(f"unknown interp {interp!r}")
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.top_k = top_k
        self.pool = pool
        self.gate = dict(threshold=threshold, margin=margin, hi_sim=hi_sim)
        self.override = override
        self.structure_gate = structure_gate
        self.structure_slope_tol = structure_slope_tol
        # The override bar of scans whose rigid answer failed the structure
        # gate: with the gate set, every query in the scan queue did.
        self.override_unstructured = (
            override_unstructured if structure_gate is not None else None)
        if structure_gate is not None and not ts.db.has_prints:
            raise ValueError("structure_gate needs host print rows on ts.db.prints "
                             "or a device-resident DB")
        self.hyps = api.scan_hypotheses(cfg, span, step, pitch_span_bins)
        self.interp = interp
        # About 70 variant rows a scan dispatch, as the reference sizes them.
        self.scan_batch = int(scan_batch) if scan_batch else max(1, 70 // len(self.hyps))
        self.scan_wait = (scan_wait_ms / 1e3 if scan_wait_ms is not None
                          else 2 * self.max_wait)
        super().__init__(ts, max_queue=max_queue, depth=depth,
                         submit_timeout_ms=submit_timeout_ms, rank_workers=rank_workers,
                         prefix="hpfw-esc")
        self._filters = api._filters_on(filters, cfg, self.device)
        self._scan_q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "confident": 0, "escalated": 0,
                      "overridden": 0, "structure_kept": 0, "shed": 0}
        self._rigid = _Lane(self, self._q, self.max_batch, self.max_wait,
                            self._launch_rigid, self._rank_rigid,
                            admit="serve.admit", cls="rigid")
        self._scan = _Lane(self, self._scan_q, self.scan_batch, self.scan_wait,
                           self._launch_scan, self._rank_scan, first_wait=self.scan_wait,
                           admit="serve.scan_admit", cls="scan")
        self._rigid_thread, self._scan_thread = self._rigid.thread, self._scan.thread
        self._start(self._rigid, self._scan)

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    # ---- client surface -------------------------------------------------
    def submit(self, pcm: np.ndarray, timeout_ms: float | None = None) -> Future:
        """Queue one PCM window; resolves to (ids, scores, offs, escalated)."""
        return self._submit(np.asarray(pcm, dtype=np.float32), (self.n_samples,),
                            "sample", timeout_ms)

    def match(self, pcm: np.ndarray):
        """Blocking convenience wrapper."""
        return self.submit(pcm, timeout_ms=None).result()

    def warmup(self, example_pcm: np.ndarray) -> None:
        """Run every rigid and scan batch bucket, so that no first-use cost
        (the kernel build, the allocator's first blocks) falls inside a
        request; on one card each bucket's dispatch twice, the second
        capturing its CUDA graph on its class's stream."""
        p = np.asarray(example_pcm, dtype=np.float32)
        runs = 2 if self.ts._graphed else 1
        spec1 = None
        with _on(self._rigid.streams):
            for b in _buckets(self.max_batch):
                specs, prints = self._extract([p] * b)
                spec1 = specs[0] if spec1 is None else spec1
                for _ in range(runs):
                    self.ts.dispatch_batch(prints, pool=self.pool).cpu()   # waits
        with _on(self._scan.streams):
            for b in _buckets(self.scan_batch):
                stack = self._scan_stack([spec1] * b)
                for _ in range(runs):
                    self._scan_match(stack).cpu()

    # ---- device side ----------------------------------------------------
    def _extract(self, rows):
        """PCM rows -> ((B, F, n_bins) spectra, (B, n_q, 2) int32 prints) on
        the device: K1, then K2 a row, on the current stream."""
        pcms = api._upload(torch.from_numpy(np.stack(rows)), self.device)
        specs = torch.stack([frontend.cqt(p, self.cfg) for p in pcms])
        prints = torch.stack([fp_ops.fingerprint_from_spec(s, self._filters, self.cfg)
                              for s in specs])
        return specs, prints

    def _scan_stack(self, specs) -> torch.Tensor:
        """Saved spectra -> their hypotheses' (B * V, n_q, 2) print stack."""
        return torch.cat([api.scan_from_spec(s, self._filters, self.cfg, self.hyps,
                                             self.interp) for s in specs])

    def _scan_match(self, stack) -> torch.Tensor:
        """A print stack -> (B * V, 3, K), through dispatch_batch in pieces of
        whole queries that fit K5's queries a launch (one piece at the
        default scan_batch); the pool is never shrunk."""
        step = fine.MAX_QUERIES // len(self.hyps) * len(self.hyps)
        return torch.cat([self.ts.dispatch_batch(stack[i:i + step], pool=self.pool)
                          for i in range(0, stack.shape[0], step)])

    # ---- the rigid class: items (pcm, stamp, request id, future) ---------
    def _launch_rigid(self, batch, rows, bid):
        with trace("serve.extract", parent=bid, cls="rigid"):
            specs, prints = self._extract(rows)
        with trace("serve.dispatch", sid=bid, cls="rigid", rows=len(batch),
                   padded=len(rows)):
            out, ready = api._to_host(self.ts.dispatch_batch(prints, pool=self.pool),
                                      self._rigid.streams[0])
        return out, ready, (specs, prints, ready)

    def _rank_rigid(self, host, ctx, batch):
        """Resolve the confident answers first, then the structure gate, then
        queue the rest for the scan."""
        specs, prints, ready = ctx
        unconfident = []
        for b, (_, _, req, fut) in enumerate(batch):
            try:
                ranked = self._rank(host[b][None], max(2, self._k()))
                if api.rigid_confident(ranked[1], self.n_q, **self.gate):
                    self._count("confident")
                    self._resolve(fut, ranked, False)
                else:
                    unconfident.append((b, ranked, req, fut))
            except Exception as e:
                _fail([fut], e)
        if not unconfident:
            return
        qprints = None
        if self.structure_gate is not None:
            # The one copy of the batch's prints, for its unconfident rows.
            qprints = api._to_numpy_prints(prints[[b for b, _, _, _ in unconfident]])
        for j, (b, ranked, req, fut) in enumerate(unconfident):
            try:
                if qprints is not None and len(ranked[0]) and self._structured(qprints[j],
                                                                               ranked):
                    self._count("structure_kept")
                    self._resolve(fut, ranked, False)
                else:
                    self._count("escalated")
                    self._scan_q.put((specs[b], time.perf_counter_ns(), req, ready, ranked,
                                      fut))
            except Exception as e:
                _fail([fut], e)

    def _structured(self, query_prints: np.ndarray, ranked) -> bool:
        db = self.ts.db
        row = db.index_of(ranked[0][0])
        return api.rigid_structured(query_prints, db.print_row(row), int(ranked[2][0]),
                                    inlier=self.structure_gate,
                                    slope_tol=self.structure_slope_tol,
                                    length=int(db.lengths[row]))

    # ---- the scan class: items (spectrum, stamp, request id, rigid event,
    # ---- rigid answer, future) -------------------------------------------
    def _launch_scan(self, batch, specs, sid):
        scan_stream = self._scan.streams[0]
        if scan_stream is not None:
            # The spectra come from the rigid stream: wait for their batch's
            # event, and keep their memory until the scan stream's work on
            # them has run.
            for ev in {id(item[3]): item[3] for item in batch}.values():
                scan_stream.wait_event(ev)
            for s in specs:
                s.record_stream(scan_stream)
        with trace("serve.extract", parent=sid, cls="scan"):
            stack = self._scan_stack(specs)
        with trace("serve.dispatch", sid=sid, cls="scan", rows=len(batch),
                   padded=len(specs)):
            out, ready = api._to_host(self._scan_match(stack), scan_stream)
        return out, ready, None

    def _rank_scan(self, host, ctx, batch):
        # (B * V, 3, K) -> (B, V, 3, K): a query's hypothesis rows rank together.
        host = host.reshape(-1, len(self.hyps), 3, host.shape[-1])
        ov = (self.override_unstructured
              if self.override_unstructured is not None else self.override)
        for out_v, (*_, rigid, fut) in zip(host, batch):
            try:
                ranked = self._rank(out_v, max(2, self._k()))
                if api.scan_overrides(ranked[1], rigid[1], override=ov):
                    self._count("overridden")
                    result = ranked
                else:
                    result = rigid
                self._resolve(fut, result, True)
            except Exception as e:
                _fail([fut], e)

    def _resolve(self, fut: Future, ranked, escalated: bool) -> None:
        if fut.set_running_or_notify_cancel():
            fut.set_result(tuple(x[:self._k()] for x in ranked) + (escalated,))
