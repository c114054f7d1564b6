"""Public API of the PyTorch port; mirrors hpfw_tpu.api:

    fingerprint(audio)      -> hashprint sequence
    match(query, db)        -> ranked track IDs
    build_db(catalog)       -> FingerprintDB
    build_db_from_files(paths) -> FingerprintDB (native decode, io/ingest.py)
    fingerprint_stream(batches) -> hashprints, staged ahead by a thread
    learn_filters(corpus)   -> projection filters

plus the rendition scans (fingerprint_scan_batch, match_scan_escalating over
a TwoStageDB) and multi-bank extraction for known-artist mode
(fingerprint_multi, artist.ArtistDB). Functions take and return numpy with
the shapes and dtypes of hpfw_tpu.api (prints are (N, 2) uint32). Work runs
on the `device` argument, else the device of the filters tensor or DB passed
in, else the card; with no card and no device named, an entry point raises,
so the CPU runs only when the caller asks for it. On a CUDA device the hot
path is the kernels in csrc/; on the CPU it is their plain PyTorch
versions. Nothing falls back from one to the other.
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, HpfwConfig
from .filters import filters_from_jax
from .match import matcher
from .match.align import structure_evidence
from .match.stretch import hypothesis_grid, pitch_grid, stretch_grid
from .ops import fingerprint as fp_ops
from .ops import _build, frontend, fused
from .utils.profiling import record, trace


def default_device() -> torch.device:
    """Where work runs when the caller names no device: the card. Raises when
    torch sees no card; work runs on the CPU only when the caller passes
    device="cpu" (or CPU tensors)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to torch; pass device=\"cpu\" to run the plain "
            "PyTorch versions on the CPU")
    return torch.device("cuda")


def _resolve_device(device, filters) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(filters, torch.Tensor):
        return filters.device
    return default_device()


def _filters_on(filters, cfg: HpfwConfig, device: torch.device) -> torch.Tensor:
    if isinstance(filters, torch.Tensor):
        if tuple(filters.shape) != (cfg.context_dim, cfg.n_filters):
            raise ValueError(f"expected ({cfg.context_dim}, {cfg.n_filters}) "
                             f"filters, got {tuple(filters.shape)}")
        return filters.to(device=device, dtype=torch.float32).contiguous()
    return filters_from_jax(filters, cfg, device)


def _to_numpy_prints(prints: torch.Tensor) -> np.ndarray:
    """int32 prints on any device -> numpy uint32 with the same bits."""
    return prints.cpu().numpy().view(np.uint32)


def _to_tensor_prints(prints: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy uint32 prints -> int32 tensor on device with the same bits."""
    a = np.ascontiguousarray(np.asarray(prints, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(a).to(device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" is the current card)."""
    if a.type != b.type or a.type != "cuda":
        return a.type == b.type

    def index(d):
        return d.index if d.index is not None else torch.cuda.current_device()
    return index(a) == index(b)


def _bucket_pad(pcm: np.ndarray, cfg: HpfwConfig, bucket_s: float) -> np.ndarray:
    """pcm zero-padded up to a multiple of bucket_s seconds (0: as it is)."""
    if bucket_s:
        bucket = max(1, int(round(bucket_s * cfg.sample_rate)))
        padded = -(-pcm.shape[0] // bucket) * bucket
        if padded != pcm.shape[0]:
            pcm = np.concatenate([pcm, np.zeros(padded - pcm.shape[0], np.float32)])
    return pcm


def fingerprint(
    pcm: np.ndarray,
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
    bucket_s: float = 1.0,
) -> np.ndarray:
    """Audio -> packed 64-bit hashprints, shape (N, 2) uint32.

    bucket_s: input length is zero-padded up to this granularity, as in
    hpfw_tpu.api.fingerprint. EXACT: the first n_hashprints(true_len) prints
    depend only on samples within the true length, and only those are
    returned. bucket_s=0 disables.
    """
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    n_true = cfg.n_hashprints(pcm.shape[0])
    if n_true == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    pcm = _bucket_pad(pcm, cfg, bucket_s)
    dev = _resolve_device(device, filters)
    out = fused.fingerprint(torch.from_numpy(pcm).to(dev),
                            _filters_on(filters, cfg, dev), cfg)
    return _to_numpy_prints(out[:n_true])


def fingerprint_batch_device(pcms: torch.Tensor, filters: torch.Tensor,
                             cfg: HpfwConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(B, S) float32 PCM tensor -> (B, N, 2) int32 prints on its device.

    One track at a time, so the working set is one track's spectrum (and, on
    the CPU, one track's frames) whatever B is.
    """
    n = cfg.n_hashprints(pcms.shape[1])
    if n == 0:
        return torch.zeros((pcms.shape[0], 0, 2), dtype=torch.int32,
                           device=pcms.device)
    return torch.stack([fused.fingerprint(p, filters, cfg) for p in pcms])


def fingerprint_batch(
    pcms: np.ndarray,
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Fingerprint a batch of equal-length tracks, shape (B, N, 2) uint32."""
    pcms = np.asarray(pcms, dtype=np.float32)
    if pcms.ndim != 2:
        raise ValueError(f"expected (B, S) PCM batch, got shape {pcms.shape}")
    dev = _resolve_device(device, filters)
    out = fingerprint_batch_device(torch.from_numpy(pcms).to(dev),
                                   _filters_on(filters, cfg, dev), cfg)
    return _to_numpy_prints(out)


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on device: from pinned memory without blocking on a card."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _to_host(out_dev: torch.Tensor, stream):
    """Start the copy of a result to the host: (host tensor, event to wait on
    or None). On a card, a non-blocking copy into fresh pinned memory, then
    an event recorded on `stream`; no sync. On the CPU, out_dev itself."""
    if stream is None:
        return out_dev, None
    out = torch.empty(out_dev.shape, dtype=out_dev.dtype, pin_memory=True)
    out.copy_(out_dev, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(stream)
    return out, ready


def _wait(ready) -> None:
    if ready is not None:
        ready.synchronize()


class _Staged(NamedTuple):
    """A batch ready for the caller: its PCM on the device, and the event its
    upload ends with (None on the CPU, where pcms is the host tensor)."""
    pcms: torch.Tensor
    ready: torch.cuda.Event | None


# Batches the staging queue holds for fingerprint_stream's caller; the staging
# thread works on one more, so it runs one to two batches ahead of the launches.
_STAGE_DEPTH = 1
# The least bytes a staging chunk holds: a batch is cut into one chunk a copy
# thread, but no smaller than this.
_STAGE_MIN_CHUNK_BYTES = 4 << 20


def _stage_threads() -> int:
    """Threads that copy a batch's chunks into pinned memory: one a CPU this
    process may run on. The copy is bound by each core's memory bandwidth,
    and the caller sleeps while it waits for a result (PERF.md, section 6)."""
    return len(os.sched_getaffinity(0))


def _stream_copy(copy, dst: np.ndarray, src: np.ndarray) -> None:
    """One chunk into pinned memory by csrc/stage.cu's streaming stores, with
    the GIL released; the arguments keep both buffers alive while it runs."""
    copy(dst.ctypes.data, src.ctypes.data, src.nbytes)


class _Stager:
    """fingerprint_stream's staging thread and the queue it fills.

    The thread pulls each batch from the input, checks it and stages it: on
    a card, a copy into pinned memory (torch's caching host allocator) in one
    chunk a copy thread by streaming stores (csrc/stage.cu), each chunk's
    upload queued on a copy stream as it lands, and one event recorded after
    the last; on the CPU the host tensor itself. Each staged batch is one `extract.upload` span of the staging
    thread. The input's end, or an exception from the input or the staging,
    follows the batches before it through the queue. close() stops the
    thread and joins it, and with it the copy threads.
    """

    def __init__(self, batches, dev: torch.device):
        self._batches = iter(batches)
        self._dev = dev
        self._copy = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # Built here, on the caller's thread, before any copy thread asks.
        self._copy_fn = _build.library().hpfw_stream_copy if self._copy is not None else None
        self._threads = _stage_threads()
        self._queue: queue.Queue = queue.Queue(maxsize=_STAGE_DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="hpfw-stage", daemon=True)
        self._thread.start()

    def __enter__(self) -> "_Stager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def get(self):
        """The next staged batch; None at the input's end; or the exception
        that ended it. A batch's wait is an `extract.stage_wait` span."""
        t0 = time.perf_counter_ns()
        item = self._queue.get()
        if isinstance(item, _Staged):
            record("extract.stage_wait", t0, time.perf_counter_ns())
        return item

    def close(self) -> None:
        self._stop.set()
        # The thread puts at most one more item once it can see the stop: make
        # room for it, then wait for the thread.
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join()

    def _run(self) -> None:
        with ThreadPoolExecutor(self._threads, thread_name_prefix="hpfw-stage") \
                if self._copy is not None else contextlib.nullcontext() as pool:
            while not self._stop.is_set():
                try:
                    item = self._stage(next(self._batches), pool)
                except StopIteration:
                    item = None
                except Exception as exc:  # raised to the caller in its place
                    item = exc
                self._queue.put(item)
                if not isinstance(item, _Staged):
                    return

    def _stage(self, batch, pool) -> _Staged:
        pcm = np.ascontiguousarray(batch, dtype=np.float32)
        if pcm.ndim != 2:
            raise ValueError(f"expected (B, S) PCM batches, got shape {pcm.shape}")
        if self._copy is None:
            t0 = time.perf_counter_ns()
            record("extract.upload", t0, t0)
            return _Staged(torch.from_numpy(pcm), None)
        with torch.cuda.device(self._dev), torch.cuda.stream(self._copy):
            pinned = torch.empty(pcm.shape, dtype=torch.float32, pin_memory=True).view(-1)
            pcms = torch.empty(pcm.shape, dtype=torch.float32, device=self._dev)
            src, mid, dst = pcm.reshape(-1), pinned.numpy(), pcms.view(-1)
            step = max(_STAGE_MIN_CHUNK_BYTES // src.itemsize, -(-src.size // self._threads))
            chunks = [(a, min(a + step, src.size)) for a in range(0, src.size, step)]
            t0 = time.perf_counter_ns()
            copies = [pool.submit(_stream_copy, self._copy_fn, mid[a:b], src[a:b])
                      for a, b in chunks]
            for (a, b), copied in zip(chunks, copies):
                copied.result()
                dst[a:b].copy_(pinned[a:b], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy)
            record("extract.upload", t0, time.perf_counter_ns())
        return _Staged(pcms, ready)


def fingerprint_stream(
    batches,
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
):
    """Fingerprint an iterator of (B, S) PCM batches, staged ahead of the
    launches by a thread of the call; yields (B, N, 2) uint32 a batch, in
    order.

    A staging thread (_Stager) pulls and checks each batch and, on a card,
    copies it into pinned memory in chunks and uploads each chunk on a copy
    stream as it lands, one to two batches ahead of the caller. The caller
    launches each batch's kernels on the current stream once its upload's
    event is reached, and keeps two batches in flight: each result comes
    back by a non-blocking copy into pinned memory, and the generator waits,
    asleep, only for the batch it yields. On the CPU the same code runs with no
    streams and no copy. An exception from the input (or a batch that is
    not 2-D) is raised after every earlier batch has been yielded. Closing
    the generator stops and joins the staging thread.
    """
    dev = _resolve_device(device, filters)
    filt = _filters_on(filters, cfg, dev)
    pending: list[tuple[torch.Tensor, torch.cuda.Event | None]] = []
    with _Stager(batches, dev) as stager:
        while isinstance(item := stager.get(), _Staged):
            compute = None
            if item.ready is not None:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(item.ready)
                item.pcms.record_stream(compute)  # read on compute, made on the copy stream
            pending.append(_to_host_sleeping(fingerprint_batch_device(item.pcms, filt, cfg),
                                             compute))
            if len(pending) >= 2:
                yield _take(*pending.pop(0))
        for out in pending:
            yield _take(*out)
        if item is not None:
            raise item


def _to_host_sleeping(out_dev: torch.Tensor, stream):
    """_to_host with an event whose waiter sleeps: a waiter on _to_host's
    event spins a core, which fingerprint_stream's copy threads need."""
    if stream is None:
        return out_dev, None
    out = torch.empty(out_dev.shape, dtype=out_dev.dtype, pin_memory=True)
    out.copy_(out_dev, non_blocking=True)
    ready = torch.cuda.Event(blocking=True)
    ready.record(stream)
    return out, ready


def _take(out: torch.Tensor, ready) -> np.ndarray:
    _wait(ready)
    return _to_numpy_prints(out)


# ---- the rendition scan: one spectrum, V re-timed / re-keyed variants ----

@functools.lru_cache(maxsize=16)
def _hypothesis_table(hyps: tuple, device: torch.device) -> torch.Tensor:
    """(V, 2) float32 [tempo factor, bin roll] of the hypotheses on device,
    uploaded once per grid (an upload waits for the card)."""
    return torch.tensor(hyps, dtype=torch.float32).to(device)


def scan_spectra(spec: torch.Tensor, factors, interp: str = "linear") -> torch.Tensor:
    """(F, n_bins) log-mag CQT frames -> (V, F, n_bins) variant spectra on
    spec's device, one a hypothesis: a tempo factor s (a plain float) or an
    (s, roll) pair.

    - TEMPO: catalog frame i <- rendition frame pos = i / s, clamped to
      [0, F - 1]; "linear" blends frames floor(pos) and floor(pos) + 1,
      "nearest" takes round(pos) (half to even, as jnp.round).
    - PITCH: catalog bin k <- query bin k + roll, edge-clamped.

    The gather of hpfw_tpu.api.scan_from_spec (:141-149), in float32 (i / s
    divided, not multiplied by a reciprocal), for all V at once. The
    identity hypothesis (1.0, 0) gives spec itself, bit for bit.
    """
    hyps = tuple(h if isinstance(h, tuple) else (float(h), 0) for h in factors)
    table = _hypothesis_table(hyps, spec.device)
    f, nb = spec.shape
    base = torch.arange(f, dtype=torch.float32, device=spec.device)
    bins = torch.arange(nb, device=spec.device)
    pos = (base[None, :] / table[:, :1]).clamp(0.0, f - 1.0)                # (V, F)
    cols = (bins[None, :] + table[:, 1:].long()).clamp(0, nb - 1)[:, None]  # (V, 1, nb)
    if interp == "linear":
        i0 = pos.floor().long()
        i1 = (i0 + 1).clamp(max=f - 1)
        frac = (pos - i0.to(torch.float32))[..., None]
        return spec[i0[..., None], cols] * (1.0 - frac) + spec[i1[..., None], cols] * frac
    return spec[torch.round(pos).long()[..., None], cols]


def scan_from_spec(spec: torch.Tensor, filters: torch.Tensor, cfg: HpfwConfig,
                   factors, interp: str = "linear") -> torch.Tensor:
    """(F, n_bins) spectrum -> (V, F - halo, 2) int32 prints on its device:
    scan_spectra's variants, each through the encoder (K2 on the card, its
    plain version on the CPU), one launch a variant. The NDFT front end is
    not re-run: every variant shares the one spectrum."""
    return torch.stack([fp_ops.fingerprint_from_spec(sv, filters, cfg)
                        for sv in scan_spectra(spec, factors, interp)])


def scan_hypotheses(cfg: HpfwConfig, span=None, step=None,
                    pitch_span_bins=None) -> tuple:
    """The (tempo factor, pitch roll) product grid a scan call will use.

    Resolves span/step/pitch_span_bins against the config's knobs; the
    combined identity hypothesis (1.0, 0) always sits at index V//2.
    """
    span = span if span is not None else cfg.stretch_span
    step = step if step is not None else cfg.stretch_step
    p = (pitch_span_bins if pitch_span_bins is not None
         else cfg.pitch_span_bins)
    if span <= 0.0 and p <= 0:
        raise ValueError("scan needs a positive stretch span and/or pitch "
                         "span (set cfg.stretch_span / cfg.pitch_span_bins "
                         "or pass span= / pitch_span_bins=)")
    factors = stretch_grid(span, step) if span > 0.0 else [1.0]
    return tuple(hypothesis_grid(factors, pitch_grid(max(p, 0))))


def fingerprint_scan_batch_device(pcms: torch.Tensor, filters: torch.Tensor,
                                  cfg: HpfwConfig, hyps, interp: str = "linear"
                                  ) -> torch.Tensor:
    """(B, S) float32 PCM tensor -> (B, V, N, 2) int32 prints on its device:
    one CQT a track, then scan_from_spec over the hypotheses."""
    n = cfg.n_hashprints(pcms.shape[1])
    if n == 0:
        return torch.zeros((pcms.shape[0], len(hyps), 0, 2), dtype=torch.int32,
                           device=pcms.device)
    return torch.stack([scan_from_spec(frontend.cqt(p, cfg), filters, cfg, hyps, interp)
                        for p in pcms])


def fingerprint_scan_batch(
    pcms: np.ndarray,
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    span: float | None = None,
    step: float | None = None,
    pitch_span_bins: int | None = None,
    interp: str = "linear",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """(B, S) PCM -> (B, V, N, 2) uint32: rendition-hypothesis variants.

    V = (2*span/step + 1) * (2*pitch_span_bins + 1) catalog-tempo,
    catalog-key re-extractions a query, sharing one CQT. Feed the stack to
    TwoStageDB.match_batch: a 4-D batch ranks each query's variant rows
    together. span/step/pitch_span_bins default to the config's knobs. The
    middle variant (index V//2) is the identity hypothesis: exactly the
    plain extraction.
    """
    pcms = np.asarray(pcms, dtype=np.float32)
    if pcms.ndim != 2:
        raise ValueError(f"expected (B, S) PCM batch, got shape {pcms.shape}")
    if interp not in ("linear", "nearest"):
        raise ValueError(f"unknown interp {interp!r}")
    hyps = scan_hypotheses(cfg, span, step, pitch_span_bins)
    dev = _resolve_device(device, filters)
    out = fingerprint_scan_batch_device(torch.from_numpy(pcms).to(dev),
                                        _filters_on(filters, cfg, dev), cfg, hyps, interp)
    return _to_numpy_prints(out)


# ---- identity-first matching with rendition-scan escalation ----

def rigid_confident(scores, n_prints: int, *, threshold: float = 0.62,
                    margin: float = 0.04, hi_sim: float = 0.78) -> bool:
    """The escalation gate: is a rigid ranked result CONFIDENT (final)?

    True when top-1 similarity >= hi_sim, or >= threshold with a top1->top2
    relative margin >= margin (wrong answers sit nearly tied with their
    imposter tail). hi_sim <= 0 disables escalation entirely.
    """
    if hi_sim <= 0.0:
        return True
    if not len(scores):
        return False
    s1 = float(scores[0])
    if s1 >= hi_sim * 64.0 * n_prints:
        return True
    if s1 < threshold * 64.0 * n_prints:
        return False
    s2 = float(scores[1]) if len(scores) > 1 else 0.0
    return (s1 - s2) / max(s1, 1e-9) >= margin


def scan_overrides(scan_scores, rigid_scores, *,
                   override: float = 0.02) -> bool:
    """The override rule: a scan result replaces the rigid answer only when
    its top score beats the rigid top score by the relative `override`
    margin."""
    if not len(scan_scores):
        return False
    rigid_s = float(rigid_scores[0]) if len(rigid_scores) else 0.0
    return float(scan_scores[0]) > (1.0 + override) * rigid_s


def rigid_structured(query_prints, track_prints, offset, *,
                     inlier: float = 0.75, slope_tol: float = 0.005,
                     k: int = 8, band: int = 24, tol: float = 2.0,
                     length: int | None = None) -> bool:
    """Structural second opinion on a rigid answer (match/align.py): True
    when the sub-window offsets' Theil-Sen fit has inlier_frac >= `inlier`
    and |slope| <= `slope_tol`."""
    ev = structure_evidence(np.asarray(query_prints), np.asarray(track_prints),
                            int(offset), k=k, band=band, tol=tol, length=length)
    return ev["inlier_frac"] >= inlier and abs(ev["slope"]) <= slope_tol


def match_scan_escalating(
    pcms: np.ndarray,
    filters,
    ts,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    threshold: float = 0.62,
    margin: float = 0.04,
    hi_sim: float = 0.78,
    override: float = 0.02,
    span: float | None = None,
    step: float | None = None,
    pitch_span_bins: int | None = None,
    top_k: int | None = None,
    pool: int | None = None,
    batch: int = 10,
    retry_pool: int | None = None,
    retry_fine_window: int | None = None,
    structure_gate: float | None = None,
    structure_slope_tol: float = 0.005,
    override_unstructured: float | None = None,
    stats: dict | None = None,
) -> list:
    """Identity-first matching with rendition-scan escalation against a
    TwoStageDB ts, as hpfw_tpu.api.match_scan_escalating (its docstring has
    the measurements behind each rung).

    Every query is extracted and matched rigid. A query whose rigid answer
    is not confident (rigid_confident) may first be re-matched rigid with
    retry_pool / retry_fine_window, then kept when structure_gate is set and
    its sub-window offsets are collinear at ~zero slope (rigid_structured);
    the rest escalate: fingerprint_scan_batch's (B, V, N, 2) stack is matched
    with every hypothesis ranking together, and replaces the rigid answer
    when scan_overrides (with override_unstructured as the bar for answers
    the structure gate rejected, when both are set). Extraction runs on
    ts.device.

    Returns match_batch-shaped results: a list of (ids, scores, offsets).
    If `stats` is given it is filled with {"escalated": [indices],
    "overridden": [indices], "retried": [indices], "structure_kept":
    [indices]}.
    """
    pcms = np.asarray(pcms, dtype=np.float32)
    if pcms.ndim != 2:
        raise ValueError(f"expected (B, S) PCM batch, got shape {pcms.shape}")
    dev = ts.device
    filt = _filters_on(filters, cfg, dev)
    prints = fingerprint_batch(pcms, filt, cfg, device=dev)
    n = prints.shape[1]
    k_int = max(2, top_k if top_k is not None else cfg.top_k)
    results = []
    for i in range(0, prints.shape[0], batch):
        results.extend(ts.match_batch(prints[i:i + batch], top_k=k_int,
                                      pool=pool, stretch_span=0.0))

    def unconfident(items):
        return [i for i in items
                if not rigid_confident(results[i][1], n, threshold=threshold,
                                       margin=margin, hi_sim=hi_sim)]

    low = unconfident(range(len(results)))
    if stats is not None:
        stats["escalated"] = []
        stats["overridden"] = []
        stats["retried"] = list(low) if (retry_pool or retry_fine_window) else []
        stats["structure_kept"] = []
    if low and (retry_pool or retry_fine_window):
        for i in range(0, len(low), batch):
            chunk = low[i:i + batch]
            retried = ts.match_batch(prints[chunk], top_k=k_int,
                                     pool=retry_pool or pool,
                                     fine_window=retry_fine_window,
                                     stretch_span=0.0)
            for j, r in zip(chunk, retried):
                results[j] = r
        low = unconfident(low)
    if low and structure_gate is not None:
        kept, still = [], []
        for i in low:
            ids, sc, off = results[i]
            if len(ids) and rigid_structured(
                    prints[i], ts.db.print_row(ts.db.index_of(ids[0])), off[0],
                    inlier=structure_gate, slope_tol=structure_slope_tol,
                    length=int(ts.db.lengths[ts.db.index_of(ids[0])])):
                kept.append(i)
            else:
                still.append(i)
        low = still
        if stats is not None:
            stats["structure_kept"] = kept
    if stats is not None:
        stats["escalated"] = list(low)
    if low:
        stacks = fingerprint_scan_batch(pcms[low], filt, cfg, span=span, step=step,
                                        pitch_span_bins=pitch_span_bins, device=dev)
        # About 70 variant rows a dispatch, as the reference sizes them.
        sbatch = max(1, min(batch, 70 // stacks.shape[1]))
        rescued = []
        for i in range(0, stacks.shape[0], sbatch):
            rescued.extend(ts.match_batch(stacks[i:i + sbatch], top_k=k_int,
                                          pool=pool))
        ov = (override_unstructured
              if (structure_gate is not None
                  and override_unstructured is not None) else override)
        for i, r in zip(low, rescued):
            if scan_overrides(r[1], results[i][1], override=ov):
                results[i] = r
                if stats is not None:
                    stats["overridden"].append(i)
    k = top_k if top_k is not None else cfg.top_k
    if k < k_int:   # the internal rank ran deeper for the margin test
        results = [(ids[:k], sc[:k], off[:k]) for ids, sc, off in results]
    return results


# ---- known-artist extraction and filter learning ----

def fingerprint_multi(
    pcm: np.ndarray,
    filter_stack,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Fingerprint one clip under A filter banks -> (A, N, 2) uint32.

    One CQT (K1 on the card), then the encoder once a bank (K2), on the
    spectrum fingerprint() computes for the clip (padded the same way), so
    row a equals fingerprint(pcm, filter_stack[a]) on the same device bit
    for bit. filter_stack: (A, context_dim, 64), numpy or a tensor.
    """
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    if not isinstance(filter_stack, torch.Tensor):
        filter_stack = np.asarray(filter_stack, dtype=np.float32)
    if filter_stack.ndim != 3:
        raise ValueError(f"expected (A, D, 64) filter stack, got {tuple(filter_stack.shape)}")
    n_true = cfg.n_hashprints(pcm.shape[0])
    if n_true == 0:
        return np.zeros((filter_stack.shape[0], 0, 2), dtype=np.uint32)
    dev = _resolve_device(device, filter_stack)
    spec = frontend.cqt(torch.from_numpy(_bucket_pad(pcm, cfg, 1.0)).to(dev), cfg)
    out = torch.stack([fp_ops.fingerprint_from_spec(spec, _filters_on(f, cfg, dev), cfg)
                       for f in filter_stack])
    return _to_numpy_prints(out[:, :n_true])


def learn_filters(
    corpus: list[np.ndarray],
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Learn the 64 spectro-temporal projection filters: streaming covariance
    of context vectors (K1 and a float32 X^T X GEMM a track, on device) and
    a float64 eigh on the host; see learn/pca.py. Returns (context_dim, 64)
    float32."""
    from .learn import pca

    return pca.learn_filters(corpus, cfg, device=device)


def match(
    query_prints: np.ndarray,
    db: "FingerprintDB",
    *,
    top_k: int | None = None,
):
    """Rank DB tracks against a query print sequence, on the DB's device.

    Returns (track_ids, scores, offsets) sorted by descending similarity,
    ties broken by ascending track index — identical to oracle.match.
    """
    top_k = top_k if top_k is not None else db.cfg.top_k
    prints, lengths = db.device_arrays()
    q = _to_tensor_prints(query_prints, prints.device)
    if q.shape[0] > prints.shape[1]:
        # Oracle semantics for tracks shorter than the query are truncated
        # head overlap at offset 0; padding the print array up to the query
        # length makes the masked scan reproduce that exactly.
        pad = prints.new_zeros((prints.shape[0], q.shape[0] - prints.shape[1], 2))
        prints = torch.cat([prints, pad], dim=1)
    scores, offsets = matcher.score_tracks(q, prints, lengths)
    both = torch.stack([scores, offsets]).cpu().numpy()
    order, s, o = matcher.rank(both[0], both[1], top_k)
    return [db.track_ids[i] for i in order], s, o


class FingerprintDB:
    """In-memory fingerprint database: packed prints + config + filters.

    Saves and loads the same format_version=1 .npz as hpfw_tpu.api's
    FingerprintDB, and holds its device arrays on `device` (default: the
    card; raises when torch sees none).

    prints is either a (T, L, 2) uint32 host array, uploaded to `device` on
    the first device_arrays(), or a (T, L, 2) int32 tensor (the bits of
    uint32) already on `device` (default: its own). A DB built from a tensor
    is device-resident: device_arrays() returns that very tensor, and no
    host copy of the prints exists until something reads the `prints`
    attribute (save(), a mesh split, an explicit host user), which copies
    them back once. host_bytes says how many bytes of prints the DB holds
    in host memory. lengths may be a host array or a tensor; the DB keeps
    a host copy of them either way.
    """

    def __init__(self, cfg: HpfwConfig, filters: np.ndarray,
                 track_ids: list[str], prints: np.ndarray | torch.Tensor,
                 lengths: np.ndarray | torch.Tensor,
                 *, device: str | torch.device | None = None):
        self.cfg = cfg
        self.filters = np.asarray(filters, dtype=np.float32)
        self.track_ids = list(track_ids)
        self._device_arrays = None
        self._resident = None
        if isinstance(prints, torch.Tensor):
            if prints.dtype != torch.int32:
                raise ValueError(f"device prints must be int32, got {prints.dtype}")
            self.device = prints.device if device is None else torch.device(device)
            if not _same_device(prints.device, self.device):
                raise ValueError(f"prints are on {prints.device}, not on {self.device}")
            self._resident = prints.contiguous()    # (T, L, 2) padded
            self._host = None
        else:
            self._host = np.asarray(prints, dtype=np.uint32)    # (T, L, 2) padded
            self.device = torch.device(device) if device is not None else default_device()
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.cpu().numpy()
        self.lengths = np.asarray(lengths, dtype=np.int32)   # (T,)
        shape = tuple(self._print_rows().shape)
        t = len(self.track_ids)
        if len(shape) != 3 or shape[0] != t or shape[2] != 2:
            raise ValueError(f"prints must be ({t}, L, 2), got {shape}")
        if self.lengths.shape != (t,):
            raise ValueError(f"lengths must be ({t},), got {self.lengths.shape}")
        if t and (self.lengths.min() < 0 or self.lengths.max() > shape[1]):
            raise ValueError("track lengths must lie in [0, L]")
        if self._resident is not None:
            self._device_arrays = (self._resident,
                                   torch.from_numpy(self.lengths).to(self.device))
        self._id_index = None

    def _print_rows(self):
        """The prints as held: the device tensor of a resident DB, else the
        host array (None once prints was set to None)."""
        return self._resident if self._resident is not None else self._host

    @property
    def prints(self) -> np.ndarray | None:
        """(T, L, 2) uint32 host prints. On a resident DB the first read
        copies them from the device (a db.host_copy span) and keeps the copy."""
        if self._host is None and self._resident is not None:
            with trace("db.host_copy", bytes=self._resident.nbytes):
                self._host = _to_numpy_prints(self._resident)
        return self._host

    @prints.setter
    def prints(self, value) -> None:
        """Replace the host prints (None: the DB holds no print rows); a
        resident DB's device tensor goes with them."""
        self._host = None if value is None else np.asarray(value, dtype=np.uint32)
        self._resident = None

    @property
    def has_prints(self) -> bool:
        """Whether the DB holds print rows, on the host or on its device."""
        return self._print_rows() is not None

    @property
    def host_bytes(self) -> int:
        """Bytes of prints held in host memory."""
        return self._host.nbytes if self._host is not None else 0

    def print_row(self, i: int) -> np.ndarray:
        """(L, 2) uint32 prints of row i, from the host copy where there is one,
        else one row copied from the device."""
        if self._host is not None or self._resident is None:
            return self._host[i]
        return _to_numpy_prints(self._resident[i])

    def index_of(self, track_id: str) -> int:
        """Track-id -> row index."""
        if self._id_index is None:
            self._id_index = {t: i for i, t in enumerate(self.track_ids)}
        return self._id_index[track_id]

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(T, L, 2) int32 prints and (T,) int32 lengths on self.device (a
        resident DB's own tensor; host prints uploaded once, a db.upload span)."""
        if self._device_arrays is None:
            with trace("db.upload", bytes=self._host.nbytes):
                self._device_arrays = (_to_tensor_prints(self._host, self.device),
                                       torch.from_numpy(self.lengths).to(self.device))
        return self._device_arrays

    @property
    def n_tracks(self) -> int:
        return len(self.track_ids)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            format_version=np.int32(1),
            config_json=np.frombuffer(self.cfg.to_json().encode(), dtype=np.uint8),
            filters=self.filters,
            track_ids=np.array(self.track_ids),
            prints=self.prints,
            lengths=self.lengths,
        )

    @classmethod
    def load(cls, path: str, *,
             device: str | torch.device | None = None) -> "FingerprintDB":
        with np.load(path, allow_pickle=False) as z:
            if int(z["format_version"]) != 1:
                raise ValueError(
                    f"unsupported DB format version {int(z['format_version'])}")
            cfg = HpfwConfig.from_json(bytes(z["config_json"].tobytes()).decode())
            return cls(cfg, z["filters"], [str(t) for t in z["track_ids"]],
                       z["prints"], z["lengths"], device=device)


def build_db(
    catalog: dict[str, np.ndarray] | list[np.ndarray],
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
) -> FingerprintDB:
    """Fingerprint a catalog of tracks into a matchable database on device."""
    if isinstance(catalog, dict):
        ids, tracks = list(catalog.keys()), list(catalog.values())
    else:
        ids = [str(i) for i in range(len(catalog))]
        tracks = list(catalog)
    dev = _resolve_device(device, filters)
    filt = _filters_on(filters, cfg, dev)
    fps = [fingerprint(t, filt, cfg, device=dev) for t in tracks]
    prints, lengths = matcher.pad_prints(fps, min_len=1)
    host_filters = filt.cpu().numpy()
    return FingerprintDB(cfg, host_filters, ids, prints, lengths, device=dev)


def build_db_from_files(
    paths: list[str],
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    n_threads: int = 0,
    batch: int = 8,
    bucket_seconds: float = 30.0,
    track_ids: list[str] | None = None,
    progress=None,
    device: str | torch.device | None = None,
) -> FingerprintDB:
    """Fingerprint a catalog of audio files into a matchable database.

    The threaded native decoder (io/ingest.load_files) decodes and resamples
    chunk i + 1 on a host thread while chunk i extracts on device. A chunk's
    tracks are sorted by length, zero-padded up to a multiple of
    `bucket_seconds` and extracted `batch` rows at a time
    (fingerprint_batch_device; on a card each group uploads from pinned
    memory); each row keeps the cfg.n_hashprints of its true length, which
    depend only on samples inside it. track_ids default to the paths;
    progress(done, total) is called after each chunk.
    """
    from concurrent.futures import ThreadPoolExecutor

    from .io.ingest import load_files

    dev = _resolve_device(device, filters)
    filt = _filters_on(filters, cfg, dev)
    bucket = max(int(bucket_seconds * cfg.sample_rate), cfg.min_samples())
    fps: list[np.ndarray | None] = [None] * len(paths)
    chunk = max(batch * 4, 32)
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(load_files, list(paths[:chunk]), cfg, n_threads)
        start = 0
        while start < len(paths):
            pcms = fut.result()
            nxt = start + len(pcms)
            if nxt < len(paths):
                fut = ex.submit(load_files, list(paths[nxt:nxt + chunk]), cfg, n_threads)
            order = sorted(range(len(pcms)), key=lambda i: pcms[i].shape[0])
            for g0 in range(0, len(order), batch):
                grp = order[g0:g0 + batch]
                longest = max(pcms[i].shape[0] for i in grp)
                s = -(-max(longest, cfg.min_samples()) // bucket) * bucket
                arr = np.zeros((len(grp), s), np.float32)
                for row, i in enumerate(grp):
                    arr[row, : pcms[i].shape[0]] = pcms[i]
                out = _to_numpy_prints(fingerprint_batch_device(
                    _upload(torch.from_numpy(arr), dev), filt, cfg))
                for row, i in enumerate(grp):
                    fps[start + i] = out[row, : cfg.n_hashprints(pcms[i].shape[0])]
            if progress is not None:
                progress(nxt, len(paths))
            start = nxt
    ids = list(track_ids) if track_ids is not None else [str(p) for p in paths]
    prints, lengths = matcher.pad_prints(fps, min_len=1)
    return FingerprintDB(cfg, filt.cpu().numpy(), ids, prints, lengths, device=dev)
