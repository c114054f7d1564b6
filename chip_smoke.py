#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printing its own line; any failure raises and exits non-zero:
  1. device check: a CUDA card, its name and power limit (nvidia-smi), and
     TF32 off for float32 products;
  2. build the CUDA kernels from hpfw_tpu_torch/csrc (one nvcc a source);
  3. each kernel against its plain PyTorch version on the card, at main-path
     shapes of the default config, and K2 on 67-frame windows (the streaming
     launch, 32 prints) cut from the 240 s spectrum, equal to the whole-track
     prints bit for bit;
  4. the slice (BASELINE config 1): a 100-track DB of 20 s synthetic tracks
     built through api.build_db on the card, a noisy 10 s query identified
     at the right offset, and an exact excerpt scoring 64*N;
  5. a dense scan of a planted 1,000 x 7,701-print catalog;
  6. every kernel launched during phase 4, by the launch counters;
  7. times of each kernel and its plain version (K1 and K2 also beside
     torch.matmul of their operands, K3 beside conv1d of the tracks' 0/1 bit
     channels by the +-1 query, and their bounds, at every shape), the
     16 x 240 s extraction realtime factor, and the config-1 query latency;
  8. the catalog of BASELINE config 4 at benchmarks/config4_scale.py's own
     defaults: 100,000 random tracks x 60 s, 20 planted noisy 10 s queries;
then, for each of HpfwConfig() (phase-aligned plants) and
HpfwConfig.catalog_scale() (misphased plants), on a TwoStageDB on the card:
  9. K4 (csrc/coarse.cu) at its surfaces and K5 (csrc/fine.cu) against their
     plain versions at the catalog's shapes, exactly equal, and K4 on 1,024
     rows of ~5,000 windows (31 pass-1 rows each), which it streams in chunks;
 10. the slice: TwoStageDB.match on each query and match_batch in batches of
     8, 8 and 4; every query ranks its planted track first at the (score,
     offset) of K3's dense scan of that track, and batched equals single;
 11. the kernels launched during phase 10, by the launch counters;
 12. times of K4, K5 and their plain versions, the single-query match
     latency and the batch-of-8 queries per second;
then, on the catalog_scale() catalog, whose rows also hold 16 synthetic
60 s stream tracks extracted on the card in phase 8:
 13. the pass-1 DB nibble-packed (5,248 -> 2,688 B a row): packed K4 equal to
     its plain version and to int8 K4 on 8,192 rows x 16 lanes (the long body)
     and x 512 lanes of 128-print queries (the short body); the HBM
     load-floor probe (csrc/probe.cu) equal to torch.sum over the coarse DB
     and the packed pass-1 DB, and its GB/s;
 14. TwoStageDB(prefilter_pack4=True): all 20 queries through match and
     match_batch identical to phase 10's int8 DB, pass 1 only on packed K4;
 15. MatchServer over it under Poisson load (benchmarks/config4_serve.py's
     settings): single queries equal ts.match, p50/p99, achieved q/s, shed
     share and recall at 100-800 offered q/s, and the knee;
 16. StreamingPool at B = 8 and 16 (benchmarks/config3_pool.py's protocol):
     every stream identifies its planted track; tick ms and streams a card;
 17. StreamingSession (rigid) on one 30 s stream; match and step p50/p99;
 18. filter learning at BASELINE config 5's sizes (12 synthetic 30 s tracks):
     api.learn_filters on the card (12 K1 launches) against the same corpus
     through the plain versions on the card; X^T X to rtol 1e-4, the counts
     equal, every filter's |cos| > 0.98, and finalize_filters of the card's
     state equal to learn_filters' result; seconds a track, the X^T X GEMM's
     time and bound;
 19. the rendition scan on phase 10's catalog_scale() TwoStageDB: 4 in-tempo
     noisy 10 s excerpts of stream tracks and 4 renditions pitched +0.5
     semitone (2.9% fast) through match_scan_escalating(span=0.03,
     pitch_span_bins=1), V = 21: the renditions alone escalate, all 8 rank
     their tracks first, stats equal the same call through the plain
     extraction on the card (results too where the query's prints do), the
     identity row equals plain extraction and every variant's K2 prints are
     within K2's gate of the plain encoder; in an escalated match_batch every
     K4 and K5 call equals its plain version on the same inputs, and the
     dispatch through the plain K4 and K5 gives the same results as an eager
     call, a capture and a replay of its CUDA graph; scan extraction and
     escalated match_batch times;
 20. known-artist mode at config 5's artist_eval sizes (6 artists x 8 tracks
     x 30 s): ArtistDB.build on the card, known- and unknown-artist matches
     of noisy excerpts, dense and scaled=True, each ranking its track first
     with equal top hits, every K3, K4 and K5 call of them equal to its plain
     version on the same inputs; fingerprint_multi equal to per-bank
     fingerprint and within K2's gate of the plain versions; build seconds
     and fingerprint_multi time at A = 6;
 21. the streaming spec scan: StreamingSession over phase 14's packed
     TwoStageDB with the catalog_scale() config plus stretch_span 0.03 and
     pitch_span_bins 1 (V = 21), fed a 30 s stream track played 2.9% fast
     and +0.5 semitone in 0.25 s chunks: it acquires, locks pitch +1 bin and
     a tempo within a grid step of 1.03, tracks, and names the track, its
     dispatches replaying CUDA graphs; every K2 call within K2's gate; the
     same stream with eager dispatches, every K4/K5 call equal to its plain
     version, and through the plain K1/K2/K4/K5 on the card gives the same
     states and top tracks every feed, and the same window top hit wherever
     the prints are equal; an in-tempo stream locks at
     (1.0, 0) and goes rigid-only; a 12 s rendition over phase 4's dense DB
     (K3 once a hypothesis while acquiring); match and step p50/p99 while
     acquiring and while tracking;
 22. EscalatingMatchServer (V = 21, max_batch 16) over the same DB on phase
     19's 8 queries, without and with the structure gate: every future
     equals api.match_scan_escalating on the same PCM (ids, scores,
     offsets, escalated), alone and together, and the stats agree; then
     Poisson load at 25 and 50 q/s, a quarter renditions, every served
     answer equal to its query's answer alone (the spectra's hand-off from
     the rigid to the scan stream): p50/p99 of confident and escalated
     queries, achieved q/s, shed share, recall;
 23. file ingestion: 64 synthetic 30 s tracks saved as 44.1 kHz stereo WAV,
     api.build_db_from_files (native decode and resampling, bucket-padded
     batches of 8) within K2's gate of api.build_db over load_files' PCM, a
     noisy excerpt of one file found at its offset; seconds of the native
     build, the decode and the whole build, tracks a second;
 24. api.fingerprint_stream over 8 batches of 16 x 240 s: each batch equal
     to fingerprint_batch bit for bit; its realtime factor (host clock,
     uploads included) beside the card-resident batch's (CUDA events), in
     turns;
then the track-sharded matchers, on a mesh of the one card (db_mesh(1), D =
1) and of 4 logical shards on it (Mesh([cuda:0] * 4), D = 4):
 25. dryrun_multichip(4) on the 4 logical shards: the covariance sum, a
     sharded_score, a sharded match, match_batch and two-pass prefilter pass
     the reference's checks, with K1 and K3 4 times and K4/K5 4 times a
     match;
 26. ShardedDB over phase 5's planted catalog at D = 1 and 4: the top 10
     equal api.match's, K3 D times a match and equal to its plain version;
 27. TwoStageDB(prefilter_pack4=True, mesh=) over the catalog_scale()
     catalog at D = 1 and 4: at D = 1 all 20 queries equal the unsharded
     DB's through match and match_batch (8, 8, 4), at both D every plant
     first at K3's (score, offset); D times the unsharded DB's launches; a
     dispatch_batch of 8 under torch.cuda.set_sync_debug_mode("error") (no
     host sync); every K4/K5 call of one match equal to its plain version;
     match latency and match_batch queries/s of the unsharded DB, D = 1 and
     D = 4, in turns, and a torch.profiler account of a match of the
     unsharded DB and of D = 4 (launches, host and device ms);
 28. MatchServer over the D = 4 DB: queries alone equal its match, and
     under Poisson load at 50 q/s every answer equals its query's alone;
 29. phase 21's dense spec-scan session fed again over a D = 4 ShardedDB of
     phase 4's DB: the same states and top tracks on every feed, the same
     top hits where the prints are equal, 4 times the K3 launches, and every
     K3 call of one scanned window equal to its plain version;
 30. ArtistDB(scaled=True, mesh=) over phase 20's banks at D = 4: every
     known- and unknown-artist match equals the unsharded scaled banks',
     with 4 times their K4/K5 launches, and the K4/K5 calls of one match
     equal to their plain versions;
then the port's remaining surfaces at the default config:
 31. the CLI (hpfw_tpu_torch/cli.py): `demo` (10 x 8 s) as a subprocess
     exits 0 with OK; `artist-demo` and `selfcheck` in-process; over phase
     23's 64 WAV files (written again): `learn` on 12, `build-db` of all 64
     equal to api.build_db_from_files, `fingerprint` on the card against
     `--cpu` (the native C++ extraction) within selfcheck's 1e-4 of the
     bits, 8 noisy 10 s queries at -12 dB through `match --db`,
     `match --scaled` and `build-cache` + `match --cache` of the same files
     under catalog_scale(): each ranks its file first and prints the API's
     top 5 (ids, scores, offsets); `stream` of one file ends on it, `pool`
     of 8 identifies each, `build-artist-db` of 4 x 8 x 30 s artist tracks
     and `match-artist` with and without --artist rank the track first;
     K1-K5 launched, one `match --scaled`'s K4/K5 equal to their plain
     versions; each subcommand's host seconds;
 32. utils.profiling around 5 catalog_scale() TwoStageDB.match calls of
     phase 10's DB: trace.json holds the 5 `match` scopes and K4's and K5's
     kernels; scope_stats and the card's busy share inside each scope (the
     union of kernel intervals over the scope's length);
 33. io/synth_device.py: 2,048 x 60 s tracks rendered on the card in
     batches of 64, each batch fingerprinted there and only the prints
     kept, a FingerprintDB of them; 20 query_batch excerpts (10 s, -12 dB)
     rank their tracks first; each cover in the first 100 tracks scores its
     source above every unrelated track; 8 x 6 s rendered on the card
     against the same call on the CPU within the CPU tests' tolerance;
     tracks rendered a second;
 34. the float64 oracle's margin audit (oracle/audit.py) of the card's
     prints at HpfwConfig(), through K1 -> K2 and through the plain versions
     on the card: api.fingerprint of 8, 15 and 30 s synthetic tracks and of
     phase 3's 240 s track, and K2 on phase 3's 32-print windows of the
     240 s spectrum; the differing and free bits of each;
 35. graft_entry.entry(): its forward step on the card launches K1 and K2
     once each, its prints pass the audit, its time by CUDA events;
 36. TwoStageDB.warmup in fresh processes: a catalog_scale() cache of phase
     33's prints loaded, in turns, by a process that runs warmup([430],
     batch_sizes=(16,)) and one that does not; each one's first match and
     the median of the next 21 (host clock), the same answers in all.
Each path (phases 4, 10, 14-33, 35, and 36's processes) runs with the launch
counters set to 0 just before it and read just after; comparison and timing
launches are not counted, and a plain-version run checks that K1 and K2 did
not launch. A run whose K3-K5 calls are held to their plain versions forces
eager dispatches (a CUDA graph replays its kernels without calling them), so
it is a pass of its own, outside the counted path. Kernel times are CUDA events over launches queued behind a
spin kernel (cuda_ms). The last two lines are a JSON object of per-kernel
results (time, plain and library time, bound) and {"ok": true, "device":
{...}}.
Imports nothing of jax or hpfw_tpu.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CFG1_TRACKS, CFG1_SECONDS = 100, 20.0      # BASELINE config 1 catalog
QUERY_TRACK, QUERY_START_S, QUERY_SECONDS = 42, 3.0, 10.0
EXCERPT_TRACK, EXCERPT_PRINT = 7, 50
LONG_SECONDS = 240.0                        # bench.py's track length
BATCH = 16                                  # bench.py's batch
CAT_TRACKS, CAT_PRINTS, CAT_QUERY = 1000, 7701, 380   # 180 s tracks, 10 s query
CAT_PLANT_TRACK, CAT_PLANT_OFFSET = 617, 4321
# BASELINE config 4, benchmarks/config4_scale.py:49 defaults.
CFG4_TRACKS, CFG4_SECONDS, CFG4_QUERY_SECONDS, CFG4_QUERIES = 100_000, 60, 10, 20
CFG4_FLIP = 0.15
CFG4_BATCHES = (8, 8, 4)
KERNEL_ROWS = 8192          # K4 rows scanned, and pooled rows a query for the rescan
LONG_ROWS, LONG_TRACKS = 1024, 31   # K4 on rows of 31 tracks' windows (~5,000)
FINE_QUERIES, FINE_CANDIDATES = 8, 1024
# Serving (benchmarks/config4_serve.py) and streaming (benchmarks/config3_pool.py).
SERVE_LOADS = (100.0, 200.0, 400.0, 800.0)
SERVE_KW = dict(max_batch=16, max_wait_ms=4.0, depth=2, max_queue=64)
STREAMS, STREAM_SECONDS, STREAM_SEED = 16, 60.0, 7000
POOL_SIZES, CHUNK_PRINTS, QUERY_PRINTS = (8, 16), 32, 128
SHORT_QUERIES = 256         # phase 13: queries of the short body, x 2 phases = 512 lanes
POOL_WARM_TICKS, POOL_TICKS = QUERY_PRINTS // CHUNK_PRINTS + 3, 30
WINDOW_OFFSETS = (0, 1, 37, 113, 4000)      # K2's 32-print windows cut from the 240 s spectrum
SESSION_SECONDS = 30.0
LIVE_CHUNK_S, DENSE_LIVE_SECONDS = 0.25, 12.0     # phase 21's feed and dense stream
ESC_LOADS, ESC_QUERIES = (25.0, 50.0), 120          # phase 22's Poisson loads
# Phase 23: synthetic tracks saved as 44.1 kHz stereo WAV; phase 24: batches
# of bench.py's batch and length.
INGEST_FILES, INGEST_SECONDS, INGEST_RATE, INGEST_SEED, INGEST_QUERY = 64, 30.0, 44100, 9000, 37
STREAM_BATCHES = 8
# BASELINE config 5 (benchmarks/config5_learning.py): n_train tracks of
# track_seconds for learning (:91), artist_eval's catalogs (:44), 8 s queries.
LEARN_TRACKS, LEARN_SECONDS = 12, 30.0
ARTISTS, ARTIST_TRACKS, ARTIST_SECONDS, ARTIST_QUERY_SECONDS = 6, 8, 30.0, 8.0
# The rendition scan: V = 7 tempo factors x 3 bin rolls = 21 hypotheses.
SCAN_SPAN, SCAN_PITCH_BINS, SCAN_STEP = 0.03, 1, 0.01
SCAN_IN_TEMPO, SCAN_RENDITIONS, SCAN_SECONDS, RENDITION_SEMITONES = 4, 4, 10.0, 0.5

# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet, dense
# rates at the full 700 W): bytes over the memory rate, operations over the
# rate of the unit the TPU kernel's work maps to. int32 is 64 INT32 lanes an
# SM (Hopper white paper) x 132 SMs x 1.98 GHz, the clock behind the data
# sheet's 67 TFLOP/s float32, the rate of float32 products outside the tensor
# cores (TF32 off).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8_tensor": 1979e12, "bf16_tensor": 989e12, "int32": 132 * 64 * 1.98e9,
            "fp32": 67e12}
# The TPU's CQT and encoder GEMMs run six bf16 products (an X6 split of each
# float32 operand, pallas_frontend.py:81-83, pallas_fingerprint.py).
X6_PASSES = 6
# Per 32-bit word of a print comparison: xor, popcount, add.
WORD_OPS = 3


def bound(nbytes: float, ops: float, unit: str) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for nbytes moved and ops done."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[unit]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Launch counts of every kernel summed over the main-path runs (phases 4, 10,
# 14-33, 35, and 36's fresh processes), each read right after its run.
PATH_LAUNCHES: Counter = Counter()


def start_path() -> None:
    from hpfw_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()


def end_path() -> dict:
    """The launches since start_path(), added to PATH_LAUNCHES."""
    from hpfw_tpu_torch.ops import _build
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    PATH_LAUNCHES.update(counts)
    return counts


def random_filters(cfg) -> np.ndarray:
    from hpfw_tpu_torch.oracle import fix_eigenvector_signs
    rng = np.random.default_rng(0)
    return fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    ).astype(np.float32)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# The card's name and power limit, as nvidia-smi gives them, once phase 1 has
# read them; every later line of output carries them.
CARD = ""


def log(msg: str) -> None:
    print(f"{msg}  [{CARD}]" if CARD else msg, flush=True)


# Clock cycles a second that torch.cuda._sleep spins, at least: the H100's
# top SM clock (a lower clock only lengthens the spin).
SPIN_CYCLES_PER_S = 2.0e9


def cuda_ms(fn, min_total_ms: float = 200.0, max_reps: int = 50) -> float:
    """Mean device time of fn() in ms, by CUDA events after one warm-up.

    The timed calls queue up behind a spin kernel that lasts longer than the
    host takes to enqueue them, so the card runs them back to back: a kernel
    shorter than its host launch cost is timed on the card, not the host.
    """
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = int(min(max_reps, max(1, min_total_ms // once)))
    torch.cuda._sleep(int(min(2.0, 1.5 * reps * host_s + 1e-3) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def differing_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    x = (a ^ b).cpu().numpy().view(np.uint32)
    return int(np.bitwise_count(x).sum())


def k2_gate(prints: torch.Tensor) -> int:
    """K2's gate: the differing bits allowed against its plain version."""
    return max(2, prints.numel() * 32 // 10000)


@contextlib.contextmanager
def plain_versions():
    """Route every CQT and encoder call through the plain versions (on the
    card too). Fails if K1 or K2 launches meanwhile."""
    from unittest import mock

    from hpfw_tpu_torch.ops import _build, frontend
    from hpfw_tpu_torch.ops import fingerprint as fp_ops
    before = (_build.LAUNCHES["cqt"], _build.LAUNCHES["fingerprint"])
    with mock.patch.object(frontend, "cqt_from_frames", frontend.cqt_from_frames_ref), \
            mock.patch.object(fp_ops, "fingerprint_from_spec", fp_ops.fingerprint_from_spec_ref):
        yield
    check((_build.LAUNCHES["cqt"], _build.LAUNCHES["fingerprint"]) == before,
          "K1 or K2 launched under the plain versions")


def matcher_routes() -> list:
    """K3, K4 and K5 as the matchers call them: (module, attribute, launch
    counter, plain version)."""
    from hpfw_tpu_torch.match import matcher, scaled
    from hpfw_tpu_torch.ops import coarse_scan, fine
    return [(matcher, "score_tracks", "score_tracks", matcher.score_tracks_ref),
            (scaled, "coarse_scan", "coarse_scan", coarse_scan.coarse_scan_ref),
            (scaled, "coarse_scan_batch", "coarse_scan_batch", coarse_scan.coarse_scan_batch_ref),
            (scaled, "coarse_scan_batch_packed", "coarse_scan_batch_packed",
             coarse_scan.coarse_scan_batch_packed_ref),
            (scaled, "coarse_rescan", "coarse_rescan", coarse_scan.coarse_rescan_ref),
            (scaled, "fine_rescan_batch", "fine_rescan", fine.fine_rescan_ref)]


def eager_dispatch():
    """Every dispatch_batch meanwhile runs eager, calling the names that
    matcher_routes() patches: a captured CUDA graph (match/graphs.py) would
    replay its kernels without calling them. The main path replays graphs
    from a shape's second call, so a run under this is a pass of its own,
    outside start_path()/end_path()."""
    from unittest import mock

    from hpfw_tpu_torch.match import graphs
    return mock.patch.object(graphs.DispatchGraphs, "run",
                             lambda self, device, key, queries, fn: (fn(queries), False))


def graphed_dispatches(first: int) -> tuple[int, int]:
    """(graphed, all) of the match.dispatch spans (TwoStageDB.dispatch_batch
    calls) opened since profiling.new_id() returned first."""
    from hpfw_tpu_torch.utils import profiling
    mine = [s.attrs["graphed"] for s in profiling.spans()
            if s.name == "match.dispatch" and s.sid > first]
    return sum(mine), len(mine)


@contextlib.contextmanager
def plain_matcher():
    """Route K3, K4 and K5 through their plain versions (on the card too).
    Fails if one of them launches meanwhile."""
    from unittest import mock

    from hpfw_tpu_torch.ops import _build
    routes = matcher_routes()
    before = [_build.LAUNCHES[counter] for _, _, counter, _ in routes]
    with contextlib.ExitStack() as stack:
        stack.enter_context(eager_dispatch())
        for mod, attr, _, ref in routes:
            stack.enter_context(mock.patch.object(mod, attr, ref))
        yield
    check([_build.LAUNCHES[counter] for _, _, counter, _ in routes] == before,
          "K3, K4 or K5 launched under the plain versions")


@contextlib.contextmanager
def matcher_held_to_plain(held: dict):
    """Record every K3, K4 and K5 call made meanwhile, then run each one's
    plain version on the same inputs: fails unless every output is equal.
    held gets {launch counter: [the shape of each call's query input]}.
    Dispatches run eager meanwhile (eager_dispatch())."""
    from unittest import mock
    calls = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(eager_dispatch())
        for mod, attr, counter, ref in matcher_routes():
            def spy(*args, _real=getattr(mod, attr), _counter=counter, _ref=ref, **kw):
                out = _real(*args, **kw)
                calls.append((_counter, _ref, args, kw, out))
                return out
            stack.enter_context(mock.patch.object(mod, attr, spy))
        yield
    for counter, ref, args, kw, out in calls:
        want = ref(*args, **kw)
        check(all(torch.equal(o, w) for o, w in zip(out, want)),
              f"{counter} on a {tuple(args[0].shape)} query: differs from its plain version")
        held.setdefault(counter, []).append(tuple(args[0].shape))


def phase_device() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    global CARD
    CARD = card
    from hpfw_tpu_torch.ops import dot
    check(dot.tf32_disabled(), "TF32 is enabled for float32 products")
    log(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | tf32 off")


def phase_build() -> None:
    from hpfw_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.library()
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (lib_path.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log(f"phase 2 build: {lib_path.name} in {dt:.1f} s")
    for ln in ptxas:
        log(f"  ptxas: {ln}")


def main() -> None:
    phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    kernels, dense = run(dev)
    kernels += run_catalog(dev, dense)
    for k in kernels:
        k["launches"] = PATH_LAUNCHES[k.pop("counter")]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on a main path: {dict(PATH_LAUNCHES)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run(dev: torch.device) -> tuple[list[dict], dict]:
    """Phases 3-7 on dev, once the card is checked and the kernels built.
    Returns the per-kernel results of K1-K3, and phase 4's DB, tracks and
    filters and the 240 s track for phases 21 and 24."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.filters import filters_from_jax
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.match import matcher
    from hpfw_tpu_torch.ops import frontend
    from hpfw_tpu_torch.ops import fingerprint as fp_ops

    cfg = HpfwConfig()
    filters_np = random_filters(cfg)
    filt = filters_from_jax(filters_np, cfg, dev)

    t0 = time.perf_counter()
    tracks = synth.synth_catalog(CFG1_TRACKS, CFG1_SECONDS, cfg)
    q_pcm = synth.make_query(tracks[QUERY_TRACK], QUERY_START_S, QUERY_SECONDS, cfg,
                             noise_db=-20.0, seed=9)
    long_pcm = synth.synth_track(100, LONG_SECONDS, cfg)
    log(f"  synthesized audio in {time.perf_counter() - t0:.1f} s")

    # ---- phase 3: each kernel against its plain version on the card ----
    k1_err = 0.0
    k2_bits = 0
    k2_err = 0
    specs = {}
    for name, pcm in (("query_10s", q_pcm), ("track_240s", long_pcm)):
        frames = frontend.frame_signal(torch.from_numpy(pcm).to(dev), cfg)
        spec_k = frontend.cqt_kernel(frames, cfg)
        spec_r = frontend.cqt_from_frames_ref(frames, cfg)
        check(bool(torch.isfinite(spec_k).all()), f"K1 {name}: non-finite spectrum")
        err = float((spec_k - spec_r).abs().max())
        check(err <= 1e-4, f"K1 {name}: max abs diff {err} > 1e-4")
        k1_err = max(k1_err, err)
        pk = fp_ops.encoder_kernel(spec_k, filt, cfg)
        pr = fp_ops.fingerprint_from_spec_ref(spec_k, filt, cfg)
        check(pk.shape == pr.shape == (cfg.n_hashprints(len(pcm)), 2),
              f"K2 {name}: shapes {tuple(pk.shape)} vs {tuple(pr.shape)}")
        bits = differing_bits(pk, pr)
        limit = max(2, pk.numel() * 32 // 10000)
        check(bits <= limit, f"K2 {name}: {bits} differing bits > {limit}")
        k2_bits += bits
        k2_err = max(k2_err, int(bits > 0))
        specs[name] = (frames, spec_k)
        log(f"phase 3 K1/K2 {name}: frames {tuple(frames.shape)} spec max abs diff "
            f"{err:.3e} (<= 1e-4); prints {tuple(pk.shape)} differing bits {bits} "
            f"(<= {limit})")

    # The pool's and the session's launch: 67 frames -> 32 prints, cut from the
    # 240 s spectrum, equal to the whole-track launch's prints there bit for bit.
    l_spec = specs["track_240s"][1]
    w_frames = CHUNK_PRINTS + cfg.context_w - 1 + cfg.delta_lag
    whole = fp_ops.encoder_kernel(l_spec, filt, cfg)
    for o in WINDOW_OFFSETS:
        w_spec = l_spec[o:o + w_frames]
        pk = fp_ops.encoder_kernel(w_spec, filt, cfg)
        pr = fp_ops.fingerprint_from_spec_ref(w_spec, filt, cfg)
        bits = differing_bits(pk, pr)
        check(pk.shape == (CHUNK_PRINTS, 2) and bits <= 2,
              f"K2 window_32 at frame {o}: shape {tuple(pk.shape)}, {bits} differing bits > 2")
        check(torch.equal(pk, whole[o:o + CHUNK_PRINTS]),
              f"K2 window_32 at frame {o}: differs from the whole-track prints")
        k2_bits += bits
        k2_err = max(k2_err, int(bits > 0))
    specs["window_32"] = (None, l_spec[WINDOW_OFFSETS[-1]:WINDOW_OFFSETS[-1] + w_frames])
    log(f"phase 3 K2 window_32: {w_frames} frames -> {CHUNK_PRINTS} prints at frames "
        f"{', '.join(map(str, WINDOW_OFFSETS))} of the 240 s spectrum: within 2 bits of the "
        f"plain version and equal to the whole-track launch's prints bit for bit")

    rng_db = np.random.default_rng(3)
    n_q = cfg.n_hashprints(int(round(QUERY_SECONDS * cfg.sample_rate)))
    n_db = cfg.n_hashprints(int(round(CFG1_SECONDS * cfg.sample_rate)))
    rand_prints = rng_db.integers(0, 2 ** 32, (CFG1_TRACKS, n_db, 2), dtype=np.uint32)
    rand_lens = rng_db.integers(n_q // 2, n_db + 1, CFG1_TRACKS).astype(np.int32)
    rand_q = rng_db.integers(0, 2 ** 32, (n_q, 2), dtype=np.uint32)
    rand_prints[5, 100:100 + n_q] = rand_q
    rand_lens[5] = n_db
    for i, ln in enumerate(rand_lens):
        rand_prints[i, ln:] = 0
    k3_in = (torch.from_numpy(rand_q.view(np.int32)).to(dev),
             torch.from_numpy(rand_prints.view(np.int32)).to(dev),
             torch.from_numpy(rand_lens).to(dev))
    sk, ok_ = matcher.score_tracks_kernel(*k3_in)
    sr, or_ = matcher.score_tracks_ref(*k3_in)
    k3_err = max(int((sk - sr).abs().max()), int((ok_ - or_).abs().max()))
    check(k3_err == 0, "K3: (score, offset) differ from the plain scan")
    check(int(sk[5]) == 64 * n_q and int(ok_[5]) == 100, "K3: planted query not found")
    log(f"phase 3 K3: {CFG1_TRACKS} tracks x {n_db} prints, query {n_q}: "
        f"scores and offsets equal to the plain scan")

    # ---- phase 4: the slice, BASELINE config 1 ----
    start_path()
    t0 = time.perf_counter()
    db = api.build_db(tracks, filters_np, cfg, device=dev)
    build_s = time.perf_counter() - t0
    check(db.prints.shape == (CFG1_TRACKS, n_db, 2) and bool((db.lengths == n_db).all()),
          f"DB shape {db.prints.shape}")
    qfp = api.fingerprint(q_pcm, filters_np, cfg, device=dev)
    check(qfp.shape == (n_q, 2) and qfp.dtype == np.uint32, f"query prints {qfp.shape}")
    ids, scores, offs = api.match(qfp, db, top_k=5)
    exp_off = round(QUERY_START_S * cfg.sample_rate / cfg.hop)
    check(ids[0] == str(QUERY_TRACK) and abs(int(offs[0]) - exp_off) <= 1,
          f"config-1 query: top {ids[0]} at offset {offs[0]}, want {QUERY_TRACK} at "
          f"{exp_off}+-1")
    check(int(scores[0]) > int(scores[1]), "config-1 query: no score gap to #2")
    a = EXCERPT_PRINT * cfg.hop
    exc = tracks[EXCERPT_TRACK][a:a + int(QUERY_SECONDS * cfg.sample_rate)]
    efp = api.fingerprint(exc, filters_np, cfg, device=dev)
    e_ids, e_scores, e_offs = api.match(efp, db, top_k=3)
    check(e_ids[0] == str(EXCERPT_TRACK) and int(e_scores[0]) == 64 * efp.shape[0]
          and int(e_offs[0]) == EXCERPT_PRINT,
          f"exact excerpt: top {e_ids[0]} score {e_scores[0]} offset {e_offs[0]}, "
          f"want {EXCERPT_TRACK} {64 * efp.shape[0]} {EXCERPT_PRINT}")
    launches = end_path()
    cpu_fp = api.fingerprint(tracks[0], filters_np, cfg, device="cpu")
    cpu_bits = int(np.bitwise_count(cpu_fp ^ db.prints[0, :db.lengths[0]]).sum())
    cpu_limit = max(2, cpu_fp.size * 32 // 10000)
    check(cpu_bits <= cpu_limit, f"DB track 0 vs the CPU path: {cpu_bits} bits differ")
    log(f"phase 4 slice: DB {db.prints.shape} built in {build_s:.2f} s; query -> "
        f"{ids[0]} @ {int(offs[0])} score {int(scores[0])} (#2 {ids[1]} "
        f"{int(scores[1])}); excerpt -> {e_ids[0]} @ {int(e_offs[0])} score "
        f"{int(e_scores[0])} = 64*{efp.shape[0]}; track 0 vs CPU path {cpu_bits} bits")

    # ---- phase 5: dense scan of a planted catalog ----
    rng_cat = np.random.default_rng(5)
    cat = rng_cat.integers(0, 2 ** 32, (CAT_TRACKS, CAT_PRINTS, 2), dtype=np.uint32)
    cat_lens = np.full(CAT_TRACKS, CAT_PRINTS, np.int32)
    cat_lens[1::7] = rng_cat.integers(CAT_QUERY // 2, CAT_PRINTS, len(cat_lens[1::7]))
    for i in range(1, CAT_TRACKS, 7):
        cat[i, cat_lens[i]:] = 0
    cat_q = rng_cat.integers(0, 2 ** 32, (CAT_QUERY, 2), dtype=np.uint32)
    t_star, o_star = CAT_PLANT_TRACK, CAT_PLANT_OFFSET
    cat_lens[t_star] = CAT_PRINTS
    cat[t_star, o_star:o_star + CAT_QUERY] = cat_q
    cat_db = api.FingerprintDB(cfg, filters_np, [f"cat{i}" for i in range(CAT_TRACKS)],
                               cat, cat_lens, device=dev)
    c_ids, c_scores, c_offs = api.match(cat_q, cat_db, top_k=5)
    check(c_ids[0] == f"cat{t_star}" and int(c_offs[0]) == o_star
          and int(c_scores[0]) == 64 * CAT_QUERY,
          f"planted catalog: top {c_ids[0]} @ {c_offs[0]} score {c_scores[0]}")
    cat_p, cat_l = cat_db.device_arrays()
    cat_qt = torch.from_numpy(cat_q.view(np.int32)).to(dev)
    # The whole catalog, at the geometry that phase 7 times (several items a
    # persistent block, each prefetching the next).
    sk, ok_ = matcher.score_tracks_kernel(cat_qt, cat_p, cat_l)
    sr, or_ = matcher.score_tracks_ref(cat_qt, cat_p, cat_l)
    cat_err = max(int((sk - sr).abs().max()), int((ok_ - or_).abs().max()))
    check(cat_err == 0, "planted catalog: K3 differs from the plain scan")
    k3_err = max(k3_err, cat_err)
    log(f"phase 5 catalog: {CAT_TRACKS} x {CAT_PRINTS} prints "
        f"({cat.nbytes / 1e6:.0f} MB), query {CAT_QUERY}: {c_ids[0]} @ "
        f"{int(c_offs[0])} score {int(c_scores[0])} (#2 {int(c_scores[1])}); "
        f"K3 = plain on all {CAT_TRACKS} tracks")

    # ---- phase 6: the main path went through every kernel ----
    check(all(launches.get(k, 0) > 0 for k in ("cqt", "fingerprint", "score_tracks")),
          f"phase 4 launches {launches}: a kernel of the path never ran")
    torch.cuda.synchronize()
    log(f"phase 6 launches during phase 4: {launches}")

    # ---- phase 7: times on the card ----
    q_frames, q_spec = specs["query_10s"]
    l_frames, l_spec = specs["track_240s"]
    w_spec = specs["window_32"][1]
    q_dev = torch.from_numpy(qfp.view(np.int32)).to(dev)
    db_p, db_l = db.device_arrays()
    times = {
        "K1 query_10s": (lambda: frontend.cqt_kernel(q_frames, cfg),
                         lambda: frontend.cqt_from_frames_ref(q_frames, cfg)),
        "K1 track_240s": (lambda: frontend.cqt_kernel(l_frames, cfg),
                          lambda: frontend.cqt_from_frames_ref(l_frames, cfg)),
        "K2 query_10s": (lambda: fp_ops.encoder_kernel(q_spec, filt, cfg),
                         lambda: fp_ops.fingerprint_from_spec_ref(q_spec, filt, cfg)),
        "K2 track_240s": (lambda: fp_ops.encoder_kernel(l_spec, filt, cfg),
                          lambda: fp_ops.fingerprint_from_spec_ref(l_spec, filt, cfg)),
        "K2 window_32": (lambda: fp_ops.encoder_kernel(w_spec, filt, cfg),
                         lambda: fp_ops.fingerprint_from_spec_ref(w_spec, filt, cfg)),
        "K3 config1_db": (lambda: matcher.score_tracks_kernel(q_dev, db_p, db_l),
                          lambda: matcher.score_tracks_ref(q_dev, db_p, db_l)),
        "K3 catalog_1000": (lambda: matcher.score_tracks_kernel(cat_qt, cat_p, cat_l),
                            lambda: matcher.score_tracks_ref(cat_qt, cat_p, cat_l)),
    }
    measured = {}
    for name, (kern, plain) in times.items():
        # plain, kernel, kernel, plain: each side's mean of its two turns
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        measured[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"phase 7 time {name}: kernel {measured[name][0]:.4f} ms, plain "
            f"{measured[name][1]:.4f} ms")

    batch = torch.from_numpy(long_pcm).to(dev).expand(BATCH, -1).contiguous()

    def plain_batch():
        return torch.stack([fp_ops.fingerprint_from_spec_ref(
            frontend.cqt_from_frames_ref(frontend.frame_signal(p, cfg), cfg), filt, cfg)
            for p in batch])

    kern_ms = cuda_ms(lambda: api.fingerprint_batch_device(batch, filt, cfg),
                      min_total_ms=1000.0, max_reps=5)
    plain_ms = cuda_ms(plain_batch, min_total_ms=1000.0, max_reps=5)
    audio_s = BATCH * LONG_SECONDS
    log(f"phase 7 extraction {BATCH} x {LONG_SECONDS:.0f} s: kernels {kern_ms:.2f} ms "
        f"= {audio_s / (kern_ms / 1e3):.1f}x realtime; plain {plain_ms:.2f} ms = "
        f"{audio_s / (plain_ms / 1e3):.1f}x realtime")

    lat = []
    for _ in range(21):
        t0 = time.perf_counter()
        qp = api.fingerprint(q_pcm, filt, cfg)
        api.match(qp, db, top_k=5)
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 7 config-1 query latency (fingerprint 10 s + match 100 tracks, host "
        f"clock): median {statistics.median(lat):.3f} ms, min {min(lat):.3f} ms, "
        f"max {max(lat):.3f} ms over {len(lat)}")

    # ---- the bounds and library calls of the timed shapes (query_10s, config1_db) ----
    kmat = frontend.kernel_matrix(cfg, dev)
    k1_bounds, k1_libs = {}, {}
    for label, pcm, frames in (("query_10s", q_pcm, q_frames), ("track_240s", long_pcm, l_frames)):
        n_frames = frames.shape[0]
        k1_bounds[label] = bound(4 * len(pcm) + nbytes(kmat) + 4 * n_frames * cfg.n_bins,
                                 X6_PASSES * 2 * n_frames * cfg.frame_len * kmat.shape[1],
                                 "bf16_tensor")
        k1_libs[label] = cuda_ms(lambda: torch.matmul(frames, kmat))
    k1_bound, k1_lib = k1_bounds["query_10s"], k1_libs["query_10s"]
    # K2: six bf16 products of each float32 product of the projection (the
    # TPU's X6 split), over the spectrum, the filters and the prints; library:
    # torch.matmul of the unfolded (rows, context_dim) context and the
    # filters, the GEMM only.
    k2_bounds, k2_libs = {}, {}
    for label, spec_ in (("query_10s", q_spec), ("track_240s", l_spec), ("window_32", w_spec)):
        m_rows = spec_.shape[0] - cfg.context_w + 1
        k2_bounds[label] = bound(nbytes(spec_, filt) + 8 * (m_rows - cfg.delta_lag),
                                 X6_PASSES * 2 * m_rows * cfg.context_dim * cfg.n_filters,
                                 "bf16_tensor")
        ctx = spec_.unfold(0, cfg.context_w, 1).transpose(1, 2).reshape(m_rows, -1)
        k2_libs[label] = cuda_ms(lambda: torch.matmul(ctx, filt))
        log(f"phase 7 K2 {label}: kernel {measured['K2 ' + label][0]:.4f} ms, plain "
            f"{measured['K2 ' + label][1]:.4f} ms, library torch.matmul of the unfolded "
            f"{tuple(ctx.shape)} context and the filters {k2_libs[label]:.4f} ms (TF32 off), "
            f"bound {k2_bounds[label][0]:.4f} ms ({k2_bounds[label][1]})")
    k2_bound, k2_lib = k2_bounds["query_10s"], k2_libs["query_10s"]
    # K3: each visited offset (o <= max(len - N, 0)) over min(len, N) print
    # pairs of 64 +-1 products on the int8 tensor cores (its formulation);
    # logged beside it, the popcount formulation's count (xor, popcount and
    # add a 32-bit word) on int32. Library: torch.nn.functional.conv1d of the
    # 0/1 bit channels of every track by the +-1 query (cuDNN, TF32 off), the
    # correlation alone at every offset; the port never calls it.
    k3_bounds, k3_libs = {}, {}
    check(not torch.backends.cudnn.allow_tf32, "cuDNN may round float32 to TF32")
    for label, (q_, p_, l_) in (("config1_db", (q_dev, db_p, db_l)),
                                ("catalog_1000", (cat_qt, cat_p, cat_l))):
        n_q_ = q_.shape[0]
        lens_ = l_.to(torch.int64)
        valid = (lens_ - n_q_).clamp(min=0) + 1
        pairs = int((valid * lens_.clamp(max=n_q_)).sum())
        k3_bytes = nbytes(q_, p_, l_) + 8 * p_.shape[0]
        k3_bounds[label] = bound(k3_bytes, pairs * 64 * 2, "int8_tensor")
        k3_int32 = bound(k3_bytes, pairs * 2 * WORD_OPS, "int32")
        shifts = torch.arange(32, device=dev, dtype=torch.int32)
        chans = ((p_[..., None] >> shifts) & 1).reshape(p_.shape[0], p_.shape[1], 64)
        inside = torch.arange(p_.shape[1], device=dev)[None, :] < l_[:, None]
        x01 = (chans * inside[..., None]).transpose(1, 2).float().contiguous()  # (T, 64, L)
        w_pm1 = (2 * ((q_[..., None] >> shifts) & 1) - 1).reshape(n_q_, 64).T[None].float()
        corr = torch.nn.functional.conv1d(x01, w_pm1.contiguous())
        pc = ((q_[..., None] >> shifts) & 1).sum()
        s0, o0_ = matcher.score_tracks_ref(q_, p_[:1], l_[:1])      # track 0 is full length
        check(int(corr[0, 0, int(o0_[0])]) + 64 * n_q_ - int(pc) == int(s0[0]),
              f"K3 {label}: the conv1d correlation disagrees with the plain scan")
        k3_libs[label] = cuda_ms(lambda: torch.nn.functional.conv1d(x01, w_pm1))
        del chans, x01, corr
        log(f"phase 7 K3 {label}: kernel {measured['K3 ' + label][0]:.4f} ms, plain "
            f"{measured['K3 ' + label][1]:.4f} ms, library conv1d of the 0/1 bit channels "
            f"by the +-1 query {k3_libs[label]:.4f} ms (cuDNN, TF32 off), bound "
            f"{k3_bounds[label][0]:.4f} ms ({k3_bounds[label][1]}, int8 tensor operations); "
            f"the popcount formulation's int32 bound {k3_int32[0]:.4f} ms ({k3_int32[1]})")
    k3_bound, k3_lib = k3_bounds["config1_db"], k3_libs["config1_db"]
    for label in k1_bounds:
        log(f"phase 7 K1 {label}: kernel {measured['K1 ' + label][0]:.4f} ms, library "
            f"torch.matmul of its operands {k1_libs[label]:.4f} ms (TF32 off), bound "
            f"{k1_bounds[label][0]:.4f} ms ({k1_bounds[label][1]})")
    log(f"phase 7 bounds: K1 query_10s {k1_bound[0]:.4f} ms ({k1_bound[1]}), "
        + ", ".join(f"K2 {k} {v[0]:.4f} ms ({v[1]})" for k, v in k2_bounds.items()) + ", "
        + ", ".join(f"K3 {k} {v[0]:.4f} ms ({v[1]})" for k, v in k3_bounds.items()))
    del cat_p, cat_l
    rows = (("cqt_filterbank", "cqt", "frontend.cu", "pallas_frontend.py:68", k1_err,
             "K1 query_10s", k1_bound, k1_lib),
            ("hashprint_encoder", "fingerprint", "fingerprint.cu", "pallas_fingerprint.py:63",
             k2_err, "K2 query_10s", k2_bound, k2_lib),
            ("hamming_scan", "score_tracks", "match.cu", "pallas_match.py:41", k3_err,
             "K3 config1_db", k3_bound, k3_lib))
    kernels = []
    for name, counter, src, tpu, err, timed, (b_ms, b_by), lib in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": f"hpfw_tpu_torch/csrc/{src}",
            "replaces": f"hpfw_tpu/ops/{tpu}", "counter": counter,
            "max_abs_err": err, "ms": measured[timed][0], "plain_ms": measured[timed][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        if name == "hashprint_encoder":
            kernels[-1]["differing_bits"] = k2_bits
    return kernels, {"db": db, "tracks": tracks, "filters": filters_np, "long_pcm": long_pcm,
                     "batch_ms": kern_ms, "cat_db": cat_db, "cat_q": cat_q,
                     "cat_plant": (t_star, o_star)}


def noisy_excerpt(rng, track_prints, start, n, flip_rate=CFG4_FLIP):
    """Excerpt with flip_rate of its bits flipped, as benchmarks/config4_scale.py
    makes its queries."""
    q = track_prints[start:start + n].copy()
    shifts = np.arange(32, dtype=np.uint32)
    flip = np.stack([
        np.bitwise_or.reduce(
            (rng.random((n, 32)) < flip_rate).astype(np.uint32) << shifts, axis=1),
        np.bitwise_or.reduce(
            (rng.random((n, 32)) < flip_rate).astype(np.uint32) << shifts, axis=1),
    ], axis=1)
    return np.bitwise_xor(q, flip)


def timed_pair(kern, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two turns: plain, kernel,
    kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def run_catalog(dev: torch.device, dense: dict) -> list[dict]:
    """Phases 8-30: BASELINE config 4 through TwoStageDB, under HpfwConfig()
    and HpfwConfig.catalog_scale(), then the packed pass 1, the server and
    the streaming surfaces on the catalog_scale() catalog, filter learning,
    the rendition scan on that catalog, known-artist mode, the streaming
    spec scan (also over phase 4's dense DB, `dense`), the escalating server,
    file ingestion, fingerprint_stream, and the track-sharded matchers.
    Returns the per-kernel results of K4 (int8 and packed), K5 and the
    probe."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.filters import filters_from_jax
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.match import matcher
    from hpfw_tpu_torch.match.scaled import TwoStageDB, _phase_variants
    from hpfw_tpu_torch.ops import coarse_scan, fine

    # ---- phase 8: the config-4 catalog, its planted queries and stream tracks ----
    t0 = time.perf_counter()
    fps = HpfwConfig().frames_per_second
    n_prints, n_q = int(CFG4_SECONDS * fps), int(CFG4_QUERY_SECONDS * fps)
    rng = np.random.default_rng(0)
    prints = rng.integers(0, 2 ** 32, (CFG4_TRACKS, n_prints, 2), dtype=np.uint32)
    lengths = np.full(CFG4_TRACKS, n_prints, np.int32)
    truth = rng.choice(CFG4_TRACKS, CFG4_QUERIES, replace=False)
    aligned = 16 * rng.integers(0, (n_prints - n_q) // 16, CFG4_QUERIES)
    runs = {
        "default": (HpfwConfig(), aligned),
        "catalog_scale": (HpfwConfig.catalog_scale(),
                          aligned + 1 + np.arange(CFG4_QUERIES) % 15),   # r = 1..15
    }
    queries = {name: np.stack([noisy_excerpt(rng, prints[t], int(o), n_q)
                               for t, o in zip(truth, offs)])
               for name, (_, offs) in runs.items()}
    ids = [str(i) for i in range(CFG4_TRACKS)]
    # Stream tracks (benchmarks/config3_pool.py:58-68), extracted on the card and
    # planted in the first rows that no query uses, before any TwoStageDB is built.
    stream_cfg = HpfwConfig.catalog_scale()
    filters_np = random_filters(stream_cfg)
    stream_pcm = [synth.synth_track(STREAM_SEED + i, STREAM_SECONDS, stream_cfg)
                  for i in range(STREAMS)]
    stream_prints = api._to_numpy_prints(api.fingerprint_batch_device(
        torch.from_numpy(np.stack(stream_pcm)).to(dev),
        filters_from_jax(filters_np, stream_cfg, dev), stream_cfg))
    stream_rows = [r for r in range(CFG4_TRACKS) if r not in set(truth.tolist())][:STREAMS]
    for row, sp in zip(stream_rows, stream_prints):
        n = min(n_prints, sp.shape[0])
        prints[row, :n] = sp[:n]
    log(f"phase 8 catalog: {CFG4_TRACKS} x {n_prints} prints ({prints.nbytes / 1e9:.2f} GB), "
        f"{CFG4_QUERIES} noisy {n_q}-print queries ({CFG4_FLIP:.0%} of bits flipped), "
        f"{STREAMS} x {STREAM_SECONDS:.0f} s stream tracks extracted on the card "
        f"({stream_prints.shape[1]} prints each) in rows {stream_rows[0]}..{stream_rows[-1]}; "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = {}
    for name, (cfg, offs) in runs.items():
        t0 = time.perf_counter()
        db = api.FingerprintDB(cfg, filters_np, ids, prints, lengths, device=dev)
        ts = TwoStageDB(db)
        torch.cuda.synchronize()
        qs_np = queries[name]
        qs = torch.from_numpy(qs_np.view(np.int32)).to(dev)
        gib = nbytes(*{id(t): t for t in (ts.prints, ts.db_c, ts.db_c1)}.values()) / 2 ** 30
        log(f"  {name}: TwoStageDB on the card in {time.perf_counter() - t0:.1f} s "
            f"(prints + coarse DBs {gib:.2f} GiB; db_c {tuple(ts.db_c.shape)}, db_c1 "
            f"{tuple(ts.db_c1.shape)}, phases {ts.query_phases}, prefilter {ts.prefilter}, "
            f"pass-1 channels {ts.prefilter_channels}, pool {cfg.fine_candidates})")
        # The exact answer for each planted track: K3's dense scan of that track.
        want = []
        for q, t in zip(qs, truth):
            s, o = matcher.score_tracks_kernel(q, ts.prints[t:t + 1], ts.lengths[t:t + 1])
            want.append((str(t), int(s[0]), int(o[0])))

        # ---- phase 9: K4 and K5 against their plain versions ----
        rows = ts.db_c[:KERNEL_ROWS]
        checks = {}      # name -> (shape, kernel, plain, (bound ms, bound by))
        if name == "default":
            qc = _phase_variants(qs[:1], stride=ts.stride, phases=1, kind=ts.coarse_kind,
                                 channels=ts.coarse_channels)[0][0, 0]
            n_off = ts.lc_true - qc.shape[0] + 1
            checks["coarse_scan"] = (
                f"{KERNEL_ROWS} rows x {ts.lc_true} windows x {ts.coarse_channels} "
                f"channels, one {qc.shape[0]}-window query",
                lambda: coarse_scan.coarse_scan_kernel(qc, rows, lc_true=ts.lc_true),
                lambda: coarse_scan.coarse_scan_ref(qc, rows, lc_true=ts.lc_true),
                bound(nbytes(rows, qc) + 8 * KERNEL_ROWS,
                      2 * KERNEL_ROWS * n_off * qc.numel(), "int8_tensor"))
            f_tracks = torch.randint(0, CFG4_TRACKS, (FINE_QUERIES, FINE_CANDIDATES),
                                     dtype=torch.int32, device=dev)
            n_fine = 2 * ts.stride + 1
            span = n_q + n_fine - 1
            f_starts = torch.randint(0, n_prints - span + 1, f_tracks.shape,
                                     dtype=torch.int32, device=dev)
            # Shorter lengths, so that bands run past max(len - N, 0) and some
            # tracks are shorter than the query.
            f_lens = torch.randint(n_q // 2, n_prints + 1, (CFG4_TRACKS,),
                                   dtype=torch.int32, device=dev)
            f_args = (qs[:FINE_QUERIES], ts.prints, f_lens, f_tracks, f_starts)
            cand_len = f_lens[f_tracks.long()].to(torch.int64)
            max_o = (cand_len - n_q).clamp(min=0)
            past = int(((f_starts + n_fine - 1) > max_o).sum())
            # This run's work: each band offset up to max(len - N, 0), over
            # min(N, len) print pairs of 64 +-1 products each on the int8
            # tensor cores (K5's formulation); the band's prints read once.
            # Logged beside it: the popcount formulation's count (xor,
            # popcount and add a 32-bit word) on int32.
            n_valid = (max_o - f_starts + 1).clamp(0, n_fine)
            fine_pairs = int((n_valid * cand_len.clamp(max=n_q)).sum())
            fine_bytes = (8 * f_tracks.numel() * span + nbytes(qs[:FINE_QUERIES]) +
                          4 * f_tracks.numel() * 4)
            fine_int32 = bound(fine_bytes, fine_pairs * 2 * WORD_OPS, "int32")
            log(f"  K5 bound on int32 words (the popcount formulation): "
                f"{fine_int32[0]:.4f} ms ({fine_int32[1]})")
            checks["fine_rescan"] = (
                f"{FINE_QUERIES} queries x {FINE_CANDIDATES} candidates, band {n_fine}, "
                f"{past} bands past max(len - N, 0)",
                lambda: fine.fine_rescan_kernel(*f_args, n_fine=n_fine),
                lambda: fine.fine_rescan_ref(*f_args, n_fine=n_fine),
                bound(fine_bytes, fine_pairs * 64 * 2, "int8_tensor"))
        else:
            rows1 = ts.db_c1[:KERNEL_ROWS]
            q1 = _phase_variants(qs[:8], stride=ts.stride, phases=ts.prefilter_phases,
                                 kind=ts.coarse_kind, channels=ts.prefilter_channels)[0]
            q1 = q1.reshape(-1, *q1.shape[2:])
            n_off1 = ts.lc_true - q1.shape[1] + 1
            checks["coarse_scan_batch"] = (
                f"{KERNEL_ROWS} rows x {ts.lc_true} windows x {ts.prefilter_channels} "
                f"channels, {q1.shape[0]} lanes (8 queries x {ts.prefilter_phases} phases)",
                lambda: coarse_scan.coarse_scan_batch_kernel(q1, rows1, lc_true=ts.lc_true),
                lambda: coarse_scan.coarse_scan_batch_ref(q1, rows1, lc_true=ts.lc_true),
                bound(nbytes(rows1, q1) + 8 * q1.shape[0] * KERNEL_ROWS,
                      2 * KERNEL_ROWS * n_off1 * q1.numel(), "int8_tensor"))
            q2 = _phase_variants(qs[:2], stride=ts.stride, phases=ts.query_phases,
                                 kind=ts.coarse_kind, channels=ts.coarse_channels)[0]
            pooled = torch.stack([torch.randperm(CFG4_TRACKS, device=dev)[:KERNEL_ROWS]
                                  for _ in range(2)]).sort(dim=1).values.to(torch.int32)
            n_off2 = ts.lc_true - q2.shape[2] + 1
            checks["coarse_rescan"] = (
                f"2 queries x {ts.query_phases} variants over {KERNEL_ROWS} pooled rows each",
                lambda: coarse_scan.coarse_rescan_kernel(q2, ts.db_c, pooled,
                                                         lc_true=ts.lc_true),
                lambda: coarse_scan.coarse_rescan_ref(q2, ts.db_c, pooled,
                                                      lc_true=ts.lc_true),
                bound(pooled.numel() * ts.db_c.shape[1] + nbytes(q2, pooled) +
                      8 * q2.shape[1] * pooled.numel(),
                      2 * KERNEL_ROWS * n_off2 * q2.numel(), "int8_tensor"))
            # Rows past the old shared-memory limit: LONG_TRACKS consecutive
            # pass-1 rows as one row of ~5,000 windows, scanned in chunks.
            long_rows = ts.db_c1[:LONG_ROWS * LONG_TRACKS].reshape(LONG_ROWS, -1)
            lc_long = long_rows.shape[1] // ts.prefilter_channels
            checks["coarse_scan_batch_long"] = (
                f"{LONG_ROWS} rows x {lc_long} windows x {ts.prefilter_channels} channels, "
                f"{q1.shape[0]} lanes",
                lambda: coarse_scan.coarse_scan_batch_kernel(q1, long_rows, lc_true=lc_long),
                lambda: coarse_scan.coarse_scan_batch_ref(q1, long_rows, lc_true=lc_long),
                bound(nbytes(long_rows, q1) + 8 * q1.shape[0] * LONG_ROWS,
                      2 * LONG_ROWS * (lc_long - q1.shape[1] + 1) * q1.numel(), "int8_tensor"))
        for kname, (shape, kern, plain, _) in checks.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = max(int((got[0] - ref[0]).abs().max()), int((got[1] - ref[1]).abs().max()))
            check(err == 0, f"{kname}: kernel differs from its plain version by {err}")
            kernels[kname] = {"max_abs_err": err}
            log(f"phase 9 {name} {kname}: {shape}: equal to the plain version")

        # ---- phase 10: the slice ----
        start_path()
        t0 = time.perf_counter()
        single = [ts.match(q, top_k=10) for q in qs_np]
        per_match = end_path()
        start_path()
        batched = match_in_batches(ts, qs_np)
        slice_s = time.perf_counter() - t0
        per_batches = end_path()
        for i, ((r_ids, r_s, r_o), (b_ids, b_s, b_o)) in enumerate(zip(single, batched)):
            got = (r_ids[0], int(r_s[0]), int(r_o[0]))
            check(got == want[i], f"{name} query {i}: top {got}, want {want[i]} (K3 dense)")
            check(r_ids == b_ids and np.array_equal(r_s, b_s) and np.array_equal(r_o, b_o),
                  f"{name} query {i}: match_batch differs from match")
        exact_off = sum(int(w[2]) == int(o) for w, o in zip(want, offs))
        log(f"phase 10 {name}: {CFG4_QUERIES}/{CFG4_QUERIES} planted tracks first at K3's "
            f"(score, offset), batched == single; {exact_off}/{CFG4_QUERIES} at the planted "
            f"offset; scores {min(w[1] for w in want)}..{max(w[1] for w in want)} of "
            f"{64 * n_q}, #2 at most {max(int(r[1][1]) for r in single)}; "
            f"{CFG4_QUERIES} match + {len(CFG4_BATCHES)} match_batch in {slice_s:.2f} s")

        # ---- phase 11: the slice went through the kernels ----
        used = (("coarse_scan", "coarse_scan_batch", "fine_rescan") if name == "default"
                else ("coarse_scan_batch", "coarse_rescan", "fine_rescan"))
        counts = Counter(per_match) + Counter(per_batches)
        check(all(counts[k] > 0 for k in used),
              f"phase 10 {name} launches {dict(counts)}: a kernel of the path never ran")
        log(f"phase 11 {name} launches: {CFG4_QUERIES} x match {per_match} (per match "
            f"{ {k: v / CFG4_QUERIES for k, v in per_match.items()} }); match_batch "
            f"{'+'.join(map(str, CFG4_BATCHES))} {per_batches}")

        # ---- phase 12: times ----
        for kname, (shape, kern, plain, (b_ms, b_by)) in checks.items():
            k_ms, p_ms = timed_pair(kern, plain)
            kernels[kname].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                  library_ms=None)
            log(f"phase 12 time {name} {kname} ({shape}): kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        log_match_times(f"phase 12 {name}", match_times(ts, qs_np))
        if name == "default":
            del ts, db, qs, rows, checks
            torch.cuda.empty_cache()

    # Phases 13-17 on the catalog_scale() catalog.
    ts_p, packed_kernels = run_packed(ts, qs, qs_np, want, single, batched)
    kernels.update(packed_kernels)
    run_serving(ts_p, filters_np, qs_np, truth, stream_pcm, stream_rows)
    run_learning(dev)
    scan_queries = run_renditions(ts, filters_np, stream_pcm, stream_rows)
    artists = run_artists(dev)
    live_dense = run_live_scan(ts_p, filters_np, stream_pcm, stream_rows, dense)
    run_escalating_server(ts_p, filters_np, *scan_queries)
    run_ingest(dev, dense)
    run_stream(dev, dense)
    # Phases 25-30: the track-sharded matchers.
    run_dryrun(dev)
    run_sharded_dense(dev, dense)
    mesh_ts = run_sharded_catalog(dev, ts_p, qs_np, want, single, batched)
    run_mesh_server(mesh_ts, qs_np, want)
    del mesh_ts
    torch.cuda.empty_cache()
    run_mesh_session(dev, dense, live_dense)
    run_mesh_artists(dev, *artists)
    # Phases 31-33: the CLI, the profiler and the device catalog synthesizer.
    run_cli(dev)
    run_profiler(ts, qs_np)
    synth_prints = run_synth_device(dev, filters_np)
    # Phases 34-36: the oracle audit, entry() and warmup in fresh processes.
    run_oracle_audit(dev, dense)
    run_entry()
    run_warmup(synth_prints, filters_np)
    source = {"fine_rescan": "fine.cu", "row_sum": "probe.cu"}
    # Both packed bodies launch under one counter; the short one has its own entry.
    counter = {"coarse_scan_batch_packed_short": "coarse_scan_batch_packed"}
    replaces = {"coarse_scan": "hpfw_tpu/ops/pallas_coarse.py:82",
                "coarse_scan_batch": "hpfw_tpu/ops/pallas_coarse.py:201",
                "coarse_scan_batch_packed": "hpfw_tpu/ops/pallas_coarse.py:223",
                "coarse_scan_batch_packed_short": "hpfw_tpu/ops/pallas_coarse.py:223",
                "coarse_rescan": "hpfw_tpu/ops/pallas_coarse.py:201",
                "fine_rescan": "hpfw_tpu/ops/pallas_fine.py:83",
                "row_sum": "benchmarks/pass1_tune.py:97"}
    return [dict({"name": k, "route": "cuda",
                  "source": "hpfw_tpu_torch/csrc/" + source.get(k, "coarse.cu"),
                  "replaces": replaces[k], "counter": counter.get(k, k)}, **kernels[k])
            for k in replaces]


def match_in_batches(ts, qs_np) -> list:
    """match_batch over the queries in batches of CFG4_BATCHES."""
    out, at = [], 0
    for b in CFG4_BATCHES:
        out += ts.match_batch(qs_np[at:at + b], top_k=10)
        at += b
    return out


def match_times(ts, qs_np) -> dict:
    """Host-clock latency of TwoStageDB.match (21 single queries) and
    queries/s of match_batch at B = 8 and 16 (median of 5 each)."""
    lat = []
    for i in range(21):
        t1 = time.perf_counter()
        ts.match(qs_np[i % len(qs_np)], top_k=10)
        lat.append((time.perf_counter() - t1) * 1e3)
    out = {"median": statistics.median(lat), "min": min(lat), "max": max(lat)}
    for b in (8, 16):
        bat = []
        for _ in range(5):
            t1 = time.perf_counter()
            ts.match_batch(qs_np[:b], top_k=10)
            bat.append(time.perf_counter() - t1)
        out[b] = (statistics.median(bat) * 1e3, b / statistics.median(bat))
    return out


def log_match_times(tag: str, t: dict) -> None:
    log(f"{tag} match latency (host clock, {CFG4_TRACKS} tracks): median "
        f"{t['median']:.3f} ms, min {t['min']:.3f} ms, max {t['max']:.3f} ms over 21; "
        + "; ".join(f"match_batch B={b}: median {t[b][0]:.3f} ms = {t[b][1]:.1f} queries/s"
                    for b in (8, 16)) + f" (median of 5)")


def same_results(a, b) -> bool:
    return all(x[0] == y[0] and np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])
               for x, y in zip(a, b)) and len(a) == len(b)


def run_packed(ts, qs, qs_np, want, single, batched):
    """Phases 13-14 on the catalog_scale() TwoStageDB ts of phase 10: the
    nibble-packed pass-1 rows, packed K4, the load-floor probe, and the packed
    matcher. Returns (the packed TwoStageDB, the per-kernel results of packed
    K4 and the probe)."""
    from hpfw_tpu_torch.match.scaled import TwoStageDB, _phase_variants
    from hpfw_tpu_torch.ops import coarse_scan, probe

    # ---- phase 13: packed pass-1 rows, packed K4 and the probe ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed1 = coarse_scan.pack_coarse_nibbles(ts.db_c1)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    log(f"phase 13 pack: pass-1 DB {tuple(ts.db_c1.shape)} int8 ({nbytes(ts.db_c1) / 1e9:.3f} "
        f"GB) -> {tuple(packed1.shape)} packed ({nbytes(packed1) / 1e9:.3f} GB) in "
        f"{pack_s * 1e3:.1f} ms")
    rows1, prow1 = ts.db_c1[:KERNEL_ROWS], packed1[:KERNEL_ROWS]
    q1 = _phase_variants(qs[:8], stride=ts.stride, phases=ts.prefilter_phases,
                         kind=ts.coarse_kind, channels=ts.prefilter_channels)[0]
    q1 = q1.reshape(-1, *q1.shape[2:])
    lc = ts.lc_true

    def packed_k():
        return coarse_scan.coarse_scan_batch_packed_kernel(q1, prow1, lc_true=lc)

    def packed_plain():
        return coarse_scan.coarse_scan_batch_packed_ref(q1, prow1, lc_true=lc)

    def int8_k():
        return coarse_scan.coarse_scan_batch_kernel(q1, rows1, lc_true=lc)

    got, ref, int8 = packed_k(), packed_plain(), int8_k()
    torch.cuda.synchronize()
    err = max(int((a - b).abs().max()) for a, b in zip(got + got, ref + int8))
    check(err == 0, f"packed K4 differs from its plain version or from int8 K4 by {err}")
    shape = (f"{KERNEL_ROWS} packed rows x {lc} windows x {ts.prefilter_channels} channels, "
             f"{q1.shape[0]} lanes (8 queries x {ts.prefilter_phases} phases)")
    long_lanes = coarse_scan.packed_geometry(lc, q1.shape[1], q1.shape[2]).lanes
    check(long_lanes == coarse_scan.PACKED_LANES,
          f"a {q1.shape[1]}-window query takes {long_lanes} lanes a block, not the long body")
    log(f"phase 13 coarse_scan_batch_packed: {shape}: equal to its plain version and to "
        f"int8 K4 on the unpacked rows")
    # The pool's shape (phase 16): SHORT_QUERIES queries of QUERY_PRINTS prints,
    # excerpts of the catalog queries, take the short body (nc <= PACKED_HALF).
    starts = range(0, qs.shape[1] - QUERY_PRINTS + 1, 16)
    qp = torch.cat([qs[:, s:s + QUERY_PRINTS] for s in starts])[:SHORT_QUERIES]
    qp = _phase_variants(qp, stride=ts.stride, phases=ts.prefilter_phases,
                         kind=ts.coarse_kind, channels=ts.prefilter_channels)[0]
    qp = qp.reshape(-1, *qp.shape[2:])
    short_lanes = coarse_scan.packed_geometry(lc, qp.shape[1], qp.shape[2]).lanes
    check(short_lanes == coarse_scan.PACKED_SHORT_LANES,
          f"a {qp.shape[1]}-window query takes {short_lanes} lanes a block, not the short body")

    def short_k():
        return coarse_scan.coarse_scan_batch_packed_kernel(qp, prow1, lc_true=lc)

    def short_plain():
        return coarse_scan.coarse_scan_batch_packed_ref(qp, prow1, lc_true=lc)

    def short_int8():
        return coarse_scan.coarse_scan_batch_kernel(qp, rows1, lc_true=lc)

    got, ref, int8 = short_k(), short_plain(), short_int8()
    torch.cuda.synchronize()
    short_err = max(int((a - b).abs().max()) for a, b in zip(got + got, ref + int8))
    check(short_err == 0, f"packed K4's short body differs from its plain version or from "
          f"int8 K4 by {short_err}")
    short_shape = (f"{KERNEL_ROWS} packed rows x {lc} windows x {ts.prefilter_channels} "
                   f"channels, {qp.shape[0]} lanes ({qp.shape[0] // ts.prefilter_phases} "
                   f"queries of {QUERY_PRINTS} prints, {qp.shape[1]} windows, x "
                   f"{ts.prefilter_phases} phases)")
    log(f"phase 13 coarse_scan_batch_packed short body: {short_shape}: equal to its plain "
        f"version and to int8 K4 on the unpacked rows")
    dbs = {"coarse DB": ts.db_c, "packed pass-1 DB": packed1}
    probe_err = max(int((probe.row_sum_kernel(d) - torch.sum(d, dim=1, dtype=torch.int32))
                        .abs().max()) for d in dbs.values())
    check(probe_err == 0, f"the probe differs from torch.sum by {probe_err}")
    log(f"phase 13 probe: row sums over the coarse DB {tuple(ts.db_c.shape)} and the packed "
        f"pass-1 DB {tuple(packed1.shape)} equal to torch.sum(dtype=int32)")
    # The probe's own path: one read of each DB, the measured floor.
    start_path()
    for d in dbs.values():
        probe.row_sum(d)
    log(f"phase 13 probe path launches: {end_path()}")

    # Times: int8, packed, packed, int8 for the two layouts; then the plain version.
    i1, p1, p2, i2 = cuda_ms(int8_k), cuda_ms(packed_k), cuda_ms(packed_k), cuda_ms(int8_k)
    k_ms, plain_ms = timed_pair(packed_k, packed_plain)
    # The pass-1 shape of one match: one query's phases over every row.
    qm = q1[:ts.prefilter_phases]
    whole = [cuda_ms(lambda: coarse_scan.coarse_scan_batch_kernel(qm, ts.db_c1, lc_true=lc)),
             cuda_ms(lambda: coarse_scan.coarse_scan_batch_packed_kernel(qm, packed1,
                                                                          lc_true=lc))]
    whole += [cuda_ms(lambda: coarse_scan.coarse_scan_batch_packed_kernel(qm, packed1,
                                                                           lc_true=lc)),
              cuda_ms(lambda: coarse_scan.coarse_scan_batch_kernel(qm, ts.db_c1, lc_true=lc))]
    n_off1 = lc - q1.shape[1] + 1
    pk_bound = bound(nbytes(prow1, q1) + 8 * q1.shape[0] * KERNEL_ROWS,
                     2 * KERNEL_ROWS * n_off1 * q1.numel(), "int8_tensor")
    log(f"phase 13 time packed K4 ({shape}): {p1:.4f}/{p2:.4f} ms against int8 K4 "
        f"{i1:.4f}/{i2:.4f} ms on the same rows (turns int8, packed, packed, int8); "
        f"packed {k_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {pk_bound[0]:.4f} ms "
        f"({pk_bound[1]})")
    si1, sp1, sp2, si2 = (cuda_ms(short_int8), cuda_ms(short_k), cuda_ms(short_k),
                          cuda_ms(short_int8))
    short_ms, short_plain_ms = timed_pair(short_k, short_plain)
    short_bound = bound(nbytes(prow1, qp) + 8 * qp.shape[0] * KERNEL_ROWS,
                        2 * KERNEL_ROWS * (lc - qp.shape[1] + 1) * qp.numel(), "int8_tensor")
    log(f"phase 13 time packed K4 short body ({short_shape}): {sp1:.4f}/{sp2:.4f} ms against "
        f"int8 K4 {si1:.4f}/{si2:.4f} ms on the same rows (turns int8, packed, packed, int8); "
        f"packed {short_ms:.4f} ms, plain {short_plain_ms:.4f} ms, bound "
        f"{short_bound[0]:.4f} ms ({short_bound[1]})")
    log(f"phase 13 time one match's pass 1 ({qm.shape[0]} lanes over all "
        f"{ts.db_c1.shape[0]} rows): int8 K4 {whole[0]:.4f}/{whole[3]:.4f} ms, packed K4 "
        f"{whole[1]:.4f}/{whole[2]:.4f} ms (turns int8, packed, packed, int8)")
    probe_res = {}
    for label, d in dbs.items():
        kt, pt = timed_pair(lambda: probe.row_sum_kernel(d), lambda: probe.row_sum_ref(d))
        lib = cuda_ms(lambda: torch.sum(d, dim=1, dtype=torch.int32))
        b_ms, b_by = bound(nbytes(d) + 4 * d.shape[0], d.numel(), "int32")
        gbs = nbytes(d) / (kt * 1e-3) / 1e9
        log(f"phase 13 time probe over the {label} ({nbytes(d) / 1e9:.3f} GB): kernel "
            f"{kt:.4f} ms = {gbs:.1f} GB/s ({gbs / HBM_BYTES_PER_S * 1e11:.1f}% of 3.35 "
            f"TB/s), torch.sum {lib:.4f} ms = {nbytes(d) / (lib * 1e-3) / 1e9:.1f} GB/s, "
            f"plain {pt:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        probe_res[label] = (kt, pt, lib, b_ms, b_by)
    kt, pt, lib, b_ms, b_by = probe_res["coarse DB"]

    # ---- phase 14: the packed matcher ----
    t0 = time.perf_counter()
    ts_p = TwoStageDB(ts.db, prefilter_pack4=True)
    torch.cuda.synchronize()
    check(ts_p.prints is ts.prints and torch.equal(ts_p.db_c, ts.db_c)
          and torch.equal(ts_p.db_c1, packed1),
          "the packed TwoStageDB's coarse DBs differ from phase 10's (packed)")
    log(f"phase 14 TwoStageDB(prefilter_pack4=True) in {time.perf_counter() - t0:.1f} s: "
        f"db_c1 {tuple(ts_p.db_c1.shape)}, the bytes of phase 13's packing")
    start_path()
    p_single = [ts_p.match(q, top_k=10) for q in qs_np]
    p_match = end_path()
    start_path()
    p_batched = match_in_batches(ts_p, qs_np)
    p_batch = end_path()
    check(same_results(p_single, single) and same_results(p_batched, batched),
          "packed matcher results differ from the int8 matcher's (phase 10)")
    top = sum((r[0][0], int(r[1][0]), int(r[2][0])) == w for r, w in zip(p_single, want))
    check(top == CFG4_QUERIES, f"packed matcher: {top}/{CFG4_QUERIES} at K3's (score, offset)")
    counts = Counter(p_match) + Counter(p_batch)
    check(counts["coarse_scan_batch_packed"] > 0 and counts["coarse_scan_batch"] == 0,
          f"phase 14 launches {dict(counts)}: pass 1 did not run (only) on packed K4")
    log(f"phase 14 packed matcher: {CFG4_QUERIES}/{CFG4_QUERIES} match and match_batch "
        f"(8, 8, 4) identical to the int8 matcher (ids, scores, offsets of the top 10), "
        f"{top}/{CFG4_QUERIES} at K3's (score, offset); launches {CFG4_QUERIES} x match "
        f"{p_match}, match_batch {p_batch}")
    # The two matchers in turns (int8, packed, packed, int8), in one call.
    for label, which in (("int8", ts), ("packed", ts_p), ("packed", ts_p), ("int8", ts)):
        log_match_times(f"phase 14 {label}", match_times(which, qs_np))
    return ts_p, {"coarse_scan_batch_packed": {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                                         "bound_ms": pk_bound[0], "bound_by": pk_bound[1],
                                         "library_ms": None},
            "coarse_scan_batch_packed_short": {
                "max_abs_err": short_err, "ms": short_ms, "plain_ms": short_plain_ms,
                "bound_ms": short_bound[0], "bound_by": short_bound[1], "library_ms": None},
            "row_sum": {"max_abs_err": probe_err, "ms": kt, "plain_ms": pt, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib}}


def run_load(srv, queries, truths, lam, rng, n_queries, expect=None) -> dict:
    """Submit n_queries with exponential gaps at lam queries/s (as
    benchmarks/config4_serve.py does) and wait for every answer. A future that
    fails for another reason than ServerSaturated fails the run, and so does
    an answer that differs from expect[i] (its query's answer alone), if
    given."""
    from hpfw_tpu_torch import ServerSaturated

    lat, ok, shed, errors, wrong = [], [0], [0], [], []
    lock = threading.Lock()
    pending = [n_queries]
    all_done = threading.Event()

    def callback(i, t_sub):
        def done(fut):
            exc = fut.exception()
            with lock:
                if exc is None:
                    lat.append(time.perf_counter() - t_sub)
                    ok[0] += fut.result()[0][0] == truths[i % len(queries)]
                    if expect is not None and not same_answer(fut.result(),
                                                              expect[i % len(queries)]):
                        wrong.append(i % len(queries))
                elif isinstance(exc, ServerSaturated):
                    shed[0] += 1
                else:
                    errors.append(repr(exc))
                pending[0] -= 1
                if pending[0] == 0:
                    all_done.set()
        return done

    gaps = rng.exponential(1.0 / lam, n_queries)
    t_start = time.perf_counter()
    for i in range(n_queries):
        t_sub = time.perf_counter()
        srv.submit(queries[i % len(queries)]).add_done_callback(callback(i, t_sub))
        time.sleep(max(0.0, gaps[i]))
    check(all_done.wait(timeout=300), f"offered {lam} q/s: not every query was answered")
    wall = time.perf_counter() - t_start
    check(not errors, f"offered {lam} q/s: futures failed: {errors[:3]}")
    check(not wrong, f"offered {lam} q/s: answers of queries {sorted(set(wrong))} differ "
          "from the same query served alone")
    served = n_queries - shed[0]
    ms = np.array(lat) * 1e3 if lat else np.array([float("nan")])
    return {"p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99)),
            "achieved": served / wall, "shed": shed[0] / n_queries,
            "recall": ok[0] / max(served, 1), "n": n_queries}


def run_serving(ts, filters_np, qs_np, truth, stream_pcm, stream_rows) -> None:
    """Phases 15-17 over the packed catalog_scale() TwoStageDB ts."""
    from hpfw_tpu_torch import MatchServer, StreamingPool, StreamingSession

    cfg = ts.db.cfg
    truths = [str(t) for t in truth]

    # ---- phase 15: MatchServer under Poisson load ----
    direct = [ts.match(q) for q in qs_np]
    rng = np.random.default_rng(1)
    results = {}
    start_path()
    with MatchServer(ts, qs_np.shape[1], **SERVE_KW) as srv:
        t0 = time.perf_counter()
        srv.warmup(qs_np[0])
        warm_s = time.perf_counter() - t0
        alone = [srv.match(q) for q in qs_np]
        check(same_results(alone, direct), "a query served alone differs from ts.match")
        log(f"phase 15 server: warmup of buckets 1, 4, 16 in {warm_s:.2f} s; "
            f"{len(alone)}/{len(alone)} queries served alone equal ts.match (top "
            f"{cfg.top_k} ids, scores, offsets)")
        for lam in SERVE_LOADS:
            r = run_load(srv, qs_np, truths, lam, rng, int(min(600, max(96, 2.5 * lam))))
            results[lam] = r
            log(f"phase 15 offered {lam:.0f} q/s ({r['n']} queries): p50 {r['p50']:.3f} ms, "
                f"p99 {r['p99']:.3f} ms, achieved {r['achieved']:.1f} q/s, shed "
                f"{r['shed']:.1%}, recall {r['recall']:.3f}")
    counts = end_path()
    check(counts.get("coarse_scan_batch_packed", 0) > 0 and "coarse_scan_batch" not in counts,
          f"phase 15 launches {counts}: the server's pass 1 did not run on packed K4")
    sustained = [lam for lam, r in results.items()
                 if r["shed"] == 0 and r["achieved"] >= 0.90 * lam]
    if sustained:
        knee = max(sustained)
        r = results[knee]
        note = "; the sweep's top load: raise it to find the knee" if knee == max(SERVE_LOADS) \
            else ""
        log(f"phase 15 knee: {knee:.0f} q/s offered, {r['achieved']:.1f} achieved, p50 "
            f"{r['p50']:.3f} ms, p99 {r['p99']:.3f} ms, zero shed{note}")
    else:
        log(f"phase 15 knee: no load met zero shed and >= 90% achieved")
    log(f"phase 15 launches: {counts}")

    # ---- phase 16: StreamingPool at config-3 scale ----
    chunk_samples = CHUNK_PRINTS * cfg.hop
    chunk_s = chunk_samples / cfg.sample_rate
    for b in POOL_SIZES:
        pool = StreamingPool(ts, filters_np, cfg, capacity=b, chunk_prints=CHUNK_PRINTS,
                             query_prints=QUERY_PRINTS, query_buckets=(QUERY_PRINTS,))
        sids = [str(r) for r in stream_rows[:b]]
        for sid in sids:
            pool.add_stream(sid)
        pos = [0]

        def tick():
            p = pos[0]
            pos[0] = p + chunk_samples
            return pool.feed({sid: stream_pcm[i][p:p + chunk_samples]
                              for i, sid in enumerate(sids)})

        start_path()
        t0 = time.perf_counter()
        for _ in range(POOL_WARM_TICKS):
            tick()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(POOL_TICKS):
            out = tick()
        tick_s = (time.perf_counter() - t0) / POOL_TICKS
        counts = end_path()
        correct = sum(h is not None and h.track_id == sid for sid, h in out.items())
        check(correct == b, f"pool B={b}: {correct}/{b} streams identified")
        check(all(counts.get(k, 0) > 0 for k in ("cqt", "fingerprint",
                                                  "coarse_scan_batch_packed", "fine_rescan")),
              f"pool B={b} launches {counts}: a kernel of the path never ran")
        stats = pool.latency_stats()
        log(f"phase 16 pool B={b}: {correct}/{b} streams identified; warm {POOL_WARM_TICKS} "
            f"ticks in {warm_s:.2f} s; tick {tick_s * 1e3:.3f} ms over {POOL_TICKS} (match "
            f"p50 {stats['match_p50_ms']:.3f} ms) -> {b * chunk_s / tick_s:.1f} real-time "
            f"streams a card (chunk {chunk_s:.3f} s); launches {counts}")

    # ---- phase 17: one StreamingSession (rigid) ----
    sess = StreamingSession(ts, filters_np, cfg, query_prints=QUERY_PRINTS,
                            chunk_prints=CHUNK_PRINTS)
    live = stream_pcm[0][:int(SESSION_SECONDS * cfg.sample_rate)]
    start_path()
    for p in range(0, len(live), chunk_samples):
        best = sess.feed(live[p:p + chunk_samples])
    counts = end_path()
    check(best is not None and best.track_id == str(stream_rows[0]),
          f"session: {best}, want track {stream_rows[0]}")
    st = sess.latency_stats()
    log(f"phase 17 session: {SESSION_SECONDS:.0f} s stream -> track {best.track_id} score "
        f"{best.score} offset {best.offset} confidence {best.confidence:.3f}; "
        f"{st['n_matches']} matches, match p50 {st['match_p50_ms']:.3f} ms p99 "
        f"{st['match_p99_ms']:.3f} ms, step p50 {st['step_p50_ms']:.3f} ms p99 "
        f"{st['step_p99_ms']:.3f} ms; launches {counts}")


def run_learning(dev: torch.device) -> None:
    """Phase 18: filter learning at BASELINE config 5's sizes, on the card
    and through the plain versions on the card."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.learn import pca
    from hpfw_tpu_torch.ops import frontend
    from hpfw_tpu_torch.ops.dot import precise_matmul
    from hpfw_tpu_torch.ops.fingerprint import context_matrix

    cfg = HpfwConfig()
    t0 = time.perf_counter()
    corpus = synth.synth_catalog(LEARN_TRACKS, LEARN_SECONDS, cfg)
    log(f"  synthesized {LEARN_TRACKS} x {LEARN_SECONDS:.0f} s in "
        f"{time.perf_counter() - t0:.1f} s")
    start_path()
    t0 = time.perf_counter()
    learned = api.learn_filters(corpus, cfg, device=dev)
    learn_s = time.perf_counter() - t0
    counts = end_path()
    check(counts == {"cqt": LEARN_TRACKS},
          f"learning launches {counts}, want {LEARN_TRACKS} of K1 and nothing else")
    # The same corpus through the state API: a track's host-clock seconds,
    # then the plain versions on the card.
    state, track_s = pca.CovarianceState.zero(cfg), []
    for t in corpus:
        t1 = time.perf_counter()
        state = pca.accumulate_track(state, t, cfg, device=dev)
        track_s.append(time.perf_counter() - t1)
    t0 = time.perf_counter()
    finalized = pca.finalize_filters(state, cfg)
    eigh_s = time.perf_counter() - t0
    check(np.array_equal(finalized, learned),
          "finalize_filters of the card's state differs from learn_filters")
    plain = pca.CovarianceState.zero(cfg)
    with plain_versions():
        for t in corpus:
            plain = pca.accumulate_track(plain, t, cfg, device=dev)
    check(state.count == plain.count, f"counts {state.count} vs plain {plain.count}")
    rel = float(np.max(np.abs(state.xtx - plain.xtx) / np.abs(plain.xtx).clip(1e-30)))
    check(np.allclose(state.xtx, plain.xtx, rtol=1e-4, atol=0)
          and np.allclose(state.xsum, plain.xsum, rtol=1e-4, atol=0),
          f"X^T X or sum X beyond rtol 1e-4 of the plain versions (max rel {rel:.2e})")
    cos = np.abs(np.sum(learned.astype(np.float64) * pca.finalize_filters(plain, cfg), axis=0))
    check(bool(np.all(cos > 0.98)), f"a filter's |cos| against the plain route is {cos.min()}")
    # The X^T X GEMM of one 30 s track: float32 on the CUDA cores (TF32 off).
    x = context_matrix(frontend.cqt(torch.from_numpy(corpus[0]).to(dev), cfg), cfg)
    m, d = x.shape
    gemm_ms = cuda_ms(lambda: precise_matmul(x.T, x))
    gemm_bound = bound(nbytes(x) + 4 * d * d, 2 * m * d * d, "fp32")
    log(f"phase 18 learning: {LEARN_TRACKS} x {LEARN_SECONDS:.0f} s, D {cfg.context_dim}: "
        f"api.learn_filters in {learn_s:.2f} s ({learn_s / LEARN_TRACKS:.3f} s a track); "
        f"finalize_filters alone {eigh_s:.2f} s; accumulate_track median "
        f"{statistics.median(track_s):.4f} s, max {max(track_s):.4f} s (host clock); count "
        f"{state.count} = plain; X^T X max rel diff {rel:.2e} (<= 1e-4); min |cos| "
        f"{cos.min():.6f} (> 0.98); finalize_filters(state) == learn_filters; launches "
        f"{counts}")
    log(f"phase 18 X^T X GEMM ({m} x {d}): {gemm_ms:.4f} ms (cuBLAS float32, TF32 off), "
        f"bound {gemm_bound[0]:.4f} ms ({gemm_bound[1]}, 67 TFLOP/s float32)")


def run_renditions(ts, filters_np, stream_pcm, stream_rows) -> tuple:
    """Phase 19: identity-first matching with the rendition scan on the
    catalog_scale() TwoStageDB ts, whose rows stream_rows hold the stream
    tracks. Returns the queries' PCM and true track ids."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.filters import filters_from_jax
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.ops import frontend
    from hpfw_tpu_torch.ops import fingerprint as fp_ops
    from hpfw_tpu_torch.utils import profiling

    cfg, dev = ts.db.cfg, ts.device
    n_s = int(SCAN_SECONDS * cfg.sample_rate)
    pcms, truths = [], []
    for i in range(SCAN_IN_TEMPO + SCAN_RENDITIONS):
        start = 4.0 + 9.0 * (i % SCAN_IN_TEMPO)
        if i < SCAN_IN_TEMPO:
            q = synth.make_query(stream_pcm[i], start, SCAN_SECONDS, cfg, noise_db=-20.0,
                                 seed=100 + i)
        else:   # played 2.9% fast and +0.5 semitone: a 10.5 s clip resampled
            clip = synth.make_query(stream_pcm[i], start, 1.05 * SCAN_SECONDS, cfg,
                                    noise_db=-20.0, seed=100 + i)
            q = synth.pitch_shift(clip, RENDITION_SEMITONES, cfg)[:n_s]
        check(len(q) == n_s, f"query {i}: {len(q)} samples, want {n_s}")
        pcms.append(q)
        truths.append(str(stream_rows[i]))
    pcms = np.stack(pcms)
    kw = dict(span=SCAN_SPAN, pitch_span_bins=SCAN_PITCH_BINS)
    hyps = api.scan_hypotheses(cfg, **kw)
    v = len(hyps)
    renditions = list(range(SCAN_IN_TEMPO, len(pcms)))

    stats: dict = {}
    start_path()
    t0 = time.perf_counter()
    res = api.match_scan_escalating(pcms, filters_np, ts, cfg, stats=stats, **kw)
    esc_s = time.perf_counter() - t0
    counts = end_path()
    top = [r[0][0] for r in res]
    check(top == truths, f"escalating match: top {top}, want {truths}")
    check(stats["escalated"] == renditions,
          f"escalated {stats['escalated']}, want the renditions {renditions}")
    n_esc = len(renditions)
    check(counts.get("cqt") == len(pcms) + n_esc
          and counts.get("fingerprint") == len(pcms) + v * n_esc
          and all(counts.get(k, 0) > 0 for k in ("coarse_scan_batch", "coarse_rescan",
                                                  "fine_rescan")),
          f"escalation launches {counts}: want K1 {len(pcms)} + {n_esc}, K2 {len(pcms)} + "
          f"{v} x {n_esc}, and the matcher's kernels")
    # The same call through the plain extraction on the card: the same stats,
    # and the same results for every query whose prints (rigid and all
    # variants) are the same. K1 is within 1e-4 of the plain CQT, so a bit of
    # a query's prints may differ, and a score by as many: such a query's top
    # hit keeps its (id, offset), its score within the differing bits.
    filt = filters_from_jax(filters_np, cfg, dev)
    pcm_t = torch.from_numpy(pcms).to(dev)
    stacks = api.fingerprint_scan_batch_device(pcm_t, filt, cfg, hyps)
    plain_stats: dict = {}
    with plain_versions():
        res_plain = api.match_scan_escalating(pcms, filters_np, ts, cfg, stats=plain_stats,
                                              **kw)
        stacks_plain = api.fingerprint_scan_batch_device(pcm_t, filt, cfg, hyps)
    q_bits = [differing_bits(a, b) for a, b in zip(stacks, stacks_plain)]
    d_score = [abs(int(a[1][0]) - int(b[1][0])) for a, b in zip(res, res_plain)]
    same = [same_results([a], [b]) for a, b in zip(res, res_plain)]
    check(plain_stats == stats
          and all(s for s, q in zip(same, q_bits) if q == 0)
          and all((a[0][0], int(a[2][0])) == (b[0][0], int(b[2][0])) and d <= q
                  for a, b, d, q in zip(res, res_plain, d_score, q_bits)),
          f"escalation through the plain extraction: stats {plain_stats} vs {stats}, "
          f"identical results {same}, top "
          f"{[(r[0][0], int(r[1][0]), int(r[2][0])) for r in res_plain]} vs "
          f"{[(r[0][0], int(r[1][0]), int(r[2][0])) for r in res]}, query bits {q_bits}")
    check(torch.equal(stacks[:, v // 2], api.fingerprint_batch_device(pcm_t, filt, cfg)),
          "the scan's identity row differs from plain extraction")
    worst, total = 0, 0
    for i in range(len(pcms)):
        for j, sv in enumerate(api.scan_spectra(frontend.cqt(pcm_t[i], cfg), hyps)):
            bits = differing_bits(stacks[i, j], fp_ops.fingerprint_from_spec_ref(sv, filt, cfg))
            check(bits <= k2_gate(stacks[i, j]),
                  f"query {i} variant {hyps[j]}: {bits} differing bits > {k2_gate(stacks[i, j])}")
            worst, total = max(worst, bits), total + bits

    # Times: one query's scan extraction (K1, the gathers, V x K2) by CUDA
    # events, at most 8 calls behind the spin so that their launches fit the
    # card's launch queue, and by host clock; the rigid and the escalated
    # match_batch by host clock (median of 5).
    def host_ms(fn) -> float:
        fn()
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(lat)

    def scan_one():
        return api.fingerprint_scan_batch_device(pcm_t[:1], filt, cfg, hyps)

    variants = api.scan_spectra(frontend.cqt(pcm_t[0], cfg), hyps)
    scan_ms, scan_host = cuda_ms(scan_one, max_reps=8), host_ms(scan_one)
    k1_ms = cuda_ms(lambda: frontend.cqt(pcm_t[0], cfg))
    k2_ms = cuda_ms(lambda: [fp_ops.fingerprint_from_spec(sv, filt, cfg) for sv in variants],
                    max_reps=8)
    stacks_np = api._to_numpy_prints(stacks)
    sbatch = max(1, min(10, 70 // v))
    k_int = max(2, cfg.top_k)
    rigid_np = stacks_np[:, v // 2]
    esc_np = stacks_np[SCAN_IN_TEMPO:SCAN_IN_TEMPO + sbatch]

    # The escalation's first dispatch (sbatch queries x V variant rows) once
    # more, with every K4 and K5 call held to its plain version on the same
    # inputs, then once through the plain K4 and K5: the same results.
    held: dict = {}
    with matcher_held_to_plain(held):
        esc = ts.match_batch(esc_np, top_k=k_int)
    check(all(k in held for k in ("coarse_scan_batch", "coarse_rescan", "fine_rescan")),
          f"the escalated match_batch ran {sorted(held)}, want pass 1, the rescan and K5")
    with plain_matcher():
        esc_plain = ts.match_batch(esc_np, top_k=k_int)
    check(same_results(esc, esc_plain),
          "the escalated match_batch through the plain K4 and K5 differs")
    # The same dispatch as the main path runs it: eager, then captured and
    # replayed as a CUDA graph, then replayed; each equal to the plain run.
    first = profiling.new_id()
    esc_graphed = [ts.match_batch(esc_np, top_k=k_int) for _ in range(3)]
    g_esc = graphed_dispatches(first)
    check(g_esc[0] >= 2 and all(same_results(r, esc_plain) for r in esc_graphed),
          f"the escalated match_batch replayed {g_esc} graphed of all dispatches, or a "
          "replay differs from the plain K4 and K5")

    rigid_ms = host_ms(lambda: ts.match_batch(rigid_np, top_k=k_int, stretch_span=0.0))
    esc_ms = host_ms(lambda: ts.match_batch(esc_np, top_k=k_int))
    scores = [(int(r[1][0]), int(r[1][1])) for r in res]
    log(f"phase 19 rendition scan: {len(pcms)} x {SCAN_SECONDS:.0f} s queries ({SCAN_IN_TEMPO} "
        f"in tempo, {SCAN_RENDITIONS} at +{RENDITION_SEMITONES} st), V = {v}: all rank their "
        f"tracks first; escalated {stats['escalated']}, overridden {stats['overridden']}; "
        f"top-1/top-2 scores {scores} of {64 * stacks.shape[2]}; through the plain "
        f"extraction: the same stats and top hits, {sum(same)}/{len(pcms)} top-{cfg.top_k} "
        f"results identical (every query with 0 differing bits), top-1 scores off by "
        f"{d_score} with {q_bits} differing query bits (rigid and all variants); identity "
        f"row == plain extraction; variant K2 vs plain: worst {worst}, total {total} "
        f"differing bits; {esc_s:.2f} s; launches {counts}")
    log(f"phase 19 escalated match_batch of {sbatch} x {v} variant rows: K4 and K5 equal to "
        f"their plain versions on the path's inputs ("
        + ", ".join(f"{k} on {sorted(set(s))}" for k, s in held.items())
        + "); the dispatch through the plain K4 and K5 gives the same results, and so do "
        f"an eager call, a capture and a replay of its CUDA graph ({g_esc[0]} of {g_esc[1]} "
        "dispatches graphed)")
    log(f"phase 19 times: scan extraction a query (K1, the gathers, {v} x K2) {scan_ms:.4f} "
        f"ms by CUDA events, {scan_host:.3f} ms by host clock; K1 alone {k1_ms:.4f} ms, {v} x "
        f"K2 alone {k2_ms:.4f} ms; match_batch (host clock, median of 5): rigid {len(pcms)} "
        f"queries {rigid_ms:.3f} ms, escalated {sbatch} x {v} variant rows {esc_ms:.3f} ms "
        f"= {esc_ms / sbatch:.3f} ms a query")
    return pcms, truths


def run_artists(dev: torch.device) -> tuple:
    """Phase 20: known-artist mode at config 5's artist_eval sizes. Returns
    (the ArtistDB, its scaled twin, the queries) for phase 30."""
    from hpfw_tpu_torch import ArtistDB, api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.ops import fingerprint as fp_ops
    from hpfw_tpu_torch.ops import frontend

    cfg = HpfwConfig()
    t0 = time.perf_counter()
    catalogs = {f"artist{a}": {f"a{a}t{i}": synth.synth_artist_track(a, i, ARTIST_SECONDS, cfg)
                               for i in range(ARTIST_TRACKS)}
                for a in range(ARTISTS)}
    log(f"  synthesized {ARTISTS} x {ARTIST_TRACKS} x {ARTIST_SECONDS:.0f} s in "
        f"{time.perf_counter() - t0:.1f} s")
    n_tracks = ARTISTS * ARTIST_TRACKS
    start_path()
    t0 = time.perf_counter()
    adb = ArtistDB.build(catalogs, cfg, device=dev)
    build_s = time.perf_counter() - t0
    counts = end_path()
    check(counts == {"cqt": 2 * n_tracks, "fingerprint": n_tracks},
          f"build launches {counts}: want K1 {2 * n_tracks} (learning, extraction), "
          f"K2 {n_tracks}")
    # Stride 4, as tests/test_artist.py scales its banks: at the default
    # stride of 16 a query whose offset lies half a window off the grid
    # loses its coarse peak (config.py's coarse_query_phases note).
    scaled = ArtistDB(cfg, adb.banks, scaled=True, stride=4, device=dev)
    queries = []
    for a, name in enumerate(adb.artists):
        tid = f"a{a}t{(3 * a + 1) % ARTIST_TRACKS}"
        queries.append((name, tid, synth.make_query(catalogs[name][tid], 1.5 + a,
                                                    ARTIST_QUERY_SECONDS, cfg,
                                                    noise_db=-20.0, seed=200 + a)))
    start_path()
    t0 = time.perf_counter()
    for name, tid, q in queries:
        for mode in ("known", "unknown"):
            want = tid if mode == "known" else (name, tid)
            kw = dict(artist=name) if mode == "known" else {}
            dense, two = adb.match(q, **kw), scaled.match(q, **kw)
            hit = (dense[0][0], int(dense[1][0]), int(dense[2][0]))
            check(hit[0] == want, f"{mode} artist, dense: top {hit}, want {want}")
            check((two[0][0], int(two[1][0]), int(two[2][0])) == hit,
                  f"{mode} artist: scaled top {two[0][0]} {two[1][0]} {two[2][0]} != dense {hit}")
    match_s = time.perf_counter() - t0
    counts = end_path()
    check(all(counts.get(k, 0) > 0 for k in ("cqt", "fingerprint", "score_tracks",
                                              "coarse_scan", "fine_rescan")),
          f"artist match launches {counts}: a kernel of the path never ran")
    # The same matches once more, every K3 (dense banks), K4 and K5 (scaled
    # banks) call held to its plain version on the same inputs.
    held: dict = {}
    with matcher_held_to_plain(held):
        for name, _, q in queries:
            for kw in (dict(artist=name), {}):
                adb.match(q, **kw), scaled.match(q, **kw)
    check(all(k in held for k in ("score_tracks", "coarse_scan", "fine_rescan")),
          f"the artist matches ran {sorted(held)}, want K3, K4 coarse_scan and K5")
    # fingerprint_multi against per-bank fingerprint and the plain versions.
    stack = np.stack([adb.banks[a].filters for a in adb.artists])
    q = queries[0][2]
    multi = api.fingerprint_multi(q, stack, cfg, device=dev)
    for i, a in enumerate(adb.artists):
        check(np.array_equal(multi[i], api.fingerprint(q, stack[i], cfg, device=dev)),
              f"fingerprint_multi bank {a} differs from fingerprint with that bank")
    with plain_versions():
        plain = api.fingerprint_multi(q, stack, cfg, device=dev)
    bits = [int(np.bitwise_count(m ^ p).sum()) for m, p in zip(multi, plain)]
    check(all(b <= k2_gate(torch.from_numpy(m)) for b, m in zip(bits, multi)),
          f"fingerprint_multi vs the plain versions: {bits} differing bits")
    stack_t = torch.from_numpy(stack).to(dev)
    pcm_t = torch.from_numpy(api._bucket_pad(q, cfg, 1.0)).to(dev)

    def multi_dev():
        spec = frontend.cqt(pcm_t, cfg)
        return [fp_ops.fingerprint_from_spec(spec, f, cfg) for f in stack_t]

    multi_ms = cuda_ms(multi_dev)
    t0 = time.perf_counter()
    for _ in range(5):
        api.fingerprint_multi(q, stack, cfg, device=dev)
    multi_host = (time.perf_counter() - t0) / 5 * 1e3
    log(f"phase 20 artists: ArtistDB.build of {ARTISTS} x {ARTIST_TRACKS} x "
        f"{ARTIST_SECONDS:.0f} s in {build_s:.2f} s ({ARTISTS} banks learned, "
        f"{n_tracks} tracks extracted); {len(queries)} noisy {ARTIST_QUERY_SECONDS:.0f} s "
        f"queries, known and unknown artist, dense and scaled: each ranks its track first, "
        f"scaled top hit == dense, in {match_s:.2f} s; launches {counts}; K3, K4 and K5 "
        f"equal to their plain versions on every call of those matches "
        f"({ {k: len(s) for k, s in held.items()} } calls); fingerprint_multi "
        f"== per-bank fingerprint, vs plain {bits} differing bits; fingerprint_multi at A = "
        f"{ARTISTS} (K1 + {ARTISTS} x K2, {multi.shape[1]} prints) {multi_ms:.4f} ms by CUDA "
        f"events, {multi_host:.3f} ms a call by host clock (mean of 5, filter upload and "
        f"copies included)")
    return adb, scaled, queries


def drive_session(sess, live, chunk: int) -> list[dict]:
    """Feed live to sess in chunks of `chunk` samples. One record a feed:
    the lock state after it, the hypothesis, and for a feed that matched,
    its query window, the scan stack it matched (or None), the state it
    matched in and its match and step ms."""
    stacks = []
    real = sess._scan_stack

    def recorded(n, factors):
        stacks.append(real(n, factors))
        return stacks[-1]

    sess._scan_stack = recorded
    out = []
    for p in range(0, len(live), chunk):
        before, n_match, n_stacks = sess._scan_state, len(sess.match_latencies_ms), len(stacks)
        best = sess.feed(live[p:p + chunk])
        rec = {"state": (sess._scan_state, sess.tempo, sess.pitch), "best": best,
               "last": sess.last_match, "matched": len(sess.match_latencies_ms) > n_match}
        if rec["matched"]:
            n = max(b for b in sess.query_buckets if b <= len(sess._ring))
            rec.update(window=np.array(sess._ring, dtype=np.uint32)[-n:],
                       stack=stacks[-1] if len(stacks) > n_stacks else None, during=before,
                       match_ms=sess.match_latencies_ms[-1],
                       step_ms=sess.step_latencies_ms[-1])
        out.append(rec)
    del sess._scan_stack
    return out


def session_times(trace) -> str:
    """Match and step p50/p99 of the matching feeds, by the state each
    matched in."""
    parts = []
    for state in ("acquire", "track"):
        m = [r["match_ms"] for r in trace if r["matched"] and r["during"] == state]
        st = [r["step_ms"] for r in trace if r["matched"] and r["during"] == state]
        if m:
            parts.append(f"{state} ({len(m)} matches): match p50 {np.percentile(m, 50):.3f} "
                         f"p99 {np.percentile(m, 99):.3f} ms, step p50 "
                         f"{np.percentile(st, 50):.3f} p99 {np.percentile(st, 99):.3f} ms")
    return "; ".join(parts)


def rendition(pcm, start_s: float, seconds: float, cfg, seed: int) -> np.ndarray:
    """A noisy excerpt of pcm played 2.9% fast and +0.5 semitone (phase 19's
    renditions): a 1.05x longer clip resampled, cut to `seconds`."""
    from hpfw_tpu_torch.io import synth
    clip = synth.make_query(pcm, start_s, 1.05 * seconds, cfg, noise_db=-20.0, seed=seed)
    return synth.pitch_shift(clip, RENDITION_SEMITONES, cfg)[:int(seconds * cfg.sample_rate)]


def run_live_scan(ts, filters_np, stream_pcm, stream_rows, dense) -> dict:
    """Phase 21: StreamingSession's spec-level tempo and pitch scan on the
    packed catalog_scale() TwoStageDB ts of phase 14, then over phase 4's
    dense DB. Returns that dense session's feed, config and trace for phase
    29."""
    import dataclasses

    from hpfw_tpu_torch import StreamingSession, api
    from hpfw_tpu_torch.ops import fingerprint as fp_ops
    from hpfw_tpu_torch.utils import profiling
    from unittest import mock

    cfg = dataclasses.replace(ts.db.cfg, stretch_span=SCAN_SPAN, pitch_span_bins=SCAN_PITCH_BINS)
    v = len(api.scan_hypotheses(cfg))
    chunk = int(LIVE_CHUNK_S * cfg.sample_rate)
    i = SCAN_IN_TEMPO + SCAN_RENDITIONS       # a stream track phase 19 did not use
    want = str(stream_rows[i])
    live = rendition(stream_pcm[i], 2.0, SESSION_SECONDS, cfg, seed=300)
    kw = dict(query_prints=QUERY_PRINTS, chunk_prints=CHUNK_PRINTS)

    # The main path, every K2 call recorded; its dispatches replay CUDA
    # graphs from a shape's second call.
    k2_calls, held = [], {}
    real_k2 = fp_ops.fingerprint_from_spec

    def k2_spy(spec, filters, c):
        out = real_k2(spec, filters, c)
        k2_calls.append((spec, filters, c, out))
        return out

    sess = StreamingSession(ts, filters_np, cfg, **kw)
    start_path()
    first = profiling.new_id()
    t0 = time.perf_counter()
    with mock.patch.object(fp_ops, "fingerprint_from_spec", k2_spy):
        trace = drive_session(sess, live, chunk)
    run_s = time.perf_counter() - t0
    counts = end_path()
    graphed = graphed_dispatches(first)
    check(graphed[0] > 0, f"rendition session: {graphed[0]} of {graphed[1]} dispatches graphed")
    worst = 0
    for spec, filters, c, out in k2_calls:
        bits = differing_bits(out, fp_ops.fingerprint_from_spec_ref(spec, filters, c))
        check(bits <= k2_gate(out), f"session K2 on {tuple(spec.shape)}: {bits} differing bits")
        worst = max(worst, bits)
    best = trace[-1]["best"]
    check(best is not None and best.track_id == want, f"rendition session: {best}, want {want}")
    states = [r["state"] for r in trace if r["matched"]]
    path = [st for k, st in enumerate(states) if k == 0 or st != states[k - 1]]
    lock = next((st for st in path if st[0] == "track"), None)
    check(lock is not None and lock[2] == 1 and abs(lock[1] - 1.03) <= SCAN_STEP + 1e-9
          and sess._scan_state == "track" and sess.pitch == 1,
          f"rendition session: state path {path}, want a lock at pitch +1 and a tempo "
          f"within {SCAN_STEP} of 1.03, tracking at the end")
    first_acquire = next(r for r in trace if r["matched"] and r["during"] == "acquire"
                         and r["stack"] is not None)
    check(first_acquire["stack"].shape[0] == v and all(
        counts.get(k, 0) > 0 for k in ("cqt", "fingerprint", "coarse_scan_batch_packed",
                                        "coarse_rescan", "fine_rescan")),
          f"rendition session launches {counts}: want K1, K2 and the packed matcher's kernels")

    def same_as(other, route: str) -> int:
        """Checks that other has trace's states and top tracks on every feed,
        and its answers where the prints are equal: how many those are."""
        same_prints = 0
        check(len(other) == len(trace), f"{route}: {len(other)} feeds, want {len(trace)}")
        for a, b in zip(trace, other):
            check(a["state"] == b["state"] and a["matched"] == b["matched"]
                  and (a["best"] is None) == (b["best"] is None)
                  and (a["best"] is None or a["best"].track_id == b["best"].track_id),
                  f"{route} diverges: {a['state']} {a['best']} vs {b['state']} {b['best']}")
            if a["matched"] and np.array_equal(a["window"], b["window"]) and (
                    (a["stack"] is None and b["stack"] is None)
                    or (a["stack"] is not None and b["stack"] is not None
                        and np.array_equal(a["stack"], b["stack"]))):
                same_prints += 1
                check(a["last"] == b["last"],
                      f"{route}, equal prints, different answers: {a['last']} vs {b['last']}")
        return same_prints

    # The same stream in a session of its own, its dispatches eager and every
    # K4/K5 call held to its plain version on the same inputs.
    with matcher_held_to_plain(held):
        eager = drive_session(StreamingSession(ts, filters_np, cfg, **kw), live, chunk)
    same_eager = same_as(eager, "the eager route")

    # The same stream through the plain K1/K2/K4/K5 on the card.
    plain_sess = StreamingSession(ts, filters_np, cfg, **kw)
    with plain_versions(), plain_matcher():
        plain = drive_session(plain_sess, live, chunk)
    same_prints = same_as(plain, "the plain route")
    n_matches = sum(r["matched"] for r in trace)
    log(f"phase 21 live scan: {SESSION_SECONDS:.0f} s rendition (+{RENDITION_SEMITONES} st, "
        f"2.9% fast) of track {want} in {LIVE_CHUNK_S} s chunks, V = {v}: {n_matches} "
        f"matches, {sum(r['during'] == 'acquire' for r in trace if r['matched'])} acquiring; "
        f"locked at {lock[1:]}, ends at ({sess.tempo}, {sess.pitch}) -> {best.track_id} score "
        f"{best.score} offset {best.offset} confidence {best.confidence:.3f}; state path "
        f"{path}; {run_s:.2f} s")
    log(f"phase 21 live scan times: {session_times(trace)}; launches {counts}; "
        f"{graphed[0]} of {graphed[1]} dispatches replayed a CUDA graph")
    log(f"phase 21 live scan through the plain K1/K2/K4/K5: the same states and top tracks "
        f"on all {len(trace)} feeds, the same scores and offsets on the {same_prints} of "
        f"{n_matches} matches whose prints are equal; {len(k2_calls)} K2 calls within K2's "
        f"gate (worst {worst} bits); with eager dispatches the same states and top tracks, "
        f"the same answers on {same_eager} of {n_matches}, and K4/K5 equal to their plain "
        f"versions on every call (" + ", ".join(f"{k} x {len(sh)}" for k, sh in held.items())
        + ")")

    # In tempo: locks at (1.0, 0) and then matches rigid only.
    sess = StreamingSession(ts, filters_np, cfg, **kw)
    live = stream_pcm[i + 1][:int(SESSION_SECONDS * cfg.sample_rate)]
    start_path()
    trace = drive_session(sess, live, chunk)
    counts = end_path()
    best = trace[-1]["best"]
    check(best is not None and best.track_id == str(stream_rows[i + 1])
          and (sess._scan_state, sess.tempo, sess.pitch) == ("track", 1.0, 0)
          and sess._scan_factors() == (),
          f"in-tempo session: {best}, state {sess._scan_state} ({sess.tempo}, {sess.pitch})")
    n_scanned = sum(r["stack"] is not None for r in trace if r["matched"])
    log(f"phase 21 live scan in tempo: -> {best.track_id} score {best.score}, locked at "
        f"(1.0, 0), rigid only after the lock ({n_scanned} scanned matches of "
        f"{sum(r['matched'] for r in trace)}); {session_times(trace)}; "
        f"launches {counts}")

    # Over phase 4's dense DB: K3 once a hypothesis while acquiring.
    dcfg = dataclasses.replace(dense["db"].cfg, stretch_span=SCAN_SPAN,
                               pitch_span_bins=SCAN_PITCH_BINS)
    live = rendition(dense["tracks"][QUERY_TRACK], 3.0, DENSE_LIVE_SECONDS, dcfg, seed=301)
    sess = StreamingSession(dense["db"], dense["filters"], dcfg, **kw)
    start_path()
    trace = drive_session(sess, live, chunk)
    counts = end_path()
    best = trace[-1]["best"]
    n_scans = sum(0 if r.get("stack") is None else r["stack"].shape[0] for r in trace)
    check(best is not None and best.track_id == str(QUERY_TRACK)
          and counts.get("score_tracks", 0) >= n_scans >= v,
          f"dense live scan: {best}, launches {counts}, {n_scans} scanned variants")
    log(f"phase 21 dense live scan: {DENSE_LIVE_SECONDS:.0f} s rendition of track "
        f"{QUERY_TRACK} over phase 4's {dense['db'].n_tracks}-track DB -> {best.track_id}, "
        f"state ({sess._scan_state}, {sess.tempo}, {sess.pitch}); {n_scans} variant K3 "
        f"scans; {session_times(trace)}; launches {counts}")
    return {"live": live, "cfg": dcfg, "kw": kw, "chunk": chunk, "trace": trace,
            "counts": counts}


def same_answer(a, b) -> bool:
    """Two (ids, scores, offsets[, escalated]) answers are identical."""
    return (list(a[0]) == list(b[0]) and np.array_equal(a[1], b[1])
            and np.array_equal(a[2], b[2]) and a[3:] == b[3:])


def run_escalating_load(srv, pcms, expect, truths, lam, rng, n_queries, renditions) -> dict:
    """n_queries PCM windows with exponential gaps at lam queries/s, a quarter
    of them renditions; every served answer must equal expect[i] for its
    query i (its answer served alone). Recall: served answers whose top track
    is truths[i]."""
    from hpfw_tpu_torch import ServerSaturated

    in_tempo = [i for i in range(len(pcms)) if i not in renditions]
    picks = [int(rng.choice(renditions if rng.random() < 0.25 else in_tempo))
             for _ in range(n_queries)]
    lat = {False: [], True: []}
    shed, errors, wrong, hits = [0], [], [], [0]
    lock = threading.Lock()
    pending = [n_queries]
    all_done = threading.Event()

    def callback(i, t_sub):
        def done(fut):
            exc = fut.exception()
            with lock:
                if exc is None:
                    r = fut.result()
                    lat[r[3]].append((time.perf_counter() - t_sub) * 1e3)
                    if not same_answer(r, expect[i]):
                        wrong.append(i)
                    hits[0] += r[0][0] == truths[i]
                elif isinstance(exc, ServerSaturated):
                    shed[0] += 1
                else:
                    errors.append(repr(exc))
                pending[0] -= 1
                if pending[0] == 0:
                    all_done.set()
        return done

    gaps = rng.exponential(1.0 / lam, n_queries)
    t_start = time.perf_counter()
    for k, i in enumerate(picks):
        t_sub = time.perf_counter()
        srv.submit(pcms[i]).add_done_callback(callback(i, t_sub))
        time.sleep(max(0.0, gaps[k]))
    check(all_done.wait(timeout=300), f"offered {lam} q/s: not every query was answered")
    wall = time.perf_counter() - t_start
    check(not errors, f"offered {lam} q/s: futures failed: {errors[:3]}")
    check(not wrong, f"offered {lam} q/s: answers of queries {sorted(set(wrong))} differ from "
          "the same query served alone")
    served = n_queries - shed[0]

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else float("nan")

    return {"n": n_queries, "achieved": served / wall, "shed": shed[0] / n_queries,
            "recall": hits[0] / max(served, 1), "renditions": sum(
                i in renditions for i in picks),
            "confident": (len(lat[False]), pct(lat[False], 50), pct(lat[False], 99)),
            "escalated": (len(lat[True]), pct(lat[True], 50), pct(lat[True], 99))}


def run_escalating_server(ts, filters_np, pcms, truths) -> None:
    """Phase 22: EscalatingMatchServer over the packed catalog_scale()
    TwoStageDB ts (phase 14), on phase 19's 8 queries (V = 21)."""
    from hpfw_tpu_torch import EscalatingMatchServer, api

    cfg = ts.db.cfg
    kw = dict(span=SCAN_SPAN, pitch_span_bins=SCAN_PITCH_BINS)
    renditions = list(range(SCAN_IN_TEMPO, len(pcms)))
    for gate in (None, 0.75):
        stats_api: dict = {}
        want = api.match_scan_escalating(pcms, filters_np, ts, cfg, structure_gate=gate,
                                         stats=stats_api, **kw)
        start_path()
        with EscalatingMatchServer(ts, filters_np, pcms.shape[1], max_batch=16,
                                   structure_gate=gate, **kw) as srv:
            t0 = time.perf_counter()
            srv.warmup(pcms[0])
            warm_s = time.perf_counter() - t0
            got = [f.result(timeout=120) for f in [srv.submit(p) for p in pcms]]
            alone = [srv.match(p) for p in pcms]
            stats = dict(srv.stats)
            counts = end_path()
            flags = [i for i, r in enumerate(got) if r[3]]
            check(all(same_answer(g[:3], w) for g, w in zip(got, want))
                  and flags == stats_api["escalated"]
                  and all(same_answer(g, a) for g, a in zip(got, alone)),
                  f"structure_gate {gate}: the server's answers differ from "
                  f"match_scan_escalating's (escalated {flags} vs {stats_api['escalated']})")
            check([g[0][0] for g in got] == truths, f"server top {[g[0][0] for g in got]}")
            check(stats["submitted"] == 2 * len(pcms)
                  and stats["confident"] + stats["structure_kept"] + stats["escalated"]
                  == stats["submitted"]
                  and stats["escalated"] == 2 * len(stats_api["escalated"])
                  and stats["structure_kept"] == 2 * len(stats_api["structure_kept"])
                  and stats["overridden"] == 2 * len(stats_api["overridden"]),
                  f"structure_gate {gate}: stats {stats} vs match_scan_escalating's "
                  f"{stats_api} (each query submitted twice)")
            check(all(counts.get(k, 0) > 0 for k in ("cqt", "fingerprint",
                                                      "coarse_scan_batch_packed",
                                                      "coarse_rescan", "fine_rescan")),
                  f"server launches {counts}: a kernel of the path never ran")
            log(f"phase 22 escalating server (structure_gate {gate}): warmup {warm_s:.2f} s; "
                f"{len(pcms)} queries together and alone == match_scan_escalating (ids, "
                f"scores, offsets, escalated {flags}); stats {stats}; launches {counts}")
            if gate is not None:
                continue
            rng = np.random.default_rng(2)
            for lam in ESC_LOADS:
                start_path()
                r = run_escalating_load(srv, pcms, got, truths, lam, rng, ESC_QUERIES,
                                        renditions)
                counts = end_path()
                c, e = r["confident"], r["escalated"]
                log(f"phase 22 offered {lam:.0f} q/s ({r['n']} queries, {r['renditions']} "
                    f"renditions): confident {c[0]} p50 {c[1]:.3f} p99 {c[2]:.3f} ms, "
                    f"escalated {e[0]} p50 {e[1]:.3f} p99 {e[2]:.3f} ms; achieved "
                    f"{r['achieved']:.1f} q/s, shed {r['shed']:.1%}, recall {r['recall']:.3f} "
                    f"(every served answer == the query's answer alone); launches {counts}")


def write_ingest_wavs(directory) -> list[str]:
    """Phase 23's files: INGEST_FILES synthetic tracks of INGEST_SECONDS saved
    as INGEST_RATE stereo WAV (the right channel 0.6 x the left) in directory."""
    from pathlib import Path

    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.io import synth, wav

    cfg = HpfwConfig()
    Path(directory).mkdir(parents=True, exist_ok=True)
    paths = [str(Path(directory) / f"track{k:02d}.wav") for k in range(INGEST_FILES)]

    def write(k):
        left = wav.resample(synth.synth_track(INGEST_SEED + k, INGEST_SECONDS, cfg),
                            cfg.sample_rate, INGEST_RATE)
        wav.save_wav(paths[k], np.stack([left, 0.6 * left], axis=1), INGEST_RATE)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(INGEST_FILES)))
    return paths


def run_ingest(dev: torch.device, dense: dict) -> None:
    """Phase 23: api.build_db_from_files over 64 synthetic 30 s tracks saved
    as 44.1 kHz stereo WAV (downmix and sinc resampling run), against
    api.build_db over load_files' PCM."""
    import tempfile
    from pathlib import Path

    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.io import ingest, native, synth

    cfg = HpfwConfig()
    filters_np = dense["filters"]
    t0 = time.perf_counter()
    lib = native.build_library()
    native.load_library()
    native_s = time.perf_counter() - t0
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as d:
        t0 = time.perf_counter()
        paths = write_ingest_wavs(d)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pcms = ingest.load_files(paths, cfg)
        decode_s = time.perf_counter() - t0
        start_path()
        t0 = time.perf_counter()
        db = api.build_db_from_files(paths, filters_np, cfg, batch=8, device=dev)
        build_s = time.perf_counter() - t0
        counts = end_path()
    check(counts == {"cqt": INGEST_FILES, "fingerprint": INGEST_FILES},
          f"build_db_from_files launches {counts}, want K1 and K2 {INGEST_FILES} times each")
    direct = api.build_db(dict(zip(paths, pcms)), filters_np, cfg, device=dev)
    check(db.track_ids == direct.track_ids and np.array_equal(db.lengths, direct.lengths),
          "build_db_from_files: ids or lengths differ from build_db")
    bits = []
    for t in range(len(paths)):
        n = int(db.lengths[t])
        a, b = db.prints[t, :n], direct.prints[t, :n]
        bits.append(int(np.bitwise_count(a ^ b).sum()))
        check(n > 0 and bits[-1] <= k2_gate(torch.from_numpy(a)),
              f"file {t}: {bits[-1]} bits differ from build_db's prints")
    q = synth.make_query(pcms[INGEST_QUERY], 7.0, QUERY_SECONDS, cfg, noise_db=-20.0, seed=23)
    ids, scores, offs = api.match(api.fingerprint(q, filters_np, cfg, device=dev), db, top_k=2)
    exp_off = round(7.0 * cfg.sample_rate / cfg.hop)
    check(ids[0] == paths[INGEST_QUERY] and abs(int(offs[0]) - exp_off) <= 1,
          f"file query: top {ids[0]} at {offs[0]}, want {paths[INGEST_QUERY]} at {exp_off}")
    audio_s = INGEST_FILES * INGEST_SECONDS
    log(f"phase 23 ingest: {INGEST_FILES} x {INGEST_SECONDS:.0f} s stereo {INGEST_RATE} Hz "
        f"WAV ({write_s:.2f} s to write); native library {lib.parent.name} ready in "
        f"{native_s:.2f} s; load_files alone {decode_s:.2f} s; build_db_from_files "
        f"{build_s:.2f} s = {INGEST_FILES / build_s:.1f} tracks/s = "
        f"{audio_s / build_s:.0f}x realtime (host clock, decode and extraction overlapped); "
        f"prints vs build_db: {sum(b == 0 for b in bits)}/{len(bits)} tracks identical, "
        f"{sum(bits)} bits in all; noisy excerpt -> {Path(ids[0]).name} @ {int(offs[0])} "
        f"score {int(scores[0])}; launches {counts}")


def run_stream(dev: torch.device, dense: dict) -> None:
    """Phase 24: api.fingerprint_stream over 8 batches of 16 x 240 s against
    fingerprint_batch, and its realtime factor beside phase 7's."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.filters import filters_from_jax

    cfg = HpfwConfig()
    long_pcm, filters_np = dense["long_pcm"], dense["filters"]
    step = len(long_pcm) // (STREAM_BATCHES * BATCH)
    # In host memory before any timing (2.7 GB): the stream's cost, not the
    # making of its input.
    batches = [np.stack([np.roll(long_pcm, (i * BATCH + j) * step) for j in range(BATCH)])
               for i in range(STREAM_BATCHES)]
    start_path()
    t0 = time.perf_counter()
    got = list(api.fingerprint_stream(iter(batches), filters_np, cfg, device=dev))
    first_s = time.perf_counter() - t0
    counts = end_path()
    n_rows = STREAM_BATCHES * BATCH
    check(counts == {"cqt": n_rows, "fingerprint": n_rows},
          f"fingerprint_stream launches {counts}, want K1 and K2 {n_rows} times each")
    for i, (g, b) in enumerate(zip(got, batches)):
        check(np.array_equal(g, api.fingerprint_batch(b, filters_np, cfg, device=dev)),
              f"fingerprint_stream batch {i} differs from fingerprint_batch")
    check(len(got) == STREAM_BATCHES, f"{len(got)} batches yielded")
    del got

    # In turns: the extraction of phase 7 on card-resident rows (CUDA
    # events), the stream (host clock, uploads and copies included).
    filt = filters_from_jax(filters_np, cfg, dev)
    resident = torch.from_numpy(batches[0]).to(dev)

    def stream_s() -> float:
        t1 = time.perf_counter()
        for _ in api.fingerprint_stream(iter(batches), filters_np, cfg, device=dev):
            pass
        return time.perf_counter() - t1

    def resident_ms() -> float:
        return cuda_ms(lambda: api.fingerprint_batch_device(resident, filt, cfg),
                       min_total_ms=1000.0, max_reps=5)

    r1, s1, s2, r2 = resident_ms(), stream_s(), stream_s(), resident_ms()
    audio_s = n_rows * LONG_SECONDS
    batch_audio = BATCH * LONG_SECONDS
    log(f"phase 24 fingerprint_stream: {STREAM_BATCHES} batches of {BATCH} x "
        f"{LONG_SECONDS:.0f} s, each == fingerprint_batch bit for bit; launches {counts}; "
        f"in turns: card-resident batch {r1:.2f}/{r2:.2f} ms = "
        f"{batch_audio / (r1 / 1e3):.0f}x/{batch_audio / (r2 / 1e3):.0f}x realtime (phase 7 "
        f"read {batch_audio / (dense['batch_ms'] / 1e3):.0f}x), stream {s1:.3f}/{s2:.3f} s "
        f"= {audio_s / s1:.0f}x/{audio_s / s2:.0f}x realtime (host clock, uploads and "
        f"copies included; the first pass {first_s:.3f} s)")


# ---- phases 25-30: the track-sharded matchers on logical shards of the card ----

MESH_SHARDS = 4                     # logical shards on cuda:0 (the card is one)
MESH_LOAD, MESH_LOAD_QUERIES = 50.0, 100


def host_ms(fn, reps: int = 11) -> float:
    """Median host-clock ms of fn() over reps calls (each ends on the host)."""
    out = []
    for _ in range(reps):
        t1 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(out)


def run_dryrun(dev: torch.device) -> None:
    """Phase 25: dryrun_multichip's five distributed steps on 4 logical
    shards of the card (K1 a shard for the covariance, K3 a shard for
    sharded_score, K4 and K5 a shard for each two-stage match)."""
    from hpfw_tpu_torch.parallel.dryrun import dryrun_multichip

    start_path()
    t0 = time.perf_counter()
    dryrun_multichip(MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    run_s = time.perf_counter() - t0
    counts = end_path()
    d = MESH_SHARDS
    want = {"cqt": d, "score_tracks": d, "coarse_scan_batch": 3 * d, "coarse_rescan": d,
            "fine_rescan": 3 * d}
    check(counts == want, f"dryrun launches {counts}, want {want}")
    log(f"phase 25 dryrun_multichip({d}, devices=[{dev}] x {d}): the covariance sum, "
        f"sharded_score, a sharded match, match_batch and the two-pass prefilter pass the "
        f"reference's checks in {run_s:.2f} s; launches {counts}")


def run_sharded_dense(dev: torch.device, dense: dict) -> None:
    """Phase 26: ShardedDB over phase 5's planted catalog at D = 1 (the one
    card, db_mesh(1)) and D = 4 logical shards: api.match's top 10 exactly,
    K3 D times a match, each K3 call equal to its plain version."""
    from hpfw_tpu_torch import ShardedDB, api, db_mesh
    from hpfw_tpu_torch.parallel.mesh import Mesh

    cat_db, cat_q = dense["cat_db"], dense["cat_q"]
    t_star, o_star = dense["cat_plant"]
    want = api.match(cat_q, cat_db, top_k=10)
    check(want[0][0] == f"cat{t_star}" and int(want[2][0]) == o_star,
          f"planted catalog: api.match top {want[0][0]} @ {want[2][0]}")
    times = {}
    for d, mesh in ((1, db_mesh(1)), (MESH_SHARDS, Mesh([dev] * MESH_SHARDS))):
        t0 = time.perf_counter()
        sdb = ShardedDB(cat_db, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        start_path()
        got = sdb.match(cat_q, top_k=10)
        counts = end_path()
        check(same_answer(got, want), f"ShardedDB D={d}: top 10 {got[0]} differs from "
              f"api.match's {want[0]}")
        check(counts == {"score_tracks": d}, f"ShardedDB D={d} launches {counts}")
        held: dict = {}
        with matcher_held_to_plain(held):
            sdb.match(cat_q, top_k=10)
        check(len(held.get("score_tracks", ())) == d, f"ShardedDB D={d}: held {held}")
        times[d] = (host_ms(lambda: sdb.match(cat_q, top_k=10)),
                    host_ms(lambda: api.match(cat_q, cat_db, top_k=10)))
        log(f"phase 26 ShardedDB D={d} over the {cat_db.n_tracks} x "
            f"{cat_db.prints.shape[1]}-print catalog (shards of {sdb.shards[0][0].shape[0]} "
            f"tracks, built in {build_s:.2f} s): top 10 == api.match's (ids, scores, "
            f"offsets), {want[0][0]} @ {int(want[2][0])} score {int(want[1][0])}; launches "
            f"{counts}; every K3 call == its plain version; match {times[d][0]:.3f} ms "
            f"against api.match {times[d][1]:.3f} ms (host clock, median of 11, in turns)")
        del sdb


def profile_match(ts, q, n: int = 5) -> dict:
    """torch.profiler (CPU and CUDA activities) over n calls of ts.match(q),
    per match: kernel launches (cudaLaunchKernel calls), the ops' self CPU
    ms, the kernels' device ms, and the three kernels of most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ts.match(q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ts.match(q)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=dev_us,
                     reverse=True)

    def short(name: str) -> str:
        for junk in ("void ", "(anonymous namespace)::", "at::native::", "at_cuda_detail::"):
            name = name.replace(junk, "")
        return name.split("(")[0][:48]

    return {"launches": sum(e.count for e in events if e.key == "cudaLaunchKernel") / n,
            "cpu_ms": sum(e.self_cpu_time_total for e in events) / n / 1e3,
            "device_ms": sum(dev_us(e) for e in kernels) / n / 1e3,
            "top": ", ".join(f"{short(e.key)} x{e.count / n:g} {dev_us(e) / n / 1e3:.3f} ms"
                             for e in kernels[:3])}


def run_sharded_catalog(dev: torch.device, ts_p, qs_np, want, single, batched):
    """Phase 27: TwoStageDB(prefilter_pack4=True, mesh=) over the
    catalog_scale() catalog at D = 1 (db_mesh(1)) and D = 4 logical shards.
    Returns the D = 4 DB for phase 28."""
    from hpfw_tpu_torch import TwoStageDB, db_mesh
    from hpfw_tpu_torch.parallel.mesh import Mesh

    start_path()
    for q in qs_np:
        ts_p.match(q, top_k=10)
    flat_match = end_path()
    start_path()
    match_in_batches(ts_p, qs_np)
    flat_batch = end_path()
    qd = torch.from_numpy(qs_np[:8].view(np.int32)).to(dev)
    mesh_dbs = {}
    for d, mesh in ((1, db_mesh(1)), (MESH_SHARDS, Mesh([dev] * MESH_SHARDS))):
        t0 = time.perf_counter()
        mts = TwoStageDB(ts_p.db, prefilter_pack4=True, mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        shard_rows = [s.db_c.shape[0] for s in mts.shards]
        check(len(shard_rows) == d and sum(shard_rows) == -(-ts_p.n_real // (8 * d)) * 8 * d,
              f"D={d}: shards of {shard_rows} rows")
        start_path()
        res = [mts.match(q, top_k=10) for q in qs_np]
        m_counts = end_path()
        start_path()
        bres = match_in_batches(mts, qs_np)
        b_counts = end_path()
        if d == 1:
            check(same_results(res, single) and same_results(bres, batched),
                  "D=1: match or match_batch differs from the unsharded DB's")
        for i, (r, b) in enumerate(zip(res, bres)):
            for label, x in (("match", r), ("match_batch", b)):
                check((x[0][0], int(x[1][0]), int(x[2][0])) == want[i],
                      f"D={d} {label} query {i}: top {x[0][0]} {x[1][0]} {x[2][0]}, "
                      f"want {want[i]} (K3 dense)")
        for label, got, flat in (("match", m_counts, flat_match),
                                 ("match_batch", b_counts, flat_batch)):
            check(got == {k: d * v for k, v in flat.items()},
                  f"D={d} {label} launches {got}, want {d} x {flat}")
        # No host sync anywhere in a dispatch: every shard's work is queued
        # before the caller reads anything.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = mts.dispatch_batch(qd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        k = min(-(-min(ts_p.db.cfg.fine_candidates, shard_rows[0]) // 8) * 8, shard_rows[0])
        check(tuple(out.shape) == (8, 3, d * k), f"D={d}: dispatch_batch shape "
              f"{tuple(out.shape)}, want (8, 3, {d} x {k})")
        held: dict = {}
        with matcher_held_to_plain(held):
            mts.match(qs_np[0], top_k=10)
        per_match = {k: len(v) for k, v in held.items()}
        check(per_match == {k: d * v // len(qs_np) for k, v in flat_match.items()},
              f"D={d}: one match held {per_match}")
        mesh_dbs[d] = mts
        log(f"phase 27 TwoStageDB(mesh) D={d}: built in {build_s:.1f} s (shards of "
            f"{shard_rows[0]} tracks); {len(qs_np)}/{len(qs_np)} planted tracks first at "
            f"K3's (score, offset) through match and match_batch (8, 8, 4)"
            + (", identical to the unsharded DB (ids, scores, offsets of the top 10)"
               if d == 1 else "")
            + f"; launches {len(qs_np)} x match {m_counts}, match_batch {b_counts} (= {d} x "
            f"the unsharded DB's); dispatch_batch of 8 with no host sync; K4 and K5 of one "
            f"match == their plain versions ({per_match})")
    # The three in turns, in one call.
    for label, which in (("unsharded", ts_p), ("D=1", mesh_dbs[1]),
                         (f"D={MESH_SHARDS}", mesh_dbs[MESH_SHARDS]),
                         (f"D={MESH_SHARDS}", mesh_dbs[MESH_SHARDS]), ("D=1", mesh_dbs[1]),
                         ("unsharded", ts_p)):
        log_match_times(f"phase 27 {label}", match_times(which, qs_np))
    for label, which in (("unsharded", ts_p), (f"D={MESH_SHARDS}", mesh_dbs[MESH_SHARDS])):
        prof = profile_match(which, qs_np[0])
        log(f"phase 27 profile {label} (torch.profiler, 5 matches): a match makes "
            f"{prof['launches']:.0f} kernel launches, {prof['cpu_ms']:.3f} ms of ops on the "
            f"host (self CPU, profiled), {prof['device_ms']:.3f} ms of kernels on the card; "
            f"most device time: {prof['top']}")
    del mesh_dbs[1]
    torch.cuda.empty_cache()
    return mesh_dbs[MESH_SHARDS]


def run_mesh_server(mts, qs_np, want) -> None:
    """Phase 28: MatchServer over the D = 4 TwoStageDB: queries alone equal
    mts.match, then Poisson load where every answer equals its query's
    answer alone."""
    from hpfw_tpu_torch import MatchServer

    direct = [mts.match(q) for q in qs_np]
    rng = np.random.default_rng(3)
    start_path()
    with MatchServer(mts, qs_np.shape[1], **SERVE_KW) as srv:
        srv.warmup(qs_np[0])
        alone = [srv.match(q) for q in qs_np]
        check(same_results(alone, direct), "D=4 server: a query alone differs from ts.match")
        r = run_load(srv, qs_np, [w[0] for w in want], MESH_LOAD, rng, MESH_LOAD_QUERIES,
                     expect=alone)
    counts = end_path()
    check(all(counts.get(k, 0) > 0 for k in ("coarse_scan_batch_packed", "coarse_rescan",
                                              "fine_rescan")),
          f"D=4 server launches {counts}")
    log(f"phase 28 MatchServer over the D={MESH_SHARDS} DB: {len(alone)}/{len(alone)} "
        f"queries alone == ts.match; offered {MESH_LOAD:.0f} q/s ({r['n']} queries): every "
        f"answer == its query's alone, p50 {r['p50']:.3f} ms, p99 {r['p99']:.3f} ms, "
        f"achieved {r['achieved']:.1f} q/s, shed {r['shed']:.1%}, recall {r['recall']:.3f}; "
        f"launches {counts}")


def run_mesh_session(dev: torch.device, dense: dict, live_dense: dict) -> None:
    """Phase 29: phase 21's dense spec-scan session fed again over a D = 4
    ShardedDB of phase 4's DB: the same states and top tracks on every feed,
    the same top hits where the prints are equal, K3 4 times as often."""
    from hpfw_tpu_torch import ShardedDB, StreamingSession
    from hpfw_tpu_torch.parallel.mesh import Mesh

    sdb = ShardedDB(dense["db"], Mesh([dev] * MESH_SHARDS))
    sess = StreamingSession(sdb, dense["filters"], live_dense["cfg"], **live_dense["kw"])
    start_path()
    trace = drive_session(sess, live_dense["live"], live_dense["chunk"])
    counts = end_path()
    flat_counts = live_dense["counts"]
    same_prints = 0
    for a, b in zip(trace, live_dense["trace"]):
        check(a["state"] == b["state"] and a["matched"] == b["matched"]
              and (a["best"] is None) == (b["best"] is None)
              and (a["best"] is None or a["best"].track_id == b["best"].track_id),
              f"sharded session diverges: {a['state']} {a['best']} vs {b['state']} "
              f"{b['best']}")
        if a["matched"] and np.array_equal(a["window"], b["window"]) and (
                (a["stack"] is None and b["stack"] is None)
                or (a["stack"] is not None and b["stack"] is not None
                    and np.array_equal(a["stack"], b["stack"]))):
            same_prints += 1
            check(a["last"] == b["last"],
                  f"equal prints, different answers: {a['last']} vs {b['last']}")
    check(len(trace) == len(live_dense["trace"])
          and counts.get("score_tracks", 0) == MESH_SHARDS * flat_counts["score_tracks"]
          and all(counts.get(k) == flat_counts.get(k) for k in ("cqt", "fingerprint")),
          f"sharded session launches {counts} against the dense session's {flat_counts}")
    stack = next(r["stack"] for r in trace if r["matched"] and r["stack"] is not None)
    held: dict = {}
    with matcher_held_to_plain(held):
        for v in stack:
            sdb.match(v, top_k=2)
    check(len(held.get("score_tracks", ())) == MESH_SHARDS * len(stack),
          f"sharded session: held {({k: len(x) for k, x in held.items()})}")
    n_matches = sum(r["matched"] for r in trace)
    log(f"phase 29 StreamingSession over a D={MESH_SHARDS} ShardedDB of phase 4's DB, "
        f"phase 21's {DENSE_LIVE_SECONDS:.0f} s rendition: the same states and top tracks "
        f"on all {len(trace)} feeds as over the dense DB, the same top hits on the "
        f"{same_prints} of {n_matches} matches with equal prints; -> "
        f"{trace[-1]['best'].track_id}; {session_times(trace)}; launches {counts}; the "
        f"{len(stack)} variants of one scanned window, K3 == its plain version on every call")


def run_mesh_artists(dev: torch.device, adb, scaled, queries) -> None:
    """Phase 30: ArtistDB(scaled=True, mesh=) over phase 20's banks at D = 4:
    the scaled banks' answers, known and unknown artist, K4 and K5 4 times
    as often, each call of one match equal to its plain version."""
    from hpfw_tpu_torch import ArtistDB
    from hpfw_tpu_torch.parallel.mesh import Mesh

    sharded = ArtistDB(adb.cfg, adb.banks, scaled=True, stride=4,
                       mesh=Mesh([dev] * MESH_SHARDS), device=dev)
    asks = [(q, dict(artist=name)) for name, _, q in queries] + [(q, {}) for _, _, q in queries]
    start_path()
    want = [scaled.match(q, **kw) for q, kw in asks]
    flat = end_path()
    start_path()
    t0 = time.perf_counter()
    got = [sharded.match(q, **kw) for q, kw in asks]
    match_s = time.perf_counter() - t0
    counts = end_path()
    for (q, kw), g, w in zip(asks, got, want):
        check(same_answer(g, w), f"sharded artist match {kw}: {g[0][:3]} vs {w[0][:3]}")
    check(all(counts.get(k, 0) == MESH_SHARDS * flat.get(k, 0) > 0
              for k in ("coarse_scan", "fine_rescan")) and "cqt" in counts,
          f"sharded artist launches {counts} against the unsharded banks' {flat}")
    held: dict = {}
    with matcher_held_to_plain(held):
        sharded.match(queries[0][2])
    check({k: len(v) for k, v in held.items()} == {
        "coarse_scan": MESH_SHARDS * len(adb.artists),
        "fine_rescan": MESH_SHARDS * len(adb.artists)}, f"sharded artist: held {held}")
    log(f"phase 30 ArtistDB(scaled=True, mesh=D={MESH_SHARDS}) over phase 20's "
        f"{len(adb.artists)} banks: {len(asks)} matches (known and unknown artist) == the "
        f"unsharded scaled banks' (ids, scores, offsets) in {match_s:.2f} s; launches "
        f"{counts} (unsharded {flat}); an unknown-artist match's K4 and K5 == their plain "
        f"versions on every call")


# ---- phases 31-33: the CLI, the profiler and the device catalog synthesizer ----

CLI_LEARN_FILES, CLI_QUERIES, CLI_QUERY_SECONDS, CLI_POOL = 12, 8, 10.0, 8
CLI_ARTISTS, CLI_ARTIST_TRACKS = 4, 8
PROFILE_MATCHES = 5
SYNTH_TRACKS, SYNTH_SECONDS, SYNTH_BATCH, SYNTH_QUERIES = 2048, 60.0, 64, 20
SYNTH_COVER_SCOPE = 100
# tests/test_torch_synth_device.py's tolerance for a rendering against
# another (max |diff|, relative RMS), at its length of 6 s.
SYNTH_TOL, SYNTH_CHECK_SECONDS = (1e-2, 3e-3), 6.0


def cli_run(argv: list, times: dict, key: str | None = None) -> str:
    """hpfw_tpu_torch.cli.main(argv) in this process on the card: its
    standard output; fails unless it exits 0. Adds its host seconds to
    times[key or argv[0]]."""
    import io

    from hpfw_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    times[key or argv[0]] = times.get(key or argv[0], 0.0) + time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv[:2])}: exit code {rc}\n{buf.getvalue()}")
    return buf.getvalue()


def ranked_lines(out: str) -> list[tuple[str, int, int]]:
    """(id, score, offset) of each '#k id  score=S ... offset=O' line."""
    import re
    rows = []
    for ln in out.splitlines():
        m = re.match(r"#\d+ (\S+)  score=(\d+).*  offset=(\d+)", ln)
        if m:
            rows.append((m[1], int(m[2]), int(m[3])))
    return rows


def same_top(rows: list, ids, scores, offs) -> bool:
    return rows == [(str(i), int(s), int(o)) for i, s, o in zip(ids, scores, offs)]


def run_cli(dev: torch.device) -> None:
    """Phase 31: the CLI on the card at the default HpfwConfig()."""
    import tempfile
    from pathlib import Path

    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.artist import ArtistDB
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.io import ingest, synth, wav
    from hpfw_tpu_torch.match.scaled import TwoStageDB

    cfg = HpfwConfig()
    times: dict = {}
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    demo = subprocess.run([sys.executable, "-m", "hpfw_tpu_torch.cli", "demo"], cwd=root,
                          capture_output=True, text=True, timeout=600)
    times["demo (subprocess)"] = time.perf_counter() - t0
    check(demo.returncode == 0 and demo.stdout.rstrip().endswith("(OK)"),
          f"cli demo: exit code {demo.returncode}\n{demo.stdout}\n{demo.stderr[-2000:]}")
    build_dir = root / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        d = Path(tmp)
        paths = write_ingest_wavs(d / "files")
        pcms = ingest.load_files(paths, cfg)
        rng = np.random.default_rng(31)
        query_of = {}
        for k, f in enumerate(rng.choice(INGEST_FILES, CLI_QUERIES, replace=False)):
            start = float(rng.uniform(1.0, INGEST_SECONDS - CLI_QUERY_SECONDS - 1.0))
            q = synth.make_query(pcms[f], start, CLI_QUERY_SECONDS, cfg, noise_db=-12.0,
                                 seed=310 + k)
            query_of[str(d / f"q{k}.wav")] = paths[f]
            wav.save_wav(str(d / f"q{k}.wav"), q, cfg.sample_rate)
        adirs = []
        for a in range(CLI_ARTISTS):
            adirs.append(d / f"artist{a}")
            adirs[-1].mkdir()
        def write_artist_track(ai):
            a, i = ai
            pcm = synth.synth_artist_track(a, i, INGEST_SECONDS, cfg)
            wav.save_wav(str(adirs[a] / f"t{i}.wav"), pcm, cfg.sample_rate)
            return ai, pcm

        with ThreadPoolExecutor(8) as pool:
            art = dict(pool.map(write_artist_track,
                                [(a, i) for a in range(CLI_ARTISTS)
                                 for i in range(CLI_ARTIST_TRACKS)]))
        aq, ta, tt = str(d / "artist_q.wav"), CLI_ARTISTS // 2, CLI_ARTIST_TRACKS - 3
        a_truth, known = f"artist{ta}/t{tt}", f"artist{ta}"
        wav.save_wav(aq, synth.make_query(art[(ta, tt)], 4.0, ARTIST_QUERY_SECONDS, cfg,
                                          noise_db=-12.0, seed=311), cfg.sample_rate)
        setup_s = time.perf_counter() - t0 - times["demo (subprocess)"]

        start_path()
        out = cli_run(["artist-demo"], times)
        check(out.rstrip().endswith("OK"), f"cli artist-demo:\n{out}")
        sc = json.loads(cli_run(["selfcheck"], times))
        check(sc["backend"] == "cuda", f"cli selfcheck: {sc}")
        filters_npz, db_npz, cache = str(d / "filters.npz"), str(d / "db.npz"), str(d / "cache")
        db_cs_npz, cs_json = str(d / "db_cs.npz"), d / "catalog_scale.json"
        cs_json.write_text(HpfwConfig.catalog_scale().to_json())
        cli_run(["learn", *paths[:CLI_LEARN_FILES], "-o", filters_npz], times)
        cli_run(["build-db", *paths, "--filters", filters_npz, "-o", db_npz], times)
        # The same files under catalog_scale() (the same widths, the catalog
        # matcher's knobs) for the cache: 8 phases, a 2-lane 32-channel pass 1.
        cli_run(["build-db", *paths, "--filters", filters_npz, "-o", db_cs_npz,
                 "--config", str(cs_json)], times, "build-db --config catalog_scale")
        filters = np.load(filters_npz)["filters"]
        want = api.build_db_from_files(paths, filters, cfg, batch=8, device=dev)
        got = np.load(db_npz)
        check(list(got["track_ids"]) == want.track_ids
              and np.array_equal(got["lengths"], want.lengths)
              and np.array_equal(got["prints"], want.prints),
              "cli build-db: db.npz differs from api.build_db_from_files")
        one = paths[INGEST_QUERY]
        cli_run(["fingerprint", one, "--filters", filters_npz, "-o", str(d / "fp.npz")], times)
        cli_run(["fingerprint", one, "--filters", filters_npz, "--cpu",
                 "-o", str(d / "fp_cpu.npz")], times, "fingerprint --cpu")
        fp, fp_cpu = np.load(d / "fp.npz")["prints"], np.load(d / "fp_cpu.npz")["prints"]
        fp_bits = int(np.bitwise_count(fp ^ fp_cpu).sum())
        check(fp.shape == fp_cpu.shape and fp_bits <= fp.size * 32 * 1e-4,
              f"cli fingerprint: {fp_bits} of {fp.size * 32} bits differ from --cpu")
        cli_run(["build-cache", "--db", db_cs_npz, "-o", cache, "--prefilter-channels", "32"],
                times)
        db = api.FingerprintDB.load(db_npz, device=dev)
        ts_scaled = TwoStageDB(db)
        ts_cache = TwoStageDB.load(cache, device=dev)
        held: dict = {}
        for qp, truth in query_of.items():
            qfp = api.fingerprint(wav.load_wav(qp, cfg)[0], filters, cfg, device=dev)
            runs = [(["match", qp, "--db", db_npz], api.match(qfp, db, top_k=5)),
                    (["match", qp, "--db", db_npz, "--scaled"],
                     ts_scaled.match(qfp, top_k=5)),
                    (["match", qp, "--cache", cache], ts_cache.match(qfp, top_k=5))]
            for argv, answer in runs:
                key = " ".join(a for a in argv if a.startswith("--") and a != "--db")
                rows = ranked_lines(cli_run(argv, times, "match " + key))
                check(rows and rows[0][0] == truth and same_top(rows, *answer),
                      f"cli {' '.join(argv[:1] + argv[2:])} on {Path(qp).name}: {rows[:2]} "
                      f"vs the API's {answer[0][:2]}, truth {truth}")
        out = cli_run(["stream", paths[INGEST_QUERY], "--db", db_npz], times)
        check(f"final: {paths[INGEST_QUERY]} " in out, f"cli stream:\n{out}")
        out = cli_run(["pool", *paths[:CLI_POOL], "--db", db_npz], times)
        check(all(f"{p}: {p} " in out for p in paths[:CLI_POOL]), f"cli pool:\n{out}")
        adb_npz = str(d / "adb.npz")
        cli_run(["build-artist-db", *map(str, adirs), "-o", adb_npz], times)
        adb = ArtistDB.load(adb_npz, device=dev)
        apcm = wav.load_wav(aq, cfg)[0]
        for extra, answer in [([], adb.match(apcm, top_k=5)),
                              (["--artist", known], adb.match(apcm, artist=known, top_k=5))]:
            rows = ranked_lines(cli_run(["match-artist", aq, "--db", adb_npz, *extra], times,
                                        "match-artist " + " ".join(extra)))
            labels = ([f"{a}/{t}" for a, t in answer[0]] if not extra
                      else [f"{known}/{t}" for t in answer[0]])
            check(rows and rows[0][0] == a_truth
                  and rows == [(lb, int(s), int(o))
                               for lb, s, o in zip(labels, answer[1], answer[2])],
                  f"cli match-artist {extra}: {rows[:2]}, want {a_truth} first as the API")
        counts = end_path()
        # One `match --scaled` once more, in a pass of its own: its dispatches
        # eager and every K4/K5 call held to its plain version.
        qp, truth = next(iter(query_of.items()))
        with matcher_held_to_plain(held):
            rows = ranked_lines(cli_run(["match", qp, "--db", db_npz, "--scaled"], {}))
        check(rows and rows[0][0] == truth and set(held) == {"coarse_scan", "fine_rescan"},
              f"cli match --scaled held to the plain K4/K5: {rows[:2]}, truth {truth}, "
              f"held {held}")
    for k in ("cqt", "fingerprint", "score_tracks", "coarse_scan", "coarse_scan_batch",
              "coarse_rescan", "fine_rescan"):
        check(counts.get(k, 0) > 0, f"phase 31: {k} never launched: {counts}")
    log(f"phase 31 cli: demo (10 x 8 s, a subprocess) OK; artist-demo OK; selfcheck "
        f"{sc['differing_bits']}/{sc['total_bits']} bits on {sc['backend']}; over "
        f"{INGEST_FILES} x {INGEST_SECONDS:.0f} s WAVs: build-db == build_db_from_files; "
        f"fingerprint vs --cpu {fp_bits}/{fp.size * 32} bits; {CLI_QUERIES} noisy 10 s "
        f"queries first through match --db, --scaled and --cache (a catalog_scale() "
        f"DB's cache: 8 phases, 32-channel pass 1), each top 5 == the "
        f"API's; one --scaled match's K4/K5 == plain {held}; stream and pool of "
        f"{CLI_POOL} identified; match-artist known and unknown first; setup "
        f"{setup_s:.1f} s, whole phase {time.perf_counter() - t_phase:.1f} s; launches "
        f"{counts}")
    log("phase 31 cli host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))


def kernel_intervals(events: list) -> list[tuple[float, float]]:
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel")


def busy_share(intervals: list, lo: float, hi: float) -> float:
    """The union of the intervals clipped to [lo, hi], over hi - lo."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy / (hi - lo)


def run_profiler(ts, qs_np) -> None:
    """Phase 32: utils.profiling around PROFILE_MATCHES catalog_scale()
    TwoStageDB.match calls of phase 10's DB: trace.json holds the match
    scopes and K4's and K5's kernels; the device's busy share inside each
    scope (the union of kernel intervals over the scope's length)."""
    import tempfile
    from pathlib import Path

    from hpfw_tpu_torch.utils import profiling
    ts.match(qs_np[0])
    torch.cuda.synchronize()
    profiling.reset_scopes()
    build_dir = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=build_dir) as d:
        start_path()
        profiling.start_trace(d)
        for q in qs_np[:PROFILE_MATCHES]:
            with profiling.trace("match"):
                ts.match(q)
        profiling.stop_trace()
        counts = end_path()
        trace_path = Path(d) / "trace.json"
        size_mb = trace_path.stat().st_size / 1e6
        doc = json.loads(trace_path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    scopes = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == "match" and e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")
    check(len(scopes) == PROFILE_MATCHES, f"trace.json: {len(scopes)} match scopes")
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    names = Counter(e["name"].replace("void ", "").replace("(anonymous namespace)::", "")
                    .split("(")[0] for e in kernels)
    for want in ("coarse_kernel", "fine_kernel"):
        check(sum(c for n, c in names.items() if want in n) >= PROFILE_MATCHES,
              f"trace.json: fewer than {PROFILE_MATCHES} {want} events among {names}")
    check(all(counts.get(k) == PROFILE_MATCHES
              for k in ("coarse_scan_batch", "coarse_rescan", "fine_rescan")),
          f"phase 32 launches {counts}")
    ivals = kernel_intervals(events)
    shares = [busy_share(ivals, lo, hi) for lo, hi in scopes]
    stats = profiling.scope_stats()["match"]
    log(f"phase 32 profiler: {PROFILE_MATCHES} catalog_scale() matches traced "
        f"({size_mb:.1f} MB trace.json, {len(kernels)} kernel events, "
        f"{len(kernels) / PROFILE_MATCHES:.0f} a match); scope_stats {stats}; device busy "
        f"share inside each match scope {', '.join(f'{x:.3f}' for x in shares)} (mean "
        f"{statistics.mean(shares):.3f}); K4/K5 kernels "
        f"{ {n: c for n, c in names.items() if 'coarse_k' in n or 'fine_k' in n} }; launches "
        f"{counts}")


def run_synth_device(dev: torch.device, filters_np: np.ndarray) -> np.ndarray:
    """Phase 33: io/synth_device.py at catalog scale: SYNTH_TRACKS x 60 s
    rendered on the card in batches of SYNTH_BATCH, each batch fingerprinted
    on the card and only the prints kept; a FingerprintDB of them; noisy
    10 s query_batch excerpts ranked first; each cover in the first
    SYNTH_COVER_SCOPE tracks scoring its source above every unrelated
    track; a batch rendered on the card against the same call on the CPU.
    Returns the (SYNTH_TRACKS, N, 2) uint32 prints for phase 36."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.filters import filters_from_jax
    from hpfw_tpu_torch.io import synth_device as sd

    cfg = HpfwConfig()
    filt = filters_from_jax(filters_np, cfg, dev)
    t_phase = time.perf_counter()
    prints, render_s = [], 0.0
    start_path()
    for b0 in range(0, SYNTH_TRACKS, SYNTH_BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pcm = sd.synth_batch(np.arange(b0, b0 + SYNTH_BATCH), SYNTH_SECONDS, cfg, device=dev)
        torch.cuda.synchronize()
        render_s += time.perf_counter() - t0
        check(pcm.device == dev and pcm.shape == (SYNTH_BATCH, int(SYNTH_SECONDS * cfg.sample_rate)),
              f"synth_batch: {tuple(pcm.shape)} on {pcm.device}")
        prints.append(api.fingerprint_batch_device(pcm, filt, cfg).cpu())
        del pcm
    counts = end_path()
    build_s = time.perf_counter() - t_phase
    allp = torch.cat(prints).numpy().view(np.uint32)
    ids = [str(i) for i in range(SYNTH_TRACKS)]
    db = api.FingerprintDB(cfg, filters_np, ids, allp,
                           np.full(SYNTH_TRACKS, allp.shape[1], np.int32), device=dev)
    check(counts == {"cqt": SYNTH_TRACKS, "fingerprint": SYNTH_TRACKS},
          f"synth catalog launches {counts}")
    rng = np.random.default_rng(33)
    qids = rng.choice(SYNTH_TRACKS, SYNTH_QUERIES, replace=False)
    q_len = int(CLI_QUERY_SECONDS * cfg.sample_rate)
    starts = rng.integers(0, int(SYNTH_SECONDS * cfg.sample_rate) - q_len, SYNTH_QUERIES)
    qs = sd.query_batch(qids, starts, SYNTH_SECONDS, CLI_QUERY_SECONDS, cfg, noise_db=-12.0,
                        device=dev)
    qprints = api.fingerprint_batch_device(qs, filt, cfg).cpu().numpy().view(np.uint32)
    found = []
    for tid, start, qp in zip(qids, starts, qprints):
        top, scores, offs = api.match(qp, db, top_k=2)
        found.append(top[0] == str(tid))
        check(found[-1], f"synth query of track {tid} (start {start}): top {top}, "
              f"scores {scores}")
    sub = api.FingerprintDB(cfg, filters_np, ids[:SYNTH_COVER_SCOPE],
                            allp[:SYNTH_COVER_SCOPE], db.lengths[:SYNTH_COVER_SCOPE],
                            device=dev)
    margins = []
    for cov in range(SYNTH_COVER_SCOPE):
        src = sd.cover_source(cov)
        if src is None:
            continue
        rid, rs, _ = api.match(allp[cov, 200:200 + qprints.shape[1]], sub,
                               top_k=SYNTH_COVER_SCOPE)
        score = dict(zip(rid, (int(x) for x in rs)))
        unrelated = max(v for k, v in score.items() if k not in (str(cov), str(src)))
        margins.append(score[str(src)] - unrelated)
        check(margins[-1] > 0, f"cover {cov}: source {src} scores {score[str(src)]}, an "
              f"unrelated track {unrelated}")
    t_ids = np.arange(8) * 37
    on_card = sd.synth_batch(t_ids, SYNTH_CHECK_SECONDS, cfg, device=dev).cpu().numpy()
    on_cpu = sd.synth_batch(t_ids, SYNTH_CHECK_SECONDS, cfg, device="cpu").numpy()
    diff = on_card.astype(np.float64) - on_cpu
    max_abs = float(np.abs(diff).max())
    rel = float(np.sqrt(np.mean(diff ** 2) / np.mean(on_cpu.astype(np.float64) ** 2)))
    check(max_abs < SYNTH_TOL[0] and rel < SYNTH_TOL[1],
          f"synth_batch card vs CPU: max |diff| {max_abs}, relative RMS {rel}")
    log(f"phase 33 synth_device: {SYNTH_TRACKS} x {SYNTH_SECONDS:.0f} s rendered on the card "
        f"in batches of {SYNTH_BATCH} ({SYNTH_BATCH * int(SYNTH_SECONDS * cfg.sample_rate) * 4 / 1e6:.0f} MB a batch): "
        f"render {render_s:.2f} s = {SYNTH_TRACKS / render_s:.0f} tracks/s, render + "
        f"extraction {build_s:.2f} s = {SYNTH_TRACKS / build_s:.0f} tracks/s; "
        f"{sum(found)}/{SYNTH_QUERIES} noisy 10 s queries first; {len(margins)} covers "
        f"over their sources by {min(margins)}-{max(margins)} bits against the best "
        f"unrelated track; card vs CPU ({len(t_ids)} x {SYNTH_CHECK_SECONDS:.0f} s): "
        f"max |diff| {max_abs:.3g}, relative RMS {rel:.3g}; whole phase "
        f"{time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return allp


# ---- phases 34-36: the oracle audit, entry() and the warm-up of a fresh process ----

AUDIT_SEED, AUDIT_SECONDS = 300, (8.0, 15.0, 30.0)
ENTRY_REPS = 21
WARM_QUERY_PRINTS, WARM_BATCH, WARM_MATCHES, WARM_TURNS = 430, 16, 21, 2


def audit_line(name: str, got: dict, want: np.ndarray, margins: np.ndarray) -> str:
    """Hold each path's prints in got ({"kernels": ..., "plain": ...}, (N, 2)
    uint32) to the oracle's prints and margins by the margin audit and by
    position (fails the run on a print beyond its margin, on a degenerate
    audit, or on a differing bit whose own margin is not free); one line of
    their counts."""
    from hpfw_tpu_torch.oracle import audit
    parts = []
    for path, prints in got.items():
        c = audit.margin_audit_counts(prints, want, margins)
        check(c["over"] == 0 and not c["degenerate"] and c["off_free"] == 0,
              f"{name} {path}: {c} against the float64 oracle")
        parts.append(f"{path} {c['differing_bits']} differing / {c['free_bits']} free, "
                     f"{c['off_free']} off a free bit")
    return f"{name} ({want.shape[0]} prints): " + ", ".join(parts)


def run_oracle_audit(dev: torch.device, dense: dict) -> None:
    """Phase 34: the card's prints against the float64 oracle's margin audit,
    through K1 -> K2 and through the plain versions on the card: api.fingerprint
    of synthetic tracks of AUDIT_SECONDS and of phase 3's 240 s track, and
    K2 on the 32-print windows of phase 3 cut from the 240 s spectrum (the
    oracle recomputes the spectrum of those frames from their samples)."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.filters import filters_from_jax
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.ops import frontend
    from hpfw_tpu_torch.ops import fingerprint as fp_ops
    from hpfw_tpu_torch.oracle import audit

    cfg = HpfwConfig()
    filters_np = dense["filters"]
    t_phase = time.perf_counter()
    oracle_s = 0.0
    tracks = [(f"{s:.0f} s", synth.synth_track(AUDIT_SEED + int(s), s, cfg))
              for s in AUDIT_SECONDS] + [(f"{LONG_SECONDS:.0f} s", dense["long_pcm"])]
    lines = []
    for name, pcm in tracks:
        got = {"kernels": api.fingerprint(pcm, filters_np, cfg, device=dev)}
        with plain_versions():
            got["plain"] = api.fingerprint(pcm, filters_np, cfg, device=dev)
        t0 = time.perf_counter()
        want, margins = audit.oracle_prints_and_margins(pcm, filters_np, cfg)
        oracle_s += time.perf_counter() - t0
        lines.append(audit_line(name, got, want, margins))
    # K2 on 67-frame windows of the 240 s spectrum (K1's, and the plain
    # version's of the plain spectrum).
    long_pcm = dense["long_pcm"]
    frames = frontend.frame_signal(torch.from_numpy(long_pcm).to(dev), cfg)
    filt = filters_from_jax(filters_np, cfg, dev)
    spec_k = frontend.cqt_kernel(frames, cfg)
    spec_p = frontend.cqt_from_frames_ref(frames, cfg)
    w_frames = CHUNK_PRINTS + cfg.context_w - 1 + cfg.delta_lag
    for o in WINDOW_OFFSETS:
        got = {"kernels": fp_ops.encoder_kernel(spec_k[o:o + w_frames], filt, cfg),
               "plain": fp_ops.fingerprint_from_spec_ref(spec_p[o:o + w_frames], filt, cfg)}
        got = {k: v.cpu().numpy().view(np.uint32) for k, v in got.items()}
        seg = long_pcm[o * cfg.hop:(o + w_frames - 1) * cfg.hop + cfg.frame_len]
        t0 = time.perf_counter()
        want, margins = audit.oracle_prints_and_margins(seg, filters_np, cfg)
        oracle_s += time.perf_counter() - t0
        check(want.shape == (CHUNK_PRINTS, 2), f"window at frame {o}: oracle {want.shape}")
        lines.append(audit_line(f"window_32 at frame {o}", got, want, margins))
    log(f"phase 34 oracle audit (HpfwConfig(), float64 oracle, margin audit rel_tol 1e-4; "
        f"kernels = K1 -> K2, plain = the plain versions on the card): every print within "
        f"its margin, every differing bit on a free bit by position; oracle {oracle_s:.1f} s on the host, whole phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for ln in lines:
        log(f"phase 34 audit {ln}")


def run_entry() -> None:
    """Phase 35: graft_entry.entry() on the card, the main path's forward
    step (K1 -> K2 on a 10 s query): its launches, the margin audit of its
    prints, and its time by CUDA events (median of ENTRY_REPS)."""
    from hpfw_tpu_torch import graft_entry
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.oracle import audit

    forward, (pcm, filters) = graft_entry.entry()
    check(pcm.is_cuda and filters.is_cuda, f"entry() arguments on {pcm.device}")
    start_path()
    out = forward(pcm, filters)
    counts = end_path()
    check(counts == {"cqt": 1, "fingerprint": 1}, f"phase 35 launches {counts}")
    check(out.dtype == torch.int32 and tuple(out.shape) == (380, 2),
          f"entry() forward: {out.dtype} {tuple(out.shape)}")
    got = out.cpu().numpy().view(np.uint32)
    want, margins = audit.oracle_prints_and_margins(pcm.cpu().numpy(), filters.cpu().numpy(),
                                                    HpfwConfig())
    line = audit_line("entry()", {"kernels": got}, want, margins)
    times = []
    for _ in range(ENTRY_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        forward(pcm, filters)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    log(f"phase 35 entry(): forward(pcm {tuple(pcm.shape)}, filters {tuple(filters.shape)}) "
        f"-> {tuple(out.shape)} int32; launches {counts}; audit {line}; forward "
        f"{statistics.median(times):.4f} ms (median of {ENTRY_REPS}, CUDA events around "
        f"each call, min {min(times):.4f}, max {max(times):.4f})")


# Phase 36's fresh process: load the cache, warm up (mode "warm") or not,
# then time the first match and WARM_MATCHES more, and a match_batch; prints
# one JSON line.
WARMUP_WORKER = r"""
import json, statistics, sys, time
import numpy as np
import torch
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.ops import _build
d, mode, n, b, reps = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6])
qs = np.load(d + "/queries.npy")
t0 = time.perf_counter()
ts = TwoStageDB.load(d + "/cache")
torch.cuda.synchronize()
out = {"load_s": time.perf_counter() - t0, "warmup_s": None}
if mode == "warm":
    t0 = time.perf_counter()
    ts.warmup([n], batch_sizes=(b,))
    out["warmup_s"] = time.perf_counter() - t0
times, answers = [], []
for q in qs[:reps + 1]:
    t0 = time.perf_counter()
    ids, scores, offs = ts.match(q)
    times.append((time.perf_counter() - t0) * 1e3)
    answers.append([ids, scores.tolist(), offs.tolist()])
batch = [[i, s.tolist(), o.tolist()] for i, s, o in ts.match_batch(qs[:b])]
out.update(first_ms=times[0], median_ms=statistics.median(times[1:]), answers=answers,
           batch=batch, launches={k: v for k, v in _build.LAUNCHES.items() if v})
print(json.dumps(out))
"""


def run_warmup(prints: np.ndarray, filters_np: np.ndarray) -> None:
    """Phase 36: TwoStageDB.warmup in a fresh process. A catalog_scale()
    cache of phase 33's prints; then, in turns, processes that load it and
    warm up (warmup([430], batch_sizes=(16,))) or not, each timing its first
    match and the median of the next WARM_MATCHES by the host clock. Every
    process gives the same answers, the planted tracks first."""
    import tempfile
    from pathlib import Path

    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.match.scaled import TwoStageDB

    cfg = HpfwConfig.catalog_scale()
    t_phase = time.perf_counter()
    n_tracks = prints.shape[0]
    db = api.FingerprintDB(cfg, filters_np, [str(i) for i in range(n_tracks)], prints,
                           np.full(n_tracks, prints.shape[1], np.int32), device="cuda")
    ts = TwoStageDB(db)
    rng = np.random.default_rng(36)
    truth = rng.choice(n_tracks, WARM_MATCHES + 1, replace=False)
    starts = rng.integers(0, prints.shape[1] - WARM_QUERY_PRINTS, truth.shape[0])
    qs = np.stack([noisy_excerpt(rng, prints[t], s, WARM_QUERY_PRINTS)
                   for t, s in zip(truth, starts)])
    root = Path(__file__).resolve().parent
    runs = []
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        ts.save(str(Path(d) / "cache"))
        cache_mb = sum(f.stat().st_size for f in (Path(d) / "cache").iterdir()) / 1e6
        np.save(Path(d) / "queries.npy", qs)
        for _ in range(WARM_TURNS):
            for mode in ("warm", "cold"):
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-c", WARMUP_WORKER, d, mode, str(WARM_QUERY_PRINTS),
                     str(WARM_BATCH), str(WARM_MATCHES)],
                    cwd=root, capture_output=True, text=True, timeout=300)
                check(proc.returncode == 0, f"phase 36 {mode} process: exit code "
                      f"{proc.returncode}\n{proc.stderr[-3000:]}")
                r = json.loads(proc.stdout.strip().splitlines()[-1])
                r.update(mode=mode, process_s=time.perf_counter() - t0)
                runs.append(r)
    for r in runs:
        check(r["answers"] == runs[0]["answers"] and r["batch"] == runs[0]["batch"],
              f"phase 36: a {r['mode']} process answers otherwise than the first")
        check(all(r["launches"].get(k) for k in ("coarse_scan_batch", "coarse_rescan",
                                                 "fine_rescan")),
              f"phase 36 {r['mode']} process launches {r['launches']}")
        PATH_LAUNCHES.update(r["launches"])
    first = runs[0]["answers"]
    check(all(a[0][0] == str(t) for a, t in zip(first, truth)),
          f"phase 36: planted tracks {truth.tolist()}, first answers {[a[0][0] for a in first]}")
    check(all(a[0][0] == str(t) for a, t in zip(runs[0]["batch"], truth)),
          "phase 36: match_batch misses a planted track")

    def fmt(r):
        w = f"warmup {r['warmup_s']:.3f} s, " if r["warmup_s"] is not None else ""
        return (f"{r['mode']}: load {r['load_s']:.3f} s, {w}first match {r['first_ms']:.2f} ms, "
                f"median of the next {WARM_MATCHES} {r['median_ms']:.2f} ms "
                f"(process {r['process_s']:.1f} s)")

    log(f"phase 36 warmup: catalog_scale() cache of {n_tracks} x {prints.shape[1]} prints "
        f"({cache_mb:.0f} MB); {len(runs)} fresh processes in "
        f"turns, queries of {WARM_QUERY_PRINTS} prints with {CFG4_FLIP:.0%} of bits flipped: "
        f"every process gives the same {WARM_MATCHES + 1} match and {WARM_BATCH}-query "
        f"match_batch answers, each planted track first; whole phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for r in runs:
        log(f"phase 36 {fmt(r)}; launches {r['launches']}  (host clock)")


if __name__ == "__main__":
    main()
