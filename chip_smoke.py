#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printing its own line; any failure raises and exits non-zero:
  1. device check: a CUDA card, its name and power limit (nvidia-smi), and
     TF32 off for float32 products;
  2. build the three CUDA kernels from hpfw_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, at main-path
     shapes of the default config;
  4. the slice (BASELINE config 1): a 100-track DB of 20 s synthetic tracks
     built through api.build_db on the card, a noisy 10 s query identified
     at the right offset, and an exact excerpt scoring 64*N;
  5. a dense scan of a planted 1,000 x 7,701-print catalog;
  6. every kernel launched during phase 4, by the launch counters;
  7. times of each kernel and its plain version, the 16 x 240 s extraction
     realtime factor, and the config-1 query latency;
  8. the catalog of BASELINE config 4 at benchmarks/config4_scale.py's own
     defaults: 100,000 random tracks x 60 s, 20 planted noisy 10 s queries;
then, for each of HpfwConfig() (phase-aligned plants) and
HpfwConfig.catalog_scale() (misphased plants), on a TwoStageDB on the card:
  9. K4 (csrc/coarse.cu) at its surfaces and K5 (csrc/fine.cu) against their
     plain versions at the catalog's shapes, exactly equal;
 10. the slice: TwoStageDB.match on each query and match_batch in batches of
     8, 8 and 4; every query ranks its planted track first at the (score,
     offset) of K3's dense scan of that track, and batched equals single;
 11. the kernels launched during phase 10, by the launch counters;
 12. times of K4, K5 and their plain versions, the single-query match
     latency and the batch-of-8 queries per second;
then, on the catalog_scale() catalog, whose rows also hold 16 synthetic
60 s stream tracks extracted on the card in phase 8:
 13. the pass-1 DB nibble-packed (5,248 -> 2,688 B a row): packed K4 equal to
     its plain version and to int8 K4 on 8,192 rows x 16 lanes; the HBM
     load-floor probe (csrc/probe.cu) equal to torch.sum over the coarse DB
     and the packed pass-1 DB, and its GB/s;
 14. TwoStageDB(prefilter_pack4=True): all 20 queries through match and
     match_batch identical to phase 10's int8 DB, pass 1 only on packed K4;
 15. MatchServer over it under Poisson load (benchmarks/config4_serve.py's
     settings): single queries equal ts.match, p50/p99, achieved q/s, shed
     share and recall at 100-800 offered q/s, and the knee;
 16. StreamingPool at B = 8 and 16 (benchmarks/config3_pool.py's protocol):
     every stream identifies its planted track; tick ms and streams a card;
 17. StreamingSession (rigid) on one 30 s stream; match and step p50/p99.
Each path (phases 4, 10, 14, 15, 16, 17) runs with the launch counters set
to 0 just before it and read just after; comparison and timing launches are
not counted. The last two lines are a JSON object of per-kernel results
(time, plain and library time, bound) and {"ok": true, "device": {...}}.
Imports nothing of jax or hpfw_tpu.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

CFG1_TRACKS, CFG1_SECONDS = 100, 20.0      # BASELINE config 1 catalog
QUERY_TRACK, QUERY_START_S, QUERY_SECONDS = 42, 3.0, 10.0
EXCERPT_TRACK, EXCERPT_PRINT = 7, 50
LONG_SECONDS = 240.0                        # bench.py's track length
BATCH = 16                                  # bench.py's batch
CAT_TRACKS, CAT_PRINTS, CAT_QUERY = 1000, 7701, 380   # 180 s tracks, 10 s query
CAT_PLANT_TRACK, CAT_PLANT_OFFSET = 617, 4321
CAT_COMPARE = 64
# BASELINE config 4, benchmarks/config4_scale.py:49 defaults.
CFG4_TRACKS, CFG4_SECONDS, CFG4_QUERY_SECONDS, CFG4_QUERIES = 100_000, 60, 10, 20
CFG4_FLIP = 0.15
CFG4_BATCHES = (8, 8, 4)
KERNEL_ROWS = 8192          # K4 rows scanned, and pooled rows a query for the rescan
FINE_QUERIES, FINE_CANDIDATES = 8, 1024
# Serving (benchmarks/config4_serve.py) and streaming (benchmarks/config3_pool.py).
SERVE_LOADS = (100.0, 200.0, 400.0, 800.0)
SERVE_KW = dict(max_batch=16, max_wait_ms=4.0, depth=2, max_queue=64)
STREAMS, STREAM_SECONDS, STREAM_SEED = 16, 60.0, 7000
POOL_SIZES, CHUNK_PRINTS, QUERY_PRINTS = (8, 16), 32, 128
POOL_WARM_TICKS, POOL_TICKS = QUERY_PRINTS // CHUNK_PRINTS + 3, 30
SESSION_SECONDS = 30.0

# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet, dense
# rates at the full 700 W): bytes over the memory rate, operations over the
# rate of the unit the TPU kernel's work maps to. int32 is 64 INT32 lanes an
# SM (Hopper white paper) x 132 SMs x 1.98 GHz, the clock behind the data
# sheet's 67 TFLOP/s float32.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8_tensor": 1979e12, "bf16_tensor": 989e12, "int32": 132 * 64 * 1.98e9}
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
# 14-17), each read right after its run.
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
    from hpfw_tpu_torch.filters import fix_eigenvector_signs
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


def cuda_ms(fn, min_total_ms: float = 200.0, max_reps: int = 50) -> float:
    """Mean device time of fn() in ms, by CUDA events after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = int(min(max_reps, max(1, min_total_ms // once)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def differing_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    x = (a ^ b).cpu().numpy().view(np.uint32)
    return int(np.bitwise_count(x).sum())


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
    kernels = run(dev)
    kernels += run_catalog(dev)
    for k in kernels:
        k["launches"] = PATH_LAUNCHES[k.pop("counter")]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on a main path: {dict(PATH_LAUNCHES)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run(dev: torch.device) -> list[dict]:
    """Phases 3-7 on dev, once the card is checked and the kernels built.
    Returns the per-kernel results of K1-K3."""
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
    sk, ok_ = matcher.score_tracks_kernel(cat_qt, cat_p[:CAT_COMPARE], cat_l[:CAT_COMPARE])
    sr, or_ = matcher.score_tracks_ref(cat_qt, cat_p[:CAT_COMPARE], cat_l[:CAT_COMPARE])
    cat_err = max(int((sk - sr).abs().max()), int((ok_ - or_).abs().max()))
    check(cat_err == 0,
          "planted catalog: K3 differs from the plain scan on the first tracks")
    k3_err = max(k3_err, cat_err)
    log(f"phase 5 catalog: {CAT_TRACKS} x {CAT_PRINTS} prints "
        f"({cat.nbytes / 1e6:.0f} MB), query {CAT_QUERY}: {c_ids[0]} @ "
        f"{int(c_offs[0])} score {int(c_scores[0])} (#2 {int(c_scores[1])}); "
        f"K3 = plain on the first {CAT_COMPARE} tracks")

    # ---- phase 6: the main path went through every kernel ----
    check(all(launches.get(k, 0) > 0 for k in ("cqt", "fingerprint", "score_tracks")),
          f"phase 4 launches {launches}: a kernel of the path never ran")
    torch.cuda.synchronize()
    log(f"phase 6 launches during phase 4: {launches}")

    # ---- phase 7: times on the card ----
    q_frames, q_spec = specs["query_10s"]
    l_frames, l_spec = specs["track_240s"]
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

    del cat_db, cat_p, cat_l
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
    n_frames = q_frames.shape[0]
    k1_bound = bound(4 * len(q_pcm) + nbytes(kmat) + 4 * n_frames * cfg.n_bins,
                     X6_PASSES * 2 * n_frames * cfg.frame_len * kmat.shape[1], "bf16_tensor")
    k1_lib = cuda_ms(lambda: torch.matmul(q_frames, kmat))
    m_rows = q_spec.shape[0] - cfg.context_w + 1
    k2_bound = bound(nbytes(q_spec, filt) + 8 * (m_rows - cfg.delta_lag),
                     X6_PASSES * 2 * m_rows * cfg.context_dim * cfg.n_filters, "bf16_tensor")
    valid = (db_l.to(torch.int64) - q_dev.shape[0]).clamp(min=0) + 1
    k3_bound = bound(nbytes(q_dev, db_p, db_l) + 8 * db_p.shape[0],
                     int(valid.sum()) * q_dev.shape[0] * 2 * WORD_OPS, "int32")
    log(f"phase 7 library: torch.matmul of K1's query_10s operands {k1_lib:.4f} ms "
        f"(TF32 off)")
    log(f"phase 7 bounds: K1 query_10s {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 query_10s "
        f"{k2_bound[0]:.4f} ms ({k2_bound[1]}), K3 config1_db {k3_bound[0]:.4f} ms "
        f"({k3_bound[1]})")
    rows = (("cqt_filterbank", "cqt", "frontend.cu", "pallas_frontend.py:68", k1_err,
             "K1 query_10s", k1_bound, k1_lib),
            ("hashprint_encoder", "fingerprint", "fingerprint.cu", "pallas_fingerprint.py:63",
             k2_err, "K2 query_10s", k2_bound, None),
            ("hamming_scan", "score_tracks", "match.cu", "pallas_match.py:41", k3_err,
             "K3 config1_db", k3_bound, None))
    kernels = []
    for name, counter, src, tpu, err, timed, (b_ms, b_by), lib in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": f"hpfw_tpu_torch/csrc/{src}",
            "replaces": f"hpfw_tpu/ops/{tpu}", "counter": counter,
            "max_abs_err": err, "ms": measured[timed][0], "plain_ms": measured[timed][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        if name == "hashprint_encoder":
            kernels[-1]["differing_bits"] = k2_bits
    return kernels


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


def run_catalog(dev: torch.device) -> list[dict]:
    """Phases 8-17: BASELINE config 4 through TwoStageDB, under HpfwConfig()
    and HpfwConfig.catalog_scale(), then the packed pass 1, the server and
    the streaming surfaces on the catalog_scale() catalog. Returns the
    per-kernel results of K4 (int8 and packed), K5 and the probe."""
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
            # min(N, len) prints; the band's prints read once.
            n_valid = (max_o - f_starts + 1).clamp(0, n_fine)
            fine_ops = int((n_valid * cand_len.clamp(max=n_q)).sum()) * 2 * WORD_OPS
            checks["fine_rescan"] = (
                f"{FINE_QUERIES} queries x {FINE_CANDIDATES} candidates, band {n_fine}, "
                f"{past} bands past max(len - N, 0)",
                lambda: fine.fine_rescan_kernel(*f_args, n_fine=n_fine),
                lambda: fine.fine_rescan_ref(*f_args, n_fine=n_fine),
                bound(8 * f_tracks.numel() * span + nbytes(qs[:FINE_QUERIES]) +
                      4 * f_tracks.numel() * 4, fine_ops, "int32"))
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
    source = {"fine_rescan": "fine.cu", "row_sum": "probe.cu"}
    replaces = {"coarse_scan": "hpfw_tpu/ops/pallas_coarse.py:82",
                "coarse_scan_batch": "hpfw_tpu/ops/pallas_coarse.py:201",
                "coarse_scan_batch_packed": "hpfw_tpu/ops/pallas_coarse.py:223",
                "coarse_rescan": "hpfw_tpu/ops/pallas_coarse.py:201",
                "fine_rescan": "hpfw_tpu/ops/pallas_fine.py:83",
                "row_sum": "benchmarks/pass1_tune.py:97"}
    return [dict({"name": k, "route": "cuda",
                  "source": "hpfw_tpu_torch/csrc/" + source.get(k, "coarse.cu"),
                  "replaces": replaces[k], "counter": k}, **kernels[k]) for k in replaces]


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
    log(f"phase 13 coarse_scan_batch_packed: {shape}: equal to its plain version and to "
        f"int8 K4 on the unpacked rows")
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
            "row_sum": {"max_abs_err": probe_err, "ms": kt, "plain_ms": pt, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib}}


def run_load(srv, queries, truths, lam, rng, n_queries) -> dict:
    """Submit n_queries with exponential gaps at lam queries/s (as
    benchmarks/config4_serve.py does) and wait for every answer. A future that
    fails for another reason than ServerSaturated fails the run."""
    from hpfw_tpu_torch import ServerSaturated

    lat, ok, shed, errors = [], [0], [0], []
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


if __name__ == "__main__":
    main()
