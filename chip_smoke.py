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
     latency and the batch-of-8 queries per second.
The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}. Imports nothing of jax or hpfw_tpu.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from hpfw_tpu_torch.ops import dot
    check(dot.tf32_disabled(), "TF32 is enabled for float32 products")
    log(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | tf32 off")
    return card


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
    card = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    kernels = run(card, dev)
    kernels += run_catalog(card, dev)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run(card: str, dev: torch.device) -> list[dict]:
    """Phases 3-7 on dev, once the card is checked and the kernels built.
    Returns the per-kernel results of K1-K3."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.filters import filters_from_jax, fix_eigenvector_signs
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.match import matcher
    from hpfw_tpu_torch.ops import _build, frontend
    from hpfw_tpu_torch.ops import fingerprint as fp_ops

    cfg = HpfwConfig()
    rng = np.random.default_rng(0)
    filters_np = fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    ).astype(np.float32)
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
    _build.reset_launch_counts()
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
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
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
    check(all(launches[k] > 0 for k in ("cqt", "fingerprint", "score_tracks")),
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
            f"{measured[name][1]:.4f} ms  [{card}]")

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
        f"{audio_s / (plain_ms / 1e3):.1f}x realtime  [{card}]")

    lat = []
    for _ in range(21):
        t0 = time.perf_counter()
        qp = api.fingerprint(q_pcm, filt, cfg)
        api.match(qp, db, top_k=5)
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 7 config-1 query latency (fingerprint 10 s + match 100 tracks, host "
        f"clock): median {statistics.median(lat):.3f} ms, min {min(lat):.3f} ms, "
        f"max {max(lat):.3f} ms over {len(lat)}  [{card}]")

    kernels = [
        {"name": "cqt_filterbank", "route": "cuda",
         "source": "hpfw_tpu_torch/csrc/frontend.cu",
         "replaces": "hpfw_tpu/ops/pallas_frontend.py:68",
         "launches": launches["cqt"], "max_abs_err": k1_err,
         "ms": measured["K1 query_10s"][0], "plain_ms": measured["K1 query_10s"][1]},
        {"name": "hashprint_encoder", "route": "cuda",
         "source": "hpfw_tpu_torch/csrc/fingerprint.cu",
         "replaces": "hpfw_tpu/ops/pallas_fingerprint.py:63",
         "launches": launches["fingerprint"], "max_abs_err": k2_err,
         "differing_bits": k2_bits,
         "ms": measured["K2 query_10s"][0], "plain_ms": measured["K2 query_10s"][1]},
        {"name": "hamming_scan", "route": "cuda",
         "source": "hpfw_tpu_torch/csrc/match.cu",
         "replaces": "hpfw_tpu/ops/pallas_match.py:41",
         "launches": launches["score_tracks"], "max_abs_err": k3_err,
         "ms": measured["K3 config1_db"][0], "plain_ms": measured["K3 config1_db"][1]},
    ]
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


def run_catalog(card: str, dev: torch.device) -> list[dict]:
    """Phases 8-12: BASELINE config 4 through TwoStageDB, under HpfwConfig()
    and HpfwConfig.catalog_scale(). Returns the per-kernel results of K4, K5."""
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.match import matcher
    from hpfw_tpu_torch.match.scaled import TwoStageDB, _phase_variants
    from hpfw_tpu_torch.ops import _build, coarse_scan, fine

    # ---- phase 8: the config-4 catalog and its planted queries ----
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
    log(f"phase 8 catalog: {CFG4_TRACKS} x {n_prints} prints ({prints.nbytes / 1e9:.2f} GB), "
        f"{CFG4_QUERIES} noisy {n_q}-print queries ({CFG4_FLIP:.0%} of bits flipped) in "
        f"{time.perf_counter() - t0:.1f} s")

    measured, errs, launches = {}, {}, {}
    for name, (cfg, offs) in runs.items():
        t0 = time.perf_counter()
        db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32), ids,
                               prints, lengths, device=dev)
        ts = TwoStageDB(db)
        torch.cuda.synchronize()
        qs_np = queries[name]
        qs = torch.from_numpy(qs_np.view(np.int32)).to(dev)
        gib = sum(x.numel() * x.element_size() for x in {id(t): t for t in (
            ts.prints, ts.db_c, ts.db_c1)}.values()) / 2 ** 30
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
        checks = {}
        if name == "default":
            qc = _phase_variants(qs[:1], stride=ts.stride, phases=1, kind=ts.coarse_kind,
                                 channels=ts.coarse_channels)[0][0, 0]
            checks["coarse_scan"] = (
                f"{KERNEL_ROWS} rows x {ts.lc_true} windows x {ts.coarse_channels} "
                f"channels, one {qc.shape[0]}-window query",
                lambda: coarse_scan.coarse_scan_kernel(qc, rows, lc_true=ts.lc_true),
                lambda: coarse_scan.coarse_scan_ref(qc, rows, lc_true=ts.lc_true))
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
            past = int(((f_starts + n_fine - 1) > (f_lens[f_tracks.long()] - n_q)).sum())
            checks["fine_rescan"] = (
                f"{FINE_QUERIES} queries x {FINE_CANDIDATES} candidates, band {n_fine}, "
                f"{past} bands past max(len - N, 0)",
                lambda: fine.fine_rescan_kernel(*f_args, n_fine=n_fine),
                lambda: fine.fine_rescan_ref(*f_args, n_fine=n_fine))
        else:
            rows1 = ts.db_c1[:KERNEL_ROWS]
            q1 = _phase_variants(qs[:8], stride=ts.stride, phases=ts.prefilter_phases,
                                 kind=ts.coarse_kind, channels=ts.prefilter_channels)[0]
            q1 = q1.reshape(-1, *q1.shape[2:])
            checks["coarse_scan_batch"] = (
                f"{KERNEL_ROWS} rows x {ts.lc_true} windows x {ts.prefilter_channels} "
                f"channels, {q1.shape[0]} lanes (8 queries x {ts.prefilter_phases} phases)",
                lambda: coarse_scan.coarse_scan_batch_kernel(q1, rows1, lc_true=ts.lc_true),
                lambda: coarse_scan.coarse_scan_batch_ref(q1, rows1, lc_true=ts.lc_true))
            q2 = _phase_variants(qs[:2], stride=ts.stride, phases=ts.query_phases,
                                 kind=ts.coarse_kind, channels=ts.coarse_channels)[0]
            pooled = torch.stack([torch.randperm(CFG4_TRACKS, device=dev)[:KERNEL_ROWS]
                                  for _ in range(2)]).sort(dim=1).values.to(torch.int32)
            checks["coarse_rescan"] = (
                f"2 queries x {ts.query_phases} variants over {KERNEL_ROWS} pooled rows each",
                lambda: coarse_scan.coarse_rescan_kernel(q2, ts.db_c, pooled,
                                                         lc_true=ts.lc_true),
                lambda: coarse_scan.coarse_rescan_ref(q2, ts.db_c, pooled,
                                                      lc_true=ts.lc_true))
        for kname, (shape, kern, plain) in checks.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = max(int((got[0] - ref[0]).abs().max()), int((got[1] - ref[1]).abs().max()))
            check(err == 0, f"{kname}: kernel differs from its plain version by {err}")
            errs[kname] = err
            log(f"phase 9 {name} {kname}: {shape}: equal to the plain version")

        # ---- phase 10: the slice ----
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        single = [ts.match(q, top_k=10) for q in qs_np]
        batched, at = [], 0
        for b in CFG4_BATCHES:
            batched += ts.match_batch(qs_np[at:at + b], top_k=10)
            at += b
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
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
        check(all(counts[k] > 0 for k in used),
              f"phase 10 {name} launches {counts}: a kernel of the path never ran")
        for k in ("coarse_scan", "coarse_scan_batch", "coarse_rescan", "fine_rescan"):
            launches[k] = launches.get(k, 0) + counts[k]
        log(f"phase 11 {name} launches during phase 10: {counts}")

        # ---- phase 12: times ----
        for kname, (shape, kern, plain) in checks.items():
            measured[kname] = timed_pair(kern, plain)
            log(f"phase 12 time {name} {kname} ({shape}): kernel {measured[kname][0]:.4f} "
                f"ms, plain {measured[kname][1]:.4f} ms  [{card}]")
        lat = []
        for i in range(21):
            t1 = time.perf_counter()
            ts.match(qs_np[i % CFG4_QUERIES], top_k=10)
            lat.append((time.perf_counter() - t1) * 1e3)
        bat = []
        for _ in range(5):
            t1 = time.perf_counter()
            ts.match_batch(qs_np[:8], top_k=10)
            bat.append(time.perf_counter() - t1)
        log(f"phase 12 {name} match latency (host clock, {CFG4_TRACKS} tracks): median "
            f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms, max {max(lat):.3f} ms "
            f"over {len(lat)}; match_batch B=8: median {statistics.median(bat) * 1e3:.3f} ms "
            f"= {8 / statistics.median(bat):.1f} queries/s over {len(bat)}  [{card}]")
        del ts, db, qs, rows, checks
        torch.cuda.empty_cache()

    check(all(launches[k] > 0 for k in launches), f"catalog launches {launches}")
    source = "hpfw_tpu_torch/csrc/coarse.cu"
    replaces = {"coarse_scan": "hpfw_tpu/ops/pallas_coarse.py:82",
                "coarse_scan_batch": "hpfw_tpu/ops/pallas_coarse.py:201",
                "coarse_rescan": "hpfw_tpu/ops/pallas_coarse.py:201",
                "fine_rescan": "hpfw_tpu/ops/pallas_fine.py:83"}
    return [{"name": k, "route": "cuda",
             "source": source if k != "fine_rescan" else "hpfw_tpu_torch/csrc/fine.cu",
             "replaces": replaces[k], "launches": launches[k], "max_abs_err": errs[k],
             "ms": measured[k][0], "plain_ms": measured[k][1]} for k in replaces]


if __name__ == "__main__":
    main()
