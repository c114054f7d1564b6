"""Live song ID: an open loop of PCM queries into EscalatingMatchServer.

Arrivals are a Poisson process at the workload's rate_qps, fixed by its
schedule_seed, so every seed offers the same arrivals; the seed picks the
catalog, the queries and their order. A request is timed from when it was
due to when its answer resolved, so a stall delays every request due
during it. Requests due in the window are answered up to a minute after it.

The comparison: a sample of the answered requests, drawn from the seed, half
of them escalated where there are enough, is answered again by the plain
reference (extraction, two-stage match, escalation). For each, at = the
reference's exact score of the served track at the served offset, from its
own prints of the query (for an escalated answer, of the scan's variant
whose score there is nearest the served score: the answer says which track
and place, not which variant). score_gap is the largest over the sample, over 64 n bits, of
|served top score - at|, and, where the reference's answer is the query's
own planted track, of (reference top score - at). An answer the reference
does not identify is the best of a pool of imposters, and which imposters
are pooled moves with a single bit of the query's prints, so its served
score is held to the exact score of what was served, not to the
reference's pick. escalation_mismatches counts the sampled requests whose
served escalation flag differs from the reference's decision, leaving out
those whose rigid top two scores lie within the score_gap limit (in bits)
of a bar of the gate, where one bit of the prints may tip it.

The control: the reference with every float32 product in TF32 (the
configuration states float32 prints) in the program's place, on
check_requests queries of the cell's pool (half renditions where the pool
has them), compared as a run compares.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch

from .. import catalog, stats
from ..reference import extract, matcher, serve

WAIT_AFTER_S = 60.0


def setup(run) -> None:
    from hpfw_tpu_torch import EscalatingMatchServer

    c = run.config
    cat = catalog.build(run)
    ts = catalog.two_stage(run, cat)
    pcm, rows, _ = catalog.live_queries(run, cat)
    srv = EscalatingMatchServer(ts, cat["filters"], pcm.shape[1], **c["server"])
    srv.warmup(pcm[0])
    # One burst through the whole path (rank workers, callbacks, a scan).
    for f in [srv.submit(x) for x in pcm[:c["server"]["max_batch"]]]:
        f.result(timeout=WAIT_AFTER_S)
    run.state.update(catalog=cat, server=srv, ts=ts, pcm=pcm, rows=rows)


def window(run) -> None:
    from hpfw_tpu_torch import ServerSaturated

    w, srv, pcm = run.workload, run.state["server"], run.state["pcm"]
    gaps = np.random.default_rng(w["schedule_seed"]).exponential(
        1.0 / w["rate_qps"], int(w["rate_qps"] * run.seconds * 2) + 64)
    due = np.cumsum(gaps)
    due = due[due < run.seconds]
    order = np.random.default_rng(run.seed).permutation(len(pcm))
    n = len(due)
    done: list = [None] * n
    result: list = [None] * n
    error: dict = {}
    late = [0.0]
    lock = threading.Lock()
    left = [n]
    all_done = threading.Event()

    def callback(i):
        def cb(fut):
            t = time.perf_counter()
            exc = fut.exception()
            with lock:
                if exc is None:
                    done[i], result[i] = t, fut.result()
                else:
                    error[i] = exc
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()
        return cb

    stats0 = dict(srv.stats)
    t0 = run.window_starts()
    for i in range(n):
        delay = t0 + due[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        else:
            late[0] = max(late[0], -delay)
        srv.submit(pcm[order[i % len(pcm)]]).add_done_callback(callback(i))
    close = t0 + run.seconds
    if close > time.perf_counter():
        time.sleep(close - time.perf_counter())
    all_done.wait(timeout=WAIT_AFTER_S)
    closed = time.perf_counter()
    shed = sum(isinstance(e, ServerSaturated) for e in error.values())
    run.records.update(
        due=due.tolist(), attempted=n, failed=n - sum(d is not None for d in done), shed=shed,
        errors=[repr(e) for e in error.values() if not isinstance(e, ServerSaturated)],
        unanswered=left[0], latencies=stats.request_latencies(
            [t0 + u for u in due], done, closed),
        answered_in_window=sum(d is not None and d <= close for d in done),
        generator_late_s=late[0], results=result, picks=[int(order[i % len(pcm)])
                                                         for i in range(n)],
        stats={k: v - stats0[k] for k, v in srv.stats.items()})
    run.records["escalated"] = run.records["stats"]["escalated"]


def release(run) -> None:
    run.state["server"].close()
    for key in ("server", "ts"):
        del run.state[key]


def sample(run) -> list[int]:
    """The answered requests to compare, drawn from the seed: half escalated
    where there are enough."""
    res = run.records["results"]
    answered = [i for i, x in enumerate(res) if x is not None]
    rng = np.random.default_rng(run.seed + 1)
    m = run.workload["check_requests"]
    take = list(rng.permutation([i for i in answered if res[i][3]])[:m // 2])
    return take + list(rng.permutation([i for i in answered if not res[i][3]])[:m - len(take)])


def reference(run, clips: list, tf32: bool = False) -> list:
    """The plain reference's answers to PCM clips (float32, or TF32: the control)."""
    c, dev = run.config, run.device
    p = c["hpfw"]
    with extract.matmul_precision(tf32):
        return serve.answers(catalog.reference(run), [torch.from_numpy(x).to(dev) for x in clips],
                             run.state["catalog"]["filters"], p, c["server"], c["n_tracks"])


def gaps(run, served: list, want: list, planted) -> list[float]:
    """Each served answer's (ids, scores, offsets, escalated) score gap to
    the reference's answer, over 64 n bits; planted: each query's own row."""
    cat, dev = catalog.reference(run), run.device
    out = []
    for (ids, scores, offs, esc, *_), ref, own in zip(served, want, planted):
        v = len(ref[4])
        variants = ref[4] if esc else ref[4][v // 2:v // 2 + 1]
        t = torch.tensor([int(ids[0])], device=dev)
        o = torch.tensor([[int(offs[0])]], device=dev)
        exact = torch.stack([matcher.similarity(x, cat.prints, cat.lengths, t, o)[0, 0]
                             for x in variants])
        at = int(exact[(exact - int(scores[0])).abs().argmin()])    # the variant served
        gap = abs(int(scores[0]) - at)
        if int(ref[0][0]) == int(own):
            gap = max(gap, int(ref[1][0]) - at)
        out.append(gap / (64.0 * variants.shape[1]))
    return out


def escalation_mismatches(run, served: list, want: list) -> int:
    """Sampled answers whose escalation flag differs from the reference's,
    away from the gate's bars by more than the score_gap limit."""
    s, lim = run.config["server"], run.workload["limits"]["score_gap"]
    bad = 0
    for got, ref in zip(served, want):
        n = ref[4].shape[1]
        if bool(got[3]) != bool(ref[3]) and not serve.near_gate(
                ref[5], n, s["threshold"], s["margin"], s["hi_sim"], lim * 64.0 * n):
            bad += 1
    return bad


def control(run) -> dict:
    """The TF32 reference's readings on check_requests queries of the pool."""
    cat = catalog.build(run)
    pcm, rows, rend = catalog.live_queries(run, cat)
    run.state.update(catalog=cat, pcm=pcm)
    rng, m = np.random.default_rng(run.seed + 1), run.workload["check_requests"]
    take = list(rng.permutation(np.flatnonzero(rend))[:m // 2])
    take += list(rng.permutation(np.flatnonzero(~rend))[:m - len(take)])
    clips = [pcm[i] for i in take]
    want = reference(run, clips)
    ctl = reference(run, clips, tf32=True)
    return {"score_gap": max(gaps(run, ctl, want, rows[take])),
            "escalation_mismatches": float(escalation_mismatches(run, ctl, want))}


def check(run) -> dict:
    r, lim = run.records, run.workload["limits"]
    take = sample(run)
    picks = [r["picks"][i] for i in take]
    want = reference(run, [run.state["pcm"][k] for k in picks])
    served = [r["results"][i] for i in take]
    g = gaps(run, served, want, [run.state["rows"][k] for k in picks])
    run.records["checked"] = len(take)
    if g:
        j = int(np.argmax(g))
        run.records["worst"] = json.dumps({
            "served": [str(served[j][0][0]), int(served[j][1][0]), int(served[j][2][0]),
                       bool(served[j][3])],
            "reference": [int(want[j][0][0]), int(want[j][1][0]), int(want[j][2][0]),
                          bool(want[j][3])], "own_track": int(run.state["rows"][picks[j]])})
    return {"score_gap": (max(g) if g else float("inf"), lim["score_gap"]),
            "escalation_mismatches": (float(escalation_mismatches(run, served, want)),
                                      lim["escalation_mismatches"]),
            "failed_requests": (float(len(r["errors"]) + r["unanswered"]),
                                lim["failed_requests"])}
