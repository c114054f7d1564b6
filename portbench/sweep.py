"""Find a live cell's knee: the highest offered rate the server sustains.

    python3 -m portbench.sweep --workload catalog100k.live --seed <n> \\
        --seconds 10 --rates 25,50,100 --repeats 2

Sets the cell up once, then runs its window at each rate in turn, from
the lowest, repeats times. A rate is sustained when every repeat sheds
nothing and answers at least 90% of what was offered
(benchmarks/config4_serve.py's rule; the achieved rate is the answered
requests over the time from the window's start to the last answer), and
builds no backlog in either class of request, rigid or escalated: the
median latency of a class's last quarter of requests in the window is at
most twice its first quarter's. The escalation scan has a queue of its own
that sheds nothing, so past its capacity escalated requests wait ever
longer while nearly all are still answered. The sweep stops at the first
rate not sustained; the knee is the highest rate sustained below it.
Prints a JSON line a window and one for the knee.
A cell's rate_qps is fixed once from the knee this finds; the benchmark's
runs never search for a rate.
"""

from __future__ import annotations

import argparse
import json
import sys

from .run import T_PROCESS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from . import harness, stats

    run = harness.Run(args.workload, args.seed, args.seconds, False, torch.device("cuda", 0),
                      T_PROCESS)
    run.kind.setup(run)
    sustained = {}
    for rate in sorted(float(x) for x in args.rates.split(",")):
        ok = True
        for rep in range(args.repeats):
            run.workload["rate_qps"] = rate
            run.workload["schedule_seed"] += 1
            run.records = {}
            run.kind.window(run)
            r = run.records
            lat = r["latencies"]
            answered = r["attempted"] - r["failed"]
            span = max(lat[i] + u for i, u in enumerate(r["due"])) if r.get("due") else None
            achieved = answered / max(run.seconds, span or 0.0)
            quarters = {}
            for name, esc in (("rigid", False), ("escalated", True)):
                c = [x for x, res in zip(lat, r["results"])
                     if res is not None and bool(res[3]) is esc]
                q = len(c) // 4
                if q:
                    quarters[name] = (1e3 * stats.percentile(c[:q], 50),
                                      1e3 * stats.percentile(c[-q:], 50))
            backlog = any(tail > 2 * head for head, tail in quarters.values())
            ok &= r["shed"] == 0 and achieved >= 0.9 * rate and not backlog
            print(json.dumps({"rate": rate, "repeat": rep, "achieved": achieved,
                              "answered": answered, "shed": r["shed"],
                              "p50_ms": 1e3 * stats.percentile(lat, 50),
                              "p95_ms": 1e3 * stats.percentile(lat, 95),
                              "quarter_p50_ms": quarters,
                              "escalated": r["stats"]["escalated"],
                              "submitted": r["stats"]["submitted"],
                              "generator_late_s": r["generator_late_s"]}), flush=True)
            if not ok:
                break
        sustained[rate] = bool(ok)
        if not ok:
            break
    good = [k for k, v in sustained.items() if v]
    print(json.dumps({"knee": max(good) if good else None, "sustained": sustained}), flush=True)
    run.kind.release(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
