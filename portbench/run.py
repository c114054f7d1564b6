"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The run makes
its inputs from --seed, builds and warms up the system under test
(hpfw_tpu_torch), measures a window of --seconds, then compares what the
window produced with the plain reference and prints, as the last line of
standard output, {"correct", "attempted", "failed", "metrics", "device"
[, "breakdown"], "checks"}. With --trace 0 the metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
profiler trace of the window. The numbers compared are also the last lines
of standard error. Without a card, or with fewer cards than the cell asks
for, it exits 2 and prints no result.
"""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """This process's start on the perf_counter clock (from /proc, else now)."""
    now_pc, now = time.perf_counter(), time.time()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return now_pc - (now - (btime + ticks / os.sysconf("SC_CLK_TCK")))
    except (OSError, ValueError, IndexError, StopIteration):
        return now_pc


T_PROCESS = process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_note() -> str:
    """The card's name, power limit, SM clock, temperature and power draw, as
    nvidia-smi reads them after the window."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "temperature.gpu,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "?"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    entry = next((w for w in harness.benchmark()["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import hpfw_tpu_torch  # noqa: F401  (the system under test; absent: no result)

    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_PROCESS)
    try:
        out = harness.execute(run)
    except RuntimeError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    found = harness.jax_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 1
    info = {k: v for k, v in run.records.items() if isinstance(v, (int, float, str))}
    print(f"portbench: {args.workload} seed {args.seed} on {card_note()}; check "
          f"{run.check_s:.1f} s; {json.dumps(info)}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
