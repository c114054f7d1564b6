"""The control of a cell's comparison: the reference in the program's place,
one step below what the configuration states, compared as a run compares.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

Each traffic kind's control(run) says what it puts in the program's place
and returns the numbers its check compares. Nothing of hpfw_tpu_torch runs.
Prints a JSON line a seed. The benchmark's runs never run this; its limits
are set between the program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell: str, seed: int, device, overrides: dict | None = None) -> dict:
    from . import harness

    run = harness.Run(cell, seed, 0.0, False, device, time.perf_counter(), overrides)
    return run.kind.control(run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
