"""The control of each cell's comparison fails it: the reference in the
program's place, one step below what the configuration states (TF32 for
float32 prints; for the matcher, which states integer-exact results, the
stated tie rule broken). At sizes a test run holds; the readings at the
cells' own sizes come from `python3 -m portbench.control` on the card."""

import pytest
import torch

from portbench import control, harness
from portbench_tiny import CATALOG


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA device")
    return torch.device("cuda", 0)


def limit(cell: str, name: str) -> float:
    return harness.load_json("workloads", cell + ".json")["limits"][name]


def test_tie_control_fails_the_batch_cell():
    hp = dict(harness.load_json("configs", "catalog100k.json")["hpfw"],
              coarse_prefilter=16, fine_candidates=8)
    for seed in (1, 2, 3):
        got = control.readings("catalog100k.batch16", seed, torch.device("cpu"),
                               dict(CATALOG, hpfw=hp, query_batches=2, batch_size=8,
                                    check_batches=2))
        assert got["mismatches"] > limit("catalog100k.batch16", "mismatches"), got


@pytest.mark.cuda
def test_tf32_control_fails_the_ingest_cell(cuda):
    for seed in (1, 2, 3):
        got = control.readings("ingest240.stream", seed, cuda,
                               dict(batch_size=2, host_batches=1, check_batches=1))
        assert got["bit_diff_share"] > limit("ingest240.stream", "bit_diff_share"), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["catalog100k.live", "catalog100k.live_renditions"])
def test_tf32_control_fails_the_live_cells(cell, cuda):
    for seed in (1, 2, 3):
        got = control.readings(cell, seed, cuda,
                               dict(n_tracks=8192, planted_tracks=64, query_pool=64,
                                    check_requests=32))
        assert got["score_gap"] > limit(cell, "score_gap"), got
