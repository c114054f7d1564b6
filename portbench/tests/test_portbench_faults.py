"""A whole run of each cell at its tiny size on the CPU, the card's look
skipped: correct holds for the program as it is, and fails for each fault
planted under the timed path: an answer altered where it is produced, half
of a batch left out (every other row answered as the row before it), and a
step that returns
its first state again (stale answers); and, in the live cells, a gate that
escalates only well below its threshold. One card, so no exchange between
cards to leave out."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench_tiny import tiny_run

CELLS = ["catalog100k.live", "catalog100k.live_renditions", "catalog100k.batch16",
         "ingest240.stream"]
FAULTS = [None, "altered", "half_batch", "stale"]
# Requests wait into batches of several, and every one is compared.
SERVER = dict(harness.load_json("configs", "catalog100k.json")["server"], max_wait_ms=400.0)
EXTRA = {"catalog100k.live": dict(rate_qps=8.0, check_requests=64, server=SERVER),
         "catalog100k.live_renditions": dict(rate_qps=8.0, check_requests=64, server=SERVER),
         "catalog100k.batch16": dict(check_batches=8),
         "ingest240.stream": dict(check_batches=8)}


def plant(monkeypatch, cell: str, fault: str) -> None:
    from hpfw_tpu_torch import api, serve
    from hpfw_tpu_torch.match.scaled import TwoStageDB

    if cell == "ingest240.stream":
        orig, first = api.fingerprint_batch_device, []

        def broken(pcms, filters, cfg):
            out = orig(pcms, filters, cfg).clone()
            if fault == "altered":
                out[0, 0] = ~out[0, 0]
            elif fault == "half_batch":
                out[1::2] = out[0::2][:out[1::2].shape[0]]
            else:
                first.append(out)
                out = first[0]
            return out
        monkeypatch.setattr(api, "fingerprint_batch_device", broken)
        return
    if fault == "half_batch" and cell != "catalog100k.batch16":
        orig_x = serve.EscalatingMatchServer._extract

        def extract(self, rows):
            specs, prints = orig_x(self, rows)
            prints = prints.clone()
            prints[1::2] = prints[0::2][:prints[1::2].shape[0]]
            return specs, prints
        monkeypatch.setattr(serve.EscalatingMatchServer, "_extract", extract)
        return
    orig_d, first = TwoStageDB.dispatch_batch, []

    def dispatch(self, queries, **kw):
        out = orig_d(self, queries, **kw).clone()
        if fault == "altered":
            out[:, 2] += 3
        elif fault == "half_batch":
            out[1::2] = out[0::2][:out[1::2].shape[0]]
        else:
            first.append(out)
            rows = first[0][torch.arange(out.shape[0]) % first[0].shape[0]]
            out = rows
        return out
    monkeypatch.setattr(TwoStageDB, "dispatch_batch", dispatch)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f or "sound")
@pytest.mark.parametrize("cell", CELLS)
def test_correct_catches_the_fault(cell, fault, monkeypatch):
    if fault:
        plant(monkeypatch, cell, fault)
    run = tiny_run(cell, seconds=2.0, **EXTRA[cell])
    out = harness.execute(run)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] > 0 and np.isfinite(list(out["metrics"].values())[0]["value"])



@pytest.mark.parametrize("lowered", [False, True], ids=["sound", "lowered"])
@pytest.mark.parametrize("cell", CELLS[:2])
def test_escalation_check_catches_a_lowered_gate(cell, lowered, monkeypatch):
    """A server that keeps a rigid answer unless it scores a tenth below the
    threshold leaves the hard queries unescalated; only the escalation check
    sees it. At the tiny size only queries under louder noise fall below the
    gate, so both runs take them."""
    from hpfw_tpu_torch import api

    orig = api.rigid_confident

    def gate(scores, n_prints, *, threshold=0.62, **kw):
        return orig(scores, n_prints, threshold=threshold - 0.1, **kw)
    if lowered:
        monkeypatch.setattr(api, "rigid_confident", gate)
    out = harness.execute(tiny_run(cell, seconds=2.0,
                                   **dict(EXTRA[cell], query_pool=16, noise_db=6.0)))
    assert out["correct"] is not lowered, out["checks"]
    assert (out["checks"]["escalation_mismatches"]["value"] > 0) is lowered, out["checks"]
