"""utils/profiling.py on the CPU: the wall-clock scopes and their stats, a
torch.profiler trace around a port match naming the scope, and no trace
without a device when torch sees no card."""

import json

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.io import synth
from hpfw_tpu_torch.oracle import fix_eigenvector_signs
from hpfw_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_scopes():
    profiling.reset_scopes()
    yield
    profiling.reset_scopes()


def test_trace_records_scope_stats(tmp_path):
    for _ in range(3):
        with profiling.trace("a"):
            torch.ones(8).sum()
    with profiling.trace("b"):
        pass
    stats = profiling.scope_stats()
    assert set(stats) == {"a", "b"}
    assert stats["a"]["count"] == 3 and stats["b"]["count"] == 1
    assert 0 <= stats["a"]["p50_ms"] <= stats["a"]["max_ms"] <= stats["a"]["total_ms"]
    path = tmp_path / "m.json"
    profiling.dump_metrics(str(path), extra={"run": 1})
    payload = json.loads(path.read_text())
    assert payload["run"] == 1 and payload["scopes"] == stats
    profiling.reset_scopes()
    assert profiling.scope_stats() == {}


def test_trace_json_names_the_scope(tmp_path):
    cfg = HpfwConfig(frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8,
                     delta_lag=4)
    rng = np.random.default_rng(0)
    filters = fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, 64)) / 50).astype(np.float32)
    tracks = synth.synth_catalog(3, 2.0, cfg)
    db = api.build_db(tracks, filters, cfg, device="cpu")
    q = api.fingerprint(tracks[1][2000:30000], filters, cfg, device="cpu")
    profiling.start_trace(str(tmp_path / "tr"), device="cpu")
    with pytest.raises(RuntimeError, match="already running"):
        profiling.start_trace(str(tmp_path / "tr2"), device="cpu")
    with profiling.trace("match"):
        ids, _, _ = api.match(q, db, top_k=2)
    profiling.stop_trace()
    assert ids[0] == "1"
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    scopes = [e for e in events if e.get("name") == "match" and e.get("ph") == "X"]
    assert len(scopes) == 1 and scopes[0]["dur"] > 0
    assert profiling.scope_stats()["match"]["count"] == 1
    with pytest.raises(RuntimeError, match="no trace is running"):
        profiling.stop_trace()


def test_start_trace_without_device_needs_a_card(tmp_path):
    """With no device named the card is traced; with none visible, it raises."""
    if torch.cuda.is_available():
        profiling.start_trace(str(tmp_path))
        profiling.stop_trace()
        assert (tmp_path / "trace.json").exists()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.start_trace(str(tmp_path))
    profiling.start_trace(str(tmp_path), device="cpu")   # nothing left running
    profiling.stop_trace()
