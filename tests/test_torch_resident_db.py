"""A FingerprintDB whose prints are a tensor already on its device (a
device-resident DB), on the CPU at a small size.

Such a DB shares the caller's tensor, keeps no host copy until something
reads `prints`, saves what a DB built from the same bits as a host array
saves, and matches through TwoStageDB exactly as that DB does and as the
plain reference of portbench/ does. The spans it and TwoStageDB write
(index.derive, db.upload, db.host_copy) and the two host-print readers of
the serving paths (api.match_scan_escalating's structure gate,
EscalatingMatchServer's) are checked too."""

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import EscalatingMatchServer, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.io import synth
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.oracle import fix_eigenvector_signs
from hpfw_tpu_torch.utils import profiling
from portbench.reference import matcher as reference

# Catalog-scale knobs, pack4, with a prefilter and pool that prune 300 tracks.
HP = dict(coarse_prefilter_pack4=True, coarse_prefilter=64, fine_candidates=16)
T, L, N = 300, 400, 96


def _cfg():
    return HpfwConfig.catalog_scale(**HP)


def _dbs(cfg, seed=0):
    """The same seeded prints as a resident DB (over an int32 tensor) and as
    a DB over the host uint32 array, and the tensor."""
    g = torch.Generator().manual_seed(seed)
    prints = torch.randint(-2 ** 31, 2 ** 31, (T, L, 2), generator=g,
                           dtype=torch.int64).to(torch.int32)
    lengths = torch.full((T,), L, dtype=torch.int32)
    lengths[::7] = L - 50                             # some shorter tracks
    filters = np.zeros((cfg.context_dim, 64), np.float32)
    ids = [str(i) for i in range(T)]
    resident = api.FingerprintDB(cfg, filters, ids, prints, lengths, device="cpu")
    host = api.FingerprintDB(cfg, filters, ids, prints.numpy().view(np.uint32).copy(),
                             lengths.numpy(), device="cpu")
    return resident, host, prints


def _queries(prints, seed=1, b=6):
    """b excerpts of N prints with 10% of bits flipped, as int32 (b, N, 2)."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, T, (b,), generator=g)
    offs = torch.randint(0, L - 50 - N, (b,), generator=g)
    q = torch.stack([prints[r, o:o + N] for r, o in zip(rows.tolist(), offs.tolist())])
    bits = torch.rand((b, N, 2, 32), generator=g) < 0.1
    flips = (bits.to(torch.int64) << torch.arange(32)).sum(-1)
    return (q.to(torch.int64) ^ flips).to(torch.int32)


def _since(first, name):
    return [s for s in profiling.spans() if s.name == name and s.sid > first]


def test_resident_db_shares_the_tensor():
    resident, host, prints = _dbs(_cfg())
    got, lengths = resident.device_arrays()
    assert got is not None and got.data_ptr() == prints.data_ptr()
    assert torch.equal(lengths, host.device_arrays()[1])
    assert resident.host_bytes == 0 and host.host_bytes == T * L * 8
    assert resident.has_prints and resident.n_tracks == T
    np.testing.assert_array_equal(resident.print_row(5), host.prints[5])
    assert resident.host_bytes == 0                   # one row, no copy kept
    cfg = _cfg()
    with pytest.raises(ValueError, match="int32"):
        api.FingerprintDB(cfg, resident.filters, resident.track_ids, prints.long(),
                          resident.lengths, device="cpu")
    with pytest.raises(ValueError, match=r"\(300, L, 2\)"):
        api.FingerprintDB(cfg, resident.filters, resident.track_ids, prints[:, :, :1],
                          resident.lengths, device="cpu")
    with pytest.raises(ValueError, match="lengths"):
        api.FingerprintDB(cfg, resident.filters, resident.track_ids, prints[:, :300],
                          resident.lengths, device="cpu")


def test_reading_prints_makes_one_host_copy():
    resident, host, _ = _dbs(_cfg())
    first = profiling.new_id()
    assert resident.host_bytes == 0
    got = resident.prints
    assert got.dtype == np.uint32 and np.array_equal(got, host.prints)
    assert resident.host_bytes == T * L * 8
    assert resident.prints is got                     # kept, not copied again
    spans = _since(first, "db.host_copy")
    assert [s.attrs["bytes"] for s in spans] == [T * L * 8]
    assert not _since(first, "db.upload")


def test_save_of_either_db_loads_back_equal(tmp_path):
    resident, host, _ = _dbs(_cfg())
    for name, db in (("resident", resident), ("host", host)):
        path = str(tmp_path / f"{name}.npz")
        db.save(path)
        back = api.FingerprintDB.load(path, device="cpu")
        assert back.track_ids == host.track_ids and back.cfg == host.cfg
        np.testing.assert_array_equal(back.prints, host.prints)
        np.testing.assert_array_equal(back.lengths, host.lengths)
        np.testing.assert_array_equal(back.filters, host.filters)


def test_match_batch_equals_host_db_and_reference():
    """match_batch over the resident DB and over the host-array DB: the same
    tracks, scores and offsets, which are the plain reference's; the index
    is derived once a build (one index.derive span of the padded rows and
    the bytes written), the host DB is uploaded once (db.upload) and the
    resident DB never (no upload, no host copy)."""
    cfg = _cfg()
    resident, host, prints = _dbs(cfg)
    qs = _queries(prints)
    first = profiling.new_id()
    ts_r = TwoStageDB(resident)
    mid = profiling.new_id()
    ts_h = TwoStageDB(host)
    derive_h = _since(mid, "index.derive")
    derive_r = [s for s in _since(first, "index.derive") if s.sid < mid]
    assert len(derive_r) == len(derive_h) == 1
    rows = T + (-T % 8)
    for span, ts in ((derive_r[0], ts_r), (derive_h[0], ts_h)):
        assert span.attrs["rows"] == rows
        assert span.attrs["bytes"] == ts.db_c.nbytes + ts.db_c1.nbytes
    assert ts_r.db_c1 is not ts_r.db_c and ts_r.db_c1.shape[1] * 2 < ts_r.db_c.shape[1]
    assert [s.attrs["bytes"] for s in _since(first, "db.upload")] == [T * L * 8]
    got_r, got_h = ts_r.match_batch(qs.numpy()), ts_h.match_batch(qs.numpy())
    assert resident.host_bytes == 0 and not _since(first, "db.host_copy")
    m = {k: getattr(cfg, k) for k in ("db_downsample", "coarse_prefilter_phases",
                                      "coarse_prefilter_channels", "coarse_prefilter",
                                      "coarse_query_phases", "coarse_channels",
                                      "fine_candidates")}
    cat = reference.Catalog(prints, resident.device_arrays()[1], m)
    out = cat.match(qs)
    want = [reference.rank(o[0], o[1], o[2], cfg.top_k, T) for o in out]
    for (ids_r, s_r, o_r), (ids_h, s_h, o_h), (tr, sc, of) in zip(got_r, got_h, want):
        assert list(ids_r) == list(ids_h) == [str(t) for t in tr.tolist()]
        np.testing.assert_array_equal(s_r, s_h)
        np.testing.assert_array_equal(o_r, o_h)
        np.testing.assert_array_equal(np.asarray(s_r, np.int64), sc)
        np.testing.assert_array_equal(np.asarray(o_r, np.int64), of)
    assert min(int(s[0]) for _, s, _ in got_r) > 0.75 * 64 * N     # each excerpt found


def test_mesh_split_copies_a_resident_db_to_the_host_once():
    """Over a mesh, TwoStageDB splits the host prints: a resident DB makes its
    one host copy (db.host_copy) and matches as the host-array DB does."""
    from hpfw_tpu_torch.parallel.mesh import Mesh

    cfg = _cfg()
    resident, host, prints = _dbs(cfg)
    qs = _queries(prints, b=3).numpy()
    want = TwoStageDB(host, mesh=Mesh(["cpu"] * 2)).match_batch(qs)
    first = profiling.new_id()
    sharded = TwoStageDB(resident, mesh=Mesh(["cpu"] * 2))
    assert [s.attrs["bytes"] for s in _since(first, "db.host_copy")] == [T * L * 8]
    assert len(_since(first, "index.derive")) == 2 and resident.host_bytes == T * L * 8
    for (ids_a, s_a, o_a), (ids_b, s_b, o_b) in zip(sharded.match_batch(qs), want):
        assert list(ids_a) == list(ids_b)
        np.testing.assert_array_equal(s_a, s_b)
        np.testing.assert_array_equal(o_a, o_b)


@pytest.fixture(scope="module")
def structured():
    """12 synthetic tracks of 6 s at a small config: a resident DB over their
    prints, a host-array DB over the same, the filters, and three 3 s live
    queries of tracks 3, 5 and 9."""
    cfg = HpfwConfig(frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8,
                     delta_lag=4, db_downsample=4, stretch_span=0.03)
    rng = np.random.default_rng(0)
    f = rng.standard_normal((cfg.context_dim, 64)) / np.sqrt(cfg.context_dim)
    filters = fix_eigenvector_signs(f).astype(np.float32)
    tracks = synth.synth_catalog(12, 6.0, cfg)
    host = api.build_db(tracks, filters, cfg, device="cpu")
    prints = torch.from_numpy(host.prints.view(np.int32).copy())
    resident = api.FingerprintDB(cfg, filters, host.track_ids, prints,
                                 torch.from_numpy(host.lengths), device="cpu")
    pcms = np.stack([synth.make_query(tracks[t], 1.0, 3.0, cfg, noise_db=-20.0, seed=t)
                     for t in (3, 5, 9)])
    return cfg, resident, host, filters, pcms


# Every query fails the confidence gate, so each reaches the structure gate.
GATE = dict(threshold=1.01, hi_sim=1.01, structure_gate=0.75, override=10.0,
            override_unstructured=0.0, top_k=1)


def test_structure_gate_readers_on_a_resident_db(structured):
    """api.match_scan_escalating and EscalatingMatchServer read the answer's
    print row for the structure gate: over a resident DB they give the
    host-array DB's answers and rungs, and make no host copy."""
    cfg, resident, host, filters, pcms = structured
    first = profiling.new_id()
    ts_r, ts_h = TwoStageDB(resident), TwoStageDB(host)
    got, want = {}, {}
    for ts, stats in ((ts_r, got), (ts_h, want)):
        stats["api"] = {}
        stats["answers"] = api.match_scan_escalating(pcms, filters, ts, cfg, pool=8,
                                                     stats=stats["api"], **GATE)
        with EscalatingMatchServer(ts, filters, pcms.shape[1], max_batch=4,
                                   max_wait_ms=20.0, pool=8, **GATE) as srv:
            stats["served"] = [srv.submit(p).result(timeout=600) for p in pcms]
            stats["server"] = dict(srv.stats)
    assert got["api"] == want["api"] and got["server"] == want["server"]
    assert got["server"]["structure_kept"] == len(got["api"]["structure_kept"]) > 0
    for a, b in zip(got["answers"] + got["served"], want["answers"] + want["served"]):
        assert list(a[0]) == list(b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert [a[0][0] for a in got["answers"]] == ["3", "5", "9"]
    assert resident.host_bytes == 0 and not _since(first, "db.host_copy")


def test_a_db_without_print_rows_is_refused_a_structure_gate(structured):
    cfg, resident, _, filters, pcms = structured
    db = api.FingerprintDB(cfg, filters, resident.track_ids, resident.device_arrays()[0],
                           resident.lengths, device="cpu")
    ts = TwoStageDB(db)
    db.prints = None
    assert not db.has_prints and db.host_bytes == 0
    with pytest.raises(ValueError, match="host print rows"):
        EscalatingMatchServer(ts, filters, pcms.shape[1], structure_gate=0.75)
