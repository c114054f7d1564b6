"""The port's track-sharded matchers on the CPU vs hpfw_tpu's on its 8-device
simulation (tests/conftest.py): ShardedDB and sharded_score on an 8-entry
`cpu` mesh against hpfw_tpu's on mesh8, equal element for element; the
mesh itself; the shards' device bookkeeping; and dryrun_multichip(8).

The counterparts of tests/test_sharded.py's four tests build the DB with
hpfw_tpu and hand its prints to the port, so that both scan the same bits.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu.io import synth
from hpfw_tpu.match import sharded as jax_sharded
from hpfw_tpu.parallel import mesh as jax_meshlib
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match import matcher, scaled
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.match.sharded import ShardedDB, sharded_score
from hpfw_tpu_torch.parallel import mesh as meshlib
from hpfw_tpu_torch.parallel.dryrun import dryrun_multichip


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide the 8-device CPU sim"
    return jax_meshlib.db_mesh(8), meshlib.Mesh(["cpu"] * 8)


def _dbs(cfg, tracks, filters):
    """hpfw_tpu's DB and the port's over the same prints."""
    jdb = jax_api.build_db(tracks, filters, cfg)
    pdb = api.FingerprintDB(_port(cfg), filters, jdb.track_ids, jdb.prints, jdb.lengths,
                            device="cpu")
    return jdb, pdb


def _same(a, b):
    assert list(a[0]) == list(b[0])
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_sharded_equals_dense(cfg, mesh8):
    jmesh, pmesh = mesh8
    tracks = synth.synth_catalog(19, 3.0, cfg)  # deliberately not /8
    filters = _filters(cfg)
    jdb, pdb = _dbs(cfg, tracks, filters)
    sdb = ShardedDB(pdb, pmesh)
    q = synth.make_query(tracks[11], 0.8, 1.5, cfg, noise_db=-15.0, seed=1)
    qfp = jax_api.fingerprint(q, filters, cfg)
    got = sdb.match(qfp, top_k=10, top_pool=19)
    _same(got, api.match(qfp, pdb, top_k=10))
    _same(got, jax_sharded.ShardedDB(jdb, jmesh).match(qfp, top_k=10, top_pool=19))
    assert got[0][0] == "11"


def test_sharded_padding_never_wins(cfg, mesh8):
    # 3 real tracks on an 8-entry mesh: 5 shards hold only padding.
    jmesh, pmesh = mesh8
    tracks = synth.synth_catalog(3, 3.0, cfg)
    filters = _filters(cfg)
    jdb, pdb = _dbs(cfg, tracks, filters)
    sdb = ShardedDB(pdb, pmesh)
    qfp = jax_api.fingerprint(synth.make_query(tracks[0], 0.2, 1.0, cfg), filters, cfg)
    got = sdb.match(qfp, top_k=10)
    assert len(got[0]) == 3  # padded entries dropped
    assert got[0][0] == "0"
    _same(got, jax_sharded.ShardedDB(jdb, jmesh).match(qfp, top_k=10))


@pytest.mark.parametrize("top_pool", [1, 2, 5])
def test_sharded_score_is_replicated_and_fixed_size(cfg, mesh8, top_pool):
    """The gathered (D*k,) arrays equal the reference's element for element."""
    jmesh, pmesh = mesh8
    tracks = synth.synth_catalog(16, 2.5, cfg)
    filters = _filters(cfg)
    jdb, pdb = _dbs(cfg, tracks, filters)
    sdb = ShardedDB(pdb, pmesh)
    jsdb = jax_sharded.ShardedDB(jdb, jmesh)
    q = jax_api.fingerprint(synth.make_query(tracks[4], 0.1, 1.0, cfg), filters, cfg)
    got = sharded_score(torch.from_numpy(q.view(np.int32)), sdb.shards, mesh=pmesh,
                        top_pool=top_pool)
    want = jax_sharded.sharded_score(jnp.asarray(q), jsdb.prints, jsdb.lengths, mesh=jmesh,
                                     top_pool=top_pool)
    k = min(top_pool, 2)
    for g, w in zip(got, want):
        assert g.shape == (8 * k,) and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].max()) < 16


def test_sharded_score_ties_equal_reference(cfg, mesh8):
    """Many equal scores inside and across shards (every track a copy of one
    of three rows, short tracks, empty padding): the gathered arrays and the
    ranking equal the reference's."""
    jmesh, pmesh = mesh8
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2 ** 32, (3, 40, 2), dtype=np.uint32)
    prints = rows[rng.integers(0, 3, 29)]
    lengths = np.full(29, 40, np.int32)
    lengths[[5, 17]] = [12, 30]
    for i, ln in enumerate(lengths):
        prints[i, ln:] = 0
    ids = [f"t{i}" for i in range(29)]
    filt = np.zeros((cfg.context_dim, 64), np.float32)
    jdb = jax_api.FingerprintDB(cfg, filt, ids, prints, lengths)
    pdb = api.FingerprintDB(_port(cfg), filt, ids, prints, lengths, device="cpu")
    sdb, jsdb = ShardedDB(pdb, pmesh), jax_sharded.ShardedDB(jdb, jmesh)
    q = rows[1, 7:27]
    got = sharded_score(torch.from_numpy(q.view(np.int32)), sdb.shards, mesh=pmesh,
                        top_pool=3)
    want = jax_sharded.sharded_score(jnp.asarray(q), jsdb.prints, jsdb.lengths, mesh=jmesh,
                                     top_pool=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _same(sdb.match(q, top_k=12, top_pool=3), jsdb.match(q, top_k=12, top_pool=3))


def test_time_shift_property_sharded(cfg, mesh8):
    """SURVEY.md §4.3 property test, through the sharded path."""
    _, pmesh = mesh8
    tracks = synth.synth_catalog(9, 4.0, cfg)
    filters = _filters(cfg)
    sdb = ShardedDB(api.build_db(tracks, filters, _port(cfg), device="cpu"), pmesh)
    for k in [0, 5]:
        q_pcm = tracks[6][k * cfg.hop: k * cfg.hop + int(2.0 * cfg.sample_rate)]
        qfp = api.fingerprint(q_pcm, filters, _port(cfg), device="cpu")
        ids, scores, offs = sdb.match(qfp, top_k=1)
        assert ids[0] == "6"
        assert int(offs[0]) == k
        assert int(scores[0]) == 64 * qfp.shape[0]


def test_mesh(monkeypatch):
    """db_mesh takes CUDA devices only and raises past the count, as the
    reference's does past jax.devices(); an explicit list may repeat a
    device; a CUDA entry torch does not see raises (no CPU fallback)."""
    with pytest.raises(ValueError, match="requested 1 devices, have 0"):
        meshlib.db_mesh(1)
    with pytest.raises(ValueError, match="at least one device"):
        meshlib.db_mesh()
    with pytest.raises(ValueError, match="torch sees 0 CUDA devices"):
        meshlib.Mesh(["cpu", "cuda:0"])
    m = meshlib.Mesh(["cpu", "meta", "cpu"])
    assert m.size == 3 and m.first == torch.device("cpu")
    assert m.distinct == [torch.device("cpu"), torch.device("meta")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert meshlib.db_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert meshlib.db_mesh(1).size == 1
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        meshlib.db_mesh(3)
    with pytest.raises(ValueError, match="cuda:2"):
        meshlib.Mesh(["cuda:1", "cuda:2"])
    assert meshlib.pad_tracks_to_mesh(19, m) == 21 == jax_meshlib.pad_tracks_to_mesh(
        19, jax_meshlib.db_mesh(7))


def test_split_and_gather():
    m = meshlib.Mesh(["cpu"] * 4)
    x = np.arange(24, dtype=np.int32).reshape(8, 3)
    parts = meshlib.split_tracks(x, m)
    assert [p.shape for p in parts] == [(2, 3)] * 4 and all(p.is_contiguous() for p in parts)
    np.testing.assert_array_equal(meshlib.gather_blocks(parts, m, dim=0).numpy(), x)
    with pytest.raises(ValueError, match="do not split"):
        meshlib.split_tracks(x[:7], m)


def _spy(monkeypatch, module, name, record):
    """Record the devices of each call's tensors; on a meta shard return
    meta outputs of the kernel's shapes instead of running it."""
    real = getattr(module, name)

    def spy(*args, **kw):
        devs = {a.device for a in args if isinstance(a, torch.Tensor)}
        record.append((name, devs))
        if devs == {torch.device("meta")}:
            with torch.device("cpu"):
                shaped = [torch.zeros(a.shape, dtype=a.dtype) for a in args]
            out = real(*shaped, **kw)
            return tuple(o.to("meta") for o in out)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("kind", ["dense", "two_stage"])
def test_shard_tensors_sit_on_their_devices(cfg, monkeypatch, kind):
    """Over a mesh of cpu and meta entries, every shard's tensors are on its
    own entry, and every per-shard kernel call sees tensors of one device,
    its shard's, in shard order; the gather then copies the meta blocks,
    which hold no data. (One card cannot show this: on it every shard is
    cuda:0.)"""
    devices = ["cpu", "meta", "cpu", "meta"]
    m = meshlib.Mesh(devices)
    rng = np.random.default_rng(5)
    prints = rng.integers(0, 2 ** 32, (13, 120, 2), dtype=np.uint32)
    db = api.FingerprintDB(_port(cfg), np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(13)], prints, np.full(13, 120, np.int32),
                           device="cpu")
    record = []
    if kind == "dense":
        sdb = ShardedDB(db, m)
        parts = sdb.shards
        _spy(monkeypatch, matcher, "score_tracks", record)
        call = lambda: sdb.match(prints[3, 10:74], top_k=3)        # noqa: E731
    else:
        ts = TwoStageDB(db, stride=8, query_phases=4, prefilter=4, prefilter_phases=2,
                        prefilter_pack4=True, mesh=m)
        assert ts.prints is None and ts.device == torch.device("cpu")
        assert ts.devices == m.distinct
        parts = ts.shards
        for name in ("coarse_scan_batch_packed", "coarse_rescan", "fine_rescan_batch"):
            _spy(monkeypatch, scaled, name, record)
        call = lambda: ts.match_batch(prints[[3, 9], 10:74], top_k=3)   # noqa: E731
    for part, dev in zip(parts, devices):
        assert {t.device for t in part} == {torch.device(dev)}
    with pytest.raises(NotImplementedError, match="meta"):
        call()
    per_call = len(record) // len(devices)
    assert len(record) == per_call * len(devices) and per_call >= 1
    for i, (_, devs) in enumerate(record):
        assert devs == {torch.device(devices[i // per_call])}, record


def test_dryrun_multichip_cpu():
    """The port's dry run on 8 logical shards of the CPU: the five steps of
    __graft_entry__.dryrun_multichip and their invariants."""
    dryrun_multichip(8, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="requested 8 devices"):
        dryrun_multichip(8)


def test_sharding_imports_no_jax_and_no_process_group():
    """The sharded modules load without jax or hpfw_tpu, and no source of the
    port (nor chip_smoke.py) imports torch.distributed: sharding is
    single-controller."""
    repo = Path(__file__).resolve().parents[1]
    code = ("import sys, hpfw_tpu_torch.parallel.mesh, hpfw_tpu_torch.parallel.dryrun, "
            "hpfw_tpu_torch.match.sharded; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hpfw_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|hpfw_tpu)\b|torch\.distributed",
                         re.M)
    sources = sorted((repo / "hpfw_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    assert len(sources) > 30
    assert [str(p) for p in sources if pattern.search(p.read_text())] == []
