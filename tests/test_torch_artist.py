"""The port's known-artist mode on the CPU vs hpfw_tpu's: fingerprint_multi,
ArtistDB files in both directions, and known- and unknown-artist matches,
dense and scaled, on tests/test_artist.py's setups."""

import numpy as np
import pytest

from hpfw_tpu import api as jax_api
from hpfw_tpu.artist import ArtistDB as JaxArtistDB
from hpfw_tpu.io import synth
from hpfw_tpu.parallel import mesh as jax_meshlib
from hpfw_tpu_torch import api
from hpfw_tpu_torch.artist import ArtistDB
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.parallel.mesh import Mesh


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _catalogs(cfg, n_artists=3, n_tracks=4, seconds=4.0):
    return {f"artist{a}": {f"a{a}t{i}": synth.synth_artist_track(a, i, seconds, cfg)
                           for i in range(n_tracks)}
            for a in range(n_artists)}


def _port_banks(adb, cfg):
    """The reference ArtistDB's banks (filters and prints) as port DBs."""
    return {a: api.FingerprintDB(_port(cfg), db.filters, db.track_ids, db.prints,
                                 db.lengths, device="cpu")
            for a, db in adb.banks.items()}


@pytest.fixture(scope="module")
def built(cfg):
    """test_artist.py's setup, built by each package on its own: 3 artists x
    4 tracks x 4 s, one filter bank learned per artist."""
    catalogs = _catalogs(cfg)
    return (catalogs, JaxArtistDB.build(catalogs, cfg),
            ArtistDB.build(catalogs, _port(cfg), device="cpu"))


def _bits(a, b):
    return int(np.bitwise_count(np.bitwise_xor(a, b)).sum())


def test_build_learns_the_reference_banks(cfg, built):
    catalogs, ref, port = built
    assert port.artists == ref.artists == list(catalogs)
    for a in port.artists:
        pb, rb = port.banks[a], ref.banks[a]
        assert pb.track_ids == rb.track_ids and pb.device.type == "cpu"
        np.testing.assert_array_equal(pb.lengths, rb.lengths)
        cos = np.abs(np.sum(pb.filters.astype(np.float64) * rb.filters, axis=0))
        assert np.all(cos > 0.98), (a, cos.min())
    assert not np.allclose(port.banks["artist0"].filters, port.banks["artist1"].filters)


def test_fingerprint_multi_bitexact_per_bank_and_near_reference(cfg, built):
    """Row a is fingerprint() under bank a bit for bit (the twin of
    test_artist.py:29), and within K2's bar of the reference's multi-bank
    extraction under the same banks."""
    _, ref, _ = built
    pcm = synth.synth_artist_track(1, 7, 3.0, cfg)
    stack = np.stack([ref.banks[a].filters for a in ref.artists])
    got = api.fingerprint_multi(pcm, stack, _port(cfg), device="cpu")
    want = jax_api.fingerprint_multi(pcm, stack, cfg)
    assert got.dtype == np.uint32 and got.shape == want.shape == (
        3, cfg.n_hashprints(len(pcm)), 2)
    for i, a in enumerate(ref.artists):
        single = api.fingerprint(pcm, ref.banks[a].filters, _port(cfg), device="cpu")
        np.testing.assert_array_equal(got[i], single, err_msg=a)
        assert _bits(got[i], want[i]) <= max(2, got[i].size * 32 // 10000), a
    short = api.fingerprint_multi(pcm[:1000], stack, _port(cfg), device="cpu")
    assert short.shape == (3, 0, 2)
    with pytest.raises(ValueError):
        api.fingerprint_multi(pcm, stack[0], _port(cfg), device="cpu")


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_artist_db_file_loads_in_the_other_package(cfg, built, tmp_path, saver):
    _, ref, port = built
    src, loader = (ref, ArtistDB.load) if saver == "jax" else (port, JaxArtistDB.load)
    path = str(tmp_path / "adb.npz")
    src.save(path)
    loaded = loader(path, device="cpu") if saver == "jax" else loader(path)
    assert loaded.artists == src.artists
    assert loaded.cfg.to_json() == src.cfg.to_json()
    for a in src.artists:
        for field in ("filters", "prints", "lengths"):
            x, y = getattr(loaded.banks[a], field), getattr(src.banks[a], field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert loaded.banks[a].track_ids == src.banks[a].track_ids
    # The twin of test_artist.py:99: the loaded DB identifies a query.
    q = synth.make_query(synth.synth_artist_track(0, 1, 4.0, cfg), 0.5, 2.0, cfg,
                         noise_db=-18.0, seed=3)
    assert loaded.match(q, artist="artist0", top_k=1)[0][0] == "a0t1"


# (artist or None for unknown, track, start s, noise seed) of test_artist.py's
# queries: known artist (:39, :56) and unknown artist (:47, :76).
QUERIES = [("artist1", "a1t2", 0.8, 1), ("artist0", "a0t0", 0.8, 4),
           (None, "a2t1", 0.6, 2)]


@pytest.mark.parametrize("scaled", [False, True], ids=["dense", "scaled"])
@pytest.mark.parametrize("query", range(len(QUERIES)))
def test_match_gives_the_reference_ids_and_offsets(cfg, built, scaled, query):
    """Over the reference's banks, the port's ArtistDB returns the reference's
    ids and offsets, dense and scaled (stride 4, pool 4 as test_artist.py:81;
    a full pool for a known artist as :66); scores differ by at most the
    query prints' differing bits."""
    catalogs, ref, _ = built
    artist, tid, start, seed = QUERIES[query]
    owner = artist or "artist2"
    q = synth.make_query(catalogs[owner][tid], start, 2.0, cfg, noise_db=-15.0, seed=seed)
    kw = dict(top_k=3 if artist else 5)
    if scaled:
        kw["pool"] = ref.banks[owner].n_tracks if artist else 4
        ref = JaxArtistDB(cfg, ref.banks, scaled=True, stride=4, use_pallas_fine=True,
                          pallas_interpret=True)
    port = ArtistDB(_port(cfg), _port_banks(ref, cfg), scaled=scaled, stride=4 if scaled
                    else None, device="cpu")
    got = port.match(q, artist=artist, **kw)
    want = ref.match(q, artist=artist, **kw)
    assert list(got[0]) == list(want[0])
    assert got[0][0] == (tid if artist else (owner, tid))
    np.testing.assert_array_equal(got[2], want[2])
    names = [artist] if artist else ref.artists
    bits = max(_bits(api.fingerprint(q, ref.banks[a].filters, _port(cfg), device="cpu"),
                     jax_api.fingerprint(q, ref.banks[a].filters, cfg)) for a in names)
    assert np.abs(np.asarray(got[1], np.int64) - np.asarray(want[1], np.int64)).max() <= bits
    if scaled:
        assert set(port._ts_banks) == set(names)


def test_constructor_checks(cfg, built):
    _, _, port = built
    other = HpfwConfig.from_json(port.cfg.to_json().replace('"top_k": 10', '"top_k": 3'))
    with pytest.raises(ValueError, match="config differs"):
        ArtistDB(other, port.banks, device="cpu")


@pytest.mark.parametrize("query", range(len(QUERIES)))
def test_scaled_match_on_mesh(cfg, built, query):
    """ArtistDB(scaled=True, mesh=): every bank's TwoStageDB sharded over 8
    logical cpu shards. Over the reference's banks it returns the unsharded
    scaled banks' answer bit for bit, and the ids and offsets of hpfw_tpu's
    ArtistDB on mesh8 (its default coarse_tile pads each bank to 8 x 128
    tracks, the port to 8 x 8; the empty tracks take the same pool slots)."""
    catalogs, ref, _ = built
    artist, tid, start, seed = QUERIES[query]
    owner = artist or "artist2"
    q = synth.make_query(catalogs[owner][tid], start, 2.0, cfg, noise_db=-15.0, seed=seed)
    kw = dict(top_k=3 if artist else 5, pool=ref.banks[owner].n_tracks if artist else 4)
    mesh = Mesh(["cpu"] * 8)
    port = ArtistDB(_port(cfg), _port_banks(ref, cfg), scaled=True, stride=4, mesh=mesh,
                    device="cpu")
    flat = ArtistDB(_port(cfg), _port_banks(ref, cfg), scaled=True, stride=4, device="cpu")
    jref = JaxArtistDB(cfg, ref.banks, scaled=True, stride=4, mesh=jax_meshlib.db_mesh(8),
                       use_pallas_fine=True, pallas_interpret=True)
    got = port.match(q, artist=artist, **kw)
    want = flat.match(q, artist=artist, **kw)
    assert list(got[0]) == list(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    names = [artist] if artist else ref.artists
    for a in names:
        assert port.two_stage(a).mesh is mesh and len(port.two_stage(a).shards) == 8
    jgot = jref.match(q, artist=artist, **kw)
    assert list(got[0]) == list(jgot[0])
    np.testing.assert_array_equal(got[2], jgot[2])
    bits = max(_bits(api.fingerprint(q, ref.banks[a].filters, _port(cfg), device="cpu"),
                     jax_api.fingerprint(q, ref.banks[a].filters, cfg)) for a in names)
    assert np.abs(np.asarray(got[1], np.int64) - np.asarray(jgot[1], np.int64)).max() <= bits
