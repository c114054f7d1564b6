"""The port's public API on the CPU vs hpfw_tpu.api: the slice end to end."""

import sys
import threading

import numpy as np
import pytest
import torch

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu.io import synth
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from tests.test_tpu_pipeline import assert_bits_match_with_margin_audit


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def catalog(cfg):
    """6 x 4 s synthetic tracks and oracle-learned filters (SKILL recipe)."""
    tracks = synth.synth_catalog(6, 4.0, cfg)
    filters = oracle.learn_filters(tracks[:3], cfg).astype(np.float32)
    return tracks, filters


@pytest.fixture(scope="module")
def dbs(cfg, catalog):
    tracks, filters = catalog
    ids = {f"t{i}": t for i, t in enumerate(tracks)}
    return (api.build_db(ids, filters, _port(cfg), device="cpu"),
            jax_api.build_db(ids, filters, cfg))


def test_db_prints_agree_within_margin_audit(cfg, catalog, dbs):
    tracks, filters = catalog
    port_db, jax_db = dbs
    assert port_db.track_ids == jax_db.track_ids
    np.testing.assert_array_equal(port_db.lengths, jax_db.lengths)
    assert port_db.prints.shape == jax_db.prints.shape and port_db.prints.dtype == np.uint32
    for i, t in enumerate(tracks):
        n = port_db.lengths[i]
        assert_bits_match_with_margin_audit(port_db.prints[i, :n], jax_db.prints[i, :n],
                                            oracle.delta_margins(t, filters, cfg))


@pytest.mark.parametrize("query", ["noisy_excerpt", "longer_than_every_track"])
def test_match_equals_jax(cfg, catalog, dbs, query):
    tracks, filters = catalog
    port_db, _ = dbs
    if query == "noisy_excerpt":
        pcm = synth.make_query(tracks[4], 0.9, 2.0, cfg, noise_db=-15.0, seed=3)
    else:
        pcm = np.concatenate([tracks[2], tracks[5][: cfg.sample_rate]])
    q = api.fingerprint(pcm, filters, _port(cfg), device="cpu")
    assert q.dtype == np.uint32
    # Both matchers over the same prints, so the comparison is exact.
    jax_db = jax_api.FingerprintDB(cfg, filters, port_db.track_ids, port_db.prints,
                                   port_db.lengths)
    got = api.match(q, port_db, top_k=4)
    want = jax_api.match(q, jax_db, top_k=4)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == want[1].dtype and got[2].dtype == want[2].dtype
    if query == "noisy_excerpt":
        assert got[0][0] == "t4"
        assert abs(int(got[2][0]) - round(0.9 * cfg.sample_rate / cfg.hop)) <= 1
    else:
        assert q.shape[0] > port_db.prints.shape[1]
        assert got[0][0] == "t2" and int(got[2][0]) == 0


def test_fingerprint_bucketing_exact(cfg, catalog):
    _, filters = catalog
    port = _port(cfg)
    for extra in [0, 17, cfg.hop - 1, 3 * cfg.hop + 5]:
        pcm = synth.synth_track(40, 1.7, cfg)
        pcm = pcm[: len(pcm) - extra]
        unbucketed = api.fingerprint(pcm, filters, port, bucket_s=0, device="cpu")
        bucketed = api.fingerprint(pcm, filters, port, bucket_s=0.25, device="cpu")
        assert bucketed.shape == unbucketed.shape == (cfg.n_hashprints(len(pcm)), 2)
        np.testing.assert_array_equal(bucketed, unbucketed)


def test_fingerprint_batch_equals_per_track(cfg, catalog):
    tracks, filters = catalog
    port = _port(cfg)
    n = min(len(t) for t in tracks[:3]) - 123
    batch = np.stack([t[:n] for t in tracks[:3]])
    got = api.fingerprint_batch(batch, filters, port, device="cpu")
    assert got.shape == (3, cfg.n_hashprints(n), 2) and got.dtype == np.uint32
    for i in range(3):
        np.testing.assert_array_equal(got[i], api.fingerprint(batch[i], filters, port,
                                                              bucket_s=0, device="cpu"))
    assert api.fingerprint_batch(batch[:, :100], filters, port,
                                 device="cpu").shape == (3, 0, 2)


def test_db_save_load_across_packages(tmp_path, cfg, dbs):
    port_db, jax_db = dbs
    pairs = [(port_db, jax_api.FingerprintDB, "port.npz", {}),
             (jax_db, api.FingerprintDB, "jax.npz", {"device": "cpu"})]
    for src, loader, name, kw in pairs:
        path = str(tmp_path / name)
        src.save(path)
        back = loader.load(path, **kw)
        assert back.cfg.to_json() == src.cfg.to_json()
        assert back.track_ids == src.track_ids
        for field in ("prints", "lengths", "filters"):
            a, b = getattr(back, field), getattr(src, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_short_input_and_devices(cfg, catalog):
    _, filters = catalog
    port = _port(cfg)
    out = api.fingerprint(np.zeros(10, np.float32), filters, port, device="cpu")
    assert out.shape == (0, 2) and out.dtype == np.uint32
    pcm = synth.synth_track(12, 1.0, cfg)
    from_tensor = api.fingerprint(pcm, torch.from_numpy(filters), port)
    np.testing.assert_array_equal(from_tensor, api.fingerprint(pcm, filters, port,
                                                               device="cpu"))
    with pytest.raises(ValueError):
        api.fingerprint(pcm, filters[:-1], port, device="cpu")
    with pytest.raises(ValueError):
        api.FingerprintDB(port, filters, ["a"], np.zeros((1, 4, 2), np.uint32),
                          np.array([5], np.int32), device="cpu")


@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_fingerprint_stream_equals_batches(cfg, catalog, n_batches):
    """Each yielded batch equals fingerprint_batch of that batch bit for bit,
    in order, and hpfw_tpu's fingerprint_stream up to the margin audit."""
    tracks, filters = catalog
    port = _port(cfg)
    n = 2 * cfg.sample_rate
    batches = [np.stack([tracks[(i + j) % len(tracks)][i * 512:i * 512 + n]
                         for j in range(2)]) for i in range(n_batches)]
    got = list(api.fingerprint_stream(iter(batches), filters, port, device="cpu"))
    want = list(jax_api.fingerprint_stream(iter(batches), filters, cfg))
    assert len(got) == len(want) == n_batches
    for b, g, w in zip(batches, got, want):
        assert g.shape == w.shape == (2, cfg.n_hashprints(n), 2) and g.dtype == np.uint32
        np.testing.assert_array_equal(g, api.fingerprint_batch(b, filters, port, device="cpu"))
        for pcm, gi, wi in zip(b, g, w):
            assert_bits_match_with_margin_audit(
                gi, wi, oracle.delta_margins(pcm, filters, cfg)[:gi.shape[0]])
    with pytest.raises(ValueError, match="PCM batches"):
        next(api.fingerprint_stream([np.zeros(n, np.float32)], filters, port, device="cpu"))


def _stream_batches(tracks, shapes):
    """(B, S) batches of the given shapes, cut from the catalog at offsets of
    their own."""
    return [np.stack([tracks[(i + j) % len(tracks)][97 * i:97 * i + s] for j in range(b)])
            for i, (b, s) in enumerate(shapes)]


def _stage_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("hpfw-stage")]


class _Counting:
    """An iterator over batches that counts how far it was advanced."""

    def __init__(self, batches):
        self.batches, self.pulled = batches, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pulled == len(self.batches):
            raise StopIteration
        self.pulled += 1
        return self.batches[self.pulled - 1]


def test_fingerprint_stream_shapes_change_between_batches(cfg, catalog):
    """Batch size and length change from batch to batch: each yielded batch
    equals fingerprint_batch of its own batch, in order, and no staging
    thread is left once the stream ends."""
    tracks, filters = catalog
    port = _port(cfg)
    shapes = [(2, 12000), (1, 20000), (3, 12000), (1, 9000), (2, 20000), (3, 9000)]
    batches = _stream_batches(tracks, shapes)
    got = list(api.fingerprint_stream(_Counting(batches), filters, port, device="cpu"))
    assert [g.shape for g in got] == [(b, port.n_hashprints(s), 2) for b, s in shapes]
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g, api.fingerprint_batch(b, filters, port, device="cpu"))
    assert not _stage_threads()


@pytest.mark.parametrize("how", ["close", "break"])
def test_fingerprint_stream_early_close_joins_the_stager(cfg, catalog, how):
    """Closing the generator after its first batch (close(), or leaving a for
    loop) stops and joins the staging thread. By then the input was advanced
    at most: the batch yielded, the one in flight beside it, the queue's
    _STAGE_DEPTH and the one the thread was staging."""
    tracks, filters = catalog
    feed = _Counting(_stream_batches(tracks, [(1, 9000)] * 20))
    stream = api.fingerprint_stream(feed, filters, _port(cfg), device="cpu")
    if how == "close":
        first = next(stream)
        stream.close()
    else:
        for first in stream:
            break
        del stream
    assert first.shape[0] == 1
    assert not _stage_threads()
    assert 1 <= feed.pulled <= 1 + 1 + api._STAGE_DEPTH + 1


def test_fingerprint_stream_many_callers_close_at_random(cfg, catalog):
    """Twelve threads, more than the CPUs, each stream six batches and leave
    after a count of their own, under a short switch interval: every batch
    yielded equals fingerprint_batch and no staging thread is left."""
    tracks, filters = catalog
    port = _port(cfg)
    batches = _stream_batches(tracks, [(1 + i % 2, 9000) for i in range(6)])
    want = [api.fingerprint_batch(b, filters, port, device="cpu") for b in batches]
    faults = []

    def caller(stop_after):
        try:
            for k, out in enumerate(api.fingerprint_stream(iter(batches), filters, port,
                                                           device="cpu")):
                np.testing.assert_array_equal(out, want[k])
                if k == stop_after:
                    break
        except Exception as exc:
            faults.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i % 7,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not faults, faults
    assert not _stage_threads()


@pytest.mark.parametrize("fault", ["input_raises", "one_dimensional"])
@pytest.mark.parametrize("k", [0, 3])
def test_fingerprint_stream_error_after_earlier_batches(cfg, catalog, fault, k):
    """An exception from the input at batch k, or a 1-D batch k, reaches the
    caller after batches 0..k-1 have been yielded, each equal to
    fingerprint_batch; no staging thread is left."""
    tracks, filters = catalog
    port = _port(cfg)
    batches = _stream_batches(tracks, [(2, 9000)] * 6)

    def feed():
        for i, b in enumerate(batches):
            if i == k:
                if fault == "input_raises":
                    raise RuntimeError("input failed at batch k")
                b = b[0]
            yield b

    got = []
    err = RuntimeError if fault == "input_raises" else ValueError
    with pytest.raises(err, match="batch k" if fault == "input_raises" else "PCM batches"):
        for out in api.fingerprint_stream(feed(), filters, port, device="cpu"):
            got.append(out)
    assert len(got) == k
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g, api.fingerprint_batch(b, filters, port, device="cpu"))
    assert not _stage_threads()
