"""The port's CLI on the CPU (--device cpu) against hpfw_tpu's.

Every subcommand (all 12 parsers of hpfw_tpu/cli.py, the 13 usage lines of
its docstring with `match --cache`) runs through hpfw_tpu.cli.main and
hpfw_tpu_torch.cli.main on the same WAVs and the same filters.npz; their
standard output must agree line for line once the timings are masked, and
their exit codes must be equal. Each artifact (filters.npz, db.npz, a cache
directory, adb.npz) is loaded by the other package and must answer there as
in the package that wrote it. Learned filters are held to
test_torch_learn.py's tolerance (|cos| > 0.98 a column); prints built by
the two packages from one filters file to the oracle margin audit.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from hpfw_tpu import cli as jax_cli
from hpfw_tpu import oracle
from hpfw_tpu.io import synth
from hpfw_tpu.io.mp3enc import encode_mp3
from hpfw_tpu.io.wav import resample, save_wav
from hpfw_tpu.match import scaled as jax_scaled
from hpfw_tpu_torch import cli
from hpfw_tpu_torch.match.scaled import TwoStageDB
from tests.test_tpu_pipeline import assert_bits_match_with_margin_audit

N_TRACKS, SECONDS = 6, 4.0


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def port(argv):
    return run(cli.main, argv + ["--device", "cpu"])


def ref(argv):
    return run(jax_cli.main, argv)


def masked(text, **names):
    """Timings masked; each given path replaced by its name."""
    for name, path in names.items():
        text = text.replace(str(path), f"<{name}>")
    text = re.sub(r"\d+\.\d+ ms", "<t> ms", text)
    return re.sub(r" in \d+\.\d+s", " in <t>s", text)


def same(argv, **names):
    """Both CLIs on argv: equal exit codes and masked outputs; the output."""
    (rc_r, out_r), (rc_p, out_p) = ref(argv), port(argv)
    assert rc_p == rc_r, (out_r, out_p)
    assert masked(out_p, **names) == masked(out_r, **names)
    return rc_p, out_p


@pytest.fixture(scope="module")
def work(cfg, tmp_path_factory):
    """WAVs of a 6 x 4 s catalog and two noisy queries, the small config as
    --config JSON, filters learned by each CLI, and a DB built by each CLI
    from the reference's filters."""
    d = tmp_path_factory.mktemp("cli")
    conf = d / "cfg.json"
    conf.write_text(cfg.to_json())
    tracks = synth.synth_catalog(N_TRACKS, SECONDS, cfg)
    wavs = []
    for i, t in enumerate(tracks):
        wavs.append(str(d / f"{i}.wav"))
        save_wav(wavs[-1], t, cfg.sample_rate)
    queries = []
    for n, (i, start, seed) in enumerate([(3, 0.8, 1), (1, 0.5, 2)]):
        queries.append(str(d / f"q{n}.wav"))
        save_wav(queries[-1], synth.make_query(tracks[i], start, 2.0, cfg, noise_db=-15.0,
                                               seed=seed), cfg.sample_rate)
    w = dict(d=d, conf=str(conf), wavs=wavs, queries=queries, tracks=tracks)
    for pkg, fn in (("ref", ref), ("port", port)):
        w[f"learn_{pkg}"] = fn(["learn", *wavs[:3], "-o", str(d / f"f_{pkg}.npz"),
                                "--config", str(conf)])
    w["filters"] = str(d / "f_ref.npz")
    for pkg, fn in (("ref", ref), ("port", port)):
        w[f"build_{pkg}"] = fn(["build-db", *wavs, "--filters", w["filters"],
                                "-o", str(d / f"db_{pkg}.npz"), "--config", str(conf)])
    return w


def test_learn(work):
    d = work["d"]
    for pkg in ("ref", "port"):
        assert work[f"learn_{pkg}"][0] == 0
    assert (masked(work["learn_port"][1], out=d / "f_port.npz")
            == masked(work["learn_ref"][1], out=d / "f_ref.npz"))
    got, want = np.load(d / "f_port.npz"), np.load(d / "f_ref.npz")
    assert bytes(got["config_json"]) == bytes(want["config_json"])
    g, w = got["filters"].astype(np.float64), want["filters"].astype(np.float64)
    assert g.shape == w.shape and got["filters"].dtype == np.float32
    cos = np.abs(np.sum(g * w, axis=0)) / (np.linalg.norm(g, axis=0) * np.linalg.norm(w, axis=0))
    assert np.all(cos > 0.98), cos.min()


def test_build_db(work, cfg):
    d = work["d"]
    for pkg in ("ref", "port"):
        assert work[f"build_{pkg}"][0] == 0
    assert (masked(work["build_port"][1], out=d / "db_port.npz")
            == masked(work["build_ref"][1], out=d / "db_ref.npz"))
    got, want = np.load(d / "db_port.npz"), np.load(d / "db_ref.npz")
    assert list(got["track_ids"]) == list(want["track_ids"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    np.testing.assert_array_equal(got["filters"], want["filters"])
    assert bytes(got["config_json"]) == bytes(want["config_json"])
    filters = want["filters"]
    for i, pcm in enumerate(work["tracks"]):
        n = int(want["lengths"][i])
        assert_bits_match_with_margin_audit(got["prints"][i, :n], want["prints"][i, :n],
                                            oracle.delta_margins(pcm, filters, cfg)[:n])


@pytest.mark.parametrize("mode", ["head", "output", "cpu"])
def test_fingerprint(work, cfg, mode):
    d, wav = work["d"], work["wavs"][2]
    base = ["fingerprint", wav, "--filters", work["filters"], "--config", work["conf"]]
    if mode == "cpu":
        same(base + ["--cpu"])
        return
    if mode == "head":
        same(base + ["--head", "40"])
        return
    outs = {}
    for pkg, fn in (("ref", ref), ("port", port)):
        outs[pkg] = fn(base + ["-o", str(d / f"fp_{pkg}.npz")])
    assert outs["port"][0] == outs["ref"][0] == 0
    assert (masked(outs["port"][1], out=d / "fp_port.npz")
            == masked(outs["ref"][1], out=d / "fp_ref.npz"))
    got, want = np.load(d / "fp_port.npz")["prints"], np.load(d / "fp_ref.npz")["prints"]
    filters = np.load(work["filters"])["filters"]
    assert_bits_match_with_margin_audit(got, want, oracle.delta_margins(
        work["tracks"][2], filters, cfg)[:want.shape[0]])


@pytest.mark.parametrize("db", ["db_ref", "db_port"])
@pytest.mark.parametrize("flags", [[], ["--scaled"], ["--scaled", "--pool", "8", "--phases", "2"],
                                   ["--top-k", "2"]], ids=["dense", "scaled", "pool8", "top2"])
def test_match_db_either_package(work, db, flags):
    """A DB written by either package answers in both CLIs alike. (A pool
    below 8 tracks is the kept divergence of ROADMAP C: the port pools as the
    reference's Pallas path does, in whole 8-track tiles, where its CPU path
    pools exactly; test_scaled_small_pool_is_the_pallas_paths holds it.)"""
    for q in work["queries"]:
        rc, out = same(["match", q, "--db", str(work["d"] / f"{db}.npz"), *flags])
        assert rc == 0
    assert out.startswith(f"#1 {work['wavs'][1]} ")


def test_scaled_small_pool_is_the_pallas_paths(work):
    """match --scaled --pool 4 prints what hpfw_tpu's TwoStageDB answers on
    its Pallas path (an 8-track tile, interpreted) for the same prints."""
    from hpfw_tpu import api as jax_api

    d, q = work["d"], work["queries"][0]
    rc, out = port(["match", q, "--db", str(d / "db_ref.npz"), "--scaled", "--pool", "4"])
    assert rc == 0
    assert port(["fingerprint", q, "--filters", work["filters"], "--config", work["conf"],
                 "-o", str(d / "fp_q0.npz")])[0] == 0
    ts = jax_scaled.TwoStageDB(jax_api.FingerprintDB.load(str(d / "db_ref.npz")),
                               use_pallas_fine=True, use_pallas_coarse=True, coarse_tile=8,
                               pallas_interpret=True)
    ids, scores, offs = ts.match(np.load(d / "fp_q0.npz")["prints"], top_k=5, pool=4)
    rows = [ln.split() for ln in out.splitlines()[:-1]]
    assert [r[1] for r in rows] == list(ids)
    assert [r[2] for r in rows] == [f"score={int(s)}" for s in scores]
    assert [r[4] for r in rows] == [f"offset={int(o)}" for o in offs]


def test_match_needs_db_or_cache(work):
    (rc_r, _), (rc_p, _) = ref(["match", work["queries"][0]]), port(["match", work["queries"][0]])
    assert rc_r == rc_p == 2


def test_match_mp3_query(work, cfg):
    """A lossy-codec query (MP3 at 44.1 kHz, resampled on ingest) through
    load_audio, as tests/test_cli.py feeds the reference."""
    q = synth.make_query(work["tracks"][3], 0.8, 2.0, cfg, noise_db=-15.0, seed=1)
    mp = str(work["d"] / "q.mp3")
    with open(mp, "wb") as f:
        f.write(encode_mp3(resample(q, cfg.sample_rate, 44100).astype(np.float64), 44100))
    rc, out = same(["match", mp, "--db", str(work["d"] / "db_ref.npz"), "--top-k", "2"])
    assert rc == 0 and out.startswith(f"#1 {work['wavs'][3]} ")


@pytest.fixture(scope="module")
def caches(work):
    """build-cache of the reference's DB by each CLI."""
    d = work["d"]
    return {pkg: fn(["build-cache", "--db", str(d / "db_ref.npz"),
                     "-o", str(d / f"cache_{pkg}"), "--stride", "4"])
            for pkg, fn in (("ref", ref), ("port", port))}


def test_build_cache(work, caches):
    d = work["d"]
    assert caches["port"][0] == caches["ref"][0] == 0
    assert (masked(caches["port"][1], out=d / "cache_port")
            == masked(caches["ref"][1], out=d / "cache_ref"))


def test_build_cache_warmup(work, caches):
    """--warmup-prints: the reference's lines, then the warm-up line with 0
    compile-cache entries (the reference's warm-up raises on a cache it
    derived on the CPU, so its output is not compared here)."""
    d = work["d"]
    rc, out = port(["build-cache", "--db", str(d / "db_ref.npz"), "-o", str(d / "cache_w"),
                    "--stride", "4", "--warmup-prints", "64", "--warmup-batches", "1,2"])
    assert rc == 0
    lines = masked(out, out=d / "cache_w").splitlines()
    assert lines[:-1] == masked(caches["ref"][1], out=d / "cache_ref").splitlines()
    assert re.fullmatch(r"warmed serving compiles for N=64, batches \(1, 2\) in <t>s "
                        r"\(0 compile-cache entries bundled into the artifact; "
                        r"the port has no compile cache to seed\)", lines[-1]), lines[-1]


@pytest.mark.parametrize("flags", [[], ["--top-k", "3"], ["--pool", "4", "--phases", "2"]],
                         ids=["default", "top3", "pool4_phases2"])
def test_match_cache_either_package(work, caches, flags):
    """The reference's cache answers in both CLIs alike; the port's answers
    in hpfw_tpu's TwoStageDB (Pallas layout, interpreted) as in the port's."""
    d = work["d"]
    for q in work["queries"]:
        rc, _ = same(["match", q, "--cache", str(d / "cache_ref"), *flags])
        assert rc == 0
    rc, out = port(["match", work["queries"][0], "--cache", str(d / "cache_port"), *flags])
    assert rc == 0 and out.startswith(f"#1 {work['wavs'][3]} ")
    mine = TwoStageDB.load(str(d / "cache_port"), device="cpu")
    theirs = jax_scaled.TwoStageDB.load(str(d / "cache_port"), pallas_interpret=True)
    db = np.load(d / "db_ref.npz")
    kw = {"--top-k": "top_k", "--pool": "pool", "--phases": "phases"}
    kw = {kw[k]: int(v) for k, v in zip(flags[::2], flags[1::2])}
    for row in (1, 3):
        q = db["prints"][row, 20:60]
        got, want = mine.match(q, **kw), theirs.match(q, **kw)
        assert list(got[0]) == list(want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_build_cache_prefilter_channels(work):
    """--prefilter-channels derives the pass-1 subset DB in the port (no
    stderr note) and the cache answers as a cache without it."""
    d = work["d"]
    rc, _ = port(["build-cache", "--db", str(d / "db_ref.npz"), "-o", str(d / "cache_pf"),
                  "--stride", "4", "--prefilter-channels", "32"])
    assert rc == 0
    assert json.loads((d / "cache_pf" / "manifest.json").read_text())["prefilter_channels"] == 32
    assert (d / "cache_pf" / "coarse1.npy").exists()
    rc, out = port(["match", work["queries"][0], "--cache", str(d / "cache_pf")])
    assert rc == 0 and out.startswith(f"#1 {work['wavs'][3]} ")


@pytest.mark.parametrize("src", ["db", "cache"])
def test_stream(work, caches, src):
    d = work["d"]
    where = ["--db", str(d / "db_ref.npz")] if src == "db" else ["--cache", str(d / "cache_ref")]
    rc, out = same(["stream", work["queries"][0], *where, "--query-prints", "64"])
    assert rc == 0 and f"final: {work['wavs'][3]} " in out


def test_pool(work):
    q0, q1 = work["queries"]
    rc, out = same(["pool", q0, q1, "--db", str(work["d"] / "db_ref.npz"),
                    "--query-prints", "64"])
    assert rc == 0 and f"{q0}: {work['wavs'][3]} " in out and f"{q1}: {work['wavs'][1]} " in out


@pytest.fixture(scope="module")
def artists(cfg, work):
    """Two artists' directories of 3 x 4 s WAVs, a query of each, and an
    adb.npz written by each CLI."""
    d = work["d"] / "artists"
    dirs = []
    for a in range(2):
        dirs.append(d / f"artist{a}")
        dirs[-1].mkdir(parents=True)
        for i in range(3):
            save_wav(str(dirs[-1] / f"t{i}.wav"),
                     synth.synth_artist_track(a, i, SECONDS, cfg), cfg.sample_rate)
    query = str(d / "q.wav")
    save_wav(query, synth.make_query(synth.synth_artist_track(1, 2, SECONDS, cfg), 1.0, 2.0,
                                     cfg, noise_db=-12.0, seed=1), cfg.sample_rate)
    outs = {pkg: fn(["build-artist-db", *map(str, dirs), "-o", str(d / f"adb_{pkg}.npz"),
                     "--config", work["conf"]])
            for pkg, fn in (("ref", ref), ("port", port))}
    return dict(d=d, query=query, outs=outs)


def test_build_artist_db(artists):
    d, outs = artists["d"], artists["outs"]
    assert outs["port"][0] == outs["ref"][0] == 0
    assert (masked(outs["port"][1], out=d / "adb_port.npz")
            == masked(outs["ref"][1], out=d / "adb_ref.npz"))
    got, want = np.load(d / "adb_port.npz"), np.load(d / "adb_ref.npz")
    assert sorted(got.files) == sorted(want.files)
    assert list(got["artists"]) == list(want["artists"]) == ["artist0", "artist1"]
    for i in range(2):
        assert list(got[f"a{i}_track_ids"]) == list(want[f"a{i}_track_ids"])
        np.testing.assert_array_equal(got[f"a{i}_lengths"], want[f"a{i}_lengths"])


@pytest.mark.parametrize("adb", ["adb_ref", "adb_port"])
@pytest.mark.parametrize("flags", [[], ["--artist", "artist1"], ["--top-k", "2"]],
                         ids=["unknown", "known", "top2"])
def test_match_artist_either_package(artists, adb, flags):
    rc, out = same(["match-artist", artists["query"], "--db",
                    str(artists["d"] / f"{adb}.npz"), *flags])
    assert rc == 0 and out.startswith("#1 artist1/t2 ")


@pytest.mark.parametrize("cmd", [["demo", "--small", "--tracks", "6", "--seconds", "5"],
                                 ["artist-demo", "--small", "--artists", "2", "--tracks", "3",
                                  "--seconds", "5"],
                                 ["selfcheck"]],
                         ids=["demo", "artist_demo", "selfcheck"])
def test_end_to_end_commands(cmd):
    """demo and artist-demo learn their own filters in each package (to
    test_torch_learn.py's tolerance), so a ranked line's score may differ by
    a few bits: ids and offsets must be equal, scores within 16 bits; every
    other line equal."""
    (rc_r, out_r), (rc_p, out_p) = ref(cmd), port(cmd)
    assert rc_p == rc_r == 0
    if cmd[0] == "selfcheck":
        assert out_p == out_r
        assert json.loads(out_p) == {"differing_bits": 0, "total_bits": 15360,
                                     "backend": "cpu"}
        return
    assert "MISMATCH" not in out_p
    ranked = re.compile(r"  #\d (\S+)  score=(\d+)  offset=(\d+)")
    lines_p, lines_r = masked(out_p).splitlines(), masked(out_r).splitlines()
    assert len(lines_p) == len(lines_r)
    for lp, lr in zip(lines_p, lines_r):
        mp, mr = ranked.fullmatch(lp), ranked.fullmatch(lr)
        if mr is None:
            assert lp == lr
            continue
        assert mp is not None and mp[1] == mr[1] and mp[3] == mr[3], (lp, lr)
        assert abs(int(mp[2]) - int(mr[2])) <= 16, (lp, lr)


def test_device_flag_before_or_after_and_default_raises(work):
    rc1, out1 = run(cli.main, ["--device", "cpu", "selfcheck"])
    rc2, out2 = run(cli.main, ["selfcheck", "--device", "cpu"])
    assert rc1 == rc2 == 0 and out1 == out2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["selfcheck"])


def test_module_entry_point(tmp_path):
    """python -m hpfw_tpu_torch.cli runs as a script."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "hpfw_tpu_torch.cli", "--device", "cpu",
                          "selfcheck"], cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["backend"] == "cpu"
