"""The port's file ingestion on the CPU vs hpfw_tpu's.

- io.ingest.load_files equals hpfw_tpu.io.ingest.load_files bit for bit (the
  same native decoders, built from native/*.cc with the same flags) and the
  port's per-file load_audio, for WAV (mono, and 44.1 kHz stereo that is
  downmixed and resampled), FLAC, Ogg Vorbis and MPEG audio;
- Sun .au, which the native batch decoder rejects, falls back to load_audio per
  file; a missing file raises;
- api.build_db_from_files equals the port's build_db over load_files' PCM,
  and hpfw_tpu's build_db_from_files up to the margin audit;
- a failed native build raises, and never writes native/libhpfw_native.so;
- where hpfw_tpu would decode with a pure-NumPy codec, the port raises and
  names the codec.
"""

import os

import numpy as np
import pytest

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu.io import ingest as jax_ingest
from hpfw_tpu.io import native as jax_native
from hpfw_tpu.io import synth
from hpfw_tpu.io import wav as jax_wav
from hpfw_tpu.io.flac import encode_flac
from hpfw_tpu.io.mp3enc import encode_mp3
from hpfw_tpu.io.vorbis import encode_vorbis
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.io import ingest, native, wav
from tests.test_tpu_pipeline import assert_bits_match_with_margin_audit
from tests.test_wav import _au

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


@pytest.fixture(scope="module")
def files(cfg, tmp_path_factory):
    """One file a container (tests/test_ingest.py's fixtures), plus a 44.1 kHz
    stereo WAV written by the port's save_wav; all carry synth music."""
    d = tmp_path_factory.mktemp("ingest")
    tracks = synth.synth_catalog(5, 3.0, cfg)
    paths = [str(d / "a.wav")]
    wav.save_wav(paths[0], tracks[0], cfg.sample_rate)
    ints = (np.clip(tracks[1], -1, 1) * 32767.0).round().astype(np.int16)
    for name, data in [("b.flac", encode_flac(ints[:, None], cfg.sample_rate)),
                       ("c.ogg", encode_vorbis(tracks[2], cfg.sample_rate)),
                       ("d.mp3", encode_mp3(jax_wav.resample(tracks[3], cfg.sample_rate,
                                                              44100), 44100))]:
        paths.append(str(d / name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    left = jax_wav.resample(tracks[4], cfg.sample_rate, 44100)
    paths.append(str(d / "e_stereo.wav"))
    wav.save_wav(paths[-1], np.stack([left, 0.5 * left[::-1]], axis=1), 44100)
    return paths


def test_load_files_equal_to_reference(cfg, files):
    got = ingest.load_files(files, _port(cfg), n_threads=2)
    want = jax_ingest.load_files(files, cfg, n_threads=2)
    assert len(got) == len(want) == len(files)
    for p, g, w in zip(files, got, want):
        assert g.dtype == np.float32 and g.shape[0] > 0
        np.testing.assert_array_equal(g, w, err_msg=p)
        pcm, sr = wav.load_audio(p, _port(cfg))
        assert sr == cfg.sample_rate
        np.testing.assert_array_equal(g, pcm, err_msg=f"load_files != load_audio for {p}")


def test_stereo_wav_downmixed_and_resampled(cfg, files):
    """The stereo file decodes to the channel mean at 44.1 kHz, sinc-resampled
    to the config rate as hpfw_tpu's NumPy resampler does (to ~1 ulp)."""
    raw, sr = wav.load_audio(files[-1])
    assert sr == 44100
    data = open(files[-1], "rb").read()
    np.testing.assert_array_equal(raw, jax_wav._decode_wav_bytes(data)[0])
    pcm, _ = wav.load_audio(files[-1], _port(cfg))
    np.testing.assert_allclose(pcm, jax_wav.resample_sinc(raw, 44100, cfg.sample_rate),
                               rtol=0, atol=1e-6)


def test_au_falls_back_to_load_audio(cfg, tmp_path):
    """Sun .au has no native decoder: the batch decoder rejects it, and load_files
    decodes it with load_audio, as hpfw_tpu does."""
    ints = (np.sin(np.arange(8000) / 20.0) * 20000).astype(">i2")
    p = str(tmp_path / "e.au")
    with open(p, "wb") as f:
        f.write(_au(ints.tobytes(), 3, 22050))
    assert native.ingest_files([p], target_rate=0) == [None]
    got = ingest.load_files([p], _port(cfg))
    np.testing.assert_array_equal(got[0], wav.load_audio(p, _port(cfg))[0])
    np.testing.assert_array_equal(got[0], jax_ingest.load_files([p], cfg)[0])
    with pytest.raises(ValueError, match="rejected"):
        ingest.load_files([p], _port(cfg), strict=True)


def test_missing_file_raises(cfg, tmp_path):
    with pytest.raises(OSError):
        ingest.load_files([str(tmp_path / "nope.wav")], _port(cfg))


@pytest.fixture(scope="module")
def built(cfg, files):
    """The same files through the port's build_db_from_files (groups of 3
    rows, 2 s buckets) and build_db over load_files' PCM, and through
    hpfw_tpu's build_db_from_files."""
    filters = _filters(cfg)
    pcms = ingest.load_files(files, _port(cfg))
    got = api.build_db_from_files(files, filters, _port(cfg), batch=3, bucket_seconds=2.0,
                                  device="cpu")
    direct = api.build_db(dict(zip(files, pcms)), filters, _port(cfg), device="cpu")
    ref = jax_api.build_db_from_files(files, filters, cfg, batch=3, bucket_seconds=2.0)
    return filters, pcms, got, direct, ref


def test_build_db_from_files_equals_build_db(built):
    _, _, got, direct, _ = built
    assert got.track_ids == direct.track_ids
    np.testing.assert_array_equal(got.lengths, direct.lengths)
    np.testing.assert_array_equal(got.prints, direct.prints)
    np.testing.assert_array_equal(got.filters, direct.filters)
    assert got.device.type == "cpu"


def test_build_db_from_files_equals_reference(cfg, built):
    """hpfw_tpu's build_db_from_files: the same ids and lengths, and the same
    prints up to the margin audit (float64 margins of each file's PCM)."""
    filters, pcms, got, _, ref = built
    assert got.track_ids == ref.track_ids
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    for t, pcm in enumerate(pcms):
        n = int(got.lengths[t])
        assert n > 0
        assert_bits_match_with_margin_audit(got.prints[t, :n], ref.prints[t, :n],
                                            oracle.delta_margins(pcm, filters, cfg)[:n])


def test_build_db_from_files_ids_progress_and_query(cfg, files, built):
    """track_ids and progress as the reference takes them; a noisy excerpt
    of one file ranks its track first at its offset."""
    filters, pcms, _, _, _ = built
    calls = []
    db = api.build_db_from_files(files, filters, _port(cfg), track_ids=list("abcde"),
                                 progress=lambda done, total: calls.append((done, total)),
                                 device="cpu")
    assert db.track_ids == list("abcde") and calls == [(5, 5)]
    start = 64 * cfg.hop
    q = synth.make_query(pcms[2], start / cfg.sample_rate, 2.0, _port(cfg), noise_db=-15.0,
                         seed=4)
    ids, _, offs = api.match(api.fingerprint(q, filters, _port(cfg), device="cpu"), db,
                             top_k=2)
    assert (ids[0], int(offs[0])) == ("c", 64)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A compiler that fails, or none at all, makes the build raise (no
    NumPy fallback), and the build never touches native/."""
    ours = os.path.join(REPO, "native", "libhpfw_native.so")
    before = os.stat(ours).st_mtime_ns if os.path.exists(ours) else None
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    native.load_library.cache_clear()
    try:
        monkeypatch.setattr(native, "CXX", "false")
        with pytest.raises(RuntimeError, match="building the native audio library failed"):
            native.available()
        with pytest.raises(RuntimeError, match="building"):
            ingest.load_files([os.path.join(REPO, "README.md")])
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
            native.available()
        assert not list((tmp_path / "build").rglob("*.so"))
    finally:
        native.load_library.cache_clear()
    after = os.stat(ours).st_mtime_ns if os.path.exists(ours) else None
    assert after == before


def test_pure_numpy_codecs_refused(cfg, files, monkeypatch):
    """An MPEG stream the native decoder rejects: hpfw_tpu decodes it with
    its NumPy MPEG decoder, the port raises and names the codec. FLAC bytes
    handed to the WAV byte decoder: the port names the native decoder."""
    mp3 = files[3]

    def reject(data):
        raise ValueError("native mp3 decode failed (code -1)")

    monkeypatch.setattr(jax_native, "decode_mp3", reject)
    monkeypatch.setattr(native, "decode_mp3", reject)
    pcm, sr = jax_wav.load_audio(mp3)
    assert sr == 44100 and pcm.shape[0] > 0
    with pytest.raises(ValueError, match="MPEG audio .*not ported"):
        wav.load_audio(mp3)
    flac = open(files[1], "rb").read()
    assert jax_wav._decode_wav_bytes(flac)[0].shape[0] > 0
    with pytest.raises(ValueError, match="FLAC .*not ported"):
        wav._decode_wav_bytes(flac)


@pytest.mark.parametrize("sniff", ["_looks_like_mpeg", "_looks_like_adts"])
def test_sniffers_agree_with_reference(files, sniff):
    """The container sniffers give hpfw_tpu's answers on every fixture, on
    truncated and junk-prefixed copies, and on random bytes."""
    rng = np.random.default_rng(5)
    blobs = []
    for p in files:
        data = open(p, "rb").read()
        blobs += [data, data[:300], b"\x00" * 100 + data[:5000]]
    blobs += [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (10, 4096, 9000)]
    got = [getattr(wav, sniff)(b) for b in blobs]
    assert got == [getattr(jax_wav, sniff)(b) for b in blobs]
    if sniff == "_looks_like_mpeg":
        assert got[9] is True and got[0] is False
