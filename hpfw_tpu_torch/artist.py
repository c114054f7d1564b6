"""Known-artist live song ID: per-artist filter banks.

Counterpart of hpfw_tpu/artist.py. Each artist gets a 64-filter bank learned
on their own material (learn/pca.py). At query time the artist is either
known (match within their catalog, the hashprint paper's setting) or
inferred (match every artist's catalog and rank globally: exact Hamming
scores are comparable across banks, since every bank emits 64-bit prints of
the same query length). Multi-bank extraction computes the CQT once (K1)
and runs the encoder once a bank (K2), api.fingerprint_multi.

save/load write the reference's .npz, so a file saved by either package
loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import api
from .api import FingerprintDB, default_device
from .config import DEFAULT_CONFIG, HpfwConfig
from .learn import pca


class ArtistDB:
    """Per-artist fingerprint databases sharing one config, on one device.

    banks: artist name -> FingerprintDB (each carries its own filters); a
    bank on another device is re-homed to `device` (default: the card;
    raises when torch sees none). scaled=True backs each artist with a TwoStageDB
    (coarse scan + exact fine rescan, K4 and K5 on the card), derived on the
    artist's first match; `stride` and `mesh` (parallel/mesh.py: every bank
    sharded over it) apply to every bank.
    """

    def __init__(self, cfg: HpfwConfig, banks: dict, *, scaled: bool = False,
                 stride: int | None = None, mesh=None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else default_device()
        self.banks = {}
        for name, db in banks.items():
            if db.cfg != cfg:
                raise ValueError(f"artist {name!r} DB config differs")
            if db.device != self.device:
                db = FingerprintDB(db.cfg, db.filters, db.track_ids, db.prints,
                                   db.lengths, device=self.device)
            self.banks[name] = db
        self.scaled = scaled
        self._ts_kw = dict(stride=stride, mesh=mesh)
        self._ts_banks: dict = {}

    def two_stage(self, artist: str):
        """The artist's TwoStageDB (derived on first use, then resident)."""
        if artist not in self._ts_banks:
            from .match.scaled import TwoStageDB

            self._ts_banks[artist] = TwoStageDB(self.banks[artist], **self._ts_kw)
        return self._ts_banks[artist]

    @property
    def artists(self) -> list[str]:
        return list(self.banks.keys())

    @classmethod
    def build(cls, catalog_by_artist: dict, cfg: HpfwConfig = DEFAULT_CONFIG,
              *, corpus_by_artist: dict | None = None,
              device: str | torch.device | None = None, **db_kw) -> "ArtistDB":
        """Learn one filter bank per artist and fingerprint their catalog,
        on device (default: the card; raises when torch sees none).

        catalog_by_artist: artist -> {track_id: pcm} or [pcm, ...].
        corpus_by_artist: optional separate training audio per artist
        (defaults to the artist's catalog, the paper's known-artist setup).
        """
        dev = torch.device(device) if device is not None else default_device()
        banks = {}
        for artist, catalog in catalog_by_artist.items():
            tracks = list(catalog.values()) if isinstance(catalog, dict) else list(catalog)
            corpus = (corpus_by_artist or {}).get(artist, tracks)
            filters = pca.learn_filters(corpus, cfg, device=dev)
            banks[artist] = api.build_db(catalog, filters, cfg, device=dev)
        return cls(cfg, banks, device=dev, **db_kw)

    def fingerprint(self, pcm: np.ndarray, artist: str) -> np.ndarray:
        """Query prints under one artist's bank."""
        return api.fingerprint(pcm, self.banks[artist].filters, self.cfg,
                               device=self.device)

    def match(self, query_pcm: np.ndarray, *, artist: str | None = None,
              top_k: int | None = None, pool: int | None = None):
        """Identify a query clip.

        Known artist: match within that artist's catalog; returns
        (track_ids, scores, offsets) like api.match.
        Unknown artist: extract under every bank (one CQT), match each
        catalog, and rank globally (descending score, then (artist,
        track_id)); returns (artist_track_pairs, scores, offsets) with pairs
        (artist, track_id). With scaled=True both modes go through the
        per-artist TwoStageDB (exact-on-pool; `pool` forwards to it).
        """
        top_k = top_k if top_k is not None else self.cfg.top_k
        if artist is not None:
            q = self.fingerprint(query_pcm, artist)
            if self.scaled:
                return self.two_stage(artist).match(q, top_k=top_k, pool=pool)
            return api.match(q, self.banks[artist], top_k=top_k)
        names = self.artists
        filter_stack = np.stack([self.banks[a].filters for a in names])
        prints = api.fingerprint_multi(query_pcm, filter_stack, self.cfg, device=self.device)
        rows = []
        for a, q in zip(names, prints):
            kk = min(top_k, self.banks[a].n_tracks)
            if self.scaled:
                ids, scores, offs = self.two_stage(a).match(q, top_k=kk, pool=pool)
            else:
                ids, scores, offs = api.match(q, self.banks[a], top_k=kk)
            rows += [((a, i), int(s), int(o)) for i, s, o in zip(ids, scores, offs)]
        rows.sort(key=lambda r: (-r[1], r[0]))
        rows = rows[:top_k]
        return ([r[0] for r in rows],
                np.array([r[1] for r in rows], np.int64),
                np.array([r[2] for r in rows], np.int64))

    def save(self, path: str) -> None:
        arrays = {"format_version": np.int32(1),
                  "config_json": np.frombuffer(self.cfg.to_json().encode(),
                                               dtype=np.uint8),
                  "artists": np.array(self.artists)}
        for i, db in enumerate(self.banks.values()):
            arrays[f"a{i}_filters"] = db.filters
            arrays[f"a{i}_track_ids"] = np.array(db.track_ids)
            arrays[f"a{i}_prints"] = db.prints
            arrays[f"a{i}_lengths"] = db.lengths
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str, *,
             device: str | torch.device | None = None) -> "ArtistDB":
        with np.load(path, allow_pickle=False) as z:
            if int(z["format_version"]) != 1:
                raise ValueError("unsupported ArtistDB format version")
            cfg = HpfwConfig.from_json(bytes(z["config_json"].tobytes()).decode())
            dev = torch.device(device) if device is not None else default_device()
            banks = {}
            for i, name in enumerate(str(a) for a in z["artists"]):
                banks[name] = FingerprintDB(
                    cfg, z[f"a{i}_filters"],
                    [str(t) for t in z[f"a{i}_track_ids"]],
                    z[f"a{i}_prints"], z[f"a{i}_lengths"], device=dev)
        return cls(cfg, banks, device=dev)
