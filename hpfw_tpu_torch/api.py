"""Public API of the PyTorch port; mirrors hpfw_tpu.api:

    fingerprint(audio)      -> hashprint sequence
    match(query, db)        -> ranked track IDs
    build_db(catalog)       -> FingerprintDB

Functions take and return numpy with the shapes and dtypes of hpfw_tpu.api
(prints are (N, 2) uint32). Work runs on an explicit device: the `device`
argument, else the device of the filters tensor or DB passed in, else the
CPU where numpy inputs live. On a CUDA device the hot path is the three
kernels in csrc/; on the CPU it is their plain PyTorch versions. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_CONFIG, HpfwConfig
from .filters import filters_from_jax
from .match import matcher
from .ops import fused


def _resolve_device(device, filters) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(filters, torch.Tensor):
        return filters.device
    return torch.device("cpu")


def _filters_on(filters, cfg: HpfwConfig, device: torch.device) -> torch.Tensor:
    if isinstance(filters, torch.Tensor):
        if tuple(filters.shape) != (cfg.context_dim, cfg.n_filters):
            raise ValueError(f"expected ({cfg.context_dim}, {cfg.n_filters}) "
                             f"filters, got {tuple(filters.shape)}")
        return filters.to(device=device, dtype=torch.float32).contiguous()
    return filters_from_jax(filters, cfg, device)


def _to_numpy_prints(prints: torch.Tensor) -> np.ndarray:
    """int32 prints on any device -> numpy uint32 with the same bits."""
    return prints.cpu().numpy().view(np.uint32)


def _to_tensor_prints(prints: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy uint32 prints -> int32 tensor on device with the same bits."""
    a = np.ascontiguousarray(np.asarray(prints, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(a).to(device)


def fingerprint(
    pcm: np.ndarray,
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
    bucket_s: float = 1.0,
) -> np.ndarray:
    """Audio -> packed 64-bit hashprints, shape (N, 2) uint32.

    bucket_s: input length is zero-padded up to this granularity, as in
    hpfw_tpu.api.fingerprint. EXACT: the first n_hashprints(true_len) prints
    depend only on samples within the true length, and only those are
    returned. bucket_s=0 disables.
    """
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    n_true = cfg.n_hashprints(pcm.shape[0])
    if n_true == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    if bucket_s:
        bucket = max(1, int(round(bucket_s * cfg.sample_rate)))
        padded = -(-pcm.shape[0] // bucket) * bucket
        if padded != pcm.shape[0]:
            pcm = np.concatenate([pcm, np.zeros(padded - pcm.shape[0], np.float32)])
    dev = _resolve_device(device, filters)
    out = fused.fingerprint(torch.from_numpy(pcm).to(dev),
                            _filters_on(filters, cfg, dev), cfg)
    return _to_numpy_prints(out[:n_true])


def fingerprint_batch_device(pcms: torch.Tensor, filters: torch.Tensor,
                             cfg: HpfwConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(B, S) float32 PCM tensor -> (B, N, 2) int32 prints on its device.

    One track at a time, so the working set is one track's spectrum (and, on
    the CPU, one track's frames) whatever B is.
    """
    n = cfg.n_hashprints(pcms.shape[1])
    if n == 0:
        return torch.zeros((pcms.shape[0], 0, 2), dtype=torch.int32,
                           device=pcms.device)
    return torch.stack([fused.fingerprint(p, filters, cfg) for p in pcms])


def fingerprint_batch(
    pcms: np.ndarray,
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Fingerprint a batch of equal-length tracks, shape (B, N, 2) uint32."""
    pcms = np.asarray(pcms, dtype=np.float32)
    if pcms.ndim != 2:
        raise ValueError(f"expected (B, S) PCM batch, got shape {pcms.shape}")
    dev = _resolve_device(device, filters)
    out = fingerprint_batch_device(torch.from_numpy(pcms).to(dev),
                                   _filters_on(filters, cfg, dev), cfg)
    return _to_numpy_prints(out)


def match(
    query_prints: np.ndarray,
    db: "FingerprintDB",
    *,
    top_k: int | None = None,
):
    """Rank DB tracks against a query print sequence, on the DB's device.

    Returns (track_ids, scores, offsets) sorted by descending similarity,
    ties broken by ascending track index — identical to oracle.match.
    """
    top_k = top_k if top_k is not None else db.cfg.top_k
    prints, lengths = db.device_arrays()
    q = _to_tensor_prints(query_prints, prints.device)
    if q.shape[0] > prints.shape[1]:
        # Oracle semantics for tracks shorter than the query are truncated
        # head overlap at offset 0; padding the print array up to the query
        # length makes the masked scan reproduce that exactly.
        pad = prints.new_zeros((prints.shape[0], q.shape[0] - prints.shape[1], 2))
        prints = torch.cat([prints, pad], dim=1)
    scores, offsets = matcher.score_tracks(q, prints, lengths)
    both = torch.stack([scores, offsets]).cpu().numpy()
    order, s, o = matcher.rank(both[0], both[1], top_k)
    return [db.track_ids[i] for i in order], s, o


class FingerprintDB:
    """In-memory fingerprint database: packed prints + config + filters.

    Saves and loads the same format_version=1 .npz as hpfw_tpu.api's
    FingerprintDB, and holds its device arrays on `device`.
    """

    def __init__(self, cfg: HpfwConfig, filters: np.ndarray,
                 track_ids: list[str], prints: np.ndarray, lengths: np.ndarray,
                 *, device: str | torch.device = "cpu"):
        self.cfg = cfg
        self.filters = np.asarray(filters, dtype=np.float32)
        self.track_ids = list(track_ids)
        self.prints = np.asarray(prints, dtype=np.uint32)    # (T, L, 2) padded
        self.lengths = np.asarray(lengths, dtype=np.int32)   # (T,)
        self.device = torch.device(device)
        t = len(self.track_ids)
        if self.prints.ndim != 3 or self.prints.shape[0] != t or self.prints.shape[2] != 2:
            raise ValueError(f"prints must be ({t}, L, 2), got {self.prints.shape}")
        if self.lengths.shape != (t,):
            raise ValueError(f"lengths must be ({t},), got {self.lengths.shape}")
        if t and (self.lengths.min() < 0 or self.lengths.max() > self.prints.shape[1]):
            raise ValueError("track lengths must lie in [0, L]")
        self._device_arrays = None
        self._id_index = None

    def index_of(self, track_id: str) -> int:
        """Track-id -> row index."""
        if self._id_index is None:
            self._id_index = {t: i for i, t in enumerate(self.track_ids)}
        return self._id_index[track_id]

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(T, L, 2) int32 prints and (T,) int32 lengths on self.device."""
        if self._device_arrays is None:
            self._device_arrays = (_to_tensor_prints(self.prints, self.device),
                                   torch.from_numpy(self.lengths).to(self.device))
        return self._device_arrays

    @property
    def n_tracks(self) -> int:
        return len(self.track_ids)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            format_version=np.int32(1),
            config_json=np.frombuffer(self.cfg.to_json().encode(), dtype=np.uint8),
            filters=self.filters,
            track_ids=np.array(self.track_ids),
            prints=self.prints,
            lengths=self.lengths,
        )

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = "cpu") -> "FingerprintDB":
        with np.load(path, allow_pickle=False) as z:
            if int(z["format_version"]) != 1:
                raise ValueError(
                    f"unsupported DB format version {int(z['format_version'])}")
            cfg = HpfwConfig.from_json(bytes(z["config_json"].tobytes()).decode())
            return cls(cfg, z["filters"], [str(t) for t in z["track_ids"]],
                       z["prints"], z["lengths"], device=device)


def build_db(
    catalog: dict[str, np.ndarray] | list[np.ndarray],
    filters,
    cfg: HpfwConfig = DEFAULT_CONFIG,
    *,
    device: str | torch.device | None = None,
) -> FingerprintDB:
    """Fingerprint a catalog of tracks into a matchable database on device."""
    if isinstance(catalog, dict):
        ids, tracks = list(catalog.keys()), list(catalog.values())
    else:
        ids = [str(i) for i in range(len(catalog))]
        tracks = list(catalog)
    dev = _resolve_device(device, filters)
    filt = _filters_on(filters, cfg, dev)
    fps = [fingerprint(t, filt, cfg, device=dev) for t in tracks]
    prints, lengths = matcher.pad_prints(fps, min_len=1)
    host_filters = filt.cpu().numpy()
    return FingerprintDB(cfg, host_filters, ids, prints, lengths, device=dev)
