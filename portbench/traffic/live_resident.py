"""Live song ID against a catalog resident on the card: live's open loop of
PCM queries into EscalatingMatchServer, over batch_resident's catalog.

Set-up builds batch_resident's catalog (its bits at the same seed and
sizes) and the same resident FingerprintDB and TwoStageDB, with no host
copy of the catalog's prints: catalog.live_queries reads the planted rows'
prints only, through a host copy of those rows. The server, its warm-up and
burst, the window, the sample of answered requests and the comparison and
its limits are live's; the check's reference catalog is built over the same
device prints once release has dropped the system, as batch_resident's. The
control is live's, over this catalog.
"""

from __future__ import annotations

import numpy as np

from .. import catalog, synth
from . import batch_resident, live

window, release = live.window, live.release


class PlantedRows:
    """A host view of the planted rows of device prints: indexed by catalog
    rows, as catalog.live_queries indexes the host prints, it gives their
    uint32 prints; any other row raises."""

    def __init__(self, prints, rows: np.ndarray):
        self.order = np.argsort(rows)
        self.rows = rows[self.order]
        self.host = synth.to_host_u32(prints[rows[self.order]])

    def __getitem__(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        at = np.searchsorted(self.rows, rows).clip(0, len(self.rows) - 1)
        if not np.array_equal(self.rows[at], rows):
            raise KeyError("only the planted rows are held on the host")
        return self.host[at]


def queries(run, cat: dict):
    """catalog.live_queries over the resident catalog: (PCM, rows, renditions)."""
    view = dict(cat, prints=PlantedRows(cat["prints"], cat["rows"]),
                lengths=cat["lengths"].cpu().numpy())
    return catalog.live_queries(run, view)


def setup(run) -> None:
    from hpfw_tpu_torch import EscalatingMatchServer, FingerprintDB, HpfwConfig, TwoStageDB

    c = run.config
    cat = batch_resident.build(run)
    db = FingerprintDB(HpfwConfig(**c["hpfw"]), cat["filters"].cpu().numpy(),
                       [str(i) for i in range(c["n_tracks"])], cat["prints"], cat["lengths"],
                       device=run.device)
    ts = TwoStageDB(db)
    pcm, rows, _ = queries(run, cat)
    srv = EscalatingMatchServer(ts, cat["filters"], pcm.shape[1], **c["server"])
    srv.warmup(pcm[0])
    # One burst through the whole path (rank workers, callbacks, a scan).
    for f in [srv.submit(x) for x in pcm[:c["server"]["max_batch"]]]:
        f.result(timeout=live.WAIT_AFTER_S)
    run.state.update(catalog=cat, server=srv, ts=ts, pcm=pcm, rows=rows)


def check(run) -> dict:
    batch_resident.reference_catalog(run)
    return live.check(run)


def control(run) -> dict:
    """The TF32 reference's readings on check_requests queries of the pool."""
    cat = batch_resident.build(run)
    pcm, rows, rend = queries(run, cat)
    run.state.update(catalog=cat, pcm=pcm)
    batch_resident.reference_catalog(run)
    rng, m = np.random.default_rng(run.seed + 1), run.workload["check_requests"]
    take = list(rng.permutation(np.flatnonzero(rend))[:m // 2])
    take += list(rng.permutation(np.flatnonzero(~rend))[:m - len(take)])
    clips = [pcm[i] for i in take]
    want = live.reference(run, clips)
    ctl = live.reference(run, clips, tf32=True)
    return {"score_gap": max(live.gaps(run, ctl, want, rows[take])),
            "escalation_mismatches": float(live.escalation_mismatches(run, ctl, want))}
