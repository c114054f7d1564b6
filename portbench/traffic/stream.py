"""Catalog ingest: a closed loop of api.fingerprint_stream over host batches.

host_batches distinct batches of batch_size whole tracks of track_seconds,
rendered on the card at set-up and copied to the host once, are fed to
fingerprint_stream in a cycle; it keeps two batches in flight and yields each
batch's prints on the host. extract_rtf is the audio seconds whose prints came
back in the window over the window's seconds, the window ending with the
first batch back after --seconds.

The comparison: check_batches of the window's results, drawn from the seed
(a reservoir sample), are extracted again by the plain reference.
bit_diff_share is the largest share of a track's bits that differ;
worst_print_bits the most bits that differ in one print.

The control: the reference's prints with TF32 products (the configuration
states float32 prints) on check_batches host batches, held to the float32
reference by both numbers.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from .. import synth
from ..reference import extract, matcher


def inputs(run) -> tuple[torch.Tensor, list]:
    """The filters (device) and host_batches (batch_size, samples) float32 host
    batches of whole tracks, rendered on the device."""
    c, dev = run.config, run.device
    p = c["hpfw"]
    g = synth.generator(run.seed, 1, dev)
    filters = synth.filters(g, p["n_bins"] * p["context_w"], p["n_filters"], dev)
    params = synth.score_params(g, c["host_batches"] * c["batch_size"], dev)
    b = c["batch_size"]
    pool = [synth.catalog_tracks(params[i * b:(i + 1) * b], g, sr=p["sample_rate"],
                                 duration_s=c["track_seconds"], fmin=p["fmin"]).cpu().numpy()
            for i in range(c["host_batches"])]
    return filters, pool


def setup(run) -> None:
    from hpfw_tpu_torch import HpfwConfig, fingerprint_stream

    cfg = HpfwConfig(**run.config["hpfw"])
    filters, pool = inputs(run)
    for _ in fingerprint_stream(pool[:3], filters, cfg, device=run.device):
        pass
    run.state.update(cfg=cfg, filters=filters, pool=pool)


def window(run) -> None:
    from hpfw_tpu_torch import fingerprint_stream

    c, w = run.config, run.workload
    cfg, filters, pool = run.state["cfg"], run.state["filters"], run.state["pool"]
    rng = np.random.default_rng(run.seed)
    order = rng.permutation(len(pool))
    k = w["check_batches"]
    kept: list = []
    feed = (pool[int(order[i % len(pool)])] for i in itertools.count())
    t0 = run.window_starts()
    count, t_end = 0, t0
    for out in fingerprint_stream(feed, filters, cfg, device=run.device):
        t_end = time.perf_counter()
        j = int(order[count % len(pool)])
        if len(kept) < k:
            kept.append((j, out))
        elif rng.random() < k / (count + 1):
            kept[int(rng.integers(k))] = (j, out)
        count += 1
        if t_end - t0 >= run.seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    b = pool[0].shape[0]
    run.records.update(attempted=count * b, failed=0, batches=count, window_s=t_end - t0,
                       audio_s=count * b * c["track_seconds"], kept=kept)


def release(run) -> None:
    pass


def reference(run, pcms: np.ndarray, tf32: bool = False) -> list:
    """The plain reference's prints of (B, S) PCM (float32, or TF32: the control)."""
    p, filters, dev = run.config["hpfw"], run.state["filters"], run.device
    with extract.matmul_precision(tf32):
        return [extract.prints(torch.from_numpy(x).to(dev), filters, p) for x in pcms]


def differences(run, got: list, want: list) -> tuple[float, int]:
    """(the largest share of a track's bits that differ, the most bits that
    differ in one print); (1, 64) where shapes differ or nothing was compared."""
    share, worst = (0.0, 0) if want else (1.0, 64)
    for g, w in zip(got, want):
        mine = torch.from_numpy(np.ascontiguousarray(g).view(np.int32)).to(run.device)
        if mine.shape != w.shape:
            return 1.0, 64
        bits = matcher.popcount((mine.to(torch.int64) ^ w.to(torch.int64))
                                & 0xFFFFFFFF).sum(dim=1)
        share = max(share, float(bits.sum()) / (64.0 * w.shape[0]))
        worst = max(worst, int(bits.max()))
    return share, worst


def control(run) -> dict:
    """The TF32 reference's readings on check_batches of the host batches."""
    filters, pool = inputs(run)
    run.state["filters"] = filters
    rng = np.random.default_rng(run.seed + 1)
    pcms = np.concatenate([pool[i] for i in rng.choice(len(pool), run.workload["check_batches"],
                                                       replace=False)])
    want = reference(run, pcms)
    ctl = [x.cpu().numpy().view(np.uint32) for x in reference(run, pcms, tf32=True)]
    share, worst = differences(run, ctl, want)
    return {"bit_diff_share": share, "worst_print_bits": float(worst)}


def check(run) -> dict:
    lim, kept, pool = run.workload["limits"], run.records["kept"], run.state["pool"]
    got = [x for _, out in kept for x in out]
    want = [w for j, _ in kept for w in reference(run, pool[j])]
    share, worst = differences(run, got, want)
    run.records["checked"] = len(got)
    return {"bit_diff_share": (share, lim["bit_diff_share"]),
            "worst_print_bits": (float(worst), lim["worst_print_bits"])}
