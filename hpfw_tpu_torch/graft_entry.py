"""Entry points of the port: the main path's forward step and the dry run.

Counterpart of __graft_entry__.py. entry() returns the forward step of the
flagship pipeline (PCM -> packed 64-bit hashprints: the CQT front end, K1 on
the card, then the hashprint encoder, K2) with example arguments made as the
reference makes them, for one 10 s query (BASELINE config 1). On the card by
default (raises when torch sees none); device="cpu" runs the plain versions.

    from hpfw_tpu_torch.graft_entry import entry
    forward, args = entry()
    prints = forward(*args)        # (380, 2) int32 on the card

dryrun_multichip is parallel/dryrun.py's, the reference's five distributed
steps on a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import default_device
from .config import HpfwConfig
from .ops import fingerprint as fp_ops
from .ops import frontend
from .parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]


def entry(device: str | torch.device | None = None):
    """(forward, (pcm, filters)): forward(pcm, filters) -> (N, 2) int32
    hashprints on the arguments' device, N = cfg.n_hashprints(10 s). pcm is
    (220,500,) float32 and filters (context_dim, 64) float32, both drawn from
    numpy's default_rng(0) as __graft_entry__.entry() draws them."""
    dev = torch.device(device) if device is not None else default_device()
    cfg = HpfwConfig()
    n_samples = 10 * cfg.sample_rate  # one 10 s query (BASELINE config 1)
    rng = np.random.default_rng(0)
    pcm = rng.standard_normal(n_samples).astype(np.float32)
    filters = (rng.standard_normal((cfg.context_dim, cfg.n_filters)) /
               np.sqrt(cfg.context_dim)).astype(np.float32)

    def forward(pcm, filters):
        spec = frontend.cqt(pcm, cfg)
        return fp_ops.fingerprint_from_spec(spec, filters, cfg)

    return forward, (torch.from_numpy(pcm).to(dev), torch.from_numpy(filters).to(dev))
