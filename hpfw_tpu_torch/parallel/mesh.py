"""Device mesh of the track-sharded matchers.

Counterpart of hpfw_tpu/parallel/mesh.py. Sharding is single-controller, as
in the reference, where one process drives every device through shard_map:
one process queues every shard's work from one thread, with no process group.
The track axis is split into contiguous shards, one a mesh entry; the query
is replicated; each shard scans its own tracks and keeps a fixed-size block
of candidates; and the blocks are gathered onto the mesh's first device in
shard order, the counterpart of the reference's tiled all_gather. A shard's
global track index is shard * tracks a shard + its local index.

A Mesh is an ordered list of torch devices and may name one device more
than once ("logical shards"): the CPU tests build 8 shards on `cpu`, as the
reference's tests simulate 8 devices, and one card carries several shards
on cuda:0. Every shard then runs the real per-shard kernels and the real
gather; only the spread over cards differs. db_mesh() takes the first n
CUDA devices and never falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _checked(device) -> torch.device:
    """A mesh entry; a CUDA device that torch does not see raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = dev.index
    if index is None:
        index = torch.cuda.current_device() if have else 0
    if index >= have:
        raise ValueError(f"the mesh names cuda:{index}; torch sees {have} CUDA devices")
    return torch.device("cuda", index)


class Mesh:
    """A 1-D mesh over the database's track axis: an ordered list of devices,
    one a shard (a device may repeat). `size` is the counterpart of the
    reference's mesh.devices.size."""

    def __init__(self, devices):
        self.devices = tuple(_checked(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where the shards' candidate blocks are gathered."""
        return self.devices[0]

    @property
    def distinct(self) -> list[torch.device]:
        """Each device of the mesh once, in order of first appearance."""
        return list(dict.fromkeys(self.devices))


def db_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first n CUDA devices (default: all of them)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices if n_devices is not None else have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def pad_tracks_to_mesh(n_tracks: int, mesh: Mesh) -> int:
    """Tracks must divide evenly over the mesh; returns the padded count."""
    n = mesh.size
    return -(-n_tracks // n) * n


def split_tracks(x, mesh: Mesh) -> list[torch.Tensor]:
    """A track-major array (numpy or torch, leading dimension a multiple of
    the mesh size) -> one contiguous tensor a shard, shard i on mesh entry
    i. A numpy array is uploaded a shard at a time; a shard that stays on
    its array's device is a view."""
    n = x.shape[0] // mesh.size
    if n * mesh.size != x.shape[0]:
        raise ValueError(f"{x.shape[0]} tracks do not split over {mesh.size} shards")
    out = []
    for i, dev in enumerate(mesh.devices):
        part = x[i * n:(i + 1) * n]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out.append(part.to(dev).contiguous())
    return out


def gather_blocks(blocks: list[torch.Tensor], mesh: Mesh, dim: int) -> torch.Tensor:
    """Concatenate the shards' fixed-size blocks along dim on the mesh's first
    device, in shard order. A block on another device is copied there by
    Tensor.to, which queues the copy after the work queued so far on the
    block's device (its current stream) and makes the first device's
    current stream wait for the copy; no host sync."""
    first = mesh.first
    return torch.cat([b.to(first) for b in blocks], dim=dim)
