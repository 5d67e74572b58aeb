"""Data-parallel scale-out over a list of devices.  Port of
salt_tpu/parallel/mesh.py.

The workload is embarrassingly parallel over reads: the read batch is
split evenly over the devices of the mesh and the index is replicated
(small genomes) or sharded by reference bin (large genomes,
sharded_engine.py).  The SE step has no cross-read dependencies, so each
device runs it on its rows and the results are joined on devices[0] in
row order.  A mesh is a Python list of torch devices, driven by one
process; the same device may occur more than once, and then holds one
copy of the index.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..pipeline.device_index import DeviceIndex
from ..pipeline.engine import checked_device
from ..pipeline.se import se_gapped, se_ungapped


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> List[torch.device]:
    """`n_devices` devices of the given kind: every visible CUDA device by
    default (asking for CUDA without one raises), taken in turn again when
    more are asked for than exist; for the CPU, n_devices (default 1)
    entries that all name it."""
    kind = checked_device(device).type
    if kind == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(kind)]
    n = len(devs) if n_devices is None else n_devices
    return [devs[i % len(devs)] for i in range(n)]


def shard_reads(mesh, arr: torch.Tensor) -> List[torch.Tensor]:
    """The rows of a (B, L) read batch split evenly over the mesh, part i
    on mesh[i]; the batch must divide the mesh size."""
    if arr.shape[0] % len(mesh):
        raise ValueError(f"a batch of {arr.shape[0]} reads does not divide "
                         f"over {len(mesh)} devices")
    return [part.to(dev) for part, dev in zip(arr.chunk(len(mesh)), mesh)]


def replicate(mesh, dix: DeviceIndex) -> List[DeviceIndex]:
    """The index on every device of the mesh: one copy a distinct device,
    shared by the entries that name it."""
    copies = {}
    for dev in mesh:
        dev = torch.device(dev)
        if dev not in copies:
            copies[dev] = dix.to(dev)
    return [copies[torch.device(dev)] for dev in mesh]


def _joined(parts, device):
    """Per-device results (tensors in nested named tuples) on `device`,
    concatenated in row order."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts], 0)
    return type(first)(*(_joined(field, device) for field in zip(*parts)))


def sharded_se_ungapped(mesh, dix: DeviceIndex, seq_f, seq_r, **kw):
    """Data-parallel SE ungapped step over the mesh."""
    parts = [se_ungapped(d, f, r, **kw)
             for d, f, r in zip(replicate(mesh, dix), shard_reads(mesh, seq_f),
                                shard_reads(mesh, seq_r))]
    return _joined(parts, mesh[0])


def sharded_full_step(mesh, dix: DeviceIndex, seq_f, seq_r, *,
                      l_overlap, max_seed, max_locate, cap, u=64,
                      k_hits=16, gap_k=10):
    """One full SE alignment step (ungapped + gapped verify for every
    read) with the rows split over the mesh.  Returns (UngappedOut,
    GappedOut) on mesh[0]."""
    outs, gaps = [], []
    for d, f, r in zip(replicate(mesh, dix), shard_reads(mesh, seq_f),
                       shard_reads(mesh, seq_r)):
        out = se_ungapped(
            d, f, r, l_overlap=l_overlap, max_seed=max_seed,
            max_locate=max_locate, cap=cap, u=u, k_hits=k_hits,
        )
        outs.append(out)
        gaps.append(se_gapped(d, f, r, out.loci0, out.loci1, k=gap_k, u=u,
                              k_hits=k_hits))
    return _joined(outs, mesh[0]), _joined(gaps, mesh[0])
