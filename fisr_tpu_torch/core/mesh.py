"""Device mesh, shardings and collectives over process groups (port of
fisr_tpu/core/mesh.py).

The JAX mesh is single-controller: one process drives every device, and a
sharding tells XLA where each block of an array lives. PyTorch runs one
process a card, so here the mesh is a `torch.distributed.device_mesh.DeviceMesh`
over the default process group, one rank a device, with the same two axes:

* axis 'data'    - batch (DP): parameters replicated, the batch cut into
                   contiguous row blocks, gradients averaged over the axis
                   before the optimizer step (train/*: `mesh=`);
* axis 'spatial' - image width (SP): each rank holds a strip and swaps
                   `boundary`-pixel halos with its neighbours
                   (infer/sharded.py).

Every function computes on plain local tensors on the rank's device (no
DTensor: the cost-volume autograd.Function and the cuDNN convolutions see
ordinary tensors). Collectives run through `torch.distributed` on the axis's
group: `ppermute`, `all_reduce_mean_`, `mean_metrics`, `broadcast_from` and
`all_gather_axis` are the few `jax.lax` collectives the JAX code reaches, and
`all_gather_axis` also gives a caller the whole array, as `np.asarray` of a
sharded JAX array does.

A world of more than one rank is started by its launcher (`torchrun`, or
`torch.multiprocessing` with its own `init_process_group`); `make_mesh`
builds the mesh over the default group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from fisr_tpu_torch.device import resolve_device

__all__ = ["DATA_AXIS", "SPATIAL_AXIS", "make_mesh", "mesh_device", "axis_size", "axis_index",
           "Shard", "axis_sharding", "data_sharding", "replicated", "shard_batch", "ppermute",
           "all_reduce_mean_", "average_gradients_", "mean_metrics", "broadcast_from",
           "all_gather_axis", "barrier"]

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, SPATIAL_AXIS),
              devices: Optional[Sequence[int]] = None, device="cuda") -> DeviceMesh:
    """A mesh over the ranks of the default process group.

    Default: every rank on the leading axis, 1 on the rest; shape=(2, 4)
    gives a 2-way DP x 4-way spatial mesh. `devices` are the global ranks to
    span (default all, in order), as the JAX package's device list; a shape
    that needs more of them than there are raises ValueError. `device` is
    the ranks' device type: "cuda" (each rank on its current card) or "cpu".

    With no default group initialized, this starts one (NCCL for "cuda",
    gloo for "cpu"): from a launcher's environment where WORLD_SIZE > 1
    (`torchrun`: each rank on card LOCAL_RANK), else a one-rank group on an
    in-memory store (`dist.HashStore`).
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(ranks):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(ranks)}")
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(dev.type, grid, mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """`jax.lax.axis_index`: this rank's coordinate along `axis` (its place
    in the mesh; a process group numbers its members in sorted order, which
    differs where `devices` was not sorted)."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def _axis_ranks(mesh: DeviceMesh, axis: str) -> List[int]:
    """The global ranks along `axis` through this rank, in axis order."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(axis)] = slice(None)
    return [int(r) for r in mesh.mesh[tuple(coord)]]


def _global_rank(mesh: DeviceMesh, axis: str, index: int) -> int:
    """The global rank at `index` along `axis` (collectives take global ranks)."""
    return _axis_ranks(mesh, axis)[index]


@dataclasses.dataclass(frozen=True)
class Shard:
    """Block `index` of `count` equal contiguous blocks along dimension
    `dim`: what a rank holds of an array sharded over one mesh axis. Calling
    it on a numpy array or a tensor returns that block (a view); an extent
    that `count` does not divide raises ValueError, as a JAX sharding of it
    does."""

    index: int
    count: int
    dim: int = 0
    ndim: Optional[int] = None

    def __call__(self, x):
        if self.ndim is not None and x.ndim != self.ndim:
            raise ValueError(f"sharding for {self.ndim}-dim arrays got shape {tuple(x.shape)}")
        n = x.shape[self.dim]
        if n % self.count:
            raise ValueError(f"dimension {self.dim} of shape {tuple(x.shape)} does not divide "
                             f"over {self.count} ranks")
        k = n // self.count
        return x[(slice(None),) * self.dim + (slice(self.index * k, (self.index + 1) * k),)]


def axis_sharding(mesh: DeviceMesh, axis: str, dim: int, ndim: Optional[int] = None) -> Shard:
    """This rank's block of dimension `dim` split over `axis`."""
    return Shard(axis_index(mesh, axis), axis_size(mesh, axis), dim, ndim)


def data_sharding(mesh: DeviceMesh, ndim: int, axis: str = DATA_AXIS) -> Shard:
    """Batch-axis sharding for an `ndim`-dim array: this rank's rows."""
    return axis_sharding(mesh, axis, 0, ndim)


def _as_local(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device)


def shard_batch(batch: dict, mesh: DeviceMesh, axis: str = DATA_AXIS) -> dict:
    """Every array of a global batch (numpy or tensors), cut to this rank's
    rows along `axis` and moved to the rank's device."""
    dev = mesh_device(mesh)
    return {k: _as_local(data_sharding(mesh, v.ndim, axis)(v), dev) for k, v in batch.items()}


def _state_tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    return [v for state in obj.state.values() for v in state.values()
            if isinstance(v, torch.Tensor)]


@torch.no_grad()
def replicated(mesh: DeviceMesh, *objs, axis: str = DATA_AXIS) -> None:
    """Make every rank of `axis` hold the state of its first rank: each
    module's parameters and buffers, and each optimizer's per-parameter
    state and its step `count` (where it has one), broadcast in place."""
    src = _global_rank(mesh, axis, 0)
    group = mesh.get_group(axis)
    for obj in objs:
        for t in _state_tensors(obj):
            dist.broadcast(t, src, group=group)
        if hasattr(obj, "count"):
            count = torch.tensor([obj.count], dtype=torch.int64, device=mesh_device(mesh))
            dist.broadcast(count, src, group=group)
            obj.count = int(count.item())


def ppermute(xs, mesh: DeviceMesh, axis: str, perm: Sequence[tuple]):
    """`jax.lax.ppermute` over `axis`: for each (src, dst) pair of axis
    indices, src's tensors go to dst. Returns what this rank received (a
    tensor, or a list for a list), zeros where no pair sends to it, as in
    JAX. Tensors are sent contiguous; P2P ops take global ranks, so each
    axis index is mapped through the axis's group. A pair (i, i) is a copy:
    no rank posts a send to itself (which hangs under NCCL)."""
    single = isinstance(xs, torch.Tensor)
    xs = [xs] if single else list(xs)
    me = axis_index(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = [torch.zeros_like(x) for x in xs]
    ops = []
    if dst and dst[0] != me:
        peer = _global_rank(mesh, axis, dst[0])
        ops += [dist.P2POp(dist.isend, x.contiguous(), peer, mesh.get_group(axis)) for x in xs]
    if src and src[0] == me:
        out = [x.clone() for x in xs]
    elif src:
        peer = _global_rank(mesh, axis, src[0])
        ops += [dist.P2POp(dist.irecv, o, peer, mesh.get_group(axis)) for o in out]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out[0] if single else out


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh: DeviceMesh,
                     axis: str = DATA_AXIS) -> None:
    """Replace each tensor by its mean over `axis`, in place: one sum
    all-reduce a dtype over a flat buffer, then a division by the axis size
    (every rank gets the same bits)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    n = axis_size(mesh, axis)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=mesh.get_group(axis))
        flat.div_(n)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def average_gradients_(params: Iterable[torch.Tensor], mesh: DeviceMesh,
                       axis: str = DATA_AXIS) -> None:
    """The data-parallel gradient: each trainable parameter's gradient
    replaced by its mean over `axis` (parameters with requires_grad=False,
    or without a gradient, are left out). Every loss of the train steps is a
    mean over the batch, so with equal shards this is the gradient of the
    global batch."""
    all_reduce_mean_([p.grad for p in params if p.requires_grad and p.grad is not None],
                     mesh, axis)


def mean_metrics(metrics: Dict[str, torch.Tensor], mesh: DeviceMesh,
                 axis: str = DATA_AXIS) -> Dict[str, torch.Tensor]:
    """0-dim metric tensors averaged over `axis`, in one all-reduce: with
    equal shards, the global batch's values of per-batch means."""
    stacked = torch.stack([v.detach().float() for v in metrics.values()])
    all_reduce_mean_([stacked], mesh, axis)
    return dict(zip(metrics, stacked.unbind()))


@torch.no_grad()
def broadcast_from(xs, mesh: DeviceMesh, axis: str, index: int):
    """Every rank of `axis` takes the tensors of the rank at `index`, in
    place (each must be contiguous, of the same shape on every rank)."""
    group = mesh.get_group(axis)
    src = _global_rank(mesh, axis, index)
    for x in ([xs] if isinstance(xs, torch.Tensor) else xs):
        dist.broadcast(x, src, group=group)
    return xs


def all_gather_axis(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The whole array from each rank's block along `dim` (blocks of equal
    shape, in axis order): what `np.asarray` of a sharded JAX array gives."""
    group = mesh.get_group(axis)
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=group)
    ranks = _axis_ranks(mesh, axis)  # the group's order is sorted, the axis's need not be
    order = sorted(range(len(parts)), key=lambda i: ranks.index(dist.get_global_rank(group, i)))
    return torch.cat([parts[i] for i in order], dim)


def barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the default group."""
    if mesh.device_type == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
