"""Device mesh, sharding and the process group: the port's counterpart of
percepnet_tpu/parallel/mesh.py.

The JAX package runs one SPMD program over a `jax.sharding.Mesh`: a
batch-sharded leading axis, replicated parameters, and the collectives
that `jit` inserts.  PyTorch's idiom splits that in two:

  - **In one process, a mesh of devices** (serving): `Mesh` is an ordered
    list of shard devices; shard i holds the i-th contiguous range of the
    leading (slot) axis, as `P('dp')` lays it out, and its own copy of
    the parameters.  A device may appear more than once, which gives two
    shards on one card (or on the CPU).
  - **Across processes, one process per card** (training): a
    `torch.distributed` process group; each rank holds its own local
    batch, the global batch is their concatenation in rank order (JAX's
    `make_array_from_process_local_data` contract), and the gradients are
    averaged with one all-reduce (`all_reduce_mean_`).

With no process group, `process_index()` is 0, `process_count()` is 1,
and `all_reduce_mean_` and `broadcast_` do nothing.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from percepnet_tpu_torch.ops.dispatch import resolve_device

DATA_AXIS = "dp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh, axis DATA_AXIS: the shard devices, in
    shard order."""
    devices: tuple[torch.device, ...]

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """A mesh over every visible CUDA device, or over the given devices
    (repeats allowed).  Raises when a card is asked for and none is
    there."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the "
                               "mesh's devices (e.g. ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def batch_sharding(mesh: Mesh, n: int) -> list[slice]:
    """Shard i's range of a leading axis of length n: the i-th of
    len(mesh) equal contiguous ranges, as P('dp') lays them out."""
    k = len(mesh)
    if n % k:
        raise ValueError(f"a leading axis of {n} does not divide across "
                         f"{k} shards")
    per = n // k
    return [slice(i * per, (i + 1) * per) for i in range(k)]


def replicated_sharding(mesh: Mesh) -> list[slice]:
    """Every shard holds the whole leading axis."""
    return [slice(None)] * len(mesh)


def tree_map(fn, tree):
    """fn over the tensor and array leaves of nested tuples (named too),
    lists and dicts."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


def _copy_to(x, dev: torch.device) -> torch.Tensor:
    """A copy of x (tensor or array) on dev: a shard never aliases the
    batch it came from, as a device_put does not."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, copy=True)


def shard_batch(mesh: Mesh, tree) -> list[Any]:
    """The tree's leading axis split over the mesh: one tree per shard,
    on its device.

    In a process group each rank passes its OWN local batch, and the
    global batch is the concatenation in rank order; the rank's mesh is
    its one device, which keeps the whole local batch."""
    if process_count() > 1:
        if len(mesh) != 1:
            raise ValueError("in a process group each rank's mesh is its "
                             "one device")
        return [tree_map(lambda x: _copy_to(x, mesh.devices[0]), tree)]
    leaves: list = []
    tree_map(leaves.append, tree)
    if not leaves:
        return [tree] * len(mesh)
    ranges = batch_sharding(mesh, leaves[0].shape[0])
    return [tree_map(lambda x, sl=sl, dev=dev: _copy_to(x[sl], dev), tree)
            for sl, dev in zip(ranges, mesh.devices)]


def replicate(mesh: Mesh, tree):
    """One copy per shard, on its device: of a module (deep-copied, so no
    two shards share a parameter) or of a tensor tree."""
    if isinstance(tree, torch.nn.Module):
        return [copy.deepcopy(tree).to(dev) for dev in mesh.devices]
    return [tree_map(lambda x, dev=dev: _copy_to(x, dev), tree)
            for dev in mesh.devices]


# --- the process group -------------------------------------------------------
def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: str | torch.device = "cuda", *,
                     backend: str | None = None) -> torch.device:
    """Join the process group at tcp://<coordinator> (host:port, served by
    rank 0) as rank `process_id` of `num_processes`; returns this rank's
    device.

    On the card the rank takes cuda:{process_id % device_count} (unless
    `device` names one), set as the current device before the group is
    made, and the backend is NCCL; on the CPU it is gloo.  `backend`
    overrides that, for callers that put several ranks on one card (NCCL
    refuses two ranks on one device; gloo moves CUDA tensors through the
    host).  A missing card raises; nothing falls back."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside a world of "
                         f"{num_processes}")
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dev


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if in_group() else 0


def process_count() -> int:
    return dist.get_world_size() if in_group() else 1


def barrier() -> None:
    """Wait for every rank (no-op without a group)."""
    if not in_group():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor, in place, by its mean over the ranks: one flat
    buffer, one all_reduce (sum), divided by the world size.  The tensors
    share one floating dtype and device.  No-op without a group."""
    if not in_group() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor, in place, with rank `src`'s (bool tensors
    travel as uint8).  No-op without a group."""
    if not in_group():
        return
    for t in tensors:
        if t.dtype == torch.bool:
            u = t.to(torch.uint8)
            dist.broadcast(u, src)
            t.copy_(u.bool())
        else:
            dist.broadcast(t, src)
