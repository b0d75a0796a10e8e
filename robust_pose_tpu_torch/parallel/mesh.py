"""The data-parallel context of training (port of
``robust_pose_tpu/parallel/mesh.py``).

The JAX package trains SPMD: one program over the global batch, the batch
sharded over the ``data`` axis of a 1-D mesh, the state replicated, and
XLA inserts the reductions. Here a world of W processes (one a card, or
several on one card under gloo) holds B / W rows of a global batch B each
and a replica of the state, and ``train.trainer.PoseNetTrainer`` makes its
step the one-process step on the whole batch with these collectives:

* ``all_reduce_sum``: the heads' train-mode BatchNorm statistics, summed
  over ranks, differentiable (its backward sums the cotangents);
* ``mean_bucket``: the gradients, one flat bucket averaged over ranks;
* ``all_gather_rows``: per-sample losses and LM iteration counts, in rank
  order;
* ``replicate``: the initial state, broadcast from rank 0.

Launch with ``torchrun --nproc_per_node N`` (``make_mesh()`` reads RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or explicitly,
``make_mesh(device, init_method="tcp://127.0.0.1:<port>", rank=r,
world_size=W)``. Without either it is a world of 1 with no process group
and no collective.

The backend is NCCL on the card and gloo on the CPU. NCCL runs one rank a
card; several ranks on one card must ask for gloo and name their device.
gloo's collectives take host tensors here: a CUDA tensor goes through a
host copy (``_on_host``), so the compute stays on the card and only the
collective's data crosses.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from robust_pose_tpu_torch.device import resolve_device

Tensor = torch.Tensor

TIMEOUT_S = 1800               # a collective that waits longer raises


@dataclasses.dataclass
class Mesh:
    """A rank's view of the data-parallel world.

    :param world_size: processes in the world
    :param rank: this process's rank
    :param device: where this rank computes
    :param group: the process group, None for a world of 1 without one
    :param backend: ``"nccl"``, ``"gloo"`` or None (no group)
    """

    world_size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)   # collectives issued, by helper

    @property
    def distributed(self) -> bool:
        """True when the collectives run (a process group, world 1 too)."""
        return self.group is not None

    def close(self) -> None:
        """Leave the process group (idempotent)."""
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def free_tcp_address(host: str = "127.0.0.1") -> str:
    """``tcp://host:port`` with a port free on ``host`` now, for
    ``make_mesh(init_method=...)``."""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"tcp://{host}:{s.getsockname()[1]}"


def make_mesh(device=None, *, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              backend: Optional[str] = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """This process's mesh.

    * ``init_method`` given (``tcp://host:port``): a world of
      ``world_size`` with this process as ``rank``;
    * else under ``torchrun`` (``WORLD_SIZE`` set): its RANK, WORLD_SIZE
      and LOCAL_RANK, the store at MASTER_ADDR:MASTER_PORT;
    * else a world of 1 on ``device`` with no process group.

    The device is ``cuda:{LOCAL_RANK}`` (LOCAL_RANK defaults to the rank)
    unless ``device`` names one; without a card and without a device this
    raises, and so does a LOCAL_RANK with no card of its own. The backend
    is NCCL on a card and gloo on the CPU. NCCL takes one rank a card,
    ``cuda:{LOCAL_RANK}``: ranks that share a card ask for
    ``backend="gloo"``. Every check runs before the process group is made;
    a collective that waits more than ``timeout_s`` raises."""
    env = os.environ
    if init_method is None and "WORLD_SIZE" not in env:
        if (rank or 0) != 0 or (world_size or 1) != 1:
            raise ValueError("a world of more than 1 needs init_method or "
                             "torchrun's environment")
        return Mesh(1, 0, resolve_device(device))
    if init_method is None:
        init_method = "env://"
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        resolve_device(None)
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} has no card: "
                f"{torch.cuda.device_count()} visible; ranks are not wrapped "
                "onto a card on their own (name a device and use gloo)")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"nccl needs a CUDA device, not {device}")
        if device.index != local_rank:
            raise ValueError(
                f"nccl runs one rank a card: rank {rank} (local rank "
                f"{local_rank}) names {device}; ranks that share a card need "
                "backend='gloo' and an explicit device")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(world_size, rank, device, dist.group.WORLD, backend)


def batch_sharding(mesh: Mesh, batch_size: int, accum: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch_size`` that this rank holds, in
    order. The JAX trainer splits the global batch into ``accum``
    contiguous microbatches and shards each over the ranks, so rank r holds
    rows ``[i*B/accum + r*B/(accum*W), i*B/accum + (r+1)*B/(accum*W))`` of
    microbatch i, and its own contiguous split into ``accum`` is the rank's
    share of each microbatch."""
    w = mesh.world_size
    if batch_size % (accum * w):
        raise ValueError(f"batch {batch_size} is not divisible by grad_accum "
                         f"{accum} x world size {w}")
    micro, share = batch_size // accum, batch_size // (accum * w)
    rows = (np.arange(accum)[:, None] * micro + mesh.rank * share
            + np.arange(share)[None])
    return rows.reshape(-1)


def shard_batch(mesh: Mesh, batch: Sequence, accum: int = 1) -> tuple:
    """This rank's rows (``batch_sharding``) of every array of a global
    batch, numpy arrays or tensors, on the device they were on."""
    rows = batch_sharding(mesh, len(batch[0]), accum)
    if mesh.world_size == 1:
        return tuple(batch)

    def take(x):
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(rows, device=x.device)]
        return np.asarray(x)[rows]

    return tuple(take(x) for x in batch)


def _on_host(mesh: Mesh, t: Tensor, op) -> Tensor:
    """Run the in-place collective ``op`` on ``t``; under gloo a CUDA
    tensor goes through a host copy (gloo's collectives take host
    tensors)."""
    if mesh.backend == "gloo" and t.is_cuda:
        host = t.cpu()
        op(host)
        t.copy_(host)
    else:
        op(t)
    return t


@torch.no_grad()
def replicate(mesh: Mesh, tensors: Sequence[Tensor]) -> Sequence[Tensor]:
    """Broadcast every tensor from rank 0, in place: one collective for
    each dtype, over a flat bucket."""
    if not mesh.distributed:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        mesh.calls["replicate"] += 1
        _on_host(mesh, flat, lambda x: dist.broadcast(x, 0, group=mesh.group))
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    return tensors


@torch.no_grad()
def mean_bucket(mesh: Mesh, tensors: Sequence[Tensor]) -> List[Tensor]:
    """The mean over ranks of each tensor (one dtype), through one
    all-reduce of their flattened concatenation; views of that bucket."""
    if not mesh.distributed:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh.calls["mean_bucket"] += 1
    _on_host(mesh, flat, lambda x: dist.all_reduce(x, group=mesh.group))
    flat.div_(mesh.world_size)
    return [v.view_as(t) for t, v in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


@torch.no_grad()
def all_gather_rows(mesh: Mesh, t: Tensor) -> Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along dim
    0 in rank order, on ``t``'s device."""
    if not mesh.distributed:
        return t
    mesh.calls["all_gather_rows"] += 1
    src = t.detach().contiguous()
    if mesh.backend == "gloo" and src.is_cuda:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the cotangents over ranks (each
    rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        mesh.calls["all_reduce_sum"] += 1
        return _on_host(mesh, x.clone(memory_format=torch.contiguous_format),
                        lambda y: dist.all_reduce(y, group=mesh.group))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        mesh.calls["all_reduce_sum"] += 1
        g = g.clone(memory_format=torch.contiguous_format)
        return _on_host(mesh, g, lambda y: dist.all_reduce(
            y, group=mesh.group)), None


def all_reduce_sum(mesh: Mesh, x: Tensor) -> Tensor:
    """``x`` summed over the ranks, differentiable; ``x`` itself without a
    process group."""
    if not mesh.distributed:
        return x
    return _AllReduceSum.apply(x, mesh)
