"""The walker mesh: one process per card, the walkers' log-posteriors
evaluated in blocks across the processes (counterpart of
``eftpipe_tpu/parallel/mesh.py``).

The JAX package shards the walker axis of one program over a device mesh
and lets XLA insert the collectives.  Here each card has its own process
(``torchrun --nproc-per-node=N``), joined by ``torch.distributed``: NCCL
between cards, gloo between CPU processes.  The samplers keep their state
(walkers, log-posteriors, random draws, adaptation) whole and identical on
every rank; only the evaluation is split: each rank evaluates its
contiguous block of a batch and one ``all_gather`` rebuilds the batch's
values (:meth:`WalkerMesh.evaluate`).  A chain on N ranks therefore equals
the one-process chain on the same seed, as long as ``logp`` of a block
equals the block of ``logp``.  The port's ``chunk`` argument of ``logp``
plays ``chunked_vmap``'s part.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclass(eq=False)
class WalkerMesh:
    """A process group over which the walker axis is split: this process's
    ``rank`` of ``size``, and the device its walkers live on.
    ``collectives`` counts the ``all_gather`` calls made through it."""

    group: object
    rank: int
    size: int
    device: torch.device
    collectives: int = 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a batch of ``n`` (a multiple of
        the mesh size)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split evenly over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The blocks of all ranks, concatenated along the first axis in rank
        order (one ``all_gather``)."""
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local, group=self.group)
        self.collectives += 1
        return torch.cat(parts)

    def evaluate(self, fn, x: torch.Tensor):
        """``fn`` (a batch → a tensor or a tuple of tensors, each with the
        batch axis first) of the whole batch ``x``, evaluated on this rank's
        block only and gathered."""
        out = fn(x[self.block(x.shape[0])])
        if isinstance(out, tuple):
            return tuple(self.gather(o) for o in out)
        return self.gather(out)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def _torchrun_env() -> dict | None:
    keys = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    if not all(k in os.environ for k in keys):
        return None
    return dict(rank=int(os.environ["RANK"]), size=int(os.environ["WORLD_SIZE"]),
                local_rank=int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def walker_mesh(devices=None) -> WalkerMesh:
    """The mesh of this process: it joins the default process group, or
    forms one from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; NCCL when the device is a card, gloo
    on the CPU), and raises ``RuntimeError`` when neither exists.

    ``devices`` lists one device per rank; by default rank r's device is
    ``cuda:<local rank>`` (the card, which must exist)."""
    env = _torchrun_env()
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        local = env["local_rank"] if env else rank
    elif env is not None:
        rank, size, local = env["rank"], env["size"], env["local_rank"]
    else:
        raise RuntimeError(
            "walker_mesh: no process group — start the program with torchrun "
            "(--nproc-per-node=N) or call torch.distributed.init_process_group first")
    if devices is not None:
        if len(devices) != size:
            raise ValueError(f"walker_mesh: {len(devices)} devices for {size} ranks")
        device = resolve_device(devices[rank])
    else:
        device = resolve_device(f"cuda:{local}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=rank, world_size=size)
    return WalkerMesh(group=dist.group.WORLD, rank=rank, size=size, device=device)


def shard_walkers(x: torch.Tensor, mesh: WalkerMesh) -> torch.Tensor:
    """This rank's contiguous block of a (nwalkers, ...) batch, on the
    mesh's device."""
    return x[mesh.block(x.shape[0])].to(mesh.device)


def replicate(x: torch.Tensor, mesh: WalkerMesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (a broadcast), on the mesh's device."""
    x = x.to(mesh.device).clone(memory_format=torch.contiguous_format)
    dist.broadcast(x, src=0, group=mesh.group)
    return x
