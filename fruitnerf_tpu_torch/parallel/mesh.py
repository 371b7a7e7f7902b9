"""Data parallelism over ``torch.distributed``. Twin of
``fruitnerf_tpu/parallel/mesh.py``, which shards the ray batch over a
``data`` axis and replicates the parameters, the compiler emitting the
gradient sum. Here each rank is a process with its own device:

  * every rank draws the global step's random numbers from one identically
    seeded generator and keeps its contiguous 1/N of the rays and of the
    sparsity points (``shard_draws``), so the union of the shards is the
    one-rank step's draws;
  * each loss is a mean over the rank's shard, and the gradients are
    averaged over the ranks with one ``all_reduce`` of a flattened buffer
    (``average``), so every rank's optimizer takes the same step;
  * the step's metrics are averaged the same way before the PSNR is formed.

The caller names the backend: ``nccl`` with one card a rank, ``gloo`` for
CPU ranks or ranks that share one card (gloo reduces CUDA tensors through
the host). Nothing switches backends on a failure.

    mesh = init_data_mesh("nccl", world_size, rank, "tcp://localhost:29500")
    train_loop(config, data, mesh=mesh)   # engine/trainer.py

``torchrun`` sets ``RANK`` and ``WORLD_SIZE``; give it
``init_method="env://"``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..bridge import tree_leaves


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel group."""

    rank: int
    world_size: int

    @property
    def lead(self) -> bool:
        """Rank 0, the one that writes checkpoints and metrics."""
        return self.rank == 0

    def shard(self, n: int, what: str) -> slice:
        """This rank's contiguous 1/N of ``n`` items; ``n`` must divide."""
        if n % self.world_size:
            raise ValueError(
                f"{what} = {n} is not divisible by the data-parallel world size "
                f"{self.world_size}"
            )
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)


def init_data_mesh(backend: str, world_size: int, rank: int,
                   init_method: str = "env://") -> DataMesh:
    """Join the process group on ``backend`` (``nccl`` or ``gloo``, as the
    caller names it) and return this rank's ``DataMesh``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return DataMesh(rank=rank, world_size=world_size)


def close_data_mesh() -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def check_batch(config, mesh: DataMesh) -> None:
    """Raise unless the step's rays and sparsity points divide over the
    ranks (the JAX twin's batch must divide over its mesh likewise)."""
    mesh.shard(config.train_rays_per_batch, "train_rays_per_batch")
    if config.model.density_sparsity_mult > 0:
        mesh.shard(config.model.sparsity_num_points, "sparsity_num_points")


def shard_draws(draws, mesh: DataMesh):
    """This rank's slice of a step's global draws (``trainer.StepDraws``):
    its contiguous 1/N of the rays and of the sparsity points."""
    rays = mesh.shard(draws.slot.shape[0], "train_rays_per_batch")
    pts = mesh.shard(draws.sparse_points.shape[0], "sparsity_num_points")
    return dataclasses.replace(
        draws,
        slot=draws.slot[rays], py=draws.py[rays], px=draws.px[rays],
        jitter=draws.jitter[:, rays],
        sampler=[u[rays] for u in draws.sampler],
        sparse_points=draws.sparse_points[pts],
    )


def average(tensors: list[torch.Tensor], mesh: DataMesh) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor, by one ``all_reduce`` of a
    flattened float32 buffer; every rank gets the same values."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= mesh.world_size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def average_gradients(params: dict, mesh: DataMesh) -> None:
    """Replace every parameter's gradient by its mean over the ranks (a
    parameter with no gradient takes part as zeros)."""
    leaves = tree_leaves(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    for p, g in zip(leaves, average(grads, mesh)):
        p.grad = g


def check_replicated(params: dict, mesh: DataMesh) -> None:
    """Raise on every rank unless every rank holds rank 0's parameters,
    bitwise (a rank that raised alone would leave the others waiting)."""
    flat = torch.cat([p.detach().reshape(-1).float() for p in tree_leaves(params)])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    own = not torch.equal(ref, flat)
    apart = torch.tensor([float(own)], device=flat.device)
    dist.all_reduce(apart, op=dist.ReduceOp.MAX)
    if apart.item():
        raise ValueError(
            f"rank {mesh.rank}: the ranks' initial parameters differ (this rank's "
            f"{'differ from' if own else 'equal'} rank 0's); seed every rank alike"
        )
