"""The mesh a tensor-parallel engine runs on, and its collectives.

One process per card (one per rank on the CPU), all running the same host
program; a :class:`Mesh` is one rank's view: the ``(data, model)`` shape,
this rank's index on the model axis, the process group of the model axis
(NCCL on the card, gloo on the CPU) and a gloo group over the same ranks
for host state (the clock reading, sanitizer digests, snapshot pools), so
host exchanges never wait on the card. ``launch/mesh.py`` builds it.

The seam reduction (:func:`reduce_partials`) all-gathers every rank's f32
partial sums and adds them in rank order on every rank: the same bits on
every rank and in every run, under gloo and NCCL alike (NCCL's
``all_reduce`` picks its algorithm, and with it the order of the sum, by
size and topology).
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch
import torch.distributed as dist

__all__ = ["Mesh", "reduce_partials", "host_all_gather", "broadcast_float",
           "host_barrier", "differing_ranks", "world_host_group"]

_WORLD_HOST: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh (``.shape`` and
    ``.axis_names`` as JAX's ``Mesh`` has them). ``ranks``: the global
    ranks of the model axis, in order (one replica's, under replica
    meshes; ``model_rank`` is −1 on a rank outside them)."""

    shape: dict
    model_rank: int = 0
    group: object = None         # the model axis's process group
    host_group: object = None    # gloo over the same ranks
    device: torch.device = torch.device("cpu")
    axis_names: tuple = ("data", "model")
    ranks: tuple = ()

    @property
    def size(self) -> int:
        return int(self.shape["model"])


def reduce_partials(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``y`` (f32 partial sums of one row-parallel
    projection) summed in rank order, ((y₀ + y₁) + y₂) + …, on every
    rank."""
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y.contiguous(), group=mesh.group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def host_all_gather(t: torch.Tensor, mesh: Mesh) -> list:
    """A host tensor from every rank, in rank order (gloo)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.host_group)
    return parts


def broadcast_float(x: float, mesh: Mesh) -> float:
    """Rank 0's ``x`` on every rank."""
    t = torch.tensor([x], dtype=torch.float64)
    dist.broadcast(t, dist.get_global_rank(mesh.host_group, 0),
                   group=mesh.host_group)
    return float(t.item())


def world_host_group():
    """A gloo group over every rank of the process group (the world
    itself under gloo), made once per process group; creating it is
    collective, so every rank calls this at the same point."""
    if _WORLD_HOST.get("world") is not dist.group.WORLD:
        _WORLD_HOST["world"] = dist.group.WORLD
        _WORLD_HOST["group"] = (dist.new_group(backend="gloo")
                                if dist.get_backend() != "gloo"
                                else dist.group.WORLD)
    return _WORLD_HOST["group"]


def host_barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh has come here (gloo)."""
    dist.barrier(group=mesh.host_group)


def differing_ranks(text: str, mesh: Mesh) -> list:
    """All-gather a digest of ``text`` → the ranks whose digest differs
    from rank 0's (empty when every rank holds the same text)."""
    d = hashlib.sha256(text.encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(d, "little", signed=True)],
                        dtype=torch.int64)
    got = host_all_gather(mine, mesh)
    return [r for r, g in enumerate(got) if int(g) != int(got[0])]
