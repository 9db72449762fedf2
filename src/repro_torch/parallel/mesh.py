"""The mesh a tensor-parallel engine or a trainer runs on, and its
collectives.

One process per card (one per rank on the CPU), all running the same host
program; a :class:`Mesh` is one rank's view: the ``(data, model)`` shape,
this rank's index on each axis (rank r is ``(r // M, r % M)``, row-major as
JAX lays a ``reshape(data, model)`` out), the process group of its model
axis and of its data axis (NCCL on the card, gloo on the CPU) and a gloo
group over its model axis for host state (the clock reading, sanitizer
digests, snapshot pools), so host exchanges never wait on the card.
``launch/mesh.py`` builds it.

Every sum over ranks all-gathers every rank's part and adds the parts in
rank order on every rank (:func:`rank_sum`, :func:`reduce_partials`): the
same bits on every rank and in every run, under gloo and NCCL alike
(NCCL's ``all_reduce`` and ``reduce_scatter`` pick their algorithm, and
with it the order of the sum, by size and topology).

:func:`serial_train` runs a function on every rank of a ``(data, model)``
mesh as threads of one process on one device, their collectives exchanged
in memory (:class:`ThreadComm`): the same code and the same rank-order
sums, so a mesh of processes must give its bits exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import traceback

import torch
import torch.distributed as dist

__all__ = ["Mesh", "reduce_partials", "rank_sum", "axis_gather",
           "axis_all_to_all", "host_all_gather", "broadcast_float",
           "host_barrier", "mesh_barrier", "differing_ranks",
           "world_host_group", "ThreadComm", "serial_train"]

_WORLD_HOST: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh (``.shape`` and
    ``.axis_names`` as JAX's ``Mesh`` has them). ``ranks``: the global
    ranks of the model axis, in order (one replica's, under replica
    meshes; ``model_rank`` is −1 on a rank outside them). ``comm``: a
    :class:`ThreadComm` rank under
    :func:`serial_train`, else None (``torch.distributed``)."""

    shape: dict
    model_rank: int = 0
    group: object = None         # the model axis's process group
    host_group: object = None    # gloo over the same ranks
    device: torch.device = torch.device("cpu")
    axis_names: tuple = ("data", "model")
    ranks: tuple = ()
    data_rank: int = 0
    data_group: object = None    # the data axis's process group
    comm: object = None

    @property
    def size(self) -> int:
        return int(self.shape["model"])

    @property
    def data_size(self) -> int:
        return int(self.shape.get("data", 1))

    @property
    def world(self) -> int:
        return self.size * self.data_size

    @property
    def rank(self) -> int:
        """This rank's index in the mesh, ``data_rank · M + model_rank``."""
        return self.data_rank * self.size + self.model_rank

    def axis_size(self, axis: str) -> int:
        return {"data": self.data_size, "model": self.size,
                "world": self.world}[axis]

    def axis_rank(self, axis: str) -> int:
        return {"data": self.data_rank, "model": self.model_rank,
                "world": self.rank}[axis]


def _group(mesh: Mesh, axis: str):
    return {"model": mesh.group, "data": mesh.data_group,
            "world": dist.group.WORLD}[axis]


def axis_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """Every rank's ``t`` along ``axis`` (``"data"``, ``"model"`` or
    ``"world"``), in rank order; ``[t]`` on an axis of one rank."""
    if mesh.axis_size(axis) == 1:
        return [t]
    t = t.contiguous()
    if mesh.comm is not None:
        return mesh.comm.all_gather(axis, t)
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, t, group=_group(mesh, axis))
    return parts


def axis_all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` [n, ...] (n the axis's ranks): row j goes to rank j → [n,
    ...], row i what rank i sent here."""
    if mesh.axis_size(axis) == 1:
        return t
    t = t.contiguous()
    if mesh.comm is not None:
        i = mesh.axis_rank(axis)
        return torch.stack([p[i] for p in mesh.comm.all_gather(axis, t)])
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=_group(mesh, axis))
    return out


def rank_sum(parts) -> torch.Tensor:
    """((p₀ + p₁) + p₂) + …: the parts added in rank order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def reduce_partials(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``y`` (f32 partial sums of one row-parallel
    projection) summed in rank order, ((y₀ + y₁) + y₂) + …, on every
    rank."""
    return rank_sum(axis_gather(y, mesh, "model"))


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
    """Wait until every rank of the mesh's model axis has come here
    (gloo)."""
    dist.barrier(group=mesh.host_group)


def mesh_barrier(mesh: Mesh) -> None:
    """Wait until every rank of the whole mesh has come here (gloo, or
    the threads' own barrier)."""
    if mesh.world == 1:
        return
    if mesh.comm is not None:
        mesh.comm.barrier()
    else:
        dist.barrier(group=world_host_group())


def differing_ranks(text: str, mesh: Mesh) -> list:
    """All-gather a digest of ``text`` → the ranks whose digest differs
    from rank 0's (empty when every rank holds the same text)."""
    d = hashlib.sha256(text.encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(d, "little", signed=True)],
                        dtype=torch.int64)
    got = host_all_gather(mine, mesh)
    return [r for r, g in enumerate(got) if int(g) != int(got[0])]


# ------------------------------------------------- the threads' mesh

class _Exchange:
    """One group of threads' all-gather: each puts a copy of its tensor
    in its slot; between two barriers every slot is full and nobody
    writes (a copy, so an owner's later in-place update cannot reach a
    reader)."""

    def __init__(self, n: int, timeout_s: float):
        self.barrier = threading.Barrier(n, timeout=timeout_s)
        self.slots = [None] * n

    def all_gather(self, i: int, t: torch.Tensor) -> list:
        self.barrier.wait()
        self.slots[i] = t.clone()
        self.barrier.wait()
        return list(self.slots)


class ThreadComm:
    """The exchanges of a ``(data, model)`` mesh of threads: one per model
    row, one per data column, one for the world. ``rank(r)`` is rank r's
    view (what ``Mesh.comm`` holds)."""

    def __init__(self, data: int, model: int, timeout_s: float = 600.0):
        self.data, self.model = data, model
        self.rows = [_Exchange(model, timeout_s) for _ in range(data)]
        self.cols = [_Exchange(data, timeout_s) for _ in range(model)]
        self.whole = _Exchange(data * model, timeout_s)

    def abort(self) -> None:
        for ex in (*self.rows, *self.cols, self.whole):
            ex.barrier.abort()

    def rank(self, r: int) -> "_RankComm":
        return _RankComm(self, r)


@dataclasses.dataclass(frozen=True)
class _RankComm:
    comm: ThreadComm
    r: int

    def all_gather(self, axis: str, t: torch.Tensor) -> list:
        c, (d, m) = self.comm, divmod(self.r, self.comm.model)
        ex, i = {"model": (c.rows[d], m), "data": (c.cols[m], d),
                 "world": (c.whole, self.r)}[axis]
        return ex.all_gather(i, t)

    def barrier(self) -> None:
        self.comm.whole.barrier.wait()


def thread_mesh(comm: ThreadComm, r: int, device) -> Mesh:
    """Rank r's :class:`Mesh` of a :class:`ThreadComm`."""
    d, m = divmod(r, comm.model)
    return Mesh(shape={"data": comm.data, "model": comm.model},
                model_rank=m, data_rank=d, device=torch.device(device),
                ranks=tuple(range(d * comm.model, (d + 1) * comm.model)),
                comm=comm.rank(r))


def serial_train(fn, data: int, model: int, device="cpu", args=(),
                 timeout_s: float = 600.0) -> list:
    """``fn(mesh, *args)`` on every rank of a ``(data, model)`` mesh, each
    rank a thread of this process on ``device``, its collectives
    exchanged in memory → the values in rank order. The ranks compute
    exactly what a mesh of processes computes: the same code, the batch
    split into D row slices, every seam's and every gradient's M or D
    parts (forward and backward) added in rank order, ``global_norm``'s
    per-shard sums in rank order. On the card the backward runs on each
    rank's own thread (``set_multithreading_enabled(False)``: autograd's
    device thread would otherwise run every rank's backward in turn and
    wait forever at the first collective). A rank that raises stops the
    others; the first failure is raised here."""
    comm = ThreadComm(data, model, timeout_s)
    n = data * model
    out, errors = [None] * n, [None] * n
    dev = torch.device(device)

    def run(r):
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            # a thread's own setting: autograd's state is thread-local
            with (torch.autograd.set_multithreading_enabled(False)
                  if dev.type == "cuda" else contextlib.nullcontext()):
                out[r] = fn(thread_mesh(comm, r, dev), *args)
        except BaseException as e:  # noqa: BLE001 — a rank's failure goes
            errors[r] = (e, traceback.format_exc())   # to the caller
            comm.abort()

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    hung = [r for r, t in enumerate(threads) if t.is_alive()]
    if hung:
        comm.abort()
        raise TimeoutError(f"serial_train: rank(s) {hung} did not finish "
                           f"within {timeout_s:.0f} s")
    first = [e for e in errors if e is not None and not isinstance(
        e[0], threading.BrokenBarrierError)] or [e for e in errors if e]
    if first:
        raise RuntimeError(f"serial_train ({data} x {model}): a rank "
                           f"failed:\n{first[0][1]}") from first[0][0]
    return out
