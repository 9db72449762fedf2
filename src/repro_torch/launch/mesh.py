"""Meshes over local ranks, and the processes that run them
(``repro/launch/mesh.py``).

Tensor-parallel serving and training over a ``(data, model)`` mesh run
one process per rank, every one running the same host program (as a
multi-controller JAX program does): on the card
rank r owns ``cuda:r`` and its collectives go through NCCL, on the CPU
through gloo. :func:`spawn` starts the ranks, which meet through a
``FileStore`` in a fresh temporary directory, and returns what each
rank's function returned; :func:`make_local_mesh` then builds a rank's
:class:`~repro_torch.parallel.mesh.Mesh` inside its process, and
:func:`make_replica_meshes` carves the ranks into one mesh per replica
(``serving/replication.py``). :func:`make_production_mesh` is the
reference's 16 × 16 or 2 × 16 × 16 mesh as a planning mesh (a shape for
the dry run, ``launch/dryrun.py``: no card, no process group). All are strict: a mesh larger than the
visible cards, a rank that fails or exits early, and one that does not
finish within the wall-clock limit raise, and no mesh is clamped to fit
unless a launcher asks before it starts the ranks (:func:`fit_mesh`
with ``allow_shrink``, as the trainer's does).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Mesh, planning_mesh, world_host_group

__all__ = ["make_production_mesh", "parse_mesh_arg", "fit_mesh",
           "make_local_mesh",
           "make_replica_meshes", "init_rank", "spawn", "check_cards"]


def parse_mesh_arg(spec: str) -> tuple[int, int]:
    """CLI ``--mesh DxM`` → ``(data, model)``, e.g. ``"1x4"`` → (1, 4).

    Pure string parsing (no device touch) so launchers can validate the
    flag before starting any rank. Raises ValueError on anything that is
    not two positive ints joined by 'x'."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(
            f"--mesh expects DATAxMODEL (e.g. 1x4), got {spec!r}")
    try:
        data, model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"--mesh expects DATAxMODEL (e.g. 1x4), got {spec!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    return data, model


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a planning mesh
    (``parallel.mesh.planning_mesh``): 16 × 16 ``("data", "model")`` (256
    chips) or 2 × 16 × 16 ``("pod", "data", "model")`` (512 chips). It
    touches no card and no ``torch.distributed``."""
    return planning_mesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                         else {"data": 16, "model": 16})


def check_cards(n: int, device_type: str) -> None:
    """Raise unless ``n`` ranks fit: on the card, one visible card each."""
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(
                f"a mesh of {n} rank(s) needs {n} CUDA cards but {have} "
                f"are visible; no mesh is clamped to fit")


def fit_mesh(data: int, model: int, device_type: str,
             allow_shrink: bool = False) -> tuple[int, int]:
    """The ``(data, model)`` mesh to run: the request itself, or, with
    ``allow_shrink`` on the card when it needs more cards than are
    visible, the reference's best-effort shrink (``data = min(data, n)``,
    ``model = min(model, n // data)``) with a ``UserWarning`` naming the
    effective mesh. On the CPU the ranks are gloo processes: nothing
    shrinks."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    if allow_shrink and device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if data * model > n >= 1:
            data = min(data, n)
            model = min(model, max(1, n // data))
            warnings.warn(f"make_local_mesh clamped to effective mesh "
                          f"(data={data}, model={model}) over {n} "
                          f"device(s)", UserWarning, stacklevel=2)
    return data, model


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """This rank's ``(data, model)`` mesh over the ranks of the process
    group (``init_rank``), which must number exactly ``data · model``: a
    launcher that shrinks a request (:func:`fit_mesh`) does so before it
    starts the ranks. Rank r is ``(r // M,
    r % M)``; every rank creates every row's model group and every
    column's data group, in that order (creating a group is collective),
    and a gloo twin of its model group for host state. An axis of the
    whole world is the world's own group. Serving refuses a data axis
    above 1 itself (ROADMAP Queue 1 item 11)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh runs inside a rank: start the "
                           "ranks with launch.mesh.spawn (or init_rank)")
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    world, rank, cuda = _world("make_local_mesh", data * model,
                               f"mesh ({data}, {model})")
    host = world_host_group()
    d, m = divmod(rank, model)
    rows = [tuple(range(i * model, (i + 1) * model)) for i in range(data)]
    cols = [tuple(range(j, world, model)) for j in range(model)]

    def groups(members: list, mine: tuple, with_host: bool):
        if len(mine) == world:
            return dist.group.WORLD, host
        if len(mine) == 1:          # an axis of one rank never exchanges
            return None, None
        got = None
        for ranks in members:
            g = dist.new_group(list(ranks))
            h = (dist.new_group(list(ranks), backend="gloo")
                 if cuda and with_host else g)
            if ranks == mine:
                got = (g, h)
        return got

    group, host_group = groups(rows, rows[d], True)
    data_group, _ = groups(cols, cols[m], False)
    return Mesh(shape={"data": data, "model": model}, model_rank=m,
                group=group, host_group=host_group,
                device=(torch.device("cuda", rank) if cuda
                        else torch.device("cpu")),
                ranks=rows[d], data_rank=d, data_group=data_group)


def make_replica_meshes(replicas: int, model: int = 1) -> list:
    """The world's ranks carved into ``replicas`` disjoint ``(1, model)``
    meshes, replica i on ranks ``[i·model, (i+1)·model)`` (the
    reference's ``make_replica_meshes``, each replica its own engine,
    pool and scheduler). Every rank gets every replica's :class:`Mesh`
    (its model group, NCCL on the card and gloo on the CPU, and a gloo
    group over the same ranks), in replica order: creating a group is
    collective, so every rank creates every one. The world must number
    exactly ``replicas · model`` ranks, one card each on the card."""
    if replicas < 1 or model < 1:
        raise ValueError(f"replicas and model must be >= 1, got "
                         f"{replicas} and {model}")
    _, rank, cuda = _world("make_replica_meshes", replicas * model,
                           f"{replicas} replica(s) x model={model}")
    world_host_group()
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    meshes = []
    for i in range(replicas):
        ranks = tuple(range(i * model, (i + 1) * model))
        group = dist.new_group(list(ranks))
        host = (dist.new_group(list(ranks), backend="gloo") if cuda
                else group)
        meshes.append(Mesh(
            shape={"data": 1, "model": model},
            model_rank=ranks.index(rank) if rank in ranks else -1,
            group=group, host_group=host, device=device, ranks=ranks))
    return meshes


def _world(what: str, need: int, shape: str) -> tuple:
    """The process group's size, this rank and whether it runs NCCL,
    checked to number exactly ``need`` ranks with a card each."""
    if not dist.is_initialized():
        raise RuntimeError(f"{what} runs inside a rank: start the ranks "
                           "with launch.mesh.spawn (or init_rank)")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"{shape} needs {need} ranks, the process group "
                         f"has {world}")
    cuda = dist.get_backend() == "nccl"
    check_cards(world, "cuda" if cuda else "cpu")
    return world, dist.get_rank(), cuda


def init_rank(rank: int, world: int, store_path: str, device_type: str,
              timeout_s: float) -> torch.device:
    """Join the process group of ``world`` ranks as ``rank`` (NCCL on the
    card, gloo on the CPU) through the ``FileStore`` at ``store_path``,
    within ``timeout_s`` seconds → this rank's device (``cuda:rank``,
    made current, or the CPU)."""
    if device_type == "cuda":
        check_cards(world, "cuda")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _rank_main(fn, rank, world, store_path, device_type, collective_s,
               threads, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        device = init_rank(rank, world, store_path, device_type, collective_s)
        results.put((rank, True, fn(rank, world, device, *args)))
    except BaseException:  # noqa: BLE001 — a rank's failure, whatever it
        # is, goes to the parent, which stops every rank and raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args=(), *, device_type: str = "cpu",
          timeout_s: float = 600.0, collective_timeout_s: float = 600.0,
          threads: int = 0) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes,
    one per rank, each already in the process group → the returned values
    in rank order (they must pickle, and ``fn`` must be importable).
    ``threads`` pins each rank's PyTorch intra-op threads (0: leave them).
    Raises when a rank raises or exits without a result, stopping the
    others, and when the ranks have not all finished after
    ``timeout_s`` seconds. A collective that waits longer than
    ``collective_timeout_s`` (at most ``timeout_s``) for the other ranks
    raises in its rank."""
    check_cards(world, device_type)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, world, os.path.join(tmp, "store"), device_type,
              min(timeout_s, collective_timeout_s), threads, args, results))
        for r in range(world)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"rank(s) {sorted(set(range(world)) - set(out))} did "
                    f"not finish within {timeout_s:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                # a rank that exits cleanly has put its result first
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank(s) {dead} exited (codes "
                        f"{[procs[r].exitcode for r in dead]}) without a "
                        f"result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
