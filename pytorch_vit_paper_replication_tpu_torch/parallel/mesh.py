"""The process mesh: rank layout, one process group per axis, and a launcher.

The counterpart of the JAX package's ``parallel/mesh.py``. JAX lays devices
out as ``Mesh(devices.reshape(sizes), AXES)``; here every rank is one
process, and :func:`make_mesh` gives it the same coordinates (row-major over
``AXES`` in rank order) and one ``torch.distributed`` process group per
axis: the ranks that differ from this one only along that axis.

:func:`spawn` starts the ranks (``torch.multiprocessing``, forkserver
context with torch preloaded), rendezvouses them through a ``FileStore`` in
a temporary directory (no TCP port, so parallel test workers cannot
collide), and joins them with a timeout. The backend is chosen from the
layout, never after a failure:

* ``nccl`` when every rank gets a CUDA device of its own;
* ``gloo`` when ranks share one device: the CPU, or one card that several
  ranks share (NCCL refuses two ranks on one GPU). Gloo takes no CUDA
  tensor for point-to-point transfers, so on a shared card every
  collective and transfer copies through host memory (:attr:`Mesh.transport`
  says so).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..configs import MeshConfig

AXES = ("data", "model", "seq", "pipe")


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh.

    ``shape`` maps each axis to its size (as JAX's ``mesh.shape``),
    ``coords`` to this rank's index along it, ``device`` to the rank's
    device and ``groups`` to its process groups (no device and no groups
    for a layout built without processes, which validation and sharding
    rules can still read; an axis of size 1 has no group)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int = 0
    world: int = 1
    device: Optional[torch.device] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def backend(self) -> str:
        return dist.get_backend() if dist.is_initialized() else "none"

    @property
    def transport(self) -> str:
        """How tensors move between this rank and the others."""
        return describe_transport(
            self.backend, self.device.type if self.device else "cpu")

    def layout_of(self, rank: int) -> "Mesh":
        """Global rank ``rank``'s coordinates on this mesh, without device
        or groups (what the sharding rules read)."""
        coords = np.unravel_index(rank, [self.shape[a] for a in AXES])
        return Mesh(shape=dict(self.shape),
                    coords={a: int(c) for a, c in zip(AXES, coords)},
                    rank=rank, world=self.world)

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replaced (e.g. ``rank_at(pipe=s + 1)``)."""
        c = {**self.coords, **coords}
        return int(np.ravel_multi_index([c[a] for a in AXES],
                                        [self.shape[a] for a in AXES]))


def describe_transport(backend: str, device_type: str) -> str:
    """How tensors move between the ranks of ``backend`` on
    ``device_type``."""
    if backend == "gloo" and device_type == "cuda":
        return ("gloo, through host memory: the ranks share one card and "
                "gloo takes no CUDA tensor for point-to-point transfers")
    return backend


def mesh_layout(config: MeshConfig, world: int, rank: int = 0) -> Mesh:
    """The sizes and ``rank``'s coordinates of ``config`` over ``world``
    ranks, without process groups."""
    sizes = config.axis_sizes(world)
    coords = np.unravel_index(rank, sizes)
    return Mesh(shape=dict(zip(AXES, sizes)),
                coords={a: int(c) for a, c in zip(AXES, coords)},
                rank=rank, world=world)


def make_mesh(config: MeshConfig, *, device: torch.device) -> Mesh:
    """This rank's :class:`Mesh` on ``device`` over the initialized default
    process group, with one group per axis of size > 1. Every rank must
    call it, in the same order as every other ``new_group`` call."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = mesh_layout(config, world, rank)
    mesh.device = torch.device(device)
    sizes = [mesh.shape[a] for a in AXES]
    ranks = np.arange(world).reshape(sizes)
    for i, axis in enumerate(AXES):
        if sizes[i] == 1:
            continue
        # Every line of ranks along `axis`, in row-major order of the
        # other coordinates: each rank creates every group, keeps its own.
        lines = np.moveaxis(ranks, i, -1).reshape(-1, sizes[i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                mesh.groups[axis] = group
    return mesh


def from_rank0(mesh: Mesh, fn: Callable[[], Any]) -> Any:
    """Collective over every rank: ``fn()`` runs on rank 0 alone and its
    value is returned on every rank; an exception it raises (a refusal's
    ``SystemExit`` too) is raised on every rank."""
    box: List[Any] = [None]
    if mesh.rank == 0:
        try:
            box = [(True, fn())]
        except (Exception, SystemExit) as e:  # noqa: BLE001 — re-raised
            box = [(False, e)]
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        raise value
    return value


def _rank_main(rank: int, world: int, call_path: str, config: MeshConfig,
               store_path: str, backend: str, device: str,
               timeout_s: float, results) -> None:
    """One rank: init the process group, build the mesh, run ``fn(mesh,
    *args)`` (pickled by :func:`spawn` to ``call_path``) and put ``(rank,
    ok, value or traceback)`` on ``results``."""
    initialized = False
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        else:
            dev = torch.device("cuda", 0) if device == "cuda" else \
                torch.device("cpu")
            if dev.type == "cpu":
                # The ranks share the host's cores: one thread each.
                torch.set_num_threads(1)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        initialized = True
        out = fn(make_mesh(config, device=dev), *args)
        # Plain pickle: the queue's pickler would share a tensor's memory
        # with this process, which exits before the parent reads it.
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if initialized:
            dist.destroy_process_group()


def backend_for(device: str, world: int) -> str:
    """``nccl`` when each of ``world`` ranks gets a CUDA device of its own,
    else ``gloo`` (the CPU, or ranks sharing one card)."""
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def spawn(fn: Callable, mesh_config: MeshConfig, *, device: str = "cuda",
          timeout_s: float = 120.0, wait_while_alive: bool = False,
          args: Sequence = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on one rank process per device of
    ``mesh_config`` (the product of its sizes, which must all be given);
    returns each rank's return value, in rank order.

    ``fn`` must be importable by name (a module-level function), and its
    return value picklable. ``device``: ``"cuda"`` (the default) or
    ``"cpu"`` (see the module docstring for the backend). Every
    collective and transfer of a rank times out after ``timeout_s``. The
    join waits as long: TimeoutError when the ranks have not all finished
    within ``timeout_s``; with ``wait_while_alive`` (a training run
    outlives any one collective's bound) it waits while every rank is
    alive, so a hung rank fails the run through the others' collective
    timeouts. Raises RuntimeError with the traceback when a rank fails or
    exits without a result; every rank process is ended either way."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn(device='cuda') needs a CUDA device")
    if mesh_config.data < 1:
        raise ValueError("spawn needs MeshConfig.data >= 1, got "
                         f"{mesh_config.data}")
    world = (mesh_config.data * max(1, mesh_config.model)
             * max(1, mesh_config.seq) * max(1, mesh_config.pipe))
    mesh_config.axis_sizes(world)      # validate before starting anything
    backend = backend_for(device, world)
    # The ranks fork from a server process that has imported torch once
    # (started at the first call, reused after), instead of importing it
    # each: seconds a rank, tens of seconds when several start together.
    # The server never touches CUDA, so each rank initializes its own.
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="vit_mesh_")
    # The call goes through a file: a start() whose pickled arguments
    # exceed the pipe's buffer waits until the child has imported its main
    # module, which would start the ranks one after another.
    call_path = os.path.join(tmp, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, call_path, mesh_config, os.path.join(tmp, "store"),
        backend, device, timeout_s, results)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        return _collect(procs, results,
                        None if wait_while_alive else timeout_s)
    finally:
        for p in procs:
            if p.pid is None:       # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _collect(procs, results, timeout_s: Optional[float]) -> List[Any]:
    """Drain ``results`` until every rank reported; raise on a failure, a
    rank that died without reporting, or the deadline (None: none)."""
    out: Dict[int, Any] = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    dead_since: Dict[int, float] = {}
    while len(out) < len(procs):
        left = 0.5 if deadline is None else deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(len(procs))) - set(out))
            raise TimeoutError(f"ranks {missing} did not finish within "
                               f"{timeout_s} s")
        try:
            rank, ok, value = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r in out or p.is_alive():
                    continue
                # A rank that put its result and exited may still be
                # flushing it; one that is gone for 5 s without one died.
                if now - dead_since.setdefault(r, now) > 5.0:
                    raise RuntimeError(f"rank {r} exited with code "
                                       f"{p.exitcode} without a result")
            continue
        if not ok:
            # A rank that died first (a watchdog ending it, a crash) is
            # often why this one's collective failed: name it too.
            dead = "".join(
                f"\nrank {r} exited with code {p.exitcode} without a result"
                for r, p in enumerate(procs)
                if r != rank and r not in out and not p.is_alive())
            raise RuntimeError(f"rank {rank} failed:\n{value}{dead}")
        out[rank] = pickle.loads(value)
    return [out[r] for r in range(len(procs))]
