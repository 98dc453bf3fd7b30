"""Checkpoints of a training run: save **and restore** of params, optimizer
state, step and seed (port of the JAX package's ``checkpoint.py``, without
Orbax).

* One directory per step, ``<dir>/<step>/state.pt``, committed
  atomically: written under a temp name in the same directory, then
  renamed. A process killed mid-save leaves at most a ``.tmp-*``
  directory, which :meth:`Checkpointer.latest_step` never picks.
* The payload holds the model's ``state_dict``, the optimizer state
  (:class:`..optim.OptState`: Adam moments, the accumulation buffer,
  ``count`` and ``mini_step``), ``step`` and ``seed``. The port's dropout
  streams derive from ``(seed, step)`` (:func:`..engine.step_generator`),
  so that is the whole RNG state. Restore is bit-exact.
* Rotation is owned by the :class:`Checkpointer` (``max_to_keep``, newest
  kept) and skips pinned steps (:func:`pin_step`), which live in
  ``integrity.json`` so another process can pin.
* Each committed step's sha256 (:func:`..utils.digest.digest_dir`) is
  recorded in ``integrity.json`` under the cross-process flock
  (:mod:`..utils.integrity`); :meth:`Checkpointer.restore` verifies it and
  raises :class:`CheckpointCorruptError` on a mismatch.

* Saves are asynchronous by default (``async_save=True``, as in the JAX
  package): :meth:`Checkpointer.save` snapshots the state into host
  buffers allocated once per Checkpointer and returns; a writer thread
  commits the step. On a CUDA state the snapshot runs on the card: an
  event recorded on the compute stream, non-blocking copies into pinned
  buffers on a side stream, and the compute stream made to wait on the
  copy's completion event, so an in-place optimizer update queued after
  ``save()`` cannot overwrite a parameter before it is copied, and the
  host does not block. :meth:`Checkpointer.wait` blocks until the last
  save is durable and raises a writer error; ``restore``,
  ``latest_step``, ``all_steps`` and ``verify`` wait first.
  ``async_save=False`` writes in ``save()``.

:func:`save_model` / :func:`load_model` write and read the port's params
export (``params.npz``, :func:`..convert.save_params_npz`).
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import torch

from .convert import load_params_npz, save_params_npz
from .optim import OptState
from .utils.atomic import atomic_write_json
from .utils.digest import digest_dir
from .utils.integrity import (INTEGRITY_NAME, integrity_lock,
                              read_integrity_file,
                              read_integrity_file_strict)

STATE_FILE = "state.pt"
PARAMS_FILE = "params.npz"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint's payload bytes no longer match the digest recorded
    at save time (torn write, bit rot, a partial copy). The message
    carries the delete-or-use-previous recovery guidance."""


# --------------------------------------------------- pin / release API
# A pinned step is exempt from rotation until released (a deploy canary's
# incumbent must survive the trainer's rotation). Pins live in
# integrity.json (the "pins" list) so any process sharing the directory
# sees them; every read-modify-write of the manifest holds the flock.


def _parse_pins(manifest: Dict[str, Any]) -> set:
    """The pins list, malformed entries skipped per element."""
    out = set()
    pins = manifest.get("pins", [])
    for s in pins if isinstance(pins, list) else ():
        try:
            out.add(int(s))
        except (TypeError, ValueError):
            continue
    return out


def pinned_steps(directory: str | Path) -> List[int]:
    """Steps exempt from rotation, freshly read from disk."""
    return sorted(_parse_pins(read_integrity_file(directory)))


def pin_step(directory: str | Path, step: int) -> bool:
    """Exempt ``step`` from rotation. Returns True when the step's
    directory exists at pin time (False = already pruned; the pin is
    recorded anyway but protects nothing)."""
    directory = Path(directory)
    with integrity_lock(directory):
        manifest = read_integrity_file(directory)
        pins = _parse_pins(manifest)
        if int(step) not in pins:
            pins.add(int(step))
            manifest["pins"] = sorted(pins)
            atomic_write_json(directory / INTEGRITY_NAME, manifest)
    return (directory / str(int(step))).is_dir()


def unpin_step(directory: str | Path, step: int) -> None:
    """Release a pin; the step rotates out on the owner's next save."""
    directory = Path(directory)
    with integrity_lock(directory):
        manifest = read_integrity_file(directory)
        pins = _parse_pins(manifest)
        if int(step) in pins:
            pins.discard(int(step))
            manifest["pins"] = sorted(pins)
            atomic_write_json(directory / INTEGRITY_NAME, manifest)


def _cpu(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _write_payload(path: Path, payload: Dict[str, Any]) -> None:
    """``torch.save`` to ``path``, flushed and fsynced (durable on return)."""
    with open(path, "wb") as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())


def _state_tensors(state) -> Dict[str, Mapping[str, torch.Tensor]]:
    """The tensors of a checkpoint, by payload group."""
    opt: OptState = state.opt_state
    return {"params": state.model.state_dict(), "mu": opt.mu, "nu": opt.nu,
            "acc": opt.acc}


def _scalars(state) -> Dict[str, int]:
    """The integers of a checkpoint: the optimizer's count and mini_step,
    the train step and the seed."""
    opt: OptState = state.opt_state
    return {"count": int(opt.count), "mini_step": int(opt.mini_step),
            "step": int(state.step), "seed": int(state.seed)}


def _refuse_other_trainables(step: int, saved: set, state) -> None:
    """A frozen-backbone run keeps Adam state for the head only: the
    optimizer ``state`` was built with must label the same params
    trainable as the one that saved (``saved``: the names it holds
    moments for)."""
    if saved != set(state.opt_state.mu):
        raise ValueError(
            f"checkpoint step {step} holds optimizer state for "
            f"{len(saved)} params, this run's optimizer trains "
            f"{len(state.opt_state.mu)}; resume with the same "
            "--freeze-backbone setting")


def _apply_payload(state, params: Mapping[str, torch.Tensor],
                   groups: Dict[str, Mapping[str, torch.Tensor]],
                   scalars: Dict[str, int]):
    """Load a checkpoint's tensors into ``state``: ``params`` into the
    model in place, a new optimizer state (``groups``: ``mu``, ``nu``,
    ``acc``) on the params' device, and ``scalars`` (as :func:`_scalars`
    gives them). Returns ``state``."""
    state.model.load_state_dict(params)
    dev = next(state.model.parameters()).device

    def on_dev(d):
        return {k: v.to(dev) for k, v in d.items()}
    state.opt_state = OptState(
        count=int(scalars["count"]), mu=on_dev(groups["mu"]),
        nu=on_dev(groups["nu"]), acc=on_dev(groups["acc"]),
        mini_step=int(scalars["mini_step"]))
    state.step = int(scalars["step"])
    state.seed = int(scalars["seed"])
    return state


def _payload(scalars: Dict[str, int],
             tensors: Dict[str, Mapping[str, torch.Tensor]]
             ) -> Dict[str, Any]:
    return {"params": tensors["params"],
            "opt_state": {"count": scalars["count"],
                          "mini_step": scalars["mini_step"],
                          "mu": tensors["mu"], "nu": tensors["nu"],
                          "acc": tensors["acc"]},
            "step": scalars["step"], "seed": scalars["seed"]}


class _Snapshot:
    """Host copies of a state's tensors, for one save in flight at a time.

    The buffer set is allocated at the first save and reused while the
    shapes stay; pinned when the state lives on a CUDA card. There the copy
    runs on a side stream: it waits on an event recorded on the compute
    stream, and the compute stream then waits on the copy's completion
    event, so later kernels on it (the next optimizer update, which writes
    the params and moments in place) run only after the copy. The host
    does not block; :meth:`ready` is what the writer waits on. A CPU
    state is copied before :meth:`take` returns."""

    def __init__(self):
        self._bufs: Dict[str, Dict[str, torch.Tensor]] = {}
        self._stream = None
        self._done = None

    def _buffers(self, tensors, pin: bool):
        want = {g: {k: (tuple(v.shape), v.dtype) for k, v in d.items()}
                for g, d in tensors.items()}
        have = {g: {k: (tuple(v.shape), v.dtype) for k, v in d.items()}
                for g, d in self._bufs.items()}
        if want != have:
            self._bufs = {g: {k: torch.empty(shape, dtype=dt,
                                             pin_memory=pin)
                              for k, (shape, dt) in d.items()}
                          for g, d in want.items()}
        return self._bufs

    def take(self, tensors: Dict[str, Mapping[str, torch.Tensor]]
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        devs = {v.device for d in tensors.values() for v in d.values()}
        cuda = [d for d in devs if d.type == "cuda"]
        if len(cuda) > 1 or (cuda and len(devs) > 1):
            raise ValueError(f"checkpoint tensors span devices {devs}")
        bufs = self._buffers(tensors, pin=bool(cuda))
        self._done = None
        if not cuda:
            for g, d in tensors.items():
                for k, v in d.items():
                    bufs[g][k].copy_(v.detach())
            return bufs
        dev = cuda[0]
        compute = torch.cuda.current_stream(dev)
        if self._stream is None or self._stream.device != dev:
            self._stream = torch.cuda.Stream(dev)
        start = torch.cuda.Event()
        start.record(compute)
        self._stream.wait_event(start)
        with torch.cuda.stream(self._stream):
            for g, d in tensors.items():
                for k, v in d.items():
                    bufs[g][k].copy_(v.detach(), non_blocking=True)
                    v.record_stream(self._stream)
        self._done = torch.cuda.Event()
        self._done.record(self._stream)
        compute.wait_event(self._done)
        return bufs

    def ready(self) -> None:
        """Block until the last :meth:`take`'s copies have landed."""
        if self._done is not None:
            self._done.synchronize()


class Checkpointer:
    """Managed, rotating, async checkpoints of an
    :class:`..engine.TrainState`.

    One writer per directory: a new Checkpointer removes ``.tmp-*``
    directories that a killed save left behind. At most one save is in
    flight: a new ``save()`` first waits for the previous one (it reuses
    the snapshot buffers). A writer error is raised at the next ``save``
    or ``wait``.
    """

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3,
                 async_save: bool = True, integrity: bool = True):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._integrity = bool(integrity)
        self._max_to_keep = int(max_to_keep) if max_to_keep else None
        self._async = bool(async_save)
        self._snapshot = _Snapshot()
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        for tmp in self.directory.glob(".tmp-*"):
            shutil.rmtree(tmp, ignore_errors=True)

    def step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def _committed(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def all_steps(self) -> List[int]:
        """Committed steps, ascending (after any save in flight)."""
        self.wait()
        return self._committed()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, *, force: bool = False) -> bool:
        """Commit ``state`` as step ``state.step``: with ``async_save``,
        snapshot it and return before the step is durable (:meth:`wait`
        makes it so). Returns False (and writes nothing) when that step is
        already committed, unless ``force``."""
        return self.save_parts(_state_tensors(state), _scalars(state),
                               force=force)

    def save_parts(self, tensors: Dict[str, Mapping[str, torch.Tensor]],
                   scalars: Dict[str, int], *, force: bool = False) -> bool:
        """:meth:`save` of a state given as its payload groups (``params``,
        ``mu``, ``nu``, ``acc``: named tensors) and its integers (``count``,
        ``mini_step``, ``step``, ``seed``)."""
        self.wait()
        step = int(scalars["step"])
        if self.step_dir(step).is_dir() and not force:
            return False
        if not self._async:
            self._commit(step, _payload(scalars, {
                g: _cpu(d) for g, d in tensors.items()}))
            return True
        payload = _payload(scalars, self._snapshot.take(tensors))
        self._writer = threading.Thread(
            target=self._write_async, args=(step, payload),
            name=f"checkpoint-writer-{step}")
        self._writer.start()
        return True

    def _write_async(self, step: int, payload: Dict[str, Any]) -> None:
        try:
            self._snapshot.ready()
            self._commit(step, payload)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _commit(self, step: int, payload: Dict[str, Any]) -> None:
        """Write ``payload`` under a temp name, fsync, rename it into
        ``<dir>/<step>``, rotate, record the digest."""
        final = self.step_dir(step)
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        _write_payload(tmp / STATE_FILE, payload)
        if final.is_dir():
            old = self.directory / f".tmp-old-{step}-{os.getpid()}"
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        self._rotate()
        if self._integrity:
            self._record_digest(step)

    def restore(self, state, step: Optional[int] = None, *,
                verify: bool = True):
        """Load step ``step`` (default: the latest) into ``state``: the
        model's params in place, a new optimizer state on the params'
        device, ``step`` and ``seed``. Returns ``state``.

        ``verify=True`` checks the step's digest first and raises
        :class:`CheckpointCorruptError` on a mismatch; a step saved with
        no digest recorded restores unverified."""
        payload = self.load_payload(step, verify=verify)
        o = payload["opt_state"]
        _refuse_other_trainables(payload["step"], set(o["mu"]), state)
        return _apply_payload(
            state, payload["params"],
            {g: o[g] for g in ("mu", "nu", "acc")},
            {"count": o["count"], "mini_step": o["mini_step"],
             "step": payload["step"], "seed": payload["seed"]})

    def load_payload(self, step: Optional[int] = None, *,
                     verify: bool = True) -> Dict[str, Any]:
        """The saved payload of step ``step`` (default: the latest), CPU
        tensors, its digest checked first with ``verify``."""
        self.wait()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        if verify and self._integrity:
            self.verify(step)
        return torch.load(self.step_dir(step) / STATE_FILE,
                          map_location="cpu", weights_only=True)

    # ------------------------------------------------ integrity guard
    @property
    def integrity_path(self) -> Path:
        return self.directory / INTEGRITY_NAME

    def _rotate(self) -> None:
        """Delete committed steps beyond ``max_to_keep``, newest kept,
        pinned steps exempt. Fails closed: when the pins cannot be read,
        this round deletes nothing."""
        if self._max_to_keep is None:
            return
        try:
            pins = _parse_pins(read_integrity_file_strict(self.directory))
        except (OSError, ValueError) as e:
            print(f"[warn] checkpoint rotation skipped: could not read "
                  f"pins ({type(e).__name__}: {e}); retrying at the next "
                  f"save")
            return
        committed = self._committed()
        keep = set(committed[-self._max_to_keep:]) | pins
        for s in committed:
            if s not in keep:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def _record_digest(self, step: int) -> None:
        """Digest the committed ``step`` (outside the lock: it reads every
        payload byte), then merge it into the manifest under the lock,
        dropping digests of rotated-away steps and keeping the pins."""
        digest = digest_dir(self.step_dir(step))
        committed = set(self._committed())
        with integrity_lock(self.directory):
            manifest = read_integrity_file(self.directory)
            steps = {k: v for k, v in manifest.get("steps", {}).items()
                     if int(k) in committed}
            steps[str(step)] = digest
            manifest["steps"] = steps
            atomic_write_json(self.integrity_path, manifest)

    def verify(self, step: int) -> bool:
        """Recompute ``step``'s digest against the recorded one. False when
        none was recorded; raises :class:`CheckpointCorruptError` on a
        mismatch."""
        self.wait()
        recorded = read_integrity_file(self.directory).get(
            "steps", {}).get(str(step))
        if recorded is None:
            return False
        actual = digest_dir(self.step_dir(step))
        if actual["sha256"] != recorded["sha256"]:
            others = [s for s in self._committed() if s != step]
            hint = (f"restore(step={max(others)}) to use the previous "
                    f"good checkpoint" if others else
                    "no earlier checkpoint exists in this directory")
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {self.directory} is "
                f"corrupt: payload digest {actual['sha256'][:12]}… != "
                f"recorded {recorded['sha256'][:12]}… "
                f"({actual['files']} files/{actual['bytes']} bytes vs "
                f"{recorded['files']}/{recorded['bytes']} at save). "
                f"Delete {self.step_dir(step)} (and its entry in "
                f"{INTEGRITY_NAME}), or {hint}.")
        return True

    def restore_latest_verified(self, state):
        """Restore the newest step that verifies and loads, falling back
        step by step past corrupt ones (warned, left on disk)."""
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        first_err: Optional[Exception] = None
        for step in steps:
            try:
                return self.restore(state, step)
            except CheckpointCorruptError as e:
                print(f"[warn] {e}\nfalling back to the previous "
                      f"checkpoint")
            except (OSError, RuntimeError, KeyError, ValueError) as e:
                # A digest-less step damaged by a kill surfaces as a load
                # error, not a digest mismatch: fall back all the same.
                print(f"[warn] checkpoint step {step} failed to restore "
                      f"({type(e).__name__}: {e}); falling back to the "
                      f"previous checkpoint")
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        raise CheckpointCorruptError(
            f"every checkpoint under {self.directory} failed integrity "
            f"verification; delete the directory and restart from scratch")

    def pin_step(self, step: int) -> bool:
        """Exempt ``step`` from rotation (see module :func:`pin_step`),
        after any save in flight."""
        self.wait()
        return pin_step(self.directory, step)

    def unpin_step(self, step: int) -> None:
        """Release a pin; the step rotates out on the next save."""
        unpin_step(self.directory, step)

    def wait(self) -> None:
        """Block until the save in flight is durable (committed, rotated,
        its digest recorded); raise the writer's error if it failed. Call
        before process exit."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait()


class MeshCheckpointer:
    """:class:`Checkpointer` of a train state sharded over a dp x tp x pp
    mesh, in the one-card format, so a mesh run resumes on one card and a
    one-card run on a mesh. Every rank holds one and calls each method
    (they are collectives); rank 0 alone writes: it owns the
    :class:`Checkpointer` (the async writer, the manifest, pins). A save
    gathers params, ``mu``, ``nu`` and ``acc`` to rank 0 in the standard
    layout (only the ranks at data coordinate 0 send); a restore reads on
    rank 0 and sends every rank its slices."""

    def __init__(self, directory: str | Path, mesh, **kwargs):
        self.mesh = mesh
        self.directory = Path(directory).absolute()
        self.inner = (Checkpointer(directory, **kwargs) if mesh.rank == 0
                      else None)

    def latest_step(self) -> Optional[int]:
        from .parallel.mesh import from_rank0
        return from_rank0(self.mesh, self.inner and self.inner.latest_step)

    def all_steps(self) -> List[int]:
        from .parallel.mesh import from_rank0
        return from_rank0(self.mesh, self.inner and self.inner.all_steps)

    def save(self, state, *, force: bool = False) -> bool:
        """Commit ``state`` as step ``state.step`` (asynchronously on rank 0
        when its Checkpointer is async); False on every rank when that
        step is already committed, unless ``force``."""
        from .parallel.mesh import from_rank0
        from .parallel.sharding import gather_to_rank0
        inner = self.inner
        step = int(state.step)
        if not force and from_rank0(
                self.mesh,
                lambda: inner.wait() or inner.step_dir(step).is_dir()):
            return False
        full = gather_to_rank0(_state_tensors(state), self.mesh)
        if inner is None:
            return True
        return inner.save_parts(full, _scalars(state), force=force)

    def restore(self, state, step: Optional[int] = None, *,
                verify: bool = True):
        """Load step ``step`` (default: the latest) into every rank's
        ``state``: its slices of the params in place, of the optimizer
        state on the params' device, ``step`` and ``seed``."""
        from .parallel.mesh import from_rank0
        from .parallel.sharding import (_num_layers, block_index,
                                        scatter_from_rank0, stage_layers)
        inner = self.inner
        full = None
        if inner is not None:
            try:
                full = inner.load_payload(step, verify=verify)
                # Rank 0's optimizer holds its pipeline stage's names.
                layers = stage_layers(_num_layers(full["params"]),
                                      self.mesh)
                _refuse_other_trainables(
                    full["step"],
                    {k for k in full["opt_state"]["mu"]
                     if block_index(k) in (None, *layers)}, state)
            except Exception as e:  # noqa: BLE001 — raised on every rank
                full = e
        groups = None
        if inner is not None:
            groups = full if isinstance(full, BaseException) else {
                "params": full["params"],
                **{g: full["opt_state"][g] for g in ("mu", "nu", "acc")}}
        mine = scatter_from_rank0(groups, self.mesh)
        scalars = from_rank0(self.mesh, lambda: {
            "count": int(full["opt_state"]["count"]),
            "mini_step": int(full["opt_state"]["mini_step"]),
            "step": int(full["step"]), "seed": int(full["seed"])})
        return _apply_payload(state, mine.pop("params"), mine, scalars)

    def wait(self) -> None:
        """Rank 0: block until the save in flight is durable (and raise
        its writer's error); the other ranks write nothing."""
        if self.inner is not None:
            self.inner.wait()


def save_model(params: Mapping[str, torch.Tensor], target_dir: str | Path,
               model_name: str) -> Path:
    """API-parity port of reference ``utils.save_model`` (utils.py:7-35):
    a params-only export, ``target_dir/model_name/params.npz`` (a
    ``.pt``/``.pth`` suffix is stripped, as the JAX package does)."""
    name = model_name
    for suffix in (".pt", ".pth"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    path = Path(target_dir).absolute() / name
    path.mkdir(parents=True, exist_ok=True)
    print(f"[INFO] Saving model to: {path}")  # mirrors utils.py:33
    save_params_npz(path / PARAMS_FILE, params)
    return path


def load_model(path: str | Path,
               params_template: Optional[Mapping[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """Read a :func:`save_model` export back as a ``state_dict`` (f32 CPU
    tensors). With ``params_template``, the names and shapes must match
    it."""
    params = load_params_npz(Path(path) / PARAMS_FILE)
    if params_template is not None:
        want = {k: tuple(v.shape) for k, v in params_template.items()}
        got = {k: tuple(v.shape) for k, v in params.items()}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))[:6]
            raise ValueError(f"params export {path} does not match the "
                             f"template: {diff}")
    return params
