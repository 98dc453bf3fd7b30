"""Offline batch inference: every visible card, resumable, streaming (port
of the JAX package's ``serve/offline.py``).

The online engine (:mod:`.engine`) optimizes latency; this module sweeps
a whole packed-shard dataset through the same bucketed forward for
throughput:

* **data-parallel over every visible CUDA device** — one model replica a
  card; each chunk of a rung's rows splits evenly over the replicas in
  device order (the JAX package's ``NamedSharding(P("batch"))``), so the
  ladder is rounded up to device-count multiples (:func:`shard_ladder`);
* **double-buffered** as :func:`..data.image_folder.prefetch_to_device`
  does it: each chunk is copied into pinned host buffers (a set is reused
  only after its last copy completed), sent on a side copy stream the
  compute stream waits on, and its forward is queued; the host blocks on
  the oldest chunk only once more than ``prefetch`` are in flight;
* **resumable**: an atomic progress manifest (``progress.json``) records
  the record offset and the row count after every flushed checkpoint; a
  SIGKILLed run restarted with the same config resumes at the last
  durable offset and leaves a sink byte-identical to an unkilled run's
  (manifest writes happen only at loader-batch boundaries, so the resumed
  chunking replays the original plan). Completion records ``sink_sha256``;
* outputs go to a pre-sized float32 ``.npy`` (:class:`NpySink`, written
  in place through a memmap), optionally mirrored as a predictions JSONL
  for the ``probs`` head.

Heads: ``probs`` runs :func:`..predictions.forward_probs`, the expression
``predict_image`` / ``predict_batch`` run (bit-identical rows at the same
rung); ``features`` the backbone's pooled ``[D]`` embedding in float32;
``logits`` the ``probs`` expression without the softmax (so
``softmax(logits row) == probs row``), the distillation dataset.

The manifest, sink and mirror keep the JAX package's file formats; the
fingerprint is :func:`.engine.model_fingerprint`
(``compile_cache.config_fingerprint``). Telemetry rides the port's
registry (``bi_*`` instruments).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import time
from collections import deque
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.image_folder import DataLoader, _pinned_copy
from ..models.vit import pool_tokens
from ..predictions import forward_probs, resolve_device
from ..utils.atomic import atomic_write_json
from .bucketing import DEFAULT_BUCKETS, pad_rows_to_bucket, plan_buckets
from .engine import model_fingerprint

PROGRESS_MANIFEST = "progress.json"
SINK_NAME = "outputs.npy"
PREDS_NAME = "preds.jsonl"
PROGRESS_VERSION = 1
# Seconds between the run loop's progress lines.
LOG_EVERY_S = 30.0

# The one offline head registry: name -> what the sink rows are. The
# engine's validation and the batch_infer CLI's --head choices both read it.
OFFLINE_HEADS = {
    "probs": "softmax class probabilities [C] (predict_image program)",
    "features": "pooled backbone embeddings [D]",
    "logits": "pre-softmax class scores [C] (the distillation dataset)",
}


def shard_ladder(buckets: Sequence[int], ndev: int) -> Tuple[int, ...]:
    """The bucket ladder rounded up to device-count multiples, so every
    rung splits evenly over the replicas (duplicates collapse: ``(1, 8)``
    on 8 devices is ``(8,)``). On one device this is the identity."""
    nd = max(1, int(ndev))
    rungs = {-(-int(b) // nd) * nd for b in buckets if int(b) >= 1}
    if not rungs:
        raise ValueError(f"bucket ladder must be positive ints: {buckets}")
    return tuple(sorted(rungs))


# --------------------------------------------------------------- manifest
def write_progress(out_dir: str | Path, payload: dict) -> Path:
    """Atomically persist the progress manifest (temp file + ``os.replace``):
    a reader, or a resume after SIGKILL, never sees a torn file. The caller
    flushes the sink first, so the manifest never claims rows that are not
    durably in the sink."""
    return atomic_write_json(
        Path(out_dir) / PROGRESS_MANIFEST,
        {"version": PROGRESS_VERSION, **payload}, indent=2)


def load_progress(out_dir: str | Path) -> Optional[dict]:
    """None when no manifest exists; ValueError (with delete-it guidance)
    when one exists but cannot be parsed."""
    path = Path(out_dir) / PROGRESS_MANIFEST
    if not path.is_file():
        return None
    try:
        manifest = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(
            f"corrupt progress manifest {path}: {e}; delete it (or the "
            "whole output dir) to restart the job from record 0") from e
    if not isinstance(manifest, dict):
        raise ValueError(
            f"corrupt progress manifest {path}: expected a JSON object, "
            f"got {type(manifest).__name__}; delete it to restart")
    return manifest


def validate_progress(manifest: dict, *, fingerprint: str, head: str,
                      total_records: int, out_dim: int, batch_size: int,
                      ladder: Sequence[int],
                      row_shape: Sequence[int] = ()) -> int:
    """Returns the resume offset (``records_done``), or raises ValueError
    when the manifest belongs to another job (model, head, dataset length,
    batching: a byte-identical resume replays the original chunk plan)."""
    checks = (("fingerprint", fingerprint), ("head", head),
              ("total_records", int(total_records)),
              ("out_dim", int(out_dim)), ("batch_size", int(batch_size)),
              ("ladder", [int(b) for b in ladder]))
    if len(row_shape) > 1:
        # Tensor rows also pin the full per-row shape: out_dim alone is
        # ambiguous between a [D] sink and a [T, D] one.
        checks += (("row_shape", [int(d) for d in row_shape]),)
    for key, want in checks:
        got = manifest.get(key)
        if got != want:
            raise ValueError(
                f"progress manifest {key} mismatch: manifest has "
                f"{got!r}, this job wants {want!r} — the output dir "
                "belongs to a different job; point --out elsewhere, or "
                "delete it (or pass --fresh) to restart")
    done = int(manifest.get("records_done", -1))
    if not 0 <= done <= int(total_records):
        raise ValueError(
            f"progress manifest records_done={done} outside "
            f"[0, {total_records}]; delete the output dir to restart")
    return done


# ------------------------------------------------------------------ sinks
class NpySink:
    """A pre-sized float32 ``.npy`` written in place through a memmap: rows
    land at their absolute offset, so resuming is reopening ``r+`` at the
    manifest's row. Rows past the last flushed checkpoint may hold partial
    data after a SIGKILL; the resumed run rewrites them with identical
    bytes. ``dim`` is the per-row shape (an int for vector rows)."""

    def __init__(self, path: str | Path, *, rows: int,
                 dim: int | Sequence[int], resume: bool = False):
        dims = ((int(dim),) if isinstance(dim, int)
                else tuple(int(d) for d in dim))
        shape = (int(rows),) + dims
        self.path = Path(path)
        if resume:
            self._map = np.lib.format.open_memmap(self.path, mode="r+")
            if self._map.shape != shape or self._map.dtype != np.float32:
                raise ValueError(
                    f"existing sink {self.path} is "
                    f"{self._map.dtype}{self._map.shape}, this job "
                    f"needs float32{shape}; delete the output "
                    "dir to restart")
        else:
            self._map = np.lib.format.open_memmap(
                self.path, mode="w+", dtype=np.float32, shape=shape)

    def write(self, row: int, values: np.ndarray) -> None:
        self._map[row:row + len(values)] = values

    def flush(self) -> None:
        self._map.flush()

    def close(self) -> None:
        self.flush()
        del self._map


class PredsJsonl:
    """Optional classifier-predictions mirror: one ``{"index", "label",
    "prob"}`` line per record. Resume truncates to the manifest's recorded
    byte offset, so the file stays byte-identical to an unkilled run's."""

    def __init__(self, path: str | Path, *,
                 class_names: Optional[Sequence[str]] = None,
                 resume_bytes: Optional[int] = None):
        self.path = Path(path)
        self._classes = list(class_names) if class_names else None
        if resume_bytes is not None and int(resume_bytes) > 0:
            if not self.path.exists():
                # A mirror restarted here would start mid-dataset while the
                # run reports success.
                raise ValueError(
                    f"manifest records {resume_bytes} preds bytes but "
                    f"{self.path} is missing — the mirror cannot resume; "
                    "rerun with --fresh to rebuild the whole job")
            with open(self.path, "r+b") as f:
                f.truncate(int(resume_bytes))
            self._fh = open(self.path, "ab")
        else:
            # A streaming sink: durability comes from flush + fsync and the
            # manifest recording the offset, not temp + replace.
            self._fh = open(self.path, "wb")

    def write(self, start_index: int, probs: np.ndarray) -> None:
        lines = []
        for i, row in enumerate(probs):
            idx = int(row.argmax())
            label = self._classes[idx] if self._classes else idx
            lines.append(json.dumps(
                {"index": start_index + i, "label": label,
                 "prob": round(float(row[idx]), 6)}))
        self._fh.write(("\n".join(lines) + "\n").encode())

    def flush(self) -> int:
        """Durable byte offset (what the manifest records)."""
        self._fh.flush()
        os.fsync(self._fh.fileno())
        return self._fh.tell()

    def close(self) -> None:
        self._fh.close()


class _RecordRange:
    """Records ``[start, stop)`` of a dataset — the resume window. Forwards
    the page-cache hint hooks with the offset applied."""

    def __init__(self, ds, start: int, stop: int):
        self._ds = ds
        self._start = int(start)
        self._n = int(stop) - int(start)
        self.classes = getattr(ds, "classes", None)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int):
        if not 0 <= idx < self._n:
            raise IndexError(idx)
        return self._ds[self._start + idx]

    def willneed_records(self, lo: int, hi: int) -> None:
        if hasattr(self._ds, "willneed_records"):
            self._ds.willneed_records(lo + self._start, hi + self._start)

    def evict_records(self, lo: int, hi: int) -> None:
        if hasattr(self._ds, "evict_records"):
            self._ds.evict_records(lo + self._start, hi + self._start)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so it compares equal to a tensor's
    device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _head_fn(head: str):
    """``(replica, x) -> [B, ...] float32`` of one offline head."""
    if head == "features":
        def fn(model, x):
            return pool_tokens(model.config, model.backbone(x)).float()
    elif head == "logits":
        def fn(model, x):
            return model(x).float()
    else:
        fn = forward_probs
    return fn


# ----------------------------------------------------------------- engine
class OfflineEngine:
    """Data-parallel batch-inference engine (see the module docstring).

    ``model`` is the port's :class:`..models.ViT` (any classifier module
    for ``probs``/``logits``) with its weights loaded. ``devices``: the
    replicas' devices, every visible CUDA device by default (raises
    without one; ``[torch.device("cpu")]`` runs the plain versions).
    ``prefetch`` bounds the chunks in flight."""

    def __init__(self, model: torch.nn.Module, *, head: str = "probs",
                 image_size: int = 224,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prefetch: int = 2,
                 class_names: Optional[Sequence[str]] = None,
                 devices: Optional[Sequence] = None):
        if head not in OFFLINE_HEADS:
            raise ValueError(
                f"unknown head {head!r} ({'|'.join(OFFLINE_HEADS)})")
        if head == "features" and getattr(model, "config", None) is None:
            raise ValueError(
                "head='features' needs a ViT model (a .config with "
                f"pool/embedding_dim); got {type(model).__name__}")
        if devices is None:
            resolve_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.model = model
        self.head = head
        self.image_size = int(image_size)
        self.prefetch = max(1, int(prefetch))
        self.class_names = (list(class_names)
                            if class_names is not None else None)
        self.ladder = shard_ladder(buckets, len(self.devices))
        self._fn = _head_fn(head)
        home = next(model.parameters()).device
        self._replicas = [model.eval() if d == home
                          else copy.deepcopy(model).to(d).eval()
                          for d in self.devices]
        self._copy = [torch.cuda.Stream(d) if d.type == "cuda" else None
                      for d in self.devices]
        self._free: List[list] = [[] for _ in self.devices]
        # The row shape, from one zero image through the first replica (the
        # JAX package traces it with jax.eval_shape).
        with torch.inference_mode():
            row = self._fn(self._replicas[0], torch.zeros(
                1, self.image_size, self.image_size, 3,
                device=self.devices[0]))
        self.out_shape = tuple(int(d) for d in row.shape[1:])
        self.out_dim = int(self.out_shape[-1])

    # ----------------------------------------------------------- identity
    def fingerprint(self) -> str:
        """Identity of the model universe (config + image size,
        :func:`.engine.model_fingerprint`); the manifest also pins head,
        ladder and batch size."""
        return model_fingerprint(self.model, self.image_size)

    # ----------------------------------------------------------- dispatch
    def dispatch(self, padded: np.ndarray) -> List[torch.Tensor]:
        """Queue one padded chunk: its rows split evenly over the replicas
        in device order, each part copied (pinned, on the copy stream) and
        its forward queued. Returns the per-replica outputs, not yet
        waited on."""
        parts = np.split(np.ascontiguousarray(padded, np.float32),
                         len(self.devices))
        outs = []
        for i, (dev, part) in enumerate(zip(self.devices, parts)):
            replica = self._replicas[i]
            if dev.type != "cuda":
                with torch.inference_mode():
                    outs.append(self._fn(replica, torch.from_numpy(part)
                                         .to(dev)))
                continue
            free = self._free[i]
            host = _pinned_copy({"x": part}, free)
            with torch.cuda.device(dev):
                with torch.cuda.stream(self._copy[i]):
                    x = host["x"].to(dev, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(self._copy[i])
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(copied)
                x.record_stream(compute)
                with torch.inference_mode():
                    outs.append(self._fn(replica, x))
            free.append((copied, host))
            del free[:-(self.prefetch + 1)]
        return outs

    # ---------------------------------------------------------------- run
    def run(self, dataset, out_dir: str | Path, *,
            batch_size: Optional[int] = None,
            resume: bool = True,
            limit: Optional[int] = None,
            num_workers: int = 1,
            worker_type: str = "thread",
            readahead: int = 2,
            evict_behind: bool = True,
            checkpoint_every_records: Optional[int] = None,
            checkpoint_every_s: float = 30.0,
            preds_jsonl: bool = False) -> dict:
        """Sweep ``dataset`` into ``out_dir``; returns the run summary.

        ``readahead`` / ``evict_behind``: the sequential scan's page-cache
        discipline."""
        from ..telemetry.registry import get_registry

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        n_total = len(dataset)
        if limit is not None:
            n_total = min(int(limit), n_total)
        if n_total <= 0:
            raise ValueError(f"nothing to do: dataset has {n_total} records")
        bs = int(batch_size) if batch_size else self.ladder[-1]
        fp = self.fingerprint()
        ladder = [int(b) for b in self.ladder]
        n_dev = len(self.devices)

        manifest = load_progress(out) if resume else None
        start = 0
        if manifest is not None:
            start = validate_progress(
                manifest, fingerprint=fp, head=self.head,
                total_records=n_total, out_dim=self.out_dim,
                batch_size=bs, ladder=ladder, row_shape=self.out_shape)
        base = {"fingerprint": fp, "head": self.head,
                "total_records": n_total, "out_dim": self.out_dim,
                "batch_size": bs, "ladder": ladder, "sink": SINK_NAME}
        if len(self.out_shape) > 1:
            base["row_shape"] = [int(d) for d in self.out_shape]

        sink = NpySink(out / SINK_NAME, rows=n_total, dim=self.out_shape,
                       resume=manifest is not None)
        preds = None
        if preds_jsonl and self.head == "probs":
            if manifest is not None and \
                    manifest.get("preds_bytes") is None and start > 0:
                raise ValueError(
                    "resuming with --preds-jsonl but the manifest has no "
                    "preds offset (the original run didn't write the "
                    "mirror) — the file would start mid-dataset; rerun "
                    "with --fresh")
            preds = PredsJsonl(
                out / PREDS_NAME, class_names=self.class_names,
                resume_bytes=(manifest or {}).get("preds_bytes")
                if manifest is not None else None)
        if manifest is None:
            # Claim the directory up front: a later resume validates
            # against this job's identity, and a kill before the first
            # checkpoint restarts cleanly from record 0.
            write_progress(out, {**base, "records_done": 0,
                                 "rows_written": 0,
                                 "preds_bytes": 0 if preds else None})

        if start >= n_total:
            sink.close()
            if preds:
                preds.close()
            return {"records": n_total, "resumed_from": start,
                    "processed": 0, "already_complete": True,
                    "images_per_sec": 0.0, "wall_s": 0.0,
                    "devices": n_dev, "head": self.head,
                    "out_dim": self.out_dim, "sink": str(out / SINK_NAME)}

        loader = DataLoader(
            _RecordRange(dataset, start, n_total), bs, shuffle=False,
            num_workers=max(1, int(num_workers)), worker_type=worker_type,
            readahead=max(0, int(readahead)),
            evict_behind=bool(evict_behind))
        ckpt_records = int(checkpoint_every_records or 32 * bs)

        reg = get_registry()
        reg.gauge("bi_devices", n_dev)
        inflight: deque = deque()   # (outputs, n_real, abs_row)
        stats = {"data_wait_s": 0.0, "drain_s": 0.0, "checkpoints": 0,
                 "drained": start, "t_first_done": None}

        def drain_one() -> None:
            outs, n_real, row = inflight.popleft()
            t0 = time.perf_counter()
            # The oldest chunk in flight to the host for the sink; the
            # prefetch window keeps this wait off the dispatch path.
            rows = np.concatenate([y.cpu().numpy() for y in outs])[:n_real]
            dt = time.perf_counter() - t0
            stats["drain_s"] += dt
            reg.observe("bi_drain_s", dt)
            sink.write(row, rows)
            if preds is not None:
                preds.write(row, rows)
            stats["drained"] += n_real
            if stats["t_first_done"] is None:
                # Everything before the first finished chunk is start-up
                # and pipeline fill; the steady rate excludes it.
                stats["t_first_done"] = time.perf_counter()
                stats["first_images"] = stats["drained"]

        def write_checkpoint(done: int) -> None:
            while inflight:
                drain_one()
            sink.flush()
            pb = preds.flush() if preds is not None else None
            payload = {**base, "records_done": done,
                       "rows_written": done, "preds_bytes": pb}
            if done >= n_total:
                # Completion seals the sink: a consumer can prove the
                # matrix it maps is the bytes this job finished.
                payload["sink_sha256"] = sink_sha256(sink.path)
            write_progress(out, payload)
            stats["checkpoints"] += 1
            reg.count("bi_checkpoints_total")

        t_run0 = time.perf_counter()
        abs_row = start
        done = start
        since_ckpt = 0
        last_ckpt_t = last_log_t = t_run0
        it = iter(loader)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                wait = time.perf_counter() - t0
                if batch is None:
                    break
                stats["data_wait_s"] += wait
                reg.observe("bi_data_wait_s", wait)
                images = batch["image"]
                pos = 0
                for bucket in plan_buckets(len(images), self.ladder):
                    take = min(bucket, len(images) - pos)
                    padded, _ = pad_rows_to_bucket(
                        images[pos:pos + take], bucket)
                    pos += take
                    inflight.append((self.dispatch(padded), take, abs_row))
                    abs_row += take
                    while len(inflight) > self.prefetch:
                        drain_one()
                done += len(images)
                since_ckpt += len(images)
                reg.count("bi_records_total", len(images))
                reg.count("bi_batches_total")
                now = time.perf_counter()
                elapsed = now - t_run0
                reg.gauge("bi_images_per_sec",
                          round((done - start) / max(elapsed, 1e-9), 2))
                reg.gauge("bi_progress_pct",
                          round(100.0 * done / n_total, 2))
                if since_ckpt >= ckpt_records or \
                        now - last_ckpt_t >= checkpoint_every_s:
                    write_checkpoint(done)
                    since_ckpt = 0
                    last_ckpt_t = time.perf_counter()
                if now - last_log_t >= LOG_EVERY_S:
                    rate = (done - start) / max(elapsed, 1e-9)
                    eta = (n_total - done) / max(rate, 1e-9)
                    print(f"[batch_infer] {done}/{n_total} records "
                          f"({100.0 * done / n_total:.1f}%), "
                          f"{rate:.1f} img/s, eta {eta:.0f}s")
                    last_log_t = now
            write_checkpoint(done)
        finally:
            loader.close()
            sink.close()
            if preds is not None:
                preds.close()

        wall = time.perf_counter() - t_run0
        processed = done - start
        steady = None
        t_first = stats["t_first_done"]
        first_images = stats.get("first_images", start)
        if t_first is not None and done > first_images:
            span = time.perf_counter() - t_first
            steady = round((done - first_images) / max(span, 1e-9), 2)
        return {
            "records": n_total,
            "resumed_from": start,
            "processed": processed,
            "wall_s": round(wall, 3),
            "images_per_sec": round(processed / max(wall, 1e-9), 2),
            "steady_images_per_sec": steady,
            "data_wait_s": round(stats["data_wait_s"], 3),
            "drain_s": round(stats["drain_s"], 3),
            "checkpoints": stats["checkpoints"],
            "devices": n_dev,
            "ladder": ladder,
            "batch_size": bs,
            "head": self.head,
            "out_dim": self.out_dim,
            "sink": str(out / SINK_NAME),
            "preds": str(out / PREDS_NAME) if preds_jsonl
            and self.head == "probs" else None,
        }


def sink_sha256(path: str | Path) -> str:
    """Streaming sha256 of a sink file (the kill + resume evidence)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
