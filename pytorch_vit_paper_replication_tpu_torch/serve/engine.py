"""The online inference engine: checkpoint -> warmed, micro-batched model.

Port of the JAX package's ``serve/engine.py``. It wraps a ViT (params on
the engine's device, ``cuda`` unless the caller names another) behind a
:class:`.batching.MicroBatcher` whose device callback is ONE fused
multi-head forward under ``torch.inference_mode()``: the backbone runs
once per device batch and splits at the heads —

* ``probs`` — ``softmax(head(pool(backbone(x))))``, the same ops
  :func:`..predictions.predict_image` runs, so a served classifier row
  equals ``predict_image`` bit for bit at the same batch shape;
* ``features`` — the pooled ``[D]`` embedding in float32;
* ``tokens`` — the full final-LN ``[T, D]`` token sequence in float32.

On a CUDA device every encoder block's MLP half runs the fused
LN->MLP->residual kernel (``mlp_impl="auto"``) and attention runs the
flash kernel when the config asks for it.

Startup **warmup** runs each bucket rung once (zeros input, synchronized)
and records its seconds through ``stats.observe_warmup_rung``; it stands
in for the JAX package's ahead-of-time ``lower().compile()`` (CUDA
graphs come later). ``warmup="async"`` runs the ladder in a background
thread, smallest rung first.

The **warmup manifest** (``warmup.json`` next to the checkpoint) keeps the
JAX package's contract: written at first serve, extended at close with
rungs traffic dispatched beyond the recorded set, consumed and validated
on restart (a mismatched fingerprint or ladder is refused).

``InferenceEngine.from_checkpoint`` loads the port's export (``params.npz``
+ ``transform.json`` + ``model_meta.json``) through the same
:func:`..predictions.load_inference_checkpoint` call prediction uses, so
serving preprocessing cannot drift from offline prediction.

**Embedding search**: with ``search_index`` (a ``tools.build_index``
directory) the engine answers :meth:`InferenceEngine.search`: the query is
embedded through the ``features`` head (coalescing with every other head's
traffic), then a :class:`..search.scan.ShardedScanner` whose shard was
placed on the engine's device once, at construction, finds its nearest
index rows.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import threading
import time
import warnings
from pathlib import Path
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .. import compile_cache
from ..predictions import forward_probs, image_row, resolve_device
from ..utils.atomic import atomic_write_json
from ..utils.digest import resolve_export_dir
from .batching import DEFAULT_TIER, MicroBatcher
from .bucketing import DEFAULT_BUCKETS, plan_buckets
from .stats import ServeStats

WARMUP_MANIFEST = "warmup.json"
# The fused forward's head set, in output order. Requests tag one.
HEADS: Tuple[str, ...] = ("probs", "features", "tokens")


def model_fingerprint(model, image_size: int) -> str:
    """Identity of the served program universe: the model's config
    dataclass (architecture, dtype, attention/mlp impls — everything
    that changes the kernels run) plus the serving image size."""
    ident = getattr(model, "config", None)
    if ident is None:  # non-ViT modules: class name is the best we have
        ident = type(model).__name__
    return compile_cache.config_fingerprint(ident, image_size=image_size)


def write_warmup_manifest(directory: str | Path, *, fingerprint: str,
                          buckets: Sequence[int], image_size: int,
                          dtype: str,
                          heads: Optional[Sequence[str]] = None) -> Path:
    """Record the traffic-proven shape set next to the checkpoint.

    Written via :func:`..utils.atomic.atomic_write_json` (temp-file +
    atomic replace): a replica (or restart) reading concurrently never
    observes a torn file, and a process killed mid-write leaves the
    previous manifest intact. Concurrent writers — replicas sharing
    one checkpoint dir — are last-writer-wins; a rung union lost to
    the race self-heals at that replica's next
    :meth:`InferenceEngine.close`.
    """
    payload = {
        "fingerprint": fingerprint,
        "buckets": sorted(int(b) for b in buckets),
        "image_size": int(image_size),
        "dtype": str(dtype),
    }
    if heads is not None:
        # Informational (the rung set is the warm contract; the fused
        # program serves every head from one executable per rung) —
        # recorded so an operator reading warmup.json can see which
        # heads this checkpoint's serving program answers.
        payload["heads"] = [str(h) for h in heads]
    return atomic_write_json(
        resolve_export_dir(directory) / WARMUP_MANIFEST, payload, indent=2)


def load_warmup_manifest(directory: str | Path) -> Optional[dict]:
    """None when no manifest exists; ValueError (with delete-it
    guidance, not a raw JSON traceback) when one exists but cannot be
    parsed — external tampering or a non-atomic third-party write."""
    path = resolve_export_dir(directory) / WARMUP_MANIFEST
    if not path.is_file():
        return None
    try:
        manifest = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(
            f"corrupt warmup manifest {path}: {e}; delete it and the "
            "next serve will rebuild the shape set") from e
    if not isinstance(manifest, dict):
        raise ValueError(
            f"corrupt warmup manifest {path}: expected a JSON object, "
            f"got {type(manifest).__name__}; delete it and the next "
            "serve will rebuild the shape set")
    return manifest


def validate_warmup_manifest(manifest: dict, *, fingerprint: str,
                             buckets: Sequence[int],
                             image_size: int) -> List[int]:
    """Returns the manifest's rung set, or raises ValueError when the
    manifest belongs to a different program universe — a mismatched
    model-config fingerprint / image size, or a ladder ``plan_buckets``
    on THIS engine's ladder would never dispatch (warming those shapes
    would compile programs no request can ever ride)."""
    if manifest.get("fingerprint") != fingerprint:
        raise ValueError(
            "warmup manifest fingerprint mismatch: the manifest was "
            "written for a different model config/dtype/image size; "
            f"delete {WARMUP_MANIFEST} or serve the matching checkpoint")
    # A missing image_size key is a mismatch, not a pass — defaulting to
    # the engine's own value would make this check vacuous.
    if int(manifest.get("image_size", -1)) != int(image_size):
        raise ValueError(
            f"warmup manifest image_size {manifest.get('image_size')} != "
            f"engine image_size {image_size}")
    rungs = sorted(int(b) for b in manifest.get("buckets", []))
    if not rungs:
        raise ValueError("warmup manifest has no bucket ladder")
    ladder = tuple(sorted(set(int(b) for b in buckets)))
    for r in rungs:
        if plan_buckets(r, ladder) != [r]:
            raise ValueError(
                f"warmup manifest rung {r} disagrees with plan_buckets "
                f"on this engine's ladder {list(ladder)}: no request "
                f"would ever dispatch that shape; delete the manifest "
                f"or serve with the original --buckets")
    return rungs


class ServeResult(NamedTuple):
    label: Any            # class name when known, else the class index
    prob: float
    probs: np.ndarray     # full softmax row, float32 [num_classes]


class InferenceEngine:
    """See module docstring.

    ``max_wait_us`` is the latency/occupancy knob: how long the batcher
    holds the oldest queued request hoping for company. ``max_queue``
    bounds admission (beyond it, ``submit`` raises
    :class:`.batching.QueueFullError` with a retry-after hint).
    """

    def __init__(self, model: torch.nn.Module, *,
                 device=None,
                 image_size: int = 224,
                 transform=None,
                 class_names: Optional[Sequence[str]] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_us: int = 2000,
                 batch_max_wait_us: int = 50_000,
                 max_queue: int = 1024,
                 stats: Optional[ServeStats] = None,
                 segregate_heads: bool = False,
                 warmup: Union[bool, str] = True,
                 warmup_rungs: Optional[Sequence[int]] = None,
                 warmup_callback: Optional[Callable[[int, float],
                                                    None]] = None,
                 search_index=None,
                 search_k_max: int = 100,
                 model_tier: Optional[str] = None):
        from ..data.transforms import eval_transform

        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.image_size = int(image_size)
        self.transform = transform or eval_transform(self.image_size)
        self.class_names = (list(class_names)
                            if class_names is not None else None)
        # Operator-declared deployment tier; wins over the arch-derived
        # label in ::stats.
        self.declared_model_tier = (str(model_tier)
                                    if model_tier else None)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.stats = stats if stats is not None else ServeStats()
        # The fused multi-head forward (see module docstring).
        self._fwd, self.heads = self._make_forward(self.model)
        # Rungs whose warmup forward has run (written by warmup, read by
        # snapshot; set.add is atomic under the GIL).
        self._warm: set = set()
        self._warmup_callback = warmup_callback
        self._warmup_rungs = tuple(sorted(set(
            int(b) for b in (warmup_rungs
                             if warmup_rungs is not None else self.buckets))))
        self._warmup_thread: Optional[threading.Thread] = None
        self._warmup_error: Optional[str] = None
        # (directory, fingerprint, dtype) set by from_checkpoint when
        # manifest upkeep is on; close() extends the recorded rung set
        # with what traffic actually dispatched.
        self._manifest_target: Optional[Tuple[Path, str, str]] = None
        # Content identity of the export this engine answers from (set by
        # from_checkpoint; None for in-memory-constructed engines).
        self.checkpoint_fingerprint: Optional[str] = None
        self.checkpoint_path: Optional[str] = None
        self._search_index = None
        self._scanner = None
        if search_index is not None:
            self._attach_index(search_index, search_k_max)
        self._batcher = MicroBatcher(
            self._device_forward, buckets=self.buckets,
            max_wait_us=max_wait_us, batch_max_wait_us=batch_max_wait_us,
            max_queue=max_queue, stats=self.stats,
            segregate_heads=segregate_heads)
        if warmup == "async":
            self._warmup_thread = threading.Thread(
                target=self._warmup_guarded, name="serve-warmup",
                daemon=True)
            self._warmup_thread.start()
        elif warmup:
            self.warmup()

    def _attach_index(self, search_index, k_max: int) -> None:
        """Open ``search_index`` (an :class:`..search.index.EmbeddingIndex`
        or its directory) and place its rows on this engine's device.
        Refuses a model without the features head and an index whose rows
        are not this model's embedding width; warns when the index was
        embedded by another model universe (fingerprint), as the JAX engine
        does: a numerically identical re-export may carry another one."""
        from ..search.index import EmbeddingIndex
        from ..search.scan import ShardedScanner

        idx = (search_index if isinstance(search_index, EmbeddingIndex)
               else EmbeddingIndex(search_index))
        if "features" not in self.heads:
            raise ValueError(
                "search_index needs the features head; this model serves "
                f"only {list(self.heads)}")
        fp = model_fingerprint(self.model, self.image_size)
        if idx.fingerprint is not None and idx.fingerprint != fp:
            warnings.warn(
                f"search index {idx.path} was built from fingerprint "
                f"{idx.fingerprint}, this engine is {fp}: queries and index "
                "rows may live in different embedding spaces", stacklevel=3)
        if int(idx.dim) != self._feature_dim():
            raise ValueError(
                f"search index dim {idx.dim} != this model's pooled "
                f"embedding dim {self._feature_dim()}")
        self._search_index = idx
        self._scanner = ShardedScanner(
            idx.embeddings, k_max=int(k_max), metric=idx.metric,
            norms=idx.norms, devices=[self.device],
            registry=self.stats.registry)

    def _feature_dim(self) -> int:
        cfg = getattr(self.model, "config", None)
        return int(getattr(cfg, "embedding_dim", -1))

    # ---------------------------------------------------------- device
    @staticmethod
    def _make_forward(model):
        """The fused multi-head forward ``x -> {head: tensor}``.

        For a ViT (a ``.config`` plus ``backbone``/``head`` submodules)
        the backbone runs ONCE and every head is emitted; ``probs`` is
        exactly :func:`..predictions.forward_probs`' expression (the
        ops ``ViT.forward`` runs, then softmax). Any other module serves
        the plain softmax as a ``probs``-only dict.
        """
        from ..models.vit import pool_tokens

        cfg = getattr(model, "config", None)
        multihead = (cfg is not None and hasattr(model, "backbone")
                     and hasattr(model, "head"))
        if not multihead:
            return (lambda x: {"probs": forward_probs(model, x)}), ("probs",)

        def fused(x):
            tokens = model.backbone(x)
            pooled = pool_tokens(cfg, tokens)
            logits = model.head(pooled.float())
            return {"probs": torch.softmax(logits.float(), dim=-1),
                    "features": pooled.float(),
                    "tokens": tokens.float()}
        return fused, HEADS

    def _run(self, padded: np.ndarray) -> Dict[str, torch.Tensor]:
        x = torch.from_numpy(np.ascontiguousarray(padded, np.float32))
        with torch.inference_mode():
            return self._fwd(x.to(self.device))

    def _device_forward(self, padded: np.ndarray, mask: np.ndarray,
                        heads: Optional[Sequence[str]] = None
                        ) -> Dict[str, np.ndarray]:
        # mask rides the eval pad+mask contract: rows of a ViT forward
        # are independent, so correctness needs only that callers never
        # READ pad rows — the batcher slices real rows by construction.
        del mask
        out = self._run(padded)
        # The response drain: one device->host copy per NEEDED head per
        # batch (tokens rows are T x D, not worth shipping unasked).
        need = set(heads) if heads is not None else {"probs"}
        host = {h: v.cpu().numpy() for h, v in out.items() if h in need}
        self.stats.observe_first_batch(
            compile_cache.seconds_since_process_start())
        return host

    def _warmup_rung(self, b: int) -> float:
        """Run one rung's forward once on zeros; returns seconds."""
        t0 = time.perf_counter()
        self._run(np.zeros((b, self.image_size, self.image_size, 3),
                           np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self._warm.add(b)
        self.stats.observe_warmup_rung(b, dt)
        if self._warmup_callback is not None:
            self._warmup_callback(b, dt)
        return dt

    def _warmup_guarded(self) -> None:
        try:
            self.warmup()
        except Exception as e:  # noqa: BLE001 — background thread: the
            # diagnosis rides ::stats instead of a dead thread's traceback.
            self._warmup_error = f"{type(e).__name__}: {e}"

    def warmup(self, rungs: Optional[Sequence[int]] = None) -> List[int]:
        """Run the rung set (default: the warmup ladder) once each before
        serving, smallest first; returns the warmed rungs."""
        t0 = time.perf_counter()
        todo = sorted(set(int(b) for b in (
            rungs if rungs is not None else self._warmup_rungs)))
        for b in todo:
            self._warmup_rung(b)
        self.stats.warmup_finished(time.perf_counter() - t0)
        return todo

    def wait_warm(self, timeout: Optional[float] = None) -> bool:
        """Block until a background (``warmup="async"``) ladder finishes;
        True when every requested rung has run."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout)
        return all(b in self._warm for b in self._warmup_rungs)

    # ------------------------------------------------------------- API
    def _wrap(self, raw: cf.Future) -> cf.Future:
        out: cf.Future = cf.Future()

        def done(f: cf.Future):
            # Every failure mode must land on the future: an exception in
            # a cf callback is logged, not raised, and would leave `out`
            # unresolved.
            try:
                err = f.exception()
                if err is not None:
                    out.set_exception(err)
                    return
                probs = np.asarray(f.result())
                idx = int(probs.argmax())
                label = (self.class_names[idx]
                         if self.class_names is not None else idx)
                out.set_result(ServeResult(label, float(probs[idx]), probs))
            except Exception as e:  # noqa: BLE001
                if not out.done():
                    out.set_exception(e)

        raw.add_done_callback(done)
        return out

    def submit(self, image, timeout: Optional[float] = None,
               head: str = "probs",
               tier: str = DEFAULT_TIER, ctx=None) -> cf.Future:
        """Enqueue one image (path / PIL / preprocessed array); returns
        a Future of :class:`ServeResult` (``head="probs"``) or of the
        raw float32 row — ``[D]`` for ``features``, ``[T, D]`` for
        ``tokens``. ``tier`` picks the SLO class (``interactive`` |
        ``batch``). Raises :class:`.batching.QueueFullError` under
        backpressure and ValueError for a head this model cannot serve."""
        if head not in self.heads:
            raise ValueError(
                f"unknown head {head!r}; this engine serves "
                f"{list(self.heads)}")
        raw = self._batcher.submit(image_row(image, self.transform),
                                   timeout=timeout, head=head, tier=tier,
                                   ctx=ctx)
        return self._wrap(raw) if head == "probs" else raw

    def predict(self, images: Sequence,
                timeout: Optional[float] = None) -> List[ServeResult]:
        """Synchronous convenience: submit all, wait for all."""
        futures = [self.submit(img, timeout=timeout) for img in images]
        return [f.result() for f in futures]

    @property
    def search_index(self):
        """The attached :class:`..search.index.EmbeddingIndex`, or None
        when this engine serves no ``::search`` traffic."""
        return self._search_index

    def search(self, image, k: int, *, tier: str = DEFAULT_TIER,
               timeout: Optional[float] = None
               ) -> Tuple[List[int], List[float]]:
        """Embed ``image`` through the features head (coalescing with
        every other head's traffic in the micro-batcher) and scan the
        attached index; returns ``(row_ids, scores)`` of the K nearest
        index rows, best first. Equal bit for bit to embedding the same
        image offline at the same batch shape and scanning the same index
        (a lone request rides bucket 1; the scan's rows do not depend on
        the chunk)."""
        if self._scanner is None:
            raise ValueError(
                "no search index attached (serve --search-index DIR after "
                "building one with tools.build_index)")
        if not 1 <= int(k) <= self._scanner.k_max:
            raise ValueError(
                f"k={k} outside [1, {self._scanner.k_max}] (bound at "
                "engine construction by search_k_max and the index size)")
        emb = self._batcher.submit(
            image_row(image, self.transform), timeout=timeout,
            head="features", tier=tier).result()
        scores, ids = self._scanner.scan(
            np.asarray(emb, np.float32)[None, :], int(k))
        return [int(i) for i in ids[0]], [float(s) for s in scores[0]]

    def publish_telemetry(self, registry=None):
        """Sync this engine's live state into the telemetry registry
        (``serve_*`` names) and return it: the one publish path shared by
        ``::metrics`` and the fleet shipper's per-frame ``pre_ship``, so a
        scraped endpoint and a shipped frame agree on what "current"
        means. Defaults to the stats' bound registry (where the
        ``serve_lat_*_s`` histogram samples already stream)."""
        reg = registry if registry is not None else self.stats.registry
        self.stats.publish(reg)
        reg.gauge("serve_queue_depth", self._batcher.queue_depth())
        reg.gauge("serve_warm_rungs", len(self._warm))
        return reg

    def prometheus_metrics(self) -> str:
        """The live registry as Prometheus text: serving stats synced in
        (``serve_*``) plus whatever else this process published. The
        serve CLI's ``::metrics`` answers exactly this."""
        return self.publish_telemetry().to_prometheus()

    def snapshot(self) -> dict:
        """Serving stats + engine config, JSON-serializable."""
        snap = self.stats.snapshot()
        snap["served_heads"] = list(self.heads)
        snap["buckets"] = list(self.buckets)
        snap["effective_bucket_cap"] = self._batcher.effective_bucket_cap
        snap["queue_depth"] = self._batcher.queue_depth()
        snap["warm_rungs"] = sorted(self._warm)
        snap["search_index"] = (self._search_index.describe()
                                if self._search_index is not None else None)
        snap["device"] = str(self.device)
        snap["checkpoint_fingerprint"] = self.checkpoint_fingerprint
        snap["checkpoint_path"] = self.checkpoint_path
        if self.declared_model_tier is not None:
            snap["model_tier"] = self.declared_model_tier
        else:
            cfg = getattr(self.model, "config", None)
            if cfg is not None:
                from ..configs import model_tier
                snap["model_tier"] = model_tier(cfg)
            else:
                snap["model_tier"] = None
        if self._warmup_error is not None:
            snap["warmup"]["error"] = self._warmup_error
        return snap

    def _extend_manifest(self) -> None:
        """Union the rungs traffic actually dispatched into the manifest
        (best-effort)."""
        if self._manifest_target is None:
            return
        dispatched = set(self.stats.dispatched_buckets())
        directory, fp, dtype = self._manifest_target
        try:
            existing = load_warmup_manifest(directory)
        except ValueError:
            existing = None  # corrupt: the rewrite below repairs it
        recorded = set(existing.get("buckets", [])) if existing else set()
        if not dispatched - recorded:
            return
        try:
            write_warmup_manifest(
                directory, fingerprint=fp,
                buckets=sorted(recorded | dispatched),
                image_size=self.image_size, dtype=dtype,
                heads=self.heads)
        except OSError:
            pass  # read-only checkpoint dir: startup already warned

    def drain(self, timeout_s: float = 10.0) -> int:
        """Quiesce the micro-batcher: new submits fail with
        ``DrainingError``, in-flight work flushes, returns the
        unfinished count."""
        return self._batcher.drain(timeout_s)

    def resume(self) -> None:
        """Lift a :meth:`drain` — admissions open again."""
        self._batcher.resume()

    def close(self) -> None:
        self._batcher.close()
        if self._warmup_thread is not None:
            self._warmup_thread.join()
        self._extend_manifest()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------ constructors
    @classmethod
    def from_checkpoint(cls, checkpoint: str | Path, *,
                        preset: str = "ViT-B/16",
                        class_names: Optional[Sequence[str]] = None,
                        num_classes: Optional[int] = None,
                        image_size: Optional[int] = None,
                        normalize: Optional[bool] = None,
                        use_manifest: bool = True,
                        device=None,
                        config_overrides: Optional[dict] = None,
                        **engine_kwargs) -> "InferenceEngine":
        """Load the port's export (or a training ``--checkpoint-dir``)
        onto ``device`` and build a warmed engine, honoring
        ``transform.json`` exactly as prediction does.

        With ``use_manifest`` (default), an existing ``warmup.json``
        narrows warmup to the recorded rung set (validated against this
        engine's fingerprint and ladder; an explicit ``warmup_rungs``
        wins); when absent and warmup is enabled, one is written at
        first serve (best-effort). ``config_overrides`` replace
        :class:`..configs.ViTConfig` fields of the preset (e.g.
        ``{"dtype": "float32"}`` or ``{"attention_impl": "flash"}``).
        """
        from ..predictions import load_inference_checkpoint
        from ..utils.digest import cached_checkpoint_fingerprint

        if class_names is None and num_classes is None:
            raise ValueError("pass class_names or num_classes")
        n_classes = (len(class_names) if class_names is not None
                     else int(num_classes))
        model, transform, spec = load_inference_checkpoint(
            checkpoint, preset, n_classes, image_size=image_size,
            normalize=normalize, device=device, **(config_overrides or {}))
        ladder = engine_kwargs.get("buckets", DEFAULT_BUCKETS)
        fp = model_fingerprint(model, spec["image_size"])
        manifest = load_warmup_manifest(checkpoint) if use_manifest else None
        if manifest is not None and "warmup_rungs" not in engine_kwargs:
            engine_kwargs["warmup_rungs"] = validate_warmup_manifest(
                manifest, fingerprint=fp, buckets=ladder,
                image_size=spec["image_size"])
        eng = cls(model, device=device, image_size=spec["image_size"],
                  transform=transform, class_names=class_names,
                  **engine_kwargs)
        resolved = resolve_export_dir(checkpoint)
        eng.checkpoint_fingerprint = cached_checkpoint_fingerprint(
            resolved)
        eng.checkpoint_path = str(resolved)
        dtype = str(model.config.dtype)
        if use_manifest:
            eng._manifest_target = (Path(checkpoint), fp, dtype)
        if (use_manifest and manifest is None
                and engine_kwargs.get("warmup", True)):
            try:
                write_warmup_manifest(
                    checkpoint, fingerprint=fp, buckets=eng.buckets,
                    image_size=eng.image_size, dtype=dtype,
                    heads=eng.heads)
            except OSError as e:
                warnings.warn(
                    f"could not write {WARMUP_MANIFEST} next to the "
                    f"checkpoint ({e}); restarts will warm the full "
                    f"ladder instead of the traffic-proven set",
                    stacklevel=2)
        return eng
