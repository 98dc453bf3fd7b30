"""Image-folder dataset and the port's loader (a port of the JAX package's
``data/image_folder.py``).

Replaces ``going_modular/going_modular/data_setup.py``: directory-per-class
datasets (class = sorted subdir name, reference data_setup.py:47), shuffled
batching, and worker-parallel JPEG decode. The per-epoch order, the
per-host slices, the padding masks and the mid-epoch skip are the JAX
loader's, bit for bit (a function of ``(seed, epoch)``). Decoding runs in a
thread pool (PIL and the native decoder release the GIL) or in forked
worker processes; :func:`prefetch_to_device` overlaps the host-to-device
copy of the next batches with the device's work on the current one
(pinned host buffers, a side CUDA stream).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import multiprocessing
import os
import time
import warnings
from pathlib import Path
from typing import (Any, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
from PIL import Image

from .sampler import (DEFAULT_SHUFFLE_BLOCK, BlockReadahead,
                      windowed_shuffle_order)
from .transforms import Transform, default_transform, native_plan

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")

# Reference data_setup.py:10 uses os.cpu_count() fork workers; threads are
# the default here (PIL/libjpeg release the GIL for the decode itself) with
# worker_type="process" providing the reference's forked-worker semantics
# for multi-core hosts — see DataLoader.
NUM_WORKERS = min(32, os.cpu_count() or 1)

# --- process-worker plumbing ----------------------------------------------
# Forked workers find the dataset here by token instead of unpickling a copy
# per task: fork shares the parent's pages copy-on-write (torch DataLoader's
# trick, its dataloader fork workers per reference data_setup.py:50-63), so
# per task only the index slice travels in and the stacked batch travels
# out. The parent registers the dataset BEFORE the first submit —
# ProcessPoolExecutor forks its workers lazily at submit time, so
# registering after the (fallible) pool constructor is still early enough
# while keeping a failed constructor from leaking the entry — and
# unregisters when iteration ends.
_FORK_DATASETS: Dict[int, object] = {}
_fork_tokens = itertools.count()

def _foreign_transform_stages(t) -> List[str]:
    """Names of leaf callables in a transform tree defined OUTSIDE this
    package — the candidates for the process-worker fork-safety warning.
    Descends through the package's ``Compose`` (its ``transforms`` list)
    and ``functools.partial`` wrappers, so a package pipeline wrapping a
    user callable is still caught and a partial of a package function is
    not flagged spuriously."""
    import functools

    if isinstance(t, functools.partial):
        return _foreign_transform_stages(t.func)
    stages = getattr(t, "transforms", None)
    if isinstance(stages, (list, tuple)):
        out: List[str] = []
        for s in stages:
            out.extend(_foreign_transform_stages(s))
        return out
    # Functions/lambdas carry __module__ themselves; instance lookup
    # falls through to the class, so one getattr covers both.
    mod = getattr(t, "__module__", "") or ""
    if isinstance(mod, str) and mod.startswith(
            (__package__ or ".").split(".")[0]):
        return []
    return [getattr(t, "__name__", type(t).__name__)]


_fork_expectations_said = False


def _warn_fork_expectations_once() -> None:
    """One log line, at the first process-worker DataLoader construction,
    naming the fork warning the pooled epochs WILL emit on Python >= 3.12
    (CPython's DeprecationWarning about fork in a multi-threaded process),
    so it does not read as a failure."""
    global _fork_expectations_said
    if _fork_expectations_said:
        return
    _fork_expectations_said = True
    import sys
    print(
        "[data] worker_type='process': forked decode workers (torch "
        "num_workers semantics)."
        + (" EXPECTED at the first pooled epoch, NOT a failure: CPython's "
           "DeprecationWarning about fork in a multi-threaded process."
           if sys.version_info >= (3, 12) else "")
        + " Workers run numpy/PIL/ctypes decode only, never torch.cuda; "
        "custom transform callables must not touch the device either.",
        file=sys.stderr)


def _load_arrays(dataset, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decode+stack one batch worth of samples (shared by both pools)."""
    items = [dataset[int(i)] for i in idxs]
    # copy=False: transforms already emit float32; a plain astype would
    # re-copy the whole stacked batch.
    images = np.stack([x for x, _ in items]).astype(np.float32, copy=False)
    labels = np.asarray([y for _, y in items], np.int32)
    return images, labels


def _forked_load_arrays(token: int, idxs: np.ndarray):
    return _load_arrays(_FORK_DATASETS[token], idxs)


def _init_fork_worker(pool_seed: Tuple[int, ...], counter) -> None:
    """Process-pool initializer (runs once per forked worker): hand the
    worker a deterministic identity so ``ThreadLocalRng`` seeds its
    augmentation stream from ``[seed, ordinal, *pool_seed, worker]``
    instead of OS entropy — ``--seed`` then reproduces process-worker
    draws the way it reproduces thread-worker draws (torch seeds workers
    base_seed + worker_id the same way). ``counter`` is a
    fork-shared ``multiprocessing.Value`` so concurrently-spawned workers
    claim distinct ordinals."""
    with counter.get_lock():
        ordinal = counter.value
        counter.value += 1
    from .transforms import _set_fork_worker_token
    _set_fork_worker_token((*pool_seed, ordinal))


class ImageFolderDataset:
    """``torchvision.datasets.ImageFolder`` equivalent.

    Classes are the sorted subdirectory names of ``root``; samples are every
    image file beneath them.

    JPEG samples whose transform matches a natively-supported pipeline
    (``transforms.native_plan``) decode through the C fast path
    (:mod:`..native` — libjpeg scaled decode + fused resize/crop) when the
    library is available; everything else, and any decode failure, uses
    PIL. ``native_decode=False`` forces the PIL path; the two resample
    kernels differ by <1/255 on average.
    """

    def __init__(self, root: str | Path,
                 transform: Optional[Transform] = None,
                 *, native_decode: bool = True):
        self.root = Path(root)
        if not self.root.is_dir():
            raise FileNotFoundError(f"dataset root {self.root} not found")
        self.classes: List[str] = sorted(
            d.name for d in self.root.iterdir() if d.is_dir())
        if not self.classes:
            raise ValueError(f"no class subdirectories under {self.root}")
        self.class_to_idx: Dict[str, int] = {
            c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[Path, int]] = []
        for cls in self.classes:
            for p in sorted((self.root / cls).rglob("*")):
                if p.suffix.lower() in IMG_EXTENSIONS:
                    self.samples.append((p, self.class_to_idx[cls]))
        if not self.samples:
            raise ValueError(f"no images found under {self.root}")
        self.transform = transform or default_transform()
        self._plan = (native_plan(self.transform)
                      if native_decode else None)

    def __len__(self) -> int:
        return len(self.samples)

    def _native_item(self, path: Path) -> Optional[np.ndarray]:
        if self._plan is None or path.suffix.lower() not in (".jpg",
                                                             ".jpeg"):
            return None
        from .. import native
        plan = self._plan
        arr = native.decode_jpeg_file(path, plan.crop, plan.mode,
                                      plan.resize)
        if arr is None:
            return None
        if plan.to_float:
            # One fused pass (uint8 in, float32 out), not astype-then-
            # divide — same trick as imagenet.ToFloatArray.
            arr = np.multiply(arr, np.float32(1.0 / 255.0),
                              dtype=np.float32)
        if plan.normalize is not None:
            arr = plan.normalize(arr)
        return arr

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        fast = self._native_item(path)
        if fast is not None:
            return fast, label
        with Image.open(path) as img:
            return np.asarray(self.transform(img)), label


class CachedDataset:
    """Memoize another dataset's decoded items in RAM (tf.data
    ``.cache()`` semantics): the first epoch pays JPEG decode + transform,
    later epochs serve arrays at memory speed.

    The right call whenever the decoded set fits host RAM (pizza_steak_sushi
    is ~90 MB decoded; CIFAR-10 at 224px is ~30 GB — don't). On a 1-core
    host, decode throughput caps cold-epoch rate; caching removes the cap
    for every epoch after the first.

    Refuses stochastic transforms: memoizing the post-transform array would
    replay epoch 1's random draws forever, silently disabling augmentation.
    Datasets with augmentations should cache below the random stages —
    memoize the deterministic decode/resize prefix and re-apply the random
    stages per epoch — or not cache at all.
    """

    def __init__(self, base):
        if getattr(getattr(base, "transform", None), "stochastic", False):
            raise ValueError(
                "CachedDataset would freeze this dataset's stochastic "
                "transform (augmentations would replay epoch 1's draws "
                "every epoch); drop cache=True or move the random stages "
                "out of the cached dataset")
        self._base = base
        self._items: List[Optional[Tuple[np.ndarray, int]]] = \
            [None] * len(base)
        self.classes = getattr(base, "classes", None)

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx: int):
        item = self._items[idx]
        if item is None:
            # Benign race under threads: both decode, one wins — same value.
            item = self._items[idx] = self._base[idx]
        return item


class ArrayDataset:
    """In-memory dataset of (images NHWC, labels) — synthetic data, CIFAR
    arrays, or test fixtures."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 classes: Optional[Sequence[str]] = None):
        assert len(images) == len(labels)
        self.images = images
        self.labels = labels
        self.classes = list(classes) if classes is not None else [
            str(i) for i in range(int(labels.max()) + 1)]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], int(self.labels[idx])


class DataLoader:
    """Shuffling, batching, worker-parallel loader.

    Per-epoch iteration order is derived from ``(seed, epoch)`` so runs are
    reproducible and multi-host shards stay disjoint: each host sees
    ``indices[process_index::process_count]`` of the same global shuffle —
    global batch semantics match the reference's single shuffled loader.

    ``worker_type`` selects the decode pool. ``"thread"`` (default) decodes
    in a thread pool: zero IPC cost, and PIL/libjpeg/the native decoder
    release the GIL for the decode itself — but the transform's numpy
    stages and batch stacking still serialize on the GIL, which caps the
    rate on many-core hosts. ``"process"`` forks worker processes (the
    reference's torch ``num_workers`` semantics, data_setup.py:50-63):
    the whole per-batch pipeline runs outside the parent's GIL, at the
    price of pickling each finished batch back over a pipe. For
    deterministic transforms the batches are bit-identical either way
    (the per-batch work is pure given the indices); stochastic
    transforms draw from differently-seeded per-worker generators
    (``ThreadLocalRng``), so augmented batches match thread workers
    statistically, not bitwise — the same contract as across two
    thread-pool runs.
    Process workers need POSIX fork and do not see parent-side caches —
    a ``CachedDataset`` would re-decode every epoch in the workers, so
    that combination is rejected (cache in the parent with threads, or
    pack the dataset instead). They pay off on many-core hosts, where the
    thread pool's GIL-bound stages cap the rate.

    Fork-safety caveat: the parent is a multithreaded torch process (with
    a CUDA context when it trains on the card), and the forked children
    inherit whatever lock state its background threads held. The worker
    code path touches only numpy/PIL/the ctypes decoder — never
    ``torch.cuda`` (pinning and the device copy happen in the parent,
    :func:`prefetch_to_device`) — the same discipline torch's own forked
    ``DataLoader`` workers follow; keep custom ``transform`` callables off
    the device under ``worker_type="process"`` or the child can deadlock.
    Construction with process workers says this once on stderr (plus a
    ``UserWarning`` when the transform is not one of this package's own
    pipelines).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = NUM_WORKERS,
                 worker_type: str = "thread",
                 process_index: int = 0, process_count: int = 1,
                 pad_shards: bool = False,
                 shuffle_window: int = 0,
                 shuffle_block: int = DEFAULT_SHUFFLE_BLOCK,
                 readahead: int = 0,
                 evict_behind: bool = False,
                 emit_indices: bool = False):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"unknown worker_type {worker_type!r}")
        if worker_type == "process":
            if "fork" not in multiprocessing.get_all_start_methods():
                raise ValueError(
                    "worker_type='process' needs the POSIX fork start "
                    "method (copy-on-write dataset sharing); use "
                    "worker_type='thread' on this platform")
            if isinstance(dataset, CachedDataset):
                raise ValueError(
                    "worker_type='process' with CachedDataset: the cache "
                    "would fill inside the forked workers and be discarded "
                    "with them, silently re-decoding every epoch — use "
                    "thread workers with caching, or drop the cache")
            # The fork-safety contract is enforceable only by convention
            # for user-supplied transform callables, so say it ONCE at
            # construction, where the stack trace points at the caller's
            # own DataLoader(...) call.
            transform = getattr(dataset, "transform", None)
            foreign = (_foreign_transform_stages(transform)
                       if transform is not None else [])
            if foreign:
                warnings.warn(
                    "worker_type='process' with custom transform "
                    f"stage(s) {foreign!r}: forked decode workers "
                    "inherit the multithreaded parent's lock state, "
                    "so these callables must not touch torch.cuda/the "
                    "device runtime or the child can deadlock (keep them "
                    "numpy/PIL-only; this package's own transform "
                    "pipelines are audited for that discipline)",
                    stacklevel=2)
            _warn_fork_expectations_once()
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.worker_type = worker_type
        self.process_index = process_index
        self.process_count = process_count
        # pad_shards=True (eval loaders): pad the global index list UP to a
        # multiple of process_count, with a 0/1 "mask" key marking real
        # rows, so every example is evaluated exactly once per epoch.
        # False (train): truncate down — dropping <process_count samples of
        # a shuffled epoch beats biasing gradients with duplicates.
        self.pad_shards = pad_shards
        # Streaming windowed shuffle (sampler.py): >0 replaces the global
        # permutation with shuffled blocks + a bounded shuffle window, so
        # epoch I/O is one sequential scan with O(window) record-data
        # working set — the working-sets-much-larger-than-RAM regime.
        # 0 keeps the exact global-permutation order of prior rounds.
        self.shuffle_window = max(0, int(shuffle_window))
        self.shuffle_block = max(1, int(shuffle_block))
        # readahead>0: keep that many upcoming blocks hinted into the page
        # cache ahead of the consumer (needs a dataset with
        # willneed_records, e.g. PackedShardDataset; silently inert
        # otherwise). evict_behind additionally drops fully-consumed
        # blocks, bounding the resident set — the knob the scale harness
        # uses to emulate pack >> RAM on RAM-rich hosts.
        self.readahead = max(0, int(readahead))
        self.evict_behind = bool(evict_behind)
        # emit_indices: each batch additionally carries "index" — the
        # int64 dataset ordinals of its rows. Shuffle/shard/resume proof:
        # whatever order the epoch visits records in, a consumer keyed by
        # ordinal (the KD path gathering teacher-logit sink rows) stays
        # aligned with the images it sees.
        self.emit_indices = bool(emit_indices)
        self.epoch = 0
        # One-shot: the NEXT __iter__ starts this many batches into its
        # epoch (mid-epoch resume). Index-level slice — skipped batches
        # cost nothing, unlike consuming them through the decode pipeline.
        self.skip_next_batches = 0
        # Persistent process pool (torch persistent_workers semantics):
        # created at first pooled __iter__, reused across epochs, torn
        # down by close()/GC. _pool_generation feeds the deterministic
        # fork-worker seed token so a re-created pool (after close or a
        # worker crash) draws fresh streams instead of replaying.
        self._pool: Optional[cf.ProcessPoolExecutor] = None
        self._pool_token: Optional[int] = None
        self._pool_generation = 0
        self._last_block_order: Optional[np.ndarray] = None

    def _local_count(self) -> int:
        n = len(self.dataset)
        if self.process_count == 1:
            return n
        # A common per-host length so every host runs the same number of
        # (collective) steps per epoch.
        if self.pad_shards:
            return -(-n // self.process_count)
        return n // self.process_count

    def __len__(self) -> int:
        n = self._local_count()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _local_indices(self, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, valid) for this host — `valid` flags non-pad rows.

        Also records the epoch's block visit order (for the readahead
        controller) on ``self._last_block_order``: the shuffled block
        sequence under windowed shuffling, the sequential block sequence
        when unshuffled, None under the global permutation (no block
        structure to stream).
        """
        n = len(self.dataset)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        if self.shuffle and self.shuffle_window > 0:
            order, self._last_block_order = windowed_shuffle_order(
                n, self.shuffle_window, self.shuffle_block, rng)
        elif self.shuffle:
            order = rng.permutation(n)
            self._last_block_order = None
        else:
            order = np.arange(n)
            self._last_block_order = np.arange(-(-n // self.shuffle_block))
        valid = np.ones(n, bool)
        if self.process_count > 1 and self.pad_shards:
            pad = (-n) % self.process_count
            if pad:
                order = np.concatenate([order, order[:pad]])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
        local = slice(self.process_index, None, self.process_count)
        count = self._local_count()
        return order[local][:count], valid[local][:count]

    def _ensure_process_pool(self) -> cf.ProcessPoolExecutor:
        """The persistent forked decode pool (torch ``persistent_workers``
        semantics): forked once at the first pooled epoch
        and reused until close()/GC, so epoch boundaries stop paying a
        full worker re-fork and never run transient 2x worker sets. The
        pool initializer hands each worker a deterministic
        ``(seed, generation, ordinal)`` identity for seeded augmentation
        draws (see ``_init_fork_worker``)."""
        if self._pool is None:
            ctx = multiprocessing.get_context("fork")
            counter = ctx.Value("i", 0)
            # Pool ctor first (may raise, e.g. EMFILE building its
            # pipes): registering the dataset only afterwards means a
            # failed ctor can't leak the registry entry. Workers fork
            # later, at first submit, so they still see the registration.
            pool = cf.ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_init_fork_worker,
                initargs=((self.seed, self._pool_generation), counter))
            self._pool_generation += 1
            self._pool_token = next(_fork_tokens)
            _FORK_DATASETS[self._pool_token] = self.dataset
            self._pool = pool
        return self._pool

    def close(self) -> None:
        """Tear down the persistent process pool (if any). Safe to call
        repeatedly; the next pooled epoch re-forks with a fresh
        generation token."""
        pool, token = self._pool, self._pool_token
        self._pool = self._pool_token = None
        if token is not None:
            _FORK_DATASETS.pop(token, None)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _make_readahead(self) -> Optional[BlockReadahead]:
        """A BlockReadahead for this epoch, or None when not applicable
        (readahead off, global-permutation order, or a dataset without
        the ``willneed_records`` hook)."""
        if (self.readahead <= 0 or self._last_block_order is None
                or not hasattr(self.dataset, "willneed_records")):
            return None
        return BlockReadahead(
            self.dataset, self._last_block_order, self.shuffle_block,
            len(self.dataset), depth=self.readahead,
            window=self.shuffle_window, process_count=self.process_count,
            evict_behind=self.evict_behind)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices, valid = self._local_indices(self.epoch)
        self.epoch += 1
        skipped_records = 0
        if self.skip_next_batches:
            start = self.skip_next_batches * self.batch_size
            skipped_records = min(start, len(indices))
            indices, valid = indices[start:], valid[start:]
            self.skip_next_batches = 0
        nb = len(indices) // self.batch_size if self.drop_last else \
            (len(indices) + self.batch_size - 1) // self.batch_size
        with_mask = not bool(valid.all())

        def assemble(bi: int, images: np.ndarray,
                     labels: np.ndarray) -> Dict[str, np.ndarray]:
            batch = {"image": images, "label": labels}
            if with_mask:
                sl = slice(bi * self.batch_size, (bi + 1) * self.batch_size)
                batch["mask"] = valid[sl].astype(np.float32)
            if self.emit_indices:
                # `indices` is already the post-skip slice, so bi-local
                # positions map straight to dataset ordinals.
                batch["index"] = batch_indices(bi).astype(np.int64)
            return batch

        def batch_indices(bi: int) -> np.ndarray:
            return indices[bi * self.batch_size:(bi + 1) * self.batch_size]

        readahead = self._make_readahead()

        # The data pipeline's leg of the shared telemetry registry
        # (telemetry/): produced-batch/epoch counters + last-epoch
        # produce time. One counter bump per BATCH (not per record) —
        # negligible next to a decode.
        from ..telemetry.registry import get_registry
        reg = get_registry()
        epoch_t0 = time.perf_counter()

        def consumed(bi: int) -> None:
            reg.count("data_batches_total")
            if readahead is not None:
                readahead.advance(skipped_records
                                  + (bi + 1) * self.batch_size)

        # process mode with num_workers=1 still forks its one worker
        # (torch num_workers=1 semantics: decode moves OFF the training
        # process — that offload is the flag's whole point); only a
        # single-batch epoch stays serial.
        serial = nb <= 1 or (self.num_workers <= 1
                             and self.worker_type != "process")
        try:
            if serial:
                for bi in range(nb):
                    yield assemble(bi, *_load_arrays(self.dataset,
                                                     batch_indices(bi)))
                    consumed(bi)
                return

            # One sliding-window prefetch scheduler for both pool
            # flavors: decode batch b+1..b+depth while batch b trains;
            # workers return raw (images, labels) and the parent attaches
            # mask rows.
            if self.worker_type == "process":
                pool = self._ensure_process_pool()
                token = self._pool_token

                def submit(bi: int):
                    return pool.submit(_forked_load_arrays, token,
                                       batch_indices(bi))
            else:
                pool = cf.ThreadPoolExecutor(self.num_workers)

                def submit(bi: int):
                    return pool.submit(_load_arrays, self.dataset,
                                       batch_indices(bi))

            depth = min(4, nb)
            pending = {}
            try:
                pending = {bi: submit(bi) for bi in range(min(depth, nb))}
                for bi in range(nb):
                    nxt = bi + depth
                    if nxt < nb:
                        pending[nxt] = submit(nxt)
                    yield assemble(bi, *pending.pop(bi).result())
                    consumed(bi)
            except cf.BrokenExecutor:
                # A dead worker poisons the whole pool: drop it so the
                # next epoch re-forks (with a fresh generation token —
                # no draw replay) instead of failing forever.
                self.close()
                raise
            finally:
                # Abandoned epochs (early generator close) must not leave
                # the persistent pool decoding stale batches.
                for f in pending.values():
                    f.cancel()
                if self.worker_type != "process":
                    pool.shutdown(wait=False, cancel_futures=True)
        finally:
            reg.count("data_epochs_total")
            reg.gauge("data_last_epoch_s",
                      round(time.perf_counter() - epoch_t0, 3))
            if readahead is not None:
                readahead.close()


def pad_batch(batch: Dict[str, np.ndarray],
              multiple: int) -> Dict[str, np.ndarray]:
    """Pad a ragged batch up to a multiple of `multiple` and add a 0/1
    ``mask`` marking real rows.

    Data-parallel sharding needs the batch divisible by the data-axis size;
    eval must still count only real examples (the reference's
    mean-of-batch-means would miscount here).
    The pad rows replicate row 0 so dtype/shape stay uniform. An existing
    ``mask`` (e.g. from a pad_shards multi-host loader) is extended, never
    overwritten.
    """
    n = batch["label"].shape[0]
    pad = (-n) % multiple
    mask = np.asarray(batch.get("mask", np.ones(n, np.float32)), np.float32)
    if pad == 0:
        return {**batch, "mask": mask}
    out = {}
    for k, v in batch.items():
        if k == "mask":
            continue
        filler = np.repeat(v[:1], pad, axis=0)
        out[k] = np.concatenate([v, filler], axis=0)
    out["mask"] = np.concatenate([mask, np.zeros(pad, np.float32)])
    return out


def _pinned_copy(batch: Dict[str, np.ndarray],
                 free: List[Tuple[torch.cuda.Event, Dict[str, torch.Tensor]]]
                 ) -> Dict[str, torch.Tensor]:
    """``batch`` copied into pinned host tensors: a set from ``free`` whose
    shapes and dtypes match (waiting for its last copy event first, so a
    buffer is never rewritten while the card may still read it), else a
    new set."""
    src = {k: torch.as_tensor(v) for k, v in batch.items()}
    want = {k: (tuple(t.shape), t.dtype) for k, t in src.items()}
    host = None
    for i, (event, bufs) in enumerate(free):
        if {k: (tuple(t.shape), t.dtype) for k, t in bufs.items()} == want:
            del free[i]
            event.synchronize()
            host = bufs
            break
    if host is None:
        host = {k: torch.empty(shape, dtype=dt, pin_memory=True)
                for k, (shape, dt) in want.items()}
    for k, t in src.items():
        host[k].copy_(t)
    return host


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]],
                       size: int = 2, device=None
                       ) -> Iterator[Dict[str, Any]]:
    """Overlap the host-to-device copy of the next batches with the
    device's work on the current one — the counterpart of the JAX
    package's ``prefetch_to_device`` and of the reference's
    ``pin_memory=True`` + per-batch ``.to(device)`` (engine.py:47).

    On a CUDA ``device`` each numpy batch is copied into pinned host
    tensors, then sent with ``.to(device, non_blocking=True)`` on a side
    ``torch.cuda.Stream``; ``size`` batches are kept in flight. A batch is
    yielded only after the consumer's current stream has been made to wait
    on its copy's event (and its tensors are recorded on that stream, so
    the caching allocator keeps them until the consumer's work is done).
    A pinned buffer set is reused only after its copy's event has
    completed. Any other device (``"cpu"``, the tests' host) passes the
    batches through unchanged.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        yield from iterator
        return
    stream = torch.cuda.Stream(dev)
    free: List[Tuple[torch.cuda.Event, Dict[str, torch.Tensor]]] = []
    queue = collections.deque()

    def put(batch):
        host = _pinned_copy(batch, free)
        with torch.cuda.stream(stream):
            out = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        queue.append((out, event, host))

    def take():
        out, event, host = queue.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        for t in out.values():
            t.record_stream(consumer)
        free.append((event, host))
        del free[:-(size + 1)]
        return out

    for batch in iterator:
        put(batch)
        if len(queue) >= size:
            yield take()
    while queue:
        yield take()


def create_dataloaders(
    train_dir: str | Path,
    test_dir: str | Path,
    transform: Optional[Transform] = None,
    batch_size: int = 32,
    num_workers: int = NUM_WORKERS,
    *,
    eval_transform: Optional[Transform] = None,
    seed: int = 0,
    drop_last_train: bool = False,
    process_index: int = 0,
    process_count: int = 1,
    cache: bool = False,
    worker_type: str = "thread",
    shuffle_window: int = 0,
    shuffle_block: int = DEFAULT_SHUFFLE_BLOCK,
    readahead: int = 0,
    evict_behind: bool = False,
) -> Tuple[DataLoader, DataLoader, List[str]]:
    """API-parity port of ``data_setup.create_dataloaders`` (its :12-65).

    Returns ``(train_loader, test_loader, class_names)`` with
    shuffle-on-train only, exactly as the reference. ``cache=True`` wraps
    both datasets in :class:`CachedDataset` (decode once, serve from RAM);
    a train transform with stochastic stages (augmentations) is left
    uncached — with a warning — so the augmentation stays live.
    ``worker_type="process"`` forks decode workers (see
    :class:`DataLoader`); it applies to whichever of the two datasets is
    NOT cached (a cached dataset keeps thread workers so the parent-side
    cache actually fills).
    """
    train_ds = ImageFolderDataset(train_dir, transform)
    test_ds = ImageFolderDataset(test_dir, eval_transform or transform)
    if train_ds.classes != test_ds.classes:
        raise ValueError(
            f"train/test class mismatch: {train_ds.classes} vs "
            f"{test_ds.classes}")
    if cache:
        for name, ds in (("train", train_ds), ("test", test_ds)):
            if getattr(ds.transform, "stochastic", False):
                warnings.warn(
                    f"cache=True: {name} dataset not cached — its transform "
                    "has stochastic stages that caching would freeze")
        if not getattr(train_ds.transform, "stochastic", False):
            train_ds = CachedDataset(train_ds)
        if not getattr(test_ds.transform, "stochastic", False):
            test_ds = CachedDataset(test_ds)
    train_loader = DataLoader(
        train_ds, batch_size, shuffle=True, drop_last=drop_last_train,
        seed=seed, num_workers=num_workers,
        worker_type=("thread" if isinstance(train_ds, CachedDataset)
                     else worker_type),
        process_index=process_index, process_count=process_count,
        shuffle_window=shuffle_window, shuffle_block=shuffle_block,
        readahead=readahead, evict_behind=evict_behind)
    test_loader = DataLoader(
        test_ds, batch_size, shuffle=False, seed=seed,
        num_workers=num_workers,
        worker_type=("thread" if isinstance(test_ds, CachedDataset)
                     else worker_type),
        process_index=process_index, process_count=process_count,
        pad_shards=True, shuffle_block=shuffle_block, readahead=readahead,
        evict_behind=evict_behind)
    return train_loader, test_loader, train_ds.classes
