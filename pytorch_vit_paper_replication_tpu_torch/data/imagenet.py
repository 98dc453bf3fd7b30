"""ImageNet-scale input pipeline: packed uint8 shards + array-space
augmentation (port of the JAX package's ``data/imagenet.py``, numpy and
PIL only).

A per-epoch decode of 1.28M JPEGs cannot feed an accelerator from a small
host: JPEG decode costs far more CPU than every other stage together. So
decode is paid ONCE at ingest, fixed-size raw arrays go into large shard
files, and epochs are served from the OS page cache via ``np.memmap``:

* :func:`pack_image_folder` — one-time converter: decode + resize-shorter
  to ``pack_size`` + center-crop, write uint8 ``[N, S, S, 3]`` raw shards
  (``shard-NNNNN.bin``) plus a JSON index with labels and class names.
  The format (version 1) is the JAX package's, byte for byte: a pack made
  by either package loads in the other.
* :class:`PackedShardDataset` — random-access dataset over those shards;
  ``__getitem__`` is a memmap slice (no decode), then the transform runs
  in *array space*.
* :class:`RandomResizedCropArray` / :class:`RandomHorizontalFlipArray` /
  :class:`FusedAugmentArray` — torchvision-semantics augmentations on
  uint8 HWC arrays, with the JAX package's RNG order (crop box, then
  flip) and its uint8-grid rounding before the affine, so the same seed
  gives the same pixels in both packages. Because the stored image is
  already pack_size-bounded, the random crop scales relative to that
  frame (standard practice for pre-decoded pipelines, e.g. FFCV).

Everything here runs on the host, in loader threads or forked loader
processes, and never touches ``torch.cuda``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..utils.atomic import atomic_write_json
from .image_folder import ImageFolderDataset
from .transforms import (IMAGENET_MEAN, IMAGENET_STD, CenterCrop, Compose,
                         ResizeShorter, ThreadLocalRng,
                         default_rng as _default_rng,
                         sample_resized_crop_box)

INDEX_NAME = "index.json"
FORMAT_VERSION = 1


def _mem_available_bytes() -> int:
    """Linux MemAvailable in bytes (0 when unknown) — bounds the
    readahead hint in :class:`PackedShardDataset`."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


# --- array-space transforms ------------------------------------------------


class RandomResizedCropArray:
    """torchvision ``RandomResizedCrop`` semantics on a uint8 HWC array.

    Samples an area fraction in ``scale`` and an aspect ratio in ``ratio``
    (log-uniform), then crops+resizes to ``size`` in one native bilinear
    pass (:func:`..native.resize_crop`) when the C library is available,
    else via PIL. Falls back to center-crop-of-max-square after 10 failed
    box draws, exactly like torchvision.
    """

    stochastic = True

    def __init__(self, size: int, scale: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                 rng=None):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.rng = rng if rng is not None else _default_rng()

    def _sample_box(self, h: int, w: int) -> Tuple[int, int, int, int]:
        return sample_resized_crop_box(h, w, self.scale, self.ratio,
                                       self.rng)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        top, left, ch, cw = self._sample_box(h, w)
        return _crop_resize_u8(arr, top, left, ch, cw, self.size)


def _crop_resize_u8(arr: np.ndarray, top: int, left: int, ch: int, cw: int,
                    size: int) -> np.ndarray:
    """Crop ``[top:top+ch, left:left+cw]`` and bilinear-resize to
    ``[size, size, 3]`` uint8 — identity shortcut for exact-size crops,
    one native pass when available (~1.8x the PIL round-trip), PIL
    fallback. Shared by :class:`RandomResizedCropArray` and
    :class:`FusedAugmentArray`'s non-native fallback so the resampling
    semantics cannot drift apart."""
    if (ch, cw) == (size, size):
        return np.ascontiguousarray(arr[top:top + size, left:left + size])
    from .. import native
    out = native.resize_crop(arr, top, left, ch, cw, size)
    if out is not None:
        return out
    img = Image.fromarray(arr[top:top + ch, left:left + cw])
    return np.asarray(img.resize((size, size), Image.BILINEAR))


class RandomHorizontalFlipArray:
    """p-probability left-right flip of an HWC array."""

    stochastic = True

    def __init__(self, p: float = 0.5,
                 rng=None):
        self.p = p
        self.rng = rng if rng is not None else _default_rng()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        if self.rng.random() < self.p:
            return arr[:, ::-1]
        return arr


class ToFloatArray:
    """uint8 [0,255] HWC -> float32 [0,1], optionally ImageNet-normalized.

    Computed as one fused ``arr * scale + offset`` pass (uint8 in, float32
    out): ``(x/255 - mean)/std == x * 1/(255*std) + (-mean/std)``. Half
    the memory traffic of astype-then-normalize on the loader's hot path.
    """

    def __init__(self, normalize: bool = False,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        self.normalize = normalize
        mean = np.asarray(mean, np.float32)
        std = np.asarray(std, np.float32)
        if normalize:
            self._scale = (1.0 / (255.0 * std)).astype(np.float32)
            self._offset = (-mean / std).astype(np.float32)
        else:
            self._scale = np.float32(1.0 / 255.0)
            self._offset = np.float32(0.0)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        if arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
            from .. import native
            out = native.u8_to_f32(arr, self._scale,
                                   self._offset if self.normalize else 0.0)
            if out is not None:
                return out
        # Numpy fallback: contiguous f32 cast first, then in-place affine —
        # ~1.6x the mixed-dtype broadcast multiply this replaced.
        out = arr.astype(np.float32)
        out *= self._scale
        if self.normalize:
            out += self._offset
        return out


# ``transforms.Compose`` works unchanged on array inputs (its trailing
# PIL->array conversion is a no-op for ndarrays) and already carries the
# ``stochastic`` property; alias it rather than duplicating the logic.
ComposeArray = Compose


class FusedAugmentArray:
    """RandomResizedCrop + horizontal flip + float/normalize as ONE native
    pass (``native.resize_crop_f32``).

    Draw-for-draw identical to ``Compose([RandomResizedCropArray,
    RandomHorizontalFlipArray, ToFloatArray])`` — same RNG consumption
    order (crop box, then flip), same uint8-grid rounding before the
    affine — but the uint8 crop intermediate is never materialized, read
    back, or converted in a second pass. Falls back to the composed path
    when the native library is absent.
    """

    stochastic = True

    def __init__(self, size: int, scale: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                 normalize: bool = True, flip_p: float = 0.5, rng=None):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.flip_p = flip_p
        self.rng = rng if rng is not None else _default_rng()
        self._to_float = ToFloatArray(normalize=normalize)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        top, left, ch, cw = sample_resized_crop_box(
            h, w, self.scale, self.ratio, self.rng)
        flip = self.rng.random() < self.flip_p
        from .. import native
        tf = self._to_float
        out = native.resize_crop_f32(
            arr, top, left, ch, cw, self.size, hflip=flip,
            scale=tf._scale, offset=tf._offset if tf.normalize else 0.0)
        if out is not None:
            return out
        # Composed fallback (same pixels, more passes).
        crop = _crop_resize_u8(arr, top, left, ch, cw, self.size)
        if flip:
            crop = crop[:, ::-1]
        return tf(crop)


def train_augment_transform(image_size: int, *, normalize: bool = True,
                            rng=None,
                            ) -> ComposeArray:
    """The standard ImageNet training recipe: RandomResizedCrop + flip +
    normalize (ViT paper appendix B.1 trains with this pipeline), fused
    into one native pass per image (:class:`FusedAugmentArray`)."""
    return ComposeArray([
        FusedAugmentArray(image_size, normalize=normalize, rng=rng),
    ])


def eval_center_transform(image_size: int, *,
                          normalize: bool = True) -> ComposeArray:
    """Eval path for packed data: center-crop to size + normalize (the
    shards are already resize-shorter'd at pack time)."""

    def center(arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        s = min(image_size, h, w)
        top, left = (h - s) // 2, (w - s) // 2
        crop = arr[top:top + s, left:left + s]
        if s != image_size:
            crop = np.asarray(Image.fromarray(crop).resize(
                (image_size, image_size), Image.BILINEAR))
        return crop

    return ComposeArray([center, ToFloatArray(normalize=normalize)])


# --- packed shard format ---------------------------------------------------


def pack_image_folder(src_dir: str | Path, out_dir: str | Path, *,
                      pack_size: int = 256,
                      images_per_shard: int = 4096,
                      num_workers: Optional[int] = None,
                      shuffle_seed: Optional[int] = None) -> Path:
    """Decode an image folder once into packed uint8 shards.

    Each image is resize-shorter to ``pack_size`` then center-cropped square
    (so every record is ``[pack_size, pack_size, 3]`` and the shard is one
    contiguous memmap-able block). Labels/classes/geometry go to
    ``index.json``. Returns ``out_dir``.

    ``shuffle_seed`` writes records in a seeded random order instead of
    the class-major folder order. Do this for packs destined for the
    windowed-shuffle loader: a class-major pack puts ~one class per
    block run, so a bounded window sees only a sliver of the label
    space at a time — pre-shuffling at pack time makes windowed batches
    class-uniform at ANY window size (labels in ``index.json`` follow
    the records, so the pack stays self-consistent). Irrelevant for the
    global-permutation path.
    """
    src = ImageFolderDataset(src_dir, transform=_PackTransform(pack_size))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    import concurrent.futures as cf
    workers = (num_workers if num_workers is not None
               else min(32, os.cpu_count() or 1))
    record_bytes = pack_size * pack_size * 3
    labels: List[int] = []
    shards: List[dict] = []
    n = len(src)
    order = (np.random.default_rng(
        np.random.SeedSequence([shuffle_seed])).permutation(n)
        if shuffle_seed is not None else np.arange(n))

    def write_shard(idxs: np.ndarray) -> None:
        # Workers decode straight into one preallocated shard buffer (a
        # second list-of-arrays copy would double peak memory — ~800 MB at
        # the ImageNet defaults).
        buf = np.empty((len(idxs), pack_size, pack_size, 3), np.uint8)

        def fill(j: int) -> int:
            arr, label = src[int(idxs[j])]
            buf[j] = arr
            return int(label)

        if workers <= 1:
            shard_labels = [fill(j) for j in range(len(idxs))]
        else:
            with cf.ThreadPoolExecutor(workers) as pool:
                shard_labels = list(pool.map(fill, range(len(idxs))))
        name = f"shard-{len(shards):05d}.bin"
        buf.tofile(out / name)
        labels.extend(shard_labels)
        shards.append({"file": name, "count": len(idxs)})

    for start in range(0, n, images_per_shard):
        write_shard(order[start:start + images_per_shard])
    # Atomic (temp+os.replace): the index is the manifest every
    # PackedShardDataset open validates — a pack job killed mid-index
    # must not leave a torn file next to good shards.
    atomic_write_json(out / INDEX_NAME, {
        "version": FORMAT_VERSION,
        "pack_size": pack_size,
        "record_bytes": record_bytes,
        "num_images": n,
        "classes": src.classes,
        "labels": labels,
        "shards": shards,
    })
    return out


class _PackTransform:
    """Deterministic ingest transform: resize-shorter + center-crop, uint8.

    Carries a ``native_plan`` so pack-time decode rides the C fast path
    (``..native``) when available.
    """

    def __init__(self, pack_size: int):
        self._resize = ResizeShorter(pack_size)
        self._crop = CenterCrop(pack_size)
        from .transforms import NativePlan
        self.native_plan = NativePlan("shorter_crop", pack_size, pack_size,
                                      to_float=False, normalize=None)

    def __call__(self, img: Image.Image) -> np.ndarray:
        out = np.asarray(self._crop(self._resize(img.convert("RGB"))),
                         dtype=np.uint8)
        return out


class PackedShardDataset:
    """Random-access dataset over :func:`pack_image_folder` output.

    ``__getitem__`` copies one record out of a shard memmap (OS page cache
    makes repeat epochs RAM-speed without holding the dataset in Python
    memory) and applies the array-space ``transform``. Compatible with
    :class:`.image_folder.DataLoader` (len / indexing / ``.classes``).
    """

    def __init__(self, root: str | Path,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None, *, startup_readahead: bool = True):
        self.root = Path(root)
        index_path = self.root / INDEX_NAME
        if not index_path.is_file():
            raise FileNotFoundError(
                f"{index_path} not found — is {self.root} a "
                "pack_image_folder output?")
        meta = json.loads(index_path.read_text())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"packed-shard format version {meta.get('version')} "
                f"(expected {FORMAT_VERSION})")
        self.pack_size: int = meta["pack_size"]
        self.record_bytes: int = self.pack_size * self.pack_size * 3
        self.classes: List[str] = list(meta["classes"])
        self.labels = np.asarray(meta["labels"], np.int64)
        self._maps: List[np.memmap] = []
        self._paths: List[Path] = []
        self._counts: List[int] = []
        self._fds: List[Optional[int]] = []
        starts: List[int] = []
        start = 0
        shape = (self.pack_size, self.pack_size, 3)
        for sh in meta["shards"]:
            path = self.root / sh["file"]
            m = np.memmap(path, dtype=np.uint8, mode="r",
                          shape=(sh["count"],) + shape)
            self._maps.append(m)
            self._paths.append(path)
            self._counts.append(sh["count"])
            self._fds.append(None)
            starts.append(start)
            start += sh["count"]
        self._starts = np.asarray(starts, np.int64)
        if start != meta["num_images"] or start != len(self.labels):
            raise ValueError(
                f"index inconsistent: shards hold {start} records, index "
                f"says {meta['num_images']} with {len(self.labels)} labels")
        self.transform = transform
        # Disk-cold first epochs under a GLOBAL-permutation shuffle read
        # records in random order — ~150 KB reads that a slow/virtualized
        # disk serves far below the device's rate. madvise(WILLNEED)
        # asks the kernel to readahead the shards sequentially+
        # asynchronously while the loader works, converting the
        # random-read penalty into one sequential scan. Only hinted when
        # the whole pack fits in half of MemAvailable — for ImageNet-
        # scale packs the hint would just churn the page cache; THAT
        # regime is the windowed-shuffle + streaming-readahead loader's
        # job (DataLoader(shuffle_window=..., readahead=...), which
        # drives the per-block willneed_records/evict_records hooks
        # below and needs no up-front whole-pack hint —
        # ``startup_readahead=False`` skips it).
        self.readahead = False
        total_bytes = start * self.record_bytes
        avail = _mem_available_bytes()
        if startup_readahead and avail and total_bytes <= avail // 2:
            import mmap as _mmaplib
            try:
                for m in self._maps:
                    m._mmap.madvise(_mmaplib.MADV_WILLNEED)
                self.readahead = True
            except (AttributeError, OSError):
                pass  # non-Linux / old numpy: hint is best-effort only

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        if not 0 <= idx < len(self.labels):
            raise IndexError(idx)
        # O(log n_shards) shard lookup — ImageNet-1k has ~313 shards at the
        # default shard size and this runs once per image per epoch.
        si = int(np.searchsorted(self._starts, idx, side="right")) - 1
        arr = np.array(self._maps[si][idx - self._starts[si]])  # copy out
        if self.transform is not None:
            arr = self.transform(arr)
        return arr, int(self.labels[idx])

    # --- streaming-readahead hooks (sampler.BlockReadahead) ------------
    # Record ranges map to per-shard byte ranges; WILLNEED goes through
    # posix_fadvise on a kept-open fd (kicks off kernel readahead into
    # the page cache without touching the mapping), DONTNEED drops the
    # mapping's PTEs first (madvise) so the fadvise can actually evict
    # the file pages. All hints are best-effort: an unsupported kernel/
    # filesystem degrades to plain demand paging, never to an error.

    _PAGE = 4096

    def _shard_ranges(self, lo: int, hi: int):
        """yield (shard_idx, byte_lo, byte_hi) covering records [lo, hi),
        page-aligned outward."""
        lo = max(0, int(lo))
        hi = min(len(self.labels), int(hi))
        while lo < hi:
            si = int(np.searchsorted(self._starts, lo, side="right")) - 1
            shard_lo = int(self._starts[si])
            shard_hi = shard_lo + self._counts[si]
            span = min(hi, shard_hi)
            b_lo = (lo - shard_lo) * self.record_bytes
            b_hi = (span - shard_lo) * self.record_bytes
            b_lo -= b_lo % self._PAGE
            b_hi += (-b_hi) % self._PAGE
            yield si, b_lo, min(b_hi, self._counts[si] * self.record_bytes)
            lo = span

    def _fd(self, si: int) -> int:
        if self._fds[si] is None:
            self._fds[si] = os.open(self._paths[si], os.O_RDONLY)
        return self._fds[si]

    def willneed_records(self, lo: int, hi: int) -> None:
        """Hint records [lo, hi) into the page cache (async readahead)."""
        for si, b_lo, b_hi in self._shard_ranges(lo, hi):
            try:
                os.posix_fadvise(self._fd(si), b_lo, b_hi - b_lo,
                                 os.POSIX_FADV_WILLNEED)
            except (AttributeError, OSError):
                pass  # no posix_fadvise on this platform: demand paging

    def evict_records(self, lo: int, hi: int) -> None:
        """Drop records [lo, hi) from this mapping and the page cache
        (as far as the kernel allows) — bounds the resident set when the
        pack is much larger than RAM. Caveat: this acts on the CALLING
        process's mapping; pages a forked decode worker has mapped
        survive until normal kernel reclaim (clean pages, so that is a
        weakening of the proactive bound, not a leak)."""
        import mmap as _mmaplib
        for si, b_lo, b_hi in self._shard_ranges(lo, hi):
            try:
                self._maps[si]._mmap.madvise(_mmaplib.MADV_DONTNEED,
                                             b_lo, b_hi - b_lo)
                os.posix_fadvise(self._fd(si), b_lo, b_hi - b_lo,
                                 os.POSIX_FADV_DONTNEED)
            except (AttributeError, OSError, ValueError):
                pass

    def __del__(self):
        for fd in getattr(self, "_fds", []):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass


def create_packed_dataloaders(
    train_root: str | Path,
    test_root: str | Path,
    image_size: int = 224,
    batch_size: int = 32,
    *,
    normalize: bool = True,
    augment: bool = True,
    seed: int = 0,
    num_workers: Optional[int] = None,
    process_index: int = 0,
    process_count: int = 1,
    worker_type: str = "thread",
    shuffle_window: int = 0,
    shuffle_block: Optional[int] = None,
    readahead: int = 0,
    evict_behind: bool = False,
):
    """(train_loader, test_loader, classes) over packed shard directories —
    the ImageNet-config analogue of ``create_dataloaders``.

    ``worker_type="process"`` forks decode workers (multi-core hosts; see
    ``image_folder.DataLoader``) — forked children inherit the read-only
    shard memmaps (pages shared, no copy) and ``ThreadLocalRng`` reseeds
    per process, so the augmented path is process-safe.

    ``shuffle_window > 0`` switches the train loader to the streaming
    windowed shuffle (sequential shard I/O, O(window) record working
    set — the pack >> RAM regime; see ``data.sampler``); ``readahead``
    keeps that many upcoming blocks hinted into the page cache for both
    loaders, and ``evict_behind`` additionally drops fully-consumed
    blocks so the resident set stays bounded (both knobs apply to the
    train AND eval loaders — inference sweeps deserve the same
    page-cache discipline training got). ``shuffle_block`` defaults to
    one pack shard so block reads are whole-file-sequential."""
    from .image_folder import DEFAULT_SHUFFLE_BLOCK, DataLoader, NUM_WORKERS

    rng = ThreadLocalRng(seed)
    train_tf = (train_augment_transform(image_size, normalize=normalize,
                                        rng=rng)
                if augment else eval_center_transform(
                    image_size, normalize=normalize))
    train_ds = PackedShardDataset(train_root, train_tf)
    test_ds = PackedShardDataset(
        test_root, eval_center_transform(image_size, normalize=normalize))
    if train_ds.classes != test_ds.classes:
        raise ValueError(
            f"train/test class mismatch: {train_ds.classes} vs "
            f"{test_ds.classes}")
    workers = num_workers if num_workers is not None else NUM_WORKERS
    if shuffle_block is None:
        # One block = one shard file unless shards are unusually large.
        counts = train_ds._counts
        shuffle_block = min(max(counts), DEFAULT_SHUFFLE_BLOCK) if counts \
            else DEFAULT_SHUFFLE_BLOCK
    train_loader = DataLoader(
        train_ds, batch_size, shuffle=True, drop_last=True, seed=seed,
        num_workers=workers, worker_type=worker_type,
        process_index=process_index, process_count=process_count,
        shuffle_window=shuffle_window, shuffle_block=shuffle_block,
        readahead=readahead, evict_behind=evict_behind)
    test_loader = DataLoader(
        test_ds, batch_size, shuffle=False, seed=seed, num_workers=workers,
        worker_type=worker_type,
        process_index=process_index, process_count=process_count,
        pad_shards=True, shuffle_block=shuffle_block, readahead=readahead,
        evict_behind=evict_behind)
    return train_loader, test_loader, train_ds.classes
