"""Host-side image transforms (numpy/PIL) for the input pipeline.

A copy of the JAX package's ``data/transforms.py``, so both packages feed
their models identical pixels. The reference composes
``torchvision.transforms`` (Resize + ToTensor in the notebooks, plus
ImageNet-normalize for prediction, ``predictions.py:46-54``). These are the
equivalents, producing **NHWC float32 in [0,1]** numpy arrays (the layout
the port's models take). They run in data-loader worker threads or forked
worker processes, never on the device.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

# ImageNet statistics, as hardcoded in reference predictions.py:49-53.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Transform = Callable[[Image.Image], np.ndarray]

# Deterministic identity of a forked decode worker, set by the process
# pool's initializer (image_folder._init_fork_worker): a tuple like
# (loader_seed, pool_generation, worker_ordinal). When present,
# ThreadLocalRng seeds forked-worker streams from it instead of OS
# entropy, so --seed reproduces augmentation draws under
# worker_type='process'. None in the parent and in
# directly-forked children (which keep the entropy fallback).
_FORK_WORKER_TOKEN: Optional[Tuple[int, ...]] = None


def _set_fork_worker_token(token: Tuple[int, ...]) -> None:
    global _FORK_WORKER_TOKEN
    _FORK_WORKER_TOKEN = tuple(int(t) for t in token)


def to_array(img: Image.Image) -> np.ndarray:
    """PIL → float32 HWC in [0,1] (torchvision ``ToTensor`` minus the CHW
    transpose — the models take NHWC)."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr


class Resize:
    """Resize to (size, size) with bilinear interpolation."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        return img.resize((self.size, self.size), Image.BILINEAR)


class ResizeShorter:
    """Resize the SHORTER side to `size`, keeping aspect ratio — the
    torchvision ``Resize(int)`` semantics used by pretrained-weight
    transforms (reference main notebook cell 117)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        if w <= h:
            new_w, new_h = self.size, max(1, round(h * self.size / w))
        else:
            new_w, new_h = max(1, round(w * self.size / h)), self.size
        return img.resize((new_w, new_h), Image.BILINEAR)


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        s = self.size
        left, top = (w - s) // 2, (h - s) // 2
        return img.crop((left, top, left + s, top + s))


class ThreadLocalRng:
    """A ``np.random.Generator`` facade safe to share across loader threads.

    ``np.random.Generator`` is not thread-safe; the DataLoader decodes
    batches in a thread pool, so augmentations sharing one generator would
    race. Each thread gets its own generator seeded from
    ``SeedSequence([seed, thread_ordinal])``. Draw sequences are
    reproducible per thread; which batch lands on which thread is
    scheduling-dependent, so augmentation draws are statistically — not
    bitwise — reproducible across runs (same as torch DataLoader workers).

    Fork-safety for ``worker_type="process"`` loaders: a forked worker
    inherits both the parent thread's generator and a copy of the
    ordinal counter, so without intervention every worker would
    continue/replay one identical draw sequence (correlated
    augmentations across workers). A generator used in a process other
    than the one that built the facade therefore reseeds on first use.
    Pool workers carry a deterministic identity (``_FORK_WORKER_TOKEN``,
    set by the pool initializer: loader seed, pool generation, worker
    ordinal) and reseed from ``[seed, ordinal, *token]`` — so ``--seed``
    reproduces process-worker draws run-to-run exactly like thread
    workers (which batch lands on which worker is still
    scheduling-dependent, the same contract as threads; with one worker
    the batches are bitwise reproducible). Children forked OUTSIDE a
    pool have no token and keep the fresh-OS-entropy fallback — pids
    recycle, so pid alone is not a safe distinguisher. The in-process
    thread paths keep their exact ``[seed, ordinal]`` seeding.
    """

    def __init__(self, seed: int):
        self._seed = seed
        self._origin_pid = os.getpid()
        self._local = threading.local()
        self._counter = itertools.count()

    def _gen(self) -> np.random.Generator:
        pid = os.getpid()
        gen = getattr(self._local, "gen", None)
        if gen is None or getattr(self._local, "pid", None) != pid:
            ordinal = next(self._counter)
            if pid == self._origin_pid:
                seq = np.random.SeedSequence([self._seed, ordinal])
            elif _FORK_WORKER_TOKEN is not None:
                # Pool worker: deterministic [seed, ordinal, loader seed,
                # pool generation, worker ordinal] (see docstring).
                seq = np.random.SeedSequence(
                    [self._seed, ordinal, *_FORK_WORKER_TOKEN])
            else:  # non-pool forked child (see docstring)
                seq = np.random.SeedSequence(
                    [self._seed, ordinal,
                     int.from_bytes(os.urandom(8), "little")])
            gen = np.random.default_rng(seq)
            self._local.gen = gen
            self._local.pid = pid
        return gen

    def uniform(self, *a, **kw):
        return self._gen().uniform(*a, **kw)

    def integers(self, *a, **kw):
        return self._gen().integers(*a, **kw)

    def random(self, *a, **kw):
        return self._gen().random(*a, **kw)


def default_rng() -> ThreadLocalRng:
    """Entropy-seeded thread-safe rng — the safe default for augmentations
    (a bare ``np.random.default_rng()`` shared across DataLoader decode
    threads races on its generator state)."""
    return ThreadLocalRng(int(np.random.SeedSequence().generate_state(1)[0]))


def sample_resized_crop_box(h: int, w: int, scale: Tuple[float, float],
                            ratio: Tuple[float, float],
                            rng) -> Tuple[int, int, int, int]:
    """torchvision ``RandomResizedCrop`` box sampling: ``(top, left,
    crop_h, crop_w)`` with area fraction in ``scale`` and log-uniform
    aspect in ``ratio``; falls back to the largest centered in-ratio crop
    after 10 failed draws, exactly like torchvision."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


class RandomResizedCrop:
    """torchvision ``RandomResizedCrop`` on PIL images — the ImageNet
    training augmentation for the (non-packed) image-folder path. PIL's
    ``resize(box=...)`` does the crop+resize in one resample."""

    stochastic = True

    def __init__(self, size: int, scale: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3), rng=None):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.rng = rng if rng is not None else default_rng()

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        top, left, ch, cw = sample_resized_crop_box(
            h, w, self.scale, self.ratio, self.rng)
        return img.resize((self.size, self.size), Image.BILINEAR,
                          box=(left, top, left + cw, top + ch))


class RandomHorizontalFlip:
    """Training augmentation (not in the reference recipe; off by default in
    the presets — provided for the ImageNet configs)."""

    stochastic = True

    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng if rng is not None else default_rng()

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.rng.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class Normalize:
    """Channel-wise (x - mean) / std on the float32 array."""

    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


class Compose:
    """Apply transforms in order; PIL stages first, then array stages."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    @property
    def stochastic(self) -> bool:
        """True when any stage draws randomness per call (augmentations).

        Consumers that memoize post-transform outputs (``CachedDataset``)
        check this to avoid silently freezing augmentations.
        """
        return any(getattr(t, "stochastic", False) for t in self.transforms)

    def __call__(self, img: Image.Image) -> np.ndarray:
        x = img
        for t in self.transforms:
            x = t(x)
        if isinstance(x, Image.Image):
            x = to_array(x)
        return x


class NativePlan(NamedTuple):
    """Declarative description of a transform the native JPEG decoder
    (:mod:`..native`) can reproduce: decode+resize(+crop) in C, then the
    cheap numpy tail (scale to [0,1], normalize) on the host."""

    mode: str                       # "squash" | "shorter_crop"
    resize: int                     # shorter-side target (shorter_crop)
    crop: int                       # output square size
    to_float: bool                  # divide by 255 after decode
    normalize: Optional[Normalize]  # applied after to_float


def native_plan(transform) -> Optional[NativePlan]:
    """Match ``transform`` against the natively-supported pipelines.

    Returns a :class:`NativePlan` when the transform is exactly one of
    ``Resize+to_array(+Normalize)`` or ``ResizeShorter+CenterCrop+to_array
    (+Normalize)`` — i.e. every deterministic pipeline this module builds —
    else None (callers keep the PIL path). A transform may also carry its
    own ``native_plan`` attribute (e.g. the pack-time ingest transform).
    """
    own = getattr(transform, "native_plan", None)
    if isinstance(own, NativePlan):
        return own
    if not isinstance(transform, Compose):
        return None
    stages = list(transform.transforms)
    norm = None
    if stages and isinstance(stages[-1], Normalize):
        norm = stages.pop()
    if len(stages) == 2 and isinstance(stages[0], Resize) \
            and stages[1] is to_array:
        s = stages[0].size
        return NativePlan("squash", s, s, True, norm)
    if (len(stages) == 3 and isinstance(stages[0], ResizeShorter)
            and isinstance(stages[1], CenterCrop) and stages[2] is to_array
            and stages[1].size <= stages[0].size):
        return NativePlan("shorter_crop", stages[0].size, stages[1].size,
                          True, norm)
    return None


def default_transform(image_size: int = 224) -> Compose:
    """Resize + scale-to-[0,1] — the notebooks' training transform
    (main notebook cells 10-11)."""
    return Compose([Resize(image_size), to_array])


def eval_transform(image_size: int = 224, normalize: bool = True) -> Compose:
    """Resize + [0,1] + ImageNet-normalize — the reference's prediction
    default (predictions.py:46-54)."""
    stages = [Resize(image_size), to_array]
    if normalize:
        stages.append(Normalize())
    return Compose(stages)


def pretrained_transform(image_size: int = 224,
                         resize_size: Optional[int] = None,
                         normalize: bool = True) -> Compose:
    """The pretrained-weights eval transform: resize shorter side, center
    crop, ImageNet normalize — what ``ViT_B_16_Weights.DEFAULT.transforms()``
    applies in the reference's transfer workflow (main notebook cells 110,
    117; SWAG@384 uses resize=crop=384, exercises cell 49)."""
    if resize_size is None:
        # torchvision's 256/224 ratio, e.g. 224->256; 384 stays 384 (SWAG).
        resize_size = image_size if image_size >= 384 else round(
            image_size * 256 / 224)
    stages = [ResizeShorter(resize_size), CenterCrop(image_size), to_array]
    if normalize:
        stages.append(Normalize())
    return Compose(stages)


def augment_transform(image_size: int, *, normalize: bool = False,
                      rng=None) -> Compose:
    """The ImageNet training augmentation for image-folder datasets:
    RandomResizedCrop + horizontal flip (+ optional normalize). The packed
    pipeline's array-space twin is ``imagenet.train_augment_transform``."""
    if rng is None:
        rng = default_rng()
    stages = [RandomResizedCrop(image_size, rng=rng),
              RandomHorizontalFlip(rng=rng), to_array]
    if normalize:
        stages.append(Normalize())
    return Compose(stages)


def make_transform(image_size: int, *, pretrained: bool = False,
                   normalize: Optional[bool] = None,
                   resize_size: Optional[int] = None) -> Compose:
    """THE input-transform decision, shared by train and predict.

    ``normalize=None`` resolves to ``pretrained`` — fine-tuning pretrained
    weights must feed them the ImageNet-normalized distribution they were
    trained on, while scratch runs keep the
    reference notebooks' plain [0,1] inputs. Pretrained additionally uses
    resize-shorter + center-crop instead of squashing to square;
    ``resize_size`` overrides its shorter-side target (packed-shard runs
    record their pack size here so predict crops the identical region).
    """
    if normalize is None:
        normalize = pretrained
    if pretrained:
        return pretrained_transform(image_size, resize_size=resize_size,
                                    normalize=normalize)
    return eval_transform(image_size, normalize=normalize)
