"""CIFAR-10 dataset support (port of the JAX package's ``data/cifar.py``).

Loads the standard python-pickle CIFAR-10 archive from a **local** path
(nothing is downloaded) into :class:`.image_folder.ArrayDataset` pairs,
with the 32 -> target resize done lazily per item on the host (the
"ViT-B/16 on CIFAR-10, 32 -> 224" configuration). :func:`make_fake_cifar10`
writes a seeded archive in the same format for tests and offline runs.
The batch files are pickles: load only archives from a trusted source.
"""

from __future__ import annotations

import pickle
import tarfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .image_folder import ArrayDataset

CIFAR10_CLASSES = ("airplane", "automobile", "bird", "cat", "deer", "dog",
                   "frog", "horse", "ship", "truck")


def _load_batch_file(fh) -> Tuple[np.ndarray, np.ndarray]:
    d = pickle.load(fh, encoding="bytes")
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[b"labels"], np.int32)
    return images, labels


def load_cifar10(root: str | Path,
                 ) -> Tuple[ArrayDataset, ArrayDataset]:
    """Load CIFAR-10 from `root`, which may be the extracted
    ``cifar-10-batches-py`` directory or the ``cifar-10-python.tar.gz``
    archive. Returns (train_ds, test_ds) with uint8 NHWC images.
    """
    root = Path(root)
    train_x, train_y, test_x, test_y = [], [], None, None
    if root.is_file():
        with tarfile.open(root) as tf:
            for member in tf.getmembers():
                name = Path(member.name).name
                if name.startswith("data_batch_"):
                    x, y = _load_batch_file(tf.extractfile(member))
                    train_x.append(x), train_y.append(y)
                elif name == "test_batch":
                    test_x, test_y = _load_batch_file(tf.extractfile(member))
    elif root.is_dir():
        for i in range(1, 6):
            with open(root / f"data_batch_{i}", "rb") as fh:
                x, y = _load_batch_file(fh)
                train_x.append(x), train_y.append(y)
        with open(root / "test_batch", "rb") as fh:
            test_x, test_y = _load_batch_file(fh)
    else:
        raise FileNotFoundError(f"CIFAR-10 not found at {root}")
    if not train_x or test_x is None:
        raise ValueError(f"no CIFAR batches found under {root}")
    return (
        ArrayDataset(np.concatenate(train_x), np.concatenate(train_y),
                     CIFAR10_CLASSES),
        ArrayDataset(test_x, test_y, CIFAR10_CLASSES),
    )


class ResizedArrayDataset:
    """Wrap an ArrayDataset of uint8 images with per-item resize + scale —
    the 32→224 path of the CIFAR benchmark config. ``normalize`` applies
    the ImageNet statistics (for pretrained backbones)."""

    def __init__(self, base: ArrayDataset, image_size: int,
                 normalize: bool = False):
        from PIL import Image

        from .transforms import Normalize

        self._base = base
        self._size = image_size
        self._Image = Image
        self._normalize = Normalize() if normalize else None
        self.classes = base.classes

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx):
        img, label = self._base[idx]
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        pil = self._Image.fromarray(img).resize(
            (self._size, self._size), self._Image.BILINEAR)
        arr = np.asarray(pil, np.float32) / 255.0
        if self._normalize is not None:
            arr = self._normalize(arr)
        return arr, label


def make_fake_cifar10(root: str | Path, per_batch: int = 20,
                      seed: int = 0) -> Path:
    """Write a tiny archive in the real CIFAR-10 pickle format (for tests
    and offline demos)."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True, exist_ok=True)

    def write(name, n):
        data = rng.integers(0, 256, size=(n, 3 * 32 * 32),
                            dtype=np.uint8)
        labels = rng.integers(0, 10, size=n).tolist()
        with open(d / name, "wb") as fh:
            pickle.dump({b"data": data, b"labels": labels}, fh)

    for i in range(1, 6):
        write(f"data_batch_{i}", per_batch)
    write("test_batch", per_batch)
    return d
