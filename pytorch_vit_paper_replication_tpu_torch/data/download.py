"""Dataset acquisition helpers (a copy of the JAX package's
``data/download.py``).

The reference depends on an external, non-vendored ``helper_functions.py``
(cloned at runtime from mrdbourke/pytorch-deep-learning, main notebook cell 4)
for ``download_data``. This module is the vendored equivalent, plus a
synthetic-dataset generator so tests and benchmarks never need the network.
"""

from __future__ import annotations

import shutil
import urllib.request
import zipfile
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np


def download_data(source: str, destination: str | Path,
                  remove_source: bool = True) -> Path:
    """Download a zip (or copy a local zip path) and extract it.

    API-parity port of helper_functions ``download_data``. ``source`` may be
    an ``http(s)://`` URL or a local filesystem path (the offline path —
    useful wherever egress is blocked).
    """
    dest = Path(destination)
    if dest.is_dir() and any(dest.iterdir()):
        return dest
    dest.mkdir(parents=True, exist_ok=True)
    src = Path(source)
    if src.exists():
        zip_path = dest / src.name
        shutil.copy(src, zip_path)
    else:
        zip_path = dest / Path(source).name
        try:
            urllib.request.urlretrieve(source, zip_path)  # noqa: S310
        except Exception as e:
            raise RuntimeError(
                f"could not download {source!r} (offline environment?); "
                f"pass a local zip path instead") from e
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(dest)
    if remove_source:
        zip_path.unlink(missing_ok=True)
    return dest


def make_synthetic_image_folder(
    root: str | Path,
    classes: Sequence[str] = ("pizza", "steak", "sushi"),
    train_per_class: int = 8,
    test_per_class: int = 4,
    image_size: int = 64,
    seed: int = 0,
    noise_sigma: float = 40.0,
) -> Tuple[Path, Path]:
    """Write a tiny fake image-folder dataset (train/ + test/ dirs of JPEGs).

    Class k's images are noise centered on a distinct mean color, so a model
    can actually fit them — used by tests and the offline demo path in place
    of pizza_steak_sushi. ``noise_sigma`` sets the per-pixel noise around
    the 200-intensity class mean: the default 40 is near-trivially
    separable (tests); larger values (e.g. 150+) bury the mean under
    clipped noise so learning takes multiple epochs — used by the
    committed training-dynamics run (BASELINE.md).
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = Path(root)
    for split, per_class in (("train", train_per_class),
                             ("test", test_per_class)):
        for ci, cls in enumerate(classes):
            d = root / split / cls
            d.mkdir(parents=True, exist_ok=True)
            base = np.zeros(3)
            base[ci % 3] = 200.0
            for i in range(per_class):
                arr = np.clip(
                    base + rng.normal(0, noise_sigma, (image_size, image_size, 3)),
                    0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{cls}_{i}.jpg", quality=90)
    return root / "train", root / "test"


def synthetic_batch(batch_size: int, image_size: int, num_classes: int,
                    seed: int = 0, dtype=np.float32):
    """One deterministic classification batch (for benches / smoke tests)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(batch_size,), dtype=np.int32)
    means = labels[:, None, None, None].astype(dtype) / num_classes
    images = (means + 0.1 * rng.standard_normal(
        (batch_size, image_size, image_size, 3))).astype(dtype)
    return {"image": images, "label": labels}
