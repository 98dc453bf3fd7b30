"""The port's packed-shard pipeline (``data/imagenet.py``, ``data/pack.py``)
against the JAX package's.

A seeded folder of 48 px JPEGs (3 classes) is packed at 40 px into shards
of 5 records. Held bit for bit: the shard bytes and ``index.json``, the
``PackedShardDataset`` items, every array transform with the native
library and on the composed path (the native passes replaced by None in
both packages), and the packed loaders' batches over two epochs (order,
labels, images) with a global shuffle and with the windowed shuffle plus
readahead, one decode thread (the augmentation's draws are reproducible
per thread, so one thread makes them bitwise).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_vit_paper_replication_tpu import native as jnative
from pytorch_vit_paper_replication_tpu.data import imagenet as jimg
from pytorch_vit_paper_replication_tpu.data.transforms import (
    ThreadLocalRng as JRng)
from pytorch_vit_paper_replication_tpu_torch import native as tnative
from pytorch_vit_paper_replication_tpu_torch.data import imagenet as timg
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_synthetic_image_folder)
from pytorch_vit_paper_replication_tpu_torch.data.transforms import (
    ThreadLocalRng as TRng)

REPO = Path(__file__).resolve().parent.parent
PACK = dict(pack_size=40, images_per_shard=5, num_workers=2)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return make_synthetic_image_folder(
        tmp_path_factory.mktemp("torch_imagenet") / "ds", train_per_class=6,
        test_per_class=2, image_size=48)


@pytest.fixture(scope="module")
def packs(folder, tmp_path_factory):
    """(port pack, JAX pack) of the train split and the port's test pack,
    records in a seeded order."""
    root = tmp_path_factory.mktemp("torch_imagenet_packs")
    port = timg.pack_image_folder(folder[0], root / "port", shuffle_seed=0,
                                  **PACK)
    jax_ = jimg.pack_image_folder(folder[0], root / "jax", shuffle_seed=0,
                                  **PACK)
    test = timg.pack_image_folder(folder[1], root / "test", **PACK)
    return port, jax_, test


@pytest.fixture(params=["native", "composed"])
def path(request, monkeypatch):
    """Both packages' array transforms with the native passes, or with
    them replaced by None (the composed numpy/PIL path)."""
    if request.param == "native":
        assert tnative.available() and jnative.available()
    else:
        for mod in (tnative, jnative):
            for fn in ("resize_crop", "resize_crop_f32", "u8_to_f32"):
                monkeypatch.setattr(mod, fn, lambda *a, **k: None)
    return request.param


@pytest.mark.parametrize("shuffle_seed", [None, 0])
def test_pack_bytes_and_index_equal_jax(folder, tmp_path, shuffle_seed):
    t = timg.pack_image_folder(folder[0], tmp_path / "t",
                               shuffle_seed=shuffle_seed, **PACK)
    j = jimg.pack_image_folder(folder[0], tmp_path / "j",
                               shuffle_seed=shuffle_seed, **PACK)
    names = sorted(p.name for p in t.iterdir())
    assert names == sorted(p.name for p in j.iterdir())
    assert len([n for n in names if n.startswith("shard-")]) == 4
    for name in names:
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    index = json.loads((t / "index.json").read_text())
    assert index["version"] == 1 and index["num_images"] == 18


def test_packed_dataset_items_equal_jax(packs):
    port, jax_, _ = packs
    tds, jds = timg.PackedShardDataset(port), jimg.PackedShardDataset(jax_)
    assert len(tds) == len(jds) == 18 and tds.classes == jds.classes
    assert tds.pack_size == 40 and tds.readahead == jds.readahead
    for i in range(len(tds)):
        (ta, tl), (ja, jl) = tds[i], jds[i]
        assert tl == jl and ta.dtype == np.uint8
        np.testing.assert_array_equal(ta, ja)
    with pytest.raises(IndexError):
        tds[len(tds)]
    # The readahead hooks run over shard boundaries without error.
    tds.willneed_records(3, 12)
    tds.evict_records(0, 7)
    np.testing.assert_array_equal(tds[6][0], jds[6][0])


def _frames(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (40 + i, 36 + 2 * i, 3), dtype=np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("normalize", [False, True])
def test_array_transforms_bit_identical_to_jax(path, normalize):
    pairs = [
        (timg.RandomResizedCropArray(24, rng=TRng(5)),
         jimg.RandomResizedCropArray(24, rng=JRng(5))),
        (timg.RandomHorizontalFlipArray(rng=TRng(6)),
         jimg.RandomHorizontalFlipArray(rng=JRng(6))),
        (timg.ToFloatArray(normalize=normalize),
         jimg.ToFloatArray(normalize=normalize)),
        (timg.FusedAugmentArray(24, normalize=normalize, rng=TRng(7)),
         jimg.FusedAugmentArray(24, normalize=normalize, rng=JRng(7))),
        (timg.train_augment_transform(24, normalize=normalize, rng=TRng(8)),
         jimg.train_augment_transform(24, normalize=normalize, rng=JRng(8))),
        (timg.eval_center_transform(24, normalize=normalize),
         jimg.eval_center_transform(24, normalize=normalize)),
        (timg.eval_center_transform(48, normalize=normalize),
         jimg.eval_center_transform(48, normalize=normalize)),
    ]
    for t, j in pairs:
        for arr in _frames():
            got, want = t(arr), j(arr)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert timg.FusedAugmentArray(24).stochastic
    assert timg.train_augment_transform(24).stochastic


def test_fused_augment_equals_the_composed_transforms():
    """FusedAugmentArray draws crop box then flip and rounds to the uint8
    grid before the affine: the same pixels as crop, flip and ToFloat."""
    fused = timg.FusedAugmentArray(24, normalize=True, rng=TRng(9))
    crop = timg.RandomResizedCropArray(24, rng=TRng(9))
    flip = timg.RandomHorizontalFlipArray(rng=crop.rng)
    to_f = timg.ToFloatArray(normalize=True)
    for arr in _frames():
        np.testing.assert_array_equal(fused(arr), to_f(flip(crop(arr))))


def _epochs(loaders, n=2):
    out = []
    for loader in loaders:
        seen = []
        for epoch in range(n):
            loader.epoch = epoch
            seen.append([(b["image"], b["label"]) for b in loader])
        out.append(seen)
    return out


@pytest.mark.parametrize("window,readahead", [(0, 0), (8, 2)])
@pytest.mark.parametrize("augment", [True, False])
def test_packed_loaders_equal_jax(packs, path, window, readahead, augment):
    port, jax_, test = packs
    kw = dict(image_size=24, batch_size=4, augment=augment, seed=11,
              num_workers=1, shuffle_window=window, readahead=readahead,
              evict_behind=readahead > 0)
    t_train, t_test, t_cls = timg.create_packed_dataloaders(port, test, **kw)
    j_train, j_test, j_cls = jimg.create_packed_dataloaders(jax_, test, **kw)
    try:
        assert t_cls == j_cls and len(t_train) == len(j_train) == 4
        (t_ep, j_ep), (t_ev, j_ev) = (_epochs([t_train, j_train]),
                                      _epochs([t_test, j_test], 1))
        for got, want in ((t_ep, j_ep), (t_ev, j_ev)):
            for tb, jb in zip(sum(got, []), sum(want, [])):
                np.testing.assert_array_equal(tb[1], jb[1])
                np.testing.assert_array_equal(tb[0], jb[0])
            assert len(sum(got, [])) == len(sum(want, []))
        # Two epochs draw two different orders.
        assert not all(np.array_equal(a[1], b[1])
                       for a, b in zip(t_ep[0], t_ep[1]))
    finally:
        for dl in (t_train, t_test, j_train, j_test):
            dl.close()


def test_pack_cli_runs(folder, tmp_path):
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_vit_paper_replication_tpu_torch.data."
         "pack", str(folder[1]), str(out), "--pack-size", "40",
         "--shard-images", "4", "--num-workers", "1", "--shuffle-seed", "2"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("packed 6 images / 3 classes -> ")
    ref = jimg.pack_image_folder(folder[1], tmp_path / "ref", pack_size=40,
                                 images_per_shard=4, num_workers=1,
                                 shuffle_seed=2)
    for name in ("index.json", "shard-00000.bin", "shard-00001.bin"):
        assert (out / name).read_bytes() == (ref / name).read_bytes()
