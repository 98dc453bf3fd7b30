"""The port's input pipeline against the JAX package's, on the same files.

One synthetic image folder (48 px JPEGs, resized to 32) feeds both
packages' datasets and loaders. Orders, labels, shard slices, masks, the
mid-epoch skip and ``pad_batch`` must be equal; images must be bit-identical
for the eval and default transforms with native decode on and off at 1 and
4 thread workers, for the augmentation at one worker (which batch lands on
which thread's generator is scheduling-dependent with more), and for a
deterministic transform under forked process workers.
"""

import numpy as np
import pytest

from pytorch_vit_paper_replication_tpu.data import download as jdownload
from pytorch_vit_paper_replication_tpu.data import image_folder as jfolder
from pytorch_vit_paper_replication_tpu.data import sampler as jsampler
from pytorch_vit_paper_replication_tpu.data import transforms as jtf
from pytorch_vit_paper_replication_tpu_torch.data import download as tdownload
from pytorch_vit_paper_replication_tpu_torch.data import image_folder as tfolder
from pytorch_vit_paper_replication_tpu_torch.data import sampler as tsampler
from pytorch_vit_paper_replication_tpu_torch.data import transforms as ttf

SIZE = 32


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    return tdownload.make_synthetic_image_folder(
        root, train_per_class=7, test_per_class=3, image_size=48, seed=3)


def _epoch(loader):
    return [dict(b) for b in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_synthetic_generators_match_jax(tmp_path):
    t = tdownload.make_synthetic_image_folder(tmp_path / "t", seed=5,
                                              image_size=16)
    j = jdownload.make_synthetic_image_folder(tmp_path / "j", seed=5,
                                              image_size=16)
    files = sorted(p.relative_to(t[0].parent)
                   for p in t[0].parent.rglob("*.jpg"))
    assert len(files) == 3 * (8 + 4)
    for rel in files:
        assert (t[0].parent / rel).read_bytes() == \
            (j[0].parent / rel).read_bytes()
    tb = tdownload.synthetic_batch(4, 8, 5, seed=2)
    jb = jdownload.synthetic_batch(4, 8, 5, seed=2)
    _assert_batches_equal([tb], [jb])


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("epoch", [0, 1])
def test_classes_samples_and_epoch_order(folder, seed, epoch):
    train, _ = folder
    tds = tfolder.ImageFolderDataset(train, ttf.eval_transform(SIZE))
    jds = jfolder.ImageFolderDataset(train, jtf.eval_transform(SIZE))
    assert tds.classes == jds.classes and tds.samples == jds.samples
    for kw in ({}, {"shuffle_window": 5, "shuffle_block": 4}):
        tl = tfolder.DataLoader(tds, 4, shuffle=True, seed=seed, **kw)
        jl = jfolder.DataLoader(jds, 4, shuffle=True, seed=seed, **kw)
        ti, tv = tl._local_indices(epoch)
        ji, jv = jl._local_indices(epoch)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tl._last_block_order,
                                      jl._last_block_order)


def _arrays(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4, 4, 3)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


@pytest.mark.parametrize("pad_shards", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_process_shards_and_masks(seed, pad_shards):
    images, labels = _arrays()
    for count in (1, 2, 3):
        for index in range(count):
            kw = dict(shuffle=True, seed=seed, num_workers=1,
                      process_index=index, process_count=count,
                      pad_shards=pad_shards)
            tl = tfolder.DataLoader(tfolder.ArrayDataset(images, labels), 4,
                                    **kw)
            jl = jfolder.DataLoader(jfolder.ArrayDataset(images, labels), 4,
                                    **kw)
            assert len(tl) == len(jl)
            for _ in range(2):
                _assert_batches_equal(_epoch(tl), _epoch(jl))


@pytest.mark.parametrize("skip", [1, 3, 9])
def test_skip_next_batches(skip):
    images, labels = _arrays()
    tl = tfolder.DataLoader(tfolder.ArrayDataset(images, labels), 4,
                            shuffle=True, seed=7, drop_last=True,
                            num_workers=1)
    jl = jfolder.DataLoader(jfolder.ArrayDataset(images, labels), 4,
                            shuffle=True, seed=7, drop_last=True,
                            num_workers=1)
    for loader in (tl, jl):
        loader.epoch = 1
        loader.skip_next_batches = skip
    t1, j1 = _epoch(tl), _epoch(jl)
    _assert_batches_equal(t1, j1)
    assert len(t1) == max(0, len(tl) - skip)
    # One-shot: the next epoch is whole again.
    _assert_batches_equal(_epoch(tl), _epoch(jl))
    assert tl.epoch == jl.epoch == 3


@pytest.mark.parametrize("multiple", [1, 3, 8])
def test_pad_batch(multiple):
    images, labels = _arrays(n=5)
    for batch in ({"image": images, "label": labels},
                  {"image": images, "label": labels,
                   "mask": np.array([1, 1, 1, 0, 1], np.float32)}):
        _assert_batches_equal([tfolder.pad_batch(batch, multiple)],
                              [jfolder.pad_batch(batch, multiple)])


@pytest.mark.parametrize("n,window,block", [(0, 4, 2), (17, 0, 4),
                                            (17, 1, 4), (40, 6, 8),
                                            (40, 64, 8), (257, 33, 16)])
def test_windowed_shuffle_order(n, window, block):
    for seed in (0, 7):
        t = tsampler.windowed_shuffle_order(
            n, window, block, np.random.default_rng(seed))
        j = jsampler.windowed_shuffle_order(
            n, window, block, np.random.default_rng(seed))
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert sorted(t[0].tolist()) == list(range(n))


def _loaders(pkg, folder, transform, **kw):
    train, test = folder
    return pkg.create_dataloaders(train, test, transform, batch_size=4,
                                  seed=7, drop_last_train=True, **kw)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["eval", "default"])
def test_images_bit_identical(folder, kind, native, workers):
    make = {"eval": lambda tf: tf.eval_transform(SIZE),
            "default": lambda tf: tf.default_transform(SIZE)}[kind]
    train, test = folder
    loaders = []
    for pkg, tf in ((tfolder, ttf), (jfolder, jtf)):
        ds = pkg.ImageFolderDataset(train, make(tf), native_decode=native)
        assert (ds._plan is not None) == native
        loaders.append(pkg.DataLoader(ds, 4, shuffle=True, seed=7,
                                      drop_last=True, num_workers=workers))
    for _ in range(2):
        _assert_batches_equal(*(_epoch(x) for x in loaders))
    t_train, t_test, t_cls = _loaders(tfolder, folder, make(ttf),
                                      num_workers=workers)
    j_train, j_test, j_cls = _loaders(jfolder, folder, make(jtf),
                                      num_workers=workers)
    assert t_cls == j_cls
    _assert_batches_equal(_epoch(t_test), _epoch(j_test))


def test_augmented_batches_bit_identical_one_worker(folder):
    t_tf = ttf.augment_transform(SIZE, rng=ttf.ThreadLocalRng(7))
    j_tf = jtf.augment_transform(SIZE, rng=jtf.ThreadLocalRng(7))
    assert t_tf.stochastic and ttf.native_plan(t_tf) is None
    t_train, _, _ = _loaders(tfolder, folder, t_tf, num_workers=1,
                             eval_transform=ttf.eval_transform(SIZE))
    j_train, _, _ = _loaders(jfolder, folder, j_tf, num_workers=1,
                             eval_transform=jtf.eval_transform(SIZE))
    for _ in range(2):
        _assert_batches_equal(_epoch(t_train), _epoch(j_train))


def test_process_workers_deterministic_transform(folder):
    train, _ = folder
    tl = tfolder.DataLoader(
        tfolder.ImageFolderDataset(train, ttf.eval_transform(SIZE)), 4,
        shuffle=True, seed=7, num_workers=2, worker_type="process")
    jl = jfolder.DataLoader(
        jfolder.ImageFolderDataset(train, jtf.eval_transform(SIZE)), 4,
        shuffle=True, seed=7, num_workers=2)
    try:
        for _ in range(2):
            _assert_batches_equal(_epoch(tl), _epoch(jl))
    finally:
        tl.close()


def test_cache_refusals_and_cached_epochs(folder):
    train, _ = folder
    aug = tfolder.ImageFolderDataset(
        train, ttf.augment_transform(SIZE, rng=ttf.ThreadLocalRng(0)))
    with pytest.raises(ValueError, match="stochastic"):
        tfolder.CachedDataset(aug)
    cached = tfolder.CachedDataset(
        tfolder.ImageFolderDataset(train, ttf.eval_transform(SIZE)))
    with pytest.raises(ValueError, match="CachedDataset"):
        tfolder.DataLoader(cached, 4, worker_type="process")
    jl = jfolder.DataLoader(
        jfolder.ImageFolderDataset(train, jtf.eval_transform(SIZE)), 4,
        shuffle=True, seed=2)
    tl = tfolder.DataLoader(cached, 4, shuffle=True, seed=2)
    for _ in range(2):
        _assert_batches_equal(_epoch(tl), _epoch(jl))


def test_prefetch_on_cpu_passes_batches_through():
    images, labels = _arrays(n=8)
    batches = [{"image": images[i:i + 4], "label": labels[i:i + 4]}
               for i in (0, 4)]
    out = list(tfolder.prefetch_to_device(iter(batches), size=2,
                                          device="cpu"))
    assert len(out) == 2 and all(a is b for a, b in zip(out, batches))
