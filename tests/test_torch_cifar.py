"""The port's CIFAR-10 support (``data/cifar.py``) against the JAX package's:
the fake archive's bytes, the loaded arrays (from the batch directory and
from a tarball) and the resized items, bit for bit."""

import tarfile

import numpy as np
import pytest

from pytorch_vit_paper_replication_tpu.data import cifar as jcifar
from pytorch_vit_paper_replication_tpu_torch.data import cifar as tcifar


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    return tcifar.make_fake_cifar10(tmp_path_factory.mktemp("torch_cifar"),
                                    per_batch=6, seed=4)


def test_fake_archive_bytes_equal_jax(fake, tmp_path):
    ref = jcifar.make_fake_cifar10(tmp_path, per_batch=6, seed=4)
    names = sorted(p.name for p in fake.iterdir())
    assert names == sorted(p.name for p in ref.iterdir()) == [
        "data_batch_1", "data_batch_2", "data_batch_3", "data_batch_4",
        "data_batch_5", "test_batch"]
    for name in names:
        assert (fake / name).read_bytes() == (ref / name).read_bytes(), name


@pytest.mark.parametrize("form", ["dir", "tarball"])
def test_load_cifar10_equals_jax(fake, tmp_path, form):
    root = fake
    if form == "tarball":
        root = tmp_path / "cifar-10-python.tar.gz"
        with tarfile.open(root, "w:gz") as tf:
            tf.add(fake, arcname="cifar-10-batches-py")
    t_train, t_test = tcifar.load_cifar10(root)
    j_train, j_test = jcifar.load_cifar10(root)
    for t, j in ((t_train, j_train), (t_test, j_test)):
        assert t.images.dtype == np.uint8 and t.images.shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert t.classes == list(tcifar.CIFAR10_CLASSES) == j.classes
    assert len(t_train) == 30 and len(t_test) == 6
    with pytest.raises(FileNotFoundError):
        tcifar.load_cifar10(tmp_path / "missing")


@pytest.mark.parametrize("normalize", [False, True])
def test_resized_items_equal_jax(fake, normalize):
    t_train, _ = tcifar.load_cifar10(fake)
    j_train, _ = jcifar.load_cifar10(fake)
    t = tcifar.ResizedArrayDataset(t_train, 56, normalize=normalize)
    j = jcifar.ResizedArrayDataset(j_train, 56, normalize=normalize)
    assert len(t) == len(j) and t.classes == j.classes
    for i in (0, 7, len(t) - 1):
        (ta, tl), (ja, jl) = t[i], j[i]
        assert tl == jl and ta.shape == (56, 56, 3) and ta.dtype == ja.dtype
        np.testing.assert_array_equal(ta, ja)
