"""The port's native JPEG decoder against the JAX package's.

Both compile the same ``jpeg_loader.cc`` (the port's copy) with g++ and
libjpeg; the port builds into its own git-ignored ``_build/``, named by a
digest of source and flags, and never loads the JAX package's library.
Decodes must be bit-identical in both modes at two output sizes.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pytorch_vit_paper_replication_tpu import native as jnative
from pytorch_vit_paper_replication_tpu_torch import native as tnative

JAX_SOURCE = Path(jnative.__file__).parent / "jpeg_loader.cc"


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_native")
    rng = np.random.default_rng(11)
    paths = []
    for i, (h, w) in enumerate(((96, 128), (120, 80), (64, 64))):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p = root / f"img_{i}.jpg"
        Image.fromarray(arr).save(p, quality=90)
        paths.append(p)
    return paths


def test_library_builds_under_the_ports_build_dir():
    assert tnative.available(), tnative.unavailable_reason()
    assert tnative.unavailable_reason() is None
    path = tnative.library_path()
    assert path.is_file()
    assert path.parent == tnative.BUILD_DIR
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "pytorch_vit_paper_replication_tpu_torch"
    assert tnative.SOURCE.read_bytes() == JAX_SOURCE.read_bytes()
    # The port's library is its own file, never the JAX package's.
    assert path.resolve() != (JAX_SOURCE.parent / "_jpeg_loader.so").resolve()


@pytest.mark.parametrize("target", [32, 56])
@pytest.mark.parametrize("mode,resize", [("squash", None),
                                         ("shorter_crop", None),
                                         ("shorter_crop", 72)])
def test_decode_bit_identical_to_jax(jpegs, mode, resize, target):
    for p in jpegs:
        got = tnative.decode_jpeg_file(p, target, mode, resize)
        want = jnative.decode_jpeg_file(p, target, mode, resize)
        assert got is not None and want is not None
        assert got.shape == (target, target, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tnative.decode_jpeg(p.read_bytes(), target, mode, resize), got)


def test_undecodable_input_returns_none(tmp_path):
    assert tnative.decode_jpeg(b"not a jpeg", 32) is None
    assert tnative.decode_jpeg_file(tmp_path / "missing.jpg", 32) is None
