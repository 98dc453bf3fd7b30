"""The port's ring attention against the JAX package's, on the CPU.

The same seeded inputs (numpy) go through JAX ``make_ring_attention`` on
the conftest's virtual CPU devices and through the port's
``make_ring_attention`` on gloo rank processes (``parallel.spawn``, one
per device of the same mesh; the workers in
``tests/torch_parallel_worker.py`` import no JAX), each rank holding its
data rows, its token piece and, with tensor parallelism, its heads. The
meshes: seq 2 and 4, data 2 x seq 4, data 2 x model 2 x seq 2. Bounds are
the JAX package's kernel-test ones in f32: the forward within 1e-4, each
gradient within 2e-3 of its largest element (``jax.grad`` of the same
``sum(out * ct)``). With attention dropout the port gets JAX's int32
positional-hash seed (``derive_positional_seed`` of the same key), and
the keep masks (recovered with ``q = k = 0``, ``v`` the identity) are
compared bit for bit: with JAX's ring, across two mesh layouts, and with
the port's flash kernel's mask (its plain version; the card's run is
``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from pytorch_vit_paper_replication_tpu import parallel as jparallel
from pytorch_vit_paper_replication_tpu.configs import MeshConfig as JMeshCfg
from pytorch_vit_paper_replication_tpu.ops.attention import (
    dot_product_attention as jax_attention, sequence_parallel as jax_sp)
from pytorch_vit_paper_replication_tpu.ops.dropout import (
    derive_positional_seed)
from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
from pytorch_vit_paper_replication_tpu_torch.ops.dropout import _threshold
from pytorch_vit_paper_replication_tpu_torch.ops.flash_attention import (
    _keep_mask)
from pytorch_vit_paper_replication_tpu_torch.parallel import spawn

SPAWN_TIMEOUT_S = 120
RATE = 0.25
LAYOUTS = {"seq2": (1, 1, 2), "seq4": (1, 1, 4), "data2_seq4": (2, 1, 4),
           "data2_model2_seq2": (2, 2, 2)}


def jax_seed(key: int) -> int:
    """The int32 positional-hash seed JAX's ring derives from
    ``jax.random.key(key)``."""
    return int(np.asarray(derive_positional_seed(jax.random.key(key)))[0])


def qkv_ct(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]


def eye_case(b, h, t):
    """``q = k = 0`` and ``v`` the identity over tokens: output row
    ``(b, i, h)`` is the dropped weight row ``keep / t / keep_prob``."""
    z = np.zeros((b, t, h, t), np.float32)
    eye = np.broadcast_to(np.eye(t, dtype=np.float32)[None, :, None, :],
                          (b, t, h, t)).copy()
    return {"q": z, "k": z, "v": eye, "ct": np.ones_like(z)}


def jax_mesh(layout):
    """JAX's mesh of ``layout`` over the first of the virtual devices."""
    data, model, seq = LAYOUTS[layout]
    return jparallel.make_mesh(JMeshCfg(data=data, model=model, seq=seq),
                               devices=jax.devices()[:data * model * seq])


def jax_vjp(fn, case):
    """``fn``'s output on the case's ``q, k, v`` and the gradients of
    ``sum(out * ct)``, jitted as one program."""
    def both(q, k, v, ct):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(ct)
    out, grads = jax.jit(both)(*[jnp.asarray(case[n])
                                 for n in ("q", "k", "v", "ct")])
    return np.asarray(out), [np.asarray(g) for g in grads]


def jax_ring(layout, case, key=None, impl="ring"):
    """JAX's ring (or Ulysses) forward and gradients on ``layout``."""
    make = (jparallel.make_ring_attention if impl == "ring"
            else jparallel.make_ulysses_attention)
    kw = {}
    if key is not None:
        kw = dict(dropout_rate=RATE, dropout_rng=jax.random.key(key),
                  deterministic=False)
    return jax_vjp(make(jax_mesh(layout), head_axis="model"
                        if case.get("heads") else None, **kw), case)


def port(layout, impl, cases):
    data, model, seq = LAYOUTS[layout]
    return spawn(worker.sp_attention, MeshConfig(data=data, model=model,
                                                 seq=seq),
                 device="cpu", timeout_s=SPAWN_TIMEOUT_S, args=(impl, cases))


def assert_matches(got, want, fwd_tol=1e-4):
    (out, grads), (w_out, w_grads) = got, want
    np.testing.assert_allclose(out, w_out, rtol=fwd_tol, atol=fwd_tol)
    for name, g, w in zip("qkv", grads, w_grads):
        err = np.abs(g - w).max()
        assert err <= 2e-3 * np.abs(w).max(), (name, err)


CASES = {
    "seq2": dict(shape=(2, 32, 2, 16)),
    "seq4": dict(shape=(2, 32, 2, 16)),
    "data2_seq4": dict(shape=(4, 32, 2, 16)),
    "data2_model2_seq2": dict(shape=(4, 32, 4, 16), heads=True),
}


@pytest.mark.parametrize("layout", sorted(CASES))
def test_ring_matches_jax(layout):
    """Forward and gradients, without and with attention dropout (key 7),
    on each layout."""
    spec = CASES[layout]
    base = dict(zip("qkv", qkv_ct(1, *spec["shape"])))
    base["ct"] = qkv_ct(2, *spec["shape"])[0]
    base["heads"] = spec.get("heads", False)
    cases = [base, dict(base, rate=RATE, seed=jax_seed(7))]
    ranks = port(layout, "ring", cases)
    for i, key in enumerate((None, 7)):
        assert_matches(worker.assemble_sp(ranks, i, spec["shape"]),
                       jax_ring(layout, cases[i], key))


@pytest.fixture(scope="module")
def masks():
    """The keep masks ``[B, H, T, T]`` of the port's ring on data 2 x seq
    4 and on data 2 x model 2 x seq 2 (heads sharded), and JAX's ring's on
    the first, all for key 5."""
    b, h, t = 2, 2, 64
    case = dict(eye_case(b, h, t), rate=RATE, seed=jax_seed(5))
    got = {}
    for layout, heads in (("data2_seq4", False), ("data2_model2_seq2", True)):
        ranks = port(layout, "ring", [dict(case, heads=heads)])
        w, _ = worker.assemble_sp(ranks, 0, (b, t, h, t))
        got[layout] = w.transpose(0, 2, 1, 3)
    w_jax, _ = jax_ring("data2_seq4", case, 5)
    return got, w_jax.transpose(0, 2, 1, 3), (b, h, t)


def test_ring_dropout_masks_bit_equal_to_jax_and_layouts(masks):
    got, w_jax, (b, h, t) = masks
    keep = got["data2_seq4"] > 0
    np.testing.assert_array_equal(keep, w_jax > 0)
    np.testing.assert_array_equal(keep, got["data2_model2_seq2"] > 0)
    # Survivors carry the quantized-keep rescale, exactly.
    keep_prob = 1.0 - _threshold(RATE) / 256.0
    np.testing.assert_allclose(got["data2_seq4"][keep],
                               (1.0 / t) / keep_prob, rtol=1e-6)
    assert abs((1.0 - keep.mean()) - _threshold(RATE) / 256.0) < 0.02
    assert (keep[0, 0] != keep[0, 1]).mean() > 0.1      # heads differ
    assert (keep[0, 0] != keep[1, 0]).mean() > 0.1      # examples differ


def test_ring_and_flash_dropout_masks_identical(masks):
    """For one seed the ring drops exactly the flash kernel's elements
    (the port's flash mask over ``[B*H, T, T]``)."""
    got, _, (b, h, t) = masks
    flash = _keep_mask(jax_seed(5), b * h, t, t, _threshold(RATE),
                       torch.device("cpu")).numpy()
    np.testing.assert_array_equal(
        (got["data2_seq4"] > 0).reshape(b * h, t, t), flash)


def test_dispatch_runs_ring_with_dropout():
    """Inside ``sequence_parallel`` the dispatch goes through the ring
    (JAX's ``test_sequence_parallel_dispatch_runs_dropout_in_ring``):
    outputs and gradients equal JAX's dispatch under its context for the
    same key, two keys differ, and ``deterministic`` is exact attention.
    No warning: nothing falls back."""
    shape = (2, 32, 2, 16)
    q, k, v, ct = qkv_ct(3, *shape)
    base = {"q": q, "k": k, "v": v, "ct": ct}
    cases = [dict(base, rate=0.3, seed=jax_seed(1)),
             dict(base, rate=0.3, seed=jax_seed(2)), base]
    ranks = spawn(worker.sp_dispatch, MeshConfig(data=2, seq=4),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                  args=("ring", cases))
    assert all(not c["warnings"] for r in ranks for c in r["cases"])
    got = [worker.assemble_sp(ranks, i, shape) for i in range(3)]
    mesh = jax_mesh("data2_seq4")
    for i, key in enumerate((1, 2, None)):
        def fn(*a, key=key):
            with jax_sp(mesh):
                if key is None:
                    return jax_attention(*a, dropout_rate=0.3)
                return jax_attention(*a, dropout_rate=0.3,
                                     dropout_rng=jax.random.key(key),
                                     deterministic=False)
        assert_matches(got[i], jax_vjp(fn, base))
    assert not np.allclose(got[0][0], got[1][0])
    exact = np.asarray(jax.nn.dot_product_attention(
        *[jnp.asarray(a) for a in (q, k, v)]))
    np.testing.assert_allclose(got[2][0], exact, rtol=1e-4, atol=1e-4)
