"""The port's Ulysses attention and the sequence-parallel dispatch against
the JAX package's, on the CPU.

As ``tests/test_torch_ring.py``: seeded numpy inputs through JAX
``make_ulysses_attention`` on the virtual CPU devices and through the
port's on gloo rank processes of the same mesh, each rank holding its
shards; forward within 1e-4, gradients within 2e-3 of each one's largest
element, dropout keep masks bit for bit (against JAX's Ulysses and the
port's ring). Then the dispatch (``dot_product_attention`` inside
``sequence_parallel(..., sp_impl="ulysses")``), JAX's
``tests/test_ulysses.py`` cases: the all-to-all path when the heads
divide, and the two of JAX's fallbacks to the gathered xla path that
the port's shards can meet, each with JAX's warning text (read from
JAX's warn-once by a patch, since an earlier test in the process may
have used up JAX's one warning): heads that do not divide, a mask. Last,
the gathered path's attention dropout against the port's own unsharded
xla call with the same seed.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from pytorch_vit_paper_replication_tpu.ops import attention as jattention
from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
from pytorch_vit_paper_replication_tpu_torch.ops.attention import (
    _xla_attention)
from pytorch_vit_paper_replication_tpu_torch.parallel import spawn
from test_torch_ring import (LAYOUTS, RATE, SPAWN_TIMEOUT_S, assert_matches,
                             eye_case, jax_mesh, jax_ring, jax_seed,
                             jax_vjp, port, qkv_ct)

CASES = {
    "seq2": dict(shape=(2, 32, 2, 16)),
    "seq4": dict(shape=(2, 32, 4, 16)),
    "data2_seq4": dict(shape=(4, 32, 4, 16)),
    "data2_model2_seq2": dict(shape=(4, 32, 4, 16), heads=True),
}


def _base(spec, seed):
    q, k, v, ct = qkv_ct(seed, *spec["shape"])
    return {"q": q, "k": k, "v": v, "ct": ct,
            "heads": spec.get("heads", False)}


@pytest.mark.parametrize("layout", sorted(CASES))
def test_ulysses_matches_jax(layout):
    """Forward and gradients, without and with attention dropout (key 7);
    on data 2 x model 2 x seq 2 the model axis's local heads are split
    again over seq."""
    spec = CASES[layout]
    base = _base(spec, 1)
    cases = [base, dict(base, rate=RATE, seed=jax_seed(7))]
    ranks = port(layout, "ulysses", cases)
    for i, key in enumerate((None, 7)):
        assert_matches(worker.assemble_sp(ranks, i, spec["shape"]),
                       jax_ring(layout, cases[i], key, impl="ulysses"))


def test_ulysses_dropout_mask_identical_to_ring_and_jax():
    """For one seed Ulysses drops the same elements as the port's ring
    and as JAX's Ulysses (global example·head, row, column)."""
    b, h, t = 2, 4, 64
    case = dict(eye_case(b, h, t), rate=RATE, seed=jax_seed(5))
    got = {}
    for impl in ("ulysses", "ring"):
        got[impl], _ = worker.assemble_sp(port("data2_seq4", impl, [case]),
                                          0, (b, t, h, t))
    w_jax, _ = jax_ring("data2_seq4", case, 5, impl="ulysses")
    np.testing.assert_array_equal(got["ulysses"] > 0, got["ring"] > 0)
    np.testing.assert_array_equal(got["ulysses"] > 0, w_jax > 0)
    np.testing.assert_allclose(got["ulysses"], got["ring"], rtol=1e-5)


def test_ulysses_refuses_indivisible_heads():
    """h = 2 on seq 4: the op raises JAX's ValueError (the dispatch falls
    back instead)."""
    case = _base(dict(shape=(2, 32, 2, 16)), 4)
    got = port("data2_seq4", "ulysses", [case])
    with pytest.raises(ValueError, match="divisible") as want:
        jax_ring("data2_seq4", case, impl="ulysses")
    assert {r["cases"][0]["error"] for r in got} == {str(want.value)}


def _jax_dispatch(monkeypatch, case, shape):
    """JAX's dispatch inside ``sequence_parallel(sp_impl="ulysses")`` on
    data 2 x seq 4, global arrays: output, gradients and the warnings its
    warn-once was asked for."""
    said = []
    monkeypatch.setattr(jattention, "_warn_once", said.append)
    mesh = jax_mesh("data2_seq4")
    mask = case.get("mask")

    def fn(q, k, v):
        with jattention.sequence_parallel(mesh, sp_impl="ulysses"):
            return jattention.dot_product_attention(
                q, k, v, mask=None if mask is None else jax.numpy.asarray(
                    mask))
    return jax_vjp(fn, case), said


FALLBACKS = {
    # name: (global shape, extra case keys)
    "ulysses": ((2, 32, 4, 16), {}),
    "heads": ((2, 32, 2, 16), {}),
    "mask": ((2, 32, 4, 16), {"mask": True}),
}
# The gathered path with attention dropout (heads 2 on seq 4): q = k = 0
# and v the identity, so the output rows are the dropped weight rows.
DROPOUT_SHAPE = (2, 32, 2, 32)
DROPOUT_SEED = 11


@pytest.fixture(scope="module")
def dispatched():
    """Every FALLBACKS case, then the dropout case, through the port's
    dispatch on one spawn of data 2 x seq 4 ranks."""
    cases = []
    for name in sorted(FALLBACKS):
        shape, extra = FALLBACKS[name]
        case = _base(dict(shape=shape), 5)
        if extra.get("mask"):
            mask = np.ones((shape[0], 1, 1, shape[1]), bool)
            mask[1, ..., -7:] = False       # example 1 pads its last keys
            case["mask"] = mask
        cases.append(case)
    b, t, h, _ = DROPOUT_SHAPE
    cases.append(dict(eye_case(b, h, t), rate=RATE, seed=DROPOUT_SEED))
    data, model, seq = LAYOUTS["data2_seq4"]
    ranks = spawn(worker.sp_dispatch, MeshConfig(data=data, model=model,
                                                 seq=seq),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                  args=("ulysses", cases))
    return dict(zip(sorted(FALLBACKS), cases)), ranks


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_dispatch_ulysses_and_fallbacks_match_jax(dispatched, monkeypatch,
                                                  name):
    """Heads that divide: the all-to-all path, no warning. Otherwise the
    gathered xla path with JAX's warning, on every rank; the outputs and
    gradients are JAX's in every case."""
    cases, ranks = dispatched
    i = sorted(FALLBACKS).index(name)
    shape = FALLBACKS[name][0]
    want, said = _jax_dispatch(monkeypatch, cases[name], shape)
    assert_matches(worker.assemble_sp(ranks, i, shape), want)
    assert len(said) == (0 if name == "ulysses" else 1)
    for r in ranks:
        assert r["cases"][i]["warnings"] == said


def test_gathered_fallback_dropout_is_the_unsharded_calls(dispatched):
    """With attention dropout the gathered path keeps, on every (data,
    seq) rank, its block of the unsharded xla call's output and gradients
    for the same seed: the same keep bits, so the two data shards drop
    differently, as the rows of one call do."""
    _, ranks = dispatched
    b, t, h, _ = DROPOUT_SHAPE
    case = eye_case(b, h, t)
    qkv = [torch.from_numpy(case[n]).requires_grad_() for n in "qkv"]
    out = _xla_attention(*qkv, dropout_rate=RATE, seed=DROPOUT_SEED,
                         deterministic=False)
    (out * torch.from_numpy(case["ct"])).sum().backward()
    want = (out.detach().numpy(), [a.grad.numpy() for a in qkv])
    got = worker.assemble_sp(ranks, len(FALLBACKS), DROPOUT_SHAPE)
    assert_matches(got, want, fwd_tol=1e-6)
    np.testing.assert_array_equal(got[0] > 0, want[0] > 0)
    assert not np.array_equal(want[0][0] > 0, want[0][1] > 0)
