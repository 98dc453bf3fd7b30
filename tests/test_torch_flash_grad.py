"""The port's flash-attention gradients against the JAX package's.

``jax.grad`` through ``flash_attention`` (Pallas forward, dq and dk/dv
kernels in interpret mode) against ``torch.autograd`` through the port's
``autograd.Function`` (plain versions on CPU tensors), at ragged T in
{17, 197}, with and without dropout, on the same seeded numpy inputs.
Tolerances relative to each gradient's largest element: f32 2e-3 (the JAX
package's grad tolerance), bf16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops.dropout import (
    derive_positional_seed)
from pytorch_vit_paper_replication_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from pytorch_vit_paper_replication_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _grads(t, dtype, rate, seed=0, b=2, h=2, dh=32):
    rng = np.random.default_rng(seed + t)
    q, k, v, ct = [rng.standard_normal((b, t, h, dh)).astype(np.float32)
                   for _ in range(4)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    det = rate == 0.0
    key = jax.random.key(seed + 7)

    def jloss(args):
        out = jax_flash(*args, dropout_rate=rate, dropout_rng=key,
                        deterministic=det)
        return (out.astype(jnp.float32) * jnp.asarray(ct)).sum()

    want = jax.grad(jloss)(tuple(jnp.asarray(a).astype(jdt)
                                 for a in (q, k, v)))
    pseed = int(np.asarray(derive_positional_seed(key))[0])
    targs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*targs, dropout_rate=rate, seed=pseed,
                             deterministic=det)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return ([np.asarray(w.astype(jnp.float32)) for w in want],
            [a.grad.float().numpy() for a in targs])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [17, 197])
def test_flash_grads_match_jax_f32(t, rate):
    want, got = _grads(t, "float32", rate)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < TOL["float32"], f"{name}: {err}"


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_grads_match_jax_bf16(rate):
    want, got = _grads(17, "bfloat16", rate, seed=3)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < TOL["bfloat16"], f"{name}: {err}"


def test_flash_dropout_changes_grads_and_no_launch_on_cpu():
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    _, plain = _grads(17, "float32", 0.0, seed=5)
    _, dropped = _grads(17, "float32", 0.1, seed=5)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
    assert np.abs(plain[2] - dropped[2]).max() > 1e-2
