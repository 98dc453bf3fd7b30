"""The port's ViT against the JAX package's on converted weights.

The JAX model is initialized from a seed, its param tree converted with
``convert.params_from_flax``, and both models classify the same seeded
NHWC images. f32 logits within 1e-4 for every mlp_impl x attention_impl
(JAX's Pallas kernels in interpret mode; the port's plain versions);
bf16 logits within 5e-2 (bf16 activations through two blocks: each
framework rounds the same ops to bf16, but sums in different orders, so
per-element differences of a few bf16 ulps propagate to the logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.configs import ViTConfig as JCfg
from pytorch_vit_paper_replication_tpu.configs import vit_b16 as jvit_b16
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.models import (
    ViTFeatureExtractor as JFeat)
from pytorch_vit_paper_replication_tpu_torch import configs as tcfg
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, load_params_npz, params_from_flax, params_to_flax,
    save_params_npz, seeded_params)
from pytorch_vit_paper_replication_tpu_torch.models import (
    ViT, ViTFeatureExtractor, create_model)

SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4,
             embedding_dim=64, mlp_size=128, num_classes=5)


def _pair(dtype="float32", **kw):
    """(jax model, jax params, port model) on the same weights."""
    fields = {**SMALL, "dtype": dtype, **kw}
    jm = JViT(JCfg(**fields))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    # Perturb the zero-initialized leaves so biases, CLS and LN params
    # take part in the comparison.
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
        np.float32) for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    tm = ViT(tcfg.ViTConfig(**fields)).eval()
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _images(seed=0, n=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def test_b16_param_count_matches_reference():
    """85,800,963 params for the 3-class ViT-B/16 (the reference's
    count, asserted for the JAX package in tests/test_models.py)."""
    with torch.device("meta"):
        model = ViT(tcfg.vit_b16(num_classes=3))
    assert sum(p.numel() for p in model.parameters()) == 85_800_963


def test_param_tree_keys_and_shapes_match_flax():
    jm, params, tm = _pair()
    flat = params_from_flax(params)
    state = tm.state_dict()
    assert set(flat) == set(state)
    for k, v in flat.items():
        assert tuple(v.shape) == tuple(state[k].shape), k


@pytest.mark.parametrize("mlp_impl", ["xla", "fused"])
@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_logits_match_jax_f32(mlp_impl, attention_impl):
    jm, params, tm = _pair(mlp_impl=mlp_impl, attention_impl=attention_impl)
    x = _images()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_logits_match_jax_bf16():
    jm, params, tm = _pair(dtype="bfloat16", mlp_impl="xla",
                           attention_impl="xla")
    x = _images(2)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=5e-2)


def test_feature_extractor_matches_jax():
    jm, params, tm = _pair(mlp_impl="fused")
    x = _images(3)
    want = np.asarray(JFeat(jm.config).apply(
        {"params": params["backbone"]}, jnp.asarray(x)))
    feat = create_model(tm.config, with_head=False)
    assert isinstance(feat, ViTFeatureExtractor)
    feat.load_state_dict({k[len("backbone."):]: v
                          for k, v in tm.state_dict().items()
                          if k.startswith("backbone.")})
    with torch.inference_mode():
        got = feat.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_npz_roundtrip_and_seeded_params(tmp_path):
    cfg = tcfg.ViTConfig(**SMALL, dtype="float32")
    state = seeded_params(cfg, 3)
    path = save_params_npz(tmp_path / "params.npz", state)
    back = load_params_npz(path)
    assert set(back) == set(state)
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)
    with np.load(path) as z:
        assert z["backbone/encoder_block_1/mlp/fc2/kernel"].shape == (128, 64)
    again = seeded_params(cfg, 3)
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_port_config_mirrors_jax_config():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JCfg)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.ViTConfig)}
    assert jf == tf
    assert set(tcfg.PRESETS) == {"ViT-Ti/16", "ViT-S/16", "ViT-B/16",
                                 "ViT-L/16", "ViT-H/14"}
    assert tcfg.arch_of(tcfg.vit_b16()) == {
        "patch_size": 16, "num_layers": 12, "num_heads": 12,
        "embedding_dim": 768, "mlp_size": 3072, "pool": "cls"}
    assert tcfg.model_tier(tcfg.vit_ti16(num_classes=7)) == "ViT-Ti/16"
    assert tcfg.model_tier(tcfg.ViTConfig(**SMALL)) == "custom/64x2p8"
    from pytorch_vit_paper_replication_tpu.compile_cache import (
        config_fingerprint as jfp)
    from pytorch_vit_paper_replication_tpu_torch.compile_cache import (
        config_fingerprint as tfp)
    assert tfp(tcfg.vit_b16(), image_size=224) == \
        jfp(jvit_b16(), image_size=224)
    for bad in (dict(image_size=30), dict(mlp_impl="bogus"),
                dict(attention_probs_dtype="f4")):
        with pytest.raises(ValueError):
            tcfg.ViTConfig(**{**SMALL, **bad})


def test_fused_mlp_without_residual_refuses():
    """The standalone fused ``MLPBlock`` (``include_residual=False``, the
    reference's own contract), which the port once refused, now runs the
    MLP core (plain version on the CPU) and equals JAX's ``MLPBlock(cfg,
    mlp_impl="fused")`` (Pallas core in interpret mode): f32 forward
    within 1e-4, and every parameter's and the input's gradient within
    2e-3 of its largest element."""
    from pytorch_vit_paper_replication_tpu.models.vit import (
        MLPBlock as JMLPBlock)
    from pytorch_vit_paper_replication_tpu_torch.models.vit import MLPBlock
    jcfg = JCfg(**SMALL, dtype="float32", mlp_impl="fused")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    jblk = JMLPBlock(jcfg)
    params = jblk.init(jax.random.key(1), jnp.asarray(x))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])
    ct = rng.standard_normal((2, 17, 64)).astype(np.float32)

    def jloss(p, xx):
        return (jblk.apply({"params": p}, xx) * ct).sum()

    want = np.asarray(jax.jit(jblk.apply)({"params": params},
                                          jnp.asarray(x)))
    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                          jnp.asarray(x))
    blk = MLPBlock(tcfg.ViTConfig(**SMALL, dtype="float32", mlp_impl="fused"),
                   include_residual=False).eval()
    blk.load_state_dict(params_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    got = blk(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-4)
    (got * torch.from_numpy(ct)).sum().backward()
    want_g = {**{k: np.asarray(v) for k, v in flatten_tree(jg_p).items()},
              "x": np.asarray(jg_x)}
    got_g = {**{k.replace(".", "/"): p.grad.numpy()
                for k, p in blk.named_parameters()}, "x": xt.grad.numpy()}
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        assert np.abs(got_g[k] - w).max() <= 2e-3 * np.abs(w).max(), k


def test_params_to_flax_roundtrip_on_jax_tree():
    """``params_to_flax`` inverts ``params_from_flax`` on a JAX-initialised
    tree: same nesting, keys, shapes and values, and the JAX model runs on
    the result."""
    jm, params, tm = _pair()
    back = params_to_flax(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.device_get(params))
    for key, val in flatten_tree(params).items():
        np.testing.assert_array_equal(flatten_tree(back)[key], val)
    x = _images(4)
    np.testing.assert_array_equal(
        np.asarray(jm.apply({"params": back}, jnp.asarray(x))),
        np.asarray(jm.apply({"params": params}, jnp.asarray(x))))


@pytest.mark.parametrize("mlp_impl", ["xla", "fused"])
@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_remat_gives_identical_grads(mlp_impl, attention_impl):
    """Remat on and off, the same rng seed, every dropout at 0.1: the
    seeds are drawn outside the checkpointed blocks, so the recomputed
    forward sees the same masks and the f32 grads are identical."""
    grads = []
    for remat in (False, True):
        cfg = tcfg.ViTConfig(**SMALL, dtype="float32", mlp_impl=mlp_impl,
                             attention_impl=attention_impl, remat=remat,
                             attn_dropout=0.1)
        model = ViT(cfg).train()
        model.load_state_dict(seeded_params(cfg, 2))
        out = model(torch.from_numpy(_images(5)),
                    torch.Generator().manual_seed(11))
        out.square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
    assert any(g.abs().sum() > 0 for g in grads[0].values())


def test_training_mode_needs_rng_and_dropout_is_seeded():
    cfg = tcfg.ViTConfig(**SMALL, dtype="float32")
    model = ViT(cfg).train()
    model.load_state_dict(seeded_params(cfg, 0))
    x = torch.from_numpy(_images(6))
    with pytest.raises(ValueError, match="rng"):
        model(x)
    a = model(x, torch.Generator().manual_seed(1))
    b = model(x, torch.Generator().manual_seed(1))
    c = model(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        e = model.eval()(x)
    assert not torch.equal(a, e)
    no_drop = ViT(cfg.replace(mlp_dropout=0.0, embedding_dropout=0.0))
    no_drop.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(no_drop.train()(x), e, rtol=0, atol=0)


# --- TinyVGG: the port against JAX's models/tinyvgg.py --------------------
@pytest.mark.parametrize("image_size,hidden", [(64, 10), (33, 4), (16, 3)])
def test_tinyvgg_matches_jax_f32(image_size, hidden):
    """Same seeded weights (JAX's init, biases perturbed) and NHWC images:
    logits within 1e-5, the param names and shapes Flax's; the classifier
    reads the NHWC-flattened map (an NCHW flatten fails the comparison)."""
    from pytorch_vit_paper_replication_tpu.models import TinyVGG as JTiny
    from pytorch_vit_paper_replication_tpu_torch.models import TinyVGG
    jm = JTiny(hidden_units=hidden, num_classes=3)
    x = np.random.default_rng(image_size).standard_normal(
        (2, image_size, image_size, 3)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.key(1), jnp.zeros(
        (1, image_size, image_size, 3)))["params"])
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
        if p[-1].key == "bias" else v, params)
    model = TinyVGG(hidden_units=hidden, num_classes=3,
                    image_size=image_size)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k.replace("/", "."): v.shape
         for k, v in flatten_tree(params).items()}
    model.load_state_dict(params_from_flax(params))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tinyvgg_bf16_convs_and_f32_classifier():
    """``dtype="bfloat16"`` runs the convs in bf16 and the classifier in
    f32 (f32 logits), within bf16 rounding of JAX's bf16 model; too small
    an image is refused."""
    from pytorch_vit_paper_replication_tpu.models import TinyVGG as JTiny
    from pytorch_vit_paper_replication_tpu_torch.models import TinyVGG
    jm = JTiny(hidden_units=8, num_classes=3, dtype="bfloat16")
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    params = jax.device_get(jm.init(jax.random.key(0), jnp.zeros(
        (1, 32, 32, 3)))["params"])
    model = TinyVGG(hidden_units=8, num_classes=3, dtype="bfloat16",
                    image_size=32)
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)
    with pytest.raises(ValueError, match="needs >= 16"):
        TinyVGG(image_size=15)


def test_seeded_state_covers_tinyvgg():
    """``convert.seeded_state`` gives every TinyVGG param LeCun-normal
    kernels (fan-in 3 x 3 x C for the convs) and zero biases."""
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_state
    from pytorch_vit_paper_replication_tpu_torch.models import TinyVGG
    state = seeded_state(TinyVGG(hidden_units=16, image_size=64), 0)
    k = state["block1_conv0.kernel"]
    assert abs(float(k.std()) - (9 * 16) ** -0.5) < 0.01
    assert not state["classifier.bias"].any()
    assert torch.equal(state["block0_conv0.kernel"],
                       seeded_state(TinyVGG(hidden_units=16, image_size=64),
                                    0)["block0_conv0.kernel"])
