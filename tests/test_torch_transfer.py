"""The port's transfer path (``transfer.py``, ``--freeze-backbone``)
against the JAX package's.

The pretrained weights are a seeded torchvision-layout ViT built from
stock ``torch.nn`` layers (``tools/make_torch_vit.py::TorchViT``); the
reference repo's custom layout is the same state dict under its module
names. Tolerances:

* ``convert_torch_vit_state_dict`` only reshapes and transposes: equal to
  JAX's bit for bit, for both layouts, with and without the head;
* ``interpolate_pos_embedding``: within 1e-6 of JAX's
  ``jax.image.resize(..., "bicubic")`` (f32 sums in another order);
  ``F.interpolate(mode="bicubic")`` is a different function (a = -0.75,
  clamped borders) and misses by orders of magnitude more;
* ``init_from_pretrained``: equal to JAX's bit for bit at the source
  resolution, within 1e-6 through the interpolation;
* a forward with converted weights: within 1e-4 of JAX's ViT and of the
  stock-torch module (f32, LN epsilon 1e-5 as torch.nn.LayerNorm's);
* 5 frozen-backbone steps against JAX's ``train_step`` with
  ``head_only_label_fn``: loss and ``grad_norm`` within 2e-3 (relative),
  the backbone unchanged bit for bit, the head moved.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu import engine as jengine
from pytorch_vit_paper_replication_tpu import optim as joptim
from pytorch_vit_paper_replication_tpu import transfer as jtransfer
from pytorch_vit_paper_replication_tpu.configs import TrainConfig as JTrain
from pytorch_vit_paper_replication_tpu.configs import ViTConfig as JCfg
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu_torch import engine, optim, transfer
from pytorch_vit_paper_replication_tpu_torch.configs import (
    TrainConfig, ViTConfig)
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, params_from_flax, params_to_flax)
from pytorch_vit_paper_replication_tpu_torch.models import ViT

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
             embedding_dim=32, mlp_size=64, num_classes=3, dtype="float32",
             attn_dropout=0.0, mlp_dropout=0.0, embedding_dropout=0.0,
             ln_epsilon=1e-5, attention_impl="xla", mlp_impl="xla")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_vit", REPO / "tools" / "make_torch_vit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def torch_vit():
    """The stock-torch ViT (torchvision layout) at SMALL, seed 0."""
    torch.manual_seed(0)
    return _tool().TorchViT(JCfg(**SMALL)).eval()


# torchvision name -> the reference repo's custom-layout name.
_CUSTOM = [
    ("conv_proj.", "patch_embedding_block.patcher.0."),
    ("class_token", "patch_embedding_block.class_token"),
    ("encoder.pos_embedding", "patch_embedding_block.position_embedding"),
    ("encoder.ln.", "layer_norm."),
    ("heads.", "classifier.0."),
]
_CUSTOM_BLOCK = [
    ("ln_1.", "msa_block.layer_norm."),
    ("self_attention.", "msa_block.multihead_attn."),
    ("ln_2.", "mlp_block.layer_norm."),
    ("mlp.", "mlp_block.mlp."),
]


def _custom_layout(sd):
    out = {}
    for key, val in sd.items():
        if key.startswith("encoder.layers.encoder_layer_"):
            i, rest = key[len("encoder.layers.encoder_layer_"):].split(".", 1)
            for a, b in _CUSTOM_BLOCK:
                if rest.startswith(a):
                    rest = b + rest[len(a):]
                    break
            out[f"transformer_encoder.{i}.{rest}"] = val
            continue
        for a, b in _CUSTOM:
            if key.startswith(a):
                key = b + key[len(a):]
                break
        out[key] = val
    return out


def _layout(torch_vit, name):
    sd = torch_vit.state_dict()
    return sd if name == "torchvision" else _custom_layout(sd)


def _stock_forward(m, x_nhwc: np.ndarray, eps: float) -> np.ndarray:
    """The stock-torch module's forward (NCHW conv, nn.MultiheadAttention,
    nn.LayerNorm with ``eps``)."""
    for mod in m.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            mod.eps = eps
    with torch.no_grad():
        x = torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2))
        p = m.conv_proj(x).flatten(2).transpose(1, 2)
        tok = torch.cat([m.class_token.expand(x.shape[0], -1, -1), p], 1)
        tok = tok + m.encoder.pos_embedding
        for i in range(len(m.encoder.layers)):
            tok = m.encoder.layers[f"encoder_layer_{i}"](tok)
        return m.heads(m.encoder.ln(tok)[:, 0]).numpy()


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype and \
            np.array_equal(got[key], val), key


@pytest.mark.parametrize("include_head", [False, True])
@pytest.mark.parametrize("layout", ["torchvision", "reference"])
def test_convert_equals_jax_bit_for_bit(torch_vit, layout, include_head):
    sd = _layout(torch_vit, layout)
    got = transfer.convert_torch_vit_state_dict(
        sd, ViTConfig(**SMALL), include_head=include_head)
    want = jtransfer.convert_torch_vit_state_dict(
        sd, JCfg(**SMALL), include_head=include_head)
    _assert_trees_equal(got, want)


def test_convert_to_gap_pool_drops_cls_like_jax(torch_vit):
    sd = torch_vit.state_dict()
    got = transfer.convert_torch_vit_state_dict(
        sd, ViTConfig(**{**SMALL, "pool": "gap"}))
    want = jtransfer.convert_torch_vit_state_dict(
        sd, JCfg(**{**SMALL, "pool": "gap"}))
    assert "cls_token" not in got["backbone"]["patch_embedding"]
    np.testing.assert_allclose(
        got["backbone"]["patch_embedding"]["pos_embedding"],
        want["backbone"]["patch_embedding"]["pos_embedding"], atol=1e-6)
    assert set(flatten_tree(got)) == set(flatten_tree(want))


@pytest.mark.parametrize("case", ["depth", "layout", "head_classes"])
def test_convert_refusals_match_jax(torch_vit, case):
    sd = torch_vit.state_dict()
    kw = {}
    cfg = SMALL
    if case == "depth":
        cfg = {**SMALL, "num_layers": 3}
    elif case == "layout":
        sd = {"foo.weight": np.zeros((2, 2), np.float32)}
    else:
        cfg = {**SMALL, "num_classes": 7}
        kw = {"include_head": True}
    with pytest.raises(ValueError):
        jtransfer.convert_torch_vit_state_dict(sd, JCfg(**cfg), **kw)
    with pytest.raises(ValueError):
        transfer.convert_torch_vit_state_dict(sd, ViTConfig(**cfg), **kw)


@pytest.mark.parametrize("src,dst,cls,pool", [
    (197, 384, True, "cls"),     # 14 -> 24 with the CLS slot (224 -> 384)
    (577, 224, True, "cls"),     # 24 -> 14, the antialiased downsample
    (196, 384, False, "cls"),    # grid-only source, a zero CLS slot added
    (197, 384, True, "gap"),     # CLS dropped for a gap-pool target
    (197, 224, True, "cls"),     # same size: a copy
])
def test_interpolate_pos_embedding_within_1e6_of_jax(src, dst, cls, pool):
    d = 48
    pos = (np.random.default_rng(src + dst).standard_normal((1, src, d))
           * 0.1).astype(np.float32)
    kw = dict(SMALL, image_size=dst, patch_size=16, embedding_dim=d,
              num_heads=4, pool=pool)
    got = transfer.interpolate_pos_embedding(pos, ViTConfig(**kw))
    want = jtransfer.interpolate_pos_embedding(pos, JCfg(**kw))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6
    if src != 197 or dst != 224:
        # The library's bicubic is another function (a = -0.75, clamped
        # borders): it misses JAX's by far more than the tolerance.
        gs_s, gs_d = int(round((src - cls) ** 0.5)), dst // 16
        grid = torch.from_numpy(pos[0, int(cls):].reshape(gs_s, gs_s, d))
        lib = torch.nn.functional.interpolate(
            grid.permute(2, 0, 1)[None], size=(gs_d, gs_d), mode="bicubic",
            align_corners=False)[0].permute(1, 2, 0).reshape(-1, d).numpy()
        assert np.abs(lib - want[0, -gs_d * gs_d:]).max() > 1e-3


def test_interpolate_rejects_a_non_square_grid():
    with pytest.raises(ValueError, match="neither a square grid"):
        transfer.interpolate_pos_embedding(np.zeros((1, 20, 8), np.float32),
                                           ViTConfig(**SMALL))


@pytest.mark.parametrize("image_size", [32, 48])
def test_init_from_pretrained_matches_jax(torch_vit, tmp_path, image_size):
    """A ``.pth`` file in, the port's state_dict out: every backbone param
    equals JAX's ``init_from_pretrained`` (bit for bit at the source
    resolution; within 1e-6 where the position embedding is interpolated
    4x4 -> 6x6), the head zeros."""
    path = tmp_path / "vit.pth"
    torch.save(torch_vit.state_dict(), path)
    kw = dict(SMALL, image_size=image_size)
    jcfg = JCfg(**kw)
    want = flatten_tree(jtransfer.init_from_pretrained(
        JViT(jcfg), jcfg, str(path), rng=jax.random.key(3)))
    state = transfer.init_from_pretrained(ViTConfig(**kw), path)
    got = flatten_tree(params_to_flax(state))
    assert set(got) == set(want)
    for key, val in want.items():
        val = np.asarray(val)
        if key.endswith("pos_embedding") and image_size != 32:
            assert np.abs(got[key] - val).max() <= 1e-6
        else:
            assert np.array_equal(got[key], val), key
    assert not got["head/kernel"].any() and not got["head/bias"].any()
    assert all(v.dtype == torch.float32 for v in state.values())


def test_load_torch_file_matches_jax(torch_vit, tmp_path):
    path = tmp_path / "vit.pt"
    torch.save(torch_vit.state_dict(), path)
    got, want = transfer.load_torch_file(path), jtransfer.load_torch_file(path)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_forward_with_converted_weights_matches_jax_and_torch(torch_vit):
    """Converted weights (head included) give the JAX ViT's logits and the
    stock-torch module's, within 1e-4 — every transpose and reshape of the
    converter is right."""
    sd = torch_vit.state_dict()
    tree = transfer.convert_torch_vit_state_dict(sd, ViTConfig(**SMALL),
                                                 include_head=True)
    model = ViT(ViTConfig(**SMALL)).eval()
    model.load_state_dict(params_from_flax(tree))
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jax_out = np.asarray(JViT(JCfg(**SMALL)).apply(
        {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(x)))
    stock = _stock_forward(torch_vit, x, eps=SMALL["ln_epsilon"])
    np.testing.assert_allclose(got, jax_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, stock, rtol=1e-4, atol=1e-4)


STEPS = 5


def test_frozen_backbone_trajectory_matches_jax(torch_vit):
    """5 steps of ``--freeze-backbone`` from the same pretrained init:
    losses and grad norms (the norm of every gradient, backbone included,
    as JAX's engine takes it) within 2e-3 of JAX's ``train_step`` with
    ``head_only_label_fn``; the backbone bit-identical to the converted
    weights after the steps in both packages; the head moved, within 2e-3
    of JAX's; Adam state for the head only."""
    cfg = dict(SMALL, dtype="float32")
    sd = torch_vit.state_dict()
    jcfg = JCfg(**cfg)
    params = jax.device_get(jtransfer.init_from_pretrained(JViT(jcfg), jcfg,
                                                           sd))
    rng = np.random.default_rng(11)
    batches = [{"image": rng.standard_normal((8, 32, 32, 3)).astype(
                    np.float32),
                "label": rng.integers(0, 3, 8).astype(np.int32)}
               for _ in range(STEPS)]
    recipe = dict(batch_size=8, learning_rate=1e-2, weight_decay=0.03,
                  warmup_fraction=0.0, grad_clip_norm=1.0,
                  freeze_backbone=True)
    tx = joptim.make_optimizer(JTrain(**recipe), STEPS,
                               trainable_label_fn=joptim.head_only_label_fn)
    jstate = jengine.TrainState.create(
        apply_fn=JViT(jcfg).apply, params=jax.tree.map(jnp.asarray, params),
        tx=tx, rng=jax.random.key(0))
    jstep = jax.jit(jengine.make_train_step())
    jm = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in jax.device_get(m).items()})

    model = ViT(ViTConfig(**cfg))
    model.load_state_dict(transfer.init_from_pretrained(ViTConfig(**cfg), sd))
    state = engine.TrainState.create(
        model=model, seed=0,
        tx=optim.make_optimizer(TrainConfig(**recipe), STEPS,
                                trainable_label_fn=optim.head_only_label_fn))
    assert set(state.opt_state.mu) == {"head.kernel", "head.bias"}
    step = engine.make_train_step()
    tm = []
    for b in batches:
        state, m = step(state, b)
        tm.append({k: float(v) for k, v in m.items()})
    for key in ("loss_sum", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in tm],
                                   [m[key] for m in jm], rtol=2e-3,
                                   err_msg=key)
    got = flatten_tree(params_to_flax(state.model.state_dict()))
    jfinal = flatten_tree(jax.device_get(jstate.params))
    start = flatten_tree(params)
    for key, val in start.items():
        if key.startswith("backbone/"):
            assert np.array_equal(got[key], val), key
            assert np.array_equal(np.asarray(jfinal[key]), val), key
    for key in ("head/kernel", "head/bias"):
        assert np.abs(got[key] - start[key]).max() > 1e-3, key
        np.testing.assert_allclose(got[key], jfinal[key], rtol=2e-3,
                                   atol=2e-4, err_msg=key)
