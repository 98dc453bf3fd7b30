"""Transfer learning: pretrained torch ViT weights into the port (port of the
JAX package's ``transfer.py``).

Reference workflow (main notebook cells 110-125):
``torchvision.models.vit_b_16(weights=DEFAULT)`` -> freeze the backbone ->
replace ``heads`` with a fresh Linear -> fine-tune with the standard recipe.

* :func:`convert_torch_vit_state_dict` maps a torchvision-layout (or the
  reference repo's custom-layout) ``state_dict`` onto the Flax param tree
  the JAX package returns (numpy, the same names and layouts), with the
  position embedding grid-interpolated when the resolution changes.
* :func:`init_from_pretrained` builds the port's full ``state_dict`` from a
  pretrained backbone and a zero head (the "replace heads" step), through
  :func:`..convert.params_from_flax`, the one Flax-name -> port-name map.
* Freezing is :func:`..optim.make_optimizer` with
  ``trainable_label_fn=head_only_label_fn``: frozen params get no update
  and no Adam state.

Weights come from a ``.pth``/``.pt`` file (``torch.load``) or any mapping of
arrays; no torchvision is needed.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .configs import ViTConfig


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def load_torch_file(path: str | Path) -> Dict[str, np.ndarray]:
    """Read a torch ``state_dict`` file (or a pickled module's) into numpy."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: _np(v) for k, v in sd.items()}


# --- key normalization ----------------------------------------------------
# torchvision vit_b_16 layout and the reference repo's custom layout
# (models/vit.py module names) are both mapped onto canonical names:
#   patch.conv.weight/bias, cls, pos,
#   block{i}.ln1.w/b, block{i}.qkv.w/b, block{i}.out.w/b,
#   block{i}.ln2.w/b, block{i}.fc1.w/b, block{i}.fc2.w/b,
#   ln.w/b, head.w/b

_PATTERNS = [
    # torchvision
    (r"^conv_proj\.(weight|bias)$", r"patch.conv.\1"),
    (r"^class_token$", "cls"),
    (r"^encoder\.pos_embedding$", "pos"),
    (r"^encoder\.layers\.encoder_layer_(\d+)\.ln_1\.(weight|bias)$",
     r"block\1.ln1.\2"),
    (r"^encoder\.layers\.encoder_layer_(\d+)\.self_attention\."
     r"in_proj_(weight|bias)$", r"block\1.qkv.\2"),
    (r"^encoder\.layers\.encoder_layer_(\d+)\.self_attention\.out_proj\."
     r"(weight|bias)$", r"block\1.out.\2"),
    (r"^encoder\.layers\.encoder_layer_(\d+)\.ln_2\.(weight|bias)$",
     r"block\1.ln2.\2"),
    (r"^encoder\.layers\.encoder_layer_(\d+)\.mlp\.(?:0|linear_1)\."
     r"(weight|bias)$", r"block\1.fc1.\2"),
    (r"^encoder\.layers\.encoder_layer_(\d+)\.mlp\.(?:3|linear_2)\."
     r"(weight|bias)$", r"block\1.fc2.\2"),
    (r"^encoder\.ln\.(weight|bias)$", r"ln.\1"),
    (r"^heads\.(?:head\.)?(weight|bias)$", r"head.\1"),
    # reference repo custom ViT (models/vit.py module names)
    (r"^patch_embedding_block\.patcher\.0\.(weight|bias)$",
     r"patch.conv.\1"),
    (r"^patch_embedding_block\.class_token$", "cls"),
    (r"^patch_embedding_block\.position_embedding$", "pos"),
    (r"^transformer_encoder\.(\d+)\.msa_block\.layer_norm\.(weight|bias)$",
     r"block\1.ln1.\2"),
    (r"^transformer_encoder\.(\d+)\.msa_block\.multihead_attn\."
     r"in_proj_(weight|bias)$", r"block\1.qkv.\2"),
    (r"^transformer_encoder\.(\d+)\.msa_block\.multihead_attn\.out_proj\."
     r"(weight|bias)$", r"block\1.out.\2"),
    (r"^transformer_encoder\.(\d+)\.mlp_block\.layer_norm\.(weight|bias)$",
     r"block\1.ln2.\2"),
    (r"^transformer_encoder\.(\d+)\.mlp_block\.mlp\.0\.(weight|bias)$",
     r"block\1.fc1.\2"),
    (r"^transformer_encoder\.(\d+)\.mlp_block\.mlp\.3\.(weight|bias)$",
     r"block\1.fc2.\2"),
    (r"^layer_norm\.(weight|bias)$", r"ln.\1"),
    (r"^classifier\.(?:\d+\.)?(weight|bias)$", r"head.\1"),
]


def _canonicalize(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        for pat, repl in _PATTERNS:
            m = re.match(pat, key)
            if m:
                out[m.expand(repl)] = _np(val)
                break
    return out


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 on ``|x|`` (f32)."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The ``[in_size, out_size]`` f32 weights of one axis of
    ``jax.image.resize(..., "bicubic")`` (antialias on), the way
    ``jax._src.image.scale.compute_weight_mat`` builds them: half-pixel
    centres, the kernel widened by the scale when downsampling, each
    output's taps renormalised to sum to 1 (taps outside the grid simply
    absent), outputs whose centre falls outside the input zeroed.
    ``F.interpolate(mode="bicubic")`` (a = -0.75, border clamping) is a
    different function."""
    f32 = np.float32
    inv_scale = f32(1) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5))
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000) * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def interpolate_pos_embedding(pos: np.ndarray,
                              config: ViTConfig) -> np.ndarray:
    """Port a position embedding across input resolutions (paper §3.2).

    ``pos``: ``[1, T_src, D]``; a square ``T_src`` is grid-only, a square
    plus one carries a leading CLS slot. Returns ``[1, config.seq_len, D]``
    in ``pos``'s dtype: the patch grid resized bicubically as
    ``jax.image.resize`` does (:func:`cubic_resize_weights`, applied per
    axis in f32), the CLS slot kept, added as zeros or dropped per
    ``config.pool``."""
    pos = np.asarray(pos)
    _, t_src, d = pos.shape
    gs_src = int(round(t_src ** 0.5))
    if gs_src * gs_src == t_src:
        cls_pos, grid = None, pos[0]
    else:
        gs_src = int(round((t_src - 1) ** 0.5))
        if gs_src * gs_src != t_src - 1:
            raise ValueError(
                f"pos embedding length {t_src} is neither a square grid nor "
                "grid+CLS")
        cls_pos, grid = pos[:, :1], pos[0, 1:]

    gs_dst = config.image_size // config.patch_size
    if gs_dst * gs_dst != config.num_patches:  # non-square would be a bug
        raise AssertionError(config)
    if gs_dst != gs_src:
        w = torch.from_numpy(cubic_resize_weights(gs_src, gs_dst))
        g = torch.from_numpy(np.asarray(grid, np.float32)).reshape(
            gs_src, gs_src, d)
        grid = torch.einsum("hwd,hH,wW->HWd", g, w, w).reshape(
            -1, d).numpy()
    out = grid[None].astype(pos.dtype)
    if config.pool == "cls":
        if cls_pos is None:
            cls_pos = np.zeros((1, 1, d), pos.dtype)
        out = np.concatenate([cls_pos.astype(pos.dtype), out], axis=1)
    return out


def convert_torch_vit_state_dict(
    state_dict: Mapping[str, Any],
    config: ViTConfig,
    *,
    include_head: bool = False,
) -> Dict[str, Any]:
    """A torch ViT ``state_dict`` -> ``{"backbone": {...}}`` (plus ``"head"``
    with ``include_head``), the Flax-shaped numpy tree of the JAX package:

    * conv ``[D, C, P, P]`` -> NHWC kernel ``[P, P, C, D]``;
    * fused qkv ``[3D, D]`` (q|k|v rows, head-major within D) ->
      ``[D, 3, H, Dh]``; out-proj ``[D, D]`` -> ``[H, Dh, D]``;
    * linear ``[out, in]`` -> ``[in, out]``;
    * a gap-pool config gets no CLS token; the position embedding is
      interpolated (:func:`interpolate_pos_embedding`) when its length is
      not ``config.seq_len``.

    Raises ValueError on an unknown layout, a depth other than
    ``config.num_layers`` and (``include_head``) a head of another class
    count."""
    sd = _canonicalize(state_dict)
    if "patch.conv.weight" not in sd:
        raise ValueError(
            "unrecognized state_dict layout: no patch-projection key found "
            f"among {sorted(state_dict)[:5]}...")
    d, h = config.embedding_dim, config.num_heads
    dh = config.head_dim
    if sd["pos"].shape[1] != config.seq_len:
        sd["pos"] = interpolate_pos_embedding(sd["pos"], config)

    def lin(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T.copy(),
                "bias": sd[f"{prefix}.bias"]}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"],
                "bias": sd[f"{prefix}.bias"]}

    patch_embedding: Dict[str, Any] = {
        "patch_conv": {
            "kernel": sd["patch.conv.weight"].transpose(2, 3, 1, 0),
            "bias": sd["patch.conv.bias"],
        },
        "pos_embedding": sd["pos"],
    }
    if config.pool == "cls":  # gap-pool models have no CLS parameter
        patch_embedding["cls_token"] = sd["cls"]
    backbone: Dict[str, Any] = {
        "patch_embedding": patch_embedding,
        "encoder_norm": ln("ln"),
    }
    n_blocks = 0
    while f"block{n_blocks}.ln1.weight" in sd:
        n_blocks += 1
    if n_blocks != config.num_layers:
        raise ValueError(
            f"state_dict has {n_blocks} encoder blocks, config wants "
            f"{config.num_layers}")
    for i in range(n_blocks):
        qkv_w = sd[f"block{i}.qkv.weight"]          # [3D, D]
        qkv_b = sd[f"block{i}.qkv.bias"]            # [3D]
        out_w = sd[f"block{i}.out.weight"]          # [D, D]
        backbone[f"encoder_block_{i}"] = {
            "msa": {
                "norm": ln(f"block{i}.ln1"),
                "qkv": {
                    "kernel": qkv_w.T.reshape(d, 3, h, dh).copy(),
                    "bias": qkv_b.reshape(3, h, dh),
                },
                "out": {
                    "kernel": out_w.T.reshape(h, dh, d).copy(),
                    "bias": sd[f"block{i}.out.bias"],
                },
            },
            "mlp": {
                "norm": ln(f"block{i}.ln2"),
                "fc1": lin(f"block{i}.fc1"),
                "fc2": lin(f"block{i}.fc2"),
            },
        }
    if include_head:
        if "head.weight" not in sd:
            raise ValueError("state_dict has no classifier head")
        head = lin("head")
        if head["kernel"].shape[1] != config.num_classes:
            raise ValueError(
                f"source head has {head['kernel'].shape[1]} classes, config "
                f"wants {config.num_classes}")
        return {"backbone": backbone, "head": head}
    return {"backbone": backbone}


def init_from_pretrained(
    config: ViTConfig,
    pretrained: Mapping[str, Any] | str | Path,
) -> Dict[str, torch.Tensor]:
    """Pretrained backbone + zero head as the port's ``state_dict`` — the
    reference's "replace heads with Linear(768, num_classes)" step (main
    notebook cell 113; the JAX function's default ``head_init="zeros"``).
    ``pretrained`` is a torch state_dict mapping or a ``.pth`` path. Every
    backbone param comes from it as f32, the model's param dtype."""
    from .convert import params_from_flax
    from .models import create_model

    if isinstance(pretrained, (str, Path)):
        pretrained = load_torch_file(pretrained)
    state = params_from_flax(convert_torch_vit_state_dict(pretrained, config))
    with torch.device("meta"):
        want = create_model(config).state_dict()
    backbone = {k for k in want if k.startswith("backbone.")}
    if set(state) != backbone:
        raise ValueError(f"converted backbone names differ from the model's: "
                         f"{sorted(set(state) ^ backbone)[:5]}")
    for name, ref in want.items():
        if name not in state:
            state[name] = torch.zeros(ref.shape, dtype=ref.dtype)
        elif state[name].shape != ref.shape:
            raise ValueError(f"{name}: pretrained {tuple(state[name].shape)} "
                             f"vs model {tuple(ref.shape)}")
    return state
