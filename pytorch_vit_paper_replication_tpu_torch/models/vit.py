"""Vision Transformer as PyTorch modules (the port of the JAX ``models/vit.py``).

The module tree and every parameter keep the JAX package's Flax names and
layouts, so a Flax param tree converts by flattening its paths
(:func:`..convert.params_from_flax`) and the two packages compute the
same function on the same weights:

* images are **NHWC**; patchify is the unfold ``(b, n, p, n, p, c) ->
  (0, 1, 3, 2, 4, 5)`` followed by one matmul with the conv-layout
  kernel ``[P, P, C, D]``;
* dense kernels are ``[in, out]``; the fused QKV kernel is head-major
  ``[D, 3, H, Dh]`` and the attention out kernel ``[H, Dh, D]``;
* LayerNorm statistics are f32 (Flax's ``E[x^2] - E[x]^2`` form) and its
  output is in the compute dtype; dense layers cast inputs and params to
  the compute dtype; the classifier head runs in f32;
* params are f32; activations run in ``config.dtype``.

``mlp_impl="auto"`` picks the fused CUDA kernel on a CUDA tensor and the
two-GEMM path on the CPU; ``attention_impl`` dispatches through
:func:`..ops.attention.dot_product_attention`.

Training (``model.train()``): the caller passes ``rng``, a
``torch.Generator`` (the engine seeds one from ``(TrainConfig.seed,
step)``, the counterpart of JAX's ``fold_in(state.rng, step)``). The
backbone draws one int32 seed for the embedding dropout and two per
encoder block (attention, MLP) from it *before* running the blocks, and
passes each seed into its block: the fused MLP kernel and the flash kernel
take it as their positional-hash seed; the plain-torch dropout sites seed a
generator of their own with it. Remat (``config.remat``) checkpoints each
block with ``torch.utils.checkpoint(use_reentrant=False)``; since the
seeds are drawn outside the checkpointed call, the recomputation sees the
same masks.

Tensor parallelism: the blocks take ``tp``, a ``torch.distributed``
process group (the JAX ``tp_axis``), and then run Megatron's split over it
(:mod:`..parallel.collectives`); :mod:`..parallel.pipeline` builds them
from a head-local config.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..configs import ViTConfig
from ..ops.attention import dot_product_attention
from ..ops.dropout import Dropout
from ..parallel.collectives import copy_to_tp, reduce_from_tp

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(cfg: ViTConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None stays None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _param(*shape, fill: float = 0.0) -> nn.Parameter:
    """An f32 parameter; real values arrive through ``load_state_dict``
    (converted Flax params or :func:`..convert.seeded_params`)."""
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=...)`` numerics: f32 statistics with
    ``var = max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in f32, cast to the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = _param(dim, fill=1.0)
        self.bias = _param(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mu) * mul + self.bias).to(self.dtype)


class Dense(nn.Module):
    """``flax.linen.Dense``/``DenseGeneral`` over the trailing input axes:
    ``kernel [*in_shape, *out_shape]``, ``bias [*out_shape]``; inputs and
    params cast to the compute dtype, bias added in that dtype."""

    def __init__(self, in_shape, out_shape, dtype: torch.dtype):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.kernel = _param(*self.in_shape, *self.out_shape)
        self.bias = _param(*self.out_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmul(x) + self.bias.to(self.dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """The product without the bias, ``[*lead, *out_shape]``."""
        lead = x.shape[:x.ndim - len(self.in_shape)]
        k_in = self.kernel.shape[:len(self.in_shape)].numel()
        y = x.to(self.dtype).reshape(*lead, k_in) @ \
            self.kernel.to(self.dtype).reshape(k_in, -1)
        return y.reshape(*lead, *self.out_shape)


class _PatchConv(nn.Module):
    """Patch projection with a conv-layout kernel ``[P, P, C, D]``,
    computed as unfold + one ``[B*N, P*P*C] @ [P*P*C, D]`` matmul."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p, c, d = cfg.patch_size, cfg.color_channels, cfg.embedding_dim
        self.patch = p
        self.kernel = _param(p, p, c, d)
        self.bias = _param(d)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = images.shape
        n = h // p
        x = images.reshape(b, n, p, n, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, n * n, p * p * c)
        x = x @ self.kernel.reshape(p * p * c, -1).to(x.dtype)
        return x + self.bias.to(x.dtype)


class PatchEmbedding(nn.Module):
    """Patchify + embed + CLS + learned position embedding."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.config = cfg
        self.patch_conv = _PatchConv(cfg)
        if cfg.pool == "cls":
            self.cls_token = _param(1, 1, cfg.embedding_dim)
        self.pos_embedding = _param(1, cfg.seq_len, cfg.embedding_dim)
        self.dropout = Dropout(cfg.embedding_dropout)

    def forward(self, images: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        b, h, w, _ = images.shape
        if h != cfg.image_size or w != cfg.image_size:
            raise ValueError(
                f"expected {cfg.image_size}x{cfg.image_size} images, got "
                f"{h}x{w}")
        x = self.patch_conv(images.to(_dtype(cfg)))
        if cfg.pool == "cls":
            cls = self.cls_token.to(x.dtype).expand(b, 1, cfg.embedding_dim)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        return self.dropout(x, _generator(seed, x.device))


class MultiHeadSelfAttentionBlock(nn.Module):
    """Pre-norm multi-head self-attention; returns the attention output
    only (the residual add lives in :class:`TransformerEncoderBlock`).

    ``tp``: Megatron tensor parallelism over a process group (the JAX
    ``tp_axis``). The block is then built from a head-local config (the
    rank's ``num_heads / tp`` heads, ``head_dim_override`` set), computes
    its local heads, all-reduces the out projection's partial sum and adds
    the replicated out bias once, after the all-reduce."""

    def __init__(self, cfg: ViTConfig, tp=None):
        super().__init__()
        self.config = cfg
        self.tp = tp
        dt = _dtype(cfg)
        self.norm = LayerNorm(cfg.embedding_dim, cfg.ln_epsilon, dt)
        self.qkv = Dense((cfg.embedding_dim,),
                         (3, cfg.num_heads, cfg.head_dim), dt)
        self.out = Dense((cfg.num_heads, cfg.head_dim),
                         (cfg.embedding_dim,), dt)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        y = self.norm(x)
        if self.tp is not None:
            y = copy_to_tp(y, self.tp)
        qkv = self.qkv(y)                         # [B, T, 3, H, Dh]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = dot_product_attention(
            q, k, v, impl=cfg.attention_impl, dropout_rate=cfg.attn_dropout,
            seed=seed, deterministic=not self.training,
            heads_already_local=self.tp is not None,
            softmax=cfg.attention_softmax,
            probs_dtype=cfg.attention_probs_dtype,
            residual_dtype=cfg.attention_probs_residual_dtype)
        if self.tp is None:
            return self.out(attn)
        return (reduce_from_tp(self.out.matmul(attn), self.tp)
                + self.out.bias.to(_dtype(cfg)))


def _mlp_fused(cfg: ViTConfig, x: torch.Tensor) -> bool:
    """Whether ``config.mlp_impl`` selects the fused kernel for ``x``."""
    return cfg.mlp_impl == "fused" or (cfg.mlp_impl == "auto" and x.is_cuda)


class MLPBlock(nn.Module):
    """Pre-norm MLP: LN -> fc1 -> GELU -> Dropout -> fc2 -> Dropout.

    ``mlp_impl`` fused (``"fused"``, or ``"auto"`` on a CUDA tensor) runs
    the CUDA kernels: the whole half-block kernel
    (:func:`..ops.fused_mlp.fused_ln_mlp_residual`) when the block owns the
    residual (``include_residual``) and is not tensor-parallel; otherwise
    LN, then the MLP core kernel (:func:`..ops.fused_mlp.fused_mlp`), then
    the output dropout (and the residual). Both paths declare identical
    params (``norm``, ``fc1``, ``fc2``).

    ``tp``: Megatron tensor parallelism over a process group (the JAX
    ``tp_axis``): fc1/fc2 arrive hidden-sliced, the block runs ``LN ->
    copy_to_tp -> core on the local hidden slice -> all-reduce -> + fc2
    bias -> Dropout -> + x``. The all-reduce comes before the output
    dropout, so every rank drops the same elements of the same replicated
    tensor; the hidden dropout keys on the local hidden column, so every
    hidden slice reuses the same column keys, as the JAX package does.
    """

    def __init__(self, cfg: ViTConfig, include_residual: bool = False,
                 tp=None):
        super().__init__()
        self.config = cfg
        self.include_residual = include_residual
        self.tp = tp
        dt = _dtype(cfg)
        self.norm = LayerNorm(cfg.embedding_dim, cfg.ln_epsilon, dt)
        self.fc1 = Dense((cfg.embedding_dim,), (cfg.mlp_size,), dt)
        self.fc2 = Dense((cfg.mlp_size,), (cfg.embedding_dim,), dt)
        self.dropout = Dropout(cfg.mlp_dropout)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        dt = _dtype(cfg)
        fused = _mlp_fused(cfg, x)
        if fused and self.include_residual and self.tp is None:
            from ..ops.fused_mlp import fused_ln_mlp_residual
            return fused_ln_mlp_residual(
                x, self.norm.scale, self.norm.bias,
                self.fc1.kernel.to(dt), self.fc1.bias.to(dt),
                self.fc2.kernel.to(dt), self.fc2.bias.to(dt),
                eps=cfg.ln_epsilon, dropout_rate=cfg.mlp_dropout, seed=seed,
                deterministic=not self.training)
        gen = _generator(seed, x.device)
        y = self.norm(x)
        if self.tp is not None:
            y = copy_to_tp(y, self.tp)
        # Under TP the fc2 bias is added once, after the all-reduce.
        if fused:
            from ..ops.fused_mlp import fused_mlp
            b2 = self.fc2.bias.to(dt)
            y = fused_mlp(y, self.fc1.kernel.to(dt), self.fc1.bias.to(dt),
                          self.fc2.kernel.to(dt),
                          b2 if self.tp is None else torch.zeros_like(b2),
                          dropout_rate=cfg.mlp_dropout, seed=seed,
                          deterministic=not self.training)
        else:
            y = self.dropout(F.gelu(self.fc1(y)), gen)
            y = self.fc2(y) if self.tp is None else self.fc2.matmul(y)
        if self.tp is not None:
            y = reduce_from_tp(y, self.tp) + self.fc2.bias.to(dt)
        y = self.dropout(y, gen)
        return y + x if self.include_residual else y


class TransformerEncoderBlock(nn.Module):
    """Pre-norm residual encoder block: ``x = msa(x) + x; x = mlp(x) + x``
    (the MLP half's residual is owned by :class:`MLPBlock`). ``tp``: the
    tensor-parallel process group of both halves (head-local config)."""

    def __init__(self, cfg: ViTConfig, tp=None):
        super().__init__()
        self.msa = MultiHeadSelfAttentionBlock(cfg, tp=tp)
        self.mlp = MLPBlock(cfg, include_residual=True, tp=tp)

    def forward(self, x: torch.Tensor,
                seeds: Sequence[Optional[int]] = (None, None)
                ) -> torch.Tensor:
        """``seeds``: ``(attention seed, MLP seed)`` in training."""
        attn_seed, mlp_seed = seeds
        return self.mlp(self.msa(x, attn_seed) + x, mlp_seed)


class ViTFeatureExtractor(nn.Module):
    """ViT backbone with no classifier: the final-LN token sequence."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.config = cfg
        self.patch_embedding = PatchEmbedding(cfg)
        for i in range(cfg.num_layers):
            setattr(self, f"encoder_block_{i}", TransformerEncoderBlock(cfg))
        self.encoder_norm = LayerNorm(cfg.embedding_dim, cfg.ln_epsilon,
                                      _dtype(cfg))

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``rng`` (training only): the generator the per-step dropout
        seeds are drawn from; required when a dropout rate is active."""
        cfg = self.config
        seeds = [None] * (1 + 2 * cfg.num_layers)
        if self.training and rng is not None:
            seeds = torch.randint(-2**31, 2**31, (len(seeds),),
                                  generator=rng).tolist()
        elif self.training and max(cfg.embedding_dropout, cfg.mlp_dropout,
                                   cfg.attn_dropout) > 0.0:
            raise ValueError("training with dropout needs an rng "
                             "(torch.Generator)")
        x = self.patch_embedding(images, seeds[0])
        remat = cfg.remat and self.training and torch.is_grad_enabled()
        for i in range(cfg.num_layers):
            block = getattr(self, f"encoder_block_{i}")
            block_seeds = seeds[1 + 2 * i:3 + 2 * i]
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    block, x, block_seeds, use_reentrant=False)
            else:
                x = block(x, block_seeds)
        return self.encoder_norm(x)


def pool_tokens(cfg: ViTConfig, tokens: torch.Tensor) -> torch.Tensor:
    """``cls`` token or global average pool over ``[B, T, D]`` tokens."""
    return tokens[:, 0] if cfg.pool == "cls" else tokens.mean(dim=1)


class ViT(nn.Module):
    """ViT classifier: backbone + f32 linear head on the pooled token.
    Params nest as ``backbone.*`` and ``head.*`` like the Flax tree."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.config = cfg
        self.backbone = ViTFeatureExtractor(cfg)
        self.head = Dense((cfg.embedding_dim,), (cfg.num_classes,),
                          torch.float32)

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens = self.backbone(images, rng)
        return self.head(pool_tokens(self.config, tokens).float())


def create_model(config: ViTConfig, *, with_head: bool = True) -> nn.Module:
    """Factory matching the JAX package's: classifier or backbone."""
    return ViT(config) if with_head else ViTFeatureExtractor(config)
