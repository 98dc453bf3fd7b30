"""Model configuration for the PyTorch/CUDA port.

A field-for-field copy of the JAX package's ``ViTConfig`` (same names,
defaults and validation), so a config fingerprint, a ``model_meta.json``
or a preset name means the same model in both packages. The knobs that
name JAX/TPU execution paths keep their spelling: ``attention_impl``
``"flash"`` selects the hand-written CUDA flash kernel here, and
``mlp_impl`` ``"fused"`` the CUDA LN->MLP->residual kernel.

Presets follow Table 1 of the ViT paper (arXiv:2010.11929), which the reference
cites in its main notebook (cell 21).
"""

from __future__ import annotations

import dataclasses

from .ops.quant import PROBS_DTYPES


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters for a Vision Transformer classifier.

    Mirrors the constructor surface of the reference ``ViT``
    (``models/vit.py:172-199``): image/patch geometry, depth, heads, widths,
    and the three dropout rates. Adds execution knobs (compute dtype,
    attention and MLP implementation, remat) that have no reference
    counterpart.
    """

    image_size: int = 224
    patch_size: int = 16
    color_channels: int = 3
    num_layers: int = 12
    num_heads: int = 12
    embedding_dim: int = 768
    mlp_size: int = 3072
    num_classes: int = 1000
    attn_dropout: float = 0.0
    mlp_dropout: float = 0.1
    embedding_dropout: float = 0.1
    # LayerNorm epsilon. 1e-6 is the ViT/torchvision convention; set 1e-5
    # when porting weights from models built on torch.nn.LayerNorm defaults
    # (like the reference's custom ViT) — the mismatch is visible on
    # low-variance rows (e.g. the CLS token early in training).
    ln_epsilon: float = 1e-6
    # --- execution knobs (no reference counterpart) ---
    # Compute dtype for activations; params are kept in float32.
    dtype: str = "bfloat16"
    # "xla" = the materialized-logits attention (ops/attention.py
    # _xla_attention, plain torch); "flash" = the CUDA flash-attention
    # kernel (ops/flash_attention.py); "auto" = flash on a CUDA tensor at
    # T >= 197 with a head dim the kernels are built for (_flash_ok).
    attention_impl: str = "auto"
    # MLP-half execution path: "xla" = LayerNorm + two GEMMs with the
    # hidden activation materialized; "fused" = the CUDA
    # LN->fc1->GELU->dropout->fc2->dropout->residual kernel, or LN and the
    # CUDA MLP core kernel in tensor-parallel blocks and the standalone
    # MLPBlock (ops/fused_mlp.py); "auto" =
    # fused on a CUDA tensor, xla on the CPU. Param trees are identical
    # across paths.
    mlp_impl: str = "auto"
    # XLA-path softmax flavor: "saturating" (default) = exp(min(s - 16,
    # 80)) / (sum + 1e-35), no row-max pass, exact for logits <= ~96;
    # "exact" = the classic max-subtracted softmax. The flash path always
    # carries its own exact online softmax.
    attention_softmax: str = "saturating"
    # Storage format of the XLA path's softmax weights (ops/quant.py):
    # "bf16" = the compute dtype, or an 8-bit format ("fp8_e4m3",
    # "fp8_e5m2", "u8") through ops.attention._QuantizedSoftmaxPV.
    attention_probs_dtype: str = "bf16"
    # Storage format of the attention backward residual (None = follow
    # attention_probs_dtype).
    attention_probs_residual_dtype: str | None = None
    # Rematerialize encoder blocks in training (torch.utils.checkpoint per
    # block; the dropout seeds are drawn outside the checkpointed call).
    remat: bool = False
    # Pool strategy for classification: "cls" token (reference vit.py:235)
    # or "gap" (global average pool, used by some ViT variants).
    pool: str = "cls"
    # Explicit per-head dim. None derives embedding_dim // num_heads
    # (the JAX package's pipeline parallelism sets it; kept for parity).
    head_dim_override: int | None = None

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            # Reference asserts the same invariant at models/vit.py:25.
            raise ValueError(
                f"image_size ({self.image_size}) must be divisible by "
                f"patch_size ({self.patch_size})"
            )
        if self.embedding_dim % self.num_heads != 0:
            raise ValueError(
                f"embedding_dim ({self.embedding_dim}) must be divisible by "
                f"num_heads ({self.num_heads})"
            )
        if self.pool not in ("cls", "gap"):
            raise ValueError(f"pool must be 'cls' or 'gap', got {self.pool!r}")
        if self.attention_impl not in ("xla", "flash", "auto"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.mlp_impl not in ("xla", "fused", "auto"):
            raise ValueError(f"unknown mlp_impl {self.mlp_impl!r}")
        if self.attention_softmax not in ("saturating", "exact"):
            raise ValueError(
                f"unknown attention_softmax {self.attention_softmax!r}")
        if self.attention_probs_dtype not in PROBS_DTYPES:
            raise ValueError(
                f"unknown attention_probs_dtype "
                f"{self.attention_probs_dtype!r}; expected one of "
                f"{PROBS_DTYPES}")
        if (self.attention_probs_residual_dtype is not None
                and self.attention_probs_residual_dtype not in PROBS_DTYPES):
            raise ValueError(
                f"unknown attention_probs_residual_dtype "
                f"{self.attention_probs_residual_dtype!r}; expected one of "
                f"{PROBS_DTYPES} (or None to follow attention_probs_dtype)")

    @property
    def num_patches(self) -> int:
        # Reference computes the same at models/vit.py:26.
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        """Token count including the CLS token (197 for 224/16)."""
        return self.num_patches + (1 if self.pool == "cls" else 0)

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.embedding_dim // self.num_heads

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


# --- Table 1 presets (ViT paper) ------------------------------------------
# The reference only builds ViT-Base/16 (its defaults, models/vit.py:173-183);
# Large and Huge are listed in its notebook cell 21 and are BASELINE.json
# stretch configs.

def vit_ti16(**kw) -> ViTConfig:
    """ViT-Tiny/16 (DeiT-Ti) — handy for tests and laptops."""
    return ViTConfig(num_layers=12, num_heads=3, embedding_dim=192,
                     mlp_size=768, **kw)


def vit_s16(**kw) -> ViTConfig:
    """ViT-Small/16 (DeiT-S)."""
    return ViTConfig(num_layers=12, num_heads=6, embedding_dim=384,
                     mlp_size=1536, **kw)


def vit_b16(**kw) -> ViTConfig:
    """ViT-Base/16 — the reference's default architecture."""
    return ViTConfig(**kw)


def vit_l16(**kw) -> ViTConfig:
    """ViT-Large/16."""
    return ViTConfig(num_layers=24, num_heads=16, embedding_dim=1024,
                     mlp_size=4096, **kw)


def vit_h14(**kw) -> ViTConfig:
    """ViT-Huge/14 — the pjit model-parallel stretch config."""
    kw.setdefault("patch_size", 14)
    return ViTConfig(num_layers=32, num_heads=16, embedding_dim=1280,
                     mlp_size=5120, **kw)


PRESETS = {
    "ViT-Ti/16": vit_ti16,
    "ViT-S/16": vit_s16,
    "ViT-B/16": vit_b16,
    "ViT-L/16": vit_l16,
    "ViT-H/14": vit_h14,
}

# The fields that make two configs the same *servable architecture*
# (same param-tree shapes at a given head size). num_classes /
# image_size / dtype / kernel-impl knobs legitimately vary per
# deployment and are NOT identity.
ARCH_FIELDS = ("patch_size", "num_layers", "num_heads",
               "embedding_dim", "mlp_size", "pool")


def arch_of(cfg: "ViTConfig") -> dict:
    """The architecture-identity slice of a config — what the
    checkpoint meta records and the tier-mismatch refusal compares."""
    return {f: getattr(cfg, f) for f in ARCH_FIELDS}


def model_tier(cfg: "ViTConfig") -> str:
    """Human-meaningful tier label for a config: the ``PRESETS`` key
    whose architecture matches (``"ViT-Ti/16"`` …), else a synthesized
    ``custom/<dim>x<layers>p<patch>`` spelling. This is the label a
    serve replica reports in ``::stats`` (``model_tier``,
    informational) and the checkpoint's ``model_meta.json`` records
    for the load-time tier-mismatch refusal. The fleet's ``model=``
    routing filter deliberately does NOT key on it — routing keys on
    the deployment spec's declared model name (operator config), this
    label just tells a human which architecture that name maps to."""
    want = arch_of(cfg)
    for name, factory in PRESETS.items():
        if arch_of(factory(num_classes=cfg.num_classes,
                           image_size=cfg.image_size,
                           patch_size=cfg.patch_size)) == want:
            return name
    return (f"custom/{cfg.embedding_dim}x{cfg.num_layers}"
            f"p{cfg.patch_size}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-recipe hyperparameters (field for field the JAX package's).

    Defaults reproduce the reference recipe: Adam(1e-3, 0.9, 0.999) with
    weight decay 0.03 applied only to ndim>1 params (reference main notebook
    cells 84-85), linear warmup over 5% of steps then linear decay to 0
    (cells 87-88), global-norm-1 gradient clipping (engine.py:63), batch 32,
    10 epochs.
    """

    batch_size: int = 32
    epochs: int = 10
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.03
    warmup_fraction: float = 0.05
    grad_clip_norm: float = 1.0
    label_smoothing: float = 0.0
    seed: int = 42
    # Freeze everything except the classifier head (transfer learning;
    # reference main notebook cell 112 sets requires_grad=False on backbone).
    freeze_backbone: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh layout for distributed training (the JAX package's
    ``MeshConfig``, same fields and rules).

    Axes: ``data`` (batch sharded, gradients all-reduced), ``model``
    (tensor parallelism over attention heads and the MLP hidden width),
    ``seq`` (sequence parallelism: ring or Ulysses attention over the
    token axis; needs ``pipe`` = 1),
    ``pipe`` (pipeline parallelism, encoder layers staged with GPipe
    microbatching). A dimension of 1 disables that axis; ``data = -1``
    takes all remaining processes.
    """

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1

    def axis_sizes(self, n_devices: int) -> tuple:
        """``(data, model, seq, pipe)`` for ``n_devices`` processes."""
        model = max(1, self.model)
        seq = max(1, self.seq)
        pipe = max(1, self.pipe)
        data = self.data
        rest = model * seq * pipe
        if data == -1:
            if n_devices % rest != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by model*seq*pipe="
                    f"{rest}")
            data = n_devices // rest
        if data * rest != n_devices:
            raise ValueError(
                f"mesh {data}x{model}x{seq}x{pipe} != {n_devices} devices")
        return data, model, seq, pipe
