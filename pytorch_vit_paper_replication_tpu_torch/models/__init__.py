"""Model library of the port."""

from .tinyvgg import TinyVGG
from .vit import (MLPBlock, MultiHeadSelfAttentionBlock, PatchEmbedding,
                  TransformerEncoderBlock, ViT, ViTFeatureExtractor,
                  create_model)

__all__ = ["MLPBlock", "MultiHeadSelfAttentionBlock", "PatchEmbedding",
           "TinyVGG", "TransformerEncoderBlock", "ViT", "ViTFeatureExtractor",
           "create_model"]
