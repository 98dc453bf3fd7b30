"""Model library of the port."""

from .vit import (MLPBlock, MultiHeadSelfAttentionBlock, PatchEmbedding,
                  TransformerEncoderBlock, ViT, ViTFeatureExtractor,
                  create_model)

__all__ = ["MLPBlock", "MultiHeadSelfAttentionBlock", "PatchEmbedding",
           "TransformerEncoderBlock", "ViT", "ViTFeatureExtractor",
           "create_model"]
