"""Model inspection — the torchinfo ``summary`` counts.

The reference leans on ``torchinfo.summary`` for param counts (main
notebook cells 71/80/114); here the same numbers come from a
``state_dict`` (or any mapping of name -> tensor).
"""

from __future__ import annotations

from typing import Mapping

import torch


def count_params(params: Mapping[str, torch.Tensor]) -> int:
    """Total parameter count (reference parity value for ViT-B/16 3-class:
    85,800,963 — main notebook cell 80)."""
    return sum(int(p.numel()) for p in params.values())


def param_bytes(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(p.numel()) * p.element_size() for p in params.values())


def format_size(params: Mapping[str, torch.Tensor]) -> str:
    n = count_params(params)
    mb = param_bytes(params) / 1e6
    return f"{n:,} params ({mb:.1f} MB)"
