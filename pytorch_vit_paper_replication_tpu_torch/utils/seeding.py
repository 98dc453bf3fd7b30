"""Seeding — equivalent of helper_functions ``set_seeds`` (reference main
notebook cells 46/58/125 call it before each training run).

Seeds Python's, numpy's and torch's global generators and returns an
explicit ``torch.Generator`` for callers that thread their randomness
through arguments (the port's dropout draws from per-step generators,
:func:`..engine.step_generator`).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seeds(seed: int = 42) -> torch.Generator:
    """Seed Python/NumPy/torch RNGs and return a seeded CPU generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
