"""Weight carry-over between the JAX package's Flax params and the port.

The port's modules keep the Flax names and layouts (``models/vit.py``), so
a Flax param tree ``{"backbone": {"encoder_block_0": {"msa": {"qkv":
{"kernel": ...}}}}, "head": ...}`` maps to the port's ``state_dict`` by
joining the path with dots. The port's on-disk export is ``params.npz``
whose keys are the ``/``-joined Flax paths — the same names either way.

Reading an Orbax checkpoint needs JAX and tensorstore; converting a JAX
``save_model`` export to ``params.npz`` is a later slice (ROADMAP).
:func:`rank_local_params` takes a tree (standard or pipeline-stacked) to
one rank's slices on a parallel mesh.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .configs import ViTConfig


def flatten_tree(tree: Mapping[str, Any], prefix: str = "",
                 sep: str = "/") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> ``{"a/b/c": ndarray}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_tree(val, path, sep))
        else:
            flat[path] = np.asarray(val)
    return flat


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax param tree (nested dicts of numpy-convertible arrays, keys as
    in ``ViT.init(...)["params"]``) -> the port's ``state_dict``."""
    return {path.replace("/", "."): torch.from_numpy(
                np.array(arr, dtype=np.float32))
            for path, arr in flatten_tree(tree).items()}


def params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: a ``state_dict`` -> a nested
    Flax param tree of f32 numpy arrays, so the JAX package can read
    weights the port trained."""
    tree: Dict[str, Any] = {}
    for name, val in state.items():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = val.detach().to("cpu", torch.float32).numpy()
    return tree


def save_params_npz(path: str | Path, state: Mapping[str, torch.Tensor]
                    ) -> Path:
    """Write ``state`` as ``params.npz`` with ``/``-joined Flax keys
    (temp file + atomic rename)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **{k.replace(".", "/"): v.detach().cpu().numpy()
                     for k, v in state.items()})
    tmp.replace(path)
    return path


def load_params_npz(path: str | Path) -> Dict[str, torch.Tensor]:
    """``params.npz`` -> the port's ``state_dict`` (f32 CPU tensors)."""
    with np.load(path) as z:
        return {k.replace("/", "."): torch.from_numpy(
                    np.ascontiguousarray(z[k], dtype=np.float32))
                for k in z.files}


def seeded_params(cfg: ViTConfig, seed: int, *,
                  with_head: bool = True) -> Dict[str, torch.Tensor]:
    """Random weights for ``cfg`` made from ``seed`` with numpy, as a
    ``state_dict``: LeCun-normal kernels (fan-in over the input axes),
    zero biases, unit LayerNorm scales, zero CLS token and a 0.02-normal
    position embedding — the JAX package's initializer families."""
    from .models import create_model

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  create_model(cfg, with_head=with_head).state_dict().items()}
    rng = np.random.default_rng(seed)
    state = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(_kernel_in_shape(name, shape)))
            arr = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(fan_in ** -0.5)
        elif leaf == "scale":
            arr = np.ones(shape, np.float32)
        elif leaf == "pos_embedding":
            arr = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(0.02)
        else:   # biases, cls_token
            arr = np.zeros(shape, np.float32)
        state[name] = torch.from_numpy(arr)
    return state


def _kernel_in_shape(name: str, shape):
    """The input axes of a kernel: two for the attention out projection
    ``[H, Dh, D]``, three for the patch conv ``[P, P, C, D]``, else one."""
    if name.endswith("msa.out.kernel"):
        return shape[:2]
    if name.endswith("patch_conv.kernel"):
        return shape[:3]
    return shape[:1]


def rank_local_params(tree: Mapping[str, Any],
                      mesh) -> Dict[str, torch.Tensor]:
    """One rank's parameters on a dp x tp x pp ``mesh``: ``tree`` is a JAX
    param tree in the standard or the pipeline-stacked layout
    (``encoder_blocks`` with a leading ``[L]`` axis), or a full port
    ``state_dict``; returns this rank's slices
    (:func:`.parallel.sharding.shard_state_dict`), f32 CPU tensors."""
    from .parallel.pipeline import unstack_block_params
    from .parallel.sharding import shard_state_dict

    return shard_state_dict(unstack_block_params(params_from_flax(tree)),
                            mesh)
