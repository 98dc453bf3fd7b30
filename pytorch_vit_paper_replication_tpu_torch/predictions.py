"""Single-image inference and the port's inference-export contract.

Port of the JAX package's ``predictions.py``: open an image, apply the
eval transform recorded with the checkpoint, run a batch-of-1 forward,
softmax, argmax. :func:`predict_image` and the serve engine's ``probs``
head run the same ops on the same device (:func:`forward_probs`), so a
served ``::probs`` row equals ``predict_image`` bit for bit.

The port's export is a directory holding ``params.npz`` (``/``-joined
Flax param paths, :mod:`.convert`), ``transform.json`` and
``model_meta.json``; :func:`save_inference_export` writes one and
:func:`load_inference_checkpoint` reads it back. A training
``--checkpoint-dir`` resolves to its ``final`` export, as in the JAX
package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from .data.transforms import Transform, eval_transform
from .utils.digest import resolve_export_dir

PARAMS_FILE = "params.npz"
MODEL_META = "model_meta.json"
TRANSFORM_FILE = "transform.json"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for and absent — there is
    no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port's entry points run on "
            "cuda unless the caller passes device='cpu'")
    return dev


def forward_probs(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``softmax(model(x).float())`` — the ``probs`` expression shared by
    :func:`predict_image` and the serve engine."""
    return torch.softmax(model(x).float(), dim=-1)


def image_row(image, transform: Transform) -> np.ndarray:
    """One NHWC input row: a path or PIL image through ``transform``; an
    already-transformed array as float32."""
    if isinstance(image, (str, Path)):
        with Image.open(image) as img:
            return np.asarray(transform(img))
    if isinstance(image, Image.Image):
        return np.asarray(transform(image))
    return np.asarray(image, np.float32)


def predict_image(
    model: torch.nn.Module,
    image,
    class_names: Optional[Sequence[str]] = None,
    transform: Optional[Transform] = None,
    image_size: int = 224,
) -> Tuple[str | int, float, np.ndarray]:
    """Classify one image on the model's device; returns (predicted
    label, probability, probs). ``image`` may be a path, a PIL image, or
    an already-transformed NHWC array."""
    if transform is None:
        transform = eval_transform(image_size)
    arr = image_row(image, transform)
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))[None]
    with torch.inference_mode():
        device = next(model.parameters()).device
        probs = forward_probs(model, x.to(device))[0]
    probs = probs.cpu().numpy()
    idx = int(probs.argmax())
    label = class_names[idx] if class_names is not None else idx
    return label, float(probs[idx]), probs


def load_class_names(path: str | Path) -> List[str]:
    """Read class names from a file, one label per line (blank lines and
    ``#`` comments skipped) — the ``--classes-file`` format."""
    names = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            names.append(line)
    if not names:
        raise ValueError(f"no class names in {path}")
    return names


def write_model_meta(checkpoint_dir: str | Path, cfg, *,
                     extra: Optional[dict] = None) -> Path:
    """Record the export's model identity (``model_meta.json``): the tier
    label, the architecture-identity slice, and the config fingerprint."""
    from .compile_cache import config_fingerprint
    from .configs import arch_of, model_tier
    from .utils.atomic import atomic_write_json

    meta = {
        "model_tier": model_tier(cfg),
        "arch": arch_of(cfg),
        "num_classes": int(cfg.num_classes),
        "config_fingerprint": config_fingerprint(cfg),
    }
    if extra:
        meta.update(extra)
    return atomic_write_json(Path(checkpoint_dir) / MODEL_META, meta)


def load_model_meta(checkpoint: str | Path) -> Optional[dict]:
    """The recorded ``model_meta.json`` (next to the export, or its
    parent run dir), or None when none was recorded."""
    ckpt = resolve_export_dir(checkpoint)
    for d in (ckpt, ckpt.parent):
        meta_file = d / MODEL_META
        if meta_file.is_file():
            meta = json.loads(meta_file.read_text())
            if isinstance(meta, dict):
                return meta
    return None


def check_model_meta(checkpoint: str | Path, preset: str, cfg) -> None:
    """Refuse a checkpoint whose recorded architecture does not match
    the requested preset's — loudly, naming the tier that WOULD load."""
    from .configs import arch_of

    meta = load_model_meta(checkpoint)
    if not meta or not isinstance(meta.get("arch"), dict):
        return
    if meta["arch"] == arch_of(cfg):
        return
    recorded = meta.get("model_tier", "<unrecorded tier>")
    diffs = ", ".join(
        f"{k}={meta['arch'].get(k)}!={v}"
        for k, v in arch_of(cfg).items() if meta["arch"].get(k) != v)
    raise ValueError(
        f"checkpoint {checkpoint} was exported from a {recorded} model "
        f"but is being restored as preset {preset!r} ({diffs}) — the "
        "params tree cannot fit this architecture. Pass --preset "
        f"{recorded} (or point at a {preset} checkpoint).")


def resolve_transform_spec(checkpoint: str | Path, *,
                           image_size: Optional[int] = None,
                           normalize: Optional[bool] = None) -> dict:
    """The checkpoint's preprocessing identity without loading params:
    the recorded ``transform.json`` (next to the export, or its parent
    run dir) over the reference predict defaults (224px, normalize on),
    explicit overrides last."""
    ckpt = resolve_export_dir(checkpoint)
    spec = dict(image_size=224, pretrained=False, normalize=True)
    for d in (ckpt, ckpt.parent):
        tf_file = d / TRANSFORM_FILE
        if tf_file.is_file():
            spec.update(json.loads(tf_file.read_text()))
            break
    if image_size is not None:
        spec["image_size"] = int(image_size)
    if normalize is not None:
        spec["normalize"] = bool(normalize)
    return spec


def save_inference_export(directory: str | Path, model: torch.nn.Module, *,
                          transform_spec: Optional[dict] = None) -> Path:
    """Write the port's export of ``model`` (a :class:`..models.ViT`):
    ``params.npz``, ``model_meta.json`` and ``transform.json``."""
    from .convert import save_params_npz
    from .utils.atomic import atomic_write_json

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    save_params_npz(directory / PARAMS_FILE, model.state_dict())
    write_model_meta(directory, model.config)
    spec = dict(image_size=model.config.image_size, pretrained=False,
                normalize=True)
    spec.update(transform_spec or {})
    atomic_write_json(directory / TRANSFORM_FILE, spec)
    return directory


def load_inference_checkpoint(checkpoint: str | Path, preset: str,
                              num_classes: int, *,
                              image_size: Optional[int] = None,
                              normalize: Optional[bool] = None,
                              device=None, **config_overrides):
    """Resolve the port's export (or a training ``--checkpoint-dir``) into
    ``(model, transform, spec)`` with the model on ``device`` (``cuda``
    unless named) in eval mode. ``config_overrides`` replace
    :class:`..configs.ViTConfig` fields (e.g. ``attention_impl``)."""
    from .configs import PRESETS
    from .convert import load_params_npz
    from .data.transforms import make_transform
    from .models import ViT

    dev = resolve_device(device)
    ckpt = resolve_export_dir(checkpoint)
    spec = resolve_transform_spec(
        checkpoint, image_size=image_size, normalize=normalize)
    transform = make_transform(**spec)
    cfg = PRESETS[preset](num_classes=int(num_classes),
                          image_size=spec["image_size"], **config_overrides)
    check_model_meta(checkpoint, preset, cfg)
    model = ViT(cfg)
    model.load_state_dict(load_params_npz(ckpt / PARAMS_FILE))
    return model.to(dev).eval(), transform, spec
