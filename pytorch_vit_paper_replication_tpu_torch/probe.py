"""Linear probe: extract frozen features once, fit a linear head (port of
the JAX package's ``probe.py``).

The backbone forward runs once per example (:class:`..models.
ViTFeatureExtractor` in eval mode, the hand-written kernels on the card),
the pooled features stay on the device and the head trains on them
full-batch. API: :func:`extract_features` -> :func:`train_linear_probe`
(:func:`init_probe_head` + :func:`fit_linear_probe`) ->
:func:`evaluate_probe`. CLI::

    python -m pytorch_vit_paper_replication_tpu_torch.probe \\
        --train-dir data/train --test-dir data/test \\
        --checkpoint runs/ckpt --preset ViT-B/16

Runs on ``cuda`` unless ``--device cpu`` is given. The initial head is
drawn from a seeded ``torch.Generator`` where JAX draws
``jax.random.normal``: the two packages fit from different starts for the
same ``seed`` (ROADMAP Queue 3, known divergence); :func:`fit_linear_probe`
takes any start, so the tests hand it JAX's.
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .configs import ViTConfig
from .models.vit import ViTFeatureExtractor, pool_tokens
from .optim import ADAM_EPS
from .predictions import resolve_device

Head = Dict[str, torch.Tensor]


def extract_features(
    model: ViTFeatureExtractor,
    batches: Iterable[Dict[str, np.ndarray]],
    *,
    pool: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the frozen backbone over ``batches`` on the model's device.

    Args:
      model: a :class:`ViTFeatureExtractor` with its weights loaded.
      batches: iterable of ``{"image": [B, H, W, C], "label": [B]}``.
      pool: "cls" or "gap"; defaults to the model config's pooling.

    Returns:
      ``(features [N, D] float32, labels [N] int64)`` on the model's
      device.
    """
    from .data.image_folder import prefetch_to_device

    cfg = model.config if pool is None else model.config.replace(pool=pool)
    dev = next(model.parameters()).device
    model.eval()
    feats, labels = [], []
    with torch.no_grad():
        for b in prefetch_to_device(batches, device=dev):
            x = torch.as_tensor(b["image"]).to(dev)
            feats.append(pool_tokens(cfg, model(x)).float())
            labels.append(torch.as_tensor(b["label"]).to(dev).long())
    return torch.cat(feats), torch.cat(labels)


def init_probe_head(dim: int, num_classes: int, *, seed: int = 0,
                    device=None) -> Head:
    """The probe's initial head: ``kernel [D, C]`` ~ 0.01 N(0, 1) from a
    ``torch.Generator`` seeded with ``seed``, zero ``bias``."""
    gen = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    return {"kernel": (torch.randn(dim, num_classes, generator=gen)
                       * 0.01).to(dev),
            "bias": torch.zeros(num_classes, device=dev)}


def _loss(head: Head, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(x @ head["kernel"] + head["bias"], y)


def fit_linear_probe(features, labels, head: Head, *, epochs: int = 200,
                     learning_rate: float = 1e-2,
                     weight_decay: float = 0.0) -> Head:
    """Fit ``softmax(W f + b)`` from ``head`` by full-batch AdamW, step for
    step as ``optax.adamw(learning_rate, weight_decay=weight_decay)``:
    b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected
    moments, the decay ``weight_decay * p`` added to the Adam direction on
    the weights before the step (decoupled), both scaled by
    ``-learning_rate``. Runs on the head's device; ``features`` and
    ``labels`` (arrays or tensors) are moved there. Returns a new head."""
    dev = head["kernel"].device
    x = torch.as_tensor(features, dtype=torch.float32).to(dev)
    y = torch.as_tensor(labels).to(dev).long()
    names = ("kernel", "bias")
    params = [head[n].detach().clone().float().requires_grad_() for n in names]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2 = 0.9, 0.999
    for count in range(1, epochs + 1):
        grads = torch.autograd.grad(_loss(dict(zip(names, params)), x, y),
                                    params)
        with torch.no_grad():
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nu, 1.0 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, 1.0 - b1 ** count),
                                     denom)
            if weight_decay:
                torch._foreach_add_(upd, params, alpha=weight_decay)
            torch._foreach_add_(params, upd, alpha=-learning_rate)
    return {n: p.detach() for n, p in zip(names, params)}


def train_linear_probe(features, labels, num_classes: int, *,
                       epochs: int = 200, learning_rate: float = 1e-2,
                       weight_decay: float = 0.0, seed: int = 0,
                       device=None) -> Head:
    """:func:`init_probe_head` then :func:`fit_linear_probe` on ``device``
    (``cuda`` unless named). Returns ``{"kernel": [D, C], "bias": [C]}``."""
    d = int(features.shape[-1])
    head = init_probe_head(d, num_classes, seed=seed, device=device)
    return fit_linear_probe(features, labels, head, epochs=epochs,
                            learning_rate=learning_rate,
                            weight_decay=weight_decay)


def evaluate_probe(head: Head, features, labels) -> Dict[str, float]:
    """Accuracy and mean cross-entropy of ``head`` on (features, labels),
    on the head's device."""
    dev = head["kernel"].device
    x = torch.as_tensor(features, dtype=torch.float32).to(dev)
    y = torch.as_tensor(labels).to(dev).long()
    with torch.no_grad():
        logits = x @ head["kernel"] + head["bias"]
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
    return {"loss": float(loss), "acc": float(acc)}


def _backbone_state(args, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """Backbone weights from --checkpoint (the port's export: the
    ``backbone/*`` keys of ``params.npz``) or --pretrained (a torch .pth),
    else a seeded random backbone."""
    if args.checkpoint:
        from .convert import load_params_npz
        from .utils.digest import resolve_export_dir

        params = load_params_npz(resolve_export_dir(args.checkpoint)
                                 / "params.npz")
        return {k[len("backbone."):]: v for k, v in params.items()
                if k.startswith("backbone.")}
    if args.pretrained:
        from .convert import params_from_flax
        from .transfer import convert_torch_vit_state_dict, load_torch_file

        tree = convert_torch_vit_state_dict(load_torch_file(args.pretrained),
                                            cfg)["backbone"]
        return params_from_flax(tree)
    from .convert import seeded_params

    print("[WARN] no --checkpoint/--pretrained: probing a RANDOM backbone")
    return seeded_params(cfg, 0, with_head=False)


def build_parser() -> argparse.ArgumentParser:
    from .configs import PRESETS

    p = argparse.ArgumentParser(description="ViT linear probe "
                                            "(PyTorch/CUDA)")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--test-dir", required=True)
    p.add_argument("--preset", choices=sorted(PRESETS), default="ViT-B/16")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--checkpoint", default=None,
                   help="the port's export dir (params.npz) or a training "
                        "--checkpoint-dir holding final/")
    p.add_argument("--num-classes", type=int, default=None,
                   help="class count the --checkpoint was trained with (the "
                        "JAX CLI sizes its restore template with it; the "
                        "port reads the backbone keys and needs none)")
    p.add_argument("--pretrained", default=None,
                   help="torch .pth state_dict for the backbone")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--probe-epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="(not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    return p


def main(argv=None) -> Dict[str, float]:
    from .configs import PRESETS
    from .data import create_dataloaders
    from .data.transforms import make_transform

    args = build_parser().parse_args(argv)
    if args.compile_cache_dir is not None:
        raise SystemExit("--compile-cache-dir is not yet ported (ROADMAP "
                         "Queue 1 item 9)")
    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset](num_classes=1, image_size=args.image_size)
    model = ViTFeatureExtractor(cfg)
    model.load_state_dict(_backbone_state(args, cfg))
    model.to(dev)

    transform = make_transform(
        args.image_size, pretrained=bool(args.pretrained),
        normalize=not args.no_normalize)
    train_dl, test_dl, classes = create_dataloaders(
        args.train_dir, args.test_dir, transform,
        batch_size=args.batch_size)
    print(f"extracting features for {len(classes)} classes...")
    train_f, train_y = extract_features(model, train_dl)
    test_f, test_y = extract_features(model, test_dl)

    head = train_linear_probe(
        train_f, train_y, len(classes), epochs=args.probe_epochs,
        learning_rate=args.lr, weight_decay=args.weight_decay, device=dev)
    train_m = evaluate_probe(head, train_f, train_y)
    test_m = evaluate_probe(head, test_f, test_y)
    print(f"probe: train_acc {train_m['acc']:.4f} | "
          f"test_acc {test_m['acc']:.4f} | test_loss {test_m['loss']:.4f}")
    return {"train_acc": train_m["acc"], "test_acc": test_m["acc"],
            "test_loss": test_m["loss"]}


if __name__ == "__main__":
    main()
