"""CLI single-image / directory prediction (port of the JAX package's
``predict.py``; the scriptable face of :mod:`.predictions`)::

    python -m pytorch_vit_paper_replication_tpu_torch.predict \\
        image1.jpg image2.jpg \\
        --checkpoint runs/ckpt --classes pizza steak sushi \\
        --preset ViT-B/16 --plot-dir preds/

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises ``no CUDA device``. (Images are positional; keep them before
``--classes``, whose greedy nargs would otherwise swallow them, or use
``--classes-file labels.txt``, one class name per line.)
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .configs import PRESETS
from .predictions import (load_class_names, load_inference_checkpoint,
                          pred_and_plot_image, predict_batch)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ViT prediction (PyTorch/CUDA)")
    p.add_argument("images", nargs="+", help="image files to classify")
    p.add_argument("--checkpoint", required=True,
                   help="the port's export dir (params.npz) or a training "
                        "--checkpoint-dir holding final/")
    cls_group = p.add_mutually_exclusive_group(required=True)
    cls_group.add_argument("--classes", nargs="+",
                           help="class names in training order (greedy "
                                "nargs: keep image paths BEFORE this "
                                "flag, or use --classes-file)")
    cls_group.add_argument("--classes-file",
                           help="file with one class name per line")
    p.add_argument("--preset", choices=sorted(PRESETS), default="ViT-B/16")
    p.add_argument("--image-size", type=int, default=None,
                   help="defaults to the checkpoint's recorded "
                        "transform.json image size, else 224")
    p.add_argument("--no-normalize", action="store_true",
                   help="disable ImageNet normalization (default follows "
                        "the checkpoint's transform.json when present, "
                        "else the reference predict default: normalized)")
    p.add_argument("--plot-dir", type=str, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    classes = (load_class_names(args.classes_file) if args.classes_file
               else args.classes)
    # One load contract with serve/: the checkpoint's transform.json wins,
    # explicit flags override.
    model, transform, _ = load_inference_checkpoint(
        args.checkpoint, args.preset, len(classes),
        image_size=args.image_size,
        normalize=False if args.no_normalize else None,
        device=args.device)
    if args.plot_dir:
        Path(args.plot_dir).mkdir(parents=True, exist_ok=True)
        for img in args.images:
            out = Path(args.plot_dir) / (Path(img).stem + "_pred.png")
            label, prob = pred_and_plot_image(
                model, classes, img, transform=transform, save_path=out)
            print(f"{img}: {label} ({prob:.3f}) -> {out}")
    else:
        for img, (label, prob) in zip(args.images, predict_batch(
                model, args.images, classes, transform=transform)):
            print(f"{img}: {label} ({prob:.3f})")


if __name__ == "__main__":
    main()
