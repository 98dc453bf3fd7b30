"""CLI training entry point (port of the JAX package's ``train.py``).

One command trains a preset on an image folder, packed uint8 shards or
CIFAR-10 on one CUDA card, with async checkpoints, mid-epoch resume, JSONL
metrics and step telemetry::

    python -m pytorch_vit_paper_replication_tpu_torch.train \\
        --train-dir data/pizza_steak_sushi/train \\
        --test-dir data/pizza_steak_sushi/test \\
        --preset ViT-B/16 --epochs 10 --batch-size 32 \\
        --checkpoint-dir runs/vit --metrics-jsonl runs/vit/m.jsonl

    # no dataset handy (or offline): --synthetic generates one
    python -m pytorch_vit_paper_replication_tpu_torch.train --synthetic \\
        --preset ViT-Ti/16 --image-size 64 --epochs 2

    # ImageNet scale: pack once, train from memory-mapped shards with the
    # array-space augmentation, watch the run through the telemetry JSONL
    python -m pytorch_vit_paper_replication_tpu_torch.data.pack \\
        imagenet/train packs/train --pack-size 256 --shuffle-seed 0
    python -m pytorch_vit_paper_replication_tpu_torch.train \\
        --dataset packed --train-dir packs/train --test-dir packs/val \\
        --shuffle-window 65536 --readahead 2 --checkpoint-dir runs/in1k \\
        --checkpoint-every-steps 1000 --telemetry-jsonl runs/in1k/tel.jsonl \\
        --watchdog-s 300 --profile-steps 100:102

It runs on ``cuda`` unless ``--device cpu`` is given (then the kernels'
plain PyTorch versions run); without a card it raises ``no CUDA device``.
Checkpoint saves are asynchronous unless ``--sync-checkpoints``. The flags
keep the JAX CLI's names, defaults and semantics. Those whose path is not
ported yet (elastic and multi-card meshes, the metrics HTTP endpoint, the
fleet shipper, TensorBoard, the compile cache) are parsed and refused
with ``... not yet ported (ROADMAP Queue 1 item N)`` when given a value
other than their default.

Distillation: ``--distill-from SINK`` trains a student against a sealed
``tools.batch_infer --head logits`` sink the teacher dumped over the same
train split (rows paired with records by dataset ordinal; the objective is
:func:`.engine.distill_loss`, ``--distill-alpha 0`` ordinary training bit
for bit)::

    python -m pytorch_vit_paper_replication_tpu_torch.tools.batch_infer \
        packs/train --checkpoint runs/teacher --classes-file classes.txt \
        --head logits --out runs/teacher_logits
    python -m pytorch_vit_paper_replication_tpu_torch.train \
        --dataset packed --train-dir packs/train --test-dir packs/val \
        --preset ViT-Ti/16 --distill-from runs/teacher_logits \
        --distill-t 2 --distill-alpha 0.7 --checkpoint-dir runs/student

Transfer learning: ``--pretrained PTH`` starts the backbone from a torch
ViT state_dict (position embedding interpolated to ``--image-size``, head
at zero, the pretrained transform), ``--freeze-backbone`` trains the head
alone; ``--model tinyvgg`` trains the reference's baseline CNN::

    python -m pytorch_vit_paper_replication_tpu_torch.train \\
        --train-dir data/train --test-dir data/test --image-size 384 \\
        --pretrained vit_b_16.pth --freeze-backbone --epochs 5

A finished run leaves ``final/params.npz``, ``transform.json`` and (ViT)
``model_meta.json`` under ``--checkpoint-dir``: the layout the port's
``predict`` and ``serve`` CLIs load.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

from . import engine
from .checkpoint import Checkpointer, load_model, save_model
from .configs import PRESETS, TrainConfig, ViTConfig
from .convert import seeded_state
from .data import create_dataloaders, make_synthetic_image_folder, pad_batch
from .data.image_folder import prefetch_to_device
from .data.transforms import make_transform
from .metrics import MetricsLogger
from .models import TinyVGG, ViT
from .optim import head_only_label_fn, make_lr_schedule, make_optimizer
from .predictions import resolve_device, write_model_meta
from .telemetry.profiling import parse_profile_steps
from .transfer import init_from_pretrained
from .utils.atomic import atomic_write_json
from .utils.model_summary import count_params
from .utils.plotting import plot_loss_curves
from .utils.seeding import set_seeds

# Flags of the JAX CLI whose path the port does not have yet, by the
# ROADMAP Queue 1 item that brings it. Parsed with the JAX defaults; any
# other value exits non-zero (--mesh-data is checked on its own: -1 and 1
# both mean the one card).
NOT_PORTED: Dict[str, int] = {
    "compile_cache_dir": 9,
    "elastic": 7, "elastic_backend": 7, "elastic_heartbeat_s": 7,
    "elastic_timeout_s": 7, "elastic_rejoin_s": 7,
    "elastic_local_devices": 7, "elastic_rendezvous": 7,
    "elastic_worker_id": 7, "elastic_process_count": 7,
    "elastic_generation": 7, "elastic_collective": 7,
    "mesh_model": 7, "mesh_seq": 7, "mesh_pipe": 7, "pipe_microbatches": 7,
    "multihost": 7, "sp_impl": 7,
    "tensorboard_dir": 6, "metrics_port": 6, "ship_to": 6,
    "ship_interval_s": 6, "worker_id": 6,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="ViT training (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    data = p.add_argument_group("data")
    data.add_argument("--dataset",
                      choices=["imagefolder", "cifar10", "packed"],
                      default="imagefolder")
    data.add_argument("--train-dir", type=str, default=None,
                      help="train split: image folder, or for --dataset "
                           "packed a data.pack output dir")
    data.add_argument("--test-dir", type=str, default=None)
    data.add_argument("--data-root", type=str, default=None,
                      help="for --dataset cifar10: the cifar-10-batches-py "
                           "dir or the .tar.gz archive")
    data.add_argument("--augment", action="store_true",
                      help="RandomResizedCrop + horizontal-flip train "
                           "augmentation for --dataset imagefolder; eval "
                           "keeps the deterministic transform")
    data.add_argument("--no-augment", action="store_true",
                      help="disable the same augmentation where it is on "
                           "by default (--dataset packed)")
    data.add_argument("--synthetic", action="store_true",
                      help="generate a small synthetic dataset (offline)")
    data.add_argument("--synthetic-per-class", type=int, default=32,
                      help="train images per class for --synthetic (test "
                           "split gets a quarter)")
    data.add_argument("--synthetic-noise", type=float, default=40.0,
                      help="per-pixel noise sigma for --synthetic")
    data.add_argument("--image-size", type=int, default=224)
    data.add_argument("--num-workers", type=int, default=None)
    data.add_argument("--worker-type", choices=["thread", "process"],
                      default="thread",
                      help="decode pool: threads, or forked processes "
                           "(torch DataLoader num_workers semantics)")
    data.add_argument("--shuffle-window", type=int, default=0,
                      help="streaming windowed shuffle over N records "
                           "(0 = global permutation)")
    data.add_argument("--readahead", type=int, default=0,
                      help="hint N upcoming shard blocks into the page "
                           "cache (packed datasets; 0 = off)")
    data.add_argument("--evict-behind", action="store_true",
                      help="with --readahead: drop consumed blocks from "
                           "the page cache")
    data.add_argument("--cache-dataset", action="store_true",
                      help="decode each image once, serve later epochs "
                           "from RAM")
    data.add_argument("--no-normalize", action="store_true",
                      help="disable ImageNet normalization (off for "
                           "scratch runs already)")

    model = p.add_argument_group("model")
    model.add_argument("--model", choices=["vit", "tinyvgg"], default="vit",
                       help="vit (--preset) or the reference's TinyVGG "
                            "baseline CNN")
    model.add_argument("--hidden-units", type=int, default=10,
                       help="TinyVGG conv width")
    model.add_argument("--preset", choices=sorted(PRESETS),
                       default="ViT-B/16")
    model.add_argument("--patch-size", type=int, default=None)
    model.add_argument("--dtype", default="bfloat16",
                       choices=["bfloat16", "float32"])
    model.add_argument("--ln-eps", type=float, default=None,
                       help="LayerNorm epsilon override (default 1e-6)")
    model.add_argument("--attention", default="auto",
                       choices=["auto", "xla", "flash"],
                       help="auto = the CUDA flash kernel on the card at "
                            "T >= 197, else the materialized path")
    model.add_argument("--attention-softmax", default="saturating",
                       choices=["saturating", "exact"])
    model.add_argument("--attention-probs-dtype", default="bf16",
                       choices=["bf16", "fp8_e4m3", "fp8_e5m2", "u8"],
                       help="storage of the materialized attention probs")
    model.add_argument("--attention-probs-residual-dtype", default=None,
                       choices=["bf16", "fp8_e4m3", "fp8_e5m2", "u8"])
    model.add_argument("--sp-impl", default="ring",
                       choices=["ring", "ulysses"],
                       help="sequence parallelism (not ported)")
    model.add_argument("--mlp-impl", default="auto",
                       choices=["auto", "fused", "xla"],
                       help="fused = the CUDA LN+MLP+residual kernel; "
                            "auto = fused on the card")
    model.add_argument("--pool", default="cls", choices=["cls", "gap"])
    model.add_argument("--dropout", type=float, default=None,
                       help="override all three dropout rates; 0 makes "
                            "the step deterministic given (seed, step)")
    model.add_argument("--remat", action="store_true")

    train = p.add_argument_group("training (reference recipe defaults)")
    train.add_argument("--epochs", type=int, default=10)
    train.add_argument("--batch-size", type=int, default=32)
    train.add_argument("--lr", type=float, default=1e-3)
    train.add_argument("--weight-decay", type=float, default=0.03)
    train.add_argument("--warmup-fraction", type=float, default=0.05)
    train.add_argument("--grad-clip", type=float, default=1.0)
    train.add_argument("--label-smoothing", type=float, default=0.0)
    train.add_argument("--seed", type=int, default=42)
    train.add_argument("--grad-accum", type=int, default=1,
                       help="average gradients over N micro-batches per "
                            "optimizer update")
    train.add_argument("--nan-guard", action="store_true",
                       help="skip any update whose loss or gradient norm "
                            "is nonfinite")
    train.add_argument("--distill-from", type=str, default=None,
                       metavar="SINK_DIR",
                       help="knowledge distillation: a completed "
                            "tools.batch_infer --head logits output dir, "
                            "dumped by the teacher over this exact train "
                            "split; teacher rows are gathered per batch by "
                            "record ordinal and the manifest's rows, "
                            "classes and sha256 are verified before the "
                            "first step; the objective becomes engine."
                            "distill_loss")
    train.add_argument("--distill-t", type=float, default=2.0,
                       help="distillation temperature T (the KL term "
                            "compares softmax(logits/T) and is scaled by "
                            "T^2)")
    train.add_argument("--distill-alpha", type=float, default=0.5,
                       help="soft-target weight in the KD mix; 0.0 is "
                            "ordinary training bit for bit, 1.0 pure "
                            "teacher mimicry")
    train.add_argument("--eval-only", action="store_true",
                       help="score the latest checkpoint (or the final/ "
                            "export) in --checkpoint-dir on the test "
                            "split, then exit")
    train.add_argument("--rng-impl", default="unsafe_rbg",
                       choices=["threefry2x32", "rbg", "unsafe_rbg"],
                       help="JAX PRNG choice; the port's dropout streams "
                            "come from (seed, step) whatever it says")
    train.add_argument("--extend-schedule", action="store_true",
                       help="allow resuming with a different schedule "
                            "horizon (--epochs or steps/epoch); the LR "
                            "schedule is re-scaled to the new horizon")

    transfer = p.add_argument_group("transfer learning")
    transfer.add_argument("--pretrained", type=str, default=None,
                          metavar="PTH",
                          help="torch ViT state_dict (.pth/.pt; torchvision "
                               "or the reference repo's layout) for the "
                               "backbone, the head starts at zero; the "
                               "position embedding is interpolated to "
                               "--image-size; implies the pretrained "
                               "transform (ImageNet normalization unless "
                               "--no-normalize)")
    transfer.add_argument("--freeze-backbone", action="store_true",
                          help="train the classifier head only (the "
                               "backbone gets no update and no Adam state)")

    elastic = p.add_argument_group("elastic (not ported)")
    elastic.add_argument("--elastic", type=int, default=0, metavar="N")
    elastic.add_argument("--elastic-backend", default="host",
                         choices=["host", "jax"])
    elastic.add_argument("--elastic-heartbeat-s", type=float, default=1.0)
    elastic.add_argument("--elastic-timeout-s", type=float, default=15.0)
    elastic.add_argument("--elastic-rejoin-s", type=float, default=0.0)
    elastic.add_argument("--elastic-local-devices", type=int, default=0)
    elastic.add_argument("--elastic-rendezvous", type=str, default=None)
    elastic.add_argument("--elastic-worker-id", type=int, default=None,
                         help=argparse.SUPPRESS)
    elastic.add_argument("--elastic-process-count", type=int, default=1,
                         help=argparse.SUPPRESS)
    elastic.add_argument("--elastic-generation", type=int, default=0,
                         help=argparse.SUPPRESS)
    elastic.add_argument("--elastic-collective", type=str, default=None,
                         help=argparse.SUPPRESS)

    dist = p.add_argument_group("distributed (one card: the default mesh)")
    dist.add_argument("--mesh-data", type=int, default=-1)
    dist.add_argument("--mesh-model", type=int, default=1)
    dist.add_argument("--mesh-seq", type=int, default=1)
    dist.add_argument("--mesh-pipe", type=int, default=1)
    dist.add_argument("--pipe-microbatches", type=int, default=0)
    dist.add_argument("--multihost", action="store_true")

    out = p.add_argument_group("output")
    out.add_argument("--checkpoint-dir", type=str, default=None)
    out.add_argument("--keep-checkpoints", type=int, default=3)
    out.add_argument("--checkpoint-every-steps", type=int, default=0,
                     help="also checkpoint every N train (micro-)steps; "
                          "resume continues mid-epoch, skipping the "
                          "interrupted epoch's already-trained batches")
    out.add_argument("--sync-checkpoints", action="store_true",
                     help="synchronous (blocking) checkpoint saves; by "
                          "default a save snapshots the state into pinned "
                          "host buffers on a side stream and a writer "
                          "thread commits it")
    out.add_argument("--checkpoint-every-epochs", type=int, default=1,
                     help="save cadence in epochs (the final epoch always "
                          "saves)")
    out.add_argument("--metrics-jsonl", type=str, default=None)
    out.add_argument("--tensorboard-dir", type=str, default=None,
                     help="(not ported)")
    out.add_argument("--plot", type=str, default=None,
                     help="save loss curves PNG here")
    out.add_argument("--profile-dir", type=str, default=None,
                     help="capture a torch.profiler trace of epoch 1 "
                          "(trace.json)")
    out.add_argument("--device", default="cuda",
                     help="torch device (default cuda; 'cpu' runs the "
                          "kernels' plain PyTorch versions)")

    obs = p.add_argument_group("observability (telemetry/)")
    obs.add_argument("--telemetry-jsonl", type=str, default=None,
                     help="per-step span telemetry stream (sampled 'step' "
                          "rows + per-epoch goodput summaries: data-wait "
                          "vs device seconds, step p50/p95/p99, goodput "
                          "%%, live img/s + analytic MFU against the "
                          "card's bf16 peak)")
    obs.add_argument("--telemetry-every", type=int, default=32,
                     help="telemetry sampling cadence: one JSONL step row "
                          "and one wait on the card per N steps")
    obs.add_argument("--watchdog-s", type=float, default=0.0,
                     help="stall watchdog deadline: if no train step/span "
                          "completes for this many seconds, dump "
                          "all-thread stacks + memory + the last "
                          "telemetry events to the postmortem file; the "
                          "same dump fires on SIGTERM. 0 = off")
    obs.add_argument("--postmortem", type=str, default=None,
                     help="watchdog postmortem path (default: "
                          "postmortem.txt next to --checkpoint-dir or "
                          "--telemetry-jsonl, else ./postmortem.txt)")
    obs.add_argument("--profile-steps", type=str, default=None,
                     metavar="A:B",
                     help="capture a torch.profiler trace of global steps "
                          "A..B (inclusive); SIGUSR2 arms a window over "
                          "the next steps of a running trainer")
    obs.add_argument("--profile-auto", action="store_true",
                     help="auto-capture when the rolling p50 of "
                          "barrier-amortized step walls regresses more "
                          "than --profile-auto-pct over the baseline")
    obs.add_argument("--profile-auto-pct", type=float, default=25.0,
                     help="anomaly threshold for --profile-auto (percent "
                          "p50 regression)")
    obs.add_argument("--profile-trace-dir", type=str, default=None,
                     help="capture destination (default: profiles/ next "
                          "to --checkpoint-dir or --telemetry-jsonl)")
    obs.add_argument("--metrics-port", type=int, default=None,
                     help="(not ported)")
    obs.add_argument("--ship-to", type=str, default=None,
                     metavar="HOST:PORT", help="(not ported)")
    obs.add_argument("--ship-interval-s", type=float, default=2.0,
                     help="(not ported)")
    obs.add_argument("--worker-id", type=str, default=None,
                     help="(not ported)")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="(not ported)")
    return p


def refuse_unported(parser: argparse.ArgumentParser,
                    args: argparse.Namespace) -> None:
    """Exit non-zero on the first flag whose path is not ported yet."""
    for dest, item in NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not yet ported (ROADMAP Queue 1 "
                             f"item {item})")
    if args.rng_impl != parser.get_default("rng_impl"):
        raise SystemExit(
            "--rng-impl selects a JAX PRNG and is not ported: the port's "
            "dropout draws from torch.Generator streams seeded by (seed, "
            "step) and the kernels' positional hash (ROADMAP Queue 3, "
            "known divergence)")
    if args.mesh_data not in (-1, 1):
        raise SystemExit("--mesh-data other than 1 is not yet ported "
                         "(ROADMAP Queue 1 item 7)")


def folder_loaders(args, loader_kwargs: dict, transform_spec: dict):
    """(train, test, classes) of ``--dataset imagefolder``."""
    if args.synthetic:
        tmp = Path(tempfile.mkdtemp(prefix="vit_synth_"))
        train_dir, test_dir = make_synthetic_image_folder(
            tmp, train_per_class=args.synthetic_per_class,
            test_per_class=max(1, args.synthetic_per_class // 4),
            image_size=args.image_size, noise_sigma=args.synthetic_noise)
    else:
        if not args.train_dir or not args.test_dir:
            raise SystemExit(
                "--train-dir/--test-dir required (or pass --synthetic)")
        train_dir, test_dir = args.train_dir, args.test_dir
    transform = make_transform(**transform_spec)
    if args.augment:
        # Augment the train split only; eval (and predict, via
        # transform.json) keeps the deterministic pipeline. Seeded from
        # --seed: bit-reproducible with one decode worker.
        from .data.transforms import ThreadLocalRng, augment_transform
        train_transform = augment_transform(
            args.image_size, normalize=transform_spec["normalize"],
            rng=ThreadLocalRng(args.seed))
    else:
        train_transform = transform
    return create_dataloaders(
        train_dir, test_dir, train_transform, eval_transform=transform,
        drop_last_train=True, cache=args.cache_dataset, **loader_kwargs)


def cifar_loaders(args, loader_kwargs: dict, transform_spec: dict):
    """(train, test, classes) of ``--dataset cifar10``: the archive at
    ``--data-root`` (``--synthetic``: a seeded fake one), resized per item
    to ``--image-size``. transform.json records that plain square resize."""
    from .data import (DataLoader, ResizedArrayDataset, load_cifar10,
                       make_fake_cifar10)
    transform_spec["pretrained"] = False
    if args.synthetic:
        root = make_fake_cifar10(Path(tempfile.mkdtemp(prefix="cifar_fake_")))
    elif args.data_root:
        root = args.data_root
    else:
        raise SystemExit("--data-root required for --dataset cifar10 (or "
                         "pass --synthetic)")
    train_ds, test_ds = load_cifar10(root)
    train_ds = ResizedArrayDataset(train_ds, args.image_size,
                                   normalize=transform_spec["normalize"])
    test_ds = ResizedArrayDataset(test_ds, args.image_size,
                                  normalize=transform_spec["normalize"])
    if args.cache_dataset:
        # Real CIFAR-10 resized to 224 px is ~45 GB of float32.
        print("[warn] --cache-dataset has no effect with --dataset cifar10 "
              "(resized CIFAR would not fit host RAM)")
    train_dl = DataLoader(train_ds, shuffle=True, drop_last=True,
                          **loader_kwargs)
    test_dl = DataLoader(test_ds, shuffle=False, pad_shards=True,
                         **loader_kwargs)
    return train_dl, test_dl, list(train_ds.classes)


def packed_loaders(args, loader_kwargs: dict, transform_spec: dict):
    """(train, test, classes) of ``--dataset packed``: memory-mapped
    shards, the fused array-space augmentation unless ``--no-augment``.
    transform.json records resize-shorter to the pack size + center crop,
    what eval sees of the original image."""
    from .data import create_packed_dataloaders
    if not args.train_dir or not args.test_dir:
        raise SystemExit(
            "--train-dir/--test-dir (pack_image_folder outputs) required "
            "for --dataset packed; build them with python -m "
            "pytorch_vit_paper_replication_tpu_torch.data.pack")
    train_dl, test_dl, class_names = create_packed_dataloaders(
        args.train_dir, args.test_dir, image_size=args.image_size,
        normalize=transform_spec["normalize"], augment=not args.no_augment,
        **loader_kwargs)
    pack_size = train_dl.dataset.pack_size
    if args.image_size > pack_size:
        # Training would upscale pack_size crops while predict (via
        # transform.json) resizes the original: different pixels.
        raise SystemExit(
            f"--image-size {args.image_size} exceeds the shards' pack size "
            f"{pack_size}: packed records have no more resolution to "
            f"offer, and eval/predict geometry would diverge. Re-pack with "
            f"pack_size >= {args.image_size} (python -m "
            f"pytorch_vit_paper_replication_tpu_torch.data.pack "
            f"--pack-size {args.image_size} ...)")
    transform_spec["pretrained"] = True
    transform_spec["resize_size"] = pack_size
    if args.cache_dataset:
        print("[warn] --cache-dataset has no effect with --dataset packed "
              "(shards are already decode-free via memmap)")
    return train_dl, test_dl, class_names


def initial_params(model: torch.nn.Module,
                   seed: int) -> Dict[str, torch.Tensor]:
    """The run's initial weights, made from the model's parameter shapes
    and ``seed`` (the JAX CLI's ``model.init(key(seed), ...)``, whose Flax
    RNG the port does not reproduce)."""
    return seeded_state(model, seed)


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    # A typo'd window must fail before the data and model set-up.
    profile_window = None
    if args.profile_steps:
        try:
            profile_window = parse_profile_steps(args.profile_steps)
        except ValueError as e:
            raise SystemExit(str(e))
    dev = resolve_device(args.device)

    cfg_kwargs = dict(image_size=args.image_size, dtype=args.dtype,
                      attention_impl=args.attention,
                      attention_softmax=args.attention_softmax,
                      attention_probs_dtype=args.attention_probs_dtype,
                      attention_probs_residual_dtype=(
                          args.attention_probs_residual_dtype),
                      mlp_impl=args.mlp_impl, remat=args.remat,
                      pool=args.pool)
    if args.patch_size:
        cfg_kwargs["patch_size"] = args.patch_size
    if args.ln_eps is not None:
        cfg_kwargs["ln_epsilon"] = args.ln_eps
    if args.dropout is not None:
        cfg_kwargs.update(attn_dropout=args.dropout,
                          mlp_dropout=args.dropout,
                          embedding_dropout=args.dropout)
    set_seeds(args.seed)

    if args.eval_only:
        if not args.checkpoint_dir:
            raise SystemExit("--eval-only requires --checkpoint-dir")
        if not args.train_dir and args.test_dir:
            # Eval needs no train split; reuse the test dir so the loader
            # plumbing (class names, transform decisions) works unchanged.
            args.train_dir = args.test_dir

    # Data -----------------------------------------------------------------
    loader_kwargs = dict(batch_size=args.batch_size, seed=args.seed,
                         worker_type=args.worker_type,
                         shuffle_window=args.shuffle_window,
                         readahead=args.readahead,
                         evict_behind=args.evict_behind)
    if args.num_workers is not None:
        loader_kwargs["num_workers"] = args.num_workers
    # ONE transform decision, shared with predict via transform.json.
    # Pretrained runs get the weights' own eval transform (resize-shorter +
    # center-crop + ImageNet normalize, reference main nb cell 117).
    transform_spec = dict(
        image_size=args.image_size, pretrained=bool(args.pretrained),
        normalize=False if args.no_normalize else bool(args.pretrained))
    if args.augment and args.dataset == "cifar10":
        raise SystemExit(
            "--augment (RandomResizedCrop) is for --dataset imagefolder; "
            "the cifar10 path has no augmentation support")
    if args.augment and args.dataset == "packed":
        print("[info] --augment is already the default for --dataset packed")
    if args.dataset == "cifar10":
        train_dl, test_dl, class_names = cifar_loaders(args, loader_kwargs,
                                                       transform_spec)
    elif args.dataset == "packed":
        train_dl, test_dl, class_names = packed_loaders(args, loader_kwargs,
                                                        transform_spec)
    else:
        train_dl, test_dl, class_names = folder_loaders(args, loader_kwargs,
                                                        transform_spec)
    print(f"classes: {class_names} | train batches/epoch: {len(train_dl)}")
    distill_rows = load_teacher(args, train_dl, class_names)

    # Model + state ---------------------------------------------------------
    if args.model == "tinyvgg":
        # Reference script-entry parity (going_modular train.py:39-43).
        if args.pretrained or args.freeze_backbone:
            raise SystemExit(
                "--pretrained/--freeze-backbone apply to ViT only")
        cfg = None
        model = TinyVGG(hidden_units=args.hidden_units,
                        num_classes=len(class_names), dtype=args.dtype,
                        image_size=args.image_size)
        model_name = f"TinyVGG({args.hidden_units})"
    else:
        cfg = PRESETS[args.preset](num_classes=len(class_names), **cfg_kwargs)
        model = ViT(cfg)
        model_name = args.preset
    if args.pretrained:
        model.load_state_dict(init_from_pretrained(cfg, args.pretrained))
        print(f"initialized backbone from {args.pretrained}")
    else:
        model.load_state_dict(initial_params(model, args.seed))
    model.to(dev)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.lr, weight_decay=args.weight_decay,
        warmup_fraction=args.warmup_fraction, grad_clip_norm=args.grad_clip,
        label_smoothing=args.label_smoothing, seed=args.seed,
        freeze_backbone=args.freeze_backbone)
    steps_per_epoch = len(train_dl)
    total_steps = steps_per_epoch * args.epochs
    accum = max(1, args.grad_accum)
    if args.eval_only:
        # The checkpoint's own grad_accum wins: the restored optimizer
        # state must be the one that was saved.
        meta_p = Path(args.checkpoint_dir) / "run_meta.json"
        if meta_p.is_file():
            accum = max(1, json.loads(meta_p.read_text()).get("grad_accum",
                                                              accum))
    elif accum > total_steps:
        raise SystemExit(
            f"--grad-accum {accum} exceeds the run's {total_steps} total "
            "micro-steps: no optimizer update would ever be applied")
    # A frozen backbone keeps requires_grad: the step's grad_norm metric is
    # the norm of every gradient, as JAX's engine takes it; the optimizer
    # (and its clip) sees the head only.
    tx = make_optimizer(
        train_cfg, max(1, total_steps // accum),
        trainable_label_fn=head_only_label_fn if train_cfg.freeze_backbone
        else None, grad_accum_steps=accum)
    if accum > 1:
        print(f"gradient accumulation: {accum} micro-batches/update "
              f"(effective batch {args.batch_size * accum})")
    print(f"model: {model_name} | params: "
          f"{count_params(model.state_dict()):,} | device: {dev}")
    state = engine.TrainState.create(model=model, tx=tx, seed=args.seed)
    train_step = engine.make_train_step(
        label_smoothing=args.label_smoothing, nan_guard=args.nan_guard,
        distill_alpha=(args.distill_alpha if args.distill_from else None),
        distill_t=args.distill_t)

    checkpointer = (Checkpointer(args.checkpoint_dir,
                                 max_to_keep=args.keep_checkpoints,
                                 async_save=not args.sync_checkpoints)
                    if args.checkpoint_dir else None)
    epochs_to_run = args.epochs
    done_epochs = 0
    meta_path = (Path(args.checkpoint_dir) / "run_meta.json"
                 if args.checkpoint_dir else None)
    if (not args.eval_only and checkpointer is not None
            and checkpointer.latest_step() is not None):
        state = checkpointer.restore(state)
        done_steps = state.step
        done_epochs = done_steps // max(1, steps_per_epoch)
        skip_batches = done_steps % max(1, steps_per_epoch)
        epochs_to_run = max(0, args.epochs - done_epochs)
        if meta_path.is_file():
            check_resume(json.loads(meta_path.read_text()), args,
                         steps_per_epoch, total_steps, accum, skip_batches)
        # Continue the per-epoch shuffle sequence where the run left off
        # (the loader derives order from (seed, epoch)); a mid-epoch
        # checkpoint also skips the interrupted epoch's trained prefix,
        # index-level in the loader, so skipped batches are never decoded.
        train_dl.epoch = done_epochs
        train_dl.skip_next_batches = skip_batches
        print(f"resumed from step {done_steps} "
              f"({done_epochs}/{args.epochs} epochs done"
              + (f" + {skip_batches} steps" if skip_batches else "")
              + f"; {epochs_to_run} to run)")
    if meta_path is not None and not args.eval_only:
        meta_path.parent.mkdir(parents=True, exist_ok=True)
        meta = {"steps_per_epoch": steps_per_epoch,
                "global_batch_size": args.batch_size,
                "grad_accum": accum,
                "epochs": args.epochs}
        if args.distill_from:
            # The objective's knobs beside the schedule: a distilled
            # checkpoint says how it was trained.
            meta.update(distill_alpha=args.distill_alpha,
                        distill_t=args.distill_t)
        atomic_write_json(meta_path, meta)

    def with_teacher():
        for b in train_dl:
            # This batch's teacher rows by dataset ordinal: a [B, C]
            # fancy-index copy out of the read-only sink memmap, sent to
            # the card with the batch.
            b["teacher_logits"] = distill_rows[b.pop("index")]
            yield b

    def train_batches():
        return prefetch_to_device(
            train_dl if distill_rows is None else with_teacher(), device=dev)

    def eval_batches():
        return prefetch_to_device((pad_batch(b, 1) for b in test_dl),
                                  device=dev)

    with contextlib.ExitStack() as stack:
        if checkpointer is not None:
            # Every exit path waits for the save in flight (and raises its
            # error); the writer thread is not a daemon either.
            stack.callback(checkpointer.wait)
        logger = (stack.enter_context(MetricsLogger(args.metrics_jsonl))
                  if args.metrics_jsonl else None)
        telemetry = make_telemetry(args, cfg, dev, profile_window, stack)
        if args.eval_only:
            return eval_only(args, state, checkpointer, eval_batches, logger,
                             telemetry)
        lr_sched = make_lr_schedule(train_cfg, max(1, total_steps // accum))
        state, results = engine.train(
            state, train_batches, eval_batches, epochs=epochs_to_run,
            train_step=train_step, logger=logger, checkpointer=checkpointer,
            profile_dir=args.profile_dir, start_epoch=done_epochs,
            checkpoint_every_steps=args.checkpoint_every_steps,
            checkpoint_every_epochs=args.checkpoint_every_epochs,
            lr_schedule=lambda s: lr_sched(s // accum), telemetry=telemetry)

    if args.checkpoint_dir:
        # The params-only export the port's predict and serve CLIs load,
        # with the transform decision and the model identity beside it.
        ckpt = Path(args.checkpoint_dir)
        save_model(state.model.state_dict(), ckpt, "final")
        atomic_write_json(ckpt / "transform.json", transform_spec)
        if cfg is not None:
            write_model_meta(ckpt, cfg, extra={"preset": args.preset})
    if args.plot:
        plot_loss_curves(results, save_path=args.plot)
    return results


def load_teacher(args, train_dl, class_names):
    """``--distill-from``: the verified teacher sink's rows (None when not
    distilling); turns on the loader's ``index`` key and publishes the
    ``distill_alpha`` / ``distill_t`` gauges."""
    if not args.distill_from:
        return None
    if args.eval_only:
        raise SystemExit("--distill-from does nothing under --eval-only; "
                         "drop one of the two")
    from .distill import load_distill_sink
    from .telemetry import get_registry
    rows, manifest = load_distill_sink(
        args.distill_from, n_records=len(train_dl.dataset),
        n_classes=len(class_names))
    train_dl.emit_indices = True
    print(f"distillation: teacher sink {args.distill_from} "
          f"({manifest['total_records']} records x {manifest['out_dim']} "
          f"classes, teacher fingerprint {manifest['fingerprint']}) | "
          f"t={args.distill_t:g} alpha={args.distill_alpha:g}")
    get_registry().gauge("distill_alpha", args.distill_alpha)
    get_registry().gauge("distill_t", args.distill_t)
    return rows


def check_resume(meta: dict, args, steps_per_epoch: int, total_steps: int,
                 accum: int, skip_batches: int) -> None:
    """The resume contract of ``run_meta.json``: the schedule horizon
    (``--epochs`` x steps/epoch) may change only with
    ``--extend-schedule``; a mid-epoch resume needs the same steps/epoch;
    ``--grad-accum`` must match."""
    meta_epochs = meta.get("epochs")
    old_spe = meta.get("steps_per_epoch", steps_per_epoch)
    if meta_epochs is not None and meta_epochs * old_spe != total_steps:
        msg = (f"schedule horizon change on resume: checkpoint was written "
               f"for --epochs {meta_epochs} x {old_spe} steps/epoch (LR "
               f"schedule over {meta_epochs * old_spe} micro-steps), this "
               f"run schedules over {total_steps} ({args.epochs} x "
               f"{steps_per_epoch}); re-scaling re-opens warmup/decay at "
               f"the restored step")
        if not args.extend_schedule:
            raise SystemExit(
                msg + " — pass --extend-schedule to accept the re-scaled "
                f"schedule, or rerun with --epochs {meta_epochs} and the "
                "original batch size/dataset")
        print(f"[extend-schedule] {msg}")
    if meta.get("steps_per_epoch") != steps_per_epoch:
        msg = (f"resume mismatch: checkpoint was written with "
               f"steps_per_epoch={meta.get('steps_per_epoch')} (batch "
               f"{meta.get('global_batch_size')}), this run has "
               f"{steps_per_epoch} (batch {args.batch_size})")
        if skip_batches:
            raise SystemExit(msg + " — mid-epoch resume would skip a "
                             "wrong-sized prefix; rerun with the original "
                             "batch size/dataset")
        print(f"[warn] {msg}; epoch accounting and the LR schedule's "
              "remaining length shift accordingly")
    if meta.get("grad_accum", 1) != accum:
        raise SystemExit(
            f"resume mismatch: checkpoint used --grad-accum "
            f"{meta.get('grad_accum', 1)}, this run uses {accum}; rerun "
            "with the original value")


def make_telemetry(args, cfg: Optional[ViTConfig], dev: torch.device,
                   profile_window, stack: contextlib.ExitStack):
    """The run's :class:`..telemetry.StepTelemetry` (None when no
    telemetry, watchdog or profiling flag is given), with its watchdog and
    profile controller; each is closed by ``stack``. ``tel_mfu`` takes the
    card's bf16 peak from :mod:`..telemetry.flops`; a card the table lacks
    (or the CPU) gets one printed line and no MFU gauge, and so does
    TinyVGG (``cfg`` None: no FLOP count)."""
    if not (args.telemetry_jsonl or args.watchdog_s > 0
            or args.profile_steps or args.profile_auto):
        return None
    from .telemetry import (ProfileController, StepTelemetry, Watchdog,
                            bf16_peak_tflops, train_step_flops_per_image)
    run_dir = (Path(args.checkpoint_dir) if args.checkpoint_dir
               else Path(args.telemetry_jsonl).parent
               if args.telemetry_jsonl else Path("."))
    watchdog = None
    if args.watchdog_s > 0:
        pm = args.postmortem or str(run_dir / "postmortem.txt")
        watchdog = Watchdog(args.watchdog_s, postmortem_path=pm)
        watchdog.install_sigterm()
        stack.callback(watchdog.stop)
        watchdog.start()
        print(f"watchdog: deadline {args.watchdog_s:g}s, postmortem -> {pm}")
    # The capture controller exists whenever telemetry does: SIGUSR2 can
    # arm a window on a live run even with no profiling flag.
    trace_dir = args.profile_trace_dir or str(run_dir / "profiles")
    profiler = ProfileController(trace_dir, steps=profile_window,
                                 auto=args.profile_auto,
                                 auto_pct=args.profile_auto_pct)
    profiler.install_sigusr2()
    stack.callback(profiler.close)
    if args.profile_steps or args.profile_auto:
        print(f"profiler: captures -> {trace_dir}"
              + (f", steps {args.profile_steps}" if args.profile_steps
                 else "")
              + (f", auto-arm on p50 +{args.profile_auto_pct:g}%"
                 if args.profile_auto else ""))
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    peak = bf16_peak_tflops(card)
    if peak is None:
        print(f"[telemetry] no peak rate for {card!r} in telemetry/flops.py: "
              "tel_mfu left out")
    return stack.enter_context(StepTelemetry(
        args.telemetry_jsonl, sample_every=args.telemetry_every,
        flops_per_image=(train_step_flops_per_image(cfg) if cfg is not None
                         else None), peak_tflops=peak,
        watchdog=watchdog, profiler=profiler))


def eval_only(args, state, checkpointer, eval_batches, logger,
              telemetry=None) -> dict:
    """Score a saved model: the latest checkpoint, else the final/
    export; one eval pass, printed and logged."""
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
        src = f"checkpoint step {state.step}"
    else:
        final = Path(args.checkpoint_dir) / "final"
        if not final.is_dir():
            raise SystemExit(f"--eval-only: no checkpoints and no final/ "
                             f"export under {args.checkpoint_dir}")
        state.model.load_state_dict(
            load_model(final, state.model.state_dict()))
        src = "final/ params export"
    m = engine.evaluate(
        state, eval_batches,
        on_batch=telemetry.heartbeat if telemetry is not None else None)
    print(f"eval ({src}) | test_loss: {m['loss']:.4f} | "
          f"test_acc: {m['acc']:.4f} | examples: {int(m['count'])}")
    if logger:
        logger.log(step=state.step, epoch=0, test_loss=m["loss"],
                   test_acc=m["acc"])
    return {"train_loss": [], "train_acc": [], "test_loss": [m["loss"]],
            "test_acc": [m["acc"]]}


def cli() -> None:
    """Console-script entry point: discard main()'s results dict so the
    ``sys.exit(cli())`` wrapper exits 0 on success."""
    main()


if __name__ == "__main__":
    main()
