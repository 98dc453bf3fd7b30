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
ported yet (multihost and elastic runs, the compile cache) are parsed and
refused with ``... not yet ported (ROADMAP Queue 1 item N)`` when given a
value other than their default. ``--tensorboard-dir`` writes every
numeric metric as a TensorBoard scalar (tensorboardX, imported only then).

A data x tensor x sequence x pipeline mesh (``--mesh-data D --mesh-model
M --mesh-seq S --mesh-pipe P [--pipe-microbatches K] [--sp-impl
ring|ulysses]``; ``--mesh-data -1``, the default, is every remaining card)
runs the same command on D x M x S x P ranks::

    python -m pytorch_vit_paper_replication_tpu_torch.train --synthetic \
        --mesh-data 2 --mesh-model 2 --mesh-pipe 2 --grad-accum 2 \
        --checkpoint-dir runs/mesh

    # the token axis over 2 ranks: an even token count (--pool gap), no
    # pipe axis
    python -m pytorch_vit_paper_replication_tpu_torch.train --synthetic \
        --pool gap --mesh-data 2 --mesh-seq 2 --sp-impl ulysses

This process is the launcher: it makes the JAX CLI's mesh checks, the
initial weights, then starts one rank process per device
(``parallel.spawn``: NCCL when every rank has a card of its own, gloo
when they share one), each holding its slices (``parallel/``). Rank 0
alone prints, logs, serves the sinks and writes files; checkpoints and
``final/`` are gathered to it in the one-card format, so one card resumes
a mesh run and the one-card ``predict`` and ``serve`` read its export.
Every rank decodes the whole global batch and keeps its data slice. A
rank that fails (or whose ``--watchdog-s`` fires) fails the run with its
traceback. ``--metrics-port``
serves the registry as Prometheus text on ``/metrics``; ``--ship-to
HOST:PORT`` pushes registry frames (role ``train``) to a fleet aggregator
every ``--ship-interval-s``, one last frame at exit.

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
import copy
import importlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from . import engine
from .checkpoint import (Checkpointer, MeshCheckpointer, load_model,
                         save_model)
from .configs import PRESETS, MeshConfig, TrainConfig, ViTConfig
from .convert import rank_local_params, seeded_state
from .data import (create_dataloaders, make_fake_cifar10,
                   make_synthetic_image_folder, pad_batch)
from .data.image_folder import prefetch_to_device
from .data.transforms import make_transform
from .metrics import MetricsLogger
from .models import TinyVGG, ViT
from .optim import head_only_label_fn, make_lr_schedule, make_optimizer
from .parallel import (from_rank0, gather_state_dict, make_pipeline_apply,
                       make_parallel_eval_step, make_parallel_train_step,
                       mesh_layout, scatter_from_rank0, shard_batch,
                       shard_train_state, spawn, validate_mesh_for_config,
                       validate_pipeline)
from .predictions import resolve_device, write_model_meta
from .telemetry.profiling import parse_profile_steps
from .transfer import init_from_pretrained
from .utils.atomic import atomic_write_json
from .utils.model_summary import count_params
from .utils.plotting import plot_loss_curves
from .utils.seeding import set_seeds

# Flags of the JAX CLI whose path the port does not have yet, by the
# ROADMAP Queue 1 item that brings it. Parsed with the JAX defaults; any
# other value exits non-zero.
NOT_PORTED: Dict[str, int] = {
    "compile_cache_dir": 9,
    "elastic": 7, "elastic_backend": 7, "elastic_heartbeat_s": 7,
    "elastic_timeout_s": 7, "elastic_rejoin_s": 7,
    "elastic_local_devices": 7, "elastic_rendezvous": 7,
    "elastic_worker_id": 7, "elastic_process_count": 7,
    "elastic_generation": 7, "elastic_collective": 7,
    "multihost": 7,
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
                       help="sequence-parallel strategy for --mesh-seq>1: "
                            "'ring' rotates K/V around the ring of seq "
                            "ranks (O(T*T/K) memory); 'ulysses' re-shards "
                            "tokens->heads with two all_to_alls (needs "
                            "heads %% seq == 0)")
    model.add_argument("--mlp-impl", default="auto",
                       choices=["auto", "fused", "xla"],
                       help="fused = the CUDA LN+MLP+residual kernel; "
                            "auto = fused on the card")
    model.add_argument("--pool", default="cls", choices=["cls", "gap"],
                       help="classifier pooling; 'gap' drops the CLS token "
                            "(even token count: required for --mesh-seq on "
                            "typical shapes)")
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
    dist.add_argument("--mesh-seq", type=int, default=1,
                      help="sequence parallelism (attention over the token "
                           "axis sharded over the seq ranks, --sp-impl)")
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
                     help="write TensorBoard scalars here (needs "
                          "tensorboardX)")
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
                     help="serve the telemetry registry as Prometheus "
                          "text on http://127.0.0.1:PORT/metrics (stdlib "
                          "HTTP; 0 = pick a free port). Default: off")
    obs.add_argument("--ship-to", type=str, default=None,
                     metavar="HOST:PORT",
                     help="push registry snapshots to a fleet aggregator "
                          "every --ship-interval-s (a dead aggregator "
                          "costs dropped frames, never a stalled step)")
    obs.add_argument("--ship-interval-s", type=float, default=2.0,
                     help="shipper cadence for --ship-to")
    obs.add_argument("--worker-id", type=str, default=None,
                     help="identity in the fleet view (default "
                          "train-<host>-<pid>)")
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


def materialize_synthetic(args) -> argparse.Namespace:
    """``--synthetic``: make the image folder (or the fake CIFAR-10) once,
    before the run splits into one card or a mesh, and return args that
    name its directories (every mesh rank reads the same files)."""
    if not args.synthetic or args.dataset == "packed":
        return args
    args = copy.copy(args)
    if args.dataset == "cifar10":
        args.data_root = str(make_fake_cifar10(
            Path(tempfile.mkdtemp(prefix="cifar_fake_"))))
    else:
        train_dir, test_dir = make_synthetic_image_folder(
            Path(tempfile.mkdtemp(prefix="vit_synth_")),
            train_per_class=args.synthetic_per_class,
            test_per_class=max(1, args.synthetic_per_class // 4),
            image_size=args.image_size, noise_sigma=args.synthetic_noise)
        args.train_dir, args.test_dir = str(train_dir), str(test_dir)
    args.synthetic = False
    return args


def folder_loaders(args, loader_kwargs: dict, transform_spec: dict):
    """(train, test, classes) of ``--dataset imagefolder``."""
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
    ``--data-root`` (``--synthetic`` puts a seeded fake one there), resized
    per item to ``--image-size``. transform.json records that plain square
    resize."""
    from .data import DataLoader, ResizedArrayDataset, load_cifar10
    transform_spec["pretrained"] = False
    if not args.data_root:
        raise SystemExit("--data-root required for --dataset cifar10 (or "
                         "pass --synthetic)")
    root = args.data_root
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


def mesh_request(args) -> Optional[MeshConfig]:
    """The mesh of ``--mesh-data/-model/-seq/-pipe``, None for a world of
    one process. ``--mesh-data -1`` is every remaining card under
    ``--device cuda`` (the card count over model x seq x pipe, at least
    1), 1 on any other device."""
    model, seq, pipe = (max(1, args.mesh_model), max(1, args.mesh_seq),
                        max(1, args.mesh_pipe))
    data = args.mesh_data
    if data == -1:
        data = (max(1, torch.cuda.device_count() // (model * seq * pipe))
                if args.device == "cuda" else 1)
    if data < 1:
        raise SystemExit(f"--mesh-data must be -1 (every remaining card) "
                         f"or >= 1, got {args.mesh_data}")
    if data * model * seq * pipe == 1:
        return None
    return MeshConfig(data=data, model=model, seq=seq, pipe=pipe)


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    # A typo'd window or address must fail before the data and model
    # set-up.
    if args.profile_steps:
        try:
            parse_profile_steps(args.profile_steps)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.ship_to:
        from .telemetry.shipper import parse_address
        try:
            parse_address(args.ship_to)
        except ValueError as e:
            raise SystemExit(f"--ship-to: {e}")
    mesh_cfg = mesh_request(args)
    args = materialize_synthetic(args)
    if mesh_cfg is not None:
        return launch(args, mesh_cfg)
    return run(args)


def make_model(args, cfg: Optional[ViTConfig], num_classes: int):
    """The whole model of ``--model`` (TinyVGG, or ViT on ``cfg``)."""
    if cfg is None:
        return TinyVGG(hidden_units=args.hidden_units,
                       num_classes=num_classes, dtype=args.dtype,
                       image_size=args.image_size)
    return ViT(cfg)


def prepare(args, mesh=None) -> SimpleNamespace:
    """Everything the run decides before it builds the model: the loaders,
    the teacher rows, the model config and the step counts, with every
    check of the flags against the data and the mesh (the JAX CLI's, in
    its order and with its messages). ``mesh`` is a rank's
    :class:`.parallel.Mesh` or the launcher's layout of one."""
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

    # Model config -----------------------------------------------------------
    if args.model == "tinyvgg":
        # Reference script-entry parity (going_modular train.py:39-43).
        if args.pretrained or args.freeze_backbone:
            raise SystemExit(
                "--pretrained/--freeze-backbone apply to ViT only")
        if args.mesh_model != 1 or args.mesh_seq != 1:
            raise SystemExit("--model tinyvgg supports data parallelism "
                             "only (no TP/SP shardings for a 2-block CNN)")
        cfg = None
        model_name = f"TinyVGG({args.hidden_units})"
    else:
        cfg = PRESETS[args.preset](num_classes=len(class_names), **cfg_kwargs)
        model_name = args.preset

    # Mesh -------------------------------------------------------------------
    microbatches = 1
    if mesh is not None:
        if args.batch_size % mesh.shape["data"] != 0:
            raise SystemExit(
                f"--batch-size {args.batch_size} not divisible by the mesh "
                f"'data' axis size {mesh.shape['data']}")
        if cfg is not None:
            validate_mesh_for_config(cfg, mesh)
        if mesh.shape["pipe"] > 1:
            if cfg is None:
                raise SystemExit("--mesh-pipe applies to --model vit only")
            microbatches = args.pipe_microbatches or mesh.shape["pipe"]
            try:
                validate_pipeline(cfg, mesh, microbatches, args.batch_size)
            except ValueError as e:
                raise SystemExit(str(e))

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
    return SimpleNamespace(
        train_dl=train_dl, test_dl=test_dl, class_names=class_names,
        distill_rows=distill_rows, cfg=cfg, model_name=model_name,
        transform_spec=transform_spec, microbatches=microbatches,
        steps_per_epoch=steps_per_epoch, total_steps=total_steps,
        accum=accum)


def run(args, mesh=None, init: Optional[Dict[str, torch.Tensor]] = None
        ) -> dict:
    """The CLI's run in this process: on one device, or as one rank of a
    mesh (``mesh`` the rank's :class:`.parallel.Mesh`, ``init`` the whole
    model's initial params from the launcher). A rank holds its slices;
    rank 0 alone logs, writes files and serves the sinks, every rank runs
    the watchdog."""
    profile_window = (parse_profile_steps(args.profile_steps)
                      if args.profile_steps else None)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    s = prepare(args, mesh)
    cfg, train_dl, test_dl = s.cfg, s.train_dl, s.test_dl

    # Model + state ---------------------------------------------------------
    if mesh is not None and cfg is not None:
        # Every ViT mesh (dp-only too) runs the pipelined model, with one
        # stage when the pipe axis is 1.
        model = make_pipeline_apply(cfg, mesh,
                                    num_microbatches=s.microbatches)
    else:
        model = make_model(args, cfg, len(s.class_names))
    if mesh is not None:
        model.load_state_dict(rank_local_params(init, mesh))
        if args.pretrained:
            print(f"initialized backbone from {args.pretrained}")
    elif args.pretrained:
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
    accum, steps_per_epoch, total_steps = (s.accum, s.steps_per_epoch,
                                           s.total_steps)
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
        if args.checkpoint_every_steps:
            print(f"note: --checkpoint-every-steps counts MICRO-steps — "
                  f"{args.checkpoint_every_steps} micro-steps = "
                  f"{args.checkpoint_every_steps / accum:g} optimizer "
                  f"updates at this accumulation")
    state = engine.TrainState.create(model=model, tx=tx, seed=args.seed)
    distill_alpha = args.distill_alpha if args.distill_from else None
    eval_step = None
    if mesh is None:
        print(f"model: {s.model_name} | params: "
              f"{count_params(model.state_dict()):,} | device: {dev}")
        train_step = engine.make_train_step(
            label_smoothing=args.label_smoothing, nan_guard=args.nan_guard,
            distill_alpha=distill_alpha, distill_t=args.distill_t)
    else:
        print(f"model: {s.model_name} | params: {count_params(init):,} | "
              f"mesh: {dict(mesh.shape)} | ranks: {mesh.world} | device: "
              f"{dev}")
        if mesh.shape["pipe"] > 1:
            print(f"pipeline: {mesh.shape['pipe']} stages x "
                  f"{cfg.num_layers // mesh.shape['pipe']} layers, "
                  f"{s.microbatches} microbatches")
        state = shard_train_state(state, mesh)
        if mesh.shape["seq"] > 1:
            print(f"sequence parallelism: {mesh.shape['seq']} ranks x "
                  f"{cfg.seq_len // mesh.shape['seq']} tokens, "
                  f"{args.sp_impl} attention")
        train_step = make_parallel_train_step(
            state, mesh, label_smoothing=args.label_smoothing,
            nan_guard=args.nan_guard, sp_impl=args.sp_impl,
            distill_alpha=distill_alpha, distill_t=args.distill_t)
        eval_step = make_parallel_eval_step(state, mesh,
                                            sp_impl=args.sp_impl)

    checkpointer = None
    if args.checkpoint_dir:
        ck_kwargs = dict(max_to_keep=args.keep_checkpoints,
                         async_save=not args.sync_checkpoints)
        checkpointer = (Checkpointer(args.checkpoint_dir, **ck_kwargs)
                        if mesh is None else
                        MeshCheckpointer(args.checkpoint_dir, mesh,
                                         **ck_kwargs))
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

        def resume_check():
            if meta_path.is_file():
                check_resume(json.loads(meta_path.read_text()), args,
                             steps_per_epoch, total_steps, accum,
                             skip_batches)
        if mesh is None:
            resume_check()
        else:
            # Rank 0 alone reads run_meta.json (it rewrites it below).
            from_rank0(mesh, resume_check)
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
    if meta_path is not None and not args.eval_only and lead:
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

    distill_rows = s.distill_rows

    def with_teacher():
        for b in train_dl:
            # This batch's teacher rows by dataset ordinal: a [B, C]
            # fancy-index copy out of the read-only sink memmap, sent to
            # the card with the batch (on a mesh, sharded like it).
            b["teacher_logits"] = distill_rows[b.pop("index")]
            yield b

    # Every rank reads and decodes the whole global batch (the loaders are
    # the one-card ones) and keeps its data slice.
    shards = mesh.shape["data"] if mesh is not None else 1

    def on_rank(batches):
        if mesh is None:
            return batches
        return (shard_batch(b, mesh) for b in batches)

    def train_batches():
        return prefetch_to_device(on_rank(
            train_dl if distill_rows is None else with_teacher()), device=dev)

    # Ragged eval batches pad to the data axis times the microbatch count
    # (a pipeline splits each shard into microbatches); the mask keeps the
    # metrics example-exact.
    eval_pad = shards * s.microbatches

    def eval_batches():
        return prefetch_to_device(on_rank(
            pad_batch(b, eval_pad) for b in test_dl), device=dev)

    with contextlib.ExitStack() as stack:
        if checkpointer is not None:
            # Every exit path waits for the save in flight (and raises its
            # error); the writer thread is not a daemon either.
            stack.callback(checkpointer.wait)
        # On a mesh rank 0 alone writes the JSONL and the events.
        logger = (stack.enter_context(MetricsLogger(
            args.metrics_jsonl, tb_dir=args.tensorboard_dir))
            if (args.metrics_jsonl or args.tensorboard_dir) and lead
            else None)
        telemetry = make_telemetry(args, cfg, dev, profile_window, stack,
                                   mesh)
        if lead:
            start_sinks(args, stack)
        if args.eval_only:
            return eval_only(args, state, checkpointer, eval_batches, logger,
                             telemetry, eval_step=eval_step, mesh=mesh,
                             template=lambda: make_model(
                                 args, cfg, len(s.class_names)))
        lr_sched = make_lr_schedule(train_cfg, max(1, total_steps // accum))
        state, results = engine.train(
            state, train_batches, eval_batches, epochs=epochs_to_run,
            train_step=train_step, eval_step=eval_step, logger=logger,
            checkpointer=checkpointer, verbose=lead,
            profile_dir=args.profile_dir if lead else None,
            start_epoch=done_epochs,
            checkpoint_every_steps=args.checkpoint_every_steps,
            checkpoint_every_epochs=args.checkpoint_every_epochs,
            lr_schedule=lambda step: lr_sched(step // accum),
            telemetry=telemetry, batch_shards=shards)

    if args.checkpoint_dir:
        # The params-only export the port's predict and serve CLIs load,
        # with the transform decision and the model identity beside it; a
        # mesh run's is gathered to rank 0 in the standard layout.
        params = (state.model.state_dict() if mesh is None else
                  gather_state_dict(state.model.state_dict(), mesh))
        if lead:
            ckpt = Path(args.checkpoint_dir)
            save_model(params, ckpt, "final")
            atomic_write_json(ckpt / "transform.json", s.transform_spec)
            if cfg is not None:
                write_model_meta(ckpt, cfg, extra={"preset": args.preset})
    if args.plot and lead:
        plot_loss_curves(results, save_path=args.plot)
    return results


# How long one collective or transfer of a mesh rank may wait for the
# others before the run fails (the join itself waits while the ranks live).
COLLECTIVE_TIMEOUT_S = 300.0


def launch_counts() -> Dict[str, int]:
    """This process's launch counters of the hand-written kernels."""
    from .ops import flash_attention as fa
    from .ops import fused_mlp
    return {"fused_ln_mlp_residual": fused_mlp.launches,
            "fused_ln_mlp_residual_bwd": fused_mlp.bwd_launches,
            "fused_mlp_core": fused_mlp.core_launches,
            "fused_mlp_core_bwd": fused_mlp.core_bwd_launches,
            "flash_attention": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches}


def launch(args, mesh_cfg: MeshConfig) -> dict:
    """The CLI on a mesh: the JAX CLI's checks, the initial weights made
    once here (``initial_params`` or ``--pretrained``), then one rank
    process per device (:func:`.parallel.spawn`), each running
    :func:`run` on its slices. Returns rank 0's results with two keys
    of the port's own: ``rank_launches``, each rank's kernel launch
    counts, and ``rank_results``, each rank's results (the global metrics,
    equal on every rank). A failed rank exits non-zero with its
    traceback; no rank is left running."""
    from .parallel.mesh import backend_for, describe_transport
    dev = resolve_device(args.device)
    world = mesh_cfg.data * mesh_cfg.model * mesh_cfg.seq * mesh_cfg.pipe
    with contextlib.redirect_stdout(io.StringIO()):
        s = prepare(args, mesh_layout(mesh_cfg, world))
    if args.pretrained:
        init = init_from_pretrained(s.cfg, args.pretrained)
    else:
        with torch.device("meta"):
            shapes = make_model(args, s.cfg, len(s.class_names))
        init = initial_params(shapes, args.seed)
    backend = backend_for(dev.type, world)
    print(f"mesh: data {mesh_cfg.data} x model {mesh_cfg.model} x seq "
          f"{mesh_cfg.seq} x pipe {mesh_cfg.pipe}: {world} rank processes "
          f"on {dev.type}, "
          f"transport {describe_transport(backend, dev.type)}", flush=True)
    rank_fn = importlib.import_module(f"{__package__}.train")._mesh_rank
    try:
        ranks = spawn(rank_fn, mesh_cfg, device=dev.type,
                      timeout_s=COLLECTIVE_TIMEOUT_S, wait_while_alive=True,
                      args=(args, init))
    except RuntimeError as e:
        raise SystemExit(f"mesh run failed: {e}")
    return {**ranks[0]["results"],
            "rank_launches": [r["launches"] for r in ranks],
            "rank_results": [r["results"] for r in ranks]}


def _mesh_rank(mesh, args, init) -> dict:
    """One rank of a mesh run: :func:`run` on the rank's slices, its
    standard output kept by rank 0 alone."""
    with contextlib.ExitStack() as stack:
        if mesh.rank != 0:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        results = run(args, mesh=mesh, init=init)
    return {"results": results, "launches": launch_counts()}


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
                   profile_window, stack: contextlib.ExitStack, mesh=None):
    """The run's :class:`..telemetry.StepTelemetry` (None when no
    telemetry, watchdog, profiling or sink flag is given), with its
    watchdog and profile controller; each is closed by ``stack``.
    ``tel_mfu`` takes the card's bf16 peak from :mod:`..telemetry.flops`;
    a card the table lacks (or the CPU) gets one printed line and no MFU
    gauge, and so does TinyVGG (``cfg`` None: no FLOP count).

    On a mesh rank 0 alone writes the rows and profiles, and its MFU
    divides by the peak of the distinct cards the ranks run on (one when
    they share a card); every rank runs the watchdog, and a stall on any
    rank ends that rank's process, which fails the run."""
    lead = mesh is None or mesh.rank == 0
    if not ((lead and (args.telemetry_jsonl or args.profile_steps
                       or args.profile_auto or args.ship_to
                       or args.metrics_port is not None))
            or args.watchdog_s > 0):
        return None
    from .telemetry import (ProfileController, StepTelemetry, Watchdog,
                            bf16_peak_tflops, train_step_flops_per_image)
    run_dir = (Path(args.checkpoint_dir) if args.checkpoint_dir
               else Path(args.telemetry_jsonl).parent
               if args.telemetry_jsonl else Path("."))
    watchdog = None
    if args.watchdog_s > 0:
        pm = args.postmortem or str(run_dir / "postmortem.txt")
        on_stall = None
        if mesh is not None:
            if mesh.rank:
                pm = str(Path(pm).with_suffix(f".rank{mesh.rank}.txt"))
            on_stall = _end_stalled_rank(mesh.rank)
        watchdog = Watchdog(args.watchdog_s, postmortem_path=pm,
                            on_stall=on_stall)
        watchdog.install_sigterm()
        stack.callback(watchdog.stop)
        watchdog.start()
        print(f"watchdog: deadline {args.watchdog_s:g}s, postmortem -> {pm}")
    if not lead:
        return stack.enter_context(StepTelemetry(
            None, sample_every=args.telemetry_every, watchdog=watchdog))
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
    elif mesh is not None and mesh.backend == "nccl":
        peak *= mesh.world           # one card per rank
    return stack.enter_context(StepTelemetry(
        args.telemetry_jsonl, sample_every=args.telemetry_every,
        flops_per_image=(train_step_flops_per_image(cfg) if cfg is not None
                         else None), peak_tflops=peak,
        watchdog=watchdog, profiler=profiler))


def _end_stalled_rank(rank: int):
    """The watchdog's stall action on a mesh rank: after the postmortem,
    end the process, so the launcher fails the run (the other ranks would
    otherwise wait on it in their collectives)."""
    def on_stall(path: Path) -> None:
        print(f"rank {rank}: watchdog stall, postmortem {path}; ending the "
              "rank", file=sys.stderr, flush=True)
        os._exit(STALL_EXIT_CODE)
    return on_stall


# The exit code of a mesh rank that its watchdog ended.
STALL_EXIT_CODE = 75


def start_sinks(args, stack: contextlib.ExitStack) -> None:
    """``--metrics-port`` (the registry on ``/metrics``) and ``--ship-to``
    (registry frames, role ``train``), each stopped by ``stack``; the
    shipper sends one last frame when it closes."""
    if args.metrics_port is not None:
        from .telemetry import start_metrics_http
        http_srv = start_metrics_http(port=args.metrics_port)
        stack.callback(http_srv.server_close)
        stack.callback(http_srv.shutdown)
        print(f"metrics: http://127.0.0.1:{http_srv.server_address[1]}"
              f"/metrics")
    if args.ship_to:
        from .telemetry import TelemetryShipper
        shipper = TelemetryShipper(
            args.ship_to, worker_id=args.worker_id, role="train",
            interval_s=args.ship_interval_s)
        stack.callback(shipper.close)
        shipper.start()
        print(f"telemetry shipper: {shipper.worker_id} -> {args.ship_to} "
              f"every {args.ship_interval_s:g}s")


def eval_only(args, state, checkpointer, eval_batches, logger,
              telemetry=None, *, eval_step=None, mesh=None,
              template=None) -> dict:
    """Score a saved model: the latest checkpoint, else the final/
    export; one eval pass, printed and logged. On a mesh, rank 0 reads the
    export and sends every rank its slices (``template()``: the whole
    model, whose names and shapes the export must have)."""
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
        src = f"checkpoint step {state.step}"
    else:
        final = Path(args.checkpoint_dir) / "final"
        if not final.is_dir():
            raise SystemExit(f"--eval-only: no checkpoints and no final/ "
                             f"export under {args.checkpoint_dir}")
        if mesh is None:
            params = load_model(final, state.model.state_dict())
        else:
            full = None
            if mesh.rank == 0:
                try:
                    with torch.device("meta"):
                        shapes = template().state_dict()
                    full = {"params": load_model(final, shapes)}
                except Exception as e:  # noqa: BLE001 — raised everywhere
                    full = e
            params = scatter_from_rank0(full, mesh)["params"]
        state.model.load_state_dict(params)
        src = "final/ params export"
    m = engine.evaluate(
        state, eval_batches, eval_step=eval_step,
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
