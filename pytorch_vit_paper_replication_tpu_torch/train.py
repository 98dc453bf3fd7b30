"""CLI training entry point (port of the JAX package's ``train.py``).

One command trains a preset on an image-folder dataset on one CUDA card,
with checkpoints, mid-epoch resume and JSONL metrics::

    python -m pytorch_vit_paper_replication_tpu_torch.train \\
        --train-dir data/pizza_steak_sushi/train \\
        --test-dir data/pizza_steak_sushi/test \\
        --preset ViT-B/16 --epochs 10 --batch-size 32 \\
        --checkpoint-dir runs/vit --metrics-jsonl runs/vit/m.jsonl

    # no dataset handy (or offline): --synthetic generates one
    python -m pytorch_vit_paper_replication_tpu_torch.train --synthetic \\
        --preset ViT-Ti/16 --image-size 64 --epochs 2

It runs on ``cuda`` unless ``--device cpu`` is given (then the kernels'
plain PyTorch versions run); without a card it raises ``no CUDA device``.
The flags keep the JAX CLI's names, defaults and semantics. Those whose
path is not ported yet (packed and CIFAR data, transfer, distillation,
elastic and multi-card meshes, telemetry, profiling, the compile cache)
are parsed and refused with ``... not yet ported (ROADMAP Queue 1 item
N)`` when given a value other than their default.

A finished run leaves ``final/params.npz``, ``transform.json`` and
``model_meta.json`` under ``--checkpoint-dir``: the layout the port's
``predict`` and ``serve`` CLIs load.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
from pathlib import Path
from typing import Dict

import torch

from . import engine
from .checkpoint import Checkpointer, load_model, save_model
from .configs import PRESETS, TrainConfig, ViTConfig
from .convert import seeded_params
from .data import create_dataloaders, make_synthetic_image_folder, pad_batch
from .data.image_folder import prefetch_to_device
from .data.transforms import make_transform
from .metrics import MetricsLogger
from .models import ViT
from .optim import make_lr_schedule, make_optimizer
from .predictions import resolve_device, write_model_meta
from .utils.atomic import atomic_write_json
from .utils.model_summary import count_params
from .utils.plotting import plot_loss_curves
from .utils.seeding import set_seeds

# Flags of the JAX CLI whose path the port does not have yet, by the
# ROADMAP Queue 1 item that brings it. Parsed with the JAX defaults; any
# other value exits non-zero (--mesh-data is checked on its own: -1 and 1
# both mean the one card).
NOT_PORTED: Dict[str, int] = {
    "dataset": 2, "data_root": 2, "no_augment": 2,
    "model": 8, "hidden_units": 8, "pretrained": 8, "freeze_backbone": 8,
    "distill_from": 9, "distill_t": 9, "distill_alpha": 9,
    "compile_cache_dir": 9,
    "elastic": 7, "elastic_backend": 7, "elastic_heartbeat_s": 7,
    "elastic_timeout_s": 7, "elastic_rejoin_s": 7,
    "elastic_local_devices": 7, "elastic_rendezvous": 7,
    "elastic_worker_id": 7, "elastic_process_count": 7,
    "elastic_generation": 7, "elastic_collective": 7,
    "mesh_model": 7, "mesh_seq": 7, "mesh_pipe": 7, "pipe_microbatches": 7,
    "multihost": 7, "sp_impl": 7,
    "tensorboard_dir": 5, "profile_dir": 5, "telemetry_jsonl": 5,
    "telemetry_every": 5, "watchdog_s": 5, "postmortem": 5,
    "profile_steps": 5, "profile_auto": 5, "profile_auto_pct": 5,
    "profile_trace_dir": 5, "metrics_port": 5, "ship_to": 5,
    "ship_interval_s": 5, "worker_id": 5,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="ViT training (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    data = p.add_argument_group("data")
    data.add_argument("--dataset",
                      choices=["imagefolder", "cifar10", "packed"],
                      default="imagefolder",
                      help="only imagefolder is ported")
    data.add_argument("--train-dir", type=str, default=None)
    data.add_argument("--test-dir", type=str, default=None)
    data.add_argument("--data-root", type=str, default=None,
                      help="for --dataset cifar10 (not ported)")
    data.add_argument("--augment", action="store_true",
                      help="RandomResizedCrop + horizontal-flip train "
                           "augmentation; eval keeps the deterministic "
                           "transform")
    data.add_argument("--no-augment", action="store_true",
                      help="for --dataset packed (not ported)")
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
                      help="hint N upcoming blocks into the page cache "
                           "(datasets with willneed_records; 0 = off)")
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
                       help="tinyvgg is not ported")
    model.add_argument("--hidden-units", type=int, default=10,
                       help="TinyVGG width (not ported)")
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
                       metavar="SINK_DIR", help="(not ported)")
    train.add_argument("--distill-t", type=float, default=2.0,
                       help="(not ported)")
    train.add_argument("--distill-alpha", type=float, default=0.5,
                       help="(not ported)")
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

    transfer = p.add_argument_group("transfer learning (not ported)")
    transfer.add_argument("--pretrained", type=str, default=None)
    transfer.add_argument("--freeze-backbone", action="store_true")

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
                     help="the port's saves are always synchronous")
    out.add_argument("--checkpoint-every-epochs", type=int, default=1,
                     help="save cadence in epochs (the final epoch always "
                          "saves)")
    out.add_argument("--metrics-jsonl", type=str, default=None)
    out.add_argument("--tensorboard-dir", type=str, default=None,
                     help="(not ported)")
    out.add_argument("--plot", type=str, default=None,
                     help="save loss curves PNG here")
    out.add_argument("--profile-dir", type=str, default=None,
                     help="(not ported)")
    out.add_argument("--device", default="cuda",
                     help="torch device (default cuda; 'cpu' runs the "
                          "kernels' plain PyTorch versions)")

    obs = p.add_argument_group("observability (not ported)")
    obs.add_argument("--telemetry-jsonl", type=str, default=None)
    obs.add_argument("--telemetry-every", type=int, default=32)
    obs.add_argument("--watchdog-s", type=float, default=0.0)
    obs.add_argument("--postmortem", type=str, default=None)
    obs.add_argument("--profile-steps", type=str, default=None,
                     metavar="A:B")
    obs.add_argument("--profile-auto", action="store_true")
    obs.add_argument("--profile-auto-pct", type=float, default=25.0)
    obs.add_argument("--profile-trace-dir", type=str, default=None)
    obs.add_argument("--metrics-port", type=int, default=None)
    obs.add_argument("--ship-to", type=str, default=None,
                     metavar="HOST:PORT")
    obs.add_argument("--ship-interval-s", type=float, default=2.0)
    obs.add_argument("--worker-id", type=str, default=None)
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


def initial_params(cfg: ViTConfig, seed: int) -> Dict[str, torch.Tensor]:
    """The run's initial weights, made from the config and ``seed`` (the
    JAX CLI's ``model.init(key(seed), ...)``, whose Flax RNG the port does
    not reproduce)."""
    return seeded_params(cfg, seed)


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
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
    transform_spec = dict(image_size=args.image_size, pretrained=False,
                          normalize=False)
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
    train_dl, test_dl, class_names = create_dataloaders(
        train_dir, test_dir, train_transform, eval_transform=transform,
        drop_last_train=True, cache=args.cache_dataset, **loader_kwargs)
    print(f"classes: {class_names} | train batches/epoch: {len(train_dl)}")

    # Model + state ---------------------------------------------------------
    cfg = PRESETS[args.preset](num_classes=len(class_names), **cfg_kwargs)
    model = ViT(cfg)
    model.load_state_dict(initial_params(cfg, args.seed))
    model.to(dev)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.lr, weight_decay=args.weight_decay,
        warmup_fraction=args.warmup_fraction, grad_clip_norm=args.grad_clip,
        label_smoothing=args.label_smoothing, seed=args.seed)
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
    tx = make_optimizer(train_cfg, max(1, total_steps // accum),
                        grad_accum_steps=accum)
    if accum > 1:
        print(f"gradient accumulation: {accum} micro-batches/update "
              f"(effective batch {args.batch_size * accum})")
    print(f"model: {args.preset} | params: "
          f"{count_params(model.state_dict()):,} | device: {dev}")
    state = engine.TrainState.create(model=model, tx=tx, seed=args.seed)
    train_step = engine.make_train_step(label_smoothing=args.label_smoothing,
                                        nan_guard=args.nan_guard)

    checkpointer = (Checkpointer(args.checkpoint_dir,
                                 max_to_keep=args.keep_checkpoints)
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
        atomic_write_json(meta_path, {
            "steps_per_epoch": steps_per_epoch,
            "global_batch_size": args.batch_size,
            "grad_accum": accum,
            "epochs": args.epochs})

    def train_batches():
        return prefetch_to_device(train_dl, device=dev)

    def eval_batches():
        return prefetch_to_device((pad_batch(b, 1) for b in test_dl),
                                  device=dev)

    with contextlib.ExitStack() as stack:
        logger = (stack.enter_context(MetricsLogger(args.metrics_jsonl))
                  if args.metrics_jsonl else None)
        if args.eval_only:
            return eval_only(args, state, checkpointer, eval_batches, logger)
        lr_sched = make_lr_schedule(train_cfg, max(1, total_steps // accum))
        state, results = engine.train(
            state, train_batches, eval_batches, epochs=epochs_to_run,
            train_step=train_step, logger=logger, checkpointer=checkpointer,
            start_epoch=done_epochs,
            checkpoint_every_steps=args.checkpoint_every_steps,
            checkpoint_every_epochs=args.checkpoint_every_epochs,
            lr_schedule=lambda s: lr_sched(s // accum))

    if args.checkpoint_dir:
        # The params-only export the port's predict and serve CLIs load,
        # with the transform decision and the model identity beside it.
        ckpt = Path(args.checkpoint_dir)
        save_model(state.model.state_dict(), ckpt, "final")
        atomic_write_json(ckpt / "transform.json", transform_spec)
        write_model_meta(ckpt, cfg, extra={"preset": args.preset})
    if args.plot:
        plot_loss_curves(results, save_path=args.plot)
    return results


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


def eval_only(args, state, checkpointer, eval_batches, logger) -> dict:
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
    m = engine.evaluate(state, eval_batches)
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
