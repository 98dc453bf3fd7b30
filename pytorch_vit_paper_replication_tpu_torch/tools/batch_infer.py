"""Offline batch inference over a packed-shard dataset, every visible card
(the port's counterpart of the repo's ``tools/batch_infer.py``).

Streams a ``data.pack`` output through :class:`..serve.offline.
OfflineEngine`: the bucketed forward on one replica per CUDA device,
double-buffered host-to-device copies, the sequential scan's page-cache
discipline (readahead + evict-behind, no shuffle) and an atomic progress
manifest, so a killed run resumes where it durably left off and its final
sink is byte-identical to an unkilled run's. Outputs land in a pre-sized
``outputs.npy``: softmax probs, pooled ``[D]`` embeddings with ``--head
features``, or pre-softmax classifier activations with ``--head logits``
(the distillation dataset); ``--preds-jsonl`` mirrors the classifier's
predictions one JSON line per record. Usage::

    python -m pytorch_vit_paper_replication_tpu_torch.tools.batch_infer \\
        PACK_DIR --checkpoint runs/ckpt --classes-file labels.txt \\
        --out runs/embed --head features

Re-running the same command against the same ``--out`` resumes from the
manifest; ``--fresh`` restarts from record 0. Runs on every visible CUDA
device unless ``--device`` names one (``cpu`` runs the kernels' plain
versions). ``--ship-to HOST:PORT`` ships the ``bi_*`` telemetry in
frames (role ``batch_infer``) to a fleet aggregator while the sweep runs;
``--compile-cache-dir`` is parsed and refused: not ported yet.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def run_job(args) -> dict:
    """The job: checkpoint + pack -> ``OfflineEngine.run`` -> the summary
    (printed as one JSON line and saved as ``summary.json``)."""
    from ..data.imagenet import PackedShardDataset, eval_center_transform
    from ..predictions import load_class_names, load_inference_checkpoint
    from ..serve.bucketing import DEFAULT_BUCKETS
    from ..serve.offline import OfflineEngine, sink_sha256

    class_names = (load_class_names(args.classes_file)
                   if args.classes_file else None)
    n_classes = (len(class_names) if class_names is not None
                 else args.num_classes)
    if n_classes is None:
        raise SystemExit("pass --classes-file or --num-classes (the "
                         "checkpoint's head size is needed to load its "
                         "params, even for --head features)")
    # cuda: every visible CUDA device (the engine's default); any other
    # name: that one device.
    devices = None if args.device == "cuda" else [args.device]
    # The one inference-load contract (transform.json over the flags), so
    # batch inference preprocesses pixels as predict and serve do.
    model, _, spec = load_inference_checkpoint(
        args.checkpoint, args.preset, n_classes, image_size=args.image_size,
        normalize=False if args.no_normalize else None,
        device=args.device if devices else "cuda:0")
    engine = OfflineEngine(
        model, head=args.head, image_size=spec["image_size"],
        buckets=tuple(args.buckets) if args.buckets else DEFAULT_BUCKETS,
        prefetch=args.prefetch, class_names=class_names, devices=devices)
    # Records are resize-shorter'd at pack time: the array-space eval
    # transform center-crops them; the streaming readahead pages blocks
    # in and out, so no whole-pack startup hint.
    dataset = PackedShardDataset(
        args.pack, eval_center_transform(spec["image_size"],
                                         normalize=spec["normalize"]),
        startup_readahead=False)
    shipper = None
    if args.ship_to:
        from ..telemetry.shipper import TelemetryShipper
        shipper = TelemetryShipper(
            args.ship_to, worker_id=args.worker_id, role="batch_infer",
            interval_s=args.ship_interval_s).start()
        print(f"[batch_infer] telemetry shipper: {shipper.worker_id} -> "
              f"{args.ship_to} every {args.ship_interval_s:g}s")
    try:
        summary = engine.run(
            dataset, args.out, batch_size=args.batch_size,
            resume=not args.fresh, limit=args.limit,
            num_workers=args.num_workers, worker_type=args.worker_type,
            readahead=args.readahead, evict_behind=not args.no_evict_behind,
            checkpoint_every_records=args.checkpoint_every_records,
            checkpoint_every_s=args.checkpoint_every_s,
            preds_jsonl=args.preds_jsonl)
    finally:
        if shipper is not None:
            shipper.close()
    summary["device"] = [str(d) for d in engine.devices]
    if args.sha256:
        summary["sink_sha256"] = sink_sha256(summary["sink"])
    line = json.dumps({"metric": "batch_infer", **summary})
    print(line)
    (Path(args.out) / "summary.json").write_text(line + "\n")
    return summary


def build_parser() -> argparse.ArgumentParser:
    from ..serve.offline import OFFLINE_HEADS

    p = argparse.ArgumentParser(
        description="Offline batch inference: sweep a packed-shard "
                    "dataset through every visible card, resumably",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("pack", help="data.pack output directory")
    p.add_argument("--checkpoint", required=True,
                   help="the port's export dir (params.npz) or a training "
                        "--checkpoint-dir holding final/")
    p.add_argument("--out", required=True,
                   help="output directory (outputs.npy + progress.json "
                        "land here; re-running resumes from the manifest)")
    cls = p.add_mutually_exclusive_group()
    cls.add_argument("--classes-file",
                     help="one class name per line (training order)")
    cls.add_argument("--num-classes", type=int, default=None,
                     help="head size when names don't matter")
    p.add_argument("--preset", default="ViT-B/16")
    p.add_argument("--head", choices=sorted(OFFLINE_HEADS), default="probs",
                   help="; ".join(f"{k} = {v}"
                                  for k, v in OFFLINE_HEADS.items()))
    p.add_argument("--image-size", type=int, default=None,
                   help="defaults to the checkpoint's transform.json")
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--batch-size", type=int, default=None,
                   help="loader batch (default: top ladder rung)")
    p.add_argument("--buckets", type=int, nargs="+", default=None,
                   help="bucket ladder (default: the serve ladder, "
                        "rounded up to device-count multiples)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="chunks in flight (2 = double-buffered)")
    p.add_argument("--readahead", type=int, default=2,
                   help="shard blocks to page in ahead of the sweep "
                        "(0 = off)")
    p.add_argument("--no-evict-behind", action="store_true",
                   help="keep swept blocks in the page cache")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--worker-type", choices=["thread", "process"],
                   default="thread")
    p.add_argument("--fresh", action="store_true",
                   help="ignore an existing progress manifest and "
                        "restart from record 0")
    p.add_argument("--limit", type=int, default=None,
                   help="stop after N records (smoke runs)")
    p.add_argument("--checkpoint-every-records", type=int, default=None,
                   help="manifest cadence in records (default 32 "
                        "batches)")
    p.add_argument("--checkpoint-every-s", type=float, default=30.0)
    p.add_argument("--preds-jsonl", action="store_true",
                   help="also write preds.jsonl (probs head only)")
    p.add_argument("--sha256", action="store_true",
                   help="hash the final sink into the printed summary (the "
                        "completed job's progress.json always records "
                        "sink_sha256)")
    p.add_argument("--device", default="cuda",
                   help="cuda = every visible CUDA device; a device name "
                        "(cuda:1, cpu) = that one")
    p.add_argument("--ship-to", default=None, metavar="HOST:PORT",
                   help="ship bi_* telemetry frames to a fleet aggregator")
    p.add_argument("--ship-interval-s", type=float, default=2.0)
    p.add_argument("--worker-id", default=None)
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="(not ported)")
    return p


# Flags of the JAX CLI whose path the port does not have yet, by the
# ROADMAP Queue 1 item that brings it.
NOT_PORTED = {"compile_cache_dir": 9}


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, item in NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not yet ported (ROADMAP Queue 1 "
                             f"item {item})")
    if args.ship_to:
        from ..telemetry.shipper import parse_address
        try:
            parse_address(args.ship_to)
        except ValueError as e:
            raise SystemExit(f"--ship-to: {e}")
    return run_job(args)


if __name__ == "__main__":
    main()
