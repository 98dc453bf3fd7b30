"""CLI: convert an image folder into packed uint8 shards (port of the JAX
package's ``data/pack.py``; host only, it touches no device).

Usage:
    python -m pytorch_vit_paper_replication_tpu_torch.data.pack \
        <src_image_folder> <out_dir> [--pack-size 256] \
        [--shard-images 4096] [--num-workers N] [--shuffle-seed S]

Run once per split (train/, test/). The output directory is what
``train --dataset packed --train-dir/--test-dir`` consumes; see
:mod:`.imagenet` for the format (the JAX package's, byte for byte).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from .imagenet import pack_image_folder


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(
        description="Pack an image folder into memmap-able uint8 shards")
    p.add_argument("src", help="image-folder root (class-per-subdir)")
    p.add_argument("out", help="output directory for shards + index.json")
    p.add_argument("--pack-size", type=int, default=256,
                   help="stored square size (resize-shorter + center-crop)")
    p.add_argument("--shard-images", type=int, default=4096,
                   help="images per shard file")
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--shuffle-seed", type=int, default=None,
                   help="write records in a seeded random order instead "
                        "of class-major folder order — use for packs "
                        "trained with --shuffle-window, so bounded "
                        "windows see class-uniform batches")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    out = pack_image_folder(
        args.src, args.out, pack_size=args.pack_size,
        images_per_shard=args.shard_images, num_workers=args.num_workers,
        shuffle_seed=args.shuffle_seed)
    from .imagenet import PackedShardDataset
    ds = PackedShardDataset(out)
    dt = time.perf_counter() - t0
    size_mb = sum(f.stat().st_size for f in out.glob("shard-*.bin")) / 1e6
    print(f"packed {len(ds)} images / {len(ds.classes)} classes -> {out} "
          f"({size_mb:.0f} MB, {dt:.1f}s, {len(ds) / dt:.0f} img/s)")
    return out


def cli() -> None:
    """Console-script entry point: discard main()'s Path so the
    pip-generated ``sys.exit(cli())`` wrapper exits 0 on success."""
    main()


if __name__ == "__main__":
    main()
