#!/usr/bin/env python3
"""Wall and device time of the port's ViT-B/16 train step on one card.

For comparing two trees of this repository on the same card::

    python3 step_time.py --root DIR [--steps N] [--attention IMPL]

imports the port from ``DIR`` (default: this script's directory), builds
its kernels, trains ViT-B/16 (224 px, bf16, batch 32, the default
dropouts, seeded params, one seeded batch repeated) through
``engine.make_train_step`` for ``--steps`` steps and prints one JSON line:
the card, the per-step walls (host clock around steps that end in
``torch.cuda.synchronize()``) and their median after the first, the device
time of one ``torch.profiler`` step (kernels and copies) and the host ops
with the most self CPU time in that step. Run two trees in turns in one
call (A, B, B, A) and compare them only within it. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--attention", default="auto",
                    choices=("auto", "flash", "xla"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("step_time: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import (PRESETS,
                                                                 TrainConfig)
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import _build

    _build.build()
    cfg = PRESETS["ViT-B/16"](num_classes=1000,
                              attention_impl=args.attention)
    model = ViT(cfg)
    model.load_state_dict(seeded_params(cfg, 1))
    model.cuda()
    state = engine.TrainState.create(
        model=model, seed=0,
        tx=optim.make_optimizer(TrainConfig(), args.steps + 1))
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((32, 224, 224, 3)).astype(
        np.float32), "label": rng.integers(0, 1000, 32)}
    step = engine.make_train_step()
    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if getattr(e, "device_type", None) == DeviceType.CUDA)
    host = sorted((e for e in events
                   if getattr(e, "device_type", None) == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": args.root, "card": card, "attention": args.attention,
        "wall_ms": walls, "wall_ms_median": statistics.median(walls[1:]),
        "device_ms_profiled_step": device_us / 1e3,
        "host_self_cpu_ms_top": [[e.key[:60], e.self_cpu_time_total / 1e3,
                                  e.count] for e in host]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
