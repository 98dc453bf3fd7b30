#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (ViT-B/16 serving path).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and the
final ``ok`` line is never printed:

1. build   — compile every CUDA kernel of the path from ``csrc/`` (one
             ``nvcc`` per source, started together) and load it.
2. kernels — each kernel against its plain PyTorch version on the card at
             the B/16 serving shapes (bucket 32: N = 32*197 rows for the
             fused MLP; B = 32, H = 12, Dh = 64, T in {197, 577} for
             flash attention), with dropout off and at t = 26 (rate 0.1);
             the dropout keep masks are recovered by feeding ones and must
             be bit-identical. Times come from CUDA events.
3. serve   — a seeded ViT-B/16 export (1000 classes) served through
             ``InferenceEngine.from_checkpoint(..., device="cuda")`` with
             the ladder 1,8,32 and ~40 requests over the probs / features /
             tokens heads, a second engine with ``attention_impl="flash"``,
             and the serve CLI in pipe mode. The kernels' launch counters
             are set to 0 right before the requests and read right after.
4. the kernel list, the card's name and power limit, and the ``ok`` line.

Numerical settings: float32 matmuls run in full f32
(``allow_tf32 = False`` for matmul and cuDNN) so the plain versions are
exact f32 references.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "pytorch_vit_paper_replication_tpu_torch"

# Peak rates by card (NVIDIA data sheets, dense, at the full power limit):
# (bf16 tensor FLOP/s, f32 non-tensor FLOP/s, HBM bytes/s).
PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H200": (989e12, 67e12, 4.8e12),
    "H100": (989e12, 67e12, 3.35e12),
}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
PRESET = "ViT-B/16"
NUM_CLASSES = 1000
BUCKETS = (1, 8, 32)
N_IMAGES = 36


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak-rate entry for card {name!r}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, flop_rate: float, byte_rate: float):
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def close(a, b, tol: float) -> float:
    """max |a - b|; raises unless |a - b| <= tol + tol * |b| everywhere."""
    import torch
    a, b = a.float(), b.float()
    err = (a - b).abs()
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output is not finite")
    if not bool((err <= tol + tol * b.abs()).all()):
        raise AssertionError(f"max |kernel - plain| = {err.max().item()} "
                             f"exceeds tolerance {tol} (+{tol}*|plain|)")
    return err.max().item()


# ------------------------------------------------------------- phase 1
def phase_build(card: str) -> None:
    from pytorch_vit_paper_replication_tpu_torch.ops import _build
    t0 = time.perf_counter()
    info = _build.build()
    for name in info:
        _build.load(name)
    regs = {}
    for name, i in info.items():
        regs[name] = [int(line.split("Used ")[1].split()[0])
                      for line in i["log"].splitlines()
                      if "Used " in line and " registers" in line]
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3),
          "per_library_s": {n: round(i["seconds"], 3)
                            for n, i in info.items()},
          "registers_per_instantiation": regs, "card": card})


# ------------------------------------------------------------- phase 2
def _mlp_inputs(gen, n, d, f, dtype, dev):
    import torch
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    return dict(
        x2=r(n, d).to(dev, dtype),
        gamma=(1 + 0.1 * r(d)).to(dev), beta=(0.1 * r(d)).to(dev),
        w1=(r(d, f) * d ** -0.5).to(dev, dtype), b1=(0.1 * r(f)).to(dev, dtype),
        w2=(r(f, d) * f ** -0.5).to(dev, dtype), b2=(0.1 * r(d)).to(dev, dtype))


def check_fused_mlp(gen, card_peaks, dev):
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    n, d, f = 32 * 197, 768, 3072
    bf16_rate, f32_rate, hbm = card_peaks
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for t in (0, 26):
            p = _mlp_inputs(gen, n, d, f, dtype, dev)
            kw = dict(eps=1e-6, seed=20261016, threshold=t)
            with torch.inference_mode():
                out = fused_mlp._launch(**p, **kw)
                torch.cuda.synchronize()
                ref = fused_mlp.ln_mlp_residual_plain(**p, **kw)
                err = close(out, ref, TOL[name])
                ms = time_ms(lambda: fused_mlp._launch(**p, **kw), 20)
                plain_ms = time_ms(
                    lambda: fused_mlp.ln_mlp_residual_plain(**p, **kw), 5)
            s = dtype.itemsize
            nbytes = 2 * n * d * s + 2 * d * f * s + (f + d) * s + 2 * d * 4
            b_ms, b_by = bound(4.0 * n * d * f, nbytes,
                               bf16_rate if name == "bfloat16" else f32_rate,
                               hbm)
            row = {"phase": "kernels", "kernel": "fused_ln_mlp_residual",
                   "dtype": name, "threshold": t, "shape": [n, d, f],
                   "max_abs_err": err, "tolerance": TOL[name],
                   "kernel_ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            if t:
                row["masks_bit_identical"] = fused_mlp_masks(p, kw, dev)
            emit(row)
            rows.append(row)
    return rows


def fused_mlp_masks(p, kw, dev) -> bool:
    """Recover both keep masks by feeding ones: x = 0 and w1 = 0 make
    h = b1 = 1 everywhere; w2 = 0, b2 = 1 gives out = keep1 / keep (the
    output mask, tag 1); w2 = a block selector [I; 0] shifted by k*D and
    b2 = 0 gives out[:, j] = keep0[:, k*D + j] * keep1[:, j] * const (the
    hidden mask, tag 0, on every hidden column). The zero pattern of the
    kernel must equal the plain version's bit for bit in every run."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    n, d = p["x2"].shape
    f = p["w1"].shape[1]
    dt = p["x2"].dtype
    base = dict(p, x2=torch.zeros_like(p["x2"]),
                w1=torch.zeros_like(p["w1"]),
                b1=torch.ones_like(p["b1"]))
    runs = [dict(base, w2=torch.zeros_like(p["w2"]),
                 b2=torch.ones_like(p["b2"]))]
    for k in range(f // d):
        sel = torch.zeros(f, d, dtype=dt, device=dev)
        sel[k * d:(k + 1) * d] = torch.eye(d, dtype=dt, device=dev)
        runs.append(dict(base, w2=sel, b2=torch.zeros_like(p["b2"])))
    with torch.inference_mode():
        for args in runs:
            a = fused_mlp._launch(**args, **kw) == 0
            b = fused_mlp.ln_mlp_residual_plain(**args, **kw) == 0
            if not torch.equal(a, b):
                raise AssertionError("fused MLP dropout keep mask differs "
                                     "from the plain version's")
            if not 0.05 < a.float().mean().item() < 0.3:
                raise AssertionError("fused MLP dropout rate off")
    return True


def check_flash(gen, card_peaks, dev):
    import torch
    import torch.nn.functional as F
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    b, h, dh = 32, 12, 64
    bf16_rate, _, hbm = card_peaks
    rows = []
    for t_len in (197, 577):
        for t in (0, 26):
            q, k, v = [torch.randn(b * h, t_len, dh, generator=gen).to(
                dev, torch.bfloat16) for _ in range(3)]
            kw = dict(seed=777, threshold=t)
            with torch.inference_mode():
                out, lse = fa._launch(q, k, v, **kw)
                torch.cuda.synchronize()
                ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
                err = close(out, ref, TOL["bfloat16"])
                lse_err = close(lse, ref_lse, 1e-4)
                ms = time_ms(lambda: fa._launch(q, k, v, **kw), 20)
                plain_ms = time_ms(
                    lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
                q4, k4, v4 = (a.view(b, h, t_len, dh) for a in (q, k, v))
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, dropout_p=t / 256.0), 20)
            nbytes = 4 * b * h * t_len * dh * 2 + b * h * t_len * 4
            b_ms, b_by = bound(4.0 * b * h * t_len * t_len * dh, nbytes,
                               bf16_rate, hbm)
            row = {"phase": "kernels", "kernel": "flash_attention",
                   "dtype": "bfloat16", "threshold": t,
                   "shape": [b, t_len, h, dh], "max_abs_err": err,
                   "lse_max_abs_err": lse_err,
                   "tolerance": TOL["bfloat16"], "kernel_ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            if t:
                row["masks_bit_identical"] = flash_masks(t_len, kw, dev)
            emit(row)
            rows.append(row)
    return rows


def flash_masks(t_len, kw, dev) -> bool:
    """Recover the attention keep mask by feeding ones: q = k = 0 give
    uniform weights 1/T; v = a one-hot selector of key block c (v[j, d] =
    1 iff j = 64c + d) makes out[row, d] = keep[row, 64c + d] / (T keep).
    Every column block's zero pattern must match the plain version's."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    bh, dh = 24, 64
    z = torch.zeros(bh, t_len, dh, dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        for c in range((t_len + dh - 1) // dh):
            v = torch.zeros_like(z)
            cols = torch.arange(c * dh, min((c + 1) * dh, t_len), device=dev)
            v[:, cols, cols - c * dh] = 1.0
            a = fa._launch(z, z, v, **kw)[0][..., :len(cols)] == 0
            b = fa.flash_attention_plain(z, z, v, **kw)[0][
                ..., :len(cols)] == 0
            if not torch.equal(a, b):
                raise AssertionError("flash dropout keep mask differs from "
                                     "the plain version's")
            if not 0.05 < a.float().mean().item() < 0.16:
                raise AssertionError("flash dropout rate off")
    return True


# ------------------------------------------------------------- phase 3
def write_fixture(root: Path, seed: int):
    """A seeded ViT-B/16 export (1000 classes) and seeded PNGs."""
    import numpy as np
    from PIL import Image
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        save_inference_export)

    cfg = PRESETS[PRESET](num_classes=NUM_CLASSES)
    model = ViT(cfg)
    model.load_state_dict(seeded_params(cfg, seed))
    export = save_inference_export(root / "export", model)
    classes = [f"class_{i:04d}" for i in range(cfg.num_classes)]
    (root / "classes.txt").write_text("\n".join(classes) + "\n")
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(N_IMAGES):
        p = root / f"img_{i:02d}.png"
        Image.fromarray(rng.integers(0, 256, (240, 320, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
    return model, export, classes, paths


def phase_serve(root: Path, dev):
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        image_row, predict_image)
    from pytorch_vit_paper_replication_tpu_torch.serve import InferenceEngine
    from pytorch_vit_paper_replication_tpu_torch.serve.__main__ import (
        _answer)

    t0 = time.perf_counter()
    model, export, classes, paths = write_fixture(root, seed=0)
    fixture_s = time.perf_counter() - t0
    eng = InferenceEngine.from_checkpoint(
        export, preset=PRESET, class_names=classes, device=dev,
        buckets=BUCKETS, max_wait_us=20_000)
    flash_model = ViT(model.config.replace(attention_impl="flash"))
    flash_model.load_state_dict(model.state_dict())
    eng_flash = InferenceEngine(flash_model, device=dev,
                                image_size=eng.image_size,
                                transform=eng.transform, class_names=classes,
                                buckets=BUCKETS, max_wait_us=20_000)
    del model
    warm = eng.snapshot()["warmup"]

    # ---- the main path: counters to 0, drive both engines, read.
    fused_mlp.launches = 0
    fa.launches = 0
    batches0 = eng.stats.counters["batches"]
    t_drive = time.perf_counter()
    # A lone ::probs request rides bucket 1, the shape predict_image runs.
    probe = json.loads(_answer(f"::probs {paths[0]}", eng, None))
    # The burst: rows preprocessed first so the batcher can fill the top
    # rung (the bucket the kernel numbers above are taken at).
    heads = ["probs", "features", "tokens"]
    rows = [image_row(p, eng.transform) for p in paths + paths[:4]]
    futs = [(i % N_IMAGES, heads[i % 3], eng.submit(r, head=heads[i % 3]))
            for i, r in enumerate(rows)]
    answered = [(i, h, f.result(timeout=300)) for i, h, f in futs]
    batches1 = eng.stats.counters["batches"] - batches0
    fl_b0 = eng_flash.stats.counters["batches"]
    flash_futs = [(i, eng_flash.submit(rows[i])) for i in range(16)]
    flash_res = [(i, f.result(timeout=300)) for i, f in flash_futs]
    batches2 = eng_flash.stats.counters["batches"] - fl_b0
    drive_s = time.perf_counter() - t_drive
    k1, k2 = fused_mlp.launches, fa.launches

    # ---- checks
    _, _, ref = predict_image(eng.model, paths[0], classes,
                              transform=eng.transform)
    if not np.array_equal(np.asarray(probe["probs"], np.float32), ref):
        raise AssertionError("::probs row != predict_image bit for bit")
    n_req = len(futs) + 1
    snap = eng.snapshot()
    if snap["counters"]["completed"] != n_req or \
            snap["counters"]["submitted"] != n_req:
        raise AssertionError(f"requests not answered exactly once: "
                             f"{snap['counters']}")
    probs_rows = {}
    cfg = eng.model.config
    for i, h, r in answered:
        if h == "probs":
            s = float(r.probs.sum())
            if abs(s - 1.0) > 1e-4 or not np.isfinite(r.probs).all():
                raise AssertionError(f"probs row sums to {s}")
            probs_rows[i] = r.probs
        elif h == "features":
            if r.shape != (cfg.embedding_dim,) or not np.isfinite(r).all():
                raise AssertionError(f"bad features row {r.shape}")
        elif r.shape != (cfg.seq_len, cfg.embedding_dim) or \
                not np.isfinite(r).all():
            raise AssertionError(f"bad tokens row {r.shape}")
    if k1 != 12 * (batches1 + batches2):
        raise AssertionError(f"fused MLP launches {k1} != 12 x "
                             f"{batches1 + batches2} batches")
    if k2 != 12 * batches2 or k2 == 0:
        raise AssertionError(f"flash launches {k2} != 12 x {batches2}")
    # Flash vs xla attention: same weights, two attention paths (f32
    # online softmax vs bf16 logits + f32 softmax), bf16 activations
    # through 12 blocks.
    diffs = []
    for i, r in flash_res:
        if i not in probs_rows:
            probs_rows[i] = predict_image(eng.model, rows[i], classes)[2]
        diffs.append(float(np.abs(r.probs - probs_rows[i]).max()))
    flash_tol = 1e-3
    if max(diffs) > flash_tol:
        raise AssertionError(f"flash engine probs differ by {max(diffs)} "
                             f"> {flash_tol}")
    profile_rung(eng, np.stack(rows[:BUCKETS[-1]]))
    eng_flash.close()
    eng.close()
    emit({"phase": "serve", "ok": True, "fixture_s": round(fixture_s, 3),
          "warmup": warm, "requests": n_req, "batches": batches1,
          "flash_requests": len(flash_res), "flash_batches": batches2,
          "fused_mlp_launches": k1, "flash_launches": k2,
          "drive_s": round(drive_s, 3),
          "flash_vs_xla_max_abs_probs_diff": max(diffs),
          "flash_vs_xla_tolerance": flash_tol,
          "probs_bit_identical_to_predict_image": True,
          "latency_s": snap["latency_s"],
          "batch_occupancy": snap["batch_occupancy"]})
    return export, paths, {"fused_ln_mlp_residual": k1,
                           "flash_attention": k2}


def profile_rung(eng, batch) -> None:
    """Where one top-rung forward spends device time: CUDA-event time of
    ``engine._run`` (host->device copy + fused forward, outputs left on
    the card), then one ``torch.profiler`` pass summed by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fwd_ms = time_ms(lambda: eng._run(batch), 5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._run(batch)
        torch.cuda.synchronize()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)

    # Device-side events only (kernels and copies); the CPU-side ops
    # that launched them carry the same time again as "self device".
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    top = sorted(events, key=dev_us, reverse=True)[:12]
    emit({"phase": "profile", "rung": int(batch.shape[0]),
          "forward_ms": fwd_ms,
          "device_events": len(events),
          "device_ms_total": sum(dev_us(e) for e in events) / 1e3,
          "top_device_ms": [[e.key[:90], dev_us(e) / 1e3, e.count]
                            for e in top]})


def phase_cli(export: Path, paths, device: str = "cuda") -> None:
    """The serve CLI as a pipe-mode subprocess: a few paths + ::stats."""
    lines = [str(p) for p in paths[:5]] + ["::stats"]
    classes = export.parent / "classes.txt"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.serve", "--checkpoint", str(export),
         "--preset", PRESET, "--classes-file", str(classes),
         "--device", device, "--buckets", "1,8", "--sync-warmup",
         "--no-manifest"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out = proc.stdout.strip().splitlines()
    if len(out) != len(lines):
        raise AssertionError(f"serve CLI answered {len(out)} of "
                             f"{len(lines)} lines")
    for line, reply in zip(lines[:-1], out[:-1]):
        path, label, prob = reply.split("\t")
        if path != line or not label.startswith("class_") or \
                not 0.0 < float(prob) <= 1.0:
            raise AssertionError(f"malformed CLI reply {reply!r}")
    stats = json.loads(out[-1])
    if stats["counters"]["completed"] != len(lines) - 1 or \
            stats["device"] != device:
        raise AssertionError(f"CLI ::stats wrong: {stats['counters']}")
    emit({"phase": "serve_cli", "ok": True, "replies": len(out),
          "seconds": round(time.perf_counter() - t0, 3),
          "completed": stats["counters"]["completed"]})


# ------------------------------------------------------------- phase 4
def kernel_list(k_rows, launches):
    """The two ported kernels with their main-path numbers (bucket 32,
    bf16, dropout off), then the TPU kernels still to port."""
    def pick(kernel, **match):
        return next(r for r in k_rows if r["kernel"] == kernel and all(
            r[k] == v for k, v in match.items()))

    base = f"{PKG}/csrc"
    out = []
    for name, src, replaces, row in (
            ("fused_ln_mlp_residual", f"{base}/fused_mlp.cu",
             "pytorch_vit_paper_replication_tpu/ops/fused_mlp.py:461",
             pick("fused_ln_mlp_residual", dtype="bfloat16", threshold=0)),
            ("flash_attention", f"{base}/flash_attention.cu",
             "pytorch_vit_paper_replication_tpu/ops/flash_attention.py:295",
             pick("flash_attention", threshold=0, shape=[32, 197, 12, 64]))):
        errs = [r["max_abs_err"] for r in k_rows if r["kernel"] == name
                and r["dtype"] == "bfloat16"]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "status": "ported and checked",
                    "launches": launches[name], "max_abs_err": max(errs),
                    "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
    todo = [
        ("fused_ln_mlp_residual backward", "ops/fused_mlp.py:501"),
        ("flash_attention backward dq", "ops/flash_attention.py:485"),
        ("flash_attention backward dk/dv", "ops/flash_attention.py:503"),
        ("fused_mlp forward", "ops/fused_mlp.py:236"),
        ("fused_mlp backward", "ops/fused_mlp.py:278"),
    ]
    return {"kernels": out, "to_port": [
        {"name": n, "replaces": f"pytorch_vit_paper_replication_tpu/{r}",
         "status": "still to port"} for n, r in todo]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ is missing next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    t_start = time.perf_counter()
    phase_build(card)
    gen = torch.Generator().manual_seed(0)
    card_peaks = peaks(name)
    k_rows = check_fused_mlp(gen, card_peaks, dev) + \
        check_flash(gen, card_peaks, dev)
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        export, paths, launches = phase_serve(root, dev)
        phase_cli(export, paths)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            3)})
    print(card, flush=True)
    print(json.dumps(kernel_list(k_rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — any failed phase: traceback, exit 1
        import traceback
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
