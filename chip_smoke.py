#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (ViT-B/16 serving and
training paths, the Quickstart and the ImageNet-scale training CLIs, the
transfer-learning path, distillation, embedding search, the serving
fleet with its telemetry sinks, and the train CLI on a dp x tp x seq x pp
mesh).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and the
final ``ok`` line is never printed:

1. build   — compile every CUDA kernel of the path from ``csrc/`` (one
             ``nvcc`` per source, started together) and load it.
2. kernels — each kernel against its plain PyTorch version on the card at
             the B/16 shapes (batch 32: N = 32*197 rows for the fused MLP;
             B = 32, H = 12, Dh = 64, T in {197, 577} for flash attention;
             flash also at Dh = 80, padded to 128, and Dh = 256),
             with dropout off and at t = 26 (rate 0.1); the forward keep
             masks are recovered by feeding ones and must be bit-identical.
             The backward kernels (fused MLP: bf16 t = 0 and 26, f32 t = 0;
             flash dq and dk/dv: bf16, T in {197, 577}, t = 0 and 26) are
             held against their plain versions per output and must be
             bitwise deterministic over two launches; the ``save_h``
             forward's h against the plain h. The flash kernels also run
             one f32 case (T = 197, t = 0: the SIMT kernels f32 keeps) at
             1e-4, and the phase counts the HGMMA (wgmma) instructions that
             ``cuobjdump -sass`` finds in the bf16 tensor-core kernels (the
             flash forward, dq and dk/dv, the MLP forwards' and backwards'
             GEMMs; raises on 0). Times come from CUDA events, a device
             time per call (``device_ms``) and the host's time per call
             (``host_ms``); each row prints ``bound_share`` = bound /
             kernel time; the row 1 forward also its per-pass device
             times; the flash kernels are timed beside
             ``F.scaled_dot_product_attention`` forward and backward, the
             MLP kernels beside their bf16 products as ``torch.matmul``
             calls (``gemms_library_ms``: two forward, four backward; both
             timed only, never called by the port). Then rows 1, 2, 6 and
             7 at every preset width (D in PRESET_WIDTHS, F = 4 D) and
             N in WIDTH_ROWS, bf16 and f32, against their plain versions.
2b. ops    — the kernels' whole contracts at the B/16 shapes. Its path,
             the counts set to 0 right before and read right after:
             ``dot_product_attention(mask=..., impl="auto")`` at
             [32, 197, 12, 64] bf16 for every mask form of JAX's
             ``_normalize_mask`` (MASK_FORMS: key padding, shared, per
             head, full, per-head q-broadcast, key-broadcast with fully
             masked rows) and a Tq = 197, Tk = 577 call, forward and
             backward, then ``fused_ln_mlp_residual`` and ``fused_mlp`` at
             D = 200, F = 800 with dropout: every flash and MLP kernel
             must launch. Then rows 3-5 held to their plain versions
             (flash bounds) at every mask form in bf16 and f32, with
             dropout 0.1 under a mask (keep bits bit-identical to the
             plain version's, recovered as in phase 2), at Tq != Tk
             (197 / 577 both ways) and at Dh = 80 and 256 with the full
             mask; query rows that attend to no key exactly 0 in out and
             dq; device ms of rows 3-5 at T = 197 and 577 unmasked, with
             the key-padding and with the full mask. Rows 1, 2, 6, 7 at
             OFF64_WIDTHS x OFF64_ROWS, bf16 and f32, against their plain
             versions (the MLP bounds), device ms beside the padded
             width. The quantized softmax storage: ``_QuantizedSoftmaxPV``
             on the card against the CPU (forward and backward), and
             B/16 on the xla path with the probs in bf16, u8 and
             fp8_e4m3, QUANT_STEPS steps + eval each, losses finite.
3. serve   — a seeded ViT-B/16 export (1000 classes) served through
             ``InferenceEngine.from_checkpoint(..., device="cuda")`` with
             the ladder 1,8,32 and ~40 requests over the probs / features /
             tokens heads (``auto``: flash at T = 197 on the card), a second
             engine with ``attention_impl="xla"`` to compare, and the serve
             CLI in pipe mode. The kernels' launch counters
             are set to 0 right before the requests and read right after.
4. train   — ViT-B/16 at full width and depth (224 px, 1000 classes, bf16,
             the default dropouts) from ``convert.seeded_params``, trained
             by ``engine.train`` with the default ``TrainConfig`` recipe on
             a seeded batch of 32 repeated every step: 8 steps + one eval
             pass with ``attention_impl="auto"`` (flash at T = 197 on the
             card, fused MLP), then 3 steps + eval with
             ``attention_impl="flash"``. The
             launch counters are set to 0 right before each run and read
             right after; losses and grad norms must be finite and the loss
             must fall. Then step time, img/s and a ``torch.profiler``
             breakdown of one step of each run (the flash step's with the
             device time of the wrapper's ``_fold_heads`` copies of q, k,
             v), and one f32 step of a 2-layer B/16 on
             the card against the same step through the plain versions on
             the CPU: loss, gradients and the updated params. Last, the
             T = 197 attention decision measured again: ``auto`` and
             ``xla`` train states from the same params stepped in turns
             (COMPARE_ROUNDS), wall and device medians of each. Phase
             ``presets``: Ti/16, S/16, L/16 and H/14 at full width, cut to
             PRESET_LAYERS layers, PRESET_STEPS steps + eval under the
             default ``auto`` impls, the fused MLP kernels launched in
             every block (flash where ``auto`` picks it).
4b. train_cli — the Quickstart training path through the port's CLIs:
             ViT-B/16 at 224 px, bf16, batch 32, ``--attention auto
             --mlp-impl auto``, on a seeded synthetic image folder (96
             train and 24 test JPEGs, 3 steps an epoch). Run A: ``python
             -m ...train`` as a subprocess, 2 epochs, a checkpoint every
             2 steps, the metrics JSONL (2 rows, the JAX keys, finite
             losses) and the final/ export. Run B: the same command
             through ``train.main`` in this process, the launch counters
             set to 0 right before and read right after, rows 1-5
             launched 12 times in every train step; then every step
             after 4 and final/ deleted and the command rerun: it resumes
             at step 4 and its final params equal run A's bit for bit.
             Run A carries the telemetry sinks (``--metrics-port`` on a
             free port, scraped while it runs and parsed as Prometheus
             text with HELP lines; ``--ship-to`` a ``FrameSink``: frames
             of role ``train``) and its losses equal run B's (no sinks)
             bit for bit. A runs beside B, so its JSONL img/s and
             time_to_first_step are printed as ``..._beside_run_b``:
             contended readings, where run C's are a run alone.
             ``--eval-only`` on A equals A's last JSONL row; ``python -m
             ...predict`` on a test image prints what ``predict_image``
             gives on the same export. Run C: two 10-step epochs, steps
             3-10 profiled (the card's idle share: host wall minus the
             union of kernel intervals), epoch 2 unprofiled (the CLI's
             img/s with no checkpoint saves). Reports: the loader's img/s
             (1 and os.cpu_count() threads, os.cpu_count() processes,
             native decode where it built and PIL, 224 and 512 px
             sources), H2D ms of a [32, 224, 224, 3] f32 batch pinned and
             pageable, B/16 checkpoint save and restore seconds, and
             whether the native JPEG decoder built on this machine. The
             checkpoint reading has a sync save and two async ones (time
             in ``save()`` and until durable).
4c. train_packed — the ImageNet-scale recipe: a seeded folder of 321
             train / 24 test JPEGs at 512 px packed with ``python -m
             ...data.pack --pack-size 256 --shard-images 64
             --shuffle-seed 0``, then B/16 at 224 px, bf16, batch 32, one
             loader thread, ``--shuffle-window 128 --readahead 2``, 2
             epochs of 10 steps, a save every 4 steps. P1: ``python -m
             ...train --dataset packed`` (async saves, the default
             augmentation, telemetry JSONL every step, the watchdog, a
             profile window over steps 6-7) as a subprocess. P2: the same
             command with ``--sync-checkpoints`` through ``train.main``,
             the counters set to 0 right before and read right after:
             rows 1-5 launched 12 times a step, rows 6, 7 never. Checks:
             P1's final params equal P2's bit for bit; the command without
             augmentation stopped after step 6 and resumed from its async
             step-4 save equals the uninterrupted run; every telemetry row
             has the JAX package's keys for its event; every tel_mfu is in
             (0, 1) and equals tel_images_per_sec x FLOPs / the card's
             bf16 peak within 1%; each profile trace names the kernels of
             rows 1-5; no postmortem; the memory gauges non-zero and
             mem_dev0_bytes_peak within 5% of max_memory_allocated;
             ``--dataset cifar10`` on a fake archive one epoch with the
             same launches a step. Prints the epoch img/s of P1 and P2,
             the host's blocked seconds per save, each profile window's
             idle share, tel_mfu and the packed loader's img/s alone at 1
             and all threads with its transform path.
4d. transfer — the transfer-learning path: a seeded torchvision-layout
             ViT-B/16 state dict for 224 px, 1000 classes, from stock
             ``torch.nn`` layers (``_stock_vit``), written with
             ``torch.save``; the converted port model (eval, bf16, the
             flash and fused MLP kernels) against the stock module in f32
             on the card at 224 px and at 384 px with the interpolated
             position embedding (logits within TRANSFER_TOL of the largest
             reference logit). ``train --pretrained ... --freeze-backbone``
             at 224 px, batch 32, 2 epochs of 3 steps through
             ``train.main``, the counters set to 0 right before and read
             right after: rows 1-5 launched 12 times a step, the backbone
             after training equal to the converted weights bit for bit,
             the head moved, a run resumed from its step-4 save equal to
             the uninterrupted one. The ``runs/transfer384_r5`` command cut
             to one 10-step epoch (--image-size 384, T = 577): rows 1-5 12
             launches a step, telemetry every 4 steps (tel_mfu against
             332.9 GFLOP an image), steps 3-10 profiled (wall, device busy,
             idle share), ``mem_dev0_bytes_peak``; ``predict`` of its
             export against ``predict_image``. ``probe --pretrained`` (its
             accuracies) and the probe's features on the card held to f32
             features on the CPU (TRANSFER_TOL). The fixture packed at 384
             px, ``tools.batch_infer`` with each head (rows 1 and 3
             launched 12 times per forward, the others never): ``probs``
             rows give ``predict_batch``'s labels and probabilities bit
             for bit on the same rungs, ``softmax(logits)`` equals
             ``probs``, a SIGKILLed and resumed job's sink equals the
             unkilled one's (sha256), img/s. TinyVGG one epoch at 64 px, f32,
             card against ``--device cpu`` (losses rtol TINYVGG_RTOL). Rows
             1-5 at the 384 px shapes (the MLP rows at N = 18,464 against
             their plain versions, timed beside their matmul products; the
             flash rows from phase 2's T = 577 cases) go into the kernel
             line as ``t577``.
4e. distill, search — the consumers of the batch job's sinks. A seeded
             folder of 321 train / 24 test JPEGs at 224 px packed at 224
             px; a seeded ViT-B/16 teacher (3 classes) exported, its
             ``logits`` and ``features`` swept by ``tools.batch_infer``
             (rows 1 and 3 launched 12 times per forward);
             ``pseudo_label_pack`` relabels the pack with its argmax.
             Distill: a ViT-Ti/16 student at full width (D = 192, 12
             layers, 3 heads), 224 px, bf16, batch 32, through
             ``train.main --distill-from ... --distill-t 2
             --distill-alpha 0.7`` for two epochs, the counts set to 0
             right before and read right after: rows 1-5 launched 12 times
             in every step, rows 6, 7 never; steps 3-10 profiled (wall,
             device busy, idle share); ``teacher_agree`` in every metrics
             row and the ``distill_*`` gauges on the registry;
             ``--distill-alpha 0`` equal to the ordinary run of the same
             argv (losses, final ``params.npz`` sha256); the run in f32
             (dropout 0, TF32 off) on the card against the CPU over its
             first DISTILL_CPU_STEPS steps (STEP_TOL["loss"]); a truncated
             sink, a features sink and another pack's sink refused. Search:
             ``tools.build_index`` ``ip`` and ``cosine`` indexes over the
             features sink, each scanned on the card against
             ``reference_topk``; a lone ``::search 10`` and ``::req k=10``
             through the serve CLI (``--search-index``) bit-equal to the
             offline features head at batch 1 scanned at rung 1, then
             SERVE_PROBES lone probes timed (p50, p99); the launches of one
             ``engine.search`` (rows 1 and 3 12 times, the scores kernel
             once). A seeded clustered corpus of SEARCH_ROWS x 768 f32
             drawn on the card, written through ``NpySink`` and sealed,
             indexed by ``tools.build_index``, placed on the card (H2D
             seconds) and scanned: 1,024 queries at k = 10 and 100 (the
             scores kernel's launches counted), the first 64 against
             ``reference_topk`` (``check_topk``), a padded tail (rung 8
             against rung 1) bit for bit, duplicated rows resolved to the
             lowest id; per rung 1, 8, 64 the chunk's event ms, device ms
             by kernel, the top-k's share and the bound; the scores kernel
             against its plain version and ``q @ blockᵀ`` at 64 queries by
             one row block. IVF over the first IVF_ROWS rows at
             ``--ivf-lists`` IVF_LISTS, nprobe IVF_NPROBE: recall@10 >=
             IVF_RECALL and the share of rows touched.
4f. fleet — after search, in the same temporary root (the distill
             phase's B/16 teacher export, its Ti/16 student, the 321
             JPEGs, the search phase's ip index). ``python -m
             ...serve.fleet --replicas 2 --devices 1 --buckets 1,4,8
             --swap-probe IMG --ship-to`` a ``FrameSink``: two port
             serve-CLI replicas of the B/16 export on the one card
             (``partition_devices(1, 2)``: both on ordinal 0), booting
             together into an empty kernel build directory
             (``VIT_TORCH_BUILD_DIR``; cold boot s; each library built
             once between them, read from ``builds.jsonl``). Beside it,
             the same fleet built in this process by the CLI's own
             ``parse_args`` / ``build_fleet`` (warm boot s), its replicas
             with ``--search-index``, ``--ship-to`` and ``--trace-jsonl``
             at ``--trace-sample 0.05``, its router traced here. On the
             quiet fleets, routed ``::probs`` and ``::req head=features``
             (the CLI's) and ``::search 5`` (the in-process one's) equal an
             in-process engine on the card bit for bit (its launches
             counted: rows 1 and 3 12 times a forward, the scores kernel
             once). ``TraceClients`` replays ``profiles/burst4x.json`` as
             committed against the CLI's router, one of its replicas
             SIGKILLed at t = 15 s: every arrival answered exactly once, by
             a reply or a backpressure line the router counted, and the
             replica restarted and re-admitted warm (restart s = warm
             boot). ``profiles/steady.json`` with ``::swap`` to a second
             seeded B/16 export through the router (``::swap-status``
             polled; each replica re-admitted on the ``--swap-probe`` row
             the CLI's child process computes, bit for bit): no failed
             request, routed ``::probs`` afterwards equal the new export's
             in-process engine; ``::swap`` to a corrupt copy is refused
             (its probe row cannot be computed) and the replies stay. The
             CLI's ``::metrics`` parses as Prometheus text; it exits 0 on
             SIGINT. The in-process fleet: a traced pass (TraceClients,
             FLEET_TRACED_PROFILE), ``::metrics`` of a replica and of the
             router, ``::swap`` to the corrupt copy (no probe) rolled back
             and the replies unchanged. The cascade: three fleet CLIs with
             ``--cascade`` (a Ti/16 student and a B/16 teacher replica
             each, ``--ship-to``), at threshold 0 (the student's
             in-process replies bit for bit), infinity (the teacher's) and
             the median student margin (each reply from the tier its
             margin picks; the escalations the margins at or below it),
             CASCADE_PROBES ``::probs`` each, ``::stats``, ``::metrics``,
             exit 0 on SIGINT. Last, the sinks: frames from the in-process
             fleet's replicas (role ``serve``) and the four CLIs' routers
             (role ``router``), and the trace JSONL merged by
             ``merged_chrome_trace`` into a trace ``validate_chrome_trace``
             passes, with ``serve.request`` spans under router spans of
             the same trace id. Latency per segment is recorded, not
             gated.
5. parallel — the data x tensor x sequence x pipeline path through
             the port's ``parallel.spawn``, one spawn of four rank
             processes sharing the one card for its three runs (gloo,
             every transfer through host memory; the phase prints the
             transport): (a) ViT-B/16 at full width, PAR_LAYERS = 4
             layers (phase train_mesh runs the full depth on a pipeline),
             bf16, ``mlp_impl``/``attention_impl`` auto, default dropouts,
             on dp = 1 x tp = 2 x pp = 2 with M = 2 microbatches of a
             batch of 8: 3 steps + one eval pass, loss finite and falling,
             the MLP core kernels (rows 6 and 7) and the flash kernels
             launched (4 / 2) * 2 times per step forward and backward on
             every rank and the LN-MLP kernels (rows 1 and 2) never; (b) a
             2-layer f32 ViT-B/16,
             dropout off, biases perturbed per channel, on dp = 2 x
             tp = 2: 2 steps against the single-process port on the card
             (losses rtol 1e-5, the JAX package's pipeline x TP bound;
             gradients per leaf and params elementwise, see
             TP_DP_LOSS_RTOL; the gap to the JAX elementwise param bound
             is printed); (c) sequence parallelism at B/16 width, 2
             layers, 224 px with pool='gap' (T = 196), f32, attention
             dropout 0.1: ring on seq 2 x model 2 and Ulysses on data 2 x
             seq 2, one step each, every rank's logits and loss within
             1e-4 and gradients within 2e-3 of each leaf's largest of the
             one-rank step with the flash kernel and the same seeds; rows
             6, 7 (ring) or 1, 2 (Ulysses) launched, rows 3-5 never. Wall
             times there are four ranks sharing one H100, not
             parallel-training throughput.
5a. train_mesh — the train CLI itself on a mesh, four rank processes
             sharing the card (gloo): ViT-B/16 at full width and depth,
             bf16, auto, default dropouts, 224 px synthetic folders,
             batch 8. (a) through ``train.main`` in this process:
             ``--mesh-data 2 --mesh-pipe 2 --grad-accum 2
             --checkpoint-every-steps 2``, one short epoch of 4
             micro-steps: every rank's launches exactly its stage's (rows
             1-5, 6 layers x 2 microbatches per micro-step and eval
             batch; rows 6 and 7 never), the ranks' global metrics equal,
             losses finite; the steps after the first checkpoint and
             final/ set aside and the command rerun: its final params, its
             step-4 checkpoint (params, mu, nu, acc, count, mini_step)
             and its eval equal the uninterrupted run's bit for bit;
             ``--eval-only`` on the mesh (a background CLI process on the
             uninterrupted run's step 4) equals its eval; the ``predict``
             CLI on the mesh run's final/ prints what ``predict_image``
             gives on it. (b) a background CLI process from the phase's
             start: ``--mesh-model 2 --mesh-pipe 2 --grad-accum 2
             --nan-guard``, three epochs of one update each: rows 3-7
             launched per stage, rows 1 and 2 never, the loss finite and
             falling, no step skipped. (c) a background CLI process from
             (a)'s end: ``--pool gap --mesh-model 2 --mesh-seq 2
             --sp-impl ring``, one epoch of 2 steps: rows 6 and 7 launched
             on every rank, rows 1-5 never; its final/ scored by the
             one-card ``--eval-only`` as the seq mesh's eval did (the
             mesh's loss below MESH_C_SURE_LOSS, the |ln ratio| within
             MESH_C_LOSS_LN). Walls are host clocks with the ranks' start
             included.
5b. walls  — each phase's seconds, one line.
6. the kernel list, the card's name and power limit, and the ``ok`` line.
   Every entry's ``ms``, ``plain_ms`` and ``library_ms`` are event times,
   its ``device_ms`` and ``library_device_ms`` device times.

Phase 2 also holds the MLP core kernels (rows 6 and 7, ``csrc/
fused_mlp_core.cu``) against their plain versions at N = 32*197, D = 768,
F in {3072, 1536} (bf16 t = 0 and 26, f32 t = 0) and at the parallel
phase's own shape (N = 4*197, F = 1536, bf16 t = 26): forward keep masks
bit-identical, the forward within the tolerance below, the saved h
within one bf16 ulp of the plain h (above a magnitude floor, see
H_ULP_FLOOR), the backward within 2e-2 (bf16) / 1e-4 (f32) of each
gradient's largest element and bitwise deterministic over two launches.

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
    """(bf16 tensor FLOP/s, f32 non-tensor FLOP/s, HBM bytes/s) of the
    card, from the port's one table (``telemetry/flops.py``)."""
    from pytorch_vit_paper_replication_tpu_torch.telemetry.flops import (
        peaks as table)
    val = table(name)
    if val is None:
        raise RuntimeError(f"no peak-rate entry for card {name!r}")
    return val


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


def device_ms(fn, reps: int = 20):
    """Device time per call of ``fn``: CUDA events around ``reps`` calls
    queued behind a spin kernel of 10^8 cycles (over 50 ms), so the card
    runs them back to back and the host's time between launches (which
    :func:`time_ms` of a small kernel includes) drops out. None when
    queueing the calls outlasted the spin (then it would count again)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_s = time.perf_counter() - t0
    end.synchronize()
    return start.elapsed_time(end) / reps if queued_s < 0.04 else None


def host_ms(fn, reps: int = 20) -> float:
    """Host time per call of ``fn`` while the card is busy: ``reps`` calls
    queued behind a spin kernel, so none waits for the card. What a
    wrapper costs the host (checks, allocations, tensor-map encodes,
    launches), apart from the kernels' device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return out


def dev_us(e, total: bool = False) -> float:
    """Device microseconds of a ``torch.profiler`` average: its own, or
    with ``total`` its own and its children's."""
    names = (("device_time_total", "cuda_time_total") if total else
             ("self_device_time_total", "self_cuda_time_total"))
    return float(next((getattr(e, n) for n in names if getattr(e, n, None)),
                      0) or 0)


def kernel_breakdown(fn, reps: int = 5) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls (names cut at the argument
    list)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            name = e.key.split("(")[0].replace("void ", "")[-70:]
            out[name] = out.get(name, 0.0) + dev_us(e) / 1e3 / reps
    return out


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
    from pytorch_vit_paper_replication_tpu_torch import native
    from pytorch_vit_paper_replication_tpu_torch.ops import _build
    t0 = time.perf_counter()
    info = _build.build()
    for name in info:
        _build.load(name)
    # The host JPEG decoder (g++ + libjpeg), optional by contract: the
    # loader decodes with PIL where it does not build; which one ran is
    # printed here and in phase train_cli.
    t_native = time.perf_counter()
    native_ok = native.available()
    native_s = time.perf_counter() - t_native
    regs = {}
    for name, i in info.items():
        regs[name] = [int(line.split("Used ")[1].split()[0])
                      for line in i["log"].splitlines()
                      if "Used " in line and " registers" in line]
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3),
          "per_library_s": {n: round(i["seconds"], 3)
                            for n, i in info.items()},
          "registers_per_instantiation": regs,
          "native_jpeg_decoder": {
              "available": native_ok, "seconds": round(native_s, 3),
              "library": str(native.library_path().relative_to(REPO)),
              "reason": native.unavailable_reason()},
          "card": card})


# ------------------------------------------------------------- phase 2
def _mlp_inputs(gen, n, d, f, dtype, dev):
    import torch
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    return dict(
        x2=r(n, d).to(dev, dtype),
        gamma=(1 + 0.1 * r(d)).to(dev), beta=(0.1 * r(d)).to(dev),
        w1=(r(d, f) * d ** -0.5).to(dev, dtype), b1=(0.1 * r(f)).to(dev, dtype),
        w2=(r(f, d) * f ** -0.5).to(dev, dtype), b2=(0.1 * r(d)).to(dev, dtype))


def fwd_gemms_library(gen, n, d, f, dev) -> dict:
    """The MLP forward's two bf16 products at its shapes as two
    ``torch.matmul`` calls timed together (fc1 = y W1, fc2 = g W2): a
    yardstick of the GEMM share only, never called by the port, and not
    one call of the same function (no LN, GELU, dropout or residual)."""
    import torch
    r = lambda *s_: torch.randn(*s_, generator=gen).to(  # noqa: E731
        dev, torch.bfloat16)
    y, g, w1, w2 = r(n, d), r(n, f), r(d, f), r(f, d)

    def two():
        return (y @ w1, g @ w2)
    with torch.inference_mode():
        return {"gemms_library_ms": time_ms(two, 10),
                "gemms_library_device_ms": device_ms(two)}


def check_fused_mlp(gen, card_peaks, dev):
    """Row 1 (LN -> fc1 -> GELU -> drop -> fc2 -> drop -> residual) at
    the B/16 batch-32 shape against its plain version; bf16 also with the
    saved h (as training runs it), device times, the per-pass breakdown
    and the two-matmul yardstick."""
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
                dev_ms = device_ms(lambda: fused_mlp._launch(**p, **kw))
                h_ms = host_ms(lambda: fused_mlp._launch(**p, **kw))
                plain_ms = time_ms(
                    lambda: fused_mlp.ln_mlp_residual_plain(**p, **kw), 5)
                extra = {}
                if name == "bfloat16":
                    def with_h():
                        return fused_mlp._launch(**p, **kw, save_h=True)
                    extra = {
                        "save_h_fwd_ms": time_ms(with_h, 20),
                        "save_h_fwd_device_ms": device_ms(with_h),
                        "passes_device_ms": kernel_breakdown(
                            lambda: fused_mlp._launch(**p, **kw)),
                        "save_h_passes_device_ms": kernel_breakdown(with_h),
                        **fwd_gemms_library(gen, n, d, f, dev)}
            s = dtype.itemsize
            nbytes = 2 * n * d * s + 2 * d * f * s + (f + d) * s + 2 * d * 4
            b_ms, b_by = bound(4.0 * n * d * f, nbytes,
                               bf16_rate if name == "bfloat16" else f32_rate,
                               hbm)
            row = {"phase": "kernels", "kernel": "fused_ln_mlp_residual",
                   "design": MLP_DESIGN[name], "dtype": name, "threshold": t,
                   "shape": [n, d, f], "max_abs_err": err,
                   "tolerance": TOL[name], "kernel_ms": ms,
                   "device_ms": dev_ms, "host_ms": h_ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms,
                   "device_bound_share": b_ms / dev_ms if dev_ms else None,
                   **extra}
            if t:
                row["masks_bit_identical"] = fused_mlp_masks(p, kw, dev)
            emit(row)
            rows.append(row)
    return rows


def rel_err(a, b) -> float:
    """max |a - b| / max |b| in f32; raises on a nonfinite ``a``."""
    import torch
    a, b = a.float(), b.float()
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output is not finite")
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
# How the MLP kernels (rows 1, 2, 6 and 7) multiply, by dtype.
MLP_DESIGN = {"bfloat16": "wgmma+tma", "float32": "simt"}


def gemms_library(gen, n, d, f, dev) -> dict:
    """The MLP backward's four bf16 products at its shapes as four
    ``torch.matmul`` calls timed together (dg = df W2^T, dy = dh W1^T,
    dW1 = y^T dh, dW2 = g^T df): an informational yardstick of the
    GEMM share only, never called by the port, and not one call of the
    same function (no LN, GELU', dropout, bias sums or f32 weight
    gradients)."""
    import torch
    r = lambda *s_: torch.randn(*s_, generator=gen).to(  # noqa: E731
        dev, torch.bfloat16)
    df, dh, g, y = r(n, d), r(n, f), r(n, f), r(n, d)
    w1, w2 = r(d, f), r(f, d)

    def four():
        return (df @ w2.t(), dh @ w1.t(), y.t() @ dh, g.t() @ df)
    with torch.inference_mode():
        return {"gemms_library_ms": time_ms(four, 10),
                "gemms_library_device_ms": device_ms(four)}


def check_fused_mlp_bwd(gen, card_peaks, dev):
    """The save_h forward and the backward kernels at N = 32*197, D = 768,
    F = 3072. Tolerance per gradient, relative to its largest element:
    bf16 2e-2 (a bf16 rounding of df or dh that falls the other way moves
    that element by one ulp), f32 1e-4 (summation order only)."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    n, d, f = 32 * 197, 768, 3072
    bf16_rate, f32_rate, hbm = card_peaks
    rows = []
    for dtype, t in ((torch.bfloat16, 0), (torch.bfloat16, 26),
                     (torch.float32, 0)):
        name = str(dtype).split(".")[1]
        p = _mlp_inputs(gen, n, d, f, dtype, dev)
        kw = dict(eps=1e-6, seed=20261017, threshold=t)
        dout = torch.randn(n, d, generator=gen).to(dev, dtype)
        with torch.inference_mode():
            out, h = fused_mlp._launch(**p, **kw, save_h=True)
            torch.cuda.synchronize()
            out_ref, h_ref = fused_mlp.ln_mlp_residual_plain(**p, **kw,
                                                             save_h=True)
            h_err = close(h, h_ref, TOL[name])
            close(out, out_ref, TOL[name])
            args = (p["x2"], h_ref, p["gamma"], p["beta"], p["w1"], p["w2"],
                    dout)
            got = fused_mlp._launch_bwd(*args, **kw)
            again = fused_mlp._launch_bwd(*args, **kw)
            torch.cuda.synchronize()
            want = fused_mlp.ln_mlp_residual_bwd_plain(*args, **kw)
            errs, abs_errs = {}, []
            for g_name, a, b, c in zip(MLP_GRADS, got, again, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"fused MLP backward {g_name} is "
                                         "not deterministic")
                errs[g_name] = rel_err(a, c)
                abs_errs.append((a.float() - c.float()).abs().max().item())
            tol = 2e-2 if name == "bfloat16" else 1e-4
            bad = {k: v for k, v in errs.items() if v > tol}
            if bad:
                raise AssertionError(f"fused MLP backward {name} t={t}: "
                                     f"{bad} exceed {tol}")
            ms = time_ms(lambda: fused_mlp._launch_bwd(*args, **kw), 10)
            dev_ms = device_ms(lambda: fused_mlp._launch_bwd(*args, **kw))
            h_ms = host_ms(lambda: fused_mlp._launch_bwd(*args, **kw))
            passes = kernel_breakdown(
                lambda: fused_mlp._launch_bwd(*args, **kw))
            plain_ms = time_ms(
                lambda: fused_mlp.ln_mlp_residual_bwd_plain(*args, **kw), 3)
            fwd_h_ms = time_ms(
                lambda: fused_mlp._launch(**p, **kw, save_h=True), 10)
        s_ = dtype.itemsize
        # in: x, h, dO, W1, W2, gamma, beta; out: dx, dW1, dW2, the vectors.
        nbytes = ((3 * n * d + n * f) * s_ + 4 * d * f * s_
                  + (2 * f + 4 * d) * 4)
        b_ms, b_by = bound(8.0 * n * d * f, nbytes,
                           bf16_rate if name == "bfloat16" else f32_rate, hbm)
        h_bytes = 2 * n * d * s_ + 2 * d * f * s_ + n * f * s_
        hb_ms, hb_by = bound(4.0 * n * d * f, h_bytes,
                             bf16_rate if name == "bfloat16" else f32_rate,
                             hbm)
        row = {"phase": "kernels", "kernel": "fused_ln_mlp_residual_bwd",
               "dtype": name, "threshold": t, "shape": [n, d, f],
               "max_abs_err": max(abs_errs), "max_rel_err_by_grad": errs,
               "tolerance_rel": tol, "deterministic": True,
               "save_h_max_abs_err": h_err, "save_h_fwd_ms": fwd_h_ms,
               "save_h_fwd_bound_ms": hb_ms, "save_h_fwd_bound_by": hb_by,
               "kernel_ms": ms, "device_ms": dev_ms, "host_ms": h_ms,
               "passes_device_ms": passes,
               "design": MLP_DESIGN[name], "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / ms,
               "device_bound_share": b_ms / dev_ms if dev_ms else None,
               **(gemms_library(gen, n, d, f, dev) if name == "bfloat16"
                  else {})}
        emit(row)
        rows.append(row)
    return rows


def check_flash_bwd(gen, card_peaks, dev):
    """The dq and dk/dv kernels at B = 32, H = 12 and FLASH_CASES
    against the plain backward (f32 math), tolerance 2e-2 (bf16) / 1e-4
    (f32) relative to each gradient's largest element; two launches must
    be bitwise equal."""
    import torch
    import torch.nn.functional as F
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    b, h = 32, 12
    bf16_rate, f32_rate, hbm = card_peaks
    rows = []
    for t_len, t, dt, dh in FLASH_CASES:
        q, k, v, do = [torch.randn(b * h, t_len, dh, generator=gen).to(
            dev, getattr(torch, dt)) for _ in range(4)]
        kw = dict(seed=4242, threshold=t)
        with torch.inference_mode():
            out, lse = fa._launch(q, k, v, **kw)
            delta = (do.float() * out.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta)
            dq = fa._launch_bwd_dq(*bwd, **kw)
            dk, dv = fa._launch_bwd_dkv(*bwd, **kw)
            dq2 = fa._launch_bwd_dq(*bwd, **kw)
            dk2, dv2 = fa._launch_bwd_dkv(*bwd, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                    and torch.equal(dv, dv2)):
                raise AssertionError("flash backward not deterministic")
            want = fa.flash_attention_bwd_plain(*bwd, **kw)
            errs = {g: rel_err(a, c) for g, a, c in
                    zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
            abs_err = {g: (a.float() - c.float()).abs().max().item()
                       for g, a, c in zip(("dq", "dk", "dv"),
                                          (dq, dk, dv), want)}
            if max(errs.values()) > TOL[dt]:
                raise AssertionError(f"flash backward {dt} T={t_len} t={t}: "
                                     f"{errs} exceed {TOL[dt]}")
            dq_ms = time_ms(lambda: fa._launch_bwd_dq(*bwd, **kw), 20)
            dkv_ms = time_ms(lambda: fa._launch_bwd_dkv(*bwd, **kw), 20)
            dq_dev = device_ms(lambda: fa._launch_bwd_dq(*bwd, **kw))
            dkv_dev = device_ms(lambda: fa._launch_bwd_dkv(*bwd, **kw))
            dq_host = host_ms(lambda: fa._launch_bwd_dq(*bwd, **kw))
            dkv_host = host_ms(lambda: fa._launch_bwd_dkv(*bwd, **kw))
            plain_ms = time_ms(
                lambda: fa.flash_attention_bwd_plain(*bwd, **kw), 3)
        q4, k4, v4 = (a.view(b, h, t_len, dh).detach().requires_grad_()
                      for a in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=t / 256.0)
        do4 = do.view(b, h, t_len, dh)

        def lib():
            return torch.autograd.grad(o4, (q4, k4, v4), do4,
                                       retain_graph=True)
        lib_ms = time_ms(lib, 20)
        lib_dev = device_ms(lib)
        elem, size = b * h * t_len * dh, q.element_size()
        rate = bf16_rate if dt == "bfloat16" else f32_rate
        io = 4 * elem * size + 2 * b * h * t_len * 4
        dq_b = bound(6.0 * b * h * t_len * t_len * dh, io + elem * size,
                     rate, hbm)
        dkv_b = bound(8.0 * b * h * t_len * t_len * dh,
                      io + 2 * elem * size, rate, hbm)
        lib_b = bound(10.0 * b * h * t_len * t_len * dh,
                      io + 3 * elem * size, rate, hbm)
        row = {"phase": "kernels", "kernel": "flash_attention_bwd",
               "design": {"dq": FLASH_DESIGN[dt], "dkv": FLASH_DESIGN[dt]},
               "dtype": dt, "threshold": t,
               "shape": [b, t_len, h, dh], "max_rel_err": errs,
               "max_abs_err": abs_err, "tolerance_rel": TOL[dt],
               "deterministic": True, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "dq_bound_ms": dq_b[0], "dq_bound_by": dq_b[1],
               "dq_bound_share": dq_b[0] / dq_ms,
               "dkv_bound_ms": dkv_b[0], "dkv_bound_by": dkv_b[1],
               "dkv_bound_share": dkv_b[0] / dkv_ms,
               "dq_device_ms": dq_dev, "dkv_device_ms": dkv_dev,
               "dq_host_ms": dq_host, "dkv_host_ms": dkv_host,
               "library_device_ms": lib_dev,
               "dq_device_bound_share": dq_b[0] / dq_dev if dq_dev else None,
               "dkv_device_bound_share": (dkv_b[0] / dkv_dev if dkv_dev
                                          else None),
               "bwd_bound_ms": lib_b[0]}
        emit(row)
        rows.append(row)
        del q4, k4, v4, o4
    return rows


# Every preset's width D (Ti, S, B, L, H; F = 4 D) at one row, a ragged
# 33 rows and the B/16 batch-32 row count.
PRESET_WIDTHS = (192, 384, 768, 1024, 1280)
WIDTH_ROWS = (1, 33, 32 * 197)


def check_mlp_widths(gen, dev, widths=None, rows_n=WIDTH_ROWS,
                     phase: str = "kernels") -> list:
    """Rows 1, 2, 6 and 7 at ``widths`` ((D, F) pairs; every preset's, F =
    4 D, by default) and ``rows_n``, bf16 and f32, dropout on (t = 26):
    each forward and its saved h within TOL of the plain version at the
    true widths, each backward gradient within 2e-2 (bf16) / 1e-4 (f32)
    of its largest element, of the parameter's shape and bitwise equal
    over two launches. One row per width and dtype with the largest
    errors over the row counts."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    core_keys = ("x2", "w1", "b1", "w2", "b2")
    rows = []
    for d, f in widths or [(w, 4 * w) for w in PRESET_WIDTHS]:
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            tol_b = 2e-2 if name == "bfloat16" else 1e-4
            fwd_err = {"row1": 0.0, "row6": 0.0}
            bwd_err = {"row2": 0.0, "row7": 0.0}
            t0 = time.perf_counter()
            for n in rows_n:
                p = _mlp_inputs(gen, n, d, f, dtype, dev)
                dout = torch.randn(n, d, generator=gen).to(dev, dtype)
                ln_kw = dict(eps=1e-6, seed=31, threshold=26)
                core_kw = dict(seed=31, threshold=26)
                core = {k: p[k] for k in core_keys}
                with torch.inference_mode():
                    cases = (
                        ("row1", "row2", fused_mlp._launch,
                         fused_mlp.ln_mlp_residual_plain, p, ln_kw,
                         fused_mlp._launch_bwd,
                         fused_mlp.ln_mlp_residual_bwd_plain,
                         lambda h: (p["x2"], h, p["gamma"], p["beta"],
                                    p["w1"], p["w2"], dout)),
                        ("row6", "row7", fused_mlp._launch_core,
                         fused_mlp.mlp_core_plain, core, core_kw,
                         fused_mlp._launch_core_bwd,
                         fused_mlp.mlp_core_bwd_plain,
                         lambda h: (p["x2"], h, p["w1"], p["b1"], p["w2"],
                                    dout)))
                    for fr, br, fwd, fwd_plain, args, kw, bwd, bwd_plain, \
                            bwd_args in cases:
                        out, h = fwd(**args, **kw, save_h=True)
                        ref, h_ref = fwd_plain(**args, **kw, save_h=True)
                        fwd_err[fr] = max(fwd_err[fr],
                                          close(out, ref, TOL[name]),
                                          close(h, h_ref, TOL[name]))
                        b_args = bwd_args(h_ref)
                        got, again = bwd(*b_args, **kw), bwd(*b_args, **kw)
                        want = bwd_plain(*b_args, **kw)
                        for a, b, c in zip(got, again, want):
                            tag = f"{br} D={d} F={f} N={n} {name}"
                            if not torch.equal(a, b):
                                raise AssertionError(
                                    f"{tag}: backward not deterministic")
                            if a.shape != c.shape:
                                raise AssertionError(
                                    f"{tag}: gradient shape {a.shape}")
                            e = rel_err(a, c)
                            if e > tol_b:
                                raise AssertionError(
                                    f"{tag}: gradient off by {e} > {tol_b}")
                            bwd_err[br] = max(bwd_err[br], e)
                torch.cuda.synchronize()
            row = {"phase": phase, "check": "mlp_widths", "d": d, "f": f,
                   "padded_to": [fused_mlp._padded(d), fused_mlp._padded(f)],
                   "dtype": name, "rows": list(rows_n), "threshold": 26,
                   "fwd_max_abs_err": fwd_err, "tolerance": TOL[name],
                   "bwd_max_rel_err": bwd_err, "bwd_tolerance_rel": tol_b,
                   "deterministic": True,
                   "seconds": round(time.perf_counter() - t0, 3)}
            emit(row)
            rows.append(row)
    return rows


MLP_CORE_GRADS = ("dx", "dw1", "db1", "dw2", "db2")
# (rows, hidden width, dtype name, threshold): the B/16 batch-32 rows at
# the full and the tp = 2 hidden width, then the parallel phase's own
# per-microbatch shape (batch 8 / M = 2 -> 4 * 197 rows, F / tp = 1536).
CORE_CASES = [(32 * 197, f, dt, t) for f in (3072, 1536)
              for dt, t in (("bfloat16", 0), ("bfloat16", 26),
                            ("float32", 0))] + [(4 * 197, 1536, "bfloat16",
                                                 26)]
CORE_MAIN_PATH = (4 * 197, 1536, "bfloat16", 26)


def check_fused_mlp_core(gen, card_peaks, dev):
    """Rows 6 and 7 (the MLP core, forward with and without the saved h,
    and the backward) against their plain versions at CORE_CASES; times
    with CUDA events beside the bound."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    d = 768
    bf16_rate, f32_rate, hbm = card_peaks
    rows = []
    for n, f, name, t in CORE_CASES:
        dtype = getattr(torch, name)
        p = _mlp_inputs(gen, n, d, f, dtype, dev)
        args = (p["x2"], p["w1"], p["b1"], p["w2"], p["b2"])
        kw = dict(seed=20261018, threshold=t)
        dout = torch.randn(n, d, generator=gen).to(dev, dtype)
        with torch.inference_mode():
            out = fused_mlp._launch_core(*args, **kw)
            out_h, h = fused_mlp._launch_core(*args, **kw, save_h=True)
            torch.cuda.synchronize()
            ref, h_ref = fused_mlp.mlp_core_plain(*args, **kw, save_h=True)
            if not torch.equal(out, out_h):
                raise AssertionError("MLP core forward differs with save_h")
            err = close(out, ref, TOL[name])
            h_check = saved_h_check(h, h_ref, p)
            bwd = (p["x2"], h_ref, p["w1"], p["b1"], p["w2"], dout)
            got = fused_mlp._launch_core_bwd(*bwd, **kw)
            again = fused_mlp._launch_core_bwd(*bwd, **kw)
            torch.cuda.synchronize()
            want = fused_mlp.mlp_core_bwd_plain(*bwd, **kw)
            errs, abs_errs = {}, []
            for g_name, a, b, c in zip(MLP_CORE_GRADS, got, again, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"MLP core backward {g_name} is "
                                         "not deterministic")
                errs[g_name] = rel_err(a, c)
                abs_errs.append((a.float() - c.float()).abs().max().item())
            tol = 2e-2 if name == "bfloat16" else 1e-4
            bad = {k: v for k, v in errs.items() if v > tol}
            if bad:
                raise AssertionError(f"MLP core backward {name} t={t} "
                                     f"F={f}: {bad} exceed {tol}")
            ms = time_ms(lambda: fused_mlp._launch_core(*args, **kw), 20)
            fwd_dev = device_ms(lambda: fused_mlp._launch_core(*args, **kw))
            h_ms = time_ms(lambda: fused_mlp._launch_core(
                *args, **kw, save_h=True), 10)
            h_dev = device_ms(lambda: fused_mlp._launch_core(
                *args, **kw, save_h=True))
            plain_ms = time_ms(lambda: fused_mlp.mlp_core_plain(*args, **kw),
                               5)
            bwd_ms = time_ms(lambda: fused_mlp._launch_core_bwd(*bwd, **kw),
                             10)
            bwd_dev = device_ms(
                lambda: fused_mlp._launch_core_bwd(*bwd, **kw))
            bwd_passes = kernel_breakdown(
                lambda: fused_mlp._launch_core_bwd(*bwd, **kw))
            bwd_plain_ms = time_ms(
                lambda: fused_mlp.mlp_core_bwd_plain(*bwd, **kw), 3)
        s_ = dtype.itemsize
        rate = bf16_rate if name == "bfloat16" else f32_rate
        # forward in: x, W1, b1, W2, b2; out: out (+ h).
        f_bytes = 2 * n * d * s_ + 2 * d * f * s_ + (f + d) * s_
        b_ms, b_by = bound(4.0 * n * d * f, f_bytes, rate, hbm)
        hb_ms, hb_by = bound(4.0 * n * d * f, f_bytes + n * f * s_, rate,
                             hbm)
        # backward in: x, h, dO, W1, W2; out: dx, dW1, dW2, db1, db2.
        g_bytes = (3 * n * d + n * f) * s_ + 4 * d * f * s_ + (f + d) * s_
        g_ms, g_by = bound(8.0 * n * d * f, g_bytes, rate, hbm)
        row = {"phase": "kernels", "kernel": "fused_mlp_core",
               "dtype": name, "threshold": t, "shape": [n, d, f],
               "max_abs_err": err, "tolerance": TOL[name],
               **h_check,
               "design": MLP_DESIGN[name], "kernel_ms": ms,
               "device_ms": fwd_dev, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "save_h_fwd_ms": h_ms, "save_h_fwd_device_ms": h_dev,
               "save_h_fwd_bound_ms": hb_ms, "save_h_fwd_bound_by": hb_by,
               "bwd_max_abs_err": max(abs_errs),
               "bwd_max_rel_err_by_grad": errs, "bwd_tolerance_rel": tol,
               "bwd_deterministic": True, "bwd_ms": bwd_ms,
               "bwd_plain_ms": bwd_plain_ms, "bwd_bound_ms": g_ms,
               "bwd_bound_by": g_by, "bwd_device_ms": bwd_dev,
               "bwd_passes_device_ms": bwd_passes,
               "bwd_design": MLP_DESIGN[name],
               "bwd_bound_share": g_ms / bwd_ms,
               "bwd_device_bound_share": g_ms / bwd_dev if bwd_dev else None,
               **({"bwd_" + k: v for k, v in gemms_library(
                   gen, n, d, f, dev).items()} if name == "bfloat16"
                  else {}),
               **(fwd_gemms_library(gen, n, d, f, dev) if name == "bfloat16"
                  else {})}
        if t:
            row["masks_bit_identical"] = core_masks(p, kw, dev)
        emit(row)
        rows.append(row)
    return rows


# The saved h is x @ W1 + b1 summed in f32 and rounded once to the compute
# dtype; the kernel and the plain version sum in different orders, so where
# the f32 sums straddle a rounding boundary they round to adjacent values.
# Each h must be within one bf16 ulp of the plain h, the ulp taken at
# max(|plain h|, H_ULP_FLOOR): below the floor h comes from cancellation,
# and f32 summation-order noise spans many ulps of so small a value. The
# worst element without the floor is printed with the exact (f64) h.
H_ULP_FLOOR = 2.0 ** -8
H_MAX_ULPS = 1.0


def bf16_ulps(a, b, floor: float):
    """|a - b| per element in bf16 ulps (8 significant bits) of
    max(|b|, floor)."""
    import torch
    scale = b.float().abs().clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return (a.float() - b.float()).abs() / ulp


def saved_h_check(h, h_ref, p) -> dict:
    """The kernel's saved h against the plain h (see H_ULP_FLOOR)."""
    import torch
    ulps = bf16_ulps(h, h_ref, H_ULP_FLOOR)
    raw = bf16_ulps(h, h_ref, 2.0 ** -126)
    i = int(raw.argmax())
    row, col = divmod(i, h.shape[1])
    exact = float(p["x2"][row].double() @ p["w1"][:, col].double()
                  + p["b1"][col].double())
    out = {"save_h_max_abs_err": (h.float() - h_ref.float()).abs().max()
           .item(),
           "save_h_max_ulps": ulps.max().item(),
           "save_h_ulp_floor": H_ULP_FLOOR,
           "save_h_max_ulps_without_floor": raw[row, col].item(),
           "save_h_there": {"plain": h_ref[row, col].item(),
                            "kernel": h[row, col].item(), "exact": exact}}
    if not bool(torch.isfinite(h).all()) or \
            out["save_h_max_ulps"] > H_MAX_ULPS:
        raise AssertionError(f"MLP core saved h off the plain h: {out}")
    return out


def core_masks(p, kw, dev) -> bool:
    """The MLP core's hidden keep mask recovered by feeding ones: x = 0,
    w1 = 0, b1 = 1 make h = 1 everywhere; b2 = 0 and w2 = a block selector
    [I; 0] shifted by k*D give out[:, j] = keep[:, k*D + j] * const, so
    every hidden column is read once. The zero pattern must equal the
    plain version's bit for bit."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    n, d = p["x2"].shape
    f = p["w1"].shape[1]
    dt = p["x2"].dtype
    ones = dict(x2=torch.zeros_like(p["x2"]), w1=torch.zeros_like(p["w1"]),
                b1=torch.ones_like(p["b1"]), b2=torch.zeros_like(p["b2"]))
    with torch.inference_mode():
        for k in range(f // d):
            sel = torch.zeros(f, d, dtype=dt, device=dev)
            sel[k * d:(k + 1) * d] = torch.eye(d, dtype=dt, device=dev)
            a = fused_mlp._launch_core(**ones, w2=sel, **kw) == 0
            b = fused_mlp.mlp_core_plain(**ones, w2=sel, **kw) == 0
            if not torch.equal(a, b):
                raise AssertionError("MLP core dropout keep mask differs "
                                     "from the plain version's")
            if not 0.05 < a.float().mean().item() < 0.16:
                raise AssertionError("MLP core dropout rate off")
    return True


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


# The flash cases (T, threshold, dtype, Dh) at B = 32, H = 12: bf16 (the
# wgmma kernels) at the B/16 shapes, dropout off and at t = 26, one f32
# case (the SIMT kernels), then ViT-H/14's Dh = 80 (run on operands padded
# to 128) and Dh = 256 (the backward's two-warpgroup work split).
FLASH_CASES = [(t_len, t, "bfloat16", dh) for dh in (64, 80, 256)
               for t_len in (197, 577) for t in (0, 26)]
FLASH_CASES.insert(4, (197, 0, "float32", 64))
FLASH_DESIGN = {"bfloat16": "wgmma+tma", "float32": "simt"}


# The MLP GEMM kernel's epilogue kinds (csrc/mlp_common.cuh, enum Epi):
# the forward's fc1 and fc2, the rest the backward's.
MLP_FWD_EPIS = ("3", "4", "5")


def hgmma_counts() -> dict:
    """HGMMA (wgmma) instructions per kernel function of the built flash
    and MLP libraries, read from ``cuobjdump -sass``; raises if any bf16
    tensor-core kernel (the flash forward, the dq and dk/dv kernels of
    every head dim, and every ``gemm_bf16`` instantiation of the MLP
    forwards and backwards, rows 1, 2, 6 and 7) has none."""
    import re
    from pytorch_vit_paper_replication_tpu_torch.ops import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    per_fn = {}
    for lib in ("flash_attention", "flash_attention_bwd", "fused_mlp",
                "fused_mlp_bwd", "fused_mlp_core"):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(lib))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                # flash_<kind><DH, ..., MASK> (mangled ILi64ELb1EE).
                flash = re.search(
                    r"(flash_(?:fwd|bwd)_[a-z0-9_]+?)I((?:L[ib]\d+E)+)E",
                    line)
                gemm = re.search(r"gemm_bf16ILi(\d)ELb(\d)ELb(\d)E", line)
                if flash:
                    args = re.findall(r"L[ib](\d+)E", flash.group(2))
                    fn = f"{flash.group(1)}<{','.join(args)}>"
                elif gemm:
                    fn = f"{lib}:gemm_bf16<{','.join(gemm.groups())}>"
                else:
                    fn = f"{lib}:" + line.split("Function :")[1].strip()
                per_fn.setdefault(fn, 0)
            elif fn is not None and "HGMMA" in line:
                per_fn[fn] += 1

    def total(*keys, epis=None):
        return sum(n for f, n in per_fn.items()
                   if all(k in f for k in keys) and
                   (epis is None or f.split("<")[1][0] in epis))
    bwd_epis = ("0", "1", "2")
    out = {"vit_flash_fwd": total("flash_fwd_wgmma"),
           "vit_flash_bwd_dq": total("flash_bwd_dq_wg2")
           + total("flash_bwd_dq_split"),
           "vit_flash_bwd_dkv": total("flash_bwd_dkv_wg2")
           + total("flash_bwd_dkv_split"),
           "vit_lnmlp_fwd": total("fused_mlp:", "gemm_bf16"),
           "vit_mlp_fwd": total("fused_mlp_core:", "gemm_bf16",
                                epis=MLP_FWD_EPIS),
           "vit_lnmlp_bwd": total("fused_mlp_bwd:", "gemm_bf16"),
           "vit_mlp_bwd": total("fused_mlp_core:", "gemm_bf16",
                                epis=bwd_epis)}
    tensor_core = {f: n for f, n in per_fn.items() if "gemm_bf16" in f or (
        f.startswith("flash_") and "simt" not in f)}
    if not all(out.values()) or not all(tensor_core.values()):
        raise AssertionError(f"no HGMMA in a bf16 tensor-core kernel: "
                             f"{per_fn}")
    return {**out, "per_function": per_fn}


def check_flash(gen, card_peaks, dev):
    import torch
    import torch.nn.functional as F
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    emit({"phase": "kernels", "check": "hgmma", "counts": hgmma_counts()})
    b, h = 32, 12
    bf16_rate, f32_rate, hbm = card_peaks
    rows = []
    for t_len, t, dt, dh in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = [torch.randn(b * h, t_len, dh, generator=gen).to(
            dev, dtype) for _ in range(3)]
        kw = dict(seed=777, threshold=t)
        with torch.inference_mode():
            out, lse = fa._launch(q, k, v, **kw)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
            err = close(out, ref, TOL[dt])
            lse_err = close(lse, ref_lse, 1e-4)
            ms = time_ms(lambda: fa._launch(q, k, v, **kw), 20)
            plain_ms = time_ms(
                lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
            q4, k4, v4 = (a.view(b, h, t_len, dh) for a in (q, k, v))

            def lib():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, dropout_p=t / 256.0)
            lib_ms = time_ms(lib, 20)
            k_dev = device_ms(lambda: fa._launch(q, k, v, **kw))
            lib_dev = device_ms(lib)
        size = q.element_size()
        nbytes = 4 * b * h * t_len * dh * size + b * h * t_len * 4
        b_ms, b_by = bound(4.0 * b * h * t_len * t_len * dh, nbytes,
                           bf16_rate if dt == "bfloat16" else f32_rate, hbm)
        row = {"phase": "kernels", "kernel": "flash_attention",
               "design": FLASH_DESIGN[dt], "dtype": dt, "threshold": t,
               "shape": [b, t_len, h, dh], "max_abs_err": err,
               "lse_max_abs_err": lse_err, "tolerance": TOL[dt],
               "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / ms, "kernel_device_ms": k_dev,
               "library_device_ms": lib_dev,
               "device_bound_share": b_ms / k_dev if k_dev else None}
        if t:
            row["masks_bit_identical"] = flash_masks(t_len, kw, dev, dh)
        emit(row)
        rows.append(row)
    return rows


def flash_masks(t_len, kw, dev, dh: int = 64, mask_form=None) -> bool:
    """Recover the attention keep mask by feeding ones: q = k = 0 give
    uniform weights 1/T; v = a one-hot selector of key block c (v[j, d] =
    1 iff j = Dh c + d) makes out[row, d] = keep[row, Dh c + d] / (T keep).
    Every column block's zero pattern must match the plain version's. With
    ``mask_form`` (MASK_FORMS at B = 2, H = 12) the weights are uniform
    over the attended keys and the zeros are the dropped or masked ones;
    the drop rate is read over the attended ones."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    bh = 24
    attend = None
    if mask_form is not None:
        m = ops_mask(torch.Generator().manual_seed(11), mask_form, t_len,
                     t_len, dev, b=2, h=12)
        kw = dict(kw, mask=fa.normalize_mask(m, 2, 12, t_len, t_len))
        attend = kw["mask"].expand(bh).expand(-1, t_len, -1)
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
            dropped = a if attend is None else a[attend[..., cols]]
            if not 0.05 < dropped.float().mean().item() < 0.16:
                raise AssertionError("flash dropout rate off")
    return True


# --------------------------------------------------------- phase 2b: ops
# The mask forms of JAX's _normalize_mask at the B/16 shapes (B = 32,
# H = 12, T = 197): shape with "q" / "k" for Tq / Tk.
OPS_B, OPS_H = 32, 12
MASK_FORMS = {"key_padding": (OPS_B, 1, 1, "k"), "shared": (1, 1, "q", "k"),
              "per_head": (1, OPS_H, "q", "k"),
              "full": (OPS_B, OPS_H, "q", "k"),
              "q_bcast_per_head": (1, OPS_H, 1, "k"),
              "key_bcast": (OPS_B, 1, "q", 1)}
# Flash cases beyond the mask forms at (197, 197, Dh 64): (Tq, Tk, Dh,
# mask form or None, dtype names).
FLASH_OPS_CASES = [(197, 577, 64, None, ("bfloat16", "float32")),
                   (577, 197, 64, None, ("bfloat16", "float32")),
                   (197, 577, 64, "key_padding", ("bfloat16",)),
                   (577, 197, 64, "full", ("bfloat16",)),
                   (197, 197, 80, "full", ("bfloat16",)),
                   (197, 197, 256, "full", ("bfloat16",))]
# MLP widths off the kernels' multiple of 64 and the row counts.
OFF64_WIDTHS = ((200, 800), (100, 300), (1000, 4000))
OFF64_ROWS = (33, 32 * 197)
# Quantized probs storage on the xla path: B/16 steps per format.
QUANT_STEPS = 3


def ops_mask(gen, form, tq, tk, dev, b=OPS_B, h=OPS_H):
    """A seeded bool mask of ``form`` (70% attend; key 0 always attends
    but in the key-broadcast form, whose rows are masked whole: about 30%
    of the query rows of each batch attend to no key)."""
    import torch
    shape = [{"q": tq, "k": tk}.get(x, x) for x in MASK_FORMS[form]]
    shape[0] = min(shape[0], b)
    shape[1] = min(shape[1], h)
    m = torch.rand(*shape, generator=gen) < 0.7
    if shape[-1] > 1:
        m[..., 0] = True
    return m.to(dev)


def flash_vs_plain(gen, dev, dt, tq, tk, dh, form, threshold):
    """Rows 3-5 at ``[B*H, Tq|Tk, Dh]`` with the folded mask of ``form``
    against the plain versions: out within TOL, lse 1e-4, each gradient
    within TOL of its largest element, the backward bitwise deterministic;
    query rows that attend to no key exactly 0 in out and dq. Returns the
    row's numbers."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    dtype = getattr(torch, dt)
    bh = OPS_B * OPS_H
    q, do = (torch.randn(bh, tq, dh, generator=gen).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, tk, dh, generator=gen).to(dev, dtype)
            for _ in range(2))
    mask = None if form is None else fa.normalize_mask(
        ops_mask(gen, form, tq, tk, dev), OPS_B, OPS_H, tq, tk)
    kw = dict(seed=515, threshold=threshold, mask=mask)
    with torch.inference_mode():
        out, lse = fa._launch(q, k, v, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        delta = (do.float() * ref.float()).sum(-1)
        bwd = (q, k, v, do, ref_lse, delta)
        dq = fa._launch_bwd_dq(*bwd, **kw)
        dk, dv = fa._launch_bwd_dkv(*bwd, **kw)
        again = (fa._launch_bwd_dq(*bwd, **kw), *fa._launch_bwd_dkv(*bwd,
                                                                  **kw))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            raise AssertionError(f"flash backward {form} not deterministic")
        want = fa.flash_attention_bwd_plain(*bwd, **kw)
    tag = f"flash {dt} Tq={tq} Tk={tk} Dh={dh} mask={form} t={threshold}"
    err = close(out, ref, TOL[dt])
    lse_err = close(lse, ref_lse, 1e-4)
    errs = {g: rel_err(a, c) for g, a, c in zip(("dq", "dk", "dv"),
                                                (dq, dk, dv), want)}
    if max(errs.values()) > TOL[dt]:
        raise AssertionError(f"{tag}: {errs} exceed {TOL[dt]}")
    dead = 0
    if mask is not None:
        alive = mask.expand(bh).expand(-1, tq, -1).any(-1)
        dead = int((~alive).sum())
        if out[~alive].any() or dq[~alive].any():
            raise AssertionError(f"{tag}: rows that attend to no key are "
                                 "not zero in out and dq")
        if form == "key_bcast" and not dead:
            raise AssertionError(f"{tag}: no fully masked row to check")
    return {"dtype": dt, "q_len": tq, "kv_len": tk, "dh": dh, "mask": form,
            "threshold": threshold, "max_abs_err": err,
            "lse_max_abs_err": lse_err, "max_rel_err": errs,
            "tolerance": TOL[dt], "fully_masked_rows_zero": dead,
            "deterministic": True}


def flash_mask_times(gen, card_peaks, dev) -> list:
    """Device ms of rows 3, 4 and 5 (bf16, Dh 64, no dropout) at T = 197
    and 577: unmasked, with the key-padding mask and with the full mask,
    measured in this one run; the bound of each counts the mask's packed
    bits, read once; the packing (``Mask.bits``, once per attention call,
    kept for the backward) timed apart."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    bf16_rate, _, hbm = card_peaks
    b, h, dh = OPS_B, OPS_H, 64
    rows = []
    for t_len in (197, 577):
        q, k, v, do = (torch.randn(b * h, t_len, dh, generator=gen).to(
            dev, torch.bfloat16) for _ in range(4))
        for form in (None, "key_padding", "full"):
            mask = None if form is None else fa.normalize_mask(
                ops_mask(gen, form, t_len, t_len, dev), b, h, t_len, t_len)
            kw = dict(seed=1, threshold=0, mask=mask)
            with torch.inference_mode():
                out, lse = fa._launch(q, k, v, **kw)
                delta = (do.float() * out.float()).sum(-1)
                bwd = (q, k, v, do, lse, delta)
                ms = {"fwd": device_ms(lambda: fa._launch(q, k, v, **kw)),
                      "dq": device_ms(lambda: fa._launch_bwd_dq(*bwd, **kw)),
                      "dkv": device_ms(
                          lambda: fa._launch_bwd_dkv(*bwd, **kw))}
                pack_ms = None if mask is None else time_ms(
                    lambda: fa.Mask(mask.rows, mask.mode, h).bits(), 20)
            elem = b * h * t_len * dh * 2
            m_bytes = 0 if mask is None else mask.bits().numel()
            io = {"fwd": 4 * elem + b * h * t_len * 4,
                  "dq": 5 * elem + 2 * b * h * t_len * 4,
                  "dkv": 6 * elem + 2 * b * h * t_len * 4}
            flops = {"fwd": 4.0, "dq": 6.0, "dkv": 8.0}
            bounds = {kk: bound(flops[kk] * b * h * t_len * t_len * dh,
                                io[kk] + m_bytes, bf16_rate, hbm)
                      for kk in ms}
            row = {"phase": "ops", "check": "flash_mask_times", "T": t_len,
                   "mask": form, "mask_bits_bytes": m_bytes,
                   "device_ms": ms, "pack_ms": pack_ms,
                   "bound_ms": {kk: bb[0] for kk, bb in bounds.items()},
                   "bound_by": {kk: bb[1] for kk, bb in bounds.items()}}
            emit(row)
            rows.append(row)
    return rows


def off64_mlp_times(gen, dev) -> list:
    """Device ms of rows 1, 2, 6 and 7 (bf16, N = 32 * 197, no dropout) at
    each off-64 width and at the width its operands are padded to, the
    wrapper's padding copies included in the off-64 times."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    n = 32 * 197
    rows = []
    for d0, f0 in OFF64_WIDTHS:
        for d, f in ((d0, f0), (fused_mlp._padded(d0), fused_mlp._padded(f0))):
            p = _mlp_inputs(gen, n, d, f, torch.bfloat16, dev)
            dout = torch.randn(n, d, generator=gen).to(dev, torch.bfloat16)
            core = {k: p[k] for k in ("x2", "w1", "b1", "w2", "b2")}
            with torch.inference_mode():
                _, h = fused_mlp._launch(**p, eps=1e-6, seed=0, threshold=0,
                                         save_h=True)
                ln_b = (p["x2"], h, p["gamma"], p["beta"], p["w1"], p["w2"],
                        dout)
                core_b = (p["x2"], h, p["w1"], p["b1"], p["w2"], dout)
                ms = {
                    "row1": device_ms(lambda: fused_mlp._launch(
                        **p, eps=1e-6, seed=0, threshold=0)),
                    "row2": device_ms(lambda: fused_mlp._launch_bwd(
                        *ln_b, eps=1e-6, seed=0, threshold=0)),
                    "row6": device_ms(lambda: fused_mlp._launch_core(
                        **core, seed=0, threshold=0)),
                    "row7": device_ms(lambda: fused_mlp._launch_core_bwd(
                        *core_b, seed=0, threshold=0))}
            row = {"phase": "ops", "check": "mlp_off64_times", "n": n,
                   "d": d, "f": f, "off64": (d, f) == (d0, f0),
                   "device_ms": ms}
            emit(row)
            rows.append(row)
    return rows


def quant_pv_card_vs_cpu(gen, dev) -> dict:
    """``_QuantizedSoftmaxPV`` forward and backward on the card against
    the same call on the CPU, f32 logits [2, 12, 197, 197] and v, for
    each 8-bit format: the stored codes may differ where the card's and
    the CPU's exp round a weight to the other side of a code boundary, so
    the forward is held to one code step of one weight (the format's
    largest step over [0, 1] times max |v|) and its mean error to 1e-6;
    the gradients within 2e-3 of their largest elements."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import attention
    step = {"u8": 1 / 255, "fp8_e4m3": 2.0 ** -4, "fp8_e5m2": 2.0 ** -3}
    logits = (torch.randn(2, 12, 197, 197, generator=gen) * 2.0)
    v = torch.randn(2, 197, 12, 64, generator=gen)
    g = torch.randn(2, 197, 12, 64, generator=gen)
    out = {}
    for pd in ("u8", "fp8_e4m3", "fp8_e5m2"):
        res = {}
        for where in ("cpu", "card"):
            lg = logits.to(dev if where == "card" else "cpu").requires_grad_()
            vv = v.to(lg.device).requires_grad_()
            o = attention._QuantizedSoftmaxPV.apply(lg, vv, "saturating", pd,
                                                    pd, torch.float32)
            dl, dv = torch.autograd.grad(o, (lg, vv), g.to(lg.device))
            res[where] = [t.detach().cpu() for t in (o, dl, dv)]
        (o_c, dl_c, dv_c), (o_g, dl_g, dv_g) = res["cpu"], res["card"]
        err = (o_g - o_c).abs()
        if not (err.max() <= 1e-5 + step[pd] * v.abs().max()
                and err.mean() <= 1e-6):
            raise AssertionError(f"_quantized_softmax_pv {pd}: card vs CPU "
                                 f"max {err.max()} mean {err.mean()}")
        errs = {"dlogits": rel_err(dl_g, dl_c), "dv": rel_err(dv_g, dv_c)}
        if max(errs.values()) > 2e-3:
            raise AssertionError(f"_quantized_softmax_pv {pd} backward: "
                                 f"{errs}")
        out[pd] = {"fwd_max_abs_err": err.max().item(),
                   "fwd_mean_abs_err": err.mean().item(),
                   "bwd_max_rel_err": errs}
    return out


def quant_train(dev) -> dict:
    """B/16 (batch 32, full depth, bf16) on the xla attention path with the
    probs stored in bf16 (the comparator), u8 and fp8_e4m3: QUANT_STEPS
    steps + eval each through ``engine.train``, losses finite, the fused
    MLP kernels launched and flash never; step walls per format and the
    device time of one profiled step after them."""
    import statistics
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    cfg = PRESETS[PRESET](num_classes=NUM_CLASSES).replace(
        attention_impl="xla")
    out = {}
    for pd in ("bf16", "u8", "fp8_e4m3"):
        metrics, results, counts, walls, state, batch = _train_run(
            cfg.replace(attention_probs_dtype=pd), dev, QUANT_STEPS, seed=9)
        device = profile_step(state, batch)["device_ms_total"]
        del state
        torch.cuda.empty_cache()
        losses = _check_run(f"quant({pd})", metrics, counts, QUANT_STEPS,
                            False, loss_must_fall=False)
        out[pd] = {"losses": losses, "launches": counts,
                   "step_ms": [w * 1e3 for w in walls],
                   "step_ms_median_after_first": statistics.median(
                       walls[1:]) * 1e3, "profiled_step_device_ms": device}
    return out


def phase_ops(gen, card_peaks, dev) -> dict:
    """The kernels' whole contracts at the B/16 shapes (see the module
    docstring, phase 2b); returns the flash and MLP rows by kernel for
    the kernel list."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import attention
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    t0 = time.perf_counter()
    # The path: masked and cross-length attention through the public
    # dispatch, off-64 MLP widths through the public MLP ops, forward and
    # backward, the counts set to 0 right before and read right after.
    torch.cuda.synchronize()
    reset_counts()
    r = lambda *s: torch.randn(*s, generator=gen).to(  # noqa: E731
        dev, torch.bfloat16).requires_grad_()
    q, k, v = r(OPS_B, 197, OPS_H, 64), r(OPS_B, 197, OPS_H, 64), \
        r(OPS_B, 197, OPS_H, 64)
    for form in MASK_FORMS:
        out = attention.dot_product_attention(
            q, k, v, mask=ops_mask(gen, form, 197, 197, dev))
        out.float().square().mean().backward()
    k2, v2 = r(OPS_B, 577, OPS_H, 64), r(OPS_B, 577, OPS_H, 64)
    out = attention.dot_product_attention(q, k2, v2, impl="flash")
    out.float().square().mean().backward()
    d, f = OFF64_WIDTHS[0]
    p = {kk: t.requires_grad_() for kk, t in _mlp_inputs(
        gen, 33, d, f, torch.bfloat16, dev).items()}
    y = fused_mlp.fused_ln_mlp_residual(*p.values(), dropout_rate=0.1,
                                        seed=5, deterministic=False)
    y = fused_mlp.fused_mlp(y, p["w1"], p["b1"], p["w2"], p["b2"],
                            dropout_rate=0.1, seed=6, deterministic=False)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    path = read_counts()
    want = {"flash_attention": len(MASK_FORMS) + 1,
            "flash_attention_bwd_dq": len(MASK_FORMS) + 1,
            "flash_attention_bwd_dkv": len(MASK_FORMS) + 1,
            "fused_ln_mlp_residual": 1, "fused_ln_mlp_residual_bwd": 1,
            "fused_mlp_core": 1, "fused_mlp_core_bwd": 1}
    if path != want:
        raise AssertionError(f"ops path launches {path} != {want}")
    del q, k, v, k2, v2, p, y, out
    emit({"phase": "ops", "check": "path_launches", "launches": path})

    flash_rows = []
    for dt in ("bfloat16", "float32"):
        for form in MASK_FORMS:
            flash_rows.append(flash_vs_plain(gen, dev, dt, 197, 197, 64, form,
                                             0))
    flash_rows.append(flash_vs_plain(gen, dev, "bfloat16", 197, 197, 64,
                                     "key_padding", 26))
    flash_rows.append(flash_vs_plain(gen, dev, "bfloat16", 197, 197, 64,
                                     "full", 26))
    for tq, tk, dh, form, dts in FLASH_OPS_CASES:
        for dt in dts:
            flash_rows.append(flash_vs_plain(gen, dev, dt, tq, tk, dh, form,
                                             0))
    for row in flash_rows:
        emit({"phase": "ops", "check": "flash_vs_plain", **row})
    # The keep bits under a mask: bit-identical to the plain version's.
    bits = flash_masks(197, dict(seed=777, threshold=26), dev,
                       mask_form="key_padding")
    torch.cuda.empty_cache()
    times = flash_mask_times(gen, card_peaks, dev)
    mlp_rows = check_mlp_widths(gen, dev, OFF64_WIDTHS, OFF64_ROWS, "ops")
    mlp_times = off64_mlp_times(gen, dev)
    torch.cuda.empty_cache()
    qpv = quant_pv_card_vs_cpu(gen, dev)
    quant = quant_train(dev)
    emit({"phase": "ops", "check": "quantized_probs", "ok": True,
          "pv_card_vs_cpu": qpv, "train_xla_b16": quant})
    emit({"phase": "ops", "ok": True, "masked_keep_bits_identical": bits,
          "seconds": round(time.perf_counter() - t0, 3)})
    return {"flash": flash_rows, "flash_times": times, "mlp": mlp_rows,
            "mlp_times": mlp_times, "path": path}


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
    # The default (auto) engine runs flash at T = 197 on the card; a second
    # engine on the same weights runs the xla attention to compare.
    xla_model = ViT(model.config.replace(attention_impl="xla"))
    xla_model.load_state_dict(model.state_dict())
    eng_xla = InferenceEngine(xla_model, device=dev,
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
    xla_b0 = eng_xla.stats.counters["batches"]
    xla_futs = [(i, eng_xla.submit(rows[i])) for i in range(16)]
    xla_res = [(i, f.result(timeout=300)) for i, f in xla_futs]
    batches2 = eng_xla.stats.counters["batches"] - xla_b0
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
    if k2 != 12 * batches1 or k2 == 0:
        raise AssertionError(f"flash launches {k2} != 12 x {batches1}")
    # Flash vs xla attention: same weights, two attention paths (f32
    # online softmax vs bf16 logits + f32 softmax), bf16 activations
    # through 12 blocks.
    diffs = []
    for i, r in xla_res:
        if i not in probs_rows:
            probs_rows[i] = predict_image(eng.model, rows[i], classes)[2]
        diffs.append(float(np.abs(r.probs - probs_rows[i]).max()))
    flash_tol = 1e-3
    if max(diffs) > flash_tol:
        raise AssertionError(f"flash engine probs differ by {max(diffs)} "
                             f"> {flash_tol}")
    profile_rung(eng, np.stack(rows[:BUCKETS[-1]]))
    eng_xla.close()
    eng.close()
    emit({"phase": "serve", "ok": True, "fixture_s": round(fixture_s, 3),
          "warmup": warm, "requests": n_req, "batches": batches1,
          "xla_requests": len(xla_res), "xla_batches": batches2,
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
TRAIN_BATCH = 32
TRAIN_STEPS = 8
FLASH_STEPS = 3
EVAL_BATCHES = 2


def _counters():
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    return fused_mlp, fa


def reset_counts() -> None:
    fused_mlp, fa = _counters()
    fused_mlp.launches = fused_mlp.bwd_launches = 0
    fused_mlp.core_launches = fused_mlp.core_bwd_launches = 0
    fa.launches = fa.dq_launches = fa.dkv_launches = 0


def read_counts() -> dict:
    from pytorch_vit_paper_replication_tpu_torch.train import launch_counts
    return launch_counts()


def _train_run(cfg, dev, steps: int, seed: int):
    """``engine.train`` for one epoch of ``steps`` copies of one seeded
    batch plus an eval pass; returns (per-step metrics, results, launch
    counts, per-step wall seconds, state)."""
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import TrainConfig
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT

    tcfg = TrainConfig()
    model = ViT(cfg)
    model.load_state_dict(seeded_params(cfg, seed))
    model.to(dev)
    state = engine.TrainState.create(
        model=model, seed=tcfg.seed,
        tx=optim.make_optimizer(tcfg, steps))
    rng = np.random.default_rng(seed)
    n = TRAIN_BATCH

    def make_batch():
        return {"image": rng.standard_normal(
                    (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
                "label": rng.integers(0, cfg.num_classes, n)}
    train_batch = make_batch()
    eval_set = [dict(make_batch(), mask=np.ones(n, np.float32))
                for _ in range(EVAL_BATCHES)]
    step_fn = engine.make_train_step()
    per_step, walls = [], []

    def recording_step(st, batch):
        t0 = time.perf_counter()
        st, m = step_fn(st, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({k: v.detach() for k, v in m.items()})
        return st, m

    torch.cuda.synchronize()
    reset_counts()
    state, results = engine.train(
        state, lambda: iter([train_batch] * steps), lambda: iter(eval_set),
        epochs=1, train_step=recording_step, verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()
    metrics = [{k: float(v) for k, v in m.items()} for m in per_step]
    return metrics, results, counts, walls, state, train_batch


def _check_run(tag, metrics, counts, steps, flash: bool,
               loss_must_fall: bool = True, layers: int = 12):
    import math
    for i, m in enumerate(metrics):
        if not (math.isfinite(m["loss_sum"]) and
                math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{tag}: step {i} loss/grad_norm not "
                                 f"finite: {m}")
    losses = [m["loss_sum"] / m["count"] for m in metrics]
    if loss_must_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    forwards = steps + EVAL_BATCHES
    want = {"fused_ln_mlp_residual": layers * forwards,
            "fused_ln_mlp_residual_bwd": layers * steps,
            "fused_mlp_core": 0, "fused_mlp_core_bwd": 0,
            "flash_attention": layers * forwards if flash else 0,
            "flash_attention_bwd_dq": layers * steps if flash else 0,
            "flash_attention_bwd_dkv": layers * steps if flash else 0}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want} (one per "
                             f"block per step / eval batch)")
    return losses


def profile_step(state, batch, fold: bool = False) -> dict:
    """One train step under ``torch.profiler``: device time by kernel.
    With ``fold``, every call of the flash wrapper's ``_fold_heads`` (the
    ``[B, T, H, Dh] -> [B*H, T, Dh]`` copies of q, k and v) runs inside a
    ``flash_fold_heads`` profiler range: the result adds the calls and the
    range's device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from pytorch_vit_paper_replication_tpu_torch import engine
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)

    step = engine.make_train_step()
    fold_heads, calls = fa._fold_heads, []

    def traced_fold(x):
        calls.append(x.shape)
        with record_function("flash_fold_heads"):
            return fold_heads(x)

    if fold:
        fa._fold_heads = traced_fold
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        fa._fold_heads = fold_heads

    averages = prof.key_averages()
    events = [e for e in averages
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    top = sorted(events, key=dev_us, reverse=True)[:15]
    out = {"device_events": len(events),
           "device_ms_total": sum(dev_us(e) for e in events) / 1e3,
           "top_device_ms": [[e.key[:90], dev_us(e) / 1e3, e.count]
                             for e in top]}
    if fold:
        rng = [e for e in averages if e.key == "flash_fold_heads"]
        out["fold_heads"] = {
            "calls": len(calls),
            "device_ms": dev_us(rng[0], total=True) / 1e3 if rng else None}
    return out


# The T = 197 attention decision: rounds of interleaved unprofiled steps
# (auto, xla, then xla, auto, ...) for the wall, then profiled steps of
# each for the device time.
COMPARE_ROUNDS = 8
COMPARE_PROFILED = 3


def auto_vs_xla(cfg, dev) -> dict:
    """``attention_impl="auto"`` (flash at T = 197 on the card) against an
    explicit ``"xla"`` on the B/16 batch-32 train step, so the decision is
    measured again on every change of the kernels: two train states from
    the same seeded params, one seeded batch, stepped in turns so both
    meet the same card and host; wall medians over the unprofiled steps
    after the first of each, device medians (the profiler's kernel time of
    a step) over the profiled ones."""
    import statistics
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import TrainConfig
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT

    tcfg = TrainConfig()
    params = seeded_params(cfg, 3)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal(
        (TRAIN_BATCH, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
             "label": rng.integers(0, cfg.num_classes, TRAIN_BATCH)}
    impls = ("auto", "xla")
    states = {}
    for impl in impls:
        model = ViT(cfg.replace(attention_impl=impl))
        model.load_state_dict(params)
        model.to(dev)
        states[impl] = engine.TrainState.create(
            model=model, seed=tcfg.seed,
            tx=optim.make_optimizer(tcfg, 2 * COMPARE_ROUNDS))
    step = engine.make_train_step()
    walls = {impl: [] for impl in impls}
    for r in range(COMPARE_ROUNDS):
        for impl in (impls if r % 2 == 0 else impls[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[impl], _ = step(states[impl], batch)
            torch.cuda.synchronize()
            walls[impl].append((time.perf_counter() - t0) * 1e3)
    device = {impl: [] for impl in impls}
    for r in range(COMPARE_PROFILED):
        for impl in (impls if r % 2 == 0 else impls[::-1]):
            device[impl].append(
                profile_step(states[impl], batch)["device_ms_total"])
    del states
    torch.cuda.empty_cache()
    med = {impl: {"wall_ms_median": statistics.median(walls[impl][1:]),
                  "device_ms_median": statistics.median(device[impl]),
                  "wall_ms": walls[impl], "device_ms": device[impl]}
           for impl in impls}
    return {**med, "auto_minus_xla_wall_ms": (
        med["auto"]["wall_ms_median"] - med["xla"]["wall_ms_median"]),
            "auto_minus_xla_device_ms": (
        med["auto"]["device_ms_median"] - med["xla"]["device_ms_median"])}


def split_qkv_bias(tree: dict):
    """``(leaves, k_slices)``: the qkv bias ``[3, H, Dh]`` of every block
    split into its Q and V slices (kept as leaves) and its K slice, whose
    gradient is analytically zero (softmax is invariant to the shift
    ``q . b_k`` of a row), so both sides hold rounding noise there."""
    leaves, k_slices = {}, {}
    for name, v in tree.items():
        if name.endswith("qkv.bias"):
            leaves[name + "[q]"], leaves[name + "[v]"] = v[0], v[2]
            k_slices[name + "[k]"] = v[1]
        else:
            leaves[name] = v
    return leaves, k_slices


def step_errors(p0, card, cpu, lr: float) -> dict:
    """Errors of one train step on the card against the same step on the
    CPU. ``card`` and ``cpu`` are ``(metrics, grads, params after)``,
    ``p0`` the params before, all on the CPU. Gradients: the global
    relative error and the largest per-leaf error relative to the leaf's
    largest element. Params, in the form of the JAX trajectory tests:
    per leaf the drift between the sides over how far the CPU moved the
    leaf, and the same over all leaves; the K slices of the qkv bias are
    held in absolute terms (their update is Adam's normalised noise,
    at most lr per element on either side)."""
    (mg, gg, pg), (mc, gc, pc) = card, cpu

    def sq(a):
        return float(a.double().square().sum())
    g_card, _ = split_qkv_bias(gg)
    g_cpu, _ = split_qkv_bias(gc)
    (q_card, k_card), (q_cpu, k_cpu) = (split_qkv_bias(pg),
                                        split_qkv_bias(pc))
    q0, _ = split_qkv_bias(p0)
    drift = {k: sq(q_card[k] - q_cpu[k]) ** 0.5 for k in q_cpu}
    move = {k: sq(q_cpu[k] - q0[k]) ** 0.5 for k in q_cpu}
    return {
        "loss": abs(mg["loss_sum"] - mc["loss_sum"]) / abs(mc["loss_sum"]),
        "grad_norm": abs(mg["grad_norm"] - mc["grad_norm"])
        / mc["grad_norm"],
        "grads_global": (sum(sq(gg[k] - gc[k]) for k in gc)
                         / sum(sq(gc[k]) for k in gc)) ** 0.5,
        "grads_max_leaf": max(rel_err(g_card[k], g_cpu[k]) for k in g_cpu),
        "params_max_leaf_drift": max(drift[k] / max(move[k], 1e-12)
                                     for k in q_cpu),
        "params_global_drift": (sum(d * d for d in drift.values())
                                / sum(m * m for m in move.values())) ** 0.5,
        "qkv_bias_k_max_abs_over_lr": max(
            float((k_card[k] - k_cpu[k]).abs().max()) for k in k_cpu) / lr,
    }


# Bounds of step_errors: gradients and the loss 2e-3 relative (f32
# summation order only); params as in tests/test_torch_engine.py's
# trajectory test; the qkv-bias K slice within 2 lr (opposite signs).
# Both sides are deterministic, so a reading repeats exactly; on an H100
# the params read 4.9e-4 per leaf, 6.4e-5 global and 0.083 lr.
STEP_TOL = {"loss": 2e-3, "grad_norm": 2e-3, "grads_global": 2e-3,
            "grads_max_leaf": 2e-3, "params_max_leaf_drift": 5e-3,
            "params_global_drift": 2e-3, "qkv_bias_k_max_abs_over_lr": 2.0}


def _capture_grads(state, out: dict) -> None:
    """Make ``state.tx.apply`` copy the gradients it receives into
    ``out`` (the last step's stay)."""
    apply = state.tx.apply

    def capture(params, grads, opt_state, **kw):
        out.update({k: v.detach().cpu().clone() for k, v in grads.items()})
        return apply(params, grads, opt_state, **kw)
    state.tx.apply = capture


def f32_step_vs_cpu(dev) -> dict:
    """One f32 train step of a 2-layer ViT-B/16 (fused MLP and flash,
    mlp and attention dropout 0.1) on the card against the same step on
    the CPU, where the wrappers run their plain versions; errors and bounds
    in :func:`step_errors` and ``STEP_TOL``. The embedding dropout is
    off: its bits come from a device generator, and CPU and CUDA
    generators give different streams."""
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import (
        TrainConfig, vit_b16)
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT

    cfg = vit_b16(num_classes=NUM_CLASSES, num_layers=2, dtype="float32",
                  mlp_impl="fused", attention_impl="flash",
                  attn_dropout=0.1, embedding_dropout=0.0)
    tcfg = TrainConfig(warmup_fraction=0.0)
    rng = np.random.default_rng(5)
    batch = {"image": rng.standard_normal((8, 224, 224, 3)).astype(
        np.float32), "label": rng.integers(0, NUM_CLASSES, 8)}
    p0 = seeded_params(cfg, 9)
    out = []
    for device in (dev, torch.device("cpu")):
        model = ViT(cfg)
        model.load_state_dict(p0)
        model.to(device)
        st = engine.TrainState.create(
            model=model, seed=1, tx=optim.make_optimizer(tcfg, 10))
        grads = {}
        _capture_grads(st, grads)
        st, m = engine.make_train_step()(st, batch)
        after = {k: v.detach().cpu().clone()
                 for k, v in model.named_parameters()}
        out.append(({k: float(v) for k, v in m.items()}, grads, after))
    errs = step_errors({k: p0[k].float() for k in out[1][2]}, *out,
                       lr=tcfg.learning_rate)
    bad = {k: v for k, v in errs.items() if not v <= STEP_TOL[k]}
    if bad:
        raise AssertionError(f"f32 step on the card vs the CPU: {bad} "
                             f"exceed {STEP_TOL}")
    return errs


def phase_train(dev) -> dict:
    import statistics
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS

    cfg = PRESETS[PRESET](num_classes=NUM_CLASSES)
    t0 = time.perf_counter()
    metrics, results, counts, walls, state, batch = _train_run(
        cfg, dev, TRAIN_STEPS, seed=1)
    # auto runs flash at T = 197 on the card.
    losses = _check_run("train(auto)", metrics, counts, TRAIN_STEPS, True)
    step_s = statistics.median(walls[1:])
    torch.cuda.reset_peak_memory_stats()
    prof = profile_step(state, batch)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    f_metrics, f_results, f_counts, f_walls, f_state, f_batch = _train_run(
        cfg.replace(attention_impl="flash"), dev, FLASH_STEPS, seed=2)
    # Three steps are too few to require a falling loss; finite is required.
    f_losses = _check_run("train(flash)", f_metrics, f_counts, FLASH_STEPS,
                          True, loss_must_fall=False)
    f_prof = profile_step(f_state, f_batch, fold=True)
    del f_state
    torch.cuda.empty_cache()
    emit({"phase": "train", "ok": True, "batch": TRAIN_BATCH,
          "steps": TRAIN_STEPS, "losses": losses,
          "grad_norms": [m["grad_norm"] for m in metrics],
          "results": results, "launches": counts,
          "step_ms_median": step_s * 1e3,
          "step_ms_first": walls[0] * 1e3,
          "img_per_s": TRAIN_BATCH / step_s,
          "peak_memory_gib_profiled_step": peak_gib,
          "profile_one_step": prof,
          "flash_steps": FLASH_STEPS, "flash_losses": f_losses,
          "flash_launches": f_counts,
          "flash_step_ms_median": statistics.median(f_walls[1:]) * 1e3,
          "profile_one_flash_step": f_prof,
          "flash_results": f_results,
          "seconds": round(time.perf_counter() - t0, 3)})
    t1 = time.perf_counter()
    emit({"phase": "train_auto_vs_xla", "ok": True, "batch": TRAIN_BATCH,
          "rounds": COMPARE_ROUNDS, "profiled_rounds": COMPARE_PROFILED,
          **auto_vs_xla(cfg, dev),
          "seconds": round(time.perf_counter() - t1, 3)})
    t1 = time.perf_counter()
    emit({"phase": "train_f32_card_vs_cpu", "ok": True,
          "errors": f32_step_vs_cpu(dev), "tolerance": STEP_TOL,
          "seconds": round(time.perf_counter() - t1, 3)})
    return counts


PRESET_STEPS = 2
PRESET_LAYERS = 2


def phase_presets(dev) -> None:
    """Every other preset (Ti/16, S/16, L/16, H/14) at full width, cut to
    PRESET_LAYERS layers, bf16, the default dropouts and the default
    ``mlp_impl`` / ``attention_impl`` ("auto"): PRESET_STEPS train steps
    and the eval pass through ``engine.train`` on one seeded batch of 32,
    the launch counters set to 0 right before and read right after. The
    losses and grad norms must be finite and the fused MLP kernels
    (rows 1 and 2) launched in every block of every step; flash where auto
    picks it (Dh = 64; H/14's Dh = 80 stays on xla under auto)."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.ops.flash_attention import (
        KERNEL_HEAD_DIMS)
    for name in ("ViT-Ti/16", "ViT-S/16", "ViT-L/16", "ViT-H/14"):
        cfg = PRESETS[name](num_classes=NUM_CLASSES).replace(
            num_layers=PRESET_LAYERS)
        t0 = time.perf_counter()
        metrics, results, counts, walls, state, _ = _train_run(
            cfg, dev, PRESET_STEPS, seed=6)
        del state
        torch.cuda.empty_cache()
        flash = cfg.head_dim in KERNEL_HEAD_DIMS
        losses = _check_run(f"presets({name})", metrics, counts,
                            PRESET_STEPS, flash, loss_must_fall=False,
                            layers=PRESET_LAYERS)
        emit({"phase": "presets", "ok": True, "preset": name,
              "layers": PRESET_LAYERS, "width": cfg.embedding_dim,
              "mlp_size": cfg.mlp_size, "head_dim": cfg.head_dim,
              "tokens": cfg.seq_len,
              "batch": TRAIN_BATCH, "losses": losses,
              "grad_norms": [m["grad_norm"] for m in metrics],
              "launches": counts, "step_ms": [w * 1e3 for w in walls],
              "seconds": round(time.perf_counter() - t0, 3)})


# ------------------------------------------------------------- phase 5
PAR_BATCH = 8
PAR_MICRO = 2
PAR_STEPS = 3
# (a)'s depth, cut from B/16's 12 for the script's time limit: phase
# train_mesh (b) runs tp 2 x pp 2 at full depth through the train CLI.
PAR_LAYERS = 4
TP_DP_STEPS = 2
PAR_TIMEOUT_S = 300
# (b)'s gate, on the same weights with every bias shifted per channel
# (a replicated out/fc2 bias counted twice shows only then). The losses of
# both steps within the JAX package's pipeline x TP bound
# (tests/test_pipeline.py: rtol 1e-5). The last step's gradients per leaf,
# and their global norm, within TP_DP_GRAD_TOL of the leaf's largest
# element (the qkv bias's K slice, analytically zero, aside). The params
# after the steps elementwise within the JAX test's bound (rtol 1e-5, atol
# 1e-6) plus Adam's share of the gradient noise: the step of an element
# whose effective gradient (clipped, plus the coupled L2 term) is a share
# s of its leaf's largest moves by about lr * noise / s when the
# gradient's noise is that share of the leaf's largest, so the bound adds
# lr * min(2, TP_DP_GRAD_TOL / s). Where s >= 1e-2 that term is below the
# JAX atol (1e-6 = 1e-3 lr here); where the gradient is near zero, Adam's
# normalisation makes the summation-order noise a visible part of its
# step. The K slices within JAX's qkv-bias atol 5e-3. The elements over
# the JAX bound alone are counted and printed.
TP_DP_LOSS_RTOL = 1e-5
TP_DP_GRAD_TOL = 1e-5
JAX_PARAMS_BOUND = {"rtol": 1e-5, "atol": 1e-6, "qkv_bias_atol": 5e-3}


def _par_batch(cfg, n: int, seed: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal(
                (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
            "label": rng.integers(0, cfg.num_classes, n)}


def _rank_state(mesh, cfg, params, tcfg, total_steps: int):
    """make_pipeline_apply, the rank's slices of the full ``params``,
    shard_train_state (the order JAX's dryrun_multichip builds them)."""
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        rank_local_params)
    from pytorch_vit_paper_replication_tpu_torch.parallel import api, pipeline
    model = pipeline.make_pipeline_apply(cfg, mesh,
                                         num_microbatches=PAR_MICRO)
    model.load_state_dict(rank_local_params(params, mesh))
    return api.shard_train_state(engine.TrainState.create(
        model=model, tx=optim.make_optimizer(tcfg, total_steps), seed=7),
        mesh)


def pp_tp_rank(mesh) -> dict:
    """One rank of (a): ViT-B/16 at full width, PAR_LAYERS layers, dp 1 x
    tp 2 x pp 2, PAR_STEPS steps and one eval pass, the launch counters
    set to 0 right before and read right after."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import (
        PRESETS, TrainConfig)
    from pytorch_vit_paper_replication_tpu_torch.parallel import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS[PRESET](num_classes=NUM_CLASSES, num_layers=PAR_LAYERS)
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    state = _rank_state(mesh, cfg, seeded_params(cfg, 3), TrainConfig(),
                        PAR_STEPS)
    batch = api.shard_batch(_par_batch(cfg, PAR_BATCH, 4), mesh)
    step = api.make_parallel_train_step(state, mesh)
    eval_step = api.make_parallel_eval_step(state, mesh)
    metrics, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(PAR_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = {k: float(v) for k, v in eval_step(state, batch).items()}
    torch.cuda.synchronize()
    return {"coords": mesh.coords, "transport": mesh.transport,
            "device": str(mesh.device), "launches": read_counts(),
            "metrics": metrics, "eval": ev, "step_walls_s": walls,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def _tp_dp_cfg():
    from pytorch_vit_paper_replication_tpu_torch.configs import vit_b16
    return vit_b16(num_classes=NUM_CLASSES, num_layers=2, dtype="float32",
                   mlp_dropout=0.0, embedding_dropout=0.0, attn_dropout=0.0)


def _tp_dp_params(cfg) -> dict:
    """convert.seeded_params with every bias shifted per channel, as
    tests/test_pipeline.py does (a uniform shift would hide a bias counted
    twice behind LayerNorm)."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    return {k: v + 0.02 * torch.arange(v.shape[-1]) / v.shape[-1]
            if k.endswith(".bias") else v
            for k, v in seeded_params(cfg, 9).items()}


def _tp_dp_train():
    from pytorch_vit_paper_replication_tpu_torch.configs import TrainConfig
    return TrainConfig(warmup_fraction=0.1)


def tp_dp_rank(mesh) -> dict:
    """One rank of (b): the 2-layer f32 ViT-B/16 on dp 2 x tp 2,
    TP_DP_STEPS steps; rank 0 returns the full params after the steps and
    the last step's full gradients, gathered from every rank."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.parallel import (api,
                                                                  sharding)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tp_dp_cfg()
    state = _rank_state(mesh, cfg, _tp_dp_params(cfg), _tp_dp_train(), 10)
    batch = api.shard_batch(_par_batch(cfg, PAR_BATCH, 5), mesh)
    step = api.make_parallel_train_step(state, mesh)
    grads = {}
    _capture_grads(state, grads)
    metrics = []
    for _ in range(TP_DP_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = sharding.gather_state_dict(
        dict(state.model.named_parameters()), mesh)
    grads = sharding.gather_state_dict(grads, mesh)
    return {"coords": mesh.coords, "metrics": metrics,
            "params": params if mesh.rank == 0 else None,
            "grads": grads if mesh.rank == 0 else None}


def tp_dp_errors(p0, par, single, tcfg) -> dict:
    """(b)'s readings (see TP_DP_GRAD_TOL). ``par`` and ``single`` are
    ``(metrics, grads, params after)`` of the last step, ``p0`` the params
    before the steps, all on the CPU. ``params_worst_over_bound`` is the
    largest |parallel - single| over the gate's elementwise bound;
    ``largest_grad_share_over`` the largest share s among the elements
    over the JAX bound alone."""
    (mp, gp, pp), (ms, gs, ps) = par, single
    lr = tcfg.learning_rate
    g_par, _ = split_qkv_bias(gp)
    g_one, _ = split_qkv_bias(gs)
    clip = min(1.0, tcfg.grad_clip_norm / ms["grad_norm"])
    g_eff, _ = split_qkv_bias({
        k: g * clip + (tcfg.weight_decay * p0[k] if g.ndim > 1 else 0.0)
        for k, g in gs.items()})
    (q_par, k_par), (q_one, k_one) = split_qkv_bias(pp), split_qkv_bias(ps)
    worst_gate, worst_jax, n_over, share = 0.0, 0.0, 0, 0.0
    for k, w in q_one.items():
        d = (q_par[k] - w).abs()
        jax = JAX_PARAMS_BOUND["atol"] + JAX_PARAMS_BOUND["rtol"] * w.abs()
        g = g_eff[k].abs()
        s = g / g.max().clamp_min(1e-30)
        noise = lr * (TP_DP_GRAD_TOL / s).clamp(max=2.0)
        worst_gate = max(worst_gate, float((d / (jax + noise)).max()))
        worst_jax = max(worst_jax, float((d / jax).max()))
        over = d > jax
        n_over += int(over.sum())
        if over.any():
            share = max(share, float(s[over].max()))
    return {
        "grad_norm": abs(mp["grad_norm"] - ms["grad_norm"]) / ms["grad_norm"],
        "grads_max_leaf": max(rel_err(g_par[k], g_one[k]) for k in g_one),
        "params_worst_over_bound": worst_gate,
        "qkv_bias_k_max_abs": max(float((k_par[k] - k_one[k]).abs().max())
                                  for k in k_one),
        "jax_bound": {**JAX_PARAMS_BOUND, "worst_ratio": worst_jax,
                      "elements_over": n_over,
                      "elements": int(sum(v.numel() for v in q_one.values())),
                      "largest_grad_share_over": share}}


def tp_dp_vs_single(ranks, dev) -> dict:
    """(b)'s ranks against the single-process port on the card: the same
    weights, batch, recipe and steps."""
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    cfg = _tp_dp_cfg()
    p0 = _tp_dp_params(cfg)
    model = ViT(cfg)
    model.load_state_dict(p0)
    model.to(dev)
    tcfg = _tp_dp_train()
    state = engine.TrainState.create(model=model, seed=7,
                                     tx=optim.make_optimizer(tcfg, 10))
    grads = {}
    _capture_grads(state, grads)
    step = engine.make_train_step()
    batch = _par_batch(cfg, PAR_BATCH, 5)
    single = []
    for _ in range(TP_DP_STEPS):
        state, m = step(state, batch)
        single.append({k: float(v) for k, v in m.items()})
    after = {k: v.detach().cpu() for k, v in model.named_parameters()}
    loss_gap = max(abs(r["metrics"][i]["loss_sum"] - single[i]["loss_sum"])
                   / abs(single[i]["loss_sum"])
                   for r in ranks for i in range(len(single)))
    par = ranks[0]
    if set(par["params"]) != set(after) or set(par["grads"]) != set(grads):
        raise AssertionError("gathered params name other leaves than the "
                             "single-process model's")
    errs = tp_dp_errors(p0, (par["metrics"][-1], par["grads"],
                             par["params"]), (single[-1], grads, after), tcfg)
    tol = {"grad_norm": TP_DP_GRAD_TOL, "grads_max_leaf": TP_DP_GRAD_TOL,
           "params_worst_over_bound": 1.0,
           "qkv_bias_k_max_abs": JAX_PARAMS_BOUND["qkv_bias_atol"]}
    out = {"single_losses": [m["loss_sum"] for m in single],
           "parallel_losses": [m["loss_sum"] for m in par["metrics"]],
           "loss_max_rel_gap": loss_gap, "loss_rtol": TP_DP_LOSS_RTOL,
           "errors": errs, "tolerance": tol}
    bad = {k: errs[k] for k, v in tol.items() if not errs[k] <= v}
    if not loss_gap <= TP_DP_LOSS_RTOL or bad:
        raise AssertionError(f"dp2 x tp2 vs single process: {out}")
    return out


# (c): sequence parallelism at B/16's full width (D 768, 12 heads, F
# 3072), 224 px with pool='gap' (T = 196, 98 tokens a seq rank), SP_LAYERS
# layers, f32, attention dropout SP_RATE, MLP and embedding dropout 0.
# One spawn of four ranks runs ring on seq 2 x model 2 (the spawn's mesh)
# and Ulysses on data 2 x seq 2 (a second mesh over the same ranks), one
# train step each of the global batch SP_BATCH. Each rank first runs the
# one-rank step of the same weights and batch in its process: the plain
# ViT with the flash kernel (attention_impl="flash") and the same step
# generator, whose attention seeds the SP meshes share, so the dropout
# masks are the same bits by construction. Gate: each rank's logits (its
# data rows) and loss within SP_FWD_TOL, its gradient leaves (its model
# slices, summed by the step) within SP_GRAD_TOL of each reference leaf's
# largest element; its launches on the SP step the rows the code predicts
# (rows 1/2 without a model axis, 6/7 with one, never rows 3-5).
SP_LAYERS = 2
SP_BATCH = 8
SP_RATE = 0.1
SP_SEED = 11
SP_FWD_TOL = 1e-4
SP_GRAD_TOL = 2e-3
SP_RUNS = (("ring", {"data": 1, "model": 2, "seq": 2}),
           ("ulysses", {"data": 2, "model": 1, "seq": 2}))


def _sp_cfg():
    from pytorch_vit_paper_replication_tpu_torch.configs import vit_b16
    return vit_b16(num_classes=NUM_CLASSES, num_layers=SP_LAYERS,
                   pool="gap", dtype="float32", mlp_impl="fused",
                   attn_dropout=SP_RATE, mlp_dropout=0.0,
                   embedding_dropout=0.0)


def sp_launches(layers: int, steps: int, eval_passes: int,
                tp: bool) -> dict:
    """A rank's launches over a sequence-parallel run: the MLP rows of its
    blocks (6/7 with a model axis, else 1/2), forward in every train step
    and eval pass, backward in every train step; the flash rows never
    (ring and Ulysses attention are plain PyTorch, as JAX's are XLA)."""
    return {**_mesh_launches(layers, 1, steps, eval_passes, tp),
            "flash_attention": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}


def _one_rank_step(cfg, params, batch, dev):
    """The one-rank reference of (c): logits, mean loss and full gradients
    of the plain ViT (flash attention) in train mode with the step
    generator of (SP_SEED, step 0)."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch import engine
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    model = ViT(cfg.replace(attention_impl="flash"))
    model.load_state_dict(params)
    model.to(dev).train()
    images = torch.from_numpy(batch["image"]).to(dev)
    labels = torch.from_numpy(batch["label"]).to(dev)
    logits = model(images, engine.step_generator(SP_SEED, 0))
    loss = engine.cross_entropy_loss(logits, labels)
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return logits.detach().cpu(), float(loss.detach()), grads


def sp_rank(mesh) -> dict:
    """One rank of (c): the one-rank reference, then ring and Ulysses on
    meshes of SP_RUNS over the ranks of ``mesh``, each one train step with
    the launch counters set to 0 right before and read right after;
    returns the readings against the reference."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import (
        MeshConfig, TrainConfig)
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        rank_local_params)
    from pytorch_vit_paper_replication_tpu_torch.parallel import (
        api, make_mesh, pipeline, shard_state_dict)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _sp_cfg()
    params = _tp_dp_params(cfg)
    batch = _par_batch(cfg, SP_BATCH, 6)
    ref_logits, ref_loss, ref_grads = _one_rank_step(cfg, params, batch,
                                                     mesh.device)
    out = {}
    for impl, sizes in SP_RUNS:
        # A mesh over the spawn's four ranks (every rank makes its groups,
        # in one order).
        layout = make_mesh(MeshConfig(**sizes), device=mesh.device)
        model = pipeline.make_pipeline_apply(cfg, layout,
                                             num_microbatches=1)
        model.load_state_dict(rank_local_params(params, layout))
        state = api.shard_train_state(engine.TrainState.create(
            model=model, tx=optim.make_optimizer(TrainConfig(), 10),
            seed=SP_SEED), layout)
        grads, logits = {}, []
        _capture_grads(state, grads)
        forward_backward = model.forward_backward

        def keep_logits(*args, fb=forward_backward, into=logits):
            res = fb(*args)
            into.extend(o[0].cpu() for o in res)
            return res
        model.forward_backward = keep_logits
        step = api.make_parallel_train_step(state, layout, sp_impl=impl)
        local = api.shard_batch(batch, layout)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        d = layout.coords["data"]
        rows = slice(d * SP_BATCH // layout.shape["data"],
                     (d + 1) * SP_BATCH // layout.shape["data"])
        want = shard_state_dict(ref_grads, layout)
        if set(want) != set(grads):
            raise AssertionError(f"(c) {impl}: gradient leaves {sorted(grads)}"
                                 f" != {sorted(want)}")
        out[impl] = {
            "coords": dict(layout.coords), "launches": launches,
            "step_wall_s": wall,
            "logits": rel_err(torch.cat(logits), ref_logits[rows]),
            "loss": abs(float(m["loss_sum"]) / float(m["count"]) - ref_loss)
            / abs(ref_loss),
            "grads_max_leaf": max(rel_err(grads[k], want[k]) for k in want),
            "grad_norm": float(m["grad_norm"])}
        del state, model
        torch.cuda.empty_cache()
    return out


def par_rank(mesh) -> dict:
    """One rank of the phase: (a) on the spawn's mesh, then (b) and (c) on
    meshes built over the same four ranks (one rank start for the three
    runs), each with its wall on this rank."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
    from pytorch_vit_paper_replication_tpu_torch.parallel import make_mesh
    out, walls = {}, {}
    for run, fn in (("a", lambda: pp_tp_rank(mesh)),
                    ("b", lambda: tp_dp_rank(make_mesh(
                        MeshConfig(data=2, model=2), device=mesh.device))),
                    ("c", lambda: sp_rank(mesh))):
        if mesh.rank == 0:
            emit({"phase": "parallel", "run": run, "start": True})
        t0 = time.perf_counter()
        out[run] = fn()
        walls[run] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["walls_s"] = walls
    return out


def _check_parallel_c(ranks) -> dict:
    """(c)'s gate over every rank's readings and launches; returns rank
    0's launches per strategy."""
    for impl, sizes in SP_RUNS:
        want = sp_launches(SP_LAYERS, 1, 0, tp=sizes["model"] > 1)
        for r in ranks:
            got = r[impl]
            if got["launches"] != want:
                raise AssertionError(f"(c) {impl} rank {got['coords']}: "
                                     f"launches {got['launches']} != {want}")
            bad = {k: got[k] for k, tol in (
                ("logits", SP_FWD_TOL), ("loss", SP_FWD_TOL),
                ("grads_max_leaf", SP_GRAD_TOL)) if not got[k] <= tol}
            if bad:
                raise AssertionError(f"(c) {impl} rank {got['coords']} vs "
                                     f"the one-rank flash step: {bad}")
    emit({"phase": "parallel", "run": "c", "ok": True,
          "model": f"{PRESET} width, {SP_LAYERS} layers, 224 px, "
                   "pool gap (T = 196), f32",
          "attn_dropout": SP_RATE, "batch": SP_BATCH,
          "reference": "one-rank step, flash kernel, same seeds",
          "tolerance": {"logits": SP_FWD_TOL, "loss": SP_FWD_TOL,
                        "grads_max_leaf": SP_GRAD_TOL},
          **{impl: {"layout": " x ".join(f"{a}{n}" for a, n in
                                         sizes.items()),
                    "worst": {k: max(r[impl][k] for r in ranks)
                              for k in ("logits", "loss",
                                        "grads_max_leaf")},
                    "launches_per_rank": ranks[0][impl]["launches"],
                    "step_walls_s": [r[impl]["step_wall_s"] for r in ranks]}
             for impl, sizes in SP_RUNS}})
    return {impl: ranks[0][impl]["launches"] for impl, _ in SP_RUNS}


def phase_parallel(dev) -> dict:
    """(a), (b) then (c) in one parallel.spawn of four ranks on this card
    (:func:`par_rank`); returns rank 0's launch counts of (a) and of (c)'s
    two strategies."""
    import math
    from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
    from pytorch_vit_paper_replication_tpu_torch.parallel import spawn
    emit({"phase": "parallel", "start": True})
    t0 = time.perf_counter()
    every = spawn(par_rank, MeshConfig(data=1, model=2, pipe=2),
                  device=dev.type, timeout_s=PAR_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    walls = every[0]["walls_s"]
    ranks = [r["a"] for r in every]
    layers = PAR_LAYERS // 2
    fwd, bwd = layers * PAR_MICRO * (PAR_STEPS + 1), layers * PAR_MICRO * \
        PAR_STEPS
    want = {"fused_ln_mlp_residual": 0, "fused_ln_mlp_residual_bwd": 0,
            "fused_mlp_core": fwd, "fused_mlp_core_bwd": bwd,
            "flash_attention": fwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd}
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"rank {r['coords']}: launches "
                                 f"{r['launches']} != {want}")
        losses = [m["loss_sum"] / m["count"] for m in r["metrics"]]
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"rank {r['coords']}: losses {losses} not "
                                 "finite and falling")
        if r["metrics"] != ranks[0]["metrics"] or \
                r["eval"] != ranks[0]["eval"]:
            raise AssertionError("ranks disagree on the global metrics")
    emit({"phase": "parallel", "run": "a", "ok": True,
          "layout": "dp1 x tp2 x pp2",
          "model": f"{PRESET}, {PAR_LAYERS} layers",
          "batch": PAR_BATCH, "microbatches": PAR_MICRO,
          "transport": ranks[0]["transport"],
          "losses": [m["loss_sum"] / m["count"] for m in ranks[0]["metrics"]],
          "grad_norms": [m["grad_norm"] for m in ranks[0]["metrics"]],
          "eval": ranks[0]["eval"], "launches_per_rank": ranks[0]["launches"],
          "step_walls_s": [r["step_walls_s"] for r in ranks],
          "step_walls_are": (
              "four ranks sharing one card: a measure of the host, not of "
              "parallel-training throughput"
              if len({r["device"] for r in ranks}) == 1
              else "one card per rank"),
          "peak_memory_gib_per_rank": [r["peak_memory_gib"] for r in ranks],
          "seconds_on_rank_0": round(walls["a"], 3)})
    cmp = tp_dp_vs_single([r["b"] for r in every], dev)
    emit({"phase": "parallel", "run": "b", "ok": True,
          "layout": "dp2 x tp2 x pp1", "model": "ViT-B/16, 2 layers, f32",
          "steps": TP_DP_STEPS, **cmp,
          "seconds_on_rank_0": round(walls["b"], 3)})
    c = _check_parallel_c([r["c"] for r in every])
    emit({"phase": "parallel", "ok": True,
          "runs_seconds_on_rank_0": {k: round(v, 3) for k, v in walls.items()},
          "spawn_seconds_incl_rank_start": round(spawn_s, 3),
          "seconds": round(time.perf_counter() - t0, 3)})
    return {"a": ranks[0]["launches"], **c}


# ------------------------------------------------------------- phase 5a
# The train CLI itself on a mesh: four rank processes sharing the card
# (gloo), ViT-B/16 at full width and depth, bf16, auto, default dropouts,
# on 224 px synthetic image folders, batch 8. (a) dp 2 x pp 2: one short
# epoch of MESH_A_STEPS micro-steps with --grad-accum 2, a checkpoint every
# MESH_EVERY_STEPS micro-steps; resumed from the first; --eval-only of its
# final/ export on the mesh, and on one card through the train CLI,
# predict_image and the predict CLI. (b) tp 2 x pp 2: --grad-accum 2
# --nan-guard, MESH_B_EPOCHS epochs of 2 micro-steps (one update an
# epoch). (c) tp 2 x seq 2, ring attention, --pool gap, full depth: one
# epoch of 2 steps, its final/ scored on one card (MESH_C_SP). (b), (c)
# and the mesh's --eval-only go as background CLI processes beside (a)
# and beside the rest: the card idles in these host-bound runs.
MESH_BATCH = 8
MESH_A_PER_CLASS = (11, 2)         # 33 train images: 4 micro-steps of 8
MESH_A_STEPS = 4
MESH_EVERY_STEPS = 2
MESH_B_PER_CLASS = (6, 1)          # 18 train images: 2 micro-steps an epoch
MESH_B_EPOCHS = 3
MESH_B_LR = "1e-4"
# (c): sequence parallelism through the CLI, ring on seq 2 x model 2 with
# --pool gap (T = 196), on (b)'s folder (2 steps and one eval batch an
# epoch), one epoch, its final/ scored on one card.
MESH_C_SP = ["--pool", "gap", "--mesh-data", "1", "--mesh-model", "2",
             "--mesh-seq", "2", "--sp-impl", "ring"]
MESH_TIMEOUT_S = 900
# The one-card scores of (a)'s export against the mesh's eval: the mean
# loss is ~exp(-margin) for a model this sure, so a bound on |ln(loss
# ratio)| bounds the shift of the logit margin; 0.5 is 8 bf16 ulps of a
# logit in [8, 16). A layer or slice in the wrong place moves it by
# orders of magnitude.
MESH_EXPORT_LOSS_LN = 0.5
# (c)'s own bound, set from its reading (|ln ratio| 0.0089 on the H100):
# its seq mesh's test loss must first show a sure model (below
# MESH_C_SURE_LOSS, a margin above ~4.6 over 3 classes; 1.19e-3 was
# read), so that the loss is ~exp(-margin) and 0.05 bounds the margin's
# shift to 0.05, under 2 bf16 ulps of a logit in [4, 8). An attention
# that saw only its own token piece, or a pool over the wrong count,
# moves the margin by far more.
MESH_C_LOSS_LN = 0.05
MESH_C_SURE_LOSS = 0.02


def _mesh_launches(stage_layers: int, micro: int, steps: int,
                   eval_passes: int, tp: bool) -> dict:
    """A rank's kernel launches over a mesh CLI run: each of its stage's
    layers once per microbatch in every train micro-step (forward and
    backward) and every eval batch (forward); rows 6 and 7 with a model
    axis, rows 1 and 2 without."""
    fwd, bwd = stage_layers * micro * (steps + eval_passes), \
        stage_layers * micro * steps
    mlp = ("fused_mlp_core", "fused_mlp_core_bwd") if tp else \
        ("fused_ln_mlp_residual", "fused_ln_mlp_residual_bwd")
    other = ("fused_ln_mlp_residual", "fused_ln_mlp_residual_bwd") if tp \
        else ("fused_mlp_core", "fused_mlp_core_bwd")
    return {mlp[0]: fwd, mlp[1]: bwd, other[0]: 0, other[1]: 0,
            "flash_attention": fwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd}


def _check_mesh_run(tag: str, res: dict, want: dict) -> None:
    """Every rank's launches are its stage's, the ranks hold one set of
    global metrics, and the losses are finite."""
    import math
    for r, got in enumerate(res["rank_launches"]):
        if got != want:
            raise AssertionError(f"{tag}: rank {r} launched {got}, its "
                                 f"stage's path is {want}")
    if any(r != res["rank_results"][0] for r in res["rank_results"]):
        raise AssertionError(f"{tag}: the ranks disagree on the global "
                             f"metrics: {res['rank_results']}")
    losses = res["train_loss"] + res["test_loss"]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: losses {losses} not finite")


class _TrainCLI:
    """``python -m ...train``'s ``main`` in a background process (``-c``:
    its rank processes import the package, not this script), started at
    construction, its output in ``log``.out / .err; :meth:`results` waits
    for it and returns the results dict it prints as JSON (floats exact),
    its standard output (rank 0's lines too) and its wall (to its last
    line). With ``as_module`` the process is ``python -m ...train``
    itself, and the results dict is None. :meth:`kill` ends it and its
    ranks."""

    def __init__(self, argv, log: Path, as_module: bool = False):
        code = (f"import json, sys\nfrom {PKG}.train import main\n"
                "r = main(sys.argv[1:])\nprint('RESULTS ' + json.dumps(r))")
        entry = ["-m", f"{PKG}.train"] if as_module else ["-c", code]
        self.as_module = as_module
        self.out, self.err = log.with_suffix(".out"), log.with_suffix(".err")
        self.t0 = time.time()
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, *entry, *argv], stdout=out, stderr=err,
                cwd=REPO, start_new_session=True)

    def results(self):
        try:
            self.proc.wait(timeout=MESH_TIMEOUT_S)
        finally:
            self.kill()
        # Its last line is written as it ends, maybe long before this call.
        wall = self.out.stat().st_mtime - self.t0
        out = self.out.read_text()
        if self.proc.returncode != 0:
            raise AssertionError(f"train CLI exit {self.proc.returncode}: "
                                 f"{self.err.read_text()[-3000:]}")
        if self.as_module:
            return None, out, wall
        line = [x for x in out.splitlines() if x.startswith("RESULTS ")][-1]
        return json.loads(line[len("RESULTS "):]), out, wall

    def kill(self):
        """SIGKILL its process group: the launcher, the server its ranks
        fork from, and the ranks."""
        import os
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


def _check_mesh_export(dev, exp: Path, test_dir, classes, model_argv,
                       res_a: dict, walls: dict) -> dict:
    """The mesh run's ``final/`` export, standard layout, through one-card
    code: the train CLI's ``--eval-only`` and the probability rows of
    ``predict_image`` (each test image alone) score the test split as the
    mesh's own eval did (accuracy equal; the loss within
    MESH_EXPORT_LOSS_LN in log space, since it is a bf16 run's;
    ``predict_image`` decodes with PIL where the loader uses the native
    decoder, so its rows see slightly other pixels); the predict CLI
    prints ``predict_image``'s line. Returns the readings."""
    import math
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        load_inference_checkpoint, predict_image)
    mesh_loss, mesh_acc = res_a["test_loss"][-1], res_a["test_acc"][-1]

    def held(tag, loss, acc):
        gap = abs(math.log(loss / mesh_loss)) if loss > 0 else math.inf
        if acc != mesh_acc or not gap <= MESH_EXPORT_LOSS_LN:
            raise AssertionError(
                f"{tag} on the mesh export: loss {loss!r}, acc {acc!r}; the "
                f"mesh's eval: loss {mesh_loss!r}, acc {mesh_acc!r} (|ln "
                f"ratio| {gap:.4g}, bound {MESH_EXPORT_LOSS_LN})")
        return {"test_loss": loss, "test_acc": acc, "ln_loss_ratio": gap}

    t0 = time.perf_counter()
    ev, _ = _cli_main("train", ["--test-dir", str(test_dir), *model_argv,
                                "--eval-only", "--checkpoint-dir", str(exp),
                                "--mesh-data", "1"])
    walls["one_card_eval_only_s"] = time.perf_counter() - t0
    out = {"one_card_eval_only": held("one-card --eval-only",
                                      ev["test_loss"][0], ev["test_acc"][0])}
    images = sorted(Path(test_dir).rglob("*.jpg"))
    labels = [classes.index(img.parent.name) for img in images]
    one, transform, _ = load_inference_checkpoint(exp, PRESET, len(classes),
                                                  device=dev)
    rows = np.stack([predict_image(one, img, classes, transform)[2]
                     for img in images]).astype(np.float64)
    del one
    torch.cuda.empty_cache()
    if not (np.isfinite(rows).all() and
            np.allclose(rows.sum(1), 1.0, atol=1e-5)):
        raise AssertionError(f"predict_image rows on the mesh export: {rows}")
    picked = rows[np.arange(len(images)), labels]
    out["predict_image_rows"] = held(
        "predict_image's rows", float(-np.log(picked).mean()),
        float((rows.argmax(1) == labels).mean()))
    t0 = time.perf_counter()
    _, printed = _cli_main("predict", [str(images[0]), "--checkpoint",
                                       str(exp), "--classes", *classes,
                                       "--preset", PRESET])
    walls["predict_s"] = time.perf_counter() - t0
    p0 = rows[0].astype(np.float32)
    want = f"{images[0]}: {classes[int(p0.argmax())]} ({p0.max():.3f})"
    if printed.strip().splitlines() != [want]:
        raise AssertionError(f"predict on the mesh export printed "
                             f"{printed!r}, predict_image gives {want!r}")
    out["predict"] = want
    return out


def phase_train_mesh(dev, root: Path) -> dict:
    """``python -m ...train --mesh-*``: (a) through ``train.main`` in this
    process (its launcher starts four rank processes on the card), the
    others as background CLI processes; see MESH_*. Returns rank 0's
    launch counts of (a)'s uninterrupted run, of (b) and of (c)."""
    import math
    import os
    import shutil
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        load_params_npz)
    from pytorch_vit_paper_replication_tpu_torch.data import (
        make_synthetic_image_folder)
    emit({"phase": "train_mesh", "start": True})
    t_phase = time.perf_counter()
    layers = PRESETS[PRESET]().num_layers // 2
    walls = {}
    classes = ["pizza", "steak", "sushi"]
    model = ["--preset", PRESET, "--image-size", "224", "--dtype",
             "bfloat16", "--batch-size", str(MESH_BATCH), "--attention",
             "auto", "--mlp-impl", "auto", "--seed", "3"]
    train_b, test_b = make_synthetic_image_folder(
        root / "ds_b", train_per_class=MESH_B_PER_CLASS[0],
        test_per_class=MESH_B_PER_CLASS[1], image_size=224, seed=1)
    jsonl_b = root / "b.jsonl"
    background = []
    try:
        run_b = _TrainCLI([
            "--train-dir", str(train_b), "--test-dir", str(test_b), *model,
            "--epochs", str(MESH_B_EPOCHS), "--grad-accum", "2",
            "--nan-guard", "--lr", MESH_B_LR, "--mesh-data", "1",
            "--mesh-model", "2", "--mesh-pipe", "2", "--metrics-jsonl",
            str(jsonl_b)], root / "b")
        background.append(run_b)
        train_a, test_a = make_synthetic_image_folder(
            root / "ds_a", train_per_class=MESH_A_PER_CLASS[0],
            test_per_class=MESH_A_PER_CLASS[1], image_size=224)
        ck = root / "A"
        run_a = ["--train-dir", str(train_a), "--test-dir", str(test_a),
                 *model, "--epochs", "1", "--grad-accum", "2",
                 "--mesh-data", "2", "--mesh-pipe", "2", "--checkpoint-dir",
                 str(ck), "--checkpoint-every-steps", str(MESH_EVERY_STEPS)]
        t0 = time.perf_counter()
        res_a, out_a = _cli_main("train", run_a)
        walls["a_s"] = time.perf_counter() - t0
        # (c) starts as (a) ends, beside (b)'s tail, the mesh's
        # --eval-only and the resume below.
        emit({"phase": "train_mesh", "run": "c", "start": True})
        ck_c = root / "C"
        run_c = _TrainCLI([
            "--train-dir", str(train_b), "--test-dir", str(test_b), *model,
            *MESH_C_SP, "--epochs", "1", "--checkpoint-dir", str(ck_c)],
            root / "c")
        background.append(run_c)
        transport = next(line for line in out_a.splitlines()
                         if line.startswith("mesh:"))
        # One eval batch: 6 test images padded to dp x M = 4, each shard's
        # 4 rows in 2 microbatches.
        launches_a = _mesh_launches(layers, 2, MESH_A_STEPS, 1, tp=False)
        _check_mesh_run("train_mesh (a)", res_a, launches_a)
        saved = sorted(int(d.name) for d in ck.iterdir() if d.name.isdigit())
        if saved != [MESH_EVERY_STEPS, MESH_A_STEPS]:
            raise AssertionError(f"(a) saved steps {saved}")

        # ---- The uninterrupted run's export moves to a directory of its
        # own, F, and its last checkpoint beside it. The mesh's --eval-only
        # of F in the background; here meanwhile the one-card checks of F,
        # then the run stopped after its first checkpoint and resumed.
        exp = root / "F"
        exp.mkdir()
        os.rename(ck / "final", exp / "final")
        for name in ("transform.json", "model_meta.json"):
            shutil.copy(ck / name, exp / name)
        os.rename(ck / str(MESH_A_STEPS), root / "A_last")
        run_ev = _TrainCLI(["--test-dir", str(test_a), *model, "--eval-only",
                            "--checkpoint-dir", str(exp), "--mesh-data",
                            "2", "--mesh-pipe", "2"], root / "eval_only")
        background.append(run_ev)
        export = _check_mesh_export(dev, exp, test_a, classes, model,
                                    res_a, walls)
        t0 = time.perf_counter()
        res_r, _ = _cli_main("train", run_a)
        walls["resume_s"] = time.perf_counter() - t0
        # The launches say where the run resumed (the micro-steps after
        # the checkpoint).
        _check_mesh_run("train_mesh (a) resumed", res_r, _mesh_launches(
            layers, 2, MESH_A_STEPS - MESH_EVERY_STEPS, 1, tp=False))
        final_a = load_params_npz(exp / "final" / "params.npz")
        final_r = load_params_npz(ck / "final" / "params.npz")
        state_a = torch.load(root / "A_last" / "state.pt", weights_only=True)
        state_r = torch.load(ck / str(MESH_A_STEPS) / "state.pt",
                             weights_only=True)
        differ = [k for k in final_a
                  if not torch.equal(final_a[k], final_r[k])]
        differ += [f"params/{k}" for k in state_a["params"] if not
                   torch.equal(state_a["params"][k], state_r["params"][k])]
        for group in ("mu", "nu", "acc"):
            differ += [f"{group}/{k}" for k in state_a["opt_state"][group]
                       if not torch.equal(state_a["opt_state"][group][k],
                                          state_r["opt_state"][group][k])]
        scalars = [(state_a["opt_state"][k], state_r["opt_state"][k])
                   for k in ("count", "mini_step")] + [
            (state_a[k], state_r[k]) for k in ("step", "seed")]
        del state_a, state_r
        same = (res_r["test_loss"] == res_a["test_loss"]
                and res_r["test_acc"] == res_a["test_acc"])
        if set(final_a) != set(final_r) or differ or not same or any(
                x != y for x, y in scalars):
            raise AssertionError(f"(a) resumed != uninterrupted: "
                                 f"{differ[:4]}, {scalars}, evals "
                                 f"{res_r['test_loss']} vs "
                                 f"{res_a['test_loss']}")

        ev, _, walls["eval_only_s"] = run_ev.results()
        _check_mesh_run("train_mesh (a) --eval-only", ev,
                        _mesh_launches(layers, 2, 0, 1, tp=False))
        if (ev["test_loss"], ev["test_acc"]) != (res_a["test_loss"],
                                                 res_a["test_acc"]):
            raise AssertionError(f"(a) --eval-only {ev} != the run's eval "
                                 f"{res_a}")
        res_b, _, walls["b_s"] = run_b.results()
        res_c, _, walls["c_s"] = run_c.results()
        launches_c = sp_launches(2 * layers, 2, 1, tp=True)
        _check_mesh_run("train_mesh (c)", res_c, launches_c)
        t0 = time.perf_counter()
        ev_c, _ = _cli_main("train", [
            "--test-dir", str(test_b), *model, "--pool", "gap",
            "--eval-only", "--checkpoint-dir", str(ck_c), "--mesh-data",
            "1"])
        walls["c_one_card_eval_only_s"] = time.perf_counter() - t0
        if not res_c["test_loss"][-1] < MESH_C_SURE_LOSS:
            raise AssertionError(f"(c) the seq mesh's test loss "
                                 f"{res_c['test_loss']} is not below "
                                 f"{MESH_C_SURE_LOSS}: too unsure a model "
                                 f"for MESH_C_LOSS_LN")
        gap_c = abs(math.log(ev_c["test_loss"][0] / res_c["test_loss"][-1]))
        if ev_c["test_acc"][0] != res_c["test_acc"][-1] or \
                not gap_c <= MESH_C_LOSS_LN:
            raise AssertionError(f"(c) one-card --eval-only {ev_c} vs the "
                                 f"seq mesh's eval {res_c} (|ln ratio| "
                                 f"{gap_c:.4g}, bound {MESH_C_LOSS_LN})")
    finally:
        for run in background:
            run.kill()
    launches_b = _mesh_launches(layers, 2, 2 * MESH_B_EPOCHS, MESH_B_EPOCHS,
                                tp=True)
    _check_mesh_run("train_mesh (b)", res_b, launches_b)
    losses_b = res_b["train_loss"]
    rows_b = _jsonl(jsonl_b)
    if not losses_b[-1] < losses_b[0] or any("skipped_steps" in r
                                              for r in rows_b):
        raise AssertionError(f"(b) losses {losses_b} not falling, or a "
                             f"clean step skipped: {rows_b}")
    emit({"phase": "train_mesh", "ok": True, "model": PRESET,
          "transport": transport,
          "a": {"layout": "dp2 x pp2", "microbatches": 2,
                "micro_steps": MESH_A_STEPS, "grad_accum": 2,
                "train_loss": res_a["train_loss"],
                "test_loss": res_a["test_loss"], "checkpoints": saved,
                "resumed_from": MESH_EVERY_STEPS,
                "resume_bit_equal": ["final params", "step state",
                                     "eval"],
                "eval_only_equal": True, "export": export,
                "launches_per_rank": launches_a},
          "b": {"layout": "tp2 x pp2", "microbatches": 2,
                "micro_steps": 2 * MESH_B_EPOCHS, "grad_accum": 2,
                "nan_guard": True, "train_loss": losses_b,
                "test_loss": res_b["test_loss"],
                "launches_per_rank": launches_b},
          "c": {"layout": "tp2 x seq2, ring, pool gap", "micro_steps": 2,
                "train_loss": res_c["train_loss"],
                "test_loss": res_c["test_loss"],
                "one_card_eval_only": {"test_loss": ev_c["test_loss"][0],
                                       "test_acc": ev_c["test_acc"][0],
                                       "ln_loss_ratio": gap_c},
                "launches_per_rank": launches_c},
          "walls_s": {k: round(v, 3) for k, v in walls.items()},
          "walls_are": "four ranks sharing one card (gloo through host "
                       "memory), rank start and the launcher's set-up "
                       "included, (b) beside (a), (c) and the mesh's "
                       "--eval-only beside the one-card checks and the "
                       "resume: a measure of the host, not of "
                       "parallel-training throughput",
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return {"a": res_a["rank_launches"][0], "b": res_b["rank_launches"][0],
            "c": res_c["rank_launches"][0]}


# ------------------------------------------------------------- phase 5b
# The Quickstart training path through the port's train and predict CLIs:
# ViT-B/16 at 224 px, bf16, batch 32, auto attention and MLP, on a seeded
# synthetic image folder (CLI_PER_CLASS x 3 train JPEGs, a quarter of
# that per class for test: 3 steps an epoch with drop_last, one eval
# batch).
CLI_PER_CLASS = (32, 8)
CLI_EPOCHS = 2
CLI_EVERY_STEPS = 2
CLI_RESUME_FROM = 4
# Run C: two epochs of CLI_C_PER_CLASS x 3 images (10 steps each), no
# checkpoints: epoch 1's steady window (steps CLI_WINDOW[0]..CLI_WINDOW[1])
# profiled for the card's idle share, epoch 2 unprofiled for the CLI's
# img/s.
CLI_C_PER_CLASS = 107
CLI_WINDOW = (3, 10)
CLI_JSONL_KEYS = {"time", "step", "epoch", "train_loss", "train_acc",
                  "test_loss", "test_acc", "images_per_sec", "grad_norm",
                  "lr"}
# Rows 1-5 launch once per block in every train step (forward and
# backward); rows 6 and 7 (tensor-parallel blocks only) never.
CLI_STEP_LAUNCHES = {"fused_ln_mlp_residual": 12,
                     "fused_ln_mlp_residual_bwd": 12,
                     "fused_mlp_core": 0, "fused_mlp_core_bwd": 0,
                     "flash_attention": 12, "flash_attention_bwd_dq": 12,
                     "flash_attention_bwd_dkv": 12}


class StepProbe:
    """Wraps ``engine.make_train_step`` while installed: records each
    step's launch-count deltas and, over global steps ``window``
    (inclusive, counted from 1 in the run), the host wall (ending in a
    synchronize), the union of the card's kernel intervals from
    ``torch.profiler`` and the device ms of its 15 costliest kernel
    names (``top_ms``)."""

    def __init__(self, window=None):
        self.window = window
        self.deltas = []
        self.wall_s = self.busy_s = None

    def __enter__(self):
        from pytorch_vit_paper_replication_tpu_torch import engine
        self._engine, self._make = engine, engine.make_train_step

        def make(**kw):
            step = self._make(**kw)

            def probed(state, batch):
                n = state.step + 1
                if self.window and n == self.window[0]:
                    self._open()
                before = read_counts()
                state, m = step(state, batch)
                after = read_counts()
                self.deltas.append({k: after[k] - before[k] for k in after})
                if self.window and n == self.window[1]:
                    self._close()
                return state, m
            return probed
        engine.make_train_step = make
        return self

    def __exit__(self, *exc):
        self._engine.make_train_step = self._make

    def _open(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def _close(self):
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in self._prof.events()
                       if getattr(e, "device_type", None) == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for s, e in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        self.busy_s = busy / 1e6
        self.kernels = len(spans)
        by_name = {}
        for e in self._prof.key_averages():
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                name = e.key.split("(")[0].replace("void ", "")[-70:]
                by_name[name] = by_name.get(name, 0.0) + dev_us(e) / 1e3
        self.top_ms = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]


def _cli_main(module: str, argv):
    """``module.main(argv)`` in this process, its stdout kept (returned)
    and shown only when it raises."""
    import contextlib
    import importlib
    import io
    buf = io.StringIO()
    mod = importlib.import_module(f"{PKG}.{module}")
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
    except BaseException:
        print(buf.getvalue()[-4000:], file=sys.stderr)
        raise
    return out, buf.getvalue()


def _cli_subprocess(module: str, argv, timeout: int = 600) -> str:
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.{module}", *argv],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {PKG}.{module} exit "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


def _jsonl(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def _check_step_launches(tag: str, deltas) -> None:
    bad = [(i, d) for i, d in enumerate(deltas) if d != CLI_STEP_LAUNCHES]
    if bad or not deltas:
        raise AssertionError(f"{tag}: a train step's launches != "
                             f"{CLI_STEP_LAUNCHES}: {bad[:2]}")


def loader_rates(folder: Path) -> list:
    """img/s of the CLI's train loader (Resize + to_array at 224 px,
    batch 32) over one epoch of ``folder``: 1 and os.cpu_count() decode
    threads and os.cpu_count() forked processes, with the native decoder
    (where it built) and with PIL; host only."""
    import os
    from pytorch_vit_paper_replication_tpu_torch import native
    from pytorch_vit_paper_replication_tpu_torch.data import (
        DataLoader, ImageFolderDataset)
    from pytorch_vit_paper_replication_tpu_torch.data.transforms import (
        make_transform)
    cores = os.cpu_count() or 1
    rows = []
    for decoder in (["native"] if native.available() else []) + ["pil"]:
        ds = ImageFolderDataset(folder, make_transform(224),
                                native_decode=decoder == "native")
        for kind, workers in (("thread", 1), ("thread", cores),
                              ("process", cores)):
            dl = DataLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True,
                            num_workers=workers, worker_type=kind)
            try:
                list(dl)  # page cache and pool warm
                t0 = time.perf_counter()
                n = sum(len(b["label"]) for b in dl)
                rate = n / (time.perf_counter() - t0)
            finally:
                dl.close()
            rows.append({"decoder": decoder, "workers": workers,
                         "worker_type": kind, "images": n,
                         "img_per_s": rate})
    return rows


def h2d_ms(dev) -> dict:
    """CUDA-event ms of one [32, 224, 224, 3] f32 batch to the card, from
    pinned and from pageable host memory."""
    import numpy as np
    import torch
    arr = np.random.default_rng(0).standard_normal(
        (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)
    pageable = torch.from_numpy(arr)
    pinned = pageable.pin_memory()
    out = {"bytes": arr.nbytes}
    for name, src in (("pinned", pinned), ("pageable", pageable),
                      ("pinned_again", pinned), ("pageable_again", pageable)):
        out[name + "_ms"] = time_ms(
            lambda: src.to(dev, non_blocking=True), reps=20)
    return out


def checkpoint_seconds(dev, root: Path) -> dict:
    """Save and restore seconds of a B/16 TrainState (params, both Adam
    moments) through the port's Checkpointer (digest and verify
    included), on this machine's disk: a synchronous save, then async
    saves (the second one reuses the pinned buffers the first allocated):
    the host's time in ``save()`` and until ``wait()`` returns."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.checkpoint import (
        Checkpointer)
    from pytorch_vit_paper_replication_tpu_torch.configs import (
        PRESETS, TrainConfig)
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    cfg = PRESETS[PRESET](num_classes=3)
    model = ViT(cfg)
    model.load_state_dict(seeded_params(cfg, 0))
    model.to(dev)
    state = engine.TrainState.create(
        model=model, seed=0, tx=optim.make_optimizer(TrainConfig(), 10))
    state.step = 1
    ck = Checkpointer(root / "ck_time", max_to_keep=1, async_save=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(state)
    save_s = time.perf_counter() - t0
    nbytes = (ck.step_dir(1) / "state.pt").stat().st_size
    t0 = time.perf_counter()
    ck.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ak = Checkpointer(root / "ck_async", max_to_keep=1)
    async_s = []
    for step in (2, 3):
        state.step = step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ak.save(state)
        returned = time.perf_counter() - t0
        ak.wait()
        async_s.append({"save_returned_s": returned,
                        "durable_s": time.perf_counter() - t0})
    del state, model
    torch.cuda.empty_cache()
    return {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes,
            "async": async_s}


class TrainSinks:
    """``--metrics-port`` (a free port, scraped by a thread until it
    answers) and ``--ship-to`` (a ``FrameSink``) for one train CLI run;
    :meth:`check` holds the run's losses to a run without them, bit for
    bit."""

    def __enter__(self):
        import socket
        import threading
        import urllib.request
        from pytorch_vit_paper_replication_tpu_torch.telemetry import (
            FrameSink)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            self.port = sk.getsockname()[1]
        self.sink = FrameSink()
        self.argv = ["--metrics-port", str(self.port), "--ship-to",
                     f"127.0.0.1:{self.sink.port}", "--ship-interval-s", "1",
                     "--worker-id", "train-cli-a"]
        self.scraped, self._stop = [], threading.Event()

        def scrape():
            url = f"http://127.0.0.1:{self.port}/metrics"
            while not self._stop.wait(0.25):
                try:
                    with urllib.request.urlopen(url, timeout=5) as r:
                        body = r.read().decode()
                except OSError:
                    continue
                if "vit_tel_steps_total" in body:
                    self.scraped.append(body)
                    return
        self._thread = threading.Thread(target=scrape, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)
        self.frames = list(self.sink.frames)
        self.sink.stop()

    def check(self, rows, res_b) -> None:
        if not self.scraped:
            raise AssertionError("--metrics-port never answered mid-run")
        n = _prometheus_ok(self.scraped[0])
        roles = {f["role"] for f in self.frames}
        if roles != {"train"} or len(self.frames) < 2 or \
                self.frames[-1]["snapshot"]["counters"].get(
                    "tel_steps_total", 0) < 1:
            raise AssertionError(f"train frames: {roles}, "
                                 f"{len(self.frames)}")
        losses = {k: [r[k] for r in rows] for k in ("train_loss",
                                                    "test_loss")}
        if losses != {k: res_b[k] for k in losses}:
            raise AssertionError(f"run A with sinks {losses} != run B "
                                 f"{ {k: res_b[k] for k in losses} }")
        self.summary = {"metrics_samples_mid_run": n,
                        "frames": len(self.frames),
                        "losses_bit_identical_without_sinks": True}


def phase_train_cli(dev, root: Path) -> dict:
    """Run A through ``python -m ...train`` (2 epochs, saves every 2
    steps, metrics JSONL) in the background; run B the same command in
    this process beside it, with the launch counters, then interrupted
    after step 4 and resumed: its
    final export must equal A's bit for bit; ``--eval-only`` on A equal to
    A's last JSONL row; ``predict`` on A's export equal to
    ``predict_image``; run C two 10-step epochs, the first with a
    profiled steady window; then the loader, H2D and checkpoint
    measurements. Returns the launch counts of run B's first
    (uninterrupted) run."""
    import math
    import shutil
    import torch
    from pytorch_vit_paper_replication_tpu_torch import native
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        load_params_npz)
    from pytorch_vit_paper_replication_tpu_torch.data import (
        make_synthetic_image_folder)
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        load_inference_checkpoint, predict_image)

    t_phase = time.perf_counter()
    train_dir, test_dir = make_synthetic_image_folder(
        root / "ds", train_per_class=CLI_PER_CLASS[0],
        test_per_class=CLI_PER_CLASS[1], image_size=224)
    classes = ["pizza", "steak", "sushi"]
    common = ["--train-dir", str(train_dir), "--test-dir", str(test_dir),
              "--preset", PRESET, "--image-size", "224", "--dtype",
              "bfloat16", "--batch-size", str(TRAIN_BATCH), "--attention",
              "auto", "--mlp-impl", "auto", "--epochs", str(CLI_EPOCHS),
              "--seed", "0"]
    ck_a, ck_b = root / "A", root / "B"
    run_a = common + ["--checkpoint-dir", str(ck_a), "--metrics-jsonl",
                      str(ck_a / "m.jsonl"), "--checkpoint-every-steps",
                      str(CLI_EVERY_STEPS)]
    run_b = common + ["--checkpoint-dir", str(ck_b), "--metrics-jsonl",
                      str(ck_b / "m.jsonl"), "--checkpoint-every-steps",
                      str(CLI_EVERY_STEPS), "--keep-checkpoints", "20"]
    # Run A carries the telemetry sinks: /metrics scraped while it runs,
    # frames to a stand-in aggregator; run B (no sinks) must equal it. A
    # runs beside B (both host-bound): the card serves both.
    with TrainSinks() as sinks:
        proc_a = _TrainCLI(run_a + sinks.argv, root / "a", as_module=True)
        try:
            # ---- the main path, in this process: counts to 0, drive,
            # read.
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with StepProbe() as probe:
                res_b, _ = _cli_main("train", run_b)
            torch.cuda.synchronize()
            b_s = time.perf_counter() - t0
            launches = read_counts()
            _, _, a_s = proc_a.results()
        finally:
            proc_a.kill()
    rows = _jsonl(ck_a / "m.jsonl")
    if len(rows) != CLI_EPOCHS or any(
            not CLI_JSONL_KEYS <= set(r) or not math.isfinite(r["train_loss"])
            or not math.isfinite(r["test_loss"]) for r in rows):
        raise AssertionError(f"run A's JSONL rows are wrong: {rows}")
    if "time_to_first_step" not in rows[0]:
        raise AssertionError("run A's first row lacks time_to_first_step")
    for name in ("final/params.npz", "transform.json", "model_meta.json"):
        if not (ck_a / name).is_file():
            raise AssertionError(f"run A wrote no {name}")
    # The predict CLI on A's export runs in the background beside the
    # resume and --eval-only below.
    img = sorted(Path(test_dir).rglob("*.jpg"))[0]
    predict = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.predict", str(img), "--checkpoint",
         str(ck_a), "--classes", *classes, "--preset", PRESET],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)

    try:
        sinks.check(rows, res_b)
        _check_step_launches("run B", probe.deltas)
        steps = len(probe.deltas)
        for d in ck_b.iterdir():
            if d.is_dir() and (d.name == "final" or (
                    d.name.isdigit() and int(d.name) > CLI_RESUME_FROM)):
                shutil.rmtree(d)
        with StepProbe() as resumed:
            _, resume_out = _cli_main("train", run_b)
        _check_step_launches("run B resumed", resumed.deltas)
        if f"resumed from step {CLI_RESUME_FROM}" not in resume_out or \
                len(resumed.deltas) != steps - CLI_RESUME_FROM:
            raise AssertionError(f"run B did not resume from step "
                                 f"{CLI_RESUME_FROM}: {resume_out[-600:]}")
        pa = load_params_npz(ck_a / "final" / "params.npz")
        pb = load_params_npz(ck_b / "final" / "params.npz")
        differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
        if set(pa) != set(pb) or differ:
            raise AssertionError(f"resumed run B's final params differ from "
                                 f"run A's: {differ[:5]}")

        ev, _ = _cli_main("train", ["--test-dir", str(test_dir), "--preset",
                                    PRESET, "--image-size", "224",
                                    "--batch-size", str(TRAIN_BATCH),
                                    "--eval-only", "--checkpoint-dir",
                                    str(ck_a)])
        if (ev["test_loss"][0], ev["test_acc"][0]) != (rows[-1]["test_loss"],
                                                       rows[-1]["test_acc"]):
            raise AssertionError(f"--eval-only {ev} != run A's last row "
                                 f"{rows[-1]}")

        out, err = predict.communicate(timeout=600)
        if predict.returncode != 0:
            raise AssertionError(f"python -m {PKG}.predict exit "
                                 f"{predict.returncode}: {err[-3000:]}")
    finally:
        if predict.poll() is None:
            predict.kill()
            predict.wait()
    out = out.strip().splitlines()
    model, transform, _ = load_inference_checkpoint(ck_a, PRESET,
                                                    len(classes), device=dev)
    label, prob, _ = predict_image(model, img, classes, transform)
    want = f"{img}: {label} ({prob:.3f})"
    if out != [want]:
        raise AssertionError(f"predict printed {out}, predict_image gives "
                             f"{want!r}")
    del model
    torch.cuda.empty_cache()

    train_c, test_c = make_synthetic_image_folder(
        root / "ds_c", train_per_class=CLI_C_PER_CLASS,
        test_per_class=CLI_PER_CLASS[1], image_size=224, seed=1)
    run_c = ["--train-dir", str(train_c), "--test-dir", str(test_c),
             "--preset", PRESET, "--image-size", "224", "--batch-size",
             str(TRAIN_BATCH), "--epochs", "2", "--seed", "1",
             "--metrics-jsonl", str(root / "C.jsonl")]
    with StepProbe(window=CLI_WINDOW) as window:
        _cli_main("train", run_c)
    _check_step_launches("run C", window.deltas)
    c_rows = _jsonl(root / "C.jsonl")
    n_win = CLI_WINDOW[1] - CLI_WINDOW[0] + 1
    big, _ = make_synthetic_image_folder(root / "ds_512", train_per_class=54,
                                         test_per_class=1, image_size=512,
                                         seed=2)
    emit({"phase": "train_cli", "ok": True, "model": PRESET, "px": 224,
          "batch": TRAIN_BATCH, "steps_per_epoch": steps // CLI_EPOCHS,
          "run_a_subprocess_s": round(a_s, 3), "run_b_s": round(b_s, 3),
          "run_a_sinks": sinks.summary,
          "launches": launches, "launches_per_step": CLI_STEP_LAUNCHES,
          "resumed_from_step": CLI_RESUME_FROM,
          "resumed_final_params_bit_identical": True,
          "eval_only": {"test_loss": ev["test_loss"][0],
                        "test_acc": ev["test_acc"][0]},
          "predict": want,
          # Run A's JSONL readings, taken while run B trained beside it on
          # the same card and host: contended, not comparable with a run
          # alone (run C's are).
          "run_a_epochs_beside_run_b": [
              {"epoch": r["epoch"], "train_loss": r["train_loss"],
               "test_loss": r["test_loss"],
               "images_per_sec_beside_run_b": r["images_per_sec"]}
              for r in rows],
          "run_a_time_to_first_step_s_beside_run_b":
              rows[0]["time_to_first_step"],
          "run_c": {"steps": len(window.deltas),
                    "images_per_sec_profiled_epoch":
                        c_rows[0]["images_per_sec"],
                    "images_per_sec_epoch_2": c_rows[1]["images_per_sec"],
                    "window_steps": list(CLI_WINDOW),
                    "window_wall_ms_per_step": window.wall_s * 1e3 / n_win,
                    "window_device_busy_ms_per_step":
                        window.busy_s * 1e3 / n_win,
                    "window_idle_share": 1 - window.busy_s / window.wall_s,
                    "window_device_events": window.kernels},
          "native_decoder": {"available": native.available(),
                             "reason": native.unavailable_reason()},
          "loader_224px_sources": loader_rates(train_c),
          "loader_512px_sources": loader_rates(big),
          "h2d": h2d_ms(dev),
          "checkpoint_b16": checkpoint_seconds(dev, root),
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return launches


# ------------------------------------------------------------- phase 4c
# The ImageNet-scale recipe on a seeded folder of 512 px JPEGs: packed at
# 256 px into 64-record shards, then B/16 at 224 px, batch 32, 10 steps an
# epoch (PACKED_PER_CLASS x 3 train records), one loader thread (the
# augmentation's draws are bitwise reproducible with one worker).
PACKED_PER_CLASS = (107, 8)
PACKED_EPOCHS = 2
PACKED_EVERY_STEPS = 4
PACKED_PROFILE = (6, 7)
PACKED_STOP_AT = 6
# The JSONL rows' keys by event (the JAX package's row grammar: ROW_KEYS
# plus the declared tel_ instruments and the time/step/epoch spine).
TEL_ROW_KEYS = {
    "step": {"time", "event", "tel_data_wait_s", "tel_step_exec_s",
             "tel_step_s", "tel_images_per_sec", "tel_block_sampled",
             "tel_step_amortized_s", "tel_mfu", "step", "epoch"},
    "span": {"time", "event", "span", "seconds"},
    "epoch_summary": {"time", "event", "tel_steps", "tel_images",
                      "tel_epoch_wall_s", "tel_step_p50_s",
                      "tel_step_p95_s", "tel_step_p99_s",
                      "tel_data_wait_frac", "tel_goodput_pct",
                      "tel_images_per_sec", "tel_data_wait_s_sum",
                      "tel_step_exec_s_sum", "tel_ckpt_s_sum",
                      "tel_eval_s_sum", "tel_mfu", "epoch", "step"}}
# A name each kernel of rows 1-5 carries in a torch.profiler trace.
ROW_TRACE_NAMES = {"fused_ln_mlp_residual": ("ln_rows_pre", "gemm_bf16"),
                   "fused_ln_mlp_residual_bwd": ("rows_post",),
                   "flash_attention": ("flash_fwd_wgmma",),
                   "flash_attention_bwd_dq": ("flash_bwd_dq_wg2",),
                   "flash_attention_bwd_dkv": ("flash_bwd_dkv_wg2",)}
MEM_GAUGES = ("mem_live_bytes", "mem_live_bytes_peak", "mem_live_arrays",
              "mem_dev0_bytes_in_use", "mem_dev0_bytes_peak",
              "mem_dev0_bytes_limit")


def trace_window(path: Path) -> dict:
    """A ``torch.profiler`` Chrome trace: its wall (first event start to
    last event end), the union of its device intervals (kernels, copies,
    sets), the idle share and the kernel names."""
    events = json.loads(path.read_text())["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in timed if e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for s, e in dev:
        if e > end:
            busy += e - max(s, end)
            end = e
    t0 = min(float(e["ts"]) for e in timed)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    wall = t1 - t0
    return {"wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall if wall else None,
            "kernels": {e["name"] for e in timed if e.get("cat") == "kernel"}}


def _check_trace_names(tag: str, names) -> None:
    missing = [row for row, keys in ROW_TRACE_NAMES.items()
               if not all(any(k in n for n in names) for k in keys)]
    if missing:
        raise AssertionError(f"{tag}: the profile trace names no kernel of "
                             f"{missing} ({len(names)} kernel names)")


def _check_tel_rows(tag: str, rows, flops: float, peak_tflops: float) -> list:
    """Every telemetry row has its event's keys; every tel_mfu is in (0, 1)
    and equals tel_images_per_sec x flops / peak within 1% (plus the row's
    4-decimal rounding). Returns the step rows."""
    events = {r["event"] for r in rows}
    if events != set(TEL_ROW_KEYS):
        raise AssertionError(f"{tag}: telemetry events {events}")
    for r in rows:
        want = TEL_ROW_KEYS[r["event"]]
        if r["event"] == "step" and not r["tel_block_sampled"]:
            want = want - {"tel_step_amortized_s"}
        if set(r) != want:
            raise AssertionError(f"{tag}: a {r['event']} row has keys "
                                 f"{sorted(set(r) ^ want)} off the JAX "
                                 f"grammar: {r}")
        if "tel_mfu" in r:
            mfu = r["tel_mfu"]
            exp = r["tel_images_per_sec"] * flops / 1e12 / peak_tflops
            if not (0 < mfu < 1 and abs(mfu - exp) <= 0.01 * exp + 5e-5):
                raise AssertionError(f"{tag}: tel_mfu {mfu} against "
                                     f"{exp} from tel_images_per_sec: {r}")
    return [r for r in rows if r["event"] == "step"]


def packed_loader_rates(train: Path, test: Path) -> list:
    """img/s of the packed train loader alone (the default augmentation at
    224 px, batch 32, the phase's shuffle window and readahead) over one
    epoch after a warm one, at 1 and os.cpu_count() threads, and which
    transform path it took."""
    import os
    from pytorch_vit_paper_replication_tpu_torch import native
    from pytorch_vit_paper_replication_tpu_torch.data import (
        create_packed_dataloaders)
    path = ("native resize_crop_f32" if native.available()
            else "composed PIL (no native library)")
    rows = []
    for workers in (1, os.cpu_count() or 1):
        dl, test_dl, _ = create_packed_dataloaders(
            train, test, 224, TRAIN_BATCH, normalize=False,
            num_workers=workers, shuffle_window=128, readahead=2)
        try:
            list(dl)
            t0 = time.perf_counter()
            n = sum(len(b["label"]) for b in dl)
            rate = n / (time.perf_counter() - t0)
        finally:
            dl.close()
            test_dl.close()
        rows.append({"threads": workers, "images": n, "img_per_s": rate,
                     "path": path})
    return rows


def phase_train_packed(dev, root: Path) -> dict:
    """Pack a seeded 512 px folder with ``python -m ...data.pack``; run P1,
    ``python -m ...train --dataset packed`` with async saves, telemetry, the
    watchdog and a profile window, as a subprocess; run P2, the same
    command with ``--sync-checkpoints``, through ``train.main`` in this
    process with the launch counters; hold P1's final params equal to
    P2's, P1's command (no augmentation, one epoch) stopped after step 6
    and resumed from its async step-4 save equal to the uninterrupted run,
    the telemetry rows, tel_mfu, the traces' kernel names, the watchdog,
    the memory gauges; then one epoch of ``--dataset cifar10`` on a fake
    archive. The card's idle share is read from P1's and P2's profile
    windows (steps 6-7, between two saves). Returns P2's launch counts."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch import engine
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        load_params_npz)
    from pytorch_vit_paper_replication_tpu_torch.data import (
        make_fake_cifar10, make_synthetic_image_folder)
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        bf16_peak_tflops, get_registry, train_step_flops_per_image)

    t_phase = time.perf_counter()
    src_train, src_test = make_synthetic_image_folder(
        root / "src", train_per_class=PACKED_PER_CLASS[0],
        test_per_class=PACKED_PER_CLASS[1], image_size=512, seed=3)
    # Both splits pack at once: the pack CLI is host-only.
    procs = {split: subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.data.pack", str(src), str(root / split),
         "--pack-size", "256", "--shard-images", "64", "--shuffle-seed", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for split, src in (("train", src_train), ("test", src_test))}
    packs = {}
    for split, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"python -m {PKG}.data.pack {split} exit "
                                 f"{proc.returncode}: {err[-3000:]}")
        packs[split] = out.strip().splitlines()[-1]
    pack_s = time.perf_counter() - t_phase
    n_shards = len(list((root / "train").glob("shard-*.bin")))
    flops = train_step_flops_per_image(PRESETS[PRESET](num_classes=3))
    peak = bf16_peak_tflops(torch.cuda.get_device_name(0))

    def command(ck: Path, *extra):
        return ["--dataset", "packed", "--train-dir", str(root / "train"),
                "--test-dir", str(root / "test"), "--preset", PRESET,
                "--image-size", "224", "--dtype", "bfloat16",
                "--batch-size", str(TRAIN_BATCH), "--attention", "auto",
                "--mlp-impl", "auto", "--seed", "0", "--num-workers", "1",
                "--shuffle-window", "128", "--readahead", "2",
                "--checkpoint-dir", str(ck), "--keep-checkpoints", "20",
                "--checkpoint-every-steps", str(PACKED_EVERY_STEPS),
                *extra]

    observe = ["--epochs", str(PACKED_EPOCHS), "--telemetry-every", "1",
               "--watchdog-s", "300", "--profile-steps",
               "{}:{}".format(*PACKED_PROFILE)]
    p1, p2 = root / "P1", root / "P2"
    t0 = time.perf_counter()
    _cli_subprocess("train", command(
        p1, *observe, "--telemetry-jsonl", str(p1 / "tel.jsonl"),
        "--metrics-jsonl", str(p1 / "m.jsonl")))
    p1_s = time.perf_counter() - t0

    # ---- the main path, in this process: counts to 0, drive, read.
    get_registry().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with StepProbe() as probe:
        _cli_main("train", command(
            p2, *observe, "--sync-checkpoints", "--telemetry-jsonl",
            str(p2 / "tel.jsonl"), "--metrics-jsonl", str(p2 / "m.jsonl")))
    torch.cuda.synchronize()
    p2_s = time.perf_counter() - t0
    launches = read_counts()
    max_alloc = torch.cuda.max_memory_allocated()
    snap = get_registry().snapshot()
    _check_step_launches("P2", probe.deltas)
    steps = len(probe.deltas)
    if steps != PACKED_EPOCHS * 10:
        raise AssertionError(f"P2 ran {steps} steps, not "
                             f"{PACKED_EPOCHS * 10}")

    f1 = load_params_npz(p1 / "final" / "params.npz")
    f2 = load_params_npz(p2 / "final" / "params.npz")
    differ = [k for k in f1 if not torch.equal(f1[k], f2[k])]
    if set(f1) != set(f2) or differ:
        raise AssertionError(f"P1 (async saves) and P2 (sync) final params "
                             f"differ: {differ[:5]}")

    # ---- resume from an async save, P1's command without augmentation
    # (a resumed epoch never makes the skipped batches' draws).
    t0 = time.perf_counter()
    r_cmd = command(root / "R", "--no-augment", "--epochs", "1")
    _cli_main("train", command(root / "U", "--no-augment", "--epochs", "1"))
    train_fn = engine.train

    def stopped(*a, **kw):
        return train_fn(*a, stop_check=lambda s: s >= PACKED_STOP_AT, **kw)
    engine.train = stopped
    try:
        _cli_main("train", r_cmd)
    finally:
        engine.train = train_fn
    committed = sorted(int(d.name) for d in (root / "R").iterdir()
                       if d.name.isdigit())
    if committed != [PACKED_EVERY_STEPS]:
        raise AssertionError(f"the stopped run committed {committed}")
    shutil.rmtree(root / "R" / "final")
    _, resume_out = _cli_main("train", r_cmd)
    if f"resumed from step {PACKED_EVERY_STEPS}" not in resume_out:
        raise AssertionError(f"no resume: {resume_out[-600:]}")
    fu = load_params_npz(root / "U" / "final" / "params.npz")
    fr = load_params_npz(root / "R" / "final" / "params.npz")
    differ = [k for k in fu if not torch.equal(fu[k], fr[k])]
    if differ:
        raise AssertionError(f"resumed run differs from the uninterrupted "
                             f"one: {differ[:5]}")
    resume_s = time.perf_counter() - t0

    # ---- telemetry, traces, watchdog, memory gauges.
    readings = {}
    for tag, ck in (("P1", p1), ("P2", p2)):
        rows = _jsonl(ck / "tel.jsonl")
        step_rows = _check_tel_rows(tag, rows, flops, peak)
        if len(step_rows) != steps:
            raise AssertionError(f"{tag}: {len(step_rows)} step rows")
        traces = sorted((ck / "profiles").glob("capture_*/trace.json"))
        if len(traces) != 1 or "_step{}_".format(PACKED_PROFILE[0]) \
                not in traces[0].parent.name:
            raise AssertionError(f"{tag}: profile captures {traces}")
        window = trace_window(traces[0])
        _check_trace_names(tag, window.pop("kernels"))
        if (ck / "postmortem.txt").exists():
            raise AssertionError(f"{tag}: the watchdog fired: "
                                 f"{(ck / 'postmortem.txt').read_text()[:2000]}")
        ckpt = [r["seconds"] for r in rows if r.get("span") == "checkpoint"]
        summaries = [r for r in rows if r["event"] == "epoch_summary"]
        readings[tag] = {
            "epochs": [{k: r[k] for k in ("epoch", "images_per_sec",
                                          "train_loss")}
                       for r in _jsonl(ck / "m.jsonl")],
            "save_blocked_s": ckpt,
            "profile_window": window,
            "tel_mfu_steps_2_on": [r["tel_mfu"] for r in step_rows[1:]],
            "epoch_summaries": [{k: r[k] for k in (
                "tel_images_per_sec", "tel_mfu", "tel_goodput_pct",
                "tel_data_wait_frac", "tel_ckpt_s_sum",
                "tel_step_p50_s")} for r in summaries]}
    gauges, counters = snap["gauges"], snap["counters"]
    missing = [g for g in MEM_GAUGES if not gauges.get(g)]
    if missing:
        raise AssertionError(f"P2: memory gauges missing or zero: {missing}")
    if not 0.95 * max_alloc <= gauges["mem_dev0_bytes_peak"] <= max_alloc:
        raise AssertionError(f"P2: mem_dev0_bytes_peak "
                             f"{gauges['mem_dev0_bytes_peak']} against "
                             f"max_memory_allocated {max_alloc}")
    if counters.get("watchdog_stalls_total") or not counters.get(
            "watchdog_beats_total"):
        raise AssertionError(f"P2: watchdog counters {counters}")

    # ---- CIFAR-10 (a fake archive in the real format), one epoch.
    t0 = time.perf_counter()
    fake = make_fake_cifar10(root / "cifar")
    with StepProbe() as cifar:
        _cli_main("train", ["--dataset", "cifar10", "--data-root", str(fake),
                            "--preset", PRESET, "--image-size", "224",
                            "--batch-size", str(TRAIN_BATCH), "--epochs",
                            "1", "--seed", "0", "--num-workers", "1"])
    _check_step_launches("cifar10", cifar.deltas)
    cifar_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader = packed_loader_rates(root / "train", root / "test")

    emit({"phase": "train_packed", "ok": True, "model": PRESET, "px": 224,
          "batch": TRAIN_BATCH, "pack": packs, "train_shards": n_shards,
          "steps": steps, "pack_s": round(pack_s, 3),
          "p1_subprocess_s": round(p1_s, 3), "p2_s": round(p2_s, 3),
          "resume_s": round(resume_s, 3), "cifar10_s": round(cifar_s, 3),
          "loader_s": round(time.perf_counter() - t0, 3),
          "launches": launches,
          "launches_per_step": CLI_STEP_LAUNCHES,
          "async_equals_sync_bit_for_bit": True,
          "resumed_from_async_step": PACKED_EVERY_STEPS,
          "stopped_after_step": PACKED_STOP_AT,
          "resumed_final_params_bit_identical": True,
          "flops_per_image": flops, "peak_tflops": peak,
          "p1_async": readings["P1"], "p2_sync": readings["P2"],
          "memory": {**{g: gauges[g] for g in MEM_GAUGES},
                     "max_memory_allocated": max_alloc},
          "watchdog_beats": counters["watchdog_beats_total"],
          "cifar10_steps": len(cifar.deltas),
          "packed_loader": loader,
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return launches


# ------------------------------------------------------------- phase 4d
# The transfer-learning path: a seeded torchvision-layout ViT-B/16 state
# dict written for 224 px with 1000 classes (stock torch.nn layers, about
# 346 MB), fine-tuned with a frozen backbone at 224 and 384 px through the
# train CLI, the linear probe, offline batch inference at 384 px, TinyVGG.
TRANSFER_SEED = 10
# max |port (bf16 kernels) - reference (f32)| / max |reference|: bf16
# activations through 12 blocks (transfer_forwards on the CPU, the plain
# versions in bf16: 1.25e-2 at 224 px, 1.24e-2 at 384 px).
TRANSFER_TOL = 5e-2
TRANSFER_WINDOW = (3, 10)
TINYVGG_RTOL = 1e-3
BI_LADDER = (1, 8, 32)


def _stock_vit(cfg):
    """A torchvision-layout ViT from stock ``torch.nn`` layers (its
    ``state_dict`` keys follow ``torchvision.models.vit_b_16``: conv_proj,
    class_token, encoder.pos_embedding, encoder.layers.encoder_layer_i,
    encoder.ln, heads), LayerNorm epsilon ``cfg.ln_epsilon``; ``forward``
    takes NCHW images."""
    import torch
    from torch import nn
    d, eps = cfg.embedding_dim, cfg.ln_epsilon

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln_1 = nn.LayerNorm(d, eps=eps)
            self.self_attention = nn.MultiheadAttention(
                d, cfg.num_heads, batch_first=True)
            self.ln_2 = nn.LayerNorm(d, eps=eps)
            self.mlp = nn.Sequential(
                nn.Linear(d, cfg.mlp_size), nn.GELU(), nn.Dropout(0.0),
                nn.Linear(cfg.mlp_size, d), nn.Dropout(0.0))

        def forward(self, x):
            y = self.ln_1(x)
            a, _ = self.self_attention(y, y, y, need_weights=False)
            x = x + a
            return x + self.mlp(self.ln_2(x))

    class Encoder(nn.Module):
        pass

    class StockViT(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv_proj = nn.Conv2d(3, d, cfg.patch_size, cfg.patch_size)
            self.class_token = nn.Parameter(torch.randn(1, 1, d) * 0.02)
            enc = Encoder()
            enc.pos_embedding = nn.Parameter(
                torch.randn(1, cfg.seq_len, d) * 0.02)
            enc.layers = nn.ModuleDict({f"encoder_layer_{i}": Layer()
                                        for i in range(cfg.num_layers)})
            enc.ln = nn.LayerNorm(d, eps=eps)
            self.encoder = enc
            self.heads = nn.Linear(d, cfg.num_classes)

        def forward(self, x):
            p = self.conv_proj(x).flatten(2).transpose(1, 2)
            tok = torch.cat([self.class_token.expand(x.shape[0], -1, -1), p],
                            1) + self.encoder.pos_embedding
            for i in range(len(self.encoder.layers)):
                tok = self.encoder.layers[f"encoder_layer_{i}"](tok)
            return self.heads(self.encoder.ln(tok)[:, 0])

    return StockViT()


def _rel_to_max(got, want) -> float:
    """max |got - want| / max |want| in f32; raises on a nonfinite
    ``got``."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError("output is not finite")
    return float((got - want).abs().max() / want.abs().max())


def transfer_forwards(dev, sd, rng) -> dict:
    """The converted ViT-B/16 (eval, bf16, ``auto``: the flash and fused
    MLP kernels) against the stock-torch module in f32 on the card, on 8
    seeded images at 224 px and at 384 px (the stock module given the
    interpolated position embedding the converter made): logits within
    TRANSFER_TOL of the largest reference logit."""
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        params_from_flax)
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.transfer import (
        convert_torch_vit_state_dict)
    out = {}
    for px in (224, 384):
        cfg = PRESETS[PRESET](num_classes=NUM_CLASSES, image_size=px)
        tree = convert_torch_vit_state_dict(sd, cfg, include_head=True)
        stock = _stock_vit(cfg)
        stock.load_state_dict({**sd, "encoder.pos_embedding": torch.from_numpy(
            tree["backbone"]["patch_embedding"]["pos_embedding"])})
        stock.to(dev).eval()
        model = ViT(cfg)
        model.load_state_dict(params_from_flax(tree))
        model.to(dev).eval()
        x = rng.standard_normal((8, px, px, 3)).astype(np.float32)
        with torch.inference_mode():
            got = model(torch.from_numpy(x).to(dev))
            want = stock(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(dev))
        err = _rel_to_max(got, want)
        cos = float(torch.nn.functional.cosine_similarity(
            got.float().flatten(), want.float().flatten(), dim=0))
        if err > TRANSFER_TOL:
            raise AssertionError(f"converted B/16 at {px} px: logits off the "
                                 f"stock-torch forward by {err} of the max "
                                 f"(tolerance {TRANSFER_TOL})")
        out[px] = {"tokens": cfg.seq_len, "rel_err_to_max": err,
                   "cosine": cos, "argmax_agree": int(
                       (got.argmax(-1) == want.argmax(-1)).sum())}
        del stock, model
        torch.cuda.empty_cache()
    return out


def t577_kernels(gen, card_peaks, dev, k_rows) -> dict:
    """Rows 1-5 at the 384 px shapes of a batch-32 B/16 step: the MLP
    kernels at N = 32 * 577 = 18,464 rows (bf16, dropout off; held to
    their plain versions, timed beside their bf16 matmul products), the
    flash kernels at [32, 577, 12, 64] from the kernels phase's rows."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    n, d, f = 32 * 577, 768, 3072
    bf16_rate, _, hbm = card_peaks
    p = _mlp_inputs(gen, n, d, f, torch.bfloat16, dev)
    kw = dict(eps=1e-6, seed=20261018, threshold=0)
    dout = torch.randn(n, d, generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode():
        out, h = fused_mlp._launch(**p, **kw, save_h=True)
        torch.cuda.synchronize()
        fwd_err = close(out, fused_mlp.ln_mlp_residual_plain(**p, **kw),
                        TOL["bfloat16"])
        args = (p["x2"], h, p["gamma"], p["beta"], p["w1"], p["w2"], dout)
        got = fused_mlp._launch_bwd(*args, **kw)
        want = fused_mlp.ln_mlp_residual_bwd_plain(*args, **kw)
        bwd_err = max(rel_err(a, c) for a, c in zip(got, want))
        if bwd_err > 2e-2:
            raise AssertionError(f"MLP backward at N = {n}: {bwd_err}")
        rows = {}
        for name, fn, plain, flops, nbytes, lib in (
                ("fused_ln_mlp_residual",
                 lambda: fused_mlp._launch(**p, **kw),
                 lambda: fused_mlp.ln_mlp_residual_plain(**p, **kw),
                 4.0 * n * d * f,
                 2 * n * d * 2 + 2 * d * f * 2 + (f + d) * 2 + 2 * d * 4,
                 fwd_gemms_library(gen, n, d, f, dev)),
                ("fused_ln_mlp_residual_bwd",
                 lambda: fused_mlp._launch_bwd(*args, **kw),
                 lambda: fused_mlp.ln_mlp_residual_bwd_plain(*args, **kw),
                 8.0 * n * d * f,
                 (3 * n * d + n * f) * 2 + 4 * d * f * 2 + (2 * f + 4 * d)
                 * 4, gemms_library(gen, n, d, f, dev))):
            b_ms, b_by = bound(flops, nbytes, bf16_rate, hbm)
            dev_ms = device_ms(fn)
            rows[name] = {"shape": [n, d, f], "ms": time_ms(fn, 10),
                          "device_ms": dev_ms, "plain_ms": time_ms(plain, 2),
                          "bound_ms": b_ms, "bound_by": b_by,
                          "device_bound_share": b_ms / dev_ms if dev_ms
                          else None,
                          "library": "bf16 torch.matmul products",
                          "library_ms": lib["gemms_library_ms"],
                          "library_device_ms": lib["gemms_library_device_ms"]}
    del p, h, dout, args, got, want
    fl = next(r for r in k_rows if r.get("kernel") == "flash_attention"
              and r["dtype"] == "bfloat16" and r["threshold"] == 0
              and r["shape"] == [32, 577, 12, 64])
    fb = next(r for r in k_rows if r.get("kernel") == "flash_attention_bwd"
              and r["dtype"] == "bfloat16" and r["threshold"] == 0
              and r["shape"] == [32, 577, 12, 64])
    rows["flash_attention"] = {
        "shape": fl["shape"], "ms": fl["kernel_ms"],
        "device_ms": fl["kernel_device_ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "device_bound_share": fl["device_bound_share"], "library": "SDPA",
        "library_ms": fl["library_ms"],
        "library_device_ms": fl["library_device_ms"]}
    for name, key in (("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv")):
        rows[name] = {
            "shape": fb["shape"], "ms": fb[f"{key}_ms"],
            "device_ms": fb[f"{key}_device_ms"],
            "plain_ms": fb["plain_ms"], "bound_ms": fb[f"{key}_bound_ms"],
            "bound_by": fb[f"{key}_bound_by"],
            "device_bound_share": fb[f"{key}_device_bound_share"],
            "library": "SDPA backward (dq + dk + dv)",
            "library_ms": fb["library_ms"],
            "library_device_ms": fb["library_device_ms"]}
    return {"rows": rows, "mlp_fwd_max_abs_err": fwd_err,
            "mlp_bwd_max_rel_err": bwd_err}


def _check_forward_launches(tag: str, counts, forwards: int) -> None:
    """Rows 1 and 3 launched once per block in each of ``forwards``
    inference forwards; the backward and tensor-parallel rows never."""
    want = {**{k: 0 for k in counts}, "fused_ln_mlp_residual": 12 * forwards,
            "flash_attention": 12 * forwards}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, want {want}")


# ``tools.batch_infer.main`` on ``argv[2:]`` with every chunk's dispatch
# delayed ``argv[1]`` seconds, so a kill lands mid-sweep.
PACED_BATCH_INFER = f"""
import sys, time
from {PKG}.serve.offline import OfflineEngine
from {PKG}.tools import batch_infer
pause, dispatch = float(sys.argv[1]), OfflineEngine.dispatch
def paced(self, x):
    time.sleep(pause)
    return dispatch(self, x)
OfflineEngine.dispatch = paced
batch_infer.main(sys.argv[2:])
"""


def _kill_resume(argv, out: Path, clean: Path) -> dict:
    """``tools.batch_infer`` on ``argv`` + ``--out out``, its dispatch
    paced by ``PACED_BATCH_INFER``, SIGKILLed once its manifest records a
    checkpoint past record 0, then the same command resumed in this
    process: its sink and predictions mirror must equal ``clean``'s."""
    import signal
    from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
        PROGRESS_MANIFEST, sink_sha256)
    victim = subprocess.Popen(
        [sys.executable, "-c", PACED_BATCH_INFER, "3", *argv, "--out",
         str(out)], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    killed_at = None
    deadline = time.monotonic() + 300
    try:
        while killed_at is None and time.monotonic() < deadline:
            if victim.poll() is not None:
                raise AssertionError(
                    f"batch_infer victim exited {victim.returncode} before "
                    f"the kill: {victim.stderr.read()[-2000:]}")
            try:
                done = json.loads((out / PROGRESS_MANIFEST).read_text())[
                    "records_done"]
            except (OSError, ValueError, KeyError):
                done = 0
            if done > 0:
                killed_at = done
            else:
                time.sleep(0.05)
        if killed_at is None:
            raise AssertionError("batch_infer victim made no progress")
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=60)
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait(timeout=60)
        victim.stderr.close()
    resumed, _ = _cli_main("tools.batch_infer", [*argv, "--out", str(out)])
    sha = sink_sha256(out / "outputs.npy")
    if resumed["resumed_from"] < killed_at or \
            sha != sink_sha256(clean / "outputs.npy") or \
            (out / "preds.jsonl").read_bytes() != \
            (clean / "preds.jsonl").read_bytes():
        raise AssertionError(f"killed at {killed_at}, resumed from "
                             f"{resumed['resumed_from']}: the sink differs "
                             "from the unkilled run's")
    return {"killed_at_records": killed_at,
            "resumed_from": resumed["resumed_from"], "sink_sha256": sha,
            "identical": True}


def phase_transfer(dev, root: Path, gen, card_peaks, k_rows) -> dict:
    """The transfer path on the card (see the module docstring, 4d).
    Returns the launch counts of the frozen 224 px CLI run (its main
    path) and the rows 1-5 readings at T = 577."""
    import argparse
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch import probe
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        load_params_npz)
    from pytorch_vit_paper_replication_tpu_torch.data import (
        create_dataloaders, make_synthetic_image_folder, pack_image_folder)
    from pytorch_vit_paper_replication_tpu_torch.data.imagenet import (
        PackedShardDataset, eval_center_transform)
    from pytorch_vit_paper_replication_tpu_torch.data.transforms import (
        make_transform)
    from pytorch_vit_paper_replication_tpu_torch.models import (
        ViTFeatureExtractor)
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        load_inference_checkpoint, predict_batch, predict_image)
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        bf16_peak_tflops, get_registry, train_step_flops_per_image)
    from pytorch_vit_paper_replication_tpu_torch.transfer import (
        init_from_pretrained)

    t_phase = time.perf_counter()
    clock = {}
    rng = np.random.default_rng(TRANSFER_SEED)
    classes = ["pizza", "steak", "sushi"]
    # ---- the pretrained weights and the two forwards.
    torch.manual_seed(TRANSFER_SEED)
    sd = _stock_vit(PRESETS[PRESET](num_classes=NUM_CLASSES)).state_dict()
    pth = root / "vit_b_16_224.pth"
    torch.save(sd, pth)
    forwards = transfer_forwards(dev, sd, rng)
    del sd
    clock["weights_and_forwards_s"] = time.perf_counter() - t_phase

    # ---- frozen fine-tune at 224 px: the main path, counts to 0, drive,
    # read; then interrupted after step 4 and resumed.
    t0 = time.perf_counter()
    train_dir, test_dir = make_synthetic_image_folder(
        root / "ds", train_per_class=CLI_PER_CLASS[0],
        test_per_class=CLI_PER_CLASS[1], image_size=224)
    ck = root / "F224"
    run = ["--train-dir", str(train_dir), "--test-dir", str(test_dir),
           "--preset", PRESET, "--image-size", "224", "--batch-size",
           str(TRAIN_BATCH), "--epochs", str(CLI_EPOCHS), "--seed", "0",
           "--pretrained", str(pth), "--freeze-backbone",
           "--checkpoint-dir", str(ck), "--checkpoint-every-steps",
           str(CLI_EVERY_STEPS), "--keep-checkpoints", "20"]
    torch.cuda.synchronize()
    reset_counts()
    with StepProbe() as frozen:
        _cli_main("train", run)
    torch.cuda.synchronize()
    launches = read_counts()
    _check_step_launches("frozen 224", frozen.deltas)
    final = load_params_npz(ck / "final" / "params.npz")
    start = init_from_pretrained(PRESETS[PRESET](num_classes=3), pth)
    moved = [k for k in start if not torch.equal(final[k], start[k])]
    if set(final) != set(start) or sorted(moved) != ["head.bias",
                                                     "head.kernel"]:
        raise AssertionError(f"frozen run: params that moved {moved[:5]}")
    for d in ck.iterdir():
        if d.is_dir() and (d.name == "final" or (
                d.name.isdigit() and int(d.name) > CLI_RESUME_FROM)):
            shutil.rmtree(d)
    with StepProbe() as resumed:
        _, resume_out = _cli_main("train", run)
    _check_step_launches("frozen 224 resumed", resumed.deltas)
    if f"resumed from step {CLI_RESUME_FROM}" not in resume_out:
        raise AssertionError(f"frozen run did not resume: "
                             f"{resume_out[-600:]}")
    again = load_params_npz(ck / "final" / "params.npz")
    differ = [k for k in final if not torch.equal(final[k], again[k])]
    if differ:
        raise AssertionError(f"resumed frozen run differs: {differ[:5]}")
    clock["frozen_224_s"] = time.perf_counter() - t0

    # ---- the runs/transfer384_r5 command, cut to one 10-step epoch.
    t0 = time.perf_counter()
    train_c, test_c = make_synthetic_image_folder(
        root / "ds_c", train_per_class=CLI_C_PER_CLASS,
        test_per_class=CLI_PER_CLASS[1], image_size=224, seed=1)
    ck384 = root / "F384"
    cfg384 = PRESETS[PRESET](num_classes=3, image_size=384)
    flops = train_step_flops_per_image(cfg384)
    peak = bf16_peak_tflops(torch.cuda.get_device_name(0))
    get_registry().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with StepProbe(window=TRANSFER_WINDOW) as w384:
        _cli_main("train", [
            "--train-dir", str(train_c), "--test-dir", str(test_c),
            "--preset", PRESET, "--image-size", "384", "--batch-size",
            str(TRAIN_BATCH), "--epochs", "1", "--seed", "0",
            "--pretrained", str(pth), "--freeze-backbone",
            "--checkpoint-dir", str(ck384), "--metrics-jsonl",
            str(ck384 / "m.jsonl"), "--telemetry-jsonl",
            str(ck384 / "tel.jsonl"), "--telemetry-every", "4"])
    torch.cuda.synchronize()
    launches384 = read_counts()
    max_alloc = torch.cuda.max_memory_allocated()
    gauges = get_registry().snapshot()["gauges"]
    _check_step_launches("frozen 384", w384.deltas)
    step_rows = _check_tel_rows("frozen 384", _jsonl(ck384 / "tel.jsonl"),
                                flops, peak)
    summary = [r for r in _jsonl(ck384 / "tel.jsonl")
               if r["event"] == "epoch_summary"][0]
    n_win = TRANSFER_WINDOW[1] - TRANSFER_WINDOW[0] + 1
    m384 = _jsonl(ck384 / "m.jsonl")[0]
    if not np.isfinite(m384["train_loss"]):
        raise AssertionError(f"384 px run: {m384}")
    step384 = {
        "steps": len(w384.deltas), "tokens": cfg384.seq_len,
        "flops_per_image": flops, "peak_tflops": peak,
        "window_steps": list(TRANSFER_WINDOW),
        "window_wall_ms_per_step": w384.wall_s * 1e3 / n_win,
        "window_device_busy_ms_per_step": w384.busy_s * 1e3 / n_win,
        "window_idle_share": 1 - w384.busy_s / w384.wall_s,
        "window_device_events": w384.kernels,
        "window_top_device_ms_per_step": [[k, v / n_win]
                                          for k, v in w384.top_ms],
        "tel_mfu_steps": [r["tel_mfu"] for r in step_rows],
        "tel_step_s_steps": [r["tel_step_s"] for r in step_rows],
        "epoch_tel_mfu": summary["tel_mfu"],
        "epoch_tel_images_per_sec": summary["tel_images_per_sec"],
        "mem_dev0_bytes_peak": gauges.get("mem_dev0_bytes_peak"),
        "max_memory_allocated": max_alloc, "launches": launches384,
        "train_loss": m384["train_loss"], "test_acc": m384["test_acc"]}

    # predict on the 384 px export, as a user runs it.
    img = sorted(Path(test_c).rglob("*.jpg"))[0]
    _, printed = _cli_main("predict", [str(img), "--checkpoint", str(ck384),
                                       "--classes", *classes, "--preset",
                                       PRESET])
    model384, transform384, spec384 = load_inference_checkpoint(
        ck384, PRESET, len(classes), device=dev)
    label, prob, _ = predict_image(model384, img, classes, transform384)
    want = f"{img}: {label} ({prob:.3f})"
    if printed.strip().splitlines() != [want] or spec384["image_size"] != 384:
        raise AssertionError(f"predict at 384 px printed {printed!r}, "
                             f"predict_image gives {want!r}")
    clock["frozen_384_and_predict_s"] = time.perf_counter() - t0

    # ---- the linear probe on the pretrained backbone, card vs CPU
    # features on one batch of the test split.
    t0 = time.perf_counter()
    probe_res, _ = _cli_main("probe", [
        "--train-dir", str(train_dir), "--test-dir", str(test_dir),
        "--preset", PRESET, "--image-size", "224", "--pretrained", str(pth),
        "--batch-size", str(TRAIN_BATCH)])
    cfgp = PRESETS[PRESET](num_classes=1)
    state = probe._backbone_state(argparse.Namespace(
        checkpoint=None, pretrained=str(pth)), cfgp)
    _, test_dl, _ = create_dataloaders(
        train_dir, test_dir, make_transform(224, pretrained=True,
                                            normalize=True), batch_size=8)
    batch = next(iter(test_dl))
    test_dl.close()
    feats = {}
    for name, d, dtype in (("card", dev, cfgp.dtype),
                           ("cpu", torch.device("cpu"), "float32")):
        m = ViTFeatureExtractor(cfgp.replace(dtype=dtype))
        m.load_state_dict(state)
        feats[name], _ = probe.extract_features(m.to(d), [batch])
        del m
    probe_err = _rel_to_max(feats["card"], feats["cpu"])
    if probe_err > TRANSFER_TOL:
        raise AssertionError(f"probe features card vs CPU: {probe_err}")
    clock["probe_s"] = time.perf_counter() - t0

    # ---- offline batch inference at 384 px over the fixture's train split.
    t0 = time.perf_counter()
    pack384 = pack_image_folder(train_dir, root / "pack384", pack_size=384,
                                images_per_shard=32)
    classes_file = root / "classes.txt"
    classes_file.write_text("\n".join(classes) + "\n")
    bi = [str(pack384), "--checkpoint", str(ck384), "--classes-file",
          str(classes_file), "--preset", PRESET, "--batch-size",
          str(TRAIN_BATCH), "--buckets", *map(str, BI_LADDER),
          "--checkpoint-every-records", str(TRAIN_BATCH),
          "--checkpoint-every-s", "0.01", "--preds-jsonl"]
    sinks, bi_runs = {}, {}
    for head in ("probs", "logits", "features"):
        torch.cuda.synchronize()
        reset_counts()
        s, _ = _cli_main("tools.batch_infer",
                         bi + ["--out", str(root / f"bi_{head}"), "--head",
                               head])
        torch.cuda.synchronize()
        counts = read_counts()
        # One forward a chunk, plus the engine's one-image shape probe.
        _check_forward_launches(f"batch_infer {head}", counts,
                                -(-s["records"] // TRAIN_BATCH) + 1)
        sinks[head] = np.load(root / f"bi_{head}" / "outputs.npy")
        bi_runs[head] = {"launches": counts, **{k: s[k] for k in (
            "records", "images_per_sec", "steady_images_per_sec", "wall_s",
            "data_wait_s", "drain_s", "devices")}}
    ds = PackedShardDataset(pack384, eval_center_transform(
        384, normalize=spec384["normalize"]), startup_readahead=False)
    rows = [ds[i][0] for i in range(len(ds))]
    preds = predict_batch(model384, rows, classes, buckets=BI_LADDER)
    for i, ((label, prob), row) in enumerate(zip(preds, sinks["probs"])):
        if label != classes[int(row.argmax())] or prob != float(row.max()):
            raise AssertionError(f"batch_infer probs row {i} != "
                                 f"predict_batch {(label, prob)}")
    soft = torch.softmax(torch.from_numpy(sinks["logits"]).to(dev), -1)
    if not np.array_equal(soft.cpu().numpy(), sinks["probs"]) or \
            sinks["features"].shape != (len(ds), cfg384.embedding_dim):
        raise AssertionError("softmax(logits sink) != probs sink, or the "
                             "features sink has the wrong shape")
    del model384
    torch.cuda.empty_cache()
    kill = _kill_resume(bi + ["--head", "probs"], root / "bi_killed",
                        root / "bi_probs")
    clock["batch_infer_s"] = time.perf_counter() - t0

    # ---- TinyVGG: one epoch at 64 px on the card against the CPU.
    t0 = time.perf_counter()
    tv_train, tv_test = make_synthetic_image_folder(
        root / "ds64", train_per_class=CLI_PER_CLASS[0],
        test_per_class=CLI_PER_CLASS[1], image_size=64)
    tv = {}
    for d in ("cuda", "cpu"):
        tv[d], _ = _cli_main("train", [
            "--train-dir", str(tv_train), "--test-dir", str(tv_test),
            "--model", "tinyvgg", "--image-size", "64", "--dtype",
            "float32", "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
            "--seed", "0", "--num-workers", "1", "--device", d])
    for key in ("train_loss", "test_loss"):
        if not np.allclose(tv["cuda"][key], tv["cpu"][key], rtol=TINYVGG_RTOL,
                           atol=0):
            raise AssertionError(f"TinyVGG {key}: card {tv['cuda'][key]} vs "
                                 f"CPU {tv['cpu'][key]}")
    clock["tinyvgg_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    t577 = t577_kernels(gen, card_peaks, dev, k_rows)
    clock["t577_kernels_s"] = time.perf_counter() - t0
    emit({"phase": "transfer", "ok": True, "model": PRESET,
          "pretrained_pth_bytes": pth.stat().st_size,
          "forwards_vs_stock_f32": forwards, "tolerance": TRANSFER_TOL,
          "frozen_224": {"launches": launches,
                         "launches_per_step": CLI_STEP_LAUNCHES,
                         "steps": len(frozen.deltas),
                         "backbone_bit_identical": True,
                         "resumed_from_step": CLI_RESUME_FROM,
                         "resumed_final_params_bit_identical": True},
          "frozen_384": step384, "predict_384": want,
          "probe": {**probe_res, "features_card_vs_cpu_rel_err": probe_err,
                    "tolerance": TRANSFER_TOL},
          "batch_infer_384": {"runs": bi_runs, "ladder": list(BI_LADDER),
                              "probs_equal_predict_batch": True,
                              "softmax_logits_equal_probs": True,
                              "kill_resume": kill},
          "tinyvgg_64": {"card": tv["cuda"], "cpu": tv["cpu"],
                         "rtol": TINYVGG_RTOL},
          "t577": t577, "clock_s": clock,
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return {"launches": launches, "t577": t577["rows"]}


# ------------------------------------------------------------ phase 4e
# The consumers of the batch job's sinks: a student distilled from a
# teacher's logits, and embedding search over its features.
DISTILL_SEED = 12
STUDENT = "ViT-Ti/16"
# 321 train records (10 steps of 32 an epoch), 24 test.
DISTILL_PER_CLASS = (107, 8)
DISTILL_EPOCHS = 2
DISTILL_KD = ["--distill-t", "2", "--distill-alpha", "0.7"]
DISTILL_WINDOW = (3, 10)
DISTILL_CPU_STEPS = 3


class StepLosses:
    """Wraps ``engine.make_train_step`` while installed: records each
    step's loss (a host read every step)."""

    def __enter__(self):
        from pytorch_vit_paper_replication_tpu_torch import engine
        self._engine, self._make = engine, engine.make_train_step
        self.losses = []

        def make(**kw):
            step = self._make(**kw)

            def logged(state, batch):
                state, m = step(state, batch)
                self.losses.append(float(m["loss_sum"] / m["count"]))
                return state, m
            return logged
        engine.make_train_step = make
        return self

    def __exit__(self, *exc):
        self._engine.make_train_step = self._make


def _train_stopped_at(argv, steps: int):
    """``train.main(argv)`` stopped after ``steps`` train steps (engine.
    train's ``stop_check``); returns the per-step losses."""
    from pytorch_vit_paper_replication_tpu_torch import engine
    train_fn = engine.train

    def stopped(*a, **kw):
        return train_fn(*a, stop_check=lambda s: s >= steps, **kw)
    engine.train = stopped
    try:
        with StepLosses() as sl:
            _cli_main("train", argv)
    finally:
        engine.train = train_fn
    return sl.losses


def _refused(argv) -> str:
    """``train.main(argv)`` must exit non-zero before training; returns the
    message it exits with."""
    try:
        _cli_main("train", argv)
    except SystemExit as e:
        if e.code in (None, 0):
            raise AssertionError(f"train exited 0 on {argv[-2:]}")
        return str(e.code)
    raise AssertionError(f"train accepted {argv[-2:]}")


def phase_distill(dev, root: Path) -> dict:
    """Distillation on the card (see the module docstring, 4e). Returns
    what the search phase reuses (the teacher's export, its features
    sink, the fixture) and the student's launches a step."""
    import hashlib
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_state
    from pytorch_vit_paper_replication_tpu_torch.data import (
        make_synthetic_image_folder, pack_image_folder)
    from pytorch_vit_paper_replication_tpu_torch.distill.recipe import (
        pseudo_label_pack)
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        save_inference_export)
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        get_registry)

    t_phase = time.perf_counter()
    clock = {}
    classes = ["pizza", "steak", "sushi"]
    train_dir, test_dir = make_synthetic_image_folder(
        root / "ds", train_per_class=DISTILL_PER_CLASS[0],
        test_per_class=DISTILL_PER_CLASS[1], image_size=224, seed=2)
    pack = pack_image_folder(train_dir, root / "pack_train", pack_size=224,
                             images_per_shard=64, shuffle_seed=0)
    pack_test = pack_image_folder(test_dir, root / "pack_test",
                                  pack_size=224)
    classes_file = root / "classes.txt"
    classes_file.write_text("\n".join(classes) + "\n")
    clock["fixture_s"] = time.perf_counter() - t_phase

    # ---- the teacher: a seeded B/16 for the fixture's classes, its
    # logits and features swept by the batch job.
    t0 = time.perf_counter()
    teacher = ViT(PRESETS[PRESET](num_classes=len(classes)))
    teacher.load_state_dict(seeded_state(teacher, DISTILL_SEED))
    export = save_inference_export(root / "teacher", teacher,
                                   transform_spec={"normalize": False})
    del teacher
    bi = ["--checkpoint", str(export), "--classes-file", str(classes_file),
          "--preset", PRESET, "--batch-size", str(TRAIN_BATCH), "--buckets",
          *map(str, BI_LADDER)]
    sinks, bi_runs = {}, {}
    for head in ("logits", "features"):
        sinks[head] = root / f"teacher_{head}"
        torch.cuda.synchronize()
        reset_counts()
        s, _ = _cli_main("tools.batch_infer", [str(pack), *bi, "--out",
                                               str(sinks[head]), "--head",
                                               head])
        torch.cuda.synchronize()
        counts = read_counts()
        _check_forward_launches(f"teacher {head}", counts,
                                -(-s["records"] // TRAIN_BATCH) + 1)
        bi_runs[head] = {"records": s["records"], "wall_s": s["wall_s"],
                         "images_per_sec": s["images_per_sec"]}
    other_pack = root / "teacher_test_logits"
    _cli_main("tools.batch_infer", [str(pack_test), *bi, "--out",
                                    str(other_pack), "--head", "logits"])
    if not pseudo_label_pack(pack, sinks["logits"]):
        raise AssertionError("pseudo_label_pack did not relabel the pack")
    clock["teacher_s"] = time.perf_counter() - t0

    # ---- the student: the main path, counts to 0, drive, read.
    t0 = time.perf_counter()
    run = ["--dataset", "packed", "--train-dir", str(pack), "--test-dir",
           str(pack_test), "--preset", STUDENT, "--image-size", "224",
           "--batch-size", str(TRAIN_BATCH), "--seed", "0",
           "--num-workers", "1", "--distill-from", str(sinks["logits"]),
           *DISTILL_KD]
    ck = root / "student"
    get_registry().reset()
    torch.cuda.synchronize()
    reset_counts()
    with StepProbe(window=DISTILL_WINDOW) as probe:
        _, printed = _cli_main("train", run + [
            "--epochs", str(DISTILL_EPOCHS), "--checkpoint-dir", str(ck),
            "--metrics-jsonl", str(ck / "m.jsonl")])
    torch.cuda.synchronize()
    launches = read_counts()
    _check_step_launches("student", probe.deltas)
    gauges = get_registry().snapshot()["gauges"]
    rows = _jsonl(ck / "m.jsonl")
    if "distillation: teacher sink" not in printed or len(rows) != \
            DISTILL_EPOCHS or not all(
                np.isfinite(r["train_loss"]) and 0 <= r["teacher_agree"] <= 1
                for r in rows):
        raise AssertionError(f"student run: {rows}")
    want = {"distill_alpha": 0.7, "distill_t": 2.0,
            "distill_loss": round(rows[-1]["train_loss"], 6),
            "distill_teacher_agree_frac": round(rows[-1]["teacher_agree"],
                                                6)}
    if {k: gauges.get(k) for k in want} != want:
        raise AssertionError(f"distill gauges {gauges} != {want}")
    n_win = DISTILL_WINDOW[1] - DISTILL_WINDOW[0] + 1
    student = {
        "steps": len(probe.deltas), "launches": launches,
        "launches_per_step": probe.deltas[0],
        "epochs": rows, "window_steps": list(DISTILL_WINDOW),
        "window_wall_ms_per_step": probe.wall_s * 1e3 / n_win,
        "window_device_busy_ms_per_step": probe.busy_s * 1e3 / n_win,
        "window_idle_share": 1 - probe.busy_s / probe.wall_s,
        "window_device_events": probe.kernels,
        "window_top_device_ms_per_step": [[k, v / n_win]
                                          for k, v in probe.top_ms[:8]],
        "gauges": want}
    clock["student_s"] = time.perf_counter() - t0

    # ---- alpha = 0 against the ordinary run of the same argv (no
    # augmentation: both see the same pixels), one epoch each.
    t0 = time.perf_counter()
    base = [a for a in run[:run.index("--distill-from")]] + [
        "--epochs", "1", "--no-augment"]
    plain, _ = _cli_main("train", base + ["--checkpoint-dir",
                                          str(root / "plain")])
    zero, _ = _cli_main("train", base + [
        "--checkpoint-dir", str(root / "alpha0"), "--distill-from",
        str(sinks["logits"]), "--distill-alpha", "0"])
    shas = [hashlib.sha256((root / d / "final" / "params.npz").read_bytes()
                           ).hexdigest() for d in ("plain", "alpha0")]
    if plain != zero or shas[0] != shas[1]:
        raise AssertionError(f"alpha 0 run {zero} / {shas[1]} != ordinary "
                             f"run {plain} / {shas[0]}")
    clock["alpha0_s"] = time.perf_counter() - t0

    # ---- f32, TF32 off, dropout 0: the card's first steps against the
    # CPU's through the same CLI.
    t0 = time.perf_counter()
    f32 = run + ["--epochs", "1", "--no-augment", "--dtype", "float32",
                 "--dropout", "0"]
    losses = {d: _train_stopped_at(f32 + ["--device", d,
                                          "--checkpoint-dir",
                                          str(root / f"f32_{d}")],
                                   DISTILL_CPU_STEPS)
              for d in ("cuda", "cpu")}
    f32_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    if len(losses["cuda"]) != DISTILL_CPU_STEPS or not \
            f32_err <= STEP_TOL["loss"]:
        raise AssertionError(f"f32 distill steps card vs CPU: {losses}")
    clock["f32_vs_cpu_s"] = time.perf_counter() - t0

    # ---- refusals: a truncated sink, a features sink, another pack's.
    torn = root / "torn_logits"
    shutil.copytree(sinks["logits"], torn)
    with open(torn / "outputs.npy", "r+b") as f:
        f.truncate((torn / "outputs.npy").stat().st_size - 64)
    refusals = {}
    for name, sink in (("truncated", torn), ("features", sinks["features"]),
                       ("other_pack", other_pack)):
        refusals[name] = _refused(run + ["--epochs", "1", "--checkpoint-dir",
                                         str(root / "refused"),
                                         "--distill-from", str(sink)])[:120]
    emit({"phase": "distill", "ok": True, "teacher": PRESET,
          "student": STUDENT, "records": bi_runs["logits"]["records"],
          "teacher_batch_infer": bi_runs, "student_run": student,
          "alpha0_equals_ordinary": {"losses": plain["train_loss"],
                                     "params_sha256": shas[0]},
          "f32_vs_cpu": {"card": losses["cuda"], "cpu": losses["cpu"],
                         "max_rel_err": f32_err,
                         "tolerance": STEP_TOL["loss"]},
          "refusals": refusals,
          "clock_s": clock,
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return {"export": export, "classes_file": classes_file,
            "features": sinks["features"], "test_dir": test_dir,
            "train_dir": train_dir, "student": ck,
            "launches_per_step": probe.deltas[0]}


# Search: a clustered corpus of SEARCH_ROWS x SEARCH_DIM float32 (a
# mixture of SEARCH_CLUSTERS Gaussians, the JAX bench's recipe), cut from
# JAX's 10^7-row target only for this script's time limit.
SEARCH_ROWS = 2_000_000
SEARCH_DIM = 768
SEARCH_CLUSTERS = 64
SEARCH_QUERIES = 1024
SEARCH_RUNGS = (1, 8, 64)
SEARCH_CHECKED = 64
SEARCH_RTOL = 1e-5
SERVE_PROBES = 200
IVF_ROWS = 200_000
IVF_LISTS = 256
IVF_NPROBE = 8
IVF_QUERIES = 64
IVF_RECALL = 0.95


def write_corpus(out: Path, dev, rows: int, seed: int) -> None:
    """A sealed batch-job directory holding the clustered corpus: drawn on
    the card from ``seed`` in chunks, written through ``NpySink``, its
    manifest sealed with the sink's sha256."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
        NpySink, sink_sha256, write_progress)
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(SEARCH_CLUSTERS, SEARCH_DIM, generator=gen,
                          device=dev) * 4.0
    out.mkdir(parents=True)
    sink = NpySink(out / "outputs.npy", rows=rows, dim=SEARCH_DIM)
    for lo in range(0, rows, 1 << 17):
        n = min(1 << 17, rows - lo)
        pick = torch.randint(0, SEARCH_CLUSTERS, (n,), generator=gen,
                             device=dev)
        block = centers[pick] + torch.randn(n, SEARCH_DIM, generator=gen,
                                            device=dev)
        sink.write(lo, block.cpu().numpy())
    sink.close()
    write_progress(out, {
        "fingerprint": f"clustered-{SEARCH_CLUSTERS}-seed{seed}",
        "head": "features", "total_records": rows, "out_dim": SEARCH_DIM,
        "batch_size": 1 << 17, "ladder": [1 << 17], "sink": "outputs.npy",
        "records_done": rows, "rows_written": rows, "preds_bytes": None,
        "sink_sha256": sink_sha256(out / "outputs.npy")})


def _queries(db, n: int, seed: int):
    """Near-duplicate queries (the JAX bench's): corpus rows + 0.1 noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    picks = np.sort(rng.choice(db.shape[0], n, replace=False))
    return (np.asarray(db[picks], np.float32) + 0.1 * rng.standard_normal(
        (n, db.shape[1])).astype(np.float32))


def _reference(db, q, k: int) -> tuple:
    """NumPy ``reference_topk`` of every query row, 8 rows a call over a
    thread pool (NumPy releases the interpreter lock in its products and
    sorts)."""
    import concurrent.futures as cf
    import numpy as np
    from pytorch_vit_paper_replication_tpu_torch.search import (
        reference_topk)
    chunks = [q[i:i + 8] for i in range(0, len(q), 8)]
    with cf.ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(lambda c: reference_topk(db, c, k), chunks))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def check_topk(db, q, got, ref, k: int, norms=None) -> dict:
    """The scan's top ``k`` against the reference's top ``k + 1``: the
    score at every rank within SEARCH_RTOL of the reference's, every id's
    score (recomputed in f64; over its norm for cosine) within SEARCH_RTOL
    of its rank's reference score, and ids equal except in queries whose
    reference has two adjacent scores among its first ``k + 1`` closer
    than SEARCH_RTOL (near ties, counted)."""
    import numpy as np
    got_s, got_i = got[0][:len(q), :k], got[1][:len(q), :k]
    ref_s, ref_i = ref[0][:, :k + 1], ref[1][:, :k + 1]
    rel = np.abs(got_s - ref_s[:, :k]) / np.abs(ref_s[:, :k])
    exact = np.stack([np.asarray(db[got_i[i]], np.float64)
                      @ q[i].astype(np.float64) for i in range(len(q))])
    if norms is not None:
        exact = exact / np.asarray(norms, np.float64)[got_i]
    rel_ids = np.abs(exact - ref_s[:, :k]) / np.abs(ref_s[:, :k])
    gaps = np.abs(np.diff(ref_s, axis=1)) / np.abs(ref_s[:, 1:])
    near = (gaps < SEARCH_RTOL).any(axis=1)
    differ = (got_i != ref_i[:, :k]).any(axis=1)
    if rel.max() > SEARCH_RTOL or rel_ids.max() > SEARCH_RTOL or \
            (differ & ~near).any():
        raise AssertionError(
            f"top-{k}: score rel err {rel.max()}, id score rel err "
            f"{rel_ids.max()}, ids differ in queries "
            f"{np.flatnonzero(differ & ~near)[:5]} with no near tie")
    return {"k": k, "queries": len(q), "max_rel_err": float(rel.max()),
            "max_id_score_rel_err": float(rel_ids.max()),
            "near_tie_queries": int(near.sum()),
            "ids_differ_in_near_tie_queries": int(differ.sum()),
            "tolerance": SEARCH_RTOL}


def scan_rung(scanner, q, r: int, k: int, card_peaks) -> dict:
    """One chunk of rung ``r``: event ms a chunk (the scan waits for its
    fetch), device ms by kernel from the profiler, the scores kernel's
    share, queries/s and the bound of the scan's function (each row read
    once, the queries read and the k results written once; 2 r N K FLOP at
    the f32 non-tensor rate)."""
    chunk = q[:r]
    ms = time_ms(lambda: scanner.scan(chunk, k), reps=10)
    by_kernel = kernel_breakdown(lambda: scanner.scan(chunk, k), reps=3)
    device = sum(by_kernel.values())
    scores = sum(v for n, v in by_kernel.items() if "scan_scores" in n)
    n, d = scanner.rows, scanner.dim
    b_ms, b_by = bound(2.0 * r * n * d, 4.0 * (n * d + r * d) + 12.0 * r * k,
                       card_peaks[1], card_peaks[2])
    return {"rung": r, "k": k, "ms": ms, "device_ms": device,
            "scores_kernel_device_ms": scores,
            "topk_and_rest_share": 1 - scores / device,
            "queries_per_s": r / ms * 1e3, "bound_ms": b_ms,
            "bound_by": b_by, "bound_share": b_ms / ms,
            "top_device_ms": sorted(by_kernel.items(),
                                    key=lambda kv: -kv[1])[:6]}


def scan_kernel_row(scanner, q, card_peaks) -> dict:
    """The scores kernel against its plain version and one library call
    (``q @ blockᵀ``, TF32 off) at the main path's shape: 64 queries by one
    row block of the 2M-row shard."""
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import scan_scores as ss
    qd = torch.from_numpy(q[:SEARCH_RUNGS[-1]]).to(scanner.devices[0])
    blk = scanner._shards[0].db[:scanner._block]
    out = ss._launch(qd, blk)
    plain = ss.scan_scores_plain(qd, blk)
    err = (out - plain).abs().max().item()
    rel = err / plain.abs().max().item()
    if not rel < SEARCH_RTOL:
        raise AssertionError(f"scan_scores vs plain: rel err {rel}")
    m, n, d = qd.shape[0], blk.shape[0], blk.shape[1]
    b_ms, b_by = bound(2.0 * m * n * d, 4.0 * (m * d + n * d + m * n),
                       card_peaks[1], card_peaks[2])
    ms = time_ms(lambda: ss._launch(qd, blk), reps=10)
    dev_ms = device_ms(lambda: ss._launch(qd, blk), reps=10)
    lib = time_ms(lambda: qd @ blk.T, reps=10)
    return {"shape": [m, n, d], "max_abs_err": err, "max_rel_err": rel,
            "ms": ms, "device_ms": dev_ms,
            "plain_ms": time_ms(lambda: ss.scan_scores_plain(qd, blk),
                                reps=5),
            "library_ms": lib,
            "library_device_ms": device_ms(lambda: qd @ blk.T, reps=10),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}


def phase_search(dev, root: Path, d: dict, card_peaks) -> dict:
    """Embedding search on the card (see the module docstring, 4e).
    Returns the scores kernel's row and the launches of one ``::search``
    embed."""
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch.ops import scan_scores as ss
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        image_row, load_class_names, load_inference_checkpoint)
    from pytorch_vit_paper_replication_tpu_torch.search import (
        EmbeddingIndex, ShardedScanner, ivf_search, recall_at_k,
        reference_topk)
    from pytorch_vit_paper_replication_tpu_torch.serve.bucketing import (
        plan_buckets)
    from pytorch_vit_paper_replication_tpu_torch.serve.engine import (
        InferenceEngine)
    from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
        NpySink, OfflineEngine, sink_sha256, write_progress)

    t_phase = time.perf_counter()
    clock = {}
    # ---- indexes over the teacher's features sink; the cosine one
    # against the reference.
    idx = {m: root / f"idx_{m}" for m in ("ip", "cosine")}
    for metric, path in idx.items():
        _cli_main("tools.build_index", [str(d["features"]), "--out",
                                        str(path), "--metric", metric])
    small = {}
    for metric, path in idx.items():
        index = EmbeddingIndex(path)
        q = np.asarray(index.embeddings[:16]) + 0.5
        got = ShardedScanner(index.embeddings, k_max=10, metric=metric,
                             norms=index.norms, devices=[dev]).scan(q, 10)
        ref = reference_topk(index.embeddings, q, 11, metric=metric,
                             norms=index.norms)
        small[metric] = check_topk(
            index.embeddings, q, got, ref, 10,
            norms=index.norms if metric == "cosine" else None)
    clock["fixture_indexes_s"] = time.perf_counter() - t_phase

    # ---- online equals offline: the probe's features at batch 1, scanned
    # at rung 1, against the serve CLI's lone ::search and ::req k=.
    t0 = time.perf_counter()
    classes = load_class_names(d["classes_file"])
    probes = sorted(Path(d["test_dir"]).rglob("*.jpg"))
    model, transform, spec = load_inference_checkpoint(
        d["export"], PRESET, len(classes), device=dev)
    lone = OfflineEngine(model, head="features", image_size=spec[
        "image_size"], buckets=(1,), devices=[dev])
    emb = lone.dispatch(image_row(probes[0], transform)[None])[0].cpu(
        ).numpy()
    ip = EmbeddingIndex(idx["ip"])
    want = ShardedScanner(ip.embeddings, k_max=10, devices=[dev]).scan(
        emb, 10)
    del lone, model
    eng = InferenceEngine.from_checkpoint(
        d["export"], preset=PRESET, class_names=classes, device=dev,
        buckets=BUCKETS, use_manifest=False, search_index=idx["ip"],
        search_k_max=10)
    try:
        torch.cuda.synchronize()
        reset_counts()
        ss.launches = 0
        ids, scores = eng.search(str(probes[0]), 10)
        torch.cuda.synchronize()
        search_launches = {**read_counts(), "scan_scores": ss.launches}
    finally:
        eng.close()
    _check_forward_launches("::search embed", {
        k: v for k, v in search_launches.items() if k != "scan_scores"}, 1)
    if ids != want[1][0].tolist() or \
            not np.array_equal(np.float32(scores), want[0][0]) or \
            search_launches["scan_scores"] != 1:
        raise AssertionError(f"engine.search {ids} {scores} != offline "
                             f"{want}; launches {search_launches}")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.serve", "--checkpoint",
         str(d["export"]), "--preset", PRESET, "--classes-file",
         str(d["classes_file"]), "--buckets", ",".join(map(str, BUCKETS)),
         "--sync-warmup", "--no-manifest", "--search-index", str(idx["ip"]),
         "--search-k-max", "10"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        def ask(line):
            proc.stdin.write(line + "\n")
            proc.stdin.flush()
            return proc.stdout.readline().rstrip("\n")
        reply = ask(f"::search 10 {probes[0]}")
        relay = ask(f"::req k=10 {probes[0]}")
        path, tag, payload = reply.split("\t", 2)
        got = json.loads(payload)
        if (path, tag) != (str(probes[0]), "search") or relay != reply or \
                got["ids"] != want[1][0].tolist() or not np.array_equal(
                    np.float32(got["scores"]), want[0][0]):
            raise AssertionError(f"serve ::search {reply!r} / {relay!r} != "
                                 f"offline {want}")
        lat = []
        for i in range(SERVE_PROBES):
            t1 = time.perf_counter()
            r = ask(f"::search 10 {probes[i % len(probes)]}")
            lat.append(time.perf_counter() - t1)
            if "\tsearch\t" not in r:
                raise AssertionError(f"serve ::search: {r!r}")
    finally:
        proc.stdin.close()
        rc = proc.wait(timeout=120)
        stderr = proc.stderr.read()
        proc.stderr.close()
        proc.stdout.close()
    if rc != 0:
        raise AssertionError(f"serve exited {rc}: {stderr[-2000:]}")
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    serve = {"probes": SERVE_PROBES, "index_rows": ip.rows,
             "p50_ms": float(np.percentile(lat_ms, 50)),
             "p99_ms": float(np.percentile(lat_ms, 99)),
             "mean_ms": float(lat_ms.mean()),
             "online_equals_offline": True, "launches_per_search":
             search_launches}
    clock["serve_s"] = time.perf_counter() - t0

    # ---- the clustered corpus, indexed, on the card.
    t0 = time.perf_counter()
    need = 1.3 * SEARCH_ROWS * SEARCH_DIM * 4
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"{root}: {free} bytes free, the corpus needs "
                             f"{need:.0f}")
    write_corpus(root / "corpus", dev, SEARCH_ROWS, seed=13)
    clock["corpus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    built, _ = _cli_main("tools.build_index", [str(root / "corpus"),
                                               "--out", str(root / "cidx")])
    clock["build_index_s"] = time.perf_counter() - t0
    index = EmbeddingIndex(root / "cidx")
    q = _queries(index.embeddings, SEARCH_QUERIES, seed=14)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scanner = ShardedScanner(index.embeddings, k_max=100, devices=[dev],
                             query_buckets=SEARCH_RUNGS)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    ss.launches = 0
    t0 = time.perf_counter()
    top10 = scanner.scan(q, 10)
    scan10_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    top100 = scanner.scan(q, 100)
    scan100_s = time.perf_counter() - t0
    scan_launches = {**read_counts(), "scan_scores": ss.launches}
    blocks = -(-SEARCH_ROWS // scanner._block)
    chunks = len(plan_buckets(SEARCH_QUERIES, SEARCH_RUNGS))
    if scan_launches != {**{k: 0 for k in read_counts()},
                         "scan_scores": 2 * chunks * blocks}:
        raise AssertionError(f"scan launches {scan_launches}")
    t0 = time.perf_counter()
    qc = q[:SEARCH_CHECKED]
    ref = _reference(index.embeddings, qc, 101)
    checks = [check_topk(index.embeddings, qc, top10, ref, 10),
              check_topk(index.embeddings, qc, top100, ref, 100)]
    clock["reference_s"] = time.perf_counter() - t0
    # The padded tail on the real index: 5 queries ride rung 8, each alone
    # rung 1; bit for bit.
    tail = scanner.scan(q[:5], 10)
    for j in range(5):
        one = scanner.scan(q[j], 10)
        if not (np.array_equal(one[0][0], tail[0][j])
                and np.array_equal(one[1][0], tail[1][j])):
            raise AssertionError(f"padded tail: query {j} alone differs")
    # Ties: 1,600 duplicated rows; each query's own row and its copy tie
    # exactly at the top and resolve to the lower id.
    base = np.random.default_rng(15).standard_normal(
        (4000, SEARCH_DIM)).astype(np.float32)
    dup = np.concatenate([base, base[:1600]])
    tie = ShardedScanner(dup, k_max=8, devices=[dev]).scan(base[:5], 8)
    tie_ref = reference_topk(dup, base[:5], 8)
    if not np.array_equal(tie[1], tie_ref[1]) or \
            not (tie[1][:, :2] == np.arange(5)[:, None] + [0, 4000]).all():
        raise AssertionError(f"ties: {tie[1]} != {tie_ref[1]}")
    rungs = [scan_rung(scanner, q, r, 10, card_peaks) for r in SEARCH_RUNGS]
    kernel = scan_kernel_row(scanner, q, card_peaks)
    kernel["launches"] = scan_launches["scan_scores"]
    block_rows = scanner._block
    del scanner
    torch.cuda.empty_cache()

    # ---- IVF over the first IVF_ROWS rows, as their own sealed sink.
    t0 = time.perf_counter()
    sl = root / "slice"
    sl.mkdir()
    sink = NpySink(sl / "outputs.npy", rows=IVF_ROWS, dim=SEARCH_DIM)
    sink.write(0, np.asarray(index.embeddings[:IVF_ROWS]))
    sink.close()
    write_progress(sl, {
        "fingerprint": "clustered-slice", "head": "features",
        "total_records": IVF_ROWS, "out_dim": SEARCH_DIM,
        "batch_size": IVF_ROWS, "ladder": [IVF_ROWS],
        "sink": "outputs.npy", "records_done": IVF_ROWS,
        "rows_written": IVF_ROWS, "preds_bytes": None,
        "sink_sha256": sink_sha256(sl / "outputs.npy")})
    t1 = time.perf_counter()
    _cli_main("tools.build_index", [str(sl), "--out", str(root / "ivf"),
                                    "--ivf-lists", str(IVF_LISTS)])
    ivf_build_s = time.perf_counter() - t1
    ivf = EmbeddingIndex(root / "ivf")
    qi = _queries(ivf.embeddings, IVF_QUERIES, seed=16)
    exact = _reference(ivf.embeddings, qi, 10)
    t1 = time.perf_counter()
    _, approx = ivf_search(ivf, qi, 10, nprobe=IVF_NPROBE)
    ivf_s = time.perf_counter() - t1
    recall = recall_at_k(approx, exact[1])
    order, starts = ivf.invlists()
    sizes = np.diff(starts)
    cd2 = ((qi * qi).sum(1)[:, None] - 2.0 * (qi @ ivf.centroids.T)
           + (ivf.centroids * ivf.centroids).sum(1)[None, :])
    probed = np.argsort(cd2, axis=1, kind="stable")[:, :IVF_NPROBE]
    touched = float(sizes[probed].sum(1).mean() / IVF_ROWS)
    if recall < IVF_RECALL:
        raise AssertionError(f"IVF recall@10 {recall} < {IVF_RECALL}")
    clock["ivf_s"] = time.perf_counter() - t0
    emit({"phase": "search", "ok": True, "card": card_line(),
          "fixture_indexes": small, "serve_cli": serve,
          "corpus": {"rows": SEARCH_ROWS, "dim": SEARCH_DIM,
                     "clusters": SEARCH_CLUSTERS,
                     "bytes": index.nbytes(),
                     "build_index_s": clock["build_index_s"],
                     "build_summary": built, "h2d_s": h2d_s,
                     "score_block_rows": block_rows,
                     "score_blocks": blocks},
          "scan": {"queries": SEARCH_QUERIES, "rungs": list(SEARCH_RUNGS),
                   "k10_s": scan10_s, "k100_s": scan100_s,
                   "k10_queries_per_s": SEARCH_QUERIES / scan10_s,
                   "k100_queries_per_s": SEARCH_QUERIES / scan100_s,
                   "launches": scan_launches, "vs_reference": checks,
                   "padded_tail_bit_identical": True,
                   "ties_lowest_id": True, "per_rung": rungs},
          "scores_kernel": kernel,
          "ivf": {"rows": IVF_ROWS, "nlist": IVF_LISTS,
                  "nprobe": IVF_NPROBE, "queries": IVF_QUERIES,
                  "recall_at_10": recall, "gate": IVF_RECALL,
                  "rows_touched_share": touched, "build_s": ivf_build_s,
                  "search_s": ivf_s},
          "clock_s": clock,
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return {"kernel": kernel, "search_launches": search_launches,
            "index": idx["ip"]}


# ------------------------------------------------------------- phase 4f
# The serving fleet: ``python -m ...serve.fleet`` over ViT-B/16 replicas
# (the distill phase's teacher export) on the one card, the committed
# load profiles replayed as they are, a SIGKILL, ``::swap``, a ViT-Ti/16 /
# ViT-B/16 cascade, and every process's telemetry sinks.
FLEET_BUCKETS = (1, 4, 8)
FLEET_TRACE_SAMPLE = 0.05
FLEET_TRACE_SEED = 5
FLEET_KILL_AT_S = 15.0
FLEET_SWAP_SEED = 13
FLEET_SWAP_TIMEOUT_S = 300.0
FLEET_BAD_WARM_TIMEOUT_S = 15
# The traced pass: TraceClients mint the traces (the router and the
# replicas adopt them), 4 s at 100 rps over rungs 1 and 8.
FLEET_TRACED_PROFILE = {"seed": 5, "duration_s": 4.0, "baseline_rps": 100.0,
                        "head_mix": {"probs": 1.0},
                        "tier_mix": {"interactive": 1.0},
                        "rung_mix": {"1": 0.5, "8": 0.5}}
CASCADE_PROBES = 200


def _ask_lines(address, lines, timeout=120.0) -> list:
    """One connection, one reply line per request line; a ``::metrics``
    block is read up to its blank line."""
    import socket
    with socket.create_connection(address, timeout=timeout) as sock:
        sock.settimeout(timeout)
        rfile = sock.makefile("r", encoding="utf-8")
        out = []
        for line in lines:
            sock.sendall((line + "\n").encode())
            if line == "::metrics":
                block = []
                for reply in rfile:
                    if reply == "\n":
                        break
                    block.append(reply)
                out.append("".join(block))
            else:
                out.append(rfile.readline().rstrip("\n"))
        return out


def _stats(address) -> dict:
    return json.loads(_ask_lines(address, ["::stats"])[0])


def _swap(address, checkpoint, timeout_s: float = FLEET_SWAP_TIMEOUT_S
          ) -> dict:
    """``::swap <checkpoint>`` to a fleet router, then ``::swap-status``
    until it reports on that checkpoint; returns the report."""
    started = json.loads(_ask_lines(address, [f"::swap {checkpoint}"])[0])
    if started.get("swap") != "started":
        raise AssertionError(f"::swap {checkpoint}: {started}")
    return _swap_report(address, checkpoint, timeout_s)


def _swap_report(address, checkpoint, timeout_s: float) -> dict:
    deadline = time.perf_counter() + timeout_s
    while True:
        status = json.loads(_ask_lines(address, ["::swap-status"])[0])
        if status.get("checkpoint") == str(checkpoint):
            return status
        if time.perf_counter() > deadline:
            raise AssertionError(f"no swap report on {checkpoint} in "
                                 f"{timeout_s} s: {status}")
        time.sleep(0.2)


def _warm(address, timeout_s: float = 300.0) -> None:
    """Wait until every replica behind the router is up and warm for
    FLEET_BUCKETS."""
    deadline = time.perf_counter() + timeout_s
    while True:
        reps = _stats(address)["replicas"]
        if all(r["up"] and set(FLEET_BUCKETS) <= set(r["warm_rungs"])
               for r in reps.values()):
            return
        if time.perf_counter() > deadline:
            raise AssertionError(f"replicas not warm: {reps}")
        time.sleep(0.1)


class _FleetCLI:
    """``python -m ...serve.fleet ARGV`` as a user starts it: its router's
    address from the ``router listening on`` line, stopped by SIGINT (the
    CLI closes its replicas); replicas left alive after it are killed."""

    def __init__(self, argv, env=None):
        import subprocess as sp
        import threading
        self.t0 = time.perf_counter()
        self.proc = sp.Popen([sys.executable, "-m", f"{PKG}.serve.fleet",
                              *map(str, argv)], stderr=sp.PIPE, text=True,
                             cwd=REPO, env=env)
        self.err, self.address = [], None
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stderr:
            self.err.append(line)
            if "router listening on" in line:
                host, port = line.split("listening on ")[1].split()[0].split(
                    ":")
                self.address = (host, int(port))
            if "replicas ready:" in line:
                self._ready.set()
        self._ready.set()

    def wait_warm(self, timeout_s: float = 300.0) -> float:
        """Seconds from the start to every replica up and warm."""
        self._ready.wait(timeout_s)
        if self.address is None or not any(
                "replicas ready: True" in x for x in self.err):
            raise AssertionError(f"fleet CLI did not come up: "
                                 f"{''.join(self.err[-20:])}")
        _warm(self.address, timeout_s)
        return round(time.perf_counter() - self.t0, 3)

    def replica_pids(self) -> list:
        """The CLI's child processes (its replicas), oldest first."""
        pids = []
        for p in Path("/proc").iterdir():
            if not p.name.isdigit():
                continue
            try:
                fields = (p / "stat").read_text().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == self.proc.pid:
                pids.append(int(p.name))
        return sorted(pids)

    def stop(self) -> int:
        import os
        import signal
        import subprocess as sp
        children = self.replica_pids()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout=120)
        except sp.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self._reader.join(10)
        for pid in children:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        return rc


def _prometheus_ok(text: str) -> int:
    """Parse Prometheus text: every sample has a HELP and a TYPE line;
    returns the sample count."""
    helps, types, samples = set(), set(), 0
    for line in text.splitlines():
        if line.startswith("# HELP "):
            helps.add(line.split()[2])
        elif line.startswith("# TYPE "):
            types.add(line.split()[2])
        elif line.strip():
            name = line.split("{")[0].split()[0]
            base = name.rsplit("_count", 1)[0].rsplit("_sum", 1)[0] \
                if name not in helps else name
            float(line.rsplit(" ", 1)[1])
            if base not in helps or base not in types:
                raise AssertionError(f"sample {line!r} has no HELP/TYPE")
            samples += 1
    if not samples:
        raise AssertionError("empty Prometheus block")
    return samples


def _in_process(export, preset, classes, dev, **kw):
    from pytorch_vit_paper_replication_tpu_torch.serve import InferenceEngine
    return InferenceEngine.from_checkpoint(
        export, preset=preset, class_names=classes, device=dev,
        buckets=FLEET_BUCKETS, use_manifest=False, **kw)


def _lone(eng, lines) -> list:
    """Each line answered alone (bucket 1) by an in-process engine, as
    the serve CLI answers it."""
    from pytorch_vit_paper_replication_tpu_torch.serve.__main__ import (
        _answer)
    return [_answer(line, eng, None) for line in lines]


ROUTE_COUNTERS = ("fleet_route_requests_total", "fleet_route_retries_total",
                  "fleet_route_rejected_total", "fleet_route_errors_total")


def _replay(address, profile, lines, *, during=None):
    """``TraceClients`` over ``profile`` (a committed profile's name, or a
    dict) against the router at ``address``; ``during(t0)`` runs beside it
    in a thread (``t0`` the replay's start on the ``perf_counter`` clock).
    Returns the report with the router's counter deltas (its ``::stats``)
    and what ``during`` returned."""
    import threading
    from pytorch_vit_paper_replication_tpu_torch.serve.loadgen import (
        LoadProfile, TraceClients)
    profile = (LoadProfile.from_dict(profile, name="traced")
               if isinstance(profile, dict) else
               LoadProfile.load(REPO / "profiles" / f"{profile}.json"))
    c0 = _stats(address)["counters"]
    clients = TraceClients(address, lines, profile, clients_per_rung=8,
                           reply_timeout_s=120.0)
    out = {}
    side = None
    clients.start()
    t0 = time.perf_counter()
    if during is not None:
        side = threading.Thread(
            target=lambda: out.update(during(t0) or {}), daemon=True)
        side.start()
    clients.join(profile.duration_s + 240.0)
    if side is not None:
        side.join(FLEET_SWAP_TIMEOUT_S * 2)
    c1 = _stats(address)["counters"]
    rep = clients.report()
    rep["router"] = {k: c1.get(k, 0) - c0.get(k, 0) for k in ROUTE_COUNTERS}
    rep["side"] = out
    return rep


def _check_exactly_once(tag: str, rep: dict, backpressure_ok: bool) -> int:
    """Every arrival answered once: by a reply or, where allowed, by an
    explicit backpressure line (counted by the router); no other error."""
    req = rep["requests"]
    refused = (rep["router"]["fleet_route_rejected_total"]
               + rep["router"]["fleet_route_errors_total"])
    if not (req["sent"] == req["answered"] == rep["scheduled"]
            and req["dropped"] == req["double_answered"] == 0
            and req["connect_failures"] == 0):
        raise AssertionError(f"{tag}: not exactly once: {req}")
    if req["errors"] != (refused if backpressure_ok else 0) or not all(
            "retry after" in e for e in req["error_replies"]):
        raise AssertionError(f"{tag}: error lines other than backpressure: "
                             f"{req['errors']} errors, {refused} refused by "
                             f"the router: {req['error_replies'][:5]}")
    return refused


def phase_fleet(dev, root: Path, d: dict, search: dict) -> dict:
    """The serving fleet on the card (see the module docstring, 4f).
    Returns the kernels' launches in the in-process engine the routed
    replies were held to."""
    import math
    import os
    import signal
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_state
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import _build
    from pytorch_vit_paper_replication_tpu_torch.ops import scan_scores as ss
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        load_class_names, save_inference_export)
    from pytorch_vit_paper_replication_tpu_torch.serve.cascade import (
        softmax_margin)
    from pytorch_vit_paper_replication_tpu_torch.serve.fleet import (
        __main__ as fleet_cli)
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        FrameSink, merged_chrome_trace, tracing, validate_chrome_trace)

    t_phase = time.perf_counter()
    clock = {}
    # The replicas this process spawns run ``python -m`` from the checkout.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    classes = load_class_names(d["classes_file"])
    images = sorted(Path(d["train_dir"]).rglob("*.jpg"))
    probes = [str(p) for p in images[:CASCADE_PROBES]]
    lines = [str(p) for p in images]
    export, index = d["export"], search["index"]
    # A second seeded B/16 export to swap to, and a corrupt copy of it.
    new = ViT(PRESETS[PRESET](num_classes=len(classes)))
    new.load_state_dict(seeded_state(new, FLEET_SWAP_SEED))
    export2 = save_inference_export(root / "teacher2", new,
                                    transform_spec={"normalize": False})
    del new
    bad = root / "teacher2_bad"
    shutil.copytree(export2, bad)
    with open(bad / "params.npz", "r+b") as f:
        f.truncate(4096)
    eng2 = _in_process(export2, PRESET, classes, dev)
    try:
        want2 = _lone(eng2, [f"::probs {p}" for p in probes[:8]])
    finally:
        eng2.close()
    sink = FrameSink()
    ship = ["--ship-to", f"127.0.0.1:{sink.port}", "--ship-interval-s", "1"]
    fleet_argv = ["--checkpoint", str(export), "--classes-file",
                  str(d["classes_file"]), "--preset", PRESET, "--replicas",
                  "2", "--devices", "1", "--port", "0", "--buckets",
                  ",".join(map(str, FLEET_BUCKETS))]
    cold = root / "build_cold"
    out = {"card": card_line(), "replicas": 2, "devices": 1,
           "buckets": list(FLEET_BUCKETS)}

    # ---- 1. the fleet CLI: two B/16 replicas on the one card, booting
    # together into an empty kernel build directory; --swap-probe for the
    # swap's bit-identity gate, the router shipping to the sink.
    cli = _FleetCLI(fleet_argv + ["--swap-probe", probes[0], *ship,
                                  "--worker-id", "router-cli"],
                    env={**os.environ, "VIT_TORCH_BUILD_DIR": str(cold)})
    traced, cascade_clis = None, {}
    try:
        try:
            out["boot_cold_s"] = cli.wait_warm()
            clock["boot_s"] = time.perf_counter() - t_phase

            # The same fleet assembled in this process by the CLI's own
            # parse_args / build_fleet (its defaults, --swap-warm-timeout-s
            # short for the corrupt swap), its replicas with their own sinks
            # and the search index, its router traced here: it boots while
            # the CLI's fleet is checked.
            t0 = time.perf_counter()
            traced = fleet_cli.build_fleet(
                fleet_cli.parse_args(fleet_argv + [
                    "--swap-warm-timeout-s", str(FLEET_BAD_WARM_TIMEOUT_S)]),
                replica_extra=ship + [
                    "--search-index", str(index), "--search-k-max", "10",
                    "--trace-sample", str(FLEET_TRACE_SAMPLE), "--trace-seed",
                    str(FLEET_TRACE_SEED)])
            for spec in traced.specs:
                spec.extra_args += ["--trace-jsonl",
                                    str(root / f"trace_{spec.rid}.jsonl"),
                                    "--trace-role", f"replica-{spec.rid}"]
            traced.manager.start()
            traced.router.start()
            t_addr = traced.router.address

            # ---- 4 (first, on a quiet fleet). Routed ::probs, features and
            # ::search against an in-process engine on the card, its launches
            # counted: the CLI's fleet answers the first two, the traced
            # fleet (the one with --search-index) all three.
            ask = [f"::probs {probes[0]}", f"::req head=features {probes[1]}",
                   f"::search 5 {probes[2]}", f"::probs {probes[3]}"]
            cli_ask = _ask_lines(cli.address, [ask[0], ask[1], ask[3]])
            eng = _in_process(export, PRESET, classes, dev, search_index=index,
                              search_k_max=10)
            try:
                torch.cuda.synchronize()
                reset_counts()
                ss.launches = 0
                want = _lone(eng, ask)
                torch.cuda.synchronize()
                launches = read_counts()
                scans = ss.launches
            finally:
                eng.close()
            _check_forward_launches("fleet in-process engine", launches,
                                    len(ask))
            if scans != 1:
                raise AssertionError(f"one ::search, {scans} scores launches")
            launches["scan_scores"] = scans
            if cli_ask != [want[0], want[1], want[3]]:
                raise AssertionError(f"the fleet CLI's replies differ from "
                                     f"the in-process engine's: "
                                     f"{cli_ask[:2]} vs {want[:2]}")
            _warm(t_addr)
            out["boot_warm_pair_s"] = round(time.perf_counter() - t0, 3)
            routed = _ask_lines(t_addr, ask)
            if routed != want:
                raise AssertionError(f"routed replies (with ::search) differ "
                                     f"from the in-process engine's: "
                                     f"{routed[2]} vs {want[2]}")
            out["direct_equality"] = {"lines": len(ask), "bit_identical": True,
                                      "in_process_launches": launches}
            clock["direct_s"] = time.perf_counter() - t0

            # ---- 2. burst4x through the CLI's router, one replica SIGKILLed
            # at t = 15 s.
            t0 = time.perf_counter()

            def kill(t_start):
                while time.perf_counter() - t_start < FLEET_KILL_AT_S:
                    time.sleep(0.01)
                reps = _stats(cli.address)["replicas"]
                before = {rid: r["restarts"] for rid, r in reps.items()}
                victim = cli.replica_pids()[-1]
                t_kill = time.perf_counter()
                os.kill(victim, signal.SIGKILL)
                while time.perf_counter() - t_kill < 240:
                    reps = _stats(cli.address)["replicas"]
                    back = [rid for rid, r in reps.items()
                            if r["restarts"] > before[rid] and r["up"]
                            and set(FLEET_BUCKETS) <= set(r["warm_rungs"])]
                    if back:
                        return {"killed_pid": victim, "restarted": back,
                                "restart_s": round(
                                    time.perf_counter() - t_kill, 3)}
                    time.sleep(0.05)
                return {"killed_pid": victim, "restart_s": None}

            burst = _replay(cli.address, "burst4x", lines, during=kill)
            refused = _check_exactly_once("burst4x", burst,
                                          backpressure_ok=True)
            if burst["side"].get("restart_s") is None or \
                    burst["side"]["killed_pid"] in cli.replica_pids():
                raise AssertionError(f"the killed replica was not restarted "
                                     f"and re-admitted: {burst['side']}")
            out["burst4x"] = {"scheduled": burst["scheduled"],
                              "requests": {k: burst["requests"][k] for k in (
                                  "sent", "answered", "errors", "dropped",
                                  "double_answered")},
                              "backpressure_replies": refused,
                              "router": burst["router"],
                              "phases": burst["phases"],
                              "kill_at_s": FLEET_KILL_AT_S,
                              "restarted": burst["side"]["restarted"],
                              "restart_s": burst["side"]["restart_s"],
                              "replica_restarts_total": _stats(cli.address)[
                                  "counters"].get("replica_restarts_total", 0)}
            out["boot_warm_s"] = burst["side"]["restart_s"]
            clock["burst_s"] = time.perf_counter() - t0

            # ---- 3. steady with ::swap to the second export through the
            # router (re-admission gated on the CLI's --swap-probe row), then
            # ::swap to the corrupt copy, whose probe row cannot be computed.
            t0 = time.perf_counter()

            def swap(t_start):
                time.sleep(2.0)
                return {"report": _swap(cli.address, export2)}

            steady = _replay(cli.address, "steady", lines, during=swap)
            _check_exactly_once("steady + swap", steady, backpressure_ok=False)
            rep = steady["side"].get("report")
            if not rep or not rep["ok"] or rep["swapped"] != ["r0", "r1"] or \
                    not all(r["probe"]["matched"] for r in rep["replicas"]):
                raise AssertionError(f"::swap failed: {rep}")
            after = _ask_lines(cli.address,
                               [f"::probs {p}" for p in probes[:8]])
            if after != want2:
                raise AssertionError("routed ::probs after the swap differ "
                                     "from the new export's in-process "
                                     "engine")
            t1 = time.perf_counter()
            bad_rep = _swap(cli.address, bad)
            if bad_rep["ok"] or bad_rep.get("rolled_back") or not str(
                    bad_rep.get("error")).startswith(
                        "swap-probe reference failed"):
                raise AssertionError(f"corrupt ::swap was not refused: "
                                     f"{bad_rep}")
            if _ask_lines(cli.address,
                          [f"::probs {p}" for p in probes[:8]]) != want2:
                raise AssertionError("replies changed after the refused "
                                     "corrupt ::swap")
            out["swap"] = {"requests": {k: steady["requests"][k] for k in (
                               "sent", "answered", "errors", "dropped",
                               "double_answered")},
                           "phases": steady["phases"],
                           "wall_s": rep["wall_s"],
                           "per_replica_s": [r["seconds"]
                                             for r in rep["replicas"]],
                           "probe_bit_identical": True,
                           "after_equals_new_export": True,
                           "corrupt_refused": {
                               "error": bad_rep["error"].strip()
                               .splitlines()[-1][:200],
                               "replies_unchanged": True,
                               "seconds": round(time.perf_counter() - t1, 3)}}
            clock["swap_s"] = time.perf_counter() - t0

            # ---- 6a. the CLI router's ::metrics; the CLI stops on SIGINT.
            cli_metrics = _ask_lines(cli.address, ["::metrics"])[0]
            if "vit_fleet_route_requests_total" not in cli_metrics:
                raise AssertionError("the fleet CLI's ::metrics lacks the "
                                     "fleet instruments")
            out["metrics_samples"] = {
                "router_cli": _prometheus_ok(cli_metrics)}
        finally:
            rc = cli.stop()
        if rc != 0:
            raise AssertionError(f"fleet CLI exited {rc}: "
                                 f"{''.join(cli.err[-20:])}")

        # ---- the cold build directory: each library built once, whichever
        # replica built it.
        builds = [json.loads(x) for x in
                  (cold / _build.BUILDS_JSONL).read_text().splitlines()]
        per_lib = {}
        for b in builds:
            per_lib[b["name"]] = per_lib.get(b["name"], 0) + 1
        if any(n != 1 for n in per_lib.values()) or not \
                {"fused_mlp", "flash_attention"} <= set(per_lib):
            raise AssertionError(f"cold build directory: {builds} (each "
                                 "library once wanted)")
        out["cold_builds"] = builds

        # ---- 6b. the traced fleet: a traced pass over the pack
        # (FLEET_TRACED_PROFILE), ::metrics
        # of a replica and of the router, then ::swap to the corrupt export
        # (no probe): it rolls back while the cascade runs.
        t0 = time.perf_counter()
        tracing.configure_tracer(str(root / "trace_router.jsonl"),
                                 role="router",
                                 sample_rate=FLEET_TRACE_SAMPLE,
                                 seed=FLEET_TRACE_SEED)
        try:
            traced_pass = _replay(t_addr, FLEET_TRACED_PROFILE, lines)
        finally:
            tracing.get_tracer().close()
            tracing.configure_tracer(None)
        _check_exactly_once("traced pass", traced_pass,
                            backpressure_ok=False)
        out["traced_pass"] = {"scheduled": traced_pass["scheduled"],
                              "phases": traced_pass["phases"]}
        rep_metrics = _ask_lines(traced.manager.address_of("r0"),
                                 ["::metrics"])[0]
        rout_metrics = _ask_lines(t_addr, ["::metrics"])[0]
        out["metrics_samples"].update(replica=_prometheus_ok(rep_metrics),
                                      router=_prometheus_ok(rout_metrics))
        if "vit_serve_queue_depth" not in rep_metrics:
            raise AssertionError("a replica's ::metrics lacks the serve "
                                 "instruments")
        started = json.loads(_ask_lines(t_addr, [f"::swap {bad}"])[0])
        if started.get("swap") != "started":
            raise AssertionError(f"::swap {bad}: {started}")
        t_bad = time.perf_counter()
        clock["traced_s"] = time.perf_counter() - t0

        # ---- 5. the cascade through the fleet CLI: a Ti/16 student and a
        # B/16 teacher replica, at thresholds 0 and infinity (booting while
        # the in-process engines answer the probes), then at the median
        # student margin.
        t0 = time.perf_counter()

        def cascade_cli(name, threshold):
            cfg = root / f"cascade_{name}.json"
            cfg.write_text(json.dumps({"threshold": threshold}))
            return _FleetCLI(
                ["--checkpoint", d["student"], "--preset", STUDENT,
                 "--classes-file", d["classes_file"], "--replicas", "1",
                 "--devices", "1", "--port", "0", "--buckets",
                 ",".join(map(str, FLEET_BUCKETS)), "--cascade", cfg,
                 "--cascade-teacher", export, "--cascade-teacher-preset",
                 PRESET, *ship, "--worker-id", f"router-cascade-{name}"])

        cascade_clis["zero"] = cascade_cli("zero", 0.0)
        cascade_clis["inf"] = cascade_cli("inf", math.inf)
        s_eng = _in_process(d["student"], STUDENT, classes, dev)
        t_eng = _in_process(export, PRESET, classes, dev)
        try:
            probs_lines = [f"::probs {p}" for p in probes]
            s_want = _lone(s_eng, probs_lines)
            t_want = _lone(t_eng, probs_lines)
        finally:
            s_eng.close()
            t_eng.close()
        margins = [softmax_margin(json.loads(r)["probs"]) for r in s_want]
        thr = float(np.median(margins))
        low = sum(m <= thr for m in margins)
        cascade_clis["median"] = cascade_cli("median", thr)
        expect = {"zero": (s_want, 0), "inf": (t_want, len(probes)),
                  "median": ([t_want[i] if margins[i] <= thr else s_want[i]
                              for i in range(len(probes))], low)}
        boot = {name: c.wait_warm() for name, c in cascade_clis.items()}

        def run(name):
            c = cascade_clis[name]
            got = _ask_lines(c.address, probs_lines)
            return got, _stats(c.address)["cascade"]

        with ThreadPoolExecutor(3) as pool:
            got = dict(zip(expect, pool.map(run, expect)))
        cascade = {}
        for name, (want_rows, want_esc) in expect.items():
            rows, stats = got[name]
            if rows != want_rows or stats["escalated"] != want_esc:
                raise AssertionError(
                    f"cascade at {name}: {stats['escalated']} escalated, "
                    f"{want_esc} wanted; replies equal to the tiers' "
                    f"in-process engines: {rows == want_rows}")
            cascade[name] = {"escalated": stats["escalated"],
                             "served_student": stats["served_student"]}
        _prometheus_ok(_ask_lines(cascade_clis["median"].address,
                                  ["::metrics"])[0])
        rcs = {name: c.stop() for name, c in cascade_clis.items()}
        cascade_clis = {}
        if any(rcs.values()):
            raise AssertionError(f"cascade fleet CLIs exited {rcs}")
        out["cascade"] = {"student": STUDENT, "teacher": PRESET,
                          "probes": len(probes), "thresholds": cascade,
                          "median_margin": thr, "boot_s": boot,
                          "escalation_share_median": low / len(probes)}
        clock["cascade_s"] = time.perf_counter() - t0

        # ---- the corrupt swap on the traced fleet rolled back, and its
        # replies are the old export's.
        bad_rep = _swap_report(t_addr, bad, FLEET_SWAP_TIMEOUT_S)
        if bad_rep["ok"] or not bad_rep["rolled_back"]:
            raise AssertionError(f"corrupt ::swap did not roll back: "
                                 f"{bad_rep}")
        _warm(t_addr, 120.0)
        if _ask_lines(t_addr, probs_lines[:8]) != t_want[:8]:
            raise AssertionError("replies changed after the rolled-back "
                                 "corrupt ::swap")
        out["rollback"] = {"wall_s": bad_rep["wall_s"],
                           "restores_healthy": [
                               r["healthy"] for r in bad_rep["restores"]],
                           "error": bad_rep["error"],
                           "replies_unchanged": True,
                           "seconds": round(time.perf_counter() - t_bad, 3)}
    finally:
        for c in cascade_clis.values():
            c.stop()
        if traced is not None:
            traced.router.close()
            traced.manager.close()

    # ---- 6c. the sinks: frames from every process, the merged trace.
    time.sleep(1.5)
    frames = list(sink.frames)
    sink.stop()
    roles = {}
    for f in frames:
        roles.setdefault(f["role"], set()).add(f["worker_id"])
    # The traced fleet's replicas (each restart is a new process) and the
    # four fleet CLIs' routers.
    routers = {"router-cli"} | {f"router-cascade-{n}"
                                for n in ("zero", "inf", "median")}
    if len(roles.get("serve", ())) < 2 or not routers <= roles.get(
            "router", set()):
        raise AssertionError(f"frames by role: {roles}")
    spans = []
    for path in root.glob("trace_*.jsonl"):
        spans += tracing.read_trace_sink(str(path))
    trace = merged_chrome_trace(spans)
    n_events = validate_chrome_trace(trace)
    by_id = {s["span_id"]: s for s in spans}
    chained = sum(1 for s in spans if s["name"] == "serve.request"
                  and s["parent_id"] in by_id
                  and by_id[s["parent_id"]]["role"] == "router"
                  and by_id[s["parent_id"]]["trace_id"] == s["trace_id"])
    if not chained:
        raise AssertionError("no serve.request span under a router span")
    (root / "fleet_trace.json").write_text(json.dumps(trace))
    out["sinks"] = {"frames": len(frames),
                    "workers_by_role": {k: len(v) for k, v in roles.items()},
                    "spans": len(spans), "trace_events": n_events,
                    "serve_spans_under_router_spans": chained,
                    "span_names": sorted({s["name"] for s in spans})}
    emit({"phase": "fleet", "ok": True, **out, "clock_s": clock,
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return out["direct_equality"]["in_process_launches"]


# ------------------------------------------------------------- phase 6
# How each kernel multiplies on the card, bf16 (f32 runs SIMT everywhere).
KERNEL_DESIGN = {
    "fused_ln_mlp_residual": "wgmma+tma",
    "fused_ln_mlp_residual_bwd": "wgmma+tma",
    "flash_attention": "wgmma+tma",
    "flash_attention_bwd_dq": "wgmma+tma, two consumer warpgroups",
    "flash_attention_bwd_dkv": "wgmma+tma, two consumer warpgroups",
    "fused_mlp_core": "wgmma+tma", "fused_mlp_core_bwd": "wgmma+tma"}


def kernel_list(k_rows, launches, serve_launches, ops, cli_launches,
                packed_launches, transfer, distill_step, search, fleet,
                mesh, par):
    """The seven ported kernels with their main-path numbers: rows 1-5 at
    batch 32, bf16, dropout off, T = 197; rows 6 and 7 (the MLP core) at
    a tensor-parallel microbatch's shape (4 * 197 rows, F / tp = 1536,
    bf16, t = 26). ``launches`` are the counts of the main training run
    (``auto``, which runs flash at T = 197 on the card; rows 6 and 7:
    rank 0's in the train_mesh phase's tp 2 x pp 2 CLI run (b)),
    ``serve_launches`` the serve phase's, ``ops`` the ops phase's result:
    each entry's
    ``checked`` lists the mask forms, Tq != Tk cases, head dims and widths
    its kernel was held to its plain version at in this run,
    ``ops_launches`` its launches on the ops phase's path and
    ``train_cli_launches`` on the train_cli phase's (run B through
    ``train.main``), ``train_packed_launches`` on the train_packed phase's
    (P2 through ``train.main``), ``transfer_launches`` on the transfer
    phase's (the frozen 224 px CLI run), ``distill_launches`` in one step
    of the distilled ViT-Ti/16 student, ``search_launches`` in one
    ``::search`` (its features embed and the scan), ``fleet_launches`` in
    the fleet phase's in-process engine whose replies the routed ones
    equal bit for bit (four lone requests: two ``::probs``, a features
    row and a ``::search``), ``train_mesh_launches`` rank 0's in the
    train_mesh phase's runs (a), (b) and (c), ``sp_launches`` a rank's on
    the sequence-parallel paths (parallel phase (c)'s ring and Ulysses
    steps, train_mesh (c)'s ring CLI run), and rows 1-5 carry
    ``t577``, their readings at the 384 px step's shapes (T = 577, N =
    18,464 MLP rows). The eighth entry, ``scan_scores``, is the exact
    scan's scores kernel (no Pallas kernel in the JAX package: XLA's dot
    there), at its main path's shape (64 queries by one row block of the
    2M-row index); its ``launches`` are the search phase's 1,024-query
    scans at k = 10 and 100.
    ``ms``, ``plain_ms`` and ``library_ms``
    are event times on every row, ``device_ms`` and ``library_device_ms``
    device times (calls queued behind a spin kernel). The two clocks part
    most for the flash backward's library call: its event time includes
    the host's ``torch.autograd.grad`` call, which the card waits on."""
    def pick(kernel, **match):
        return next(r for r in k_rows if r.get("kernel") == kernel and all(
            r[k] == v for k, v in match.items()))

    def max_err(kernel, key=None):
        vals = []
        for r in k_rows:
            if r.get("kernel") == kernel and r["dtype"] == "bfloat16":
                e = r["max_abs_err"]
                vals.append(e[key] if key else
                            (max(e.values()) if isinstance(e, dict) else e))
        return max(vals)

    base = f"{PKG}/csrc"
    ref = "pytorch_vit_paper_replication_tpu/ops"
    mlp = pick("fused_ln_mlp_residual", dtype="bfloat16", threshold=0)
    mlp_b = pick("fused_ln_mlp_residual_bwd", dtype="bfloat16", threshold=0)
    fl = pick("flash_attention", dtype="bfloat16", threshold=0,
              shape=[32, 197, 12, 64])
    fl_b = pick("flash_attention_bwd", dtype="bfloat16", threshold=0,
                shape=[32, 197, 12, 64])
    # (name, source, replaces, max |err|, row with the main path's numbers,
    # its keys for kernel / plain / device ms, bound and bound_by, the
    # library call's event and device ms, and the GEMM yardstick's where
    # there is one).
    none = (None, None)
    rows = [
        ("fused_ln_mlp_residual", "fused_mlp.cu", "fused_mlp.py:461",
         max_err("fused_ln_mlp_residual"), mlp,
         ("kernel_ms", "plain_ms", "device_ms", "bound_ms", "bound_by"),
         none, (mlp["gemms_library_ms"], mlp["gemms_library_device_ms"])),
        ("fused_ln_mlp_residual_bwd", "fused_mlp_bwd.cu", "fused_mlp.py:501",
         max_err("fused_ln_mlp_residual_bwd"), mlp_b,
         ("kernel_ms", "plain_ms", "device_ms", "bound_ms", "bound_by"),
         none, (mlp_b["gemms_library_ms"],
                mlp_b["gemms_library_device_ms"])),
        ("flash_attention", "flash_attention.cu", "flash_attention.py:295",
         max_err("flash_attention"), fl,
         ("kernel_ms", "plain_ms", "kernel_device_ms", "bound_ms",
          "bound_by"), (fl["library_ms"], fl["library_device_ms"]), none),
        # plain_ms and library_ms of the two backward kernels are one call
        # each computing dq, dk and dv together.
        ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
         "flash_attention.py:485", max_err("flash_attention_bwd", "dq"),
         fl_b, ("dq_ms", "plain_ms", "dq_device_ms", "dq_bound_ms",
                "dq_bound_by"),
         (fl_b["library_ms"], fl_b["library_device_ms"]), none),
        ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
         "flash_attention.py:503",
         max(max_err("flash_attention_bwd", "dk"),
             max_err("flash_attention_bwd", "dv")), fl_b,
         ("dkv_ms", "plain_ms", "dkv_device_ms", "dkv_bound_ms",
          "dkv_bound_by"),
         (fl_b["library_ms"], fl_b["library_device_ms"]), none),
    ]
    n, f, dt, t = CORE_MAIN_PATH
    core = pick("fused_mlp_core", shape=[n, 768, f], dtype=dt, threshold=t)
    core_rows = [r for r in k_rows if r.get("kernel") == "fused_mlp_core"
                 and r["dtype"] == "bfloat16"]
    rows += [
        ("fused_mlp_core", "fused_mlp_core.cu", "fused_mlp.py:236",
         max(r["max_abs_err"] for r in core_rows), core,
         ("kernel_ms", "plain_ms", "device_ms", "bound_ms", "bound_by"),
         none, (core["gemms_library_ms"], core["gemms_library_device_ms"])),
        ("fused_mlp_core_bwd", "fused_mlp_core.cu", "fused_mlp.py:278",
         max(r["bwd_max_abs_err"] for r in core_rows), core,
         ("bwd_ms", "bwd_plain_ms", "bwd_device_ms", "bwd_bound_ms",
          "bwd_bound_by"), none,
         (core["bwd_gemms_library_ms"], core["bwd_gemms_library_device_ms"])),
    ]
    launches = {**launches, "fused_mlp_core": mesh["b"]["fused_mlp_core"],
                "fused_mlp_core_bwd": mesh["b"]["fused_mlp_core_bwd"]}
    flash_checked = {
        "mask_forms": sorted({r["mask"] for r in ops["flash"]
                              if r["mask"]}),
        "q_kv_lens": sorted({(r["q_len"], r["kv_len"]) for r in ops["flash"]
                             if r["q_len"] != r["kv_len"]}),
        "head_dims": sorted({r["dh"] for r in ops["flash"]}
                            | {c[3] for c in FLASH_CASES}),
        "dtypes": sorted({r["dtype"] for r in ops["flash"]})}
    mlp_checked = {"widths": [[w, 4 * w] for w in PRESET_WIDTHS]
                   + [[r["d"], r["f"]] for r in ops["mlp"]
                      if r["dtype"] == "bfloat16"],
                   "dtypes": ["bfloat16", "float32"]}
    out = []
    for name, src, rep, err, row, keys, lib, gemms in rows:
        ms, plain, dev_ms, b_ms, b_by = (row[k] if k else None for k in keys)
        entry = {"name": name, "route": "cuda", "source": f"{base}/{src}",
                 "replaces": f"{ref}/{rep}", "status": "ported and checked",
                 "design": KERNEL_DESIGN[name], "launches": launches[name],
                 "serve_launches": serve_launches.get(name, 0),
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b_ms, "bound_by": b_by,
                 "bound_share": b_ms / ms, "library_ms": lib[0],
                 "device_ms": dev_ms, "library_device_ms": lib[1],
                 "ops_launches": ops["path"][name],
                 "train_cli_launches": cli_launches[name],
                 "train_packed_launches": packed_launches[name],
                 "transfer_launches": transfer["launches"][name],
                 "checked": (flash_checked if name.startswith("flash")
                             else mlp_checked)}
        if gemms[0] is not None:
            entry["gemms_library_ms"], entry["gemms_library_device_ms"] = gemms
        if name in transfer["t577"]:
            entry["t577"] = transfer["t577"][name]
        entry["distill_launches"] = distill_step[name]
        entry["search_launches"] = search["search_launches"][name]
        entry["fleet_launches"] = fleet[name]
        entry["train_mesh_launches"] = {run: mesh[run][name]
                                        for run in ("a", "b", "c")}
        entry["sp_launches"] = {"parallel_c_ring": par["ring"][name],
                                "parallel_c_ulysses": par["ulysses"][name],
                                "train_mesh_c_ring": mesh["c"][name]}
        out.append(entry)
    sk = search["kernel"]
    out.append({
        "name": "scan_scores", "route": "cuda",
        "source": f"{base}/scan_scores.cu",
        "replaces": "pytorch_vit_paper_replication_tpu/search/scan.py:178",
        "status": "new: the exact scan's scores, row bits independent of "
                  "the query count", "design": "SIMT fmaf, k in order",
        "launches": sk["launches"], "serve_launches": 0,
        "max_abs_err": sk["max_abs_err"], "ms": sk["ms"],
        "plain_ms": sk["plain_ms"], "bound_ms": sk["bound_ms"],
        "bound_by": sk["bound_by"], "bound_share": sk["bound_share"],
        "library_ms": sk["library_ms"], "device_ms": sk["device_ms"],
        "library_device_ms": sk["library_device_ms"], "shape": sk["shape"],
        "distill_launches": 0,
        "search_launches": search["search_launches"]["scan_scores"],
        "fleet_launches": fleet["scan_scores"],
        "train_mesh_launches": {"a": 0, "b": 0, "c": 0},
        "sp_launches": {"parallel_c_ring": 0, "parallel_c_ulysses": 0,
                        "train_mesh_c_ring": 0}})
    return {"kernels": out, "to_port": []}


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
    walls, t_mark = {}, [t_start]

    def mark(phase: str) -> None:
        """The wall of ``phase``: the seconds since the last mark."""
        now = time.perf_counter()
        walls[phase] = round(now - t_mark[0], 3)
        t_mark[0] = now
    phase_build(card)
    mark("build")
    gen = torch.Generator().manual_seed(0)
    card_peaks = peaks(name)
    k_rows = check_fused_mlp(gen, card_peaks, dev) + \
        check_flash(gen, card_peaks, dev) + \
        check_fused_mlp_bwd(gen, card_peaks, dev) + \
        check_flash_bwd(gen, card_peaks, dev) + \
        check_fused_mlp_core(gen, card_peaks, dev)
    check_mlp_widths(gen, dev)
    mark("kernels")
    torch.cuda.empty_cache()
    ops = phase_ops(gen, card_peaks, dev)
    mark("ops")
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        export, paths, serve_launches = phase_serve(root, dev)
        phase_cli(export, paths)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("serve")
    torch.cuda.empty_cache()
    launches = phase_train(dev)
    mark("train")
    torch.cuda.empty_cache()
    phase_presets(dev)
    mark("presets")
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        cli_launches = phase_train_cli(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("train_cli")
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_packed_"))
    try:
        packed_launches = phase_train_packed(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("train_packed")
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_transfer_"))
    try:
        transfer = phase_transfer(dev, root, gen, card_peaks, k_rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("transfer")
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_distill_"))
    try:
        distill = phase_distill(dev, root)
        mark("distill")
        torch.cuda.empty_cache()
        search = phase_search(dev, root, distill, card_peaks)
        mark("search")
        torch.cuda.empty_cache()
        fleet = phase_fleet(dev, root, distill, search)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("fleet")
    torch.cuda.empty_cache()
    par = phase_parallel(dev)
    mark("parallel")
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        mesh_launches = phase_train_mesh(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("train_mesh")
    emit({"phase": "walls", "seconds": walls})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            3)})
    print(card, flush=True)
    print(json.dumps(kernel_list(k_rows, launches, serve_launches,
                                 ops, cli_launches,
                                 packed_launches, transfer,
                                 distill["launches_per_step"], search,
                                 fleet, mesh_launches, par)),
          flush=True)
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
