"""The teacher-logit sink loader: distillation's trust boundary.

``train --distill-from`` points at a ``tools.batch_infer --head logits``
output directory and pairs teacher rows with train records by dataset
ordinal. Every way the sink can disagree with the run's train split
(another pack, another label space, an unfinished or torn dump) is
refused before the first step, with the JAX package's messages.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..serve.offline import (PROGRESS_MANIFEST, SINK_NAME, load_progress,
                             sink_sha256)


def load_distill_sink(sink_dir, *, n_records: int, n_classes: int):
    """Open a completed ``--head logits`` sink for distillation.

    Returns ``(rows, manifest)``: the ``[N, C]`` float32 teacher logits
    memory-mapped read-only (a run holds one batch of them in RAM at a
    time) and the sink's progress manifest. Raises SystemExit on a sink
    with no manifest, another head, an unfinished dump, a record or class
    count other than the split's, no completion digest, a missing file, a
    digest mismatch or a wrong shape."""
    sink_dir = Path(sink_dir)
    manifest = load_progress(sink_dir)
    if manifest is None:
        raise SystemExit(
            f"--distill-from: no {PROGRESS_MANIFEST} under {sink_dir} "
            "— point at a tools.batch_infer --head logits output dir")
    head = manifest.get("head")
    if head != "logits":
        raise SystemExit(
            f"--distill-from: sink head is {head!r}, distillation "
            "needs pre-softmax rows — re-run tools.batch_infer "
            "with --head logits")
    total = int(manifest.get("total_records", -1))
    done = int(manifest.get("records_done", -1))
    if done != total:
        raise SystemExit(
            f"--distill-from: sink is incomplete ({done}/{total} "
            "records) — re-run the batch_infer job to finish it (it "
            "resumes from its own manifest)")
    if total != int(n_records):
        raise SystemExit(
            f"--distill-from: sink was dumped over {total} records "
            f"but this run's train split has {n_records} — the ordinal "
            "alignment would be meaningless; dump the teacher over "
            "THIS split (wrong pack?)")
    out_dim = int(manifest.get("out_dim", -1))
    if out_dim != int(n_classes):
        raise SystemExit(
            f"--distill-from: sink rows have {out_dim} classes, this "
            f"run trains a {n_classes}-class head — teacher and student "
            "must share one label space")
    want_sha = manifest.get("sink_sha256")
    if not want_sha:
        raise SystemExit(
            "--distill-from: manifest has no sink_sha256 (the "
            "completion seal) — the dump never finished cleanly; "
            "re-run the batch_infer job")
    path = sink_dir / str(manifest.get("sink", SINK_NAME))
    if not path.is_file():
        raise SystemExit(f"--distill-from: sink file {path} is missing")
    got_sha = sink_sha256(path)
    if got_sha != want_sha:
        raise SystemExit(
            f"--distill-from: sink sha256 mismatch (manifest "
            f"{want_sha[:12]}…, file {got_sha[:12]}…) — the sink was "
            "truncated or modified after the dump sealed it; re-run "
            "tools.batch_infer --head logits --fresh")
    rows = np.load(path, mmap_mode="r")
    if rows.shape != (total, out_dim):
        raise SystemExit(
            f"--distill-from: sink shape {rows.shape} != "
            f"({total}, {out_dim}) — delete the dir and re-dump")
    return rows, manifest
