"""Harness-facing distillation helpers (NumPy and the standard library).

Between "the teacher's logits are sealed" and "the student is training" a
pipeline needs two things: pseudo-labels whose hard-CE term pulls toward
the teacher, and the ``train`` argv that consumes the sink. Both live
here so a harness, the docs and the tests name the same ones.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..serve.offline import SINK_NAME, load_progress
from ..utils.atomic import atomic_write_text


def pseudo_label_pack(pack_dir, teacher_sink) -> bool:
    """Relabel a packed dataset with the teacher's argmax.

    A synthetic pack's labels are independent noise, and a hard-CE term
    trained on them fights the soft-target term. Real distillation sets
    have labels that agree with their teacher; this reproduces that:
    ``index.json``'s labels become ``argmax(teacher_logits)`` (pixels
    untouched, so the sealed dump stays valid), idempotent through the
    ``teacher_labeled`` flag. The file is byte-identical to the JAX
    package's. Returns True when it relabeled, False when already done."""
    pack_dir = Path(pack_dir)
    index_path = pack_dir / "index.json"
    index = json.loads(index_path.read_text())
    if index.get("teacher_labeled"):
        return False
    teacher_sink = Path(teacher_sink)
    manifest = load_progress(teacher_sink)
    if manifest is None or manifest.get("sink_sha256") is None:
        raise SystemExit(
            f"pseudo_label_pack: {teacher_sink} is not a sealed "
            "batch_infer sink — finish the --head logits dump first")
    if manifest.get("head") != "logits":
        raise SystemExit(
            f"pseudo_label_pack: sink head is "
            f"{manifest.get('head')!r}; pseudo-labels need the "
            "teacher's logits (argmax is only the teacher's answer on "
            "pre-softmax rows dumped over THIS pack)")
    rows = np.load(teacher_sink / str(manifest.get("sink", SINK_NAME)),
                   mmap_mode="r")
    if len(index["labels"]) != rows.shape[0]:
        raise SystemExit(
            f"pseudo_label_pack: pack has {len(index['labels'])} "
            f"records, sink {rows.shape[0]} rows — dump the teacher "
            "over THIS pack")
    index["labels"] = np.asarray(rows).argmax(axis=1).tolist()
    index["teacher_labeled"] = True
    atomic_write_text(index_path, json.dumps(index) + "\n")
    return True


def student_train_argv(pack_dir, teacher_sink, student_dir, *,
                       preset: str = "ViT-Ti/16",
                       image_size: int = 32,
                       epochs: int = 24, batch_size: int = 32,
                       t: float = 2.0, alpha: float = 0.7,
                       seed: int = 0,
                       python: Optional[str] = None) -> List[str]:
    """The ``train --distill-from`` command of the pipeline: the JAX
    package's flags, run by the port's train CLI. ``alpha`` is the
    soft-target weight (1.0 = pure teacher mimicry), ``t`` the softmax
    temperature."""
    return [python or sys.executable, "-m",
            "pytorch_vit_paper_replication_tpu_torch.train",
            "--dataset", "packed",
            "--train-dir", str(pack_dir),
            "--test-dir", str(pack_dir),
            "--preset", str(preset),
            "--image-size", str(int(image_size)),
            "--dtype", "float32", "--no-normalize", "--no-augment",
            "--epochs", str(int(epochs)),
            "--batch-size", str(int(batch_size)),
            "--seed", str(int(seed)),
            "--distill-from", str(teacher_sink),
            "--distill-t", repr(float(t)),
            "--distill-alpha", repr(float(alpha)),
            "--checkpoint-dir", str(student_dir)]
