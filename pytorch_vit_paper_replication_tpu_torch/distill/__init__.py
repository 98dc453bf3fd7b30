"""Knowledge distillation: the teacher -> student data path (port of the
JAX package's ``distill/``).

1. **Dump** — ``python -m pytorch_vit_paper_replication_tpu_torch.tools.
   batch_infer --head logits`` sweeps the teacher over the training pack
   and seals a ``[N, C]`` float32 sink of pre-softmax rows.
2. **Load** — :func:`load_distill_sink` memory-maps a completed sink and
   refuses every way it can disagree with the train split. Rows pair
   with records by dataset ordinal: the loader's ``emit_indices`` seam
   tags each batch with its records' ordinals, so shuffling and a
   mid-epoch resume keep the pairing.
3. **Train** — ``train --distill-from DIR --distill-alpha A --distill-t
   T`` gathers each batch's teacher rows and optimizes
   :func:`..engine.distill_loss` (``alpha = 0`` is ordinary training bit
   for bit).

:mod:`.recipe` holds the harness helpers: pseudo-labelling a pack with
the teacher's argmax and the student's train argv. NumPy and the
standard library only.
"""

from .sink import load_distill_sink

__all__ = ["load_distill_sink"]
