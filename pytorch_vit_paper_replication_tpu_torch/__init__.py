"""PyTorch/CUDA port of the ViT framework (serving path).

A second package beside the JAX reference ``pytorch_vit_paper_replication_tpu``.
It imports ``torch`` and never ``jax`` or the JAX package; the Pallas kernels
of the reference become hand-written CUDA kernels for Hopper (``csrc/``),
built with ``nvcc`` at first use. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
