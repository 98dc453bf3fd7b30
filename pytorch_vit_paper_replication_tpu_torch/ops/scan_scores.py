"""The exact scan's scores as a hand-written CUDA kernel.

``scan_scores(q, db)`` is ``q @ db.T`` in float32 (``[M, K] x [N, K] ->
[M, N]``), the counterpart of the JAX package's scan program's ``(q @
db.T).astype(f32)``, with one more promise: a row's scores are the same
bits whatever ``M`` is, so a query scanned alone and the same query in a
padded batch rank the index identically (ties included). On a CUDA tensor
it launches ``csrc/scan_scores.cu``, where every element is one float32
accumulator taking ``fmaf`` over ``k = 0 .. K-1`` in order (no TF32,
whatever ``torch.backends.cuda.matmul.allow_tf32`` says); on a CPU tensor
it runs :func:`scan_scores_plain`, which multiplies in groups of
``PLAIN_GROUP`` query rows (the last zero-padded), so every row meets a
product of one shape: a lone row would otherwise take the BLAS
matrix-vector path and sum in another order. The two sum in different
orders, so they agree within float32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel (one per wrapper call on a CUDA tensor).
launches = 0
_FN = None
# Query rows per product of the plain version.
PLAIN_GROUP = 8


def scan_scores_plain(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """``[M, N]`` float32 scores, ``q @ db.T`` in products of
    ``PLAIN_GROUP`` query rows each."""
    m = q.shape[0]
    groups = -(-m // PLAIN_GROUP)
    padded = q.new_zeros((groups * PLAIN_GROUP, q.shape[1]))
    padded[:m] = q
    out = torch.cat([g @ db.T for g in padded.split(PLAIN_GROUP)])
    return out[:m]


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("scan_scores").vit_scan_scores
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    global launches
    if q.dtype != torch.float32 or db.dtype != torch.float32:
        raise ValueError(f"scan_scores takes float32, got {q.dtype} and "
                         f"{db.dtype}")
    if q.ndim != 2 or db.ndim != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"scan_scores: q {tuple(q.shape)} and db "
                         f"{tuple(db.shape)} are not [M, K] and [N, K]")
    if q.device != db.device:
        raise ValueError("scan_scores: q and db on different devices")
    if not (q.is_contiguous() and db.is_contiguous()):
        raise ValueError("scan_scores takes contiguous rows")
    m, k = q.shape
    n = db.shape[0]
    if m * n >= 2 ** 63 or n >= 2 ** 31:
        raise ValueError(f"scan_scores: {m} x {n} scores is too many")
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), db.data_ptr(), out.data_ptr(), m, n, k,
                        stream)
    _build.check(err, "vit_scan_scores")
    launches += 1
    return out


def scan_scores(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Scores of every query row against every database row (see the
    module docstring): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if q.is_cuda:
        return _launch(q, db)
    return scan_scores_plain(q, db)
