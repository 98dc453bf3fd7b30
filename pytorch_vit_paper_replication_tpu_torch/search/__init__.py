"""Embedding search: a memory-mapped index and a device-sharded top-k scan
(port of the JAX package's ``search/``).

* :mod:`.index` — the on-disk contract: an ``index.json`` manifest (rows,
  dim, dtype, fingerprint and source sha256 pinned, atomic writes) over
  the batch job's ``outputs.npy`` embedding matrix, memory-mapped, never
  copied into the Python heap;
* :mod:`.scan` — the hot path: an exact top-k scan with the rows sharded
  over the devices, each shard's top-k kept on its device, a merge on the
  first, and one host fetch of the final ``[Q, K]`` ids and scores per
  query chunk;
* :mod:`.ivf` — IVF coarse quantization (k-means centroids + inverted
  lists) for corpora where even the sharded scan is too slow, probing
  ``nprobe`` lists per query with a recall-vs-exact gate.

Built offline by ``python -m pytorch_vit_paper_replication_tpu_torch.
tools.build_index`` (resumable); served online by ``::search K <path>`` on
the serve CLI (the features head embeds the query, the scan answers it).
"""

from .index import (EmbeddingIndex, INDEX_MANIFEST, load_index_manifest,
                    validate_index_manifest, write_index_manifest)
from .ivf import build_ivf, ivf_search, kmeans, recall_at_k
from .scan import (DEFAULT_QUERY_BUCKETS, ShardedScanner, reference_topk,
                   shard_rows)

__all__ = [
    "EmbeddingIndex",
    "INDEX_MANIFEST",
    "load_index_manifest",
    "validate_index_manifest",
    "write_index_manifest",
    "ShardedScanner",
    "DEFAULT_QUERY_BUCKETS",
    "reference_topk",
    "shard_rows",
    "kmeans",
    "build_ivf",
    "ivf_search",
    "recall_at_k",
]
