"""The port's embedding search on the CPU against the JAX package.

* The scan (:class:`ShardedScanner` on CPU devices, whose scores are the
  plain version's products in groups of 8 query rows) against JAX's
  ``ShardedScanner`` on the test mesh's 8 CPU devices and NumPy
  ``reference_topk``, on JAX's own test corpora: ids equal and scores bit
  for bit (the torch CPU product equals NumPy's at these widths), but on
  the 5-row corpus split one row a shard, where they are within 2 ulp
  (JAX's test checks only the ids there). The
  padded tail, ties across a shard boundary, the tiny corpus and k
  validation as JAX pins them.
* The index manifest, ``EmbeddingIndex`` and the port's
  ``tools.build_index`` against the repo's ``tools/build_index.py``: the
  index directory byte for byte, with and without IVF, and after a build
  stopped at a durable boundary and resumed. ``kmeans``, ``build_ivf`` and
  ``ivf_search`` arrays equal JAX's.
* Online: ``engine.search`` equals the offline features head at batch 1
  scanned at rung 1, bit for bit; the serve CLI's ``::search`` and ``::req
  k=`` replies are the line JAX's ``_search_reply`` formats.
"""

import hashlib
import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_vit_paper_replication_tpu.search import index as jindex
from pytorch_vit_paper_replication_tpu.search import ivf as jivf
from pytorch_vit_paper_replication_tpu.search.scan import (
    ShardedScanner as JScanner)
from pytorch_vit_paper_replication_tpu.serve import __main__ as jserve
from pytorch_vit_paper_replication_tpu_torch.search import (
    EmbeddingIndex, ShardedScanner, build_ivf, ivf_search, kmeans,
    load_index_manifest, recall_at_k, reference_topk, shard_rows,
    validate_index_manifest, write_index_manifest)
from pytorch_vit_paper_replication_tpu_torch.search import scan as tscan
from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
    NpySink, sink_sha256, write_progress)
from pytorch_vit_paper_replication_tpu_torch.telemetry.registry import (
    TelemetryRegistry)
from pytorch_vit_paper_replication_tpu_torch.tools import build_index

REPO = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _repo_build_index():
    spec = importlib.util.spec_from_file_location(
        "repo_build_index", REPO / "tools" / "build_index.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus(rows=3001, dim=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, dim)).astype(np.float32)


def _clustered(rows=4000, dim=16, clusters=20, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, rows)
    return centers[assign] + rng.standard_normal((rows, dim)).astype(
        np.float32)


def _fabricate_source(src: Path, mat: np.ndarray, *, with_sha=True):
    """A completed batch-job output dir (JAX's ``tests/test_search.py``
    fixture, written with the port's sink)."""
    src.mkdir(parents=True, exist_ok=True)
    rows, dim = mat.shape
    sink = NpySink(src / "outputs.npy", rows=rows, dim=dim)
    sink.write(0, mat)
    sink.close()
    payload = {"fingerprint": "fp-test", "head": "features",
               "total_records": rows, "out_dim": dim, "batch_size": rows,
               "ladder": [rows], "sink": "outputs.npy",
               "records_done": rows, "rows_written": rows,
               "preds_bytes": None}
    if with_sha:
        payload["sink_sha256"] = sink_sha256(src / "outputs.npy")
    write_progress(src, payload)
    return src


def _tie_db():
    base = _corpus(40, 8)
    return np.concatenate([base, base[:16]]), base[:3]


# JAX's scan corpora: (metric, db, queries, k).
CORPORA = {
    "ip": lambda: ("ip", _corpus(), _corpus(13, 24, seed=1), 10),
    "cosine": lambda: ("cosine", _corpus(997, 16), _corpus(5, 16, seed=2),
                       7),
    "ties": lambda: ("ip", *_tie_db(), 4),
    "tiny": lambda: ("ip", _corpus(5, 6), _corpus(5, 6), 5),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_scan_equals_jax_and_reference(devices, name):
    metric, db, q, k = CORPORA[name]()
    norms = np.linalg.norm(db, axis=1) if metric == "cosine" else None
    got = ShardedScanner(db, k_max=k, metric=metric, norms=norms,
                         devices=CPU8).scan(q, k)
    theirs = JScanner(db, k_max=k, metric=metric, norms=norms,
                      devices=devices).scan(q, k)
    ref = reference_topk(db, q, k, metric=metric, norms=norms)
    for want in (theirs, ref):
        np.testing.assert_array_equal(got[1], want[1])
        if name == "tiny":
            # One row a shard: torch's CPU product of 8 queries by one row
            # sums in another order than NumPy's (XLA's matches NumPy's);
            # measured: at most 2 ulp (4.77e-7 absolute, 2.03e-7 relative).
            np.testing.assert_array_max_ulp(got[0], want[0], maxulp=2)
        else:
            np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32


def test_shard_rows_equals_jax():
    from pytorch_vit_paper_replication_tpu.search.scan import (
        shard_rows as jshard_rows)
    for rows, nd in ((10, 8), (16, 4), (5, 8), (2_000_000, 1), (3001, 8)):
        assert shard_rows(rows, nd) == jshard_rows(rows, nd)
    with pytest.raises(ValueError):
        shard_rows(0, 4)


def test_four_shard_merge_breaks_ties_across_a_boundary_by_lowest_id():
    """Four CPU shards of 25 rows; rows 20-29 are copies of rows 60-69, so
    equal scores sit on both sides of the first boundary and in the third
    shard: the merge keeps the lowest ids, as the reference argsort."""
    db = _corpus(100, 8, seed=4)
    db[20:30] = db[60:70]
    db[90:95] = db[20:25]
    q = np.concatenate([db[[20, 24, 61]], _corpus(5, 8, seed=5)])
    scanner = ShardedScanner(db, k_max=12, devices=["cpu"] * 4)
    assert [s.offset for s in scanner._shards] == [0, 25, 50, 75]
    scores, ids = scanner.scan(q, 12)
    ref_s, ref_i = reference_topk(db, q, 12)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(scores, ref_s)
    assert ids[0][:3].tolist() == [20, 60, 90]


def test_topk_keys_order_by_score_then_lowest_id():
    s = torch.tensor([[1.0, -0.0, 0.0, -2.5, 1.0, float("-inf"), -2.5]])
    vals, ids = tscan.topk_lowest_id(s, 7)
    assert ids.tolist() == [[0, 4, 1, 2, 3, 6, 5]]
    assert vals[0, :2].tolist() == [1.0, 1.0]
    vals, ids = tscan.topk_lowest_id(s, 3, torch.tensor([[9, 8, 7, 6, 5,
                                                          4, 3]]))
    assert ids.tolist() == [[5, 9, 7]]


def test_padded_query_tail_equals_the_unpadded_loop():
    """Q = 5 rides the 8-rung (3 pad rows), Q = 13 splits 8 + 8: every
    row's result equals that query scanned alone, and no pad row appears
    (JAX's padded-tail test)."""
    db = _corpus(501, 12)
    scanner = ShardedScanner(db, k_max=6, devices=CPU8, query_buckets=(1, 8))
    for n in (5, 13):
        q = _corpus(n, 12, seed=n)
        scores, ids = scanner.scan(q, 6)
        assert scores.shape == (n, 6) and ids.shape == (n, 6)
        assert ids.min() >= 0 and ids.max() < db.shape[0]
        for j in range(n):
            s1, i1 = scanner.scan(q[j], 6)
            np.testing.assert_array_equal(s1[0], scores[j])
            np.testing.assert_array_equal(i1[0], ids[j])


def test_scan_blocks_within_the_score_budget(monkeypatch):
    """A shard scored in row blocks of 64 (the budget of 64 rows at the
    top rung) gives the one-block answer: 3 blocks a shard, the last
    short."""
    db = _corpus(300, 8, seed=6)
    q = _corpus(9, 8, seed=7)
    want = ShardedScanner(db, k_max=20, devices=["cpu", "cpu"]).scan(q, 20)
    monkeypatch.setattr(tscan, "SCORE_BUDGET_BYTES", 28 * 32 * 64)
    small = ShardedScanner(db, k_max=20, devices=["cpu", "cpu"])
    assert small._block == 64
    got = small.scan(q, 20)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_scan_k_and_shape_validation_and_instruments():
    reg = TelemetryRegistry()
    db = _corpus(64, 8)
    scanner = ShardedScanner(db, k_max=10, devices=CPU8, registry=reg)
    with pytest.raises(ValueError, match="outside"):
        scanner.scan(db[:2], 0)
    with pytest.raises(ValueError, match="outside"):
        scanner.scan(db[:2], 11)
    with pytest.raises(ValueError, match="dim"):
        scanner.scan(np.zeros((1, 9), np.float32), 5)
    with pytest.raises(ValueError, match="metric"):
        ShardedScanner(db, metric="l2", devices=CPU8)
    scanner.scan(db[:3], 5)
    snap = reg.snapshot()
    assert snap["counters"]["search_queries_total"] == 3
    assert snap["counters"]["search_scans_total"] >= 1
    assert snap["gauges"]["search_index_rows"] == 64
    assert snap["gauges"]["search_devices"] == 8
    assert snap["histograms"]["search_scan_s"]["count"] >= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedScanner(db)


# -------------------------------------------------------- index files
def test_index_manifest_roundtrip_and_refusals_equal_jax(tmp_path):
    payload = {"rows": 10, "dim": 4, "dtype": "float32",
               "source": "outputs.npy", "source_sha256": "x" * 64,
               "metric": "ip"}
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    write_index_manifest(tmp_path / "a", payload)
    jindex.write_index_manifest(tmp_path / "b", payload)
    assert (tmp_path / "a" / "index.json").read_bytes() == \
        (tmp_path / "b" / "index.json").read_bytes()
    assert validate_index_manifest(load_index_manifest(tmp_path / "a"))[
        "version"] == 1
    (tmp_path / "a" / "index.json").write_text("{not json")
    with pytest.raises(ValueError, match="rebuild"):
        load_index_manifest(tmp_path / "a")
    assert load_index_manifest(tmp_path / "nowhere") is None
    for bad, msg in (({"rows": 1}, "missing"),
                     ({**payload, "metric": "hamming"}, "metric"),
                     ({**payload, "rows": 0}, "invalid")):
        for fn in (validate_index_manifest, jindex.validate_index_manifest):
            with pytest.raises(ValueError, match=msg):
                fn(bad)


def _tree_digests(d: Path) -> dict:
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(Path(d).glob("*"))
            if f.name != "build_progress.json"}


@pytest.mark.parametrize("ivf", [None, 8], ids=["exact", "ivf"])
def test_build_index_byte_identical_to_repo_tool(tmp_path, ivf):
    mat = _clustered(1200, 12, 8, seed=5)
    src = _fabricate_source(tmp_path / "embed", mat)
    kwargs = dict(metric="cosine", ivf_lists=ivf, kmeans_iters=4,
                  chunk_rows=256, checkpoint_every_s=0.0)
    repo = _repo_build_index().run_build(src, tmp_path / "repo", **kwargs)
    mine = build_index.run_build(src, tmp_path / "port", **kwargs)
    assert _tree_digests(tmp_path / "port") == \
        _tree_digests(tmp_path / "repo")
    assert {k: v for k, v in mine.items() if k not in ("index", "wall_s")} \
        == {k: v for k, v in repo.items() if k not in ("index", "wall_s")}
    index = EmbeddingIndex(tmp_path / "port")
    assert index.describe()["rows"] == 1200 and index.nbytes() == mat.nbytes
    if ivf:
        order, starts = index.invlists()
        np.testing.assert_array_equal(
            order, jindex.EmbeddingIndex(tmp_path / "repo").invlists()[0])
        assert starts[-1] == 1200


@pytest.mark.parametrize("stop_after", [1, 4, 7])
def test_build_index_interrupted_resume_byte_identical(tmp_path,
                                                       stop_after):
    """A build stopped at a durable boundary (the hook stops exactly where
    a SIGKILL there would) and rerun leaves the unkilled index, byte for
    byte; the command line takes the same flags."""
    mat = _corpus(1200, 12, seed=5)
    src = _fabricate_source(tmp_path / "embed", mat)
    kwargs = dict(ivf_lists=8, kmeans_iters=4, chunk_rows=256,
                  checkpoint_every_s=0.0)
    build_index.run_build(src, tmp_path / "clean", **kwargs)
    with pytest.raises(build_index.BuildInterrupted):
        build_index.run_build(src, tmp_path / "killed",
                              stop_after_steps=stop_after, **kwargs)
    assert not (tmp_path / "killed" / "index.json").exists()
    build_index.main([str(src), "--out", str(tmp_path / "killed"),
                      "--ivf-lists", "8", "--kmeans-iters", "4",
                      "--chunk-rows", "256", "--checkpoint-every-s", "0"])
    assert _tree_digests(tmp_path / "clean") == \
        _tree_digests(tmp_path / "killed")


def test_build_index_refuses_what_the_repo_tool_refuses(tmp_path):
    repo = _repo_build_index()
    mat = _corpus(100, 8)
    inc = _fabricate_source(tmp_path / "incomplete", mat)
    m = json.loads((inc / "progress.json").read_text())
    m["records_done"] = 50
    (inc / "progress.json").write_text(json.dumps(m))
    legacy = _fabricate_source(tmp_path / "legacy", mat, with_sha=False)
    torn = _fabricate_source(tmp_path / "torn", mat)
    mm = np.load(torn / "outputs.npy", mmap_mode="r+")
    mm[0, 0] += 1.0
    mm.flush()
    del mm
    for src, msg in ((inc, "incomplete"), (legacy, "allow-unhashed"),
                     (torn, "digest mismatch"),
                     (tmp_path / "empty", "progress.json")):
        for fn in (repo.run_build, build_index.run_build):
            with pytest.raises(ValueError, match=msg):
                fn(src, tmp_path / f"out_{src.name}")
    assert build_index.run_build(legacy, tmp_path / "ok",
                                 allow_unhashed=True)[
        "verified_sha256"] is False
    good = _fabricate_source(tmp_path / "good", mat)
    build_index.run_build(good, tmp_path / "idx", metric="ip")
    with pytest.raises(ValueError, match="different build"):
        build_index.run_build(good, tmp_path / "idx", metric="cosine")
    build_index.run_build(good, tmp_path / "idx", metric="cosine",
                          fresh=True)
    assert EmbeddingIndex(tmp_path / "idx").metric == "cosine"
    # The sink replaced after the build: the open refuses.
    sink = NpySink(good / "outputs.npy", rows=60, dim=8)
    sink.write(0, mat[:60])
    sink.close()
    with pytest.raises(ValueError, match="rebuild"):
        EmbeddingIndex(tmp_path / "idx")


# ---------------------------------------------------------------- IVF
def test_kmeans_and_build_ivf_equal_jax():
    sample = _clustered(600, 8, 6)
    full = kmeans(sample, 6, iters=5, seed=3)
    np.testing.assert_array_equal(full, jivf.kmeans(sample, 6, iters=5,
                                                    seed=3))
    part = kmeans(sample, 6, iters=3, seed=3)
    np.testing.assert_array_equal(
        kmeans(sample, 6, iters=5, seed=3, centroids=part, start_iter=3),
        full)
    mat = _clustered(1500, 8, 10, seed=2)
    for mine, theirs in zip(build_ivf(mat, 10, sample_rows=1024, iters=6,
                                      seed=7),
                            jivf.build_ivf(mat, 10, sample_rows=1024,
                                           iters=6, seed=7)):
        np.testing.assert_array_equal(mine, theirs)


def test_ivf_search_equals_jax_and_meets_the_recall_gate(tmp_path):
    mat = _clustered()
    src = _fabricate_source(tmp_path / "embed", mat)
    build_index.run_build(src, tmp_path / "idx", ivf_lists=24,
                          kmeans_iters=6)
    index = EmbeddingIndex(tmp_path / "idx")
    jidx = jindex.EmbeddingIndex(tmp_path / "idx")
    rng = np.random.default_rng(9)
    q = mat[rng.choice(len(mat), 16, replace=False)] + \
        0.1 * rng.standard_normal((16, mat.shape[1])).astype(np.float32)
    _, exact_i = reference_topk(mat, q, 10)
    mine = ivf_search(index, q, 10, nprobe=8)
    theirs = jivf.ivf_search(jidx, q, 10, nprobe=8)
    np.testing.assert_array_equal(mine[0], theirs[0])
    np.testing.assert_array_equal(mine[1], theirs[1])
    assert recall_at_k(mine[1], exact_i) >= 0.95
    _, all_i = ivf_search(index, q, 10, nprobe=24)
    assert recall_at_k(all_i, exact_i) == 1.0
    exact_only = tmp_path / "exact"
    build_index.run_build(src, exact_only)
    with pytest.raises(ValueError, match="ivf-lists"):
        ivf_search(EmbeddingIndex(exact_only), q, 5)


# ----------------------------------------------------- online engine
@pytest.fixture(scope="module")
def search_world(tmp_path_factory):
    """A tiny f32 ViT-Ti/16 on the CPU, 24 images embedded through the
    port's offline features head, an index over them and an engine
    serving it (JAX's fixture, on the port)."""
    from pytorch_vit_paper_replication_tpu_torch import configs
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_state
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.serve.engine import (
        InferenceEngine)
    from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
        OfflineEngine)

    work = tmp_path_factory.mktemp("torch_search_world")
    model = ViT(configs.vit_ti16(num_classes=3, image_size=32,
                                 dtype="float32", attention_impl="xla"))
    model.load_state_dict(seeded_state(model, 0))
    images = np.random.default_rng(0).random((24, 32, 32, 3)).astype(
        np.float32)
    data = [(images[i], 0) for i in range(24)]
    offline = OfflineEngine(model, head="features", image_size=32,
                            buckets=(8,), devices=["cpu"])
    offline.run(data, work / "embed", batch_size=8, resume=False)
    build_index.run_build(work / "embed", work / "idx")
    engine = InferenceEngine(model, device="cpu", image_size=32,
                             buckets=(1, 8), class_names=["a", "b", "c"],
                             warmup=False, search_index=work / "idx",
                             search_k_max=10)
    yield {"engine": engine, "images": images, "work": work,
           "model": model}
    engine.close()


def test_engine_search_equals_offline_embed_and_scan(search_world):
    from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
        OfflineEngine)
    engine = search_world["engine"]
    q = search_world["images"][5]
    ids, scores = engine.search(q, 5)
    assert ids[0] == 5
    lone = OfflineEngine(search_world["model"], head="features",
                         image_size=32, buckets=(1,), devices=["cpu"])
    emb = lone.dispatch(q[None])[0].numpy()[0]
    db = np.load(search_world["work"] / "embed" / "outputs.npy",
                 mmap_mode="r")
    ref_s, ref_i = ShardedScanner(db, k_max=10, devices=["cpu"]).scan(
        emb[None], 5)
    assert ids == [int(i) for i in ref_i[0]]
    assert scores == [float(s) for s in ref_s[0]]
    snap = engine.snapshot()
    assert snap["search_index"]["rows"] == 24
    assert snap["search_index"]["metric"] == "ip"


def test_engine_search_refusals(search_world, tmp_path):
    from pytorch_vit_paper_replication_tpu_torch.serve.engine import (
        InferenceEngine)
    engine = search_world["engine"]
    with pytest.raises(ValueError, match="outside"):
        engine.search(search_world["images"][0], 11)
    kw = dict(device="cpu", image_size=32, buckets=(1, 8),
              class_names=["a", "b", "c"], warmup=False)
    bare = InferenceEngine(search_world["model"], **kw)
    try:
        with pytest.raises(ValueError, match="search-index"):
            bare.search(search_world["images"][0], 3)
    finally:
        bare.close()
    wrong = _fabricate_source(tmp_path / "wrongdim", _corpus(16, 7))
    build_index.run_build(wrong, tmp_path / "wrongdim_idx")
    with pytest.warns(UserWarning, match="fingerprint"), \
            pytest.raises(ValueError, match="dim"):
        InferenceEngine(search_world["model"], **kw,
                        search_index=EmbeddingIndex(tmp_path /
                                                    "wrongdim_idx"))
    with pytest.raises(ValueError, match="features head"):
        InferenceEngine(torch.nn.Linear(3, 3), **kw,
                        search_index=search_world["work"] / "idx")
    other = _fabricate_source(tmp_path / "other", _corpus(16, 192))
    build_index.run_build(other, tmp_path / "other_idx")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        InferenceEngine(search_world["model"], **kw,
                        search_index=tmp_path / "other_idx").close()
    assert any("fingerprint fp-test" in str(w.message) for w in caught)


def test_serve_search_lines_have_jax_format(search_world, tmp_path):
    from pytorch_vit_paper_replication_tpu_torch.serve.__main__ import (
        ConnState, _answer)
    engine = search_world["engine"]
    img = tmp_path / "probe.png"
    Image.fromarray((search_world["images"][5] * 255).astype(np.uint8)
                    ).save(img)
    reply = _answer(f"::search 3 {img}", engine, None, ConnState())
    assert reply == jserve._search_reply(str(img), 3, engine, None,
                                         "interactive")
    path, tag, payload = reply.split("\t", 2)
    assert path == str(img) and tag == "search"
    parsed = json.loads(payload)
    assert parsed["k"] == 3 and len(parsed["ids"]) == 3
    assert _answer(f"::req k=3 {img}", engine, None, ConnState()) == reply
    direct_ids, direct_scores = engine.search(str(img), 3)
    assert parsed["ids"] == direct_ids
    np.testing.assert_array_equal(np.asarray(parsed["scores"], np.float32),
                                  np.asarray(direct_scores, np.float32))
    for bad in ("::search nope x.jpg", "::search 0 x.jpg",
                f"::search 99 {img}", "::search 3 /nonexistent.png",
                "::req k=0 x.jpg"):
        assert "\tERROR\t" in _answer(bad, engine, None, ConnState()), bad
