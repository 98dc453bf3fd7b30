"""The port's serving path on the CPU against itself and the JAX package.

A ViT-Ti/16 at 32 px (f32) is initialized by JAX from a seed, converted,
and written as the port's export (``params.npz`` + ``transform.json`` +
``model_meta.json``). The CPU engine then serves it: the ``::probs`` row
must equal the port's ``predict_image`` bit for bit (same ops, same batch
shape) and JAX's ``predict_image`` within 1e-4 (f32 forward tolerance);
the features/tokens heads must match JAX's ``ViTFeatureExtractor``.
"""

import json
import subprocess
import time
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_vit_paper_replication_tpu.configs import vit_ti16 as jvit_ti16
from pytorch_vit_paper_replication_tpu.data.transforms import (
    eval_transform as jax_eval_transform)
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.models import (
    ViTFeatureExtractor as JFeat)
from pytorch_vit_paper_replication_tpu.predictions import (
    predict_image as jax_predict_image)
from pytorch_vit_paper_replication_tpu_torch import configs as tcfg
from pytorch_vit_paper_replication_tpu_torch.convert import params_from_flax
from pytorch_vit_paper_replication_tpu_torch.models import ViT
from pytorch_vit_paper_replication_tpu_torch.predictions import (
    predict_image, save_inference_export)
from pytorch_vit_paper_replication_tpu_torch.serve import InferenceEngine
from pytorch_vit_paper_replication_tpu_torch.serve.__main__ import _answer

REPO = Path(__file__).resolve().parent.parent
CLASSES = ["pizza", "steak", "sushi"]
F32 = {"dtype": "float32"}


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    """(export_dir, image paths, jax model, jax params)."""
    root = tmp_path_factory.mktemp("torch_serve")
    jm = JViT(jvit_ti16(num_classes=3, image_size=32, dtype="float32",
                        attention_impl="xla"))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32) for x in leaves])
    tm = ViT(tcfg.vit_ti16(num_classes=3, image_size=32, **F32))
    tm.load_state_dict(params_from_flax(params))
    out = save_inference_export(root / "export", tm)
    paths = []
    for i in range(4):
        p = root / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    return out, paths, jm, params


@pytest.fixture(scope="module")
def engine(export):
    eng = InferenceEngine.from_checkpoint(
        export[0], preset="ViT-Ti/16", class_names=CLASSES, device="cpu",
        config_overrides=F32, buckets=(1, 4), max_wait_us=1000)
    yield eng
    eng.close()


def test_probs_row_bit_identical_to_predict_image_and_close_to_jax(
        export, engine):
    _, paths, jm, params = export
    reply = json.loads(_answer(f"::probs {paths[0]}", engine, None))
    got = np.asarray(reply["probs"], np.float32)
    _, _, mine = predict_image(engine.model, paths[0], CLASSES,
                               transform=engine.transform)
    np.testing.assert_array_equal(got, mine)
    assert reply["label"] == CLASSES[int(mine.argmax())]
    _, _, theirs = jax_predict_image(jm, params, paths[0], CLASSES,
                                     transform=jax_eval_transform(32))
    np.testing.assert_allclose(got, theirs, atol=1e-4, rtol=1e-4)
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_features_and_tokens_heads_match_jax_backbone(export, engine):
    _, paths, jm, params = export
    feats = engine.submit(paths[1], head="features").result(timeout=60)
    toks = engine.submit(paths[1], head="tokens").result(timeout=60)
    x = np.asarray(engine.transform(Image.open(paths[1])))[None]
    want = np.asarray(JFeat(jm.config).apply(
        {"params": params["backbone"]}, jnp.asarray(x)))[0]
    assert toks.shape == (5, 192) and feats.shape == (192,)
    np.testing.assert_allclose(toks, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(feats, want[0], atol=1e-4, rtol=1e-4)


def test_engine_snapshot_manifest_and_every_request_answered(export,
                                                             engine):
    export_dir, paths, _, _ = export
    futs = [engine.submit(p) for p in paths * 3]
    results = [f.result(timeout=60) for f in futs]
    assert len(results) == 12 and all(r.label in CLASSES for r in results)
    snap = engine.snapshot()
    assert snap["device"] == "cpu" and snap["warm_rungs"] == [1, 4]
    assert snap["served_heads"] == ["probs", "features", "tokens"]
    assert snap["model_tier"] == "ViT-Ti/16"
    assert len(snap["checkpoint_fingerprint"]) == 16
    manifest = json.loads((export_dir / "warmup.json").read_text())
    assert manifest["buckets"] == [1, 4] and manifest["image_size"] == 32


def test_cli_control_lines(engine):
    assert _answer("::head features", engine, None) == \
        "::head\tok\tfeatures"
    assert "ERROR" in _answer("::head nope", engine, None)
    reply = _answer("::metrics", engine, None)
    assert reply.endswith("\n") and "\tERROR\t" not in reply
    assert "# HELP vit_serve_queue_depth Serve micro-batcher queue depth" \
        in reply
    assert "# TYPE vit_serve_warm_rungs gauge" in reply
    # Search is ported: without --search-index it answers the request's
    # error line.
    for line in ("::search 3 /x.png", "::req k=2 /x.png"):
        assert _answer(line, engine, None) == (
            "/x.png\tERROR\tValueError: no search index attached (serve "
            "--search-index DIR after building one with tools.build_index)")


def test_pipe_mode_cli_replies_well_formed(export):
    export_dir, paths, _, _ = export
    lines = [str(paths[0]), "::stats", "::head features", str(paths[1]),
             f"::req head=probs tier=batch {paths[2]}", "::metrics",
             "/no/such/image.png"]
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_vit_paper_replication_tpu_torch.serve",
         "--checkpoint", str(export_dir), "--preset", "ViT-Ti/16",
         "--classes", *CLASSES, "--device", "cpu", "--buckets", "1,4",
         "--sync-warmup", "--no-manifest"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    # ::metrics answers a Prometheus block ended by one blank line; every
    # other line answers one line.
    text = proc.stdout
    head, block = text.split("# HELP", 1)
    block, tail = ("# HELP" + block).split("\n\n", 1)
    out = head.splitlines() + [block] + tail.splitlines()
    assert len(out) == len(lines)
    path0, label, prob = out[0].split("\t")
    assert path0 == str(paths[0]) and label in CLASSES
    assert 0.0 < float(prob) <= 1.0
    assert json.loads(out[1])["buckets"] == [1, 4]
    assert out[2] == "::head\tok\tfeatures"
    p1, head, row = out[3].split("\t")
    assert head == "features" and len(json.loads(row)) == 192
    assert out[4].split("\t")[1] in CLASSES
    assert "# TYPE vit_serve_queue_depth gauge" in out[5]
    assert all(line.startswith(("# HELP ", "# TYPE ", "vit_"))
               for line in out[5].splitlines())
    assert out[6].startswith("/no/such/image.png\tERROR\t")


def test_import_whole_port_pulls_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pytorch_vit_paper_replication_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in ('distill', 'distill.sink', 'distill.recipe', 'search',"
        " 'search.index', 'search.ivf', 'search.scan', 'ops.scan_scores',"
        " 'tools.build_index', 'telemetry.shipper', 'telemetry.chrome_trace',"
        " 'serve.loadgen', 'serve.cascade', 'serve.fleet',"
        " 'serve.fleet.policy', 'serve.fleet.replica', 'serve.fleet.router',"
        " 'serve.fleet.rollout', 'serve.fleet.autoscale',"
        " 'serve.fleet.__main__', 'parallel.ring_attention',"
        " 'parallel.ulysses', 'parallel.collectives'):\n"
        "    assert pkg.__name__ + '.' + name in sys.modules, name\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'flax'"
        " or m.startswith('pytorch_vit_paper_replication_tpu.')"
        " or m == 'pytorch_vit_paper_replication_tpu']\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_entry_point_without_device_raises_without_a_card(export):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    tm = ViT(tcfg.ViTConfig(image_size=32, patch_size=16, num_layers=1,
                            num_heads=2, embedding_dim=32, mlp_size=64,
                            num_classes=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tm, image_size=32, warmup=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine.from_checkpoint(export[0], preset="ViT-Ti/16",
                                        class_names=CLASSES)


# ---------------------------------------------- telemetry sinks vs JAX
REQUESTS = 4


@pytest.fixture(scope="module")
def engines(export):
    """A JAX and a port engine over the same weights, each publishing
    into a registry of its own."""
    from pytorch_vit_paper_replication_tpu.serve import (
        InferenceEngine as JEngine)
    from pytorch_vit_paper_replication_tpu.serve.stats import (
        ServeStats as JStats)
    from pytorch_vit_paper_replication_tpu.telemetry.registry import (
        TelemetryRegistry as JRegistry)
    from pytorch_vit_paper_replication_tpu_torch.serve.stats import (
        ServeStats)
    from pytorch_vit_paper_replication_tpu_torch.telemetry.registry import (
        TelemetryRegistry)

    export_dir, paths, jm, params = export
    jeng = JEngine(jm, params, image_size=32, class_names=CLASSES,
                   buckets=(1, 4), stats=JStats(registry=JRegistry()))
    teng = InferenceEngine.from_checkpoint(
        export_dir, preset="ViT-Ti/16", class_names=CLASSES, device="cpu",
        config_overrides=F32, buckets=(1, 4), use_manifest=False,
        stats=ServeStats(registry=TelemetryRegistry()))
    yield jeng, teng
    jeng.close()
    teng.close()


def _sequential(eng, paths):
    for i in range(REQUESTS):
        eng.submit(str(paths[i % len(paths)])).result(timeout=120)
    eng.submit(str(paths[0]), head="features", tier="batch").result(
        timeout=120)


def _help_and_types(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith(("# HELP vit_serve_",
                                      "# TYPE vit_serve_")))


def test_metrics_names_and_help_equal_jax_serve(export, engines):
    from pytorch_vit_paper_replication_tpu.serve.__main__ import (
        _answer as jax_answer)

    paths = export[1]
    jeng, teng = engines
    _sequential(jeng, paths)
    _sequential(teng, paths)
    theirs = jax_answer("::metrics", jeng, None)
    mine = _answer("::metrics", teng, None)
    assert _help_and_types(mine) == _help_and_types(theirs)
    assert len(_help_and_types(mine)) > 20
    names = [sorted(line.split()[0].split("{")[0]
                    for line in text.splitlines()
                    if line.startswith("vit_serve_"))
             for text in (mine, theirs)]
    assert names[0] == names[1]


def test_stats_jsonl_keys_equal_jax_serve(export, engines, tmp_path):
    from pytorch_vit_paper_replication_tpu.metrics import (
        MetricsLogger as JLogger)
    from pytorch_vit_paper_replication_tpu_torch.metrics import MetricsLogger

    jeng, teng = engines
    rows = []
    for eng, logger_cls, name in ((jeng, JLogger, "jax"),
                                  (teng, MetricsLogger, "port")):
        path = tmp_path / f"{name}.jsonl"
        logger = logger_cls(jsonl_path=str(path))
        eng.stats.emit(logger)
        logger.close()
        rows.append(json.loads(path.read_text().splitlines()[-1]))
    # The JAX row carries compile_cache_hits / _misses once its process's
    # persistent XLA cache has seen a request (other tests in the same
    # worker may have turned it on); the port has no such cache (ROADMAP
    # Queue 1 item 9), so it never writes them.
    no_cache = {"compile_cache_hits", "compile_cache_misses"}
    assert sorted(set(rows[0]) - no_cache) == sorted(rows[1])
    assert rows[1]["head_probs_completed"] >= REQUESTS


def _spans(path):
    rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
    by_id = {r["span_id"]: r for r in rows}
    traces = {}
    for r in rows:
        parent = by_id.get(r["parent_id"])
        traces.setdefault(r["trace_id"], []).append(
            (r["name"], parent["name"] if parent else
             str(r["parent_id"])))
    return sorted(sorted(t) for t in traces.values())


def test_trace_spans_and_parents_equal_jax_serve(export, engines, tmp_path,
                                                 monkeypatch):
    """The same lines through each package's pipe mode and socket-mode
    answer, traced at rate 1: the same span names under the same parents
    per trace (an inbound trace= token adopted, control lines never
    traced)."""
    import io

    from pytorch_vit_paper_replication_tpu.serve import (
        __main__ as jserve)
    from pytorch_vit_paper_replication_tpu.telemetry import (
        tracing as jtracing)
    from pytorch_vit_paper_replication_tpu_torch.serve import (
        __main__ as tserve)
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        tracing as ttracing)

    paths = export[1]
    upstream = "00-" + "f" * 32 + "-" + "e" * 16 + "-01"
    lines = [str(paths[0]), "::stats", f"::req head=features {paths[1]}",
             ttracing.inject_wire_context(f"::probs {paths[2]}", upstream),
             "::head probs", f"::req k=3 {paths[0]}", str(paths[3])]
    jeng, teng = engines
    got = {}
    for name, serve_mod, tr, eng in (("jax", jserve, jtracing, jeng),
                                     ("port", tserve, ttracing, teng)):
        sink = tmp_path / f"{name}_spans.jsonl"
        tr.configure_tracer(str(sink), role="replica", sample_rate=1.0)
        try:
            monkeypatch.setattr(sys, "stdin", io.StringIO(
                "\n".join(lines) + "\n"))
            out = io.StringIO()
            monkeypatch.setattr(sys, "stdout", out)
            serve_mod._serve_stdin(eng, None)
            monkeypatch.undo()
            for line in lines:
                serve_mod._answer(line, eng, None)
        finally:
            tr.get_tracer().close()
            tr.configure_tracer(None)
        got[name] = (_spans(sink), len(out.getvalue().splitlines()))
    assert got["port"] == got["jax"]
    names = {n for trace in got["port"][0] for n, _ in trace}
    assert {"serve.request", "batch.queue_wait", "batch.device"} <= names
    assert any(("serve.request", "e" * 16) in t for t in got["port"][0])


def test_serve_cli_stats_ship_and_trace_flags(export, tmp_path,
                                              monkeypatch):
    """The serve CLI in pipe mode with --stats-jsonl, --ship-to and
    --trace-jsonl: a stats row on exit, frames of role serve (the last
    one sent at shutdown) and request spans; bad values are refused as
    the JAX CLI refuses them."""
    import io

    from pytorch_vit_paper_replication_tpu_torch.serve import (
        __main__ as tserve)
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        tracing as ttracing)
    from pytorch_vit_paper_replication_tpu_torch.telemetry.shipper import (
        FrameSink)

    export_dir, paths, _, _ = export
    with pytest.raises(SystemExit, match="--ship-to: expected HOST:PORT"):
        tserve.main(["--checkpoint", str(export_dir), "--classes", *CLASSES,
                     "--ship-to", "nohost"])
    stats, spans = tmp_path / "stats.jsonl", tmp_path / "spans.jsonl"
    with FrameSink() as sink:
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            f"{paths[0]}\n{paths[1]}\n::metrics\n"))
        monkeypatch.setattr(sys, "stdout", io.StringIO())
        try:
            tserve.main([
                "--checkpoint", str(export_dir), "--classes", *CLASSES,
                "--preset", "ViT-Ti/16", "--device", "cpu", "--buckets",
                "1,4", "--no-manifest", "--sync-warmup",
                "--stats-jsonl", str(stats),
                "--stats-interval-s", "100", "--ship-to",
                f"127.0.0.1:{sink.port}", "--ship-interval-s", "100",
                "--worker-id", "rep-0", "--trace-jsonl", str(spans),
                "--trace-sample", "1", "--trace-role", "replica-x"])
        finally:
            ttracing.get_tracer().close()
            ttracing.configure_tracer(None)
        monkeypatch.undo()
        deadline = time.monotonic() + 10
        while sink.frame_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        frames = list(sink.frames)
    row = json.loads(stats.read_text().splitlines()[-1])
    assert row["head_probs_completed"] == 2
    assert len(frames) >= 2 and {f["role"] for f in frames} == {"serve"}
    assert frames[-1]["worker_id"] == "rep-0"
    assert frames[-1]["snapshot"]["gauges"]["serve_warm_rungs"] == 2
    rows = [json.loads(line) for line in spans.read_text().splitlines()]
    assert {r["role"] for r in rows} == {"replica-x"}
    assert sum(r["name"] == "serve.request" for r in rows) == 2
