"""Serving CLI of the port: stdin/stdout pipe mode and a TCP socket mode.

The JAX package's serve line protocol, answered by the port's engine on
``--device`` (``cuda`` by default)::

    printf '%s\\n' img1.jpg ::stats | \\
        python -m pytorch_vit_paper_replication_tpu_torch.serve \\
            --checkpoint EXPORT_DIR --classes-file classes.txt

    img1.jpg<TAB>pizza<TAB>0.9120

Socket mode (``--port``): concurrent clients' requests coalesce into
shared device batches, one connection per client, one line per request.

Lines (both modes):

* a bare image path — ``path<TAB>label<TAB>prob`` on the connection's head
  (``features``/``tokens`` answer ``path<TAB>head<TAB>[float32 JSON]``);
* ``::stats`` — the engine snapshot as one JSON line;
* ``::probs <path>`` — one JSON line with the full float32 softmax row;
* ``::head probs|features|tokens`` / ``::tier interactive|batch`` — this
  connection's defaults;
* ``::req [head=H] [tier=T] <path>`` — one-shot inline head/tier;
* ``::search K <path>`` (and its relay form ``::req k=K <path>``), with
  ``--search-index DIR`` — the K nearest rows of a ``tools.build_index``
  index: ``path<TAB>search<TAB>{"k", "ids", "scores"}`` (full-precision
  float32 scores, best first);
* ``::drain [timeout_s]`` — quiesce the micro-batcher.

``::metrics`` belongs to a subsystem not ported yet (the Prometheus
exporter); it answers an explicit ``ERROR ... not yet ported`` line.
"""

from __future__ import annotations

import argparse
import json
import sys

from .batching import (DEFAULT_HEAD, DEFAULT_TIER, TIERS, parse_req_line,
                       parse_search_line)
from .bucketing import DEFAULT_BUCKETS
from .engine import InferenceEngine

_NOT_PORTED = {
    "::metrics": "the Prometheus ::metrics exporter (ROADMAP Queue 1, "
                 "telemetry)",
}


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """Engine/SLO knobs."""
    p.add_argument("--buckets", type=str,
                   default=",".join(str(b) for b in DEFAULT_BUCKETS),
                   help="comma-separated batch bucket ladder")
    p.add_argument("--max-wait-us", type=int, default=2000,
                   help="micro-batch coalescing window for interactive-"
                        "tier requests (latency knob)")
    p.add_argument("--batch-max-wait-us", type=int, default=50_000,
                   help="batch-tier fill window (also its anti-starvation "
                        "bound)")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="admission bound; beyond it submits are rejected "
                        "with a retry-after hint")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="per-request deadline; expired requests are "
                        "dropped before they occupy a device batch")


def parse_buckets(spec: str):
    return tuple(int(b) for b in spec.split(",") if b.strip())


class ConnState:
    """Per-connection protocol state: the default head/tier a bare
    request line rides (set by ``::head`` / ``::tier``)."""

    __slots__ = ("head", "tier")

    def __init__(self, head: str = DEFAULT_HEAD,
                 tier: str = DEFAULT_TIER):
        self.head = head
        self.tier = tier


def _not_ported(line: str):
    for cmd, what in _NOT_PORTED.items():
        if line == cmd or line.startswith(cmd + " "):
            return (f"{line}\tERROR\tNotImplementedError: {cmd} is not yet "
                    f"ported to the PyTorch/CUDA package ({what})")
    return None


def _answer(line: str, engine: InferenceEngine, timeout: float | None,
            state: ConnState | None = None) -> str:
    """One request line -> one response (shared by both modes)."""
    line = line.strip()
    state = state if state is not None else ConnState()
    refused = _not_ported(line)
    if refused is not None:
        return refused
    if line == "::stats":
        return json.dumps(engine.snapshot())
    if line.startswith("::head"):
        parts = line.split()
        if len(parts) == 2 and parts[1] in engine.heads:
            state.head = parts[1]
            return f"::head\tok\t{state.head}"
        return (f"{line}\tERROR\tValueError: expected '::head H' with "
                f"H in {list(engine.heads)}")
    if line.startswith("::tier"):
        parts = line.split()
        if len(parts) == 2 and parts[1] in TIERS:
            state.tier = parts[1]
            return f"::tier\tok\t{state.tier}"
        return (f"{line}\tERROR\tValueError: expected '::tier T' with "
                f"T in {list(TIERS)}")
    if line == "::drain" or line.startswith("::drain "):
        parts = line.split()
        try:
            drain_s = float(parts[1]) if len(parts) > 1 else 10.0
        except ValueError:
            return json.dumps({"error": f"bad ::drain timeout {parts[1]!r}"})
        return json.dumps({"draining": True,
                           "unfinished": engine.drain(drain_s)})
    if line.startswith("::probs "):
        path = line[len("::probs "):].strip()
        try:
            r = engine.submit(path, timeout=timeout).result()
        except Exception as e:  # noqa: BLE001 — one bad probe answers
            # THAT probe; serving goes on.
            return json.dumps({"error": f"{type(e).__name__}: {e}"})
        return json.dumps({"label": r.label, "prob": r.prob,
                           "probs": [float(p) for p in r.probs]})
    if line.startswith("::search"):
        try:
            k, path = parse_search_line(line)
        except ValueError as e:
            return f"{line}\tERROR\tValueError: {e}"
        return _search_reply(path, k, engine, timeout, state.tier)
    head, tier = state.head, state.tier
    if line.startswith("::req"):
        # A k= pair marks a search request (the router's relay form of
        # ::search); it answers with ::search's reply.
        try:
            req_head, req_tier, req_k, _model, path = parse_req_line(line)
        except ValueError as e:
            return f"{line}\tERROR\tValueError: {e}"
        head = req_head if req_head is not None else head
        tier = req_tier if req_tier is not None else tier
        if req_k is not None:
            return _search_reply(path, req_k, engine, timeout, tier)
        line = path
    try:
        fut = engine.submit(line, timeout=timeout, head=head, tier=tier)
    except Exception as e:  # noqa: BLE001 — admission errors answer
        # THAT request; serving goes on.
        return f"{line}\tERROR\t{type(e).__name__}: {e}"
    return _finish(line, fut, head)


def _search_reply(path: str, k: int, engine: InferenceEngine,
                  timeout: float | None, tier: str) -> str:
    """One ``::search`` request -> one reply line (both modes, and the
    ``::req k=`` relay form): ``path\\tsearch\\t{json}`` with index row
    ids and full-precision float32 scores, best first."""
    try:
        ids, scores = engine.search(path, k, tier=tier, timeout=timeout)
    except Exception as e:  # noqa: BLE001 — a bad request (no index, k
        # out of bounds, unreadable image, backpressure) answers THAT
        # request; serving goes on.
        return f"{path}\tERROR\t{type(e).__name__}: {e}"
    return f"{path}\tsearch\t" + json.dumps(
        {"k": k, "ids": ids, "scores": scores})


def _serve_stdin(engine: InferenceEngine, timeout: float | None) -> None:
    # Submit-ahead pipeline: a bounded window of futures in flight so
    # piped traffic coalesces instead of serializing batch-of-1.
    window = max(1, engine._batcher.max_queue // 2)
    state = ConnState()
    pending = []

    def drain(n):
        while len(pending) > n:
            p_line, fut, p_head = pending.pop(0)
            print(_finish(p_line, fut, p_head), flush=True)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        head, tier = state.head, state.tier
        if line.startswith("::req"):
            try:
                req_head, req_tier, req_k, _model, path = \
                    parse_req_line(line)
            except ValueError as e:
                print(f"{line}\tERROR\tValueError: {e}", flush=True)
                continue
            head = req_head if req_head is not None else head
            tier = req_tier if req_tier is not None else tier
            if req_k is not None:
                # A search: the embed + scan is synchronous, so it answers
                # in submission order like a control line.
                drain(0)
                print(_search_reply(path, req_k, engine, timeout, tier),
                      flush=True)
                continue
            line = path
        elif line.startswith("::"):
            # Control commands answer in submission order relative to the
            # pipeline: flush the window first.
            drain(0)
            print(_answer(line, engine, timeout, state), flush=True)
            continue
        try:
            pending.append((line, engine.submit(
                line, timeout=timeout, head=head, tier=tier), head))
        except Exception as e:  # noqa: BLE001
            print(f"{line}\tERROR\t{type(e).__name__}: {e}", flush=True)
        drain(window)
    drain(0)


def _format_row(values) -> str:
    """A features/tokens row as full-precision float32 JSON."""
    import numpy as np

    return json.dumps(np.asarray(values, np.float32).tolist())


def _finish(line: str, fut, head: str = DEFAULT_HEAD) -> str:
    try:
        result = fut.result()
        if head == "probs":
            return f"{line}\t{result.label}\t{result.prob:.4f}"
        return f"{line}\t{head}\t{_format_row(result)}"
    except Exception as e:  # noqa: BLE001
        return f"{line}\tERROR\t{type(e).__name__}: {e}"


def _serve_socket(engine: InferenceEngine, host: str, port: int,
                  timeout: float | None, on_ready=None) -> None:
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            state = ConnState()  # per-connection head/tier defaults
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                reply = _answer(line, engine, timeout, state)
                self.wfile.write((reply + "\n").encode())
                self.wfile.flush()

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as srv:
        print(f"[serve] listening on {host}:{srv.server_address[1]} "
              f"(line protocol: one image path per line; '::stats' for "
              f"a JSON snapshot)", file=sys.stderr)
        if on_ready is not None:
            on_ready(srv)  # tests: grab the bound port / call shutdown()
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass


def main(argv=None):
    p = argparse.ArgumentParser(
        description="ViT online serving on PyTorch/CUDA (dynamic "
                    "micro-batching)")
    p.add_argument("--checkpoint", required=True,
                   help="the port's export directory (params.npz + "
                        "transform.json + model_meta.json) or a training "
                        "--checkpoint-dir holding final/")
    cls_group = p.add_mutually_exclusive_group(required=True)
    cls_group.add_argument("--classes", nargs="+",
                           help="class names, in training order")
    cls_group.add_argument("--classes-file",
                           help="file with one class name per line")
    p.add_argument("--preset", default="ViT-B/16")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' "
                        "runs the kernels' plain PyTorch versions)")
    p.add_argument("--model-tier", default=None, metavar="TIER",
                   help="declared deployment tier this replica plays; "
                        "reported as model_tier in ::stats")
    p.add_argument("--image-size", type=int, default=None,
                   help="override the checkpoint's transform.json size")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None,
                   help="serve a TCP socket instead of stdin/stdout")
    p.add_argument("--no-manifest", action="store_true",
                   help="ignore any warmup.json next to the checkpoint "
                        "and don't write one")
    p.add_argument("--sync-warmup", action="store_true",
                   help="run the whole bucket ladder before accepting "
                        "traffic (default: warm in the background, "
                        "smallest rung first)")
    p.add_argument("--search-index", default=None, metavar="DIR",
                   help="a tools.build_index index directory; enables "
                        "'::search K <path>' — embed through the features "
                        "head, scan the memory-mapped index on the "
                        "serving device, answer the K nearest rows")
    p.add_argument("--search-k-max", type=int, default=100,
                   help="largest K a ::search may ask for (the scan's "
                        "candidate width)")
    add_engine_args(p)
    args = p.parse_args(argv)

    from ..predictions import load_class_names
    class_names = (load_class_names(args.classes_file)
                   if args.classes_file else args.classes)

    def log_rung(bucket, seconds):
        print(f"[serve] warmup: bucket {bucket} ran in {seconds:.2f}s",
              file=sys.stderr)

    search_index = None
    if args.search_index:
        # Opened (and shape-checked) before the checkpoint load: a bad
        # --search-index fails in milliseconds, not after the warmup.
        from ..search.index import EmbeddingIndex
        search_index = EmbeddingIndex(args.search_index)
        print(f"[serve] search index: "
              f"{json.dumps(search_index.describe())}", file=sys.stderr)

    engine = InferenceEngine.from_checkpoint(
        args.checkpoint, preset=args.preset, class_names=class_names,
        image_size=args.image_size, buckets=parse_buckets(args.buckets),
        max_wait_us=args.max_wait_us,
        batch_max_wait_us=args.batch_max_wait_us,
        max_queue=args.max_queue,
        warmup=(True if args.sync_warmup else "async"),
        use_manifest=not args.no_manifest,
        warmup_callback=log_rung,
        search_index=search_index,
        search_k_max=args.search_k_max,
        model_tier=args.model_tier,
        device=args.device)
    print(f"[serve] warming {len(engine._warmup_rungs)} bucket shapes "
          f"{list(engine._warmup_rungs)} at {engine.image_size}px on "
          f"{engine.device}"
          + ("" if args.sync_warmup else " (background)")
          + f"; heads: {','.join(engine.heads)}",
          file=sys.stderr)
    try:
        if args.port is not None:
            _serve_socket(engine, args.host, args.port, args.timeout_s)
        else:
            _serve_stdin(engine, args.timeout_s)
    finally:
        print(json.dumps(engine.snapshot()), file=sys.stderr)
        engine.close()


if __name__ == "__main__":
    main()
