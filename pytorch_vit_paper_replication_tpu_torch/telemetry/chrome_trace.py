"""Export the telemetry span/event stream as Chrome trace-event JSON.

A copy of the JAX package's ``telemetry/chrome_trace.py`` (stdlib only):
the same lanes, the same event order, byte-equal JSON for the same rows.

A ``torch.profiler`` capture (:mod:`.profiling`) opens in Perfetto; the
engine's own spans — data-wait, dispatch/exec, checkpoint, eval — live
in JSONL tables. This module puts both on the same timeline: any telemetry
JSONL stream (``train.py --telemetry-jsonl`` rows, or the registry's
event ring as a postmortem/aggregator hands it over) converts to the
`Trace Event Format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
JSON object that ``chrome://tracing`` and https://ui.perfetto.dev load
directly, so "the step was slow" (span lane) and "because this kernel
stalled" (profiler capture) are one side-by-side view.

Lane layout (one pid per worker, fixed tids):

* tid 1 ``steps`` — one ``X`` (complete) slice per sampled step row,
  duration = exec seconds, args carry step/epoch/img-s/MFU,
* tid 2 ``data-wait`` — the loader's share of the same step,
* tid 3 ``spans`` — checkpoint / eval slices,
* plus ``C`` (counter) tracks for images/sec and MFU, and ``i``
  (instant) marks for epoch summaries and watchdog/profiler events.

Timestamps are wall-clock microseconds rebased to the earliest event
(Perfetto renders absolute epoch-µs fine but relative reads better);
the original epoch-seconds origin rides ``metadata.wall_clock_t0_s``.
Events are emitted sorted by ``ts`` — :func:`validate_chrome_trace`
(and the tests) hold the exporter to that, plus pid/tid/ph
presence on every event, the schema contract Perfetto actually needs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

_US = 1e6
TID_STEPS = 1
TID_WAIT = 2
TID_SPANS = 3
_THREAD_NAMES = {TID_STEPS: "steps", TID_WAIT: "data-wait",
                 TID_SPANS: "spans"}
# Instant-mark events from the registry ring worth seeing on the
# timeline (everything else unknown is skipped, not fatal — the JSONL
# grammar is shared with train metrics and serve snapshots).
_INSTANT_EVENTS = ("watchdog_postmortem", "watchdog_recovered",
                   "profiler_capture_start", "profiler_capture_stop",
                   "profiler_anomaly", "profiler_armed")


def _step_args(row: Dict[str, Any]) -> Dict[str, Any]:
    keep = ("step", "epoch", "tel_images_per_sec", "tel_mfu",
            "tel_block_sampled", "tel_step_amortized_s")
    return {k: row[k] for k in keep if k in row}


def rows_to_trace_events(rows: Iterable[Dict[str, Any]], *,
                         pid: int = 1) -> List[dict]:
    """Telemetry rows/ring events -> sorted trace events (see module
    docstring for the lane layout). Rows without a ``time`` stamp or
    with an unknown shape are skipped."""
    events: List[dict] = []
    for row in rows:
        if not isinstance(row, dict):
            continue
        end = row.get("time")
        kind = row.get("event")
        if not isinstance(end, (int, float)) or not isinstance(kind, str):
            continue
        if kind == "step":
            exec_s = float(row.get("tel_step_exec_s") or 0.0)
            wait_s = float(row.get("tel_data_wait_s") or 0.0)
            if exec_s > 0:
                events.append({"name": "step", "ph": "X", "pid": pid,
                               "tid": TID_STEPS,
                               "ts": (end - exec_s) * _US,
                               "dur": exec_s * _US,
                               "args": _step_args(row)})
            if wait_s > 0:
                events.append({"name": "data_wait", "ph": "X", "pid": pid,
                               "tid": TID_WAIT,
                               "ts": (end - exec_s - wait_s) * _US,
                               "dur": wait_s * _US,
                               "args": {"seconds": round(wait_s, 6)}})
            for counter, key in (("images_per_sec", "tel_images_per_sec"),
                                 ("mfu", "tel_mfu")):
                if row.get(key) is not None:
                    events.append({"name": counter, "ph": "C", "pid": pid,
                                   "tid": TID_STEPS, "ts": end * _US,
                                   "args": {counter: row[key]}})
        elif kind == "span" and isinstance(row.get("seconds"),
                                           (int, float)):
            dur = float(row["seconds"])
            events.append({"name": str(row.get("span", "span")),
                           "ph": "X", "pid": pid, "tid": TID_SPANS,
                           "ts": (end - dur) * _US, "dur": dur * _US,
                           "args": {"seconds": round(dur, 6)}})
        elif kind == "epoch_summary":
            args = {k: v for k, v in row.items()
                    if k.startswith("tel_") or k in ("epoch", "step")}
            events.append({"name": "epoch_summary", "ph": "i", "s": "p",
                           "pid": pid, "tid": TID_STEPS, "ts": end * _US,
                           "args": args})
        elif kind in _INSTANT_EVENTS:
            events.append({"name": kind, "ph": "i", "s": "p", "pid": pid,
                           "tid": TID_STEPS, "ts": end * _US,
                           "args": {k: v for k, v in row.items()
                                    if k not in ("time", "event")}})
    events.sort(key=lambda e: e["ts"])
    return events


def to_chrome_trace(rows: Iterable[Dict[str, Any]], *, pid: int = 1,
                    process_name: str = "train") -> dict:
    """The full Perfetto-loadable JSON object for one worker's rows."""
    events = rows_to_trace_events(rows, pid=pid)
    t0_us = events[0]["ts"] if events else 0.0
    for e in events:
        e["ts"] = round(e["ts"] - t0_us, 3)
        if "dur" in e:
            e["dur"] = round(e["dur"], 3)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": process_name}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": name}}
             for tid, name in sorted(_THREAD_NAMES.items())]
    return {"traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "metadata": {"wall_clock_t0_s": round(t0_us / _US, 6),
                         "exporter": "telemetry.chrome_trace"}}


def write_chrome_trace(rows: Iterable[Dict[str, Any]],
                       path: str | Path, *, pid: int = 1,
                       process_name: str = "train") -> dict:
    trace = to_chrome_trace(rows, pid=pid, process_name=process_name)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(trace) + "\n")
    return trace


# --------------------------------------------------- multi-process lanes
# Merged views (the fleet aggregator, a merge of request-trace sinks)
# give every role its own pid, so router/replica/teacher streams never
# share one lane triplet. Roles map to disjoint pids deterministically
# (sorted role names), with process_name metadata naming each lane.
ROLE_PID_BASE = 10


def role_pids(roles: Iterable[str]) -> Dict[str, int]:
    """Deterministic role -> pid assignment: sorted unique role names
    numbered from ROLE_PID_BASE, clear of the legacy single-process
    pid=1 so old and new lanes never alias."""
    return {role: ROLE_PID_BASE + i
            for i, role in enumerate(sorted(set(roles)))}


def spans_to_trace_events(spans: Iterable[Dict[str, Any]], *,
                          pids: Optional[Dict[str, int]] = None
                          ) -> List[dict]:
    """Request-scoped trace spans (telemetry.tracing sink rows) ->
    sorted ``X`` events, one lane (tid) per hop name inside each role's
    pid. ``ts`` stays absolute epoch-µs here; rebase happens in
    :func:`merged_chrome_trace` so multiple event sources share one
    origin."""
    spans = [s for s in spans if isinstance(s, dict)]
    if pids is None:
        pids = role_pids(str(s.get("role", "proc")) for s in spans)
    # Hop lanes start at 101: clear of the fixed step-telemetry tids
    # (1-3) in case one role carries BOTH span and telemetry streams.
    tids: Dict[tuple, int] = {}
    for s in sorted(spans, key=lambda s: (str(s.get("role", "proc")),
                                          str(s.get("name", "span")))):
        key = (str(s.get("role", "proc")), str(s.get("name", "span")))
        tids.setdefault(key,
                        len([k for k in tids if k[0] == key[0]]) + 101)
    events: List[dict] = []
    for s in spans:
        role = str(s.get("role", "proc"))
        name = str(s.get("name", "span"))
        t0, t1 = float(s["t0"]), float(s["t1"])
        args = dict(s.get("args") or {})
        args.update({"trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "parent_id": s.get("parent_id")})
        events.append({"name": name, "ph": "X",
                       "pid": pids.get(role, ROLE_PID_BASE),
                       "tid": tids[(role, name)], "ts": t0 * _US,
                       "dur": max(0.0, (t1 - t0)) * _US, "args": args})
    events.sort(key=lambda e: e["ts"])
    return events


def merged_chrome_trace(spans: Iterable[Dict[str, Any]], *,
                        process_rows: Optional[
                            Dict[str, Iterable[Dict[str, Any]]]] = None
                        ) -> dict:
    """ONE Perfetto-loadable object for a merged multi-process view:
    request-span lanes per role (router/replica/teacher…) plus,
    optionally, each role's step-telemetry rows (``process_rows``
    maps role -> telemetry JSONL rows) in that role's OWN pid — the
    lane-collision fix: streams from different processes can no longer
    land on one shared pid."""
    spans = [s for s in spans if isinstance(s, dict)]
    roles = {str(s.get("role", "proc")) for s in spans}
    if process_rows:
        roles |= set(process_rows)
    pids = role_pids(roles)
    events = spans_to_trace_events(spans, pids=pids)
    span_lanes = {(e["pid"], e["tid"]): e["name"] for e in events}
    tel_pids = set()
    if process_rows:
        for role, rows in sorted(process_rows.items()):
            events.extend(rows_to_trace_events(rows, pid=pids[role]))
            tel_pids.add(pids[role])
        events.sort(key=lambda e: e["ts"])
    t0_us = events[0]["ts"] if events else 0.0
    for e in events:
        e["ts"] = round(e["ts"] - t0_us, 3)
        if "dur" in e:
            e["dur"] = round(e["dur"], 3)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": role}}
            for role, pid in sorted(pids.items())]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": name}}
             for (pid, tid), name in sorted(span_lanes.items())]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": name}}
             for pid in sorted(tel_pids)
             for tid, name in sorted(_THREAD_NAMES.items())]
    return {"traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "metadata": {"wall_clock_t0_s": round(t0_us / _US, 6),
                         "exporter": "telemetry.chrome_trace",
                         "role_pids": pids}}


def validate_chrome_trace(trace: Any) -> int:
    """Assert the trace-event schema Perfetto needs; returns the number
    of non-metadata events. Raises ValueError naming every violation —
    the contract for everything this exporter emits."""
    problems: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("not a trace object: missing 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' is not a list")
    last_ts: Optional[float] = None
    timed = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                problems.append(f"event {i}: missing {key!r}")
        if e.get("ph") == "M":
            continue  # metadata events carry no timestamp
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        timed += 1
        if last_ts is not None and ts < last_ts:
            problems.append(f"event {i}: ts {ts} < previous {last_ts} "
                            "(events must be sorted)")
        last_ts = ts
        if e.get("ph") == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: complete event with bad "
                                f"dur {dur!r}")
    if problems:
        raise ValueError("invalid chrome trace: " + "; ".join(problems))
    return timed
