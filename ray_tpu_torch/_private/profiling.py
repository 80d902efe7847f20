"""Chrome-tracing timeline export (the counterpart of
``ray_tpu/_private/profiling.py``; ref: _private/state.py timeline():960).

``chrome_trace()`` folds the runtime's task-event log and the exported
tracing spans into chrome://tracing "X" (complete) events — load the JSON at
chrome://tracing or ui.perfetto.dev.  SLO burn episodes share one "serve"
lane there.  ``postmortem_chrome_events`` lays out a forensics bundle
(``util/forensics.py``): one lane per dumped process.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


#: Span-name prefixes folded into the shared "train" timeline lane: one
#: Perfetto process row holds training steps, their wait buckets, elastic
#: recoveries, checkpoint phases and ingest transfers TOGETHER, so a
#: shrink -> restore -> resume sequence (with its starved steps) reads as
#: one story instead of thousands of per-trace rows.
_TRAIN_LANE_PREFIXES = ("train.", "checkpoint.", "data.")

#: Serve health-plane spans folded into one shared "serve" lane the same
#: way: SLO burn episodes and preemption recomputes from every request
#: line up on a single row, so a preemption-storm -> SLO-burn -> recovery
#: episode reads as one story next to the per-trace request lanes.
_SERVE_LANE_PREFIXES = ("serve.slo", "serve.preempt_recompute")

#: Device-plane spans (compiles, host<->device transfers and compute burns
#: from util.device_telemetry) fold into one shared "device" lane: a
#: recompile storm, the transfers feeding it, and the burns it starves line
#: up on a single row under the train/serve stories.
_DEVICE_LANE_PREFIXES = ("xla.", "device.")


def spans_to_chrome_events(spans: List[dict]) -> List[dict]:
    """Fold util.tracing spans into chrome-tracing "X" (complete) events.

    Rows group by trace: ``pid`` is the trace id (Perfetto renders one
    process lane per trace — a whole serve request reads top-to-bottom),
    ``tid`` is the span's name so sibling spans of the same kind share a
    track.  Training-plane spans (train./checkpoint./data.) instead share
    the single "train" pid (_TRAIN_LANE_PREFIXES), serve health-plane
    spans (SLO burns, preemption recomputes) the single "serve" pid
    (_SERVE_LANE_PREFIXES), and device-plane spans (xla./device.) the
    single "device" pid (_DEVICE_LANE_PREFIXES).  Unfinished spans
    (end=None) are skipped — an open span has no duration yet."""
    out: List[dict] = []
    for s in spans:
        if s.get("end") is None:
            continue
        args = {"span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "status": s.get("status", "OK")}
        args.update(s.get("attributes") or {})
        name = s.get("name", "")
        if name.startswith(_TRAIN_LANE_PREFIXES):
            pid = "train"
        elif name.startswith(_SERVE_LANE_PREFIXES):
            pid = "serve"
        elif name.startswith(_DEVICE_LANE_PREFIXES):
            pid = "device"
        else:
            pid = f"trace:{s.get('trace_id', '')[:8]}"
        ev = {
            "ph": "X", "cat": "trace",
            "name": name,
            "pid": pid,
            "tid": s.get("name", ""),
            "ts": s["start"] * 1e6,
            "dur": max(0.0, (s["end"] - s["start"]) * 1e6),
            "args": args,
        }
        if s.get("status", "OK") != "OK":
            ev["cname"] = "terrible"
        out.append(ev)
    return out


def postmortem_chrome_events(bundle: Dict[str, Any]) -> List[dict]:
    """Fold a forensics postmortem bundle (util.forensics.build_bundle)
    into chrome-tracing events: one Perfetto process lane per dumped
    process holding the spans its flight-recorder ring captured, with
    instant markers ("i" events, rendered as flow arrows/flags) at state
    transitions, dump triggers, and stall/death moments — so "replica
    died mid-batch" or "worker wedged in a rendezvous" reads directly off
    the fused timeline."""
    out: List[dict] = []
    for dump in bundle.get("dumps", []):
        pid = f"pid:{dump.get('pid')}"
        for row in dump.get("ring", []):
            kind = row.get("kind", "event")
            name = row.get("name", "")
            status = row.get("status", "OK")
            if kind == "span":
                ev = {
                    "ph": "X", "cat": "forensics", "name": name,
                    "pid": pid, "tid": name,
                    "ts": row.get("start", 0.0) * 1e6,
                    "dur": max(0.0, (row.get("end", 0.0)
                                     - row.get("start", 0.0)) * 1e6),
                    "args": {"status": status, "seq": row.get("seq")},
                }
            else:
                ev = {
                    "ph": "i", "cat": "forensics", "name": f"{kind}:{name}",
                    "pid": pid, "tid": kind,
                    "ts": row.get("start", 0.0) * 1e6, "s": "p",
                    "args": {"status": status, "seq": row.get("seq")},
                }
            if status != "OK" or kind in ("stall", "trigger"):
                ev["cname"] = "terrible"
            out.append(ev)
        # The dump moment itself: the death/breach marker, process-scoped.
        out.append({
            "ph": "i", "cat": "forensics",
            "name": f"dump:{dump.get('reason')}", "pid": pid, "tid": "dump",
            "ts": (dump.get("ts") or 0.0) * 1e6, "s": "p",
            "args": {"reason": dump.get("reason"), "id": dump.get("id")},
            "cname": "terrible",
        })
    return out


def chrome_trace(events: Optional[List[dict]] = None,
                 include_spans: bool = True) -> List[dict]:
    """Fold the task-event log into chrome-tracing events.

    Execution spans: RUNNING→FINISHED/FAILED pairs per task attempt.
    Instant events for submits/retries.  When tracing is on (util.tracing), the exported
    distributed-trace spans — serve request timelines included — fold in
    as their own per-trace lanes (``include_spans=False`` to opt out).
    """
    span_events: List[dict] = []
    if include_spans:
        from ray_tpu_torch.util import tracing as _tracing

        span_events = spans_to_chrome_events(_tracing.exported_spans())
    if events is None:
        from ray_tpu_torch._private import runtime as _rt

        rt = _rt.get_runtime()
        events = rt.list_task_events()

    out: List[dict] = []
    running: Dict[str, dict] = {}
    for ev in events:
        state = ev.get("state", "")
        tid = ev["task_id"]
        us = ev["time"] * 1e6
        if state == "RUNNING":
            running[tid] = ev
        elif state in ("FINISHED", "FAILED") and tid in running:
            beg = running.pop(tid)
            out.append({
                "ph": "X", "cat": "task", "name": ev.get("name", tid),
                "pid": ev.get("node_id", "node"), "tid": tid,
                "ts": beg["time"] * 1e6, "dur": us - beg["time"] * 1e6,
                "args": {"task_id": tid, "state": state},
                "cname": ("thread_state_running" if state == "FINISHED"
                          else "terrible"),
            })
        elif state in ("SUBMITTED_TO_WORKER", "RETRYING", "RESUBMITTED"):
            out.append({
                "ph": "i", "cat": "sched", "name": f"{ev.get('name','')}:{state}",
                "pid": ev.get("node_id", "node"), "tid": tid, "ts": us, "s": "t",
            })
    out.extend(span_events)
    return out


def dump_timeline(filename: str, events: Optional[List[dict]] = None) -> List[dict]:
    trace = chrome_trace(events)
    with open(filename, "w") as f:
        json.dump(trace, f)
    return trace
