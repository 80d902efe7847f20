"""Head-side crash forensics: postmortem bundles from flight-recorder dumps
(the counterpart of ``ray_tpu/util/forensics.py``).

Per-process :mod:`~ray_tpu_torch.util.flight_recorder` dumps capture what one
process saw in its final seconds; this module assembles the cluster-level
story.  ``build_bundle()`` merges every dump under
``<session>/postmortems/`` with the head's recent
:class:`~ray_tpu_torch.util.metrics_agent.TimeSeriesAggregator` window and
the :mod:`~ray_tpu_torch.train.run_registry` state into one postmortem
bundle — served by ``/api/postmortems`` and
:func:`ray_tpu_torch.util.state.list_postmortems`, and exportable as a
fused Perfetto timeline (one lane per dumped process, instant markers at
deaths, stalls and dump triggers — see
:func:`ray_tpu_torch._private.profiling.postmortem_chrome_events`).  A
bundle also embeds the device-telemetry snapshot
(:func:`ray_tpu_torch.util.device_telemetry.snapshot`), None only when
that snapshot fails.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util.flight_recorder import postmortem_dir


def list_postmortems() -> List[Dict[str, Any]]:
    """Index rows for every dump in the session's postmortem dir, newest
    first: ``{"id", "pid", "reason", "ts", "ring_events", "stalls",
    "tracing_active", "path"}``.  The id is the filename stem and is what
    :func:`load_postmortem` / the CLI / ``/api/postmortems`` key on."""
    d = postmortem_dir()
    rows: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return rows
    for fn in names:
        if not fn.endswith(".json"):
            continue
        path = os.path.join(d, fn)
        try:
            with open(path) as f:
                dump = json.load(f)
        except (OSError, ValueError):
            continue  # torn write from a dying process; skip, don't fail
        ring = dump.get("ring", [])
        extra = dump.get("extra") or {}
        rows.append({
            "id": fn[:-len(".json")],
            "pid": dump.get("pid"),
            "reason": dump.get("reason"),
            "ts": dump.get("ts"),
            "ring_events": len(ring),
            "stalls": sum(1 for r in ring if r.get("kind") == "stall"),
            "tracing_active": dump.get("tracing_active", False),
            # Node attribution when the trigger recorded one (actor_death
            # etc.) — what the cluster autoscaler's quarantine gate keys on.
            "node": str(extra.get("node") or "") or None,
            "path": path,
        })
    rows.sort(key=lambda r: r.get("ts") or 0.0, reverse=True)
    return rows


def load_postmortem(pm_id: str) -> Optional[Dict[str, Any]]:
    """Full dump payload for one id (filename stem), or None."""
    if os.sep in pm_id or pm_id.startswith("."):
        return None  # ids are filename stems, not paths
    path = os.path.join(postmortem_dir(), pm_id + ".json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build_bundle(*, window_s: float = 300.0,
                 now: Optional[float] = None) -> Dict[str, Any]:
    """Merge every per-process dump with the head's recent aggregator
    window and the run registry into one postmortem bundle."""
    t = time.time() if now is None else now
    dumps = []
    for row in list_postmortems():
        dump = load_postmortem(row["id"])
        if dump is not None:
            dump["id"] = row["id"]
            dumps.append(dump)
    bundle: Dict[str, Any] = {
        "schema": 1,
        "generated_ts": t,
        "window_s": window_s,
        "dumps": dumps,
        "stalls": [r for d in dumps for r in d.get("ring", [])
                   if r.get("kind") == "stall"],
    }
    # Head-side recent time series (the cluster view the dying process
    # could not see) — fold live counters in first so the window is fresh.
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry(ts=t)
    bundle["timeseries"] = agg.snapshot(since=t - window_s)
    # Run registry: probe sys.modules instead of importing — if the train
    # package was never imported, there are no runs to report (same idiom
    # as util.state.list_train_runs).
    reg = sys.modules.get("ray_tpu_torch.train.run_registry")
    bundle["train_runs"] = reg.list_runs() if reg is not None else []
    # Device telemetry snapshot (compile registry tail, pool high-water,
    # transfer window, device memory) next to the ring/stacks sections.
    # Absorbed: a telemetry failure (incl. the device_telemetry_snapshot
    # chaos point) must never cost the bundle its other sections.
    try:
        from ray_tpu_torch.util import device_telemetry

        bundle["device_telemetry"] = device_telemetry.snapshot(now=t)
    except Exception:
        bundle["device_telemetry"] = None
    return bundle


def bundle_chrome_trace(bundle: Dict[str, Any]) -> List[dict]:
    """Fused Perfetto timeline for a bundle (one lane per dumped process,
    death/stall markers) — load at ui.perfetto.dev."""
    from ray_tpu_torch._private.profiling import postmortem_chrome_events

    return postmortem_chrome_events(bundle)
