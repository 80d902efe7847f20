"""On-demand heap profiling via tracemalloc (the counterpart of
``ray_tpu/_private/heap_profiler.py``; ref:
python/ray/dashboard/modules/reporter/profile_manager.py — on-demand heap
profiling of any worker from the dashboard).

tracemalloc gives allocation-site attribution for this process, which hosts
every thread-tier worker.  The first call starts tracing, so only
allocations AFTER that are attributed; reported through ``/api/memory``.
Device memory is not in it: ``torch.cuda.memory_allocated()`` reads that.
"""

from __future__ import annotations

import tracemalloc
from typing import Dict, List


def ensure_tracing(nframes: int = 16) -> bool:
    """Idempotently start tracemalloc; returns True if it was ALREADY on
    (i.e. the snapshot below covers a real window, not an empty one)."""
    if tracemalloc.is_tracing():
        return True
    tracemalloc.start(nframes)
    return False


def heap_summary(top_n: int = 20, group_by: str = "lineno") -> Dict:
    """Top allocation sites since tracing began (ref: memray table view)."""
    was_tracing = ensure_tracing()
    current, peak = tracemalloc.get_traced_memory()
    stats: List[Dict] = []
    if was_tracing:
        snapshot = tracemalloc.take_snapshot()
        for stat in snapshot.statistics(group_by)[:top_n]:
            frame = stat.traceback[0]
            stats.append({
                "site": f"{frame.filename}:{frame.lineno}",
                "size_bytes": stat.size,
                "count": stat.count,
            })
    return {
        "tracing_window_open": not was_tracing,
        "traced_current_bytes": current,
        "traced_peak_bytes": peak,
        "top_sites": stats,
    }
