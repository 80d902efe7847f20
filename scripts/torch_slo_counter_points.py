"""The SLO-burn part of ``chip_smoke.py``'s ``serve_slo`` phase, once, with
the counter points the availability objective reads.

The phase runs as it does in the whole script (GPT-2 124M, one card). After
its burn traffic this prints, as JSON lines: the points of the
``serve_requests_total`` and ``serve_request_errors_total`` series from one
second before the first error to one second after it (times from the first
error), and for every sample of the request total whose fast window lies
wholly in the error part, the window's events and bad fraction as the
aggregator reads them, and again with the error series' first point at 0
left out (how the series stood before the aggregator seeded a newborn
counter at the registry's previous sample). A read further than 0.05 from
the share of errors sent is what the phase's gate fails on.

    python3 scripts/torch_slo_counter_points.py
"""

import bisect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def window_sum(ts, vs, start, end):
    """A counter's increase over the window ending at ``end``, as
    ``TimeSeriesAggregator.window_sum`` reads it there."""
    n = bisect.bisect_right(ts, end)
    ts, vs = ts[:n], vs[:n]
    i = max(bisect.bisect_left(ts, start) - 1, 0)
    return sum(max(0.0, vs[k] - vs[k - 1])
               for k in range(i + 1, len(ts)) if ts[k] >= start)


def main() -> int:
    from ray_tpu_torch._private import kernel_build
    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    print(chip_smoke.card_line(), flush=True)
    kernel_build.build()
    logs = []
    points = {}
    traffic = chip_smoke._traffic
    disable = tracing.disable_tracing

    def logged(url, bodies, clients, seconds):
        log = traffic(url, bodies, clients, seconds)
        logs.append((url, log))
        return log

    def snapshot():
        # The phase turns tracing off right after its burn traffic, before
        # its gates.
        if not points and any(u.endswith("/gpt2burn") for u, _ in logs):
            for name in ("serve_requests_total",
                         "serve_request_errors_total"):
                for s in get_aggregator()._match(name, None):
                    if "gpt2burn" in s.tags.get("deployment", ""):
                        points[name] = (list(s.ts), list(s.values))
        return disable()

    chip_smoke._traffic = logged
    tracing.disable_tracing = snapshot
    try:
        chip_smoke.phase_serve_slo(chip_smoke.serve_weights())
        status = "passed"
    except SystemExit:
        status = "failed"
    log_err = [lg for u, lg in logs if u.endswith("/gpt2burn")][0]
    errors = [(sent, done) for j, sent, done, _, _ in log_err if j % 3 == 2]
    t0 = min(sent for sent, _ in errors)
    t1 = max(done for _, done in errors)
    share = len(errors) / len(log_err)
    tt, tv = points["serve_requests_total"]
    et, ev = points["serve_request_errors_total"]
    print(json.dumps({"phase": status, "share_sent": share,
                      "total_points": [(t - t0, v) for t, v in zip(tt, tv)
                                       if -1.0 < t - t0 < 1.0],
                      "error_points": [(t - t0, v) for t, v in zip(et, ev)
                                       if t - t0 < 1.0]}), flush=True)
    seeded = ev[0] == 0.0
    fast = 2.0
    reads = []
    for t in tt:
        if not t0 + fast <= t <= t1:
            continue
        total = window_sum(tt, tv, t - fast, t)
        bad = window_sum(et, ev, t - fast, t) / total
        unseeded = (window_sum(et[1:], ev[1:], t - fast, t) / total
                    if seeded else bad)
        reads.append({"t": t - t0, "events": total, "bad": bad,
                      "bad_unseeded": unseeded})
    print(json.dumps({
        "reads": reads,
        "off": sum(abs(r["bad"] - share) > 0.05 for r in reads),
        "off_unseeded": sum(abs(r["bad_unseeded"] - share) > 0.05
                            for r in reads)}), flush=True)
    return 0 if status == "passed" else 1


if __name__ == "__main__":
    sys.exit(main())
