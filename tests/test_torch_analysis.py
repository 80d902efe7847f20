"""The reference's static analyzer (scripts/analyze.py, ray_tpu.devtools.
analysis, unedited) over the port, as tests/test_analysis_static.py runs it
over ray_tpu/.

The CLI runs every checker but registry consistency over ray_tpu_torch/
with the port's own baseline (ray_tpu_torch/analysis_baseline.json, every
entry with its reason) and must exit 0: no finding outside the baseline
and no stale entry. The CLI reads its registries from the reference, so
registry consistency runs through the library instead, against the port's
own FAULT_POINTS and SPAN_REGISTRY: every fault point and span the port
uses is declared, and every declared one is used.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_tpu_torch")
BASELINE = os.path.join(PORT, "analysis_baseline.json")


def test_zero_non_baselined_findings_over_the_port():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "analyze.py"),
         "--skip", "registry-consistency", "--baseline", BASELINE,
         "--stats", PORT],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new" in proc.stdout and "0 stale" in proc.stdout, proc.stdout


def test_baseline_entries_are_justified():
    from ray_tpu.devtools.analysis import baseline

    entries = baseline.load(BASELINE)  # raises BaselineError on no reason
    keys = [e.key for e in entries]
    assert len(keys) == len(set(keys)), "duplicate baseline keys"
    assert all(k.split(":")[1].startswith("ray_tpu_torch/") for k in keys)


def test_registries_are_consistent_with_the_ports_own():
    from ray_tpu.devtools import analysis
    from ray_tpu.devtools.analysis import core

    ctx = core.AnalysisContext(root=REPO)
    core.load_registries(ctx, PORT)
    assert {"ckpt_shard_write", "ckpt_commit", "ckpt_restore"} <= \
        set(ctx.fault_points)
    assert {"checkpoint.save", "checkpoint.commit",
            "checkpoint.restore"} <= ctx.span_names
    findings, stats = analysis.run(
        [PORT], analysis.make_checkers(only=["registry-consistency"]),
        root=REPO, ctx=ctx)
    assert stats["files"] > 100, "scan missed most of the package"
    assert not findings, "\n".join(f.render() for f in findings)
