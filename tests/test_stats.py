"""Observability counters (utils/stats.py)."""

from __future__ import annotations

import time

from somatic_sniper_tpu.utils.stats import RunStats


def test_timer_and_counters():
    s = RunStats()
    with s.timer("stage_a"):
        time.sleep(0.01)
    with s.timer("stage_a"):
        pass
    s.add("things", 3)
    s.add("things", 2)
    assert s.calls["stage_a"] == 2
    assert s.seconds["stage_a"] >= 0.01
    assert s.counts["things"] == 5
    out = s.summary()
    assert "stage_a" in out and "things" in out
    s.reset()
    assert not s.seconds and not s.counts


def test_cli_stats_flag(tmp_path):
    """--stats prints the per-stage summary to stderr."""
    import subprocess
    import sys
    from pathlib import Path

    data = Path(__file__).parent / "data"
    out = tmp_path / "o.vcf"
    r = subprocess.run(
        [sys.executable, "-m", "somatic_sniper_tpu.cli.main", "--stats",
         "-F", "vcf", "-f", str(data / "small.fa"),
         str(data / "t-small.bam"), str(data / "n-small.bam"), str(out)],
        capture_output=True, text=True, check=True,
    )
    assert "[sniper-tpu stats]" in r.stderr
    assert "records_emitted" in r.stderr


def test_trace_busy_union_and_missing_trace(tmp_path):
    """The trace reduction's busy time is the union of overlapping
    kernel intervals; a directory with no trace is an error."""
    from tests.tools.trace_device_time import _union_s, main

    assert _union_s([(30, 40), (0, 10), (5, 20), (12, 15)]) == 30e-9
    assert _union_s([]) == 0.0
    assert main([str(tmp_path)]) == 1
