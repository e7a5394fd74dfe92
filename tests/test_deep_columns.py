"""Deep-column handling under the uniform-slab dispatcher.

Columns deeper than the run's slab depth must be scored host-side by
the native exact scorer — never dispatched as their own device shapes
(the run compiles one slab shape) — and their records must be identical
to the all-device path's.  The fixtures' depths are forced "deep" by
pinning a tiny slab depth rather than committing a multi-GB deep BAM.
"""

import numpy as np
import pytest

from somatic_sniper_tpu import runner
from somatic_sniper_tpu.parallel import slab
from somatic_sniper_tpu.utils.stats import STATS


def _records(d, **kw):
    return list(runner.call_pair(
        str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
        precision="fast", **kw,
    ))


@pytest.mark.parametrize("case", ["sim1", "sim2_deep"])
def test_deep_columns_host_scored_same_output(monkeypatch, data_dir, case):
    d = data_dir / "e2e" / case
    baseline = _records(d)

    # slab depth 16: every 30x column becomes "deep" and must take the
    # native exact host path, with byte-identical records (exact values
    # satisfy the fast contract by construction)
    monkeypatch.setenv("SNIPER_SLAB_D", "16")
    s0 = STATS.snapshot()
    got = _records(d)
    s1 = STATS.snapshot()

    assert got == baseline
    deep = s1.get("host_deep_columns", 0) - s0.get("host_deep_columns", 0)
    assert deep > 0, "expected host-scored deep columns with D=16"
    # deep columns must NOT have produced extra device work
    dev = s1.get("device_columns", 0) - s0.get("device_columns", 0)
    scored = s1.get("columns_scored", 0) - s0.get("columns_scored", 0)
    assert dev + deep == scored


def test_mostly_deep_run_host_dominates(monkeypatch, data_dir):
    """With a degenerate slab depth nearly every column goes host-side;
    output must still match and the device must see almost nothing."""
    d = data_dir / "e2e" / "sim2_deep"
    baseline = _records(d)
    monkeypatch.setenv("SNIPER_SLAB_D", "2")
    s0 = STATS.snapshot()
    got = _records(d)
    s1 = STATS.snapshot()
    assert got == baseline
    deep = s1.get("host_deep_columns", 0) - s0.get("host_deep_columns", 0)
    scored = s1.get("columns_scored", 0) - s0.get("columns_scored", 0)
    assert deep >= 0.9 * scored


def test_choose_d():
    assert slab.choose_d(np.array([], np.int32)) is None
    assert slab.choose_d(np.full(100, 30)) == 32
    assert slab.choose_d(np.full(100, 33)) == 48
    assert slab.choose_d(np.full(100, 50)) == 64
    # the tail beyond the coverage quantile does not widen the slab
    dm = np.r_[np.full(999, 40), np.array([5000])]
    assert slab.choose_d(dm) == 48
    # beyond the ladder: clamp to the widest slab (rest goes host-side)
    assert slab.choose_d(np.full(100, 500)) == 128
