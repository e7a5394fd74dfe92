"""Fast-mode output contract, enforced record-by-record.

CLAUDE.md invariant: fast (f32 device) mode makes the same genotype
calls as exact mode; phred-scaled quality values may differ by at most
±1 where an f32 class sum lands on a quantization boundary.  The
reference's own contract test is the golden VCF diff
(reference integration-test/test_sniper.py:19); this generalizes it to
a field-policy diff between fast output and the exact golden across
every e2e fixture x flag combo.

Field policy
  vcf:     CHROM POS ID REF ALT QUAL FILTER INFO FORMAT exact;
           per-sample GT/IGT/DP/DP4/BCOUNT/BQ/MQ/AMQ/SS exact,
           GQ/JGQ/VAQ/SSC within ±1 ('.' must match '.').
  classic: positions/genotypes/depth/dqstats columns exact;
           somatic score + consensus/variant qualities within ±1.
  bed:     somatic score within ±1; everything else exact.

The one tolerated instance ever seen on the reference's integration
pair (GQ 44 vs 45 at 17:260, an f32 boundary of an earlier fused
kernel) is pinned: any OTHER tolerated diff on that pair fails the test.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from somatic_sniper_tpu.cli.main import main
from somatic_sniper_tpu.utils.contract import diff_records as _diff_records
from somatic_sniper_tpu.utils.contract import hist as _hist

# the documented fast-mode quantization classes: phred fields that an
# f32 class-sum boundary can move by exactly one (CLAUDE.md invariant;
# vcf FORMAT names, classic score/cnsq/vaq columns, bed score column)
_ALLOWED_CLASSES = frozenset(
    f"{f}{s}" for s in ("+1", "-1")
    for f in ("GQ", "JGQ", "VAQ", "SSC",
              "col5", "col6", "col7", "col9", "col10", "col4")
)

from .test_e2e import E2E_CASES

FILTER = re.compile(r"##fileDate|##reference=")


def _lines(path: Path) -> list[str]:
    return [
        ln for ln in path.read_text().splitlines()
        if not FILTER.search(ln)
    ]


def _fmt_of(args: list[str]) -> str:
    return args[args.index("-F") + 1]


@pytest.mark.parametrize("case,tag,args", E2E_CASES)
def test_fast_matches_exact_within_contract(data_dir, tmp_path, case, tag,
                                            args):
    d = data_dir / "e2e" / case
    out = tmp_path / f"fast.{tag}"
    rc = main([*args, "--precision", "fast", "-f", str(d / "ref.fa"),
               str(d / "tumor.bam"), str(d / "normal.bam"), str(out)])
    assert rc == 0
    tolerated = _diff_records(
        _lines(out), _lines(d / f"expected.{tag}"), _fmt_of(args)
    )
    # the ±1 boundary cases must stay rare: a drift in the f32 path shows
    # up as a spread of tolerated diffs long before calls change
    assert len(tolerated) <= 2, f"too many ±1 boundary diffs: {tolerated}"
    # and every diff must belong to a DOCUMENTED ±1 quantization class:
    # a new field or a |delta| > 1 is a regression even when rare (the
    # bench records the same histogram as fast_contract_hist)
    assert set(_hist(tolerated)) <= _ALLOWED_CLASSES, (
        f"new fast-mode diff class: {_hist(tolerated)}"
    )


def test_fast_golden_pair_pins_known_gq_diff(data_dir, tmp_path):
    """Integration pair, fast mode, in a pristine subprocess (no x64):
    the only tolerated diff ever observed is GQ 44 vs 45 at 17:260."""
    out = tmp_path / "fast.vcf"
    subprocess.run(
        [sys.executable, "-m", "somatic_sniper_tpu.cli.main",
         "-F", "vcf", "--precision", "fast",
         "-f", str(data_dir / "small.fa"),
         str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam"),
         str(out)],
        check=True, capture_output=True,
    )
    tolerated = _diff_records(
        _lines(out), _lines(data_dir / "expected.vcf"), "vcf"
    )
    for key, name, _a, _b in tolerated:
        assert (key, name) == ("17:260", "GQ"), (
            f"new fast-mode boundary diff: {tolerated}"
        )
