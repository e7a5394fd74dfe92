"""Slab-depth selection robustness (parallel.slab).

Round-3 pinned the slab depth D from the FIRST non-empty window; a
shallow unrepresentative first window (low-coverage telomere) silently
locked a small D and routed every deeper column of the run to the
host-side exact scorer — correct output, invisible perf cliff.  The
dispatcher now samples several windows before pinning and may upgrade D
once mid-run when the host-deep fraction shows the pick was wrong.
This fixture builds that adversarial shape deliberately: contig one at
~6x, contig two at ~90x.
"""

from pathlib import Path

import numpy as np
import pytest

from somatic_sniper_tpu.io.bam_writer import encode_record, write_bam
from somatic_sniper_tpu.parallel import slab as slab_mod
from somatic_sniper_tpu.parallel.sharded import call_pair_windows
from somatic_sniper_tpu.utils.contract import diff_records
from somatic_sniper_tpu.utils.stats import STATS

BASES = "ACGT"
READ_LEN = 60
CONTIG_LEN = 40_000
VAR_STRIDE = 503  # somatic SNV every ~503 bp


def _contig_seq(rng) -> str:
    return "".join(BASES[i] for i in rng.integers(0, 4, CONTIG_LEN))


def _reads(seq: str, depth: int, tumor: bool, rng):
    """Sorted 60M reads at uniform coverage; tumor reads carry a 50% VAF
    alt at every VAR_STRIDE-th position."""
    n = CONTIG_LEN * depth // READ_LEN
    starts = np.sort((np.arange(n) * (CONTIG_LEN - READ_LEN)) // max(n - 1, 1))
    var_pos = set(range(VAR_STRIDE, CONTIG_LEN - READ_LEN, VAR_STRIDE))
    out = []
    for i, s in enumerate(starts.tolist()):
        bases = list(seq[s:s + READ_LEN])
        if tumor and i % 2 == 0:
            for j, p in enumerate(range(s, s + READ_LEN)):
                if p in var_pos:
                    bases[j] = BASES[(BASES.index(bases[j]) + 1) % 4]
        out.append((s, "".join(bases), 16 if i % 2 else 0))
    return out


def _build_pair(d: Path):
    rng = np.random.default_rng(99)
    seqs = [_contig_seq(rng), _contig_seq(rng)]
    names = ["shal", "deep"]
    depths = [6, 90]
    with open(d / "ref.fa", "w") as fh:
        for nm, sq in zip(names, seqs):
            fh.write(f">{nm}\n")
            for i in range(0, CONTIG_LEN, 60):
                fh.write(sq[i:i + 60] + "\n")
    # uniform line geometry -> simple .fai
    off, fai = 0, []
    for nm in names:
        off += len(nm) + 2
        fai.append(f"{nm}\t{CONTIG_LEN}\t{off}\t60\t61")
        off += CONTIG_LEN + CONTIG_LEN // 60
    (d / "ref.fa.fai").write_text("\n".join(fai) + "\n")
    qual = bytes([30]) * READ_LEN
    for sample, tumor in (("tumor", True), ("normal", False)):
        recs = []
        for tid, (sq, dep) in enumerate(zip(seqs, depths)):
            for k, (s, bases, flag) in enumerate(
                _reads(sq, dep, tumor, rng)
            ):
                recs.append(encode_record(
                    tid, s, 50, flag, bases, qual, [(READ_LEN, "M")],
                    read_name=f"r{tid}_{k}",
                ))
        write_bam(d / f"{sample}.bam", names,
                  [CONTIG_LEN, CONTIG_LEN], recs)


@pytest.fixture(scope="module")
def shallow_first_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("shallow_first")
    _build_pair(d)
    return d


def _lines(d, precision, window_size=10_000):
    out = []
    for _wi, _w, lines in call_pair_windows(
        str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
        precision=precision, fmt="vcf", window_size=window_size,
    ):
        out.extend(lines)
    return out


def test_shallow_first_window_upgrades_depth(
    monkeypatch, capfd, shallow_first_pair
):
    d = shallow_first_pair
    exact = _lines(d, "exact")
    assert exact, "fixture must emit records"

    # small evidence thresholds so the tiny fixture crosses them
    monkeypatch.setattr(slab_mod, "D_SAMPLE_COLS", 64)
    s0 = STATS.snapshot()
    fast = _lines(d, "fast")
    s1 = STATS.snapshot()

    # output contract holds through the mid-run shape change
    diff_records(fast, exact, "vcf")

    err = capfd.readouterr().err
    assert "upgrading slab depth" in err, err
    # the upgrade must actually move deep-contig columns onto the device
    deep = s1.get("host_deep_columns", 0) - s0.get("host_deep_columns", 0)
    dev = s1.get("device_columns", 0) - s0.get("device_columns", 0)
    scored = s1.get("columns_scored", 0) - s0.get("columns_scored", 0)
    assert dev + deep == scored
    assert deep < 0.6 * scored, (deep, dev, scored)
    assert dev > 0


def test_shallow_first_window_no_upgrade_still_correct(
    monkeypatch, shallow_first_pair
):
    """With upgrade evidence thresholds out of reach, the run keeps the
    shallow D and host-scores the deep tail — output must still hold."""
    d = shallow_first_pair
    exact = _lines(d, "exact")
    monkeypatch.setattr(slab_mod, "D_SAMPLE_COLS", 10**9)
    fast = _lines(d, "fast")
    diff_records(fast, exact, "vcf")


def test_small_run_host_dispatch_threshold(monkeypatch, data_dir):
    """Below SNIPER_DEVICE_MIN_COLS the whole-file fast driver scores
    host-side; records must satisfy the contract and nothing may reach
    the device."""
    from somatic_sniper_tpu import runner

    d = data_dir / "e2e" / "sim1"
    args = (str(d / "tumor.bam"), str(d / "normal.bam"),
            str(d / "ref.fa"))
    baseline = list(runner.call_pair(*args, precision="fast", fmt="vcf"))

    monkeypatch.setenv("SNIPER_DEVICE_MIN_COLS", "1000000")
    s0 = STATS.snapshot()
    got = list(runner.call_pair(*args, precision="fast", fmt="vcf"))
    s1 = STATS.snapshot()
    # exact host values satisfy the fast contract with zero drift, but
    # phreds may differ from the device f32 path by the contract's +/-1
    diff_records(got, baseline, "vcf")
    dev = s1.get("device_columns", 0) - s0.get("device_columns", 0)
    assert dev == 0, "threshold run must not dispatch to the device"


def test_device_min_cols_default_zero(monkeypatch):
    """Without SNIPER_DEVICE_MIN_COLS every fast run dispatches to the
    device (threshold 0); an explicit value wins, garbage reads as 0."""
    from somatic_sniper_tpu import runner

    monkeypatch.delenv("SNIPER_DEVICE_MIN_COLS", raising=False)
    assert runner._device_min_cols() == 0
    monkeypatch.setenv("SNIPER_DEVICE_MIN_COLS", "123")
    assert runner._device_min_cols() == 123
    monkeypatch.setenv("SNIPER_DEVICE_MIN_COLS", "lots")
    assert runner._device_min_cols() == 0


def test_pinned_d_never_upgrades(monkeypatch, capfd, shallow_first_pair):
    """An explicit SNIPER_SLAB_D override must never be second-guessed."""
    d = shallow_first_pair
    exact = _lines(d, "exact")
    monkeypatch.setattr(slab_mod, "D_SAMPLE_COLS", 64)
    monkeypatch.setenv("SNIPER_SLAB_D", "16")
    fast = _lines(d, "fast")
    diff_records(fast, exact, "vcf")
    assert "upgrading slab depth" not in capfd.readouterr().err
