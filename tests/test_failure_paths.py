"""In-process coverage of the failure/fallback paths that only fire
when something goes wrong on a pod: CLI error exits, the collective
merge guards, BAI edge queries, the pure-Python BGZF fallback, and the
BAM writer's block machinery.

These paths previously ran only inside subprocesses (where line
coverage cannot see them) or not at all — untested fallbacks rot.
"""

import gzip
import sys
import types

import numpy as np
import pytest

from somatic_sniper_tpu.cli.main import main
from somatic_sniper_tpu.io import bai as bai_mod
from somatic_sniper_tpu.io import bgzf


# ---------------------------------------------------------------- CLI


def test_cli_missing_ref_exits_1(capsys, data_dir):
    rc = main([str(data_dir / "t-small.bam"),
               str(data_dir / "n-small.bam"), "/tmp/x.out"])
    assert rc == 1
    assert "reference sequence" in capsys.readouterr().err


def test_cli_unreadable_input_exits_1(capsys, data_dir, tmp_path):
    rc = main(["-f", str(data_dir / "small.fa"),
               str(tmp_path / "nope.bam"), str(data_dir / "n-small.bam"),
               str(tmp_path / "x.out")])
    assert rc == 1
    assert "bam-somaticsniper-tpu:" in capsys.readouterr().err


def test_cli_malformed_fai_actionable_error(capsys, data_dir, tmp_path):
    """The task-5 error surfaces through the CLI's fail-fast path."""
    fa = tmp_path / "g.fa"
    fa.write_bytes((data_dir / "small.fa").read_bytes())
    (tmp_path / "g.fa.fai").write_text("17\t900\n")
    rc = main(["-F", "vcf", "-f", str(fa),
               str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam"),
               str(tmp_path / "x.out")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "delete the .fai" in err


def test_cli_jobs_rejects_manifest(capsys, data_dir, tmp_path):
    rc = main(["-f", str(data_dir / "small.fa"), "--jobs", "2",
               "--manifest", str(tmp_path / "m"),
               str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam"),
               str(tmp_path / "x.out")])
    assert rc == 1
    assert "cannot combine" in capsys.readouterr().err


def test_cli_jobs_clamp_and_worker_failure(capsys, data_dir, tmp_path):
    """--jobs above the core count clamps with a warning, and a failing
    worker (bad reference) propagates a nonzero exit with a message."""
    rc = main(["-f", str(tmp_path / "missing.fa"), "--jobs", "99",
               str(data_dir / "e2e/sim1/tumor.bam"),
               str(data_dir / "e2e/sim1/normal.bam"),
               str(tmp_path / "x.out")])
    err = capsys.readouterr().err
    assert rc != 0
    assert "clamped" in err
    assert "worker failed" in err


def test_cli_manifest_resume_in_process(data_dir, tmp_path):
    """A completed run's manifest makes a re-run a no-op resume (all
    windows skipped, output bytes unchanged) — the crash-recovery path
    driven in-process."""
    d = data_dir / "e2e" / "sim1"
    out = tmp_path / "o.vcf"
    man = tmp_path / "m.json"
    args = ["-F", "vcf", "-f", str(d / "ref.fa"), "--window-size",
            "20000", "--manifest", str(man),
            str(d / "tumor.bam"), str(d / "normal.bam"), str(out)]
    assert main(args) == 0
    first = out.read_bytes()
    assert main(args) == 0  # resume: skips every done window
    assert out.read_bytes() == first


def test_cli_stdin_tumor_in_process(data_dir, tmp_path, monkeypatch):
    """'-' tumor reads the BAM from stdin (reference main.c:128), here
    without a subprocess so the spool path counts toward coverage."""
    import io as iomod
    import re

    data = (data_dir / "t-small.bam").read_bytes()
    fake = types.SimpleNamespace(buffer=iomod.BytesIO(data))
    monkeypatch.setattr(sys, "stdin", fake)
    out = tmp_path / "o.vcf"
    rc = main(["-F", "vcf", "-f", str(data_dir / "small.fa"), "-",
               str(data_dir / "n-small.bam"), str(out)])
    assert rc == 0
    strip = lambda p: [ln for ln in p.read_text().splitlines()
                       if not re.search(r"##fileDate|##reference=", ln)]
    assert strip(out) == strip(data_dir / "expected.vcf")


def test_partition_intervals_properties():
    from somatic_sniper_tpu.parallel.sharding import partition_intervals

    lens = [1000, 10, 3000]
    for n in (1, 2, 5, 7):
        shards = partition_intervals(lens, n)
        assert len(shards) == n
        # exact cover: every base of every contig exactly once, in order
        seen = {tid: [] for tid in range(len(lens))}
        for sh in shards:
            for tid, lo, hi in sh:
                assert 0 <= lo < hi <= lens[tid]
                seen[tid].append((lo, hi))
        for tid, spans in seen.items():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == lens[tid]
            for (a1, b1), (a2, _b2) in zip(spans, spans[1:]):
                assert b1 == a2
    # more shards than bases: empty shards allowed, cover still exact
    shards = partition_intervals([3], 8)
    total = sum(hi - lo for sh in shards for _t, lo, hi in sh)
    assert total == 3


def test_bai_python_record_table_fallback(data_dir, monkeypatch):
    """Without the native library the BAI builder falls back to the
    pure-Python record table; the resulting index must match the
    native-built one bin for bin."""
    bam = data_dir / "e2e" / "sim1" / "tumor.bam"
    native_idx = bai_mod.build_index(bam)
    monkeypatch.setattr(bai_mod, "_native_record_table", lambda p: None)
    py_idx = bai_mod.build_index(bam)
    assert len(py_idx.refs) == len(native_idx.refs)
    for rn, rp in zip(native_idx.refs, py_idx.refs):
        assert set(rn.bins) == set(rp.bins)
        for b in rn.bins:
            assert np.array_equal(np.asarray(rn.bins[b]),
                                  np.asarray(rp.bins[b]))
        assert np.array_equal(np.asarray(rn.linear), np.asarray(rp.linear))


def test_run_collective_failure_semantics(monkeypatch, capsys, tmp_path):
    """Every branch of the collective worker wrapper: input errors hard-
    exit 1, runtime/barrier/merge failures hard-exit 3 (shard output
    kept for a manifest resume), the happy path merges and returns
    soft."""
    import somatic_sniper_tpu.cli.main as M
    from somatic_sniper_tpu.parallel import collective

    args = types.SimpleNamespace(output=str(tmp_path / "out.vcf"))

    def run_with(run_exc=None, barrier_exc=None, merge_exc=None):
        monkeypatch.setattr(
            M, "_run",
            lambda *a: (_ for _ in ()).throw(run_exc) if run_exc else 0,
        )
        monkeypatch.setattr(
            collective, "merge_barrier",
            lambda: (_ for _ in ()).throw(barrier_exc)
            if barrier_exc else None,
        )
        monkeypatch.setattr(
            collective, "collective_merge",
            lambda *a, **k: (_ for _ in ()).throw(merge_exc)
            if merge_exc else None,
        )
        args.output = str(tmp_path / "out.vcf")
        return M._run_collective(args, None, None, None, None, 2, 0)

    assert run_with(run_exc=ValueError("bad input")) == (1, True)
    assert "bam-somaticsniper-tpu: bad input" in capsys.readouterr().err

    assert run_with(run_exc=RuntimeError("peer died")) == (3, True)
    assert "distributed run failed" in capsys.readouterr().err

    assert run_with(barrier_exc=RuntimeError("barrier timeout")) \
        == (3, True)
    assert "merge barrier failed" in capsys.readouterr().err

    assert run_with(merge_exc=RuntimeError("gather died")) == (3, True)
    assert "collective merge failed" in capsys.readouterr().err

    assert run_with() == (0, False)
    assert args.output.endswith(".shard0")


# ---------------------------------------------------------- collective


def test_merge_barrier_single_process_noop():
    from somatic_sniper_tpu.parallel.collective import merge_barrier

    merge_barrier()  # no distributed client: returns without error


def test_merge_barrier_waits_on_client(monkeypatch):
    """With a distributed client the barrier waits on it, named and
    bounded by SNIPER_MERGE_TIMEOUT_MS."""
    from jax._src.distributed import global_state

    from somatic_sniper_tpu.parallel import collective

    calls = []

    class _Client:
        def wait_at_barrier(self, name, timeout_ms):
            calls.append((name, timeout_ms))

    monkeypatch.setattr(global_state, "client", _Client())
    monkeypatch.setenv("SNIPER_MERGE_TIMEOUT_MS", "1234")
    collective.merge_barrier()
    assert calls == [("sniper_merge", 1234)]


def test_chunk_bytes_env_parsing(monkeypatch):
    from somatic_sniper_tpu.parallel.collective import (DEFAULT_CHUNK,
                                                        _chunk_bytes)

    monkeypatch.setenv("SNIPER_MERGE_CHUNK", "garbage")
    assert _chunk_bytes() == DEFAULT_CHUNK
    monkeypatch.setenv("SNIPER_MERGE_CHUNK", "10")
    assert _chunk_bytes() == 4096  # floor
    monkeypatch.setenv("SNIPER_MERGE_CHUNK", "65536")
    assert _chunk_bytes() == 65536


def test_merge_timeout_env_parsing(monkeypatch):
    from somatic_sniper_tpu.parallel.collective import merge_barrier

    monkeypatch.setenv("SNIPER_MERGE_TIMEOUT_MS", "not-a-number")
    merge_barrier()  # falls back to the default timeout, still a no-op


# ----------------------------------------------------------------- BAI


def test_reg2bin_member_of_reg2bins():
    """SAM §5.3 invariant: a read's own bin is always among the bins
    that a query overlapping it inspects."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        beg = int(rng.integers(0, 1 << 29))
        end = beg + int(rng.integers(1, 1 << 16))
        assert bai_mod.reg2bin(beg, end) in bai_mod.reg2bins(beg, end)
    # boundary geometry: 16 kb tile edges
    assert bai_mod.reg2bin(0, 1) == bai_mod.reg2bin(0, 1 << 14)
    assert bai_mod.reg2bin(1 << 14, (1 << 14) + 1) != bai_mod.reg2bin(0, 1)


def test_region_chunks_edges(data_dir):
    idx = bai_mod.ensure_index(data_dir / "e2e/sim1/tumor.bam")
    # out-of-range tids
    assert bai_mod.region_chunks(idx, -1, 0, 100) == []
    assert bai_mod.region_chunks(idx, 99, 0, 100) == []
    # query beyond the contig's data: no chunks (or none overlapping)
    far = bai_mod.region_chunks(idx, 0, 1 << 28, (1 << 28) + 100)
    assert far == []
    # merged chunks are sorted and non-overlapping
    got = bai_mod.region_chunks(idx, 0, 0, 1 << 20)
    assert got == sorted(got)
    for (a1, b1), (a2, _b2) in zip(got, got[1:]):
        assert b1 < a2


def test_ensure_index_caches_to_disk(data_dir, tmp_path, monkeypatch):
    src = data_dir / "e2e/sim1/tumor.bam"
    bam = tmp_path / "t.bam"
    bam.write_bytes(src.read_bytes())
    idx1 = bai_mod.ensure_index(bam)
    assert (tmp_path / "t.bam.bai").exists()
    monkeypatch.setattr(
        bai_mod, "build_index",
        lambda p: (_ for _ in ()).throw(AssertionError("rebuilt")),
    )
    idx2 = bai_mod.ensure_index(bam)
    assert len(idx1.refs) == len(idx2.refs)
    for r1, r2 in zip(idx1.refs, idx2.refs):
        assert set(r1.bins) == set(r2.bins)


# ---------------------------------------------------------------- BGZF


def test_bgzf_fallback_roundtrip(data_dir):
    raw = (data_dir / "t-small.bam").read_bytes()
    whole = bgzf.decompress_file(data_dir / "t-small.bam")
    blocks = bgzf.scan_blocks(raw)
    assert int(blocks[:, 1].sum()) == len(raw)
    assert (blocks[1:, 0] == blocks[:-1, 0] + blocks[:-1, 1]).all()
    assert bgzf.decompress_blocks(raw, blocks) == whole
    assert whole[:4] == b"BAM\x01"


def test_bgzf_scan_rejects_non_bgzf():
    with pytest.raises(ValueError, match="bad gzip magic"):
        bgzf.scan_blocks(b"not a gzip stream")
    # plain gzip (no BC subfield) is not BGZF
    with pytest.raises(ValueError, match="missing BC"):
        bgzf.scan_blocks(gzip.compress(b"plain gzip data"))


def test_bgzf_eof_block_is_valid_empty_block():
    blocks = bgzf.scan_blocks(bgzf.BGZF_EOF)
    assert len(blocks) == 1
    assert bgzf.decompress_blocks(bgzf.BGZF_EOF, blocks) == b""


# ---------------------------------------------------------- BAM writer


def test_bgzf_compress_multi_block_scan():
    from somatic_sniper_tpu.io.bam_writer import bgzf_compress

    data = bytes(range(256)) * 1024  # 256 KiB -> several BGZF blocks
    comp = bgzf_compress(data, block_size=0xFF00)
    blocks = bgzf.scan_blocks(comp)
    assert len(blocks) >= 4
    assert bgzf.decompress_blocks(comp, blocks) == data


def test_encode_record_features_roundtrip(tmp_path):
    """Reverse strand, clips, '='/X ops and multi-op CIGARs survive a
    write -> native-load round trip (depths seen by the pileup)."""
    from somatic_sniper_tpu.io import native_api
    from somatic_sniper_tpu.io.bam_writer import encode_record, write_bam

    recs = [
        encode_record(0, 10, 60, 0, "ACGTACGTAC", bytes([30] * 10),
                      [(4, "S"), (6, "M")], read_name="fwd"),
        encode_record(0, 20, 13, 1, "ACGTACGTAC", bytes([25] * 10),
                      [(5, "="), (1, "X"), (4, "M")], read_name="rev"),
        encode_record(0, 40, 7, 0, "ACGT", bytes([20] * 4),
                      [(2, "M"), (3, "D"), (2, "M")], read_name="del"),
    ]
    bam = tmp_path / "feat.bam"
    write_bam(bam, ["c1"], [1000], recs)
    header, pu = native_api.load_and_columnize(str(bam))
    assert header.ref_names == ["c1"]
    assert len(pu.ukeys) > 0
    # the deletion span contributes deletion entries, not bases
    keys = np.asarray(pu.ukeys)
    poss = keys & ((1 << 40) - 1)
    assert set(range(40, 47)).issubset(set(poss.tolist()))
