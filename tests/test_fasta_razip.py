"""razip/gzip-compressed reference FASTA support.

The reference consumes razip-compressed FASTA through vendored razf.c
(faidx.c:216) — a gzip-conformant stream with a trailing random-access
index.  This implementation decompresses the members and serves the identical
uncompressed text, so `.fai` offsets and all downstream behavior are
unchanged; trailing index bytes after the gzip stream are ignored.
"""

import gzip
import subprocess
import sys

from somatic_sniper_tpu.io.fasta import FastaFile


def _razipish(raw: bytes) -> bytes:
    """gzip members + fake trailing random-access index (RAZF shape)."""
    return gzip.compress(raw) + b"RAZFIDX" + b"\x00" * 64


def test_fetch_matches_plain(tmp_path, data_dir):
    src = data_dir / "small.fa"
    plain = FastaFile(src)
    gz = tmp_path / "small.fa.razip"
    gz.write_bytes(_razipish(src.read_bytes()))
    comp = FastaFile(gz)
    assert sorted(comp.index) == sorted(plain.index)
    for name in plain.index:
        assert comp.fetch(name) == plain.fetch(name)


def test_fai_persisted_on_build(tmp_path, data_dir, monkeypatch):
    """A freshly built index is saved next to the FASTA (reference
    vendor faidx.c fai_build writes <fa>.fai), so the second open —
    and every later process — parses it instead of re-scanning the
    FASTA (minutes at WGS scale)."""
    fa = tmp_path / "g.fa"
    fa.write_bytes((data_dir / "small.fa").read_bytes())
    first = FastaFile(fa)
    fai = tmp_path / "g.fa.fai"
    assert fai.exists()
    # second open must take the parse path, never the build path
    monkeypatch.setattr(
        FastaFile, "_build_index",
        lambda self: (_ for _ in ()).throw(AssertionError("re-scanned")),
    )
    second = FastaFile(fa)
    assert second.index == first.index
    for name in first.index:
        assert second.fetch(name) == first.fetch(name)


def test_fai_unwritable_dir_still_works(tmp_path, data_dir):
    import os
    import pytest

    if os.geteuid() == 0:
        pytest.skip("root ignores directory write bits")
    fa = tmp_path / "g.fa"
    fa.write_bytes((data_dir / "small.fa").read_bytes())
    tmp_path.chmod(0o555)
    try:
        f = FastaFile(fa)
        assert f.fetch("17") is not None
        assert not (tmp_path / "g.fa.fai").exists()
    finally:
        tmp_path.chmod(0o755)


def test_malformed_fai_one_line_error(tmp_path, data_dir):
    """A truncated/corrupt .fai gives ONE actionable error naming the
    file and the fix (the reference segfaults here — its install FAQ
    documents the crash)."""
    import pytest

    fa = tmp_path / "g.fa"
    fa.write_bytes((data_dir / "small.fa").read_bytes())
    for bad in ("17\t900\t4\n", "17\tNaN\t4\t60\t61\n",
                "17\t900\t4\t60\t2\n"):
        (tmp_path / "g.fa.fai").write_text(bad)
        with pytest.raises(ValueError) as ei:
            FastaFile(fa)
        msg = str(ei.value)
        assert "g.fa.fai" in msg and "delete the .fai" in msg
        assert "line 1" in msg


def test_cli_golden_with_compressed_reference(tmp_path, data_dir):
    gz = tmp_path / "small.fa.gz"
    gz.write_bytes(_razipish((data_dir / "small.fa").read_bytes()))
    out = tmp_path / "out.vcf"
    r = subprocess.run(
        [sys.executable, "-m", "somatic_sniper_tpu.cli.main",
         "-F", "vcf", "-f", str(gz),
         str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam"),
         str(out)],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    strip = lambda b: [
        ln for ln in b.splitlines()
        if not (ln.startswith("##fileDate") or ln.startswith("##reference="))
    ]
    got = strip(out.read_text())
    want = strip((data_dir / "expected.vcf").read_text())
    assert got == want
