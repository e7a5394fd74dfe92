#!/usr/bin/env python
"""WGS-scale soak for the windowed streaming driver.

Runs the CLI over a large (default 100 Mb) synthetic 30x pair with
--jobs 2, sampling the process tree's RSS throughout, then a
single-process run, then a SIGKILL-at-~50% + manifest-resume run, and
checks:

  * the --jobs output is byte-identical to the single-process output
    (modulo ##fileDate/##reference)
  * the killed-and-resumed run's final output is byte-identical too
    (crash consistency of the per-window manifest)
  * RSS stays flat across the run (streaming, not genome-proportional):
    the median of the last third of samples must be < 1.5x the median
    of samples taken after the first 20% of the run

Prints columns/s for all runs.  Usage:

    python tests/tools/wgs_soak.py [pair_dir] [--keep] [--size-mb N]

--size-mb sets the genome size (default 100; 500+ for the long soak).
The pair is generated with utils.simulate.simulate_pair_fast if absent.
"""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

FILTER = re.compile(rb"##fileDate|##reference=")


def ensure_pair(d: Path, contig_len: int) -> None:
    if (d / "ref.fa.fai").exists():
        return
    from somatic_sniper_tpu.utils.simulate import (SimConfig,
                                                   simulate_pair_fast)

    print(f"generating {2 * contig_len / 1e6:.0f} Mb pair at {d} ...",
          flush=True)
    simulate_pair_fast(d, SimConfig(n_contigs=2, contig_len=contig_len,
                                    mean_depth=30.0, seed=11))


def _tree_rss_kb(pid: int) -> int:
    """RSS of pid + descendants, from /proc (no psutil dependency)."""
    total = 0
    pids = [pid]
    try:
        children = {}
        for p in os.listdir("/proc"):
            if not p.isdigit():
                continue
            try:
                stat = Path(f"/proc/{p}/stat").read_text().split()
                children.setdefault(int(stat[3]), []).append(int(p))
            except OSError:
                continue
        while pids:
            q = pids.pop()
            try:
                for line in Path(f"/proc/{q}/status").read_text().splitlines():
                    if line.startswith("VmRSS:"):
                        total += int(line.split()[1])
                        break
            except OSError:
                continue
            pids.extend(children.get(q, []))
    except OSError:
        pass
    return total


def run_sampled(cmd: list[str], kill_after: float | None = None):
    """(wall, rss_samples, killed) — optionally SIGKILL the whole
    process group at ``kill_after`` seconds (crash injection)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                            start_new_session=True)
    samples, killed = [], False
    while proc.poll() is None:
        samples.append(_tree_rss_kb(proc.pid))
        if kill_after is not None and time.time() - t0 > kill_after:
            os.killpg(proc.pid, signal.SIGKILL)
            killed = True
            proc.wait()
            break
        time.sleep(2)
    if not killed and proc.returncode != 0:
        raise SystemExit(f"run failed rc={proc.returncode}: {cmd}")
    return time.time() - t0, samples, killed


def filtered_bytes(path: Path) -> bytes:
    return b"\n".join(
        ln for ln in path.read_bytes().split(b"\n") if not FILTER.search(ln)
    )


def main() -> None:
    argv = sys.argv[1:]
    size_mb = 100
    if "--size-mb" in argv:
        i = argv.index("--size-mb")
        size_mb = int(argv[i + 1])
        del argv[i : i + 2]
    args = [a for a in argv if not a.startswith("--")]
    d = Path(args[0]) if args else (
        Path(__file__).resolve().parents[2] / ".bench_data"
        / f"pair_{size_mb}mb"
    )
    ensure_pair(d, size_mb * 1_000_000 // 2)
    genome = sum(
        int(l.split("\t")[1])
        for l in (d / "ref.fa.fai").read_text().splitlines()
    )

    # one-time .bai builds up front: both timed runs need them and the
    # first would otherwise pay (and its workers would build them
    # concurrently, doubling peak RSS)
    from somatic_sniper_tpu.io import bai

    for b in ("tumor.bam", "normal.bam"):
        t0 = time.time()
        bai.ensure_index(str(d / b))
        print(f"index {b}: {time.time() - t0:.1f}s", flush=True)

    base = [sys.executable, "-m", "somatic_sniper_tpu.cli.main",
            "-F", "vcf", "-f", str(d / "ref.fa"),
            str(d / "tumor.bam"), str(d / "normal.bam")]
    out2 = d / "out.jobs2.vcf"
    out1 = d / "out.jobs1.vcf"

    wall2, rss2, _ = run_sampled(base[:-1] + ["--jobs", "2",
                                              base[-1], str(out2)])
    print(f"--jobs 2: {wall2:.1f}s  ({genome / wall2 / 1e6:.2f}M cols/s)  "
          f"peak RSS {max(rss2) / 1e6:.2f} GB", flush=True)

    wall1, rss1, _ = run_sampled(base[:-1] + [base[-1], str(out1)])
    print(f"single  : {wall1:.1f}s  ({genome / wall1 / 1e6:.2f}M cols/s)  "
          f"peak RSS {max(rss1) / 1e6:.2f} GB", flush=True)

    assert filtered_bytes(out1) == filtered_bytes(out2), \
        "--jobs 2 merge differs from single-process output"
    print("outputs byte-identical", flush=True)

    # crash consistency: SIGKILL the whole process tree at ~50% of the
    # measured wall, then resume from the per-window manifest; the
    # final bytes must equal the uninterrupted run
    out_r = d / "out.resume.vcf"
    man = d / "resume.manifest.jsonl"
    for p in (out_r, man):
        if p.exists():
            p.unlink()
    cmd_r = base[:-1] + ["--manifest", str(man), base[-1], str(out_r)]
    t_kill = max(5.0, wall1 * 0.5)
    w_a, _, killed = run_sampled(cmd_r, kill_after=t_kill)
    assert killed, "kill phase finished before the injection point"
    print(f"killed at {w_a:.1f}s (~50%); resuming ...", flush=True)
    w_b, rss_r, _ = run_sampled(cmd_r)
    assert filtered_bytes(out_r) == filtered_bytes(out1), \
        "resumed output differs from the uninterrupted run"
    print(f"resume  : {w_b:.1f}s  resumed output byte-identical",
          flush=True)
    out_r.unlink()
    man.unlink()

    for label, rss in (("jobs2", rss2), ("single", rss1)):
        # The streaming invariant is "RSS stops growing", measured
        # post-ramp: startup (BAI load + pipeline fill) takes a roughly
        # FIXED ~30 s regardless of run length, so anchoring "early" at
        # a percentage of the run misreads fast runs (an anchor inside
        # the ramp makes steady state look like growth).  Compare the
        # middle third against the last third instead — both are past
        # the ramp on any run long enough to say anything.
        body = rss[max(2, len(rss) // 5):]
        if len(body) >= 9:
            mid = sorted(body[len(body) // 3: 2 * len(body) // 3])
            late = sorted(body[-len(body) // 3:])
            m_mid = mid[len(mid) // 2]
            m_late = late[len(late) // 2]
            assert m_late < 1.3 * m_mid + 2e5, (
                f"{label}: RSS grows {m_mid} -> {m_late} kB"
            )
            print(f"{label}: RSS flat ({m_mid / 1e6:.2f} -> "
                  f"{m_late / 1e6:.2f} GB median)", flush=True)

    if "--keep" not in sys.argv:
        out1.unlink()
        out2.unlink()
    print("SOAK PASS")


if __name__ == "__main__":
    main()
