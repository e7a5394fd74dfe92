#!/usr/bin/env python
"""End-to-end throughput benchmark: pileup columns/sec through the full
caller (BAM decode -> native pileup -> device kernel -> emitted records).

Prints one JSON line whose headline fields keep the original contract:

  {"metric": "pileup_columns_per_sec", "value": N, "unit": "columns/s",
   "vs_baseline": N, ...}

plus per-mode numbers so device-path regressions can't hide behind a
best-of (exact = all-host bit-identical scoring; fast = the f32 device
path):

  exact_cols_per_sec / fast_cols_per_sec            -- 200 kb pair
  exact_10mb_cols_per_sec / fast_10mb_cols_per_sec  -- 10 Mb windowed
  fast_contract_ok / fast_contract_diffs -- on-device fast-vs-exact
      field diff under the ±1 contract (utils.contract)
  host_blocked_on_device_frac_10mb -- fraction of the fast 10 Mb wall
      the host spent BLOCKED on device fetches (not chip occupancy)
  device_cols_per_sec -- device-dispatched columns / (pad+dispatch +
      blocked-fetch seconds): the host-visible cost of using the chip
  kernel_cols_per_sec -- on-device kernel rate at the production slab
      shape via a chained fori_loop microbench (utils.mfu)
  device -- platform, device_kind and count the device phases ran on

The baseline is the reference C implementation (bam-somaticsniper) on the
same synthetic 2x200kb 30x tumor/normal pair.  If a reference binary is
present at $SNIPER_REF_BIN or /tmp/ref/bam-somaticsniper it is timed live
on this host; otherwise a recorded measurement (RECORDED_REF_COLS_PER_SEC)
is used.

Exact and fast are timed ALTERNATED in the SAME process (see
_interleaved_phase_body) so both modes see the same host conditions, and
the JSON carries medians + whole-process CPU per mode alongside the
best-of headline.  Every device phase runs in a subprocess with
``JAX_PLATFORMS=cuda``, so the parent never opens the card and a host
without one fails instead of timing the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(os.environ.get(
    "SNIPER_BENCH_DIR", Path(__file__).resolve().parent / ".bench_data"
))
# Reference throughput measured on a 2 vCPU Xeon 2.1 GHz host:
# 399,980 shared columns in 3.08 s wall = 129.9k columns/s (includes its
# ~1.2 s table startup, same as our timing includes ours).
RECORDED_REF_COLS_PER_SEC = 129_900.0


def ensure_data() -> Path:
    d = BENCH_DIR / "pair_v1"
    if (d / "ref.fa.fai").exists():
        return d
    print("bench: generating synthetic pair (one-time)...", file=sys.stderr)
    from somatic_sniper_tpu.utils.simulate import SimConfig, simulate_pair

    simulate_pair(d, SimConfig(n_contigs=2, contig_len=200_000,
                               mean_depth=30.0, seed=7))
    _write_fai(d / "ref.fa")
    return d


def ensure_data_10mb() -> Path:
    d = BENCH_DIR / "pair_10mb"
    if (d / "ref.fa.fai").exists():
        return d
    print("bench: generating 10 Mb pair (one-time)...", file=sys.stderr)
    from somatic_sniper_tpu.utils.simulate import (SimConfig,
                                                   simulate_pair_fast)

    simulate_pair_fast(d, SimConfig(n_contigs=2, contig_len=5_000_000,
                                    mean_depth=30.0, seed=11))
    return d


def _write_fai(fa: Path) -> None:
    data = fa.read_bytes()
    lines, pos = [], 0
    while pos < len(data):
        eol = data.find(b"\n", pos)
        name = data[pos + 1 : eol].decode().split()[0]
        seq_off = eol + 1
        p, length, lb, lw = seq_off, 0, 0, 0
        while p < len(data) and data[p : p + 1] != b">":
            e2 = data.find(b"\n", p)
            e2 = len(data) if e2 == -1 else e2
            if lb == 0 and e2 > p:
                lb, lw = e2 - p, e2 - p + 1
            length += e2 - p
            p = e2 + 1
        lines.append(f"{name}\t{length}\t{seq_off}\t{lb}\t{lw}")
        pos = p
    Path(str(fa) + ".fai").write_text("\n".join(lines) + "\n")


def count_columns(d: Path) -> int:
    from somatic_sniper_tpu.io import native_api
    import numpy as np

    _, pu_t = native_api.load_and_columnize(str(d / "tumor.bam"))
    _, pu_n = native_api.load_and_columnize(str(d / "normal.bam"))
    return len(np.intersect1d(pu_t.ukeys, pu_n.ukeys, assume_unique=True))


def _interleaved_phase_body(d200: Path, d10: Path) -> dict:
    """Both modes, ALTERNATED run-for-run in one process (the bounded
    subprocess of time_interleaved_phases).

    Alternating the modes inside one process gives both the same host
    conditions, and the medians + whole-process CPU per mode make the
    comparison robust to CPU steal: a noise spike shows up as
    wall>>cpu/2 on both modes alike."""
    import statistics as st

    from somatic_sniper_tpu.parallel.sharded import call_pair_windows
    from somatic_sniper_tpu.runner import call_pair
    from somatic_sniper_tpu.utils.stats import STATS

    a200 = (str(d200 / "tumor.bam"), str(d200 / "normal.bam"),
            str(d200 / "ref.fa"))
    a10 = (str(d10 / "tumor.bam"), str(d10 / "normal.bam"),
           str(d10 / "ref.fa"))

    def run200(mode):
        t0 = time.time()
        lines = list(call_pair(*a200, precision=mode, fmt="vcf"))
        return time.time() - t0, lines

    def run10(mode, keep=False):
        t0 = time.time()
        c0 = time.process_time()
        out = []
        for _wi, _w, lines in call_pair_windows(*a10, precision=mode,
                                                fmt="vcf"):
            if keep:
                out.extend(lines)
        return time.time() - t0, time.process_time() - c0, out

    # warmups: compile + the per-process first-execute of each shape
    _, fast200_lines = run200("fast")
    _, exact200_lines = run200("exact")
    _, _, fast10_lines = run10("fast", keep=True)
    _, _, exact10_lines = run10("exact", keep=True)

    walls: dict = {k: [] for k in ("e200", "f200", "e10", "f10")}
    cpus: dict = {"e10": [], "f10": []}
    dev = {}
    for _ in range(int(os.environ.get("SNIPER_BENCH_REPS200", "4"))):
        for mode, key in (("exact", "e200"), ("fast", "f200")):
            walls[key].append(run200(mode)[0])
    best_fast = float("inf")
    for _ in range(int(os.environ.get("SNIPER_BENCH_REPS10", "3"))):
        for mode, key in (("exact", "e10"), ("fast", "f10")):
            s0 = STATS.snapshot()
            wall, cpu, _ = run10(mode)
            s1 = STATS.snapshot()
            walls[key].append(wall)
            cpus[key].append(cpu)
            if mode == "fast" and wall < best_fast:
                best_fast = wall
                dev = {
                    "device_s": s1.get("device", 0) - s0.get("device", 0),
                    "dispatch_s": s1.get("pad+dispatch", 0)
                    - s0.get("pad+dispatch", 0),
                    "device_cols": int(s1.get("device_columns", 0)
                                       - s0.get("device_columns", 0)),
                    "host_deep_cols": int(
                        s1.get("host_deep_columns", 0)
                        - s0.get("host_deep_columns", 0)
                    ),
                    "host_tail_cols": int(
                        s1.get("host_tail_columns", 0)
                        - s0.get("host_tail_columns", 0)
                    ),
                    "slabs": int(s1.get("slabs_dispatched", 0)
                                 - s0.get("slabs_dispatched", 0)),
                }
    out = {
        "w200": min(walls["f200"]),
        "w200_exact": min(walls["e200"]),
        "wall": min(walls["f10"]),
        "wall_exact": min(walls["e10"]),
        "wall_median": st.median(walls["f10"]),
        "wall_exact_median": st.median(walls["e10"]),
        "cpu_median": st.median(cpus["f10"]),
        "cpu_exact_median": st.median(cpus["e10"]),
        **dev,
    }
    import jax

    devs = jax.devices()
    out["device"] = {"platform": devs[0].platform,
                     "kind": devs[0].device_kind, "count": len(devs)}
    # On-device output contract: the fast output vs the exact
    # (all-host, bit-identical-to-reference) lines at both scales.
    from somatic_sniper_tpu.utils.contract import diff_records, hist

    try:
        tolerated = diff_records(fast200_lines, exact200_lines, "vcf")
        tolerated += diff_records(fast10_lines, exact10_lines, "vcf")
        out["contract_ok"] = True
        out["contract_diffs"] = len(tolerated)
        # per-field delta histogram: a regression shows as a new class
        # or a count jump, not an opaque total (utils.contract.hist)
        out["contract_hist"] = hist(tolerated)
    except AssertionError as e:
        out["contract_ok"] = False
        out["contract_error"] = str(e)[:300]
    return out


def time_interleaved_phases(d200: Path, d10: Path) -> dict:
    """Both modes' e2e timings (alternated) + the output contract, in
    one bounded subprocess."""
    code = (
        "import bench, json, os; from pathlib import Path; "
        "os.environ['SNIPER_STATS']='1'; "
        f"r = bench._interleaved_phase_body(Path({str(d200)!r}), "
        f"Path({str(d10)!r})); "
        "print('FASTJSON ' + json.dumps(r))"
    )
    return _bounded_json(
        code, "FASTJSON",
        int(os.environ.get("SNIPER_BENCH_FAST_TIMEOUT", "1800")),
        "interleaved mode phases",
    )


def time_mfu() -> dict:
    """Kernel-only microbench in its own bounded subprocess."""
    code = (
        "import json; from somatic_sniper_tpu.utils.mfu import "
        "bench_kernel; r = bench_kernel(); "
        "print('MFUJSON ' + json.dumps(r._asdict()))"
    )
    return _bounded_json(
        code, "MFUJSON",
        int(os.environ.get("SNIPER_BENCH_MFU_TIMEOUT", "1200")),
        "kernel microbench",
    )


def _bounded_json(code: str, tag: str, timeout: int, what: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    try:
        r = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True, text=True, timeout=timeout,
            cwd=str(Path(__file__).resolve().parent), env=env,
        )
        print(r.stderr, file=sys.stderr, end="")
        if r.returncode == 0:
            for line in r.stdout.splitlines():
                if line.startswith(tag + " "):
                    return json.loads(line[len(tag) + 1:])
        print(f"bench: {what} failed (exit {r.returncode})",
              file=sys.stderr)
    except subprocess.TimeoutExpired:
        print(f"bench: {what} timed out", file=sys.stderr)
    return {}


def time_reference(d: Path, reps: int = 2) -> float | None:
    ref = os.environ.get("SNIPER_REF_BIN", "/tmp/ref/bam-somaticsniper")
    if not Path(ref).exists():
        # build it from /root/reference (offline, ~30 s) so the
        # baseline is timed live on this host instead of recorded
        script = Path(__file__).parent / "tests" / "tools" / \
            "build_reference.sh"
        try:
            subprocess.run(["sh", str(script)], check=True, timeout=300,
                           capture_output=True)
        except Exception as e:
            print(f"bench: reference build skipped ({e})",
                  file=sys.stderr)
    if not Path(ref).exists():
        return None
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        subprocess.run(
            [ref, "-F", "vcf", "-f", str(d / "ref.fa"),
             str(d / "tumor.bam"), str(d / "normal.bam"),
             str(d / "out.ref.vcf")],
            check=True, capture_output=True,
        )
        best = min(best, time.time() - t0)
    print(f"bench: reference best wall {best:.2f}s", file=sys.stderr)
    return best


def main() -> int:
    d = ensure_data()
    d10 = ensure_data_10mb()
    n_cols = count_columns(d)
    n_cols_10 = count_columns(d10)

    fast = time_interleaved_phases(d, d10)
    mfu = time_mfu()
    if not fast.get("wall") or not mfu.get("cols_per_sec"):
        print("bench: device phases failed (no GPU?)", file=sys.stderr)
        return 1
    exact_wall = fast["w200_exact"]
    exact10 = {"wall": fast["wall_exact"]}

    exact_cps = n_cols / exact_wall
    fast_cps = n_cols / fast["w200"]
    exact10_cps = n_cols_10 / exact10["wall"]
    fast10_cps = n_cols_10 / fast["wall"]

    # headline = best measured configuration; sub-second 200 kb runs
    # jitter ±40% with host load, the 10 Mb windowed rate is the stable
    # production-shaped number
    best = max(exact_cps, fast_cps or 0.0, exact10_cps, fast10_cps or 0.0)
    # scale-matched live reference: same-best-of discipline at both
    # sizes (the single-threaded C binary itself varies ±40% with load)
    ref_wall = time_reference(d)
    ref_wall10 = time_reference(d10, reps=1)
    ref_cps = (n_cols / ref_wall) if ref_wall is not None \
        else RECORDED_REF_COLS_PER_SEC
    ref_cps10 = (n_cols_10 / ref_wall10) if ref_wall10 is not None else None
    ref_best = max(ref_cps, ref_cps10 or 0.0)

    out = {
        "metric": "pileup_columns_per_sec",
        "value": round(best, 1),
        "unit": "columns/s",
        # vs_baseline follows the live reference when it builds (same
        # best-of discipline at both scales); vs_recorded pins the
        # round-over-round comparable denominator (the 200 kb recorded
        # measurement, fixed since round 1) and vs_live is explicit
        "vs_baseline": round(best / ref_best, 3),
        "vs_recorded": round(best / RECORDED_REF_COLS_PER_SEC, 3),
        "vs_live": (
            round(best / max(ref_cps if ref_wall is not None else 0.0,
                             ref_cps10 or 0.0), 3)
            if ref_wall is not None or ref_cps10 else None
        ),
        "exact_cols_per_sec": round(exact_cps, 1),
        "fast_cols_per_sec": round(fast_cps, 1) if fast_cps else None,
        "exact_10mb_cols_per_sec": round(exact10_cps, 1),
        "fast_10mb_cols_per_sec": round(fast10_cps, 1) if fast10_cps
        else None,
        # steal-proof evidence (round 5): medians over the interleaved
        # reps and whole-process CPU per mode — a host-load spike
        # inflates both modes' walls alike inside one process, and the
        # CPU column shows which mode actually costs the host more
        "exact_10mb_median_cols_per_sec": (
            round(n_cols_10 / fast["wall_exact_median"], 1)
            if fast.get("wall_exact_median") else None
        ),
        "fast_10mb_median_cols_per_sec": (
            round(n_cols_10 / fast["wall_median"], 1)
            if fast.get("wall_median") else None
        ),
        "exact_10mb_cpu_s": (
            round(fast["cpu_exact_median"], 2)
            if fast.get("cpu_exact_median") else None
        ),
        "fast_10mb_cpu_s": (
            round(fast["cpu_median"], 2)
            if fast.get("cpu_median") else None
        ),
        "ref_cols_per_sec": round(ref_cps, 1),
        "ref_10mb_cols_per_sec": round(ref_cps10, 1) if ref_cps10
        else None,
        "ref_live": ref_wall is not None,
    }
    if "contract_ok" in fast:
        out["fast_contract_ok"] = fast["contract_ok"]
        out["fast_contract_diffs"] = fast.get("contract_diffs")
        if fast.get("contract_hist") is not None:
            out["fast_contract_hist"] = fast["contract_hist"]
        if fast.get("contract_error"):
            out["fast_contract_error"] = fast["contract_error"]
    if fast.get("wall"):
        out["host_blocked_on_device_frac_10mb"] = round(
            fast.get("device_s", 0.0) / fast["wall"], 3
        )
        dev_cost = fast.get("device_s", 0.0) + fast.get("dispatch_s", 0.0)
        if dev_cost > 0:
            out["device_cols_per_sec"] = round(
                fast.get("device_cols", 0) / dev_cost, 1
            )
        out["slabs_dispatched_10mb"] = fast.get("slabs")
        out["host_deep_cols_10mb"] = fast.get("host_deep_cols")
        out["host_tail_cols_10mb"] = fast.get("host_tail_cols")
    out["kernel_cols_per_sec"] = round(mfu["cols_per_sec"], 1)
    out["kernel_shape"] = [mfu["B"], mfu["D"]]
    out["device"] = fast["device"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
