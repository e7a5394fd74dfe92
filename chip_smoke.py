#!/usr/bin/env python
"""Smoke test of the fast scoring path on an NVIDIA GPU.

Run from the root of a checkout on a host with a GPU:

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the four-card paths only

Default phases (one card):

* probe   — JAX must find a GPU (``JAX_PLATFORMS=cuda``).
* data    — the 10 Mb 30x/30x pair (the bench's ``pair_10mb``), generated
            once into ``.bench_data/`` and reused.
* golden  — exact CLI on the golden pair is byte-identical to
            ``tests/data/expected.vcf`` and opens no device; fast CLI
            passes the fast-mode contract against it.
* scoring — ``call_batch_packed`` on real slabs (production fill, B=8192,
            D=48/64/128) against the native exact scorer on the same
            columns, on the GPU and on the CPU backend.
* e2e     — fast and exact CLI on the 10 Mb pair (windowed driver), diffed
            under the contract; device columns must be > 0; exact
            ``--jobs 4`` must reproduce the single-process bytes.
* tests   — the ``gpu``-marked pytest tests.

``--four-cards`` runs only: probe (4 cards), data, one process with a mesh
over four cards vs one card (byte-identical), and four pinned processes
merged with ``--merge collective`` (byte-identical to one card).

Each phase that opens a card runs in its own subprocess, one at a time;
this parent never imports JAX.  Any failure exits non-zero, and only a
run in which every phase passed prints the final JSON line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "somatic_sniper_tpu"
WORK = ROOT / ".bench_data"
PAIR = WORK / "pair_10mb"
OUT = WORK / "smoke"
GOLDEN = ROOT / "tests" / "data"
SLAB_B = 8192
SLAB_DS = (48, 64, 128)
DEFAULT_PHASES = ("probe", "data", "golden", "scoring", "e2e", "tests")
FOUR_CARD_PHASES = ("probe", "data", "mesh4", "dist4")
# fields the fast contract lets differ by +/-1 (utils/contract.py)
PM1_FIELDS = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
              "somatic_score", "joint_cnsq")


class PhaseError(RuntimeError):
    pass


def select_phases(argv: list[str]) -> tuple[str, ...]:
    """Phases to run for the command line (no other flag exists)."""
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        raise SystemExit(f"chip_smoke.py: unknown arguments {unknown}")
    return FOUR_CARD_PHASES if "--four-cards" in argv else DEFAULT_PHASES


# ---------------------------------------------------------------- parent


def _env(platform: str | None, **extra) -> dict:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    if platform:
        env["JAX_PLATFORMS"] = platform
    env.update(extra)
    return env


def _run(cmd: list[str], env: dict, what: str, timeout: int = 900):
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise PhaseError(
            f"{what} failed (exit {r.returncode}):\n{r.stderr[-4000:]}"
        )
    return r, dt


def _child(phase: str, platform: str | None, **extra) -> dict:
    """Run one phase body in its own process; returns its RESULT dict."""
    r, dt = _run([sys.executable, __file__, "--phase", phase],
                 _env(platform, **extra), f"phase {phase}")
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            res = json.loads(line[len("RESULT "):])
            res["seconds"] = round(dt, 1)
            return res
    raise PhaseError(f"phase {phase} printed no result:\n{r.stdout[-2000:]}")


def _cli(args: list[str], platform: str | None, what: str, **extra):
    return _run([sys.executable, "-m", "somatic_sniper_tpu.cli.main",
                 *args], _env(platform, **extra), what)


def _exact_cli_no_device(args: list[str], what: str):
    """Exact CLI with JAX_PLATFORMS unset, as a user runs it; fails if
    the run created any JAX backend (exact mode scores on the host)."""
    code = (
        "import sys\n"
        "from somatic_sniper_tpu.cli.main import main\n"
        "rc = main(sys.argv[1:])\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge.backends_are_initialized(), "
        "'exact run created a JAX backend'\n"
        "sys.exit(rc)\n"
    )
    return _run([sys.executable, "-c", code, *args], _env(None), what)


def _body(path: Path) -> list[str]:
    """Output lines without the run-dependent header lines."""
    return [ln for ln in path.read_text().splitlines(keepends=True)
            if not ln.startswith(("##fileDate", "##reference="))]


def _contract(fast: Path, exact: Path) -> dict:
    from somatic_sniper_tpu.utils.contract import diff_records, hist

    try:
        tolerated = diff_records(_body(fast), _body(exact), "vcf")
    except AssertionError as e:
        raise PhaseError(f"fast/exact contract violated: {e}") from e
    return hist(tolerated)


def _stats(stderr: str) -> dict:
    return {k: int(v) for k, v in
            re.findall(r"^\s+(\w+_columns|slabs_dispatched)\s+(\d+)$",
                       stderr, re.M)}


def phase_golden() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    ex, fa = OUT / "golden.exact.vcf", OUT / "golden.fast.vcf"
    args = ["-F", "vcf", "-f", str(GOLDEN / "small.fa"),
            str(GOLDEN / "t-small.bam"), str(GOLDEN / "n-small.bam")]
    _exact_cli_no_device(args + [str(ex)], "exact CLI (golden)")
    if _body(ex) != _body(GOLDEN / "expected.vcf"):
        raise PhaseError("exact golden output differs from expected.vcf")
    _cli(["--precision", "fast"] + args + [str(fa)], "cuda",
         "fast CLI (golden)", SNIPER_DEVICE_MIN_COLS="0")
    return {"exact_bitwise": True, "exact_opened_device": False,
            "fast_contract_hist": _contract(fa, ex)}


def phase_e2e() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    ins = ["-F", "vcf", "-f", str(PAIR / "ref.fa"), str(PAIR / "tumor.bam"),
           str(PAIR / "normal.bam")]
    fa, ex, ej = (OUT / f"10mb.{t}.vcf" for t in ("fast", "exact", "jobs4"))
    r, wall_fast = _cli(["--precision", "fast", "--stats"] + ins + [str(fa)],
                        "cuda", "fast CLI (10 Mb)")
    backend = [ln for ln in r.stderr.splitlines()
               if ln.startswith("Scoring on ")]
    st = _stats(r.stderr)
    if st.get("device_columns", 0) == 0:
        raise PhaseError(f"fast run scored nothing on the device: {st}")
    _, wall_exact = _exact_cli_no_device(ins + [str(ex)], "exact CLI (10 Mb)")
    _, wall_jobs = _exact_cli_no_device(["--jobs", "4"] + ins + [str(ej)],
                                        "exact CLI --jobs 4 (10 Mb)")
    if _body(ej) != _body(ex):
        raise PhaseError("exact --jobs 4 bytes differ from one process")
    return {
        "backend": backend, "records": len(_body(ex)),
        "fast_wall_s": round(wall_fast, 2),
        "exact_wall_s": round(wall_exact, 2),
        "exact_jobs4_wall_s": round(wall_jobs, 2),
        "device_columns": st.get("device_columns", 0),
        "host_deep_columns": st.get("host_deep_columns", 0),
        "host_tail_columns": st.get("host_tail_columns", 0),
        "slabs_dispatched": st.get("slabs_dispatched", 0),
        "contract_hist": _contract(fa, ex),
    }


def phase_tests() -> dict:
    r, _ = _run([sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
                 "-p", "no:cacheprovider", "tests/test_gpu.py"],
                _env(None, SNIPER_TEST_PLATFORM="cuda,cpu"), "gpu tests")
    tail = r.stdout.strip().splitlines()[-1]
    if "skipped" in tail or "passed" not in tail:
        raise PhaseError(f"gpu tests did not all run: {tail}")
    return {"pytest": tail}


def _fast_10mb(out: Path, what: str, **extra):
    ins = ["-F", "vcf", "-f", str(PAIR / "ref.fa"), str(PAIR / "tumor.bam"),
           str(PAIR / "normal.bam")]
    return _cli(["--precision", "fast"] + ins + [str(out)], "cuda", what,
                **extra)


def phase_mesh4() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    four, one = OUT / "mesh4.vcf", OUT / "one_card.vcf"
    r4, w4 = _fast_10mb(four, "fast CLI over 4 cards")
    r1, w1 = _fast_10mb(one, "fast CLI on 1 card", CUDA_VISIBLE_DEVICES="0")
    if _body(four) != _body(one):
        raise PhaseError("4-card mesh output differs from one card")
    return {"identical": True, "wall_4cards_s": round(w4, 2),
            "wall_1card_s": round(w1, 2),
            "backends": [ln for r in (r4, r1) for ln in r.stderr.splitlines()
                         if ln.startswith("Scoring on ")]}


def phase_dist4() -> dict:
    import socket

    one = OUT / "one_card.vcf"
    merged = OUT / "dist4.vcf"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ins = ["-F", "vcf", "-f", str(PAIR / "ref.fa"), str(PAIR / "tumor.bam"),
           str(PAIR / "normal.bam")]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "somatic_sniper_tpu.cli.main",
             "--precision", "fast", "--merge", "collective", *ins,
             str(merged)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
            env=_env("cuda", SNIPER_COORDINATOR=f"localhost:{port}",
                     SNIPER_NUM_PROCESSES="4", SNIPER_PROCESS_ID=str(i)),
        )
        for i in range(4)
    ]
    errs = []
    for i, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=900)
        finally:
            if p.poll() is None:
                p.kill()
        if p.returncode != 0:
            errs.append(f"process {i} exit {p.returncode}:\n{err[-2000:]}")
        backends = [ln for ln in err.splitlines()
                    if ln.startswith("Scoring on ")]
        print(f"  dist4 process {i}: {backends}", flush=True)
    if errs:
        raise PhaseError("\n".join(errs))
    if _body(merged) != _body(one):
        raise PhaseError("4-process merged output differs from one card")
    return {"identical": True,
            "wall_s": round(time.perf_counter() - t0, 2)}


PARENT_PHASES = {"golden": phase_golden, "e2e": phase_e2e,
                 "tests": phase_tests, "mesh4": phase_mesh4,
                 "dist4": phase_dist4}


def main(argv: list[str]) -> int:
    phases = select_phases(argv)
    if not (PKG / "cli" / "main.py").exists():
        print("chip_smoke.py: run it from the root of a somatic_sniper_tpu "
              "checkout", file=sys.stderr)
        return 2
    try:
        device = None
        for phase in phases:
            if phase == "probe":
                try:
                    device = _child("probe", "cuda")
                except PhaseError as e:
                    raise PhaseError(f"JAX found no usable GPU: {e}") from e
                want = 4 if "--four-cards" in argv else 1
                if device["count"] < want:
                    raise PhaseError(f"need {want} GPUs, JAX sees {device}")
                smi = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=60,
                )
                print(smi.stdout.strip(), flush=True)
                res = dict(device)
                device.pop("seconds")
            elif phase == "data":
                res = _child("data", None)
            elif phase == "scoring":
                res = {"gpu": _child("scoring", "cuda"),
                       "cpu": _child("scoring", "cpu")}
            else:
                res = PARENT_PHASES[phase]()
            print(f"phase {phase}: ok {json.dumps(res)}", flush=True)
    except (PhaseError, subprocess.TimeoutExpired, OSError) as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


# ----------------------------------------------------------------- child


def child_probe() -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise PhaseError(f"JAX found no GPU: {devs}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def child_data() -> dict:
    from somatic_sniper_tpu.utils.simulate import (SimConfig,
                                                   simulate_pair_fast)

    done = PAIR / "complete"
    if done.exists():
        return {"generated": False}
    simulate_pair_fast(PAIR, SimConfig(n_contigs=2, contig_len=5_000_000,
                                       mean_depth=30.0, seed=11))
    done.write_text("ok\n")
    return {"generated": True}


def _exact_rows_with_dq(pu_t, pu_n, ti, ni, ref16, tabs, p):
    """Native exact rows for planned columns plus their 36 dqstats
    fields: the layout the device rows carry."""
    import numpy as np

    from somatic_sniper_tpu.io.native_api import exact_pair_rows
    from somatic_sniper_tpu.models.somatic import COMPACT_FIELDS
    from somatic_sniper_tpu.output.dqstats import get_dqstats_rows

    rows = exact_pair_rows(pu_t, pu_n, ti, ni, ref16, tabs,
                           p.use_joint_priors, p.min_somatic_qual,
                           p.include_loh, p.include_gor)
    idx = rows[:, 0].astype(np.int64)
    rb4 = ref16.astype(np.int64)[idx]
    f = {n: rows[:, 1 + j] for j, n in enumerate(COMPACT_FIELDS)}
    wanted = rb4 | f["tumor_eff_gt"] | f["normal_eff_gt"]
    dq_t = get_dqstats_rows(pu_t, ti[idx], rb4, wanted)
    dq_n = get_dqstats_rows(pu_n, ni[idx], rb4, wanted)
    return np.concatenate([rows.astype(np.int64), dq_t, dq_n], axis=1)


def child_scoring() -> dict:
    """call_batch_packed on production-filled slabs vs the native exact
    scorer on the same columns, at B=8192 and each slab depth."""
    import jax
    import numpy as np

    from somatic_sniper_tpu.io import bai, native_api
    from somatic_sniper_tpu.io.bam import read_bam_header
    from somatic_sniper_tpu.io.fasta import FastaFile
    from somatic_sniper_tpu.models.somatic import (COMPACT_FIELDS,
                                                   call_batch_packed)
    from somatic_sniper_tpu.models.tables import ModelParams, build_tables
    from somatic_sniper_tpu.runner import (_ref_blob, get_device_tables,
                                           make_plan)

    params = ModelParams()
    tabs = build_tables(params)
    tb, nb = str(PAIR / "tumor.bam"), str(PAIR / "normal.bam")
    header = read_bam_header(tb)
    ref_blob, ref_off = _ref_blob(FastaFile(str(PAIR / "ref.fa")), header)
    beg, end = 0, 1_500_000
    pus = [
        native_api.load_region_and_columnize(
            b, np.asarray(bai.region_chunks(bai.ensure_index(b), 0, beg,
                                            end)), 0, beg, end)
        for b in (tb, nb)
    ]
    plan = make_plan(pus[0], pus[1], tabs, ref_blob, ref_off, True,
                     cns_mode="proof")
    dmax = np.maximum(plan.d_t, plan.d_n)
    dtabs = get_device_tables(params, "fast")
    dev = jax.devices()[0]
    out = {"device": f"{dev.platform} ({dev.device_kind})",
           "precision": "f32 accumulation, no matmul"}
    pm1 = {COMPACT_FIELDS.index(n) for n in PM1_FIELDS}
    for D in SLAB_DS:
        sel = np.nonzero(dmax <= D)[0][:SLAB_B]
        if len(sel) < SLAB_B:
            raise PhaseError(f"only {len(sel)} columns fit D={D}")
        ti, ni = plan.ti[sel], plan.ni[sel]
        ref16 = np.ascontiguousarray(plan.ref16[sel], np.int32)
        stacked = np.zeros((2, SLAB_B, D), np.uint32)
        meta = np.zeros((3, SLAB_B), np.int32)
        native_api.slab_fill_pair(
            pus[0], pus[1], ti, ni, ref16, plan.d_t[sel], plan.d_n[sel], D,
            params.cap_mapq, stacked[0], stacked[1], meta[0], meta[1],
            meta[2],
        )
        t0 = time.perf_counter()
        res = call_batch_packed(
            jax.device_put(stacked), jax.device_put(meta), dtabs.fk,
            dtabs.coef, dtabs.lhet, dtabs.solo_prior, dtabs.joint_prior,
            dtabs.qadd, dtabs.q_r_int, cap_mapq=params.cap_mapq,
            theta=params.theta, eta=params.eta, max_emit=SLAB_B,
            row_dtype="u8",
        )
        count, rows = jax.device_get((res.count, res.rows))
        first_s = time.perf_counter() - t0
        r = np.asarray(rows)[: int(count)].astype(np.int64)
        got = np.concatenate(
            [(r[:, 0] | (r[:, 1] << 8))[:, None], r[:, 2:]], axis=1
        )
        want = _exact_rows_with_dq(pus[0], pus[1], ti, ni, ref16, tabs,
                                   params)
        if not np.array_equal(got[:, 0], want[:, 0]):
            raise PhaseError(f"D={D}: emitted columns differ "
                             f"({len(got)} device vs {len(want)} exact)")
        diff = got[:, 1:] - want[:, 1:]
        hist = {}
        for j in np.unique(np.nonzero(diff)[1]):
            d = diff[:, j]
            if j not in pm1 or np.abs(d).max() > 1:
                raise PhaseError(f"D={D}: field {j} outside the contract")
            for v in (-1, 1):
                if (d == v).any():
                    hist[f"{COMPACT_FIELDS[j]}{v:+d}"] = int((d == v).sum())
        out[f"D{D}"] = {"emitted": len(got), "pm1_hist": hist,
                        "compile_and_first_run_s": round(first_s, 2)}
    return out


CHILD_PHASES = {"probe": child_probe, "data": child_data,
                "scoring": child_scoring}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"]:
        result = CHILD_PHASES[sys.argv[2]]()
        print("RESULT " + json.dumps(result), flush=True)
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
