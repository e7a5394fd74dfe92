"""bam-somaticsniper-compatible CLI (reference main.c:64-162).

Same flag surface as the reference plus additions of this
implementation (``--precision``, ``--shards``/``--shard-index`` for
region sharding, ``--jobs``, ``--merge``).
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import __version__
from ..models.tables import ModelParams
from ..output.formatters import FORMATTERS, get_formatter
from ..output.records import HeaderData


def usage_text(progname: str = "bam-somaticsniper-tpu",
               mapq: int = 0, min_somatic_qual: int = 15,
               somatic_mutation_rate: float = 0.01, theta: float = 0.85,
               n_hap: int = 2, het_rate: float = 0.001) -> str:
    """The reference's usage() text, byte-for-byte modulo the program
    name (reference main.c:27-62, incl. the double space in the -Q line
    and the registry-order format list of output_format.c:10-17)."""
    lines = [
        "",
        "",
        f"{progname} [options] -f <ref.fasta> <tumor.bam> <normal.bam>"
        " <snp_output_file>",
        "",
        "Required Option: ",
        "        -f FILE   REQUIRED reference sequence in the FASTA"
        " format",
        "",
        "Options: ",
        "        -v        Display version information",
        "",
        f"        -q INT    filtering reads with mapping quality less"
        f" than INT [{mapq}]",
        f"        -Q INT    filtering somatic snv output with somatic"
        f" quality less than  INT [{min_somatic_qual}]",
        "        -L FLAG   do not report LOH variants as determined by"
        " genotypes",
        "        -G FLAG   do not report Gain of Reference variants as"
        " determined by genotypes",
        "        -p FLAG   disable priors in the somatic calculation."
        " Increases sensitivity for solid tumors",
        "        -J FLAG   Use prior probabilities accounting for the"
        " somatic mutation rate",
        f"        -s FLOAT  prior probability of a somatic mutation"
        f" (implies -J) [{somatic_mutation_rate:f}]",
        f"        -T FLOAT  theta in maq consensus calling model"
        f" (for -c/-g) [{theta:f}]",
        f"        -N INT    number of haplotypes in the sample"
        f" (for -c/-g) [{n_hap}]",
        f"        -r FLOAT  prior of a difference between two haplotypes"
        f" (for -c/-g) [{het_rate:f}]",
        "        -n STRING normal sample id (for VCF header) [NORMAL]",
        "        -t STRING tumor sample id (for VCF header) [TUMOR]",
        "        -F STRING select output format [classic]",
        "           Available formats:",
    ] + [f"             {name}" for name in ("classic", "vcf", "bed")] + [
        "",
    ]
    return "\n".join(lines) + "\n"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bam-somaticsniper-tpu",
        description=(
            "Somatic SNV caller with SomaticSniper's statistics on JAX"
        ),
        add_help=True,
    )
    p.add_argument("-f", dest="ref", metavar="FILE", required=False,
                   help="REQUIRED reference sequence in the FASTA format")
    p.add_argument("-v", dest="version", action="store_true",
                   help="Display version information")
    p.add_argument("-q", dest="mapq", type=int, default=0, metavar="INT",
                   help="filtering reads with mapping quality less than INT")
    p.add_argument("-Q", dest="min_somatic_qual", type=int, default=15,
                   metavar="INT",
                   help="filtering somatic snv output with somatic quality "
                        "less than INT")
    p.add_argument("-L", dest="no_loh", action="store_true",
                   help="do not report LOH variants as determined by "
                        "genotypes")
    p.add_argument("-G", dest="no_gor", action="store_true",
                   help="do not report Gain of Reference variants as "
                        "determined by genotypes")
    p.add_argument("-p", dest="no_priors", action="store_true",
                   help="disable priors in the somatic calculation. "
                        "Increases sensitivity for solid tumors")
    p.add_argument("-J", dest="joint", action="store_true",
                   help="Use prior probabilities accounting for the somatic "
                        "mutation rate")
    p.add_argument("-s", dest="somatic_rate", type=float, default=None,
                   metavar="FLOAT",
                   help="prior probability of a somatic mutation "
                        "(implies -J) [0.010000]")
    p.add_argument("-T", dest="theta", type=float, default=0.85,
                   metavar="FLOAT",
                   help="theta in maq consensus calling model [0.850000]")
    p.add_argument("-N", dest="n_hap", type=int, default=2, metavar="INT",
                   help="number of haplotypes in the sample [2]")
    p.add_argument("-r", dest="het_rate", type=float, default=0.001,
                   metavar="FLOAT",
                   help="prior of a difference between two haplotypes "
                        "[0.001000]")
    p.add_argument("-n", dest="normal_id", default="NORMAL", metavar="STRING",
                   help="normal sample id (for VCF header) [NORMAL]")
    p.add_argument("-t", dest="tumor_id", default="TUMOR", metavar="STRING",
                   help="tumor sample id (for VCF header) [TUMOR]")
    p.add_argument("-I", dest="_dead_I", default=None, metavar="STRING",
                   help=argparse.SUPPRESS)  # parity: reference getopt
    # consumes "I:" but has no handler for it (reference main.c:80)
    p.add_argument("-F", dest="format", default="classic", metavar="STRING",
                   choices=sorted(FORMATTERS),
                   help="select output format [classic] "
                        f"(available: {', '.join(sorted(FORMATTERS))})")
    p.add_argument("--precision", default="exact",
                   choices=("exact", "fast"),
                   help="model arithmetic: 'exact' replicates the reference "
                        "bit-for-bit on the host; 'fast' scores in f32 on "
                        "the accelerator")
    p.add_argument("--shards", type=int, default=1,
                   help="total number of genome shards")
    p.add_argument("--shard-index", type=int, default=None,
                   help="process only this shard (deterministic interval "
                        "partition); omit to process all shards locally")
    p.add_argument("--jobs", type=int, default=1, metavar="INT",
                   help="run INT shard worker processes on this host and "
                        "merge their outputs (built-in equivalent of the "
                        "manual --shards/--shard-index + merge_shards "
                        "workflow; the reference scaled only by running "
                        "one process per chromosome externally)")
    p.add_argument("--merge", default="files",
                   choices=("files", "collective"),
                   help="multi-process record merge: 'files' writes one "
                        "output per process for scripts.merge_shards; "
                        "'collective' all-gathers shard bytes over the "
                        "accelerator fabric (XLA all_gather, no shared "
                        "filesystem needed) and process 0 writes the "
                        "merged output [files]")
    p.add_argument("--window-size", type=int, default=250_000,
                   help="genome window length for the region-sharded "
                        "streaming driver [250000]")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage wall-clock/volume counters to "
                        "stderr at exit (also SNIPER_STATS=1); set "
                        "SNIPER_PROFILE=<dir> for a JAX profiler trace")
    p.add_argument("--manifest", default=None, metavar="FILE",
                   help="per-window completion manifest; enables the "
                        "streaming driver and crash-resumable runs "
                        "(re-running with the same manifest skips "
                        "completed windows)")
    p.add_argument("tumor_bam", nargs="?")
    p.add_argument("normal_bam", nargs="?")
    p.add_argument("output", nargs="?")
    return p


def _commit_id() -> str:
    """Source commit for version_info (reference main.c:20-25 prints the
    git-stamped commit via build-common/cmake/VersionHelper.cmake:1-8).

    Resolution: a build-time-stamped ``somatic_sniper_tpu._commit``
    module if present (sdist/wheel installs), else a live ``git
    rev-parse`` of the package's checkout (editable/dev installs),
    else "unknown"."""
    try:
        from .. import _commit  # type: ignore

        return _commit.COMMIT
    except Exception:
        pass
    try:
        import subprocess

        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            ["git", "-C", here, "rev-parse", "--short=8", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip()
    except Exception:
        pass
    return "unknown"


def _may_use_gpu() -> bool:
    """False when JAX_PLATFORMS rules the GPU backend out."""
    plat = os.environ.get("JAX_PLATFORMS", "")
    return not plat or any(p in plat for p in ("cuda", "gpu"))


def gpu_cards() -> list[str]:
    """IDs of the NVIDIA cards this process may use, found without
    creating a JAX client: CUDA_VISIBLE_DEVICES when set, else the
    indices ``nvidia-smi`` lists ([] when it is absent)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if r.returncode != 0:
        return []
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def _maybe_init_distributed(args) -> None:
    """Multi-host pod-slice initialization (opt-in via env so single-host
    runs never touch jax.distributed):

        SNIPER_COORDINATOR=host:port SNIPER_NUM_PROCESSES=N \\
        SNIPER_PROCESS_ID=I python -m somatic_sniper_tpu.cli.main ...

    Each process then defaults to genome shard I of N (overridable with
    --shards/--shard-index) and scores its span on its local devices;
    per-process outputs concatenate via scripts.merge_shards.  In fast
    mode on a GPU host, process I is pinned to card I (modulo the card
    count) so the processes of one host do not share a card."""
    coord = os.environ.get("SNIPER_COORDINATOR")
    if not coord:
        return
    import jax

    num = int(os.environ["SNIPER_NUM_PROCESSES"])
    pid = int(os.environ["SNIPER_PROCESS_ID"])
    if args.precision == "fast":
        cards = gpu_cards()
        if cards:
            os.environ["CUDA_VISIBLE_DEVICES"] = cards[pid % len(cards)]
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=num, process_id=pid,
    )
    # Force the backend's global topology exchange NOW, in every
    # process: backend init is otherwise lazy (first jax op), and a
    # process with an empty/resumed shard would never trigger it —
    # leaving a peer that does blocked 5 min in GetKeyValue waiting for
    # this process's topology.
    jax.devices()
    if args.shards == 1 and args.shard_index is None:
        args.shards = num
        args.shard_index = pid
    args._dist = (num, pid)


def _run_jobs(args) -> int:
    """--jobs N: spawn N shard worker processes (contiguous genome
    partition, same numbering as --shards/--shard-index) and merge
    their outputs; the merged bytes equal a single-process run.

    Worker thread budget: each worker's region-load pool is clamped so
    N workers never oversubscribe the host (round 2 measured --jobs 2
    SLOWER on a 2-core host because 2 workers x 2 load threads fought
    for 2 cores); with the clamp each worker is ~1 busy core and the
    speedup tracks core count."""
    import subprocess
    import tempfile

    from ..scripts.merge_shards import merge

    ncpu = os.cpu_count() or 1
    if args.jobs > ncpu:
        # more workers than cores can't help: per-worker work is CPU
        # bound; degrade instead of thrashing
        print(f"--jobs {args.jobs} clamped to {ncpu} (host cores)",
              file=sys.stderr)
        args.jobs = ncpu
    if args.jobs <= 1:
        args.jobs = 1
    cards = []
    if args.precision == "fast" and _may_use_gpu():
        cards = gpu_cards()
        if cards and args.jobs > len(cards):
            print(f"--jobs {args.jobs} in fast mode needs one GPU per "
                  f"worker; this host has {len(cards)}", file=sys.stderr)
            return 1

    base = [
        sys.executable, "-m", "somatic_sniper_tpu.cli.main",
        "-f", args.ref, "-F", args.format,
        "-q", str(args.mapq), "-Q", str(args.min_somatic_qual),
        "-T", str(args.theta), "-N", str(args.n_hap),
        "-r", str(args.het_rate),
        "-n", args.normal_id, "-t", args.tumor_id,
        "--precision", args.precision,
        "--window-size", str(args.window_size),
    ]
    for flag, on in (("-L", args.no_loh), ("-G", args.no_gor),
                     ("-p", args.no_priors), ("-J", args.joint)):
        if on:
            base.append(flag)
    if args.somatic_rate is not None:
        base += ["-s", str(args.somatic_rate)]
    tmpdir = tempfile.mkdtemp(prefix="sniper_jobs_")
    outs = [os.path.join(tmpdir, f"shard{i}.out")
            for i in range(args.jobs)]
    wenv = dict(os.environ)
    if "SNIPER_LOAD_POOL" not in wenv and 2 * args.jobs > ncpu:
        wenv["SNIPER_LOAD_POOL"] = "1"
    wenvs = [dict(wenv) for _ in range(args.jobs)]
    if args.precision == "exact":
        # exact mode scores on the host: no worker may open a card
        for e in wenvs:
            e["JAX_PLATFORMS"] = "cpu"
    elif cards:
        # one card per fast worker (a JAX process reserves most of a
        # card's memory, so two workers cannot share one)
        for i, e in enumerate(wenvs):
            e["CUDA_VISIBLE_DEVICES"] = cards[i]
    procs = [
        subprocess.Popen(
            base + ["--shards", str(args.jobs), "--shard-index", str(i),
                    args.tumor_bam, args.normal_bam, outs[i]],
            env=wenvs[i],
        )
        for i in range(args.jobs)
    ]
    rc = 0
    for p in procs:
        rc = rc or p.wait()
    if rc:
        print(f"--jobs worker failed (exit {rc})", file=sys.stderr)
        return rc
    merge(args.output, outs)
    for o in outs:
        try:
            os.unlink(o)
        except OSError:
            pass
    try:
        os.rmdir(tmpdir)
    except OSError:
        pass
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax

    # persistent compile cache: cold starts reuse compiled programs
    from ..utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    if args.precision == "exact":
        # the exact path replicates the reference's double-precision
        # arithmetic and requires x64-enabled JAX; it scores on the
        # host, so unless JAX_PLATFORMS says otherwise no accelerator
        # client is ever created
        jax.config.update("jax_enable_x64", True)
        if not os.environ.get("JAX_PLATFORMS"):
            jax.config.update("jax_platforms", "cpu")
    if args.version:
        # reference version_info() format (main.c:20-25): version and
        # commit (the build type is optional and omitted).  The commit
        # is resolved like build-common's VersionHelper (git describe at
        # build time): a stamped _commit module wins, then a live git
        # query of the source checkout.
        print(f"Somatic Sniper version ({__version__}) "
              f"(commit {_commit_id()})")
        return 0
    _maybe_init_distributed(args)
    if not (args.tumor_bam and args.normal_bam and args.output):
        # reference usage() text (main.c:27-62); --help keeps the
        # argparse surface with this implementation's extra flags
        sys.stderr.write(usage_text(
            mapq=args.mapq, min_somatic_qual=args.min_somatic_qual,
            somatic_mutation_rate=(
                args.somatic_rate if args.somatic_rate is not None
                else 0.01
            ),
            theta=args.theta, n_hap=args.n_hap, het_rate=args.het_rate,
        ))
        return 1
    if not args.ref:
        print("You MUST specify a reference sequence. It isn't optional.",
              file=sys.stderr)
        return 1
    if args.tumor_bam == "-":
        # tumor BAM from stdin (reference main.c:128): spool to a temp
        # file so the region/seek paths work on it too
        import tempfile

        tmp = tempfile.NamedTemporaryFile(suffix=".bam", delete=False)
        with tmp:
            while True:
                chunk = sys.stdin.buffer.read(1 << 20)
                if not chunk:
                    break
                tmp.write(chunk)
        args.tumor_bam = tmp.name

    params = ModelParams(
        theta=args.theta,
        n_hap=args.n_hap,
        het_rate=args.het_rate,
        use_priors=not args.no_priors,
        use_joint_priors=args.joint or args.somatic_rate is not None,
        somatic_mutation_rate=(
            args.somatic_rate if args.somatic_rate is not None else 0.01
        ),
        min_somatic_qual=args.min_somatic_qual,
        include_loh=not args.no_loh,
        include_gor=not args.no_gor,
        mapq_threshold=args.mapq,
    )

    if params.use_joint_priors:
        print(
            "Using priors accounting for somatic mutation rate. Prior "
            f"probability of a somatic mutation is {params.somatic_mutation_rate:f}",
            file=sys.stderr,
        )
    print("Preparing to snipe some somatics", file=sys.stderr)
    if params.use_priors:
        print("Using prior probabilities", file=sys.stderr)
    print(f"Normal bam is {args.normal_bam}", file=sys.stderr)
    print(f"Tumor bam is {args.tumor_bam}", file=sys.stderr)

    # header @RG parse parity (reference main.c:132,135 calls
    # sam_header_parse_rg on both headers, tumor first): the ID->LB
    # maps are built — with the same missing-tag stderr warnings — but,
    # exactly as in the reference, nothing downstream consumes them
    try:
        from ..io.bam import read_bam_header

        read_bam_header(args.tumor_bam).parse_rg()
        read_bam_header(args.normal_bam).parse_rg()
    except (OSError, ValueError):
        pass  # unreadable inputs produce their real error downstream

    header_fn, record_fn = get_formatter(args.format)
    hdata = HeaderData(
        refseq=args.ref,
        normal_sample_id=args.normal_id,
        tumor_sample_id=args.tumor_id,
    )
    if args.jobs > 1:
        if args.shard_index is not None or args.manifest:
            print("--jobs cannot combine with --shard-index/--manifest",
                  file=sys.stderr)
            return 1
        return _run_jobs(args)
    dist = getattr(args, "_dist", None)
    if dist is not None and args.merge == "collective":
        num, pid = dist
        # Hard failure paths use os._exit: after a peer death the
        # jax.distributed atexit shutdown can block indefinitely on the
        # coordination service (the coordinator waits for dead/erroring
        # clients), turning a clean fail-fast into a hang.  The branch
        # logic lives in _run_collective (returns the code + hard flag)
        # so the failure semantics are unit-testable in-process; output
        # and manifest are flushed before every hard exit.
        rc, hard = _run_collective(args, params, header_fn, record_fn,
                                   hdata, num, pid)
        if hard:
            os._exit(rc)
        return rc
    try:
        return _run(args, params, header_fn, record_fn, hdata)
    except (OSError, ValueError) as e:
        # fail fast with a message, like the reference's exit paths
        # (truncated/corrupt/unsorted inputs, malformed .fai, ...)
        print(f"bam-somaticsniper-tpu: {e}", file=sys.stderr)
        return 1


def _run_collective(args, params, header_fn, record_fn, hdata,
                    num: int, pid: int) -> tuple[int, bool]:
    """One collective-merge worker's run: score the shard, rendezvous,
    all-gather the merge.  Returns ``(exit_code, hard)`` — ``hard``
    means the caller must ``os._exit`` (a peer may be dead and the
    jax.distributed atexit shutdown would hang; see main).  Every
    failure leaves the shard output + manifest on disk so a re-run
    with the same manifests resumes."""
    real_out = args.output
    args.output = f"{real_out}.shard{pid}"
    try:
        rc = _run(args, params, header_fn, record_fn, hdata)
    except (OSError, ValueError) as e:
        print(f"bam-somaticsniper-tpu: {e}", file=sys.stderr)
        sys.stderr.flush()
        return 1, True
    except Exception as e:
        # distributed-runtime errors (peer death detected by the
        # coordination-service heartbeat) surface here
        print(
            f"bam-somaticsniper-tpu: distributed run failed "
            f"({type(e).__name__}: {e}); shard output kept at "
            f"{args.output} — re-run with the same manifests to "
            "resume",
            file=sys.stderr,
        )
        sys.stderr.flush()
        return 3, True
    if rc == 0:
        from ..parallel.collective import collective_merge, merge_barrier

        try:
            # rendezvous with a timeout BEFORE the all_gather: a dead
            # peer must fail the survivors fast, not hang them in the
            # collective; shard output + manifest stay on disk for a
            # resumed re-run
            merge_barrier()
        except Exception as e:
            print(
                f"bam-somaticsniper-tpu: merge barrier failed "
                f"(a worker died or stalled): {e}; shard output "
                f"kept at {args.output} — re-run with the same "
                "manifests to resume",
                file=sys.stderr,
            )
            sys.stderr.flush()
            return 3, True
        try:
            collective_merge(real_out, args.output, pid, num)
        except Exception as e:
            print(
                f"bam-somaticsniper-tpu: collective merge failed "
                f"({type(e).__name__}: {e}); shard outputs kept",
                file=sys.stderr,
            )
            sys.stderr.flush()
            return 3, True
    return rc, False


def _run(args, params, header_fn, record_fn, hdata) -> int:
    from ..utils import stats as run_stats

    with run_stats.maybe_profile():
        _write_output(args, params, header_fn, hdata)
    if args.stats or run_stats.enabled():
        print(run_stats.STATS.summary(), file=sys.stderr)
    return 0


def _write_output(args, params, header_fn, hdata) -> None:
    use_sharded = (
        args.shards > 1 or args.shard_index is not None
        or args.manifest is not None
    )
    if not use_sharded and args.tumor_bam != "-":
        # large genomes default to the windowed streaming driver:
        # constant memory, and the one-window decode lookahead overlaps
        # host IO with device compute (measurably faster at >=Mb scale;
        # stdin tumor cannot seek, so '-' stays on the whole-file path)
        try:
            from ..io.bam import read_bam_header

            if sum(read_bam_header(args.tumor_bam).ref_lengths) \
                    > 1_500_000:
                use_sharded = True
        except Exception:
            pass
    if not use_sharded:
        from ..runner import call_pair

        with open(args.output, "w") as fh:
            header_fn(fh, hdata)
            for line in call_pair(
                args.tumor_bam, args.normal_bam, args.ref,
                params=params, precision=args.precision,
                fmt=args.format,
            ):
                fh.write(line)
        return

    # region-sharded streaming driver with optional per-window resume
    from ..parallel.sharded import Manifest, call_pair_windows

    manifest = Manifest(args.manifest) if args.manifest else None
    resume_at = manifest.resume_offset() if manifest else None
    skip = set(manifest.done) if manifest else None
    mode = "r+" if (resume_at is not None and
                    os.path.exists(args.output)) else "w"
    with open(args.output, mode) as fh:
        if mode == "r+":
            fh.seek(resume_at)
            fh.truncate()
        else:
            header_fn(fh, hdata)
        # fault-injection hook for the distributed failure tests: die
        # hard (no cleanup, like a real crash) after N windows
        fault_after = os.environ.get("SNIPER_FAULT_EXIT_AFTER_WINDOW")
        n_done = 0
        for wi, _win, lines in call_pair_windows(
            args.tumor_bam, args.normal_bam, args.ref,
            params=params, precision=args.precision,
            window_size=args.window_size,
            shards=args.shards, shard_index=args.shard_index,
            skip_windows=skip, fmt=args.format,
        ):
            fh.writelines(lines)
            fh.flush()
            if manifest:
                manifest.mark(wi, fh.tell())
            n_done += 1
            if fault_after and n_done >= int(fault_after):
                os._exit(17)


if __name__ == "__main__":
    sys.exit(main())
