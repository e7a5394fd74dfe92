"""Which process opens which device: one JAX process per card, none for
exact mode; plus the compile-cache and native-library location rules."""

import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import somatic_sniper_tpu.cli.main as M

ROOT = Path(__file__).resolve().parents[1]


class _FakeProc:
    def wait(self):
        return 0


def _jobs_args(tmp_path, precision, jobs):
    return M.build_parser().parse_args([
        "-f", "ref.fa", "--precision", precision, "--jobs", str(jobs),
        "t.bam", "n.bam", str(tmp_path / "out.vcf"),
    ])


@pytest.fixture
def spawned(monkeypatch):
    """Record the env of every --jobs worker instead of starting it."""
    envs = []

    def popen(cmd, env):
        envs.append(env)
        return _FakeProc()

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr("somatic_sniper_tpu.scripts.merge_shards.merge",
                        lambda out, paths: None)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    return envs


def test_jobs_exact_workers_never_see_a_gpu(spawned, tmp_path, monkeypatch):
    monkeypatch.setattr(M, "gpu_cards", lambda: ["0", "1", "2", "3"])
    assert M._run_jobs(_jobs_args(tmp_path, "exact", 4)) == 0
    assert [e["JAX_PLATFORMS"] for e in spawned] == ["cpu"] * 4


def test_jobs_fast_pins_one_card_per_worker(spawned, tmp_path,
                                            monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(M, "gpu_cards", lambda: ["0", "1", "2", "3"])
    assert M._run_jobs(_jobs_args(tmp_path, "fast", 3)) == 0
    assert [e["CUDA_VISIBLE_DEVICES"] for e in spawned] == ["0", "1", "2"]


def test_jobs_fast_more_workers_than_cards_fails_before_spawning(
        spawned, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(M, "gpu_cards", lambda: ["0", "1"])
    assert M._run_jobs(_jobs_args(tmp_path, "fast", 4)) == 1
    assert spawned == []
    assert "needs one GPU per worker" in capsys.readouterr().err


def test_gpu_cards_follows_cuda_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
    assert M.gpu_cards() == ["2", "3"]


def test_distributed_worker_pinned_to_its_card(monkeypatch):
    import jax

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "unset-by-test")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setattr(M, "gpu_cards", lambda: ["0", "1", "2", "3"])
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: None)
    monkeypatch.setenv("SNIPER_COORDINATOR", "localhost:1")
    monkeypatch.setenv("SNIPER_NUM_PROCESSES", "4")
    monkeypatch.setenv("SNIPER_PROCESS_ID", "2")
    args = types.SimpleNamespace(precision="fast", shards=1,
                                 shard_index=None)
    M._maybe_init_distributed(args)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2"
    assert (args.shards, args.shard_index) == (4, 2)


def test_exact_cli_creates_no_jax_backend(data_dir, tmp_path):
    """An exact run scores in the native layer: with JAX_PLATFORMS
    unset it must not create any JAX client (on a GPU host that would
    reserve most of the card's memory)."""
    code = (
        "import sys\n"
        "from somatic_sniper_tpu.cli.main import main\n"
        "rc = main(sys.argv[1:])\n"
        "from jax._src import xla_bridge\n"
        "print('INIT', xla_bridge.backends_are_initialized())\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run(
        [sys.executable, "-c", code, "-F", "vcf",
         "-f", str(data_dir / "small.fa"), str(data_dir / "t-small.bam"),
         str(data_dir / "n-small.bam"), str(tmp_path / "o.vcf")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stderr
    assert "INIT False" in r.stdout


# -------------------------------------------------------- compile cache


def test_compile_cache_env_dir_left_to_jax(monkeypatch):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself; nothing is set."""
    import jax

    from somatic_sniper_tpu.utils import compile_cache

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", "/from/env")
    calls = []
    try:
        monkeypatch.setattr(compile_cache, "_done", False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        compile_cache.enable_persistent_cache()
    finally:
        monkeypatch.undo()
        jax.config.update("jax_compilation_cache_dir", prev)
    assert calls == []


def test_compile_cache_default_is_repo_dir(monkeypatch):
    import jax

    from somatic_sniper_tpu.utils import compile_cache

    assert compile_cache.DEFAULT_DIR == ROOT / ".jax_cache"
    prev = jax.config.jax_compilation_cache_dir
    calls = []
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setattr(compile_cache, "_done", False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        compile_cache.enable_persistent_cache()
    finally:
        monkeypatch.undo()
        jax.config.update("jax_compilation_cache_dir", prev)
    assert calls == [("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))]
    assert (ROOT / ".jax_cache").is_dir()


# ------------------------------------------------------- native library


def test_native_lib_name_tracks_source(monkeypatch, tmp_path):
    """The native library's file name hashes its source: a library
    built from other source is never the one loaded."""
    from somatic_sniper_tpu.io import native

    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain")
    assert Path(lib._name) == native.lib_path()
    src = tmp_path / "sniper_native.cpp"
    src.write_bytes(native._SRC.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native, "_SRC", src)
    assert native.lib_path() != Path(lib._name)
    assert native.lib_path().parent == Path(lib._name).parent
