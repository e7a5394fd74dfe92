"""chip_smoke.py without a GPU: it must fail loudly and print no result;
its phase selection follows --four-cards."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_fails_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "found no usable GPU" in r.stderr
    assert _no_result(r.stdout)


def test_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "checkout" in r.stderr
    assert _no_result(r.stdout)


def test_phase_selection():
    cs = _load()
    assert cs.select_phases([]) == (
        "probe", "data", "golden", "scoring", "e2e", "tests"
    )
    four = cs.select_phases(["--four-cards"])
    assert four == ("probe", "data", "mesh4", "dist4")
    assert not {"golden", "scoring", "e2e", "tests"} & set(four)
    with pytest.raises(SystemExit):
        cs.select_phases(["--cards=2"])
