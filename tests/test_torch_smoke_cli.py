"""``chip_smoke.py`` off the card: the whole script compiles and imports and
refuses to run without a card, every kernel its paths must launch is one
that ``kernels._build`` counts, and the dead-code report, which roots on the
script's imports, finds every module of the port reachable."""
import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_exits_2_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run")
    proc = subprocess.run([sys.executable, SMOKE], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "chip_smoke: no CUDA device is available" in proc.stderr
    assert proc.stdout == ""


def test_smoke_paths_name_counted_kernels():
    paths = _smoke_module().PATHS
    named = {k for kernels in paths.values() for k in kernels}
    assert named and named <= set(_build.LAUNCHES), sorted(named - set(_build.LAUNCHES))


def test_dead_code_report_finds_every_module_reachable():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--dead-code"],
                          capture_output=True, text=True, timeout=300, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    counts = re.findall(r"^unreachable[^:]*: (\d+)$", proc.stdout, re.MULTILINE)
    assert counts == ["0", "0"], proc.stdout
