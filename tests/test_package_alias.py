"""The package's former name stays importable as an alias of ``tinyslam``."""

from __future__ import annotations

import importlib
import os
import pkgutil
import subprocess
import sys
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _former_name() -> str:
    (name,) = [m.name for m in pkgutil.iter_modules([str(REPO)])
               if m.ispkg and m.name.startswith("tinyslam_")]
    return name


def test_former_name_resolves_to_the_same_modules():
    import tinyslam.ops.hamming

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        old = importlib.import_module(_former_name() + ".ops.hamming")
        from_pkg = importlib.import_module(_former_name())
    assert old is tinyslam.ops.hamming
    assert old.__spec__.name == "tinyslam.ops.hamming"
    assert from_pkg.ops is tinyslam.ops


def test_former_name_runs_as_a_module():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-W", "ignore::DeprecationWarning", "-m",
         _former_name() + ".run", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--tracker" in out.stdout
