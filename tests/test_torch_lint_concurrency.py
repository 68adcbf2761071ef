"""The port's threaded serving code (deepvision_tpu_torch/serve/ and
flywheel/) held to the JAX package's framework-free concurrency linter
(deepvision_tpu/lint/concurrency.py): no unguarded write to lock-guarded
state (LCK001), no read-modify-write outside its guard (LCK002), no
lock-order cycle (LCK003), no blocking call under a lock (LCK004), and
no thread that is neither a daemon nor joined (THR001). The engine's
int8 state, which flips under its lock, is part of what it checks."""

import os

import pytest

from deepvision_tpu.lint.cli import main as jaxlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = "LCK001,LCK002,LCK003,LCK004,THR001"


@pytest.mark.parametrize("package", ["serve", "flywheel"])
def test_threaded_serve_code_is_clean(package, capsys):
    path = os.path.join(REPO, "deepvision_tpu_torch", package)
    rc = jaxlint(["--select", RULES, "--no-cache", path])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "jaxlint: clean" in out
