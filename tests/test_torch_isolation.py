"""The port stands alone: no module of deepvision_tpu_torch/ (nor
chip_smoke.py, which runs where JAX is not installed) imports jax, flax,
optax, orbax or anything of the JAX package deepvision_tpu."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deepvision_tpu_torch")
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "deepvision_tpu"}


def _sources():
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in BANNED]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_every_port_module_imports_with_jax_blocked():
    script = f"""
import importlib, pkgutil, sys
for name in {sorted(BANNED)!r}:
    sys.modules[name] = None      # any import of these now raises
sys.path.insert(0, {REPO!r})
import deepvision_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 15
