"""The port stands alone: no module of deepvision_tpu_torch/ (nor its entry
points <Family>/torch/*.py for every family in FAMILIES and GAN_FAMILIES,
and chip_smoke.py, which run where JAX is not installed)
imports jax, flax, optax, orbax, tensorflow, h5py or anything of the JAX
package deepvision_tpu (the record loaders read TFRecords without
TensorFlow; the importers read h5 files and tf.train checkpoints with
readers of the port's own)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deepvision_tpu_torch")
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "deepvision_tpu",
          "tensorflow", "h5py"}
FAMILIES = ("AlexNet", "Hourglass", "Inception", "LeNet", "MobileNet",
            "ObjectsAsPoints", "ResNet", "ShuffleNet", "UNet", "VGG", "ViT",
            "YOLO")
# the GANs' entry points, named as in the JAX package
GAN_FAMILIES = {"DCGAN": ("main.py", "inference.py"),
                "CycleGAN": ("train.py", "inference.py", "convert.py")}
ENTRY_POINTS = [os.path.join(REPO, "chip_smoke.py")] + sorted(
    path for family in FAMILIES + tuple(GAN_FAMILIES)
    for path in glob.glob(os.path.join(REPO, family, "torch", "*.py")))


def _sources():
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield from ENTRY_POINTS


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
import runpy
for path in {ENTRY_POINTS[1:]!r}:
    runpy.run_path(path, run_name="not_main")
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 140


def test_every_family_has_its_entry_points():
    names = {os.path.relpath(p, REPO) for p in ENTRY_POINTS}
    for family in FAMILIES:
        assert os.path.join(family, "torch", "train.py") in names, family
    for family in ("Inception", "MobileNet", "ResNet"):
        assert os.path.join(family, "torch", "profile_step.py") in names
    for family, scripts in (("YOLO", ("detect.py", "evaluate.py")),
                            ("ObjectsAsPoints", ("detect.py", "evaluate.py")),
                            ("Hourglass", ("evaluate.py", "infer.py",
                                           "main.py")),
                            *GAN_FAMILIES.items()):
        for script in scripts:
            assert os.path.join(family, "torch", script) in names
