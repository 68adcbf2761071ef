"""The port's IR audit against real bug shapes: each test replants one of
the JAX audit's mutation shapes (tests/test_jaxvet.py) into a copy of
deepvision_tpu_torch/ and CHECK_COST_TORCH.json, and runs `python -m
deepvision_tpu_torch.check` on it as a subprocess (exit 1, the finding
named); `test_clean_tree_is_silent` is their silent half, the real
package audited in-process on every check.

- DTYPE: resnet34's bf16 backbone convs built at f32;
- COST: resnet34's stem widened 2x (its BN and first block with it);
- QUANT: `Int8Mode`'s planned branch dequantizing the weight and running
  the float call, on `quant/lenet5`.

A clean tree is silent on every check (lenet5, resnet34, and the int8
twins of the `quant` target). The alias rule
rides here too: centernet and objects_as_points are one config under two
names, traced once and reported under both.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _mutated_tree(tmp_path, relpath, edits):
    """A copy of the port and its cost baseline with `edits` ((old, new)
    pairs, each old found exactly once) applied to `relpath`."""
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copytree(os.path.join(REPO, "deepvision_tpu_torch"),
                    tree / "deepvision_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "CHECK_COST_TORCH.json"),
                tree / "CHECK_COST_TORCH.json")
    path = tree / "deepvision_tpu_torch" / relpath
    src = path.read_text()
    for old, new in edits:
        assert src.count(old) == 1, f"mutation anchor drifted: {old!r}"
        src = src.replace(old, new)
    path.write_text(src)
    return tree


def _run_check(tree, *args):
    env = dict(os.environ, PYTHONPATH=str(tree), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.check", *args,
         "--format", "json"], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(tree))
    assert proc.stdout.strip(), proc.stderr[-3000:]
    return proc.returncode, json.loads(proc.stdout)["findings"]


def _audit(names, select):
    from deepvision_tpu_torch.check import audit
    return audit(names, select=select)


@pytest.mark.parametrize("name", ["lenet5", "resnet34", "quant"])
def test_clean_tree_is_silent(name):
    from deepvision_tpu_torch.check import audit
    findings, report = audit([name])
    assert findings == [], [f.format() for f in findings]
    assert report["n_units"] == 3


def test_mutation_dtype_f32_backbone(tmp_path):
    tree = _mutated_tree(tmp_path, "models/resnet.py", [(
        "            main += [Conv(cin, cout, k, s, dtype=dtype, padding=pad),",
        "            main += [Conv(cin, cout, k, s, dtype=torch.float32,\n"
        "                          padding=pad),")])
    rc, found = _run_check(tree, "resnet34", "--select", "DTYPE")
    assert rc == 1, found
    assert any(f["check"] == "DTYPE" and f["unit"] == "resnet34/train"
               and "f32 aten.convolution" in f["message"] for f in found)
    assert {f["check"] for f in found} == {"DTYPE"}


def test_mutation_cost_stem_widened(tmp_path):
    tree = _mutated_tree(tmp_path, "models/resnet.py", [
        ("            self.stem_conv = Conv(channels, width, 7, 2, "
         "dtype=dtype,",
         "            self.stem_conv = Conv(channels, 2 * width, 7, 2, "
         "dtype=dtype,"),
        ("            _BN(width, dtype=dtype if lowp_bn else torch.float32)]",
         "            _BN(2 * width, dtype=dtype if lowp_bn "
         "else torch.float32)]"),
        ("        expansion = 4 if block is BottleneckBlock else 1\n"
         "        c = width\n",
         "        expansion = 4 if block is BottleneckBlock else 1\n"
         "        c = 2 * width\n")])
    rc, found = _run_check(tree, "resnet34", "--select", "COST")
    assert rc == 1, found
    units = {f["unit"] for f in found if f["check"] == "COST"
             and "flops drifted" in f["message"]}
    assert units == {"resnet34/train", "resnet34/eval", "resnet34/serve"}


def test_mutation_quant_widened_to_float(tmp_path):
    tree = _mutated_tree(tmp_path, "ops/quant.py", [(
        "                return int8_call(op.prim, args, kwargs, qw, s_x)\n",
        "                w = qw.w.float() * qw.s.view(\n"
        "                    -1, *[1] * (qw.w.dim() - 1))\n"
        "                return func(args[0], w.to(args[1].dtype), "
        "*args[2:],\n"
        "                            **kwargs)\n")])
    rc, found = _run_check(tree, "quant", "--select", "QUANT")
    assert rc == 1, found
    lenet = [f for f in found if f["unit"] == "quant/lenet5"]
    assert any("quietly skipped" in f["message"] for f in lenet)
    assert any("float" in f["message"]
               and "outside the f32 heads" in f["message"] for f in lenet)


def test_aliases_trace_once_and_report_under_both_names():
    findings, report = _audit(["centernet", "objects_as_points"], None)
    assert findings == [], [f.format() for f in findings]
    assert report["aliases"] == {"objects_as_points": "centernet"}
    prefixes = {u.split("/")[0] for u in report["units"]}
    assert prefixes == {"centernet", "objects_as_points"}
    assert report["cost"]["objects_as_points/train"] == \
        report["cost"]["centernet/train"]
    assert len(report["units"]) == 8
