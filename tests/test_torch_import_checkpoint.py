"""The PyTorch checkpoint importer (deepvision_tpu_torch/utils/
torch_convert.py, deepvision_tpu_torch/tools/import_torch_checkpoint.py)
against the JAX package on the CPU.

- `convert` equals JAX's array for array (same tree, same dtype, same
  values) for every `-m` choice, on state dicts in the reference's naming
  built here with seeded values (`reference_state_dict`: the key layout
  of tests/test_torch_convert.py's reference modules, small widths; only
  the first Linear of VGG and AlexNet keeps its real fan-in, which the
  flatten permutation needs).
- The import tool's workdir served by the port's engine against JAX's
  apply on JAX's own trees of the same file: lenet5 (f32, 1e-5) and the
  reference's resnet34 (2 basic blocks a stage, full width, served at 64
  px in the config's bf16: 5e-2 of the largest logit, tests/test_torch_
  vit.py's bf16 bound; measured 3.8e-3, and 5.3e-3 against the
  reference module's own f32 output, which is held to it too).
- The pins written to `model_kwargs.json`, the checkpoint's manifest and
  `imported_from`, `train -c latest` resuming it, and the weights-only
  refusal with `--allow-pickle` as its one way round.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.models.lenet import LeNet5 as JaxLeNet5
from deepvision_tpu.models.resnet import BasicBlock as JaxBasicBlock
from deepvision_tpu.models.resnet import ResNet as JaxResNet
from deepvision_tpu.utils import torch_convert as jax_convert
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.tools import import_torch_checkpoint as tool
from deepvision_tpu_torch.utils import torch_convert
from test_torch_convert import (_kaiming_all, _TorchBasicResNet,
                                _TorchLeNet5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Scheduler:
    """A non-tensor payload entry, as a pickled LR scheduler is."""


def _bn(sd, prefix, c, rs):
    sd[f"{prefix}.weight"] = 1 + 0.1 * rs.randn(c)
    sd[f"{prefix}.bias"] = 0.1 * rs.randn(c)
    sd[f"{prefix}.running_mean"] = 0.1 * rs.randn(c)
    sd[f"{prefix}.running_var"] = 1 + rs.rand(c)
    sd[f"{prefix}.num_batches_tracked"] = np.array(3)


def _resnet(sd, rs, stage_sizes, bottleneck, w=2):
    sd["conv1.weight"] = rs.randn(w, 3, 7, 7)
    _bn(sd, "bn1", w, rs)
    convs = 3 if bottleneck else 2
    for stage, n in zip(torch_convert.RESNET_TORCH_STAGES, stage_sizes):
        for i in range(n):
            t = f"{stage}.{i}"
            for j in range(1, convs + 1):
                sd[f"{t}.conv{j}.weight"] = rs.randn(w, w, 3, 3)
                _bn(sd, f"{t}.bn{j}", w, rs)
            if i == 0:
                sd[f"{t}.projection.0.weight"] = rs.randn(w, w, 1, 1)
                _bn(sd, f"{t}.projection.1", w, rs)
    sd["linear.weight"], sd["linear.bias"] = rs.randn(5, w), rs.randn(5)


def _sequential(sd, rs, n_convs, fc_in):
    for i in range(n_convs):
        sd[f"features.{3 * i}.weight"] = rs.randn(2, 2, 3, 3)
        sd[f"features.{3 * i}.bias"] = rs.randn(2)
    for j, (i, fan_in) in enumerate(((1, fc_in), (4, 3), (6, 3))):
        sd[f"classifier.{i}.weight"] = rs.randn(3 if j < 2 else 5, fan_in)
        sd[f"classifier.{i}.bias"] = rs.randn(3 if j < 2 else 5)


def reference_state_dict(name: str, seed: int = 0) -> dict:
    """A state dict with the reference checkpoint's keys for `name`,
    seeded f32 values, small widths."""
    rs = np.random.RandomState(seed)
    sd: dict = {}
    if name in torch_convert.RESNET_STAGE_SIZES:
        _resnet(sd, rs, torch_convert.RESNET_STAGE_SIZES[name], True)
    elif name == "resnet34":
        _resnet(sd, rs, (2, 2, 2, 2), False)
    elif name in ("vgg16", "vgg19"):
        _sequential(sd, rs, 13 if name == "vgg16" else 16, 7 * 7 * 512)
    elif name in ("alexnet1", "alexnet2"):
        _sequential(sd, rs, 5, 6 * 6 * 256)
    elif name == "mobilenet_v1":
        sd["features.0.weight"] = rs.randn(2, 3, 3, 3)
        _bn(sd, "features.1", 2, rs)
        for i in range(13):
            t = f"features.{3 + i}"
            sd[f"{t}.dw.conv.weight"] = rs.randn(2, 1, 3, 3)
            _bn(sd, f"{t}.dw.bn", 2, rs)
            sd[f"{t}.pw.conv.weight"] = rs.randn(2, 2, 1, 1)
            _bn(sd, f"{t}.pw.bn", 2, rs)
        sd["linear.weight"], sd["linear.bias"] = rs.randn(5, 2), rs.randn(5)
    elif name == "inception_v1":
        prefixes = list(jax_convert._INCEPTION_STEM) + [
            f"inception_{m}.{b}" for m in jax_convert._INCEPTION_MODULES
            for b in jax_convert._INCEPTION_BRANCHES]
        for prefix in prefixes + ["aux1.features.1", "aux2.features.1"]:
            sd[f"{prefix}.conv.weight"] = rs.randn(2, 2, 1, 1)
            sd[f"{prefix}.conv.bias"] = rs.randn(2)
        for aux in ("aux1", "aux2"):
            sd[f"{aux}.classifier.0.weight"] = rs.randn(3, 4 * 4 * 2)
            sd[f"{aux}.classifier.0.bias"] = rs.randn(3)
            sd[f"{aux}.classifier.3.weight"] = rs.randn(5, 3)
            sd[f"{aux}.classifier.3.bias"] = rs.randn(5)
        sd["linear.weight"], sd["linear.bias"] = rs.randn(5, 2), rs.randn(5)
    elif name == "lenet5":
        for i in (0, 4, 8):
            sd[f"features.{i}.weight"] = rs.randn(2, 2, 5, 5)
            sd[f"features.{i}.bias"] = rs.randn(2)
        for i in (0, 2):
            sd[f"classifier.{i}.weight"] = rs.randn(3, 2)
            sd[f"classifier.{i}.bias"] = rs.randn(3)
    else:
        raise KeyError(name)
    return {k: torch.from_numpy(np.asarray(v, np.float32)
                                if v.dtype.kind == "f" else v)
            for k, v in sd.items()}


def _same_tree(got, want, where=""):
    assert isinstance(got, dict) and set(got) == set(want), where
    for key in want:
        if isinstance(want[key], dict):
            _same_tree(got[key], want[key], f"{where}/{key}")
        else:
            assert got[key].dtype == want[key].dtype, f"{where}/{key}"
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{where}/{key}")


@pytest.mark.parametrize("name", tool.CHOICES)
def test_convert_equals_the_jax_importer_array_for_array(name):
    sd = reference_state_dict(name)
    if name == "resnet50":                 # the DataParallel wrap's prefix
        sd = {f"module.{k}": v for k, v in sd.items()}
    got, want = torch_convert.convert(name, sd), jax_convert.convert(name, sd)
    _same_tree(got[0], want[0], name)
    _same_tree(got[1], want[1], name)


def test_unknown_model_and_leftover_weights_raise_as_in_jax():
    with pytest.raises(KeyError, match="no torch-checkpoint converter"):
        torch_convert.convert("yolov3", {})
    sd = reference_state_dict("resnet50")
    sd["conv2x.3.conv1.weight"] = sd["conv2x.0.conv1.weight"]
    with pytest.raises(ValueError, match="unconsumed"):
        torch_convert.convert("resnet50", sd)


@pytest.mark.parametrize("name", tool.CHOICES)
def test_pins_are_the_jax_importers(name):
    sd = reference_state_dict(name)
    want = {"resnet34": {"stage_sizes": [2, 2, 2, 2],
                         "project_first_blocks": True},
            "inception_v1": {"use_bn": False}}.get(
        name, {"stride_on_first": True} if name.startswith("resnet")
        else {})
    assert tool.architecture_pins(name, sd) == want


def _reference_module(name):
    torch.manual_seed(0)
    tm = (_TorchLeNet5() if name == "lenet5"
          else _TorchBasicResNet(width=64, num_classes=1000)).eval()
    _kaiming_all(tm)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    return tm


def _jax_apply(name, params, stats, x):
    if name == "lenet5":
        model, variables = JaxLeNet5(num_classes=10), {"params": params}
    else:
        model = JaxResNet(stage_sizes=(2, 2, 2, 2), block=JaxBasicBlock,
                          num_classes=1000, dtype=jnp.bfloat16,
                          project_first_blocks=True)
        variables = {"params": params, "batch_stats": stats}
    return np.asarray(model.apply(variables, jnp.asarray(x), train=False),
                      np.float32)


@pytest.mark.parametrize("name,size,bound", [("lenet5", 32, 1e-5),
                                             ("resnet34", 64, 5e-2)])
def test_imported_workdir_serves_jax_apply(name, size, bound, tmp_path):
    tm = _reference_module(name)
    path = str(tmp_path / f"{name}.pt")
    torch.save({"epoch": 7, "model": tm.state_dict(),
                "optimizer": {"state": {}, "param_groups": []},
                "loggers": {"top1": [0.5]}}, path)
    wd = str(tmp_path / "wd")
    got = tool.main(["-m", name, "--torch-ckpt", path, "--workdir", wd,
                     "--device", "cpu"])
    assert got == {"workdir": wd, "epoch": 7,
                   "pins": tool.architecture_pins(name, tm.state_dict())}
    with open(os.path.join(wd, "model_kwargs.json")) as fp:
        assert json.load(fp) == got["pins"]
    engine = PredictEngine.from_config(name, workdir=wd, device="cpu",
                                       buckets=(2,), image_size=size,
                                       verbose=False)
    assert engine.provenance["weights"] == "checkpoint"
    assert engine.provenance["checkpoint_epoch"] == 7
    assert engine.provenance["verified"] is True
    channels = 1 if name == "lenet5" else 3
    x = np.random.RandomState(1).rand(2, size, size, channels).astype(
        np.float32)
    served = engine.predict(x)
    params, stats = jax_convert.convert(name, tm.state_dict())
    want = _jax_apply(name, params, stats, x)
    scale = np.abs(want).max()
    assert np.abs(served - want).max() <= bound * max(scale, 1.0)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert np.abs(served - ref).max() <= bound * max(scale, 1.0)


def test_checkpoint_carries_its_origin_and_train_resumes_it(tmp_path):
    from deepvision_tpu_torch.cli import run_classification
    from deepvision_tpu_torch.core.checkpoint import CheckpointManager

    path = str(tmp_path / "lenet5.pt")
    torch.save(_reference_module("lenet5").state_dict(), path)  # bare dict
    wd = str(tmp_path / "wd")
    assert tool.main(["-m", "lenet5", "--torch-ckpt", path, "--workdir",
                      wd, "--device", "cpu"])["epoch"] == 0
    ckpt = CheckpointManager(os.path.join(wd, "ckpt"))
    try:
        _, host, epoch = ckpt.restore(verify="strict")
        assert epoch == 0 and host["imported_from"] == path
        assert ckpt.last_restore_info["verified"] is True
    finally:
        ckpt.close()
    run_classification("LeNet", ["lenet5"], argv=[
        "-m", "lenet5", "--synthetic", "-c", "latest", "--epochs", "1",
        "--batch-size", "8", "--steps-per-epoch", "1", "--workdir", wd,
        "--device", "cpu"])
    ckpt = CheckpointManager(os.path.join(wd, "ckpt"))
    try:
        assert ckpt.epochs() == [0, 1]
    finally:
        ckpt.close()


def test_a_pickled_payload_is_refused_unless_allowed(tmp_path):
    path = str(tmp_path / "pickled.pt")
    torch.save({"epoch": 2, "model": _reference_module("lenet5").state_dict(),
                "scheduler": _Scheduler()}, path)
    wd = str(tmp_path / "wd")
    with pytest.raises(SystemExit, match="needs full \\(unsafe\\) "
                                         "unpickling"):
        tool.main(["-m", "lenet5", "--torch-ckpt", path, "--workdir", wd,
                   "--device", "cpu"])
    assert not os.path.exists(os.path.join(wd, "ckpt"))
    got = tool.main(["-m", "lenet5", "--torch-ckpt", path, "--workdir", wd,
                     "--device", "cpu", "--allow-pickle"])
    assert got["epoch"] == 2
    with pytest.raises(FileNotFoundError):
        tool.main(["-m", "lenet5", "--torch-ckpt",
                   str(tmp_path / "missing.pt"), "--workdir", wd,
                   "--device", "cpu"])


def test_the_import_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                               tmp_path):
    """The default `--device` is the card: without one the tool raises
    before it reads the file or writes the workdir."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "lenet5.pt")
    torch.save(_reference_module("lenet5").state_dict(), path)
    wd = str(tmp_path / "wd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["-m", "lenet5", "--torch-ckpt", path, "--workdir", wd])
    assert not os.path.exists(wd)
