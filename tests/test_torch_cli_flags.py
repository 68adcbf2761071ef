"""The train CLI's flags that the port took over from the JAX CLI
(`deepvision_tpu/cli.py`): `--num-classes`, `--no-halt-on-nonfinite` and
`--cache-val` change the config as JAX's do (its `_run` driven with a
stand-in trainer that records the config); `--eval-only` restores,
evaluates once and prints `eval: ...`, and refuses with JAX's own message
when nothing was restored; `--profile-dir` writes a torch.profiler trace
of the first epoch; `--multihost` and `--compilation-cache` are refused
by name. Small LeNet-5 runs on synthetic data, on the CPU.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from deepvision_tpu import cli as jax_cli  # noqa: E402
from deepvision_tpu_torch import cli  # noqa: E402
from deepvision_tpu_torch.data import imagenet as inet  # noqa: E402
from deepvision_tpu_torch.data import records  # noqa: E402

MODELS = ["lenet5", "yolov3", "hourglass104", "resnet50_tpu"]
SMALL = ["--synthetic", "--device", "cpu", "--batch-size", "8",
         "--steps-per-epoch", "2", "--epochs", "1"]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


class _Stop(Exception):
    pass


class _JaxStandIn:
    """What JAX's `_run` needs of a trainer to reach `--eval-only`'s
    refusal: nothing restorable."""

    def __init__(self, cfg, workdir):
        self.config, self.workdir = cfg, workdir

    def init_state(self, sample_shape):
        pass

    def resume(self, epoch=None):
        return None


def jax_config(monkeypatch, argv):
    """The config JAX's `_run` builds from `argv`."""
    monkeypatch.setattr(jax_cli, "setup_compilation_cache", lambda arg: None)
    got = {}

    def factory(cfg, workdir):
        got["cfg"] = cfg
        raise _Stop

    with pytest.raises(_Stop):
        jax_cli._run("T", MODELS, factory, lambda cfg, args: (None, None),
                     argv)
    return got["cfg"]


def port_config(argv):
    args = cli.build_parser("T", MODELS).parse_args(argv)
    return cli._config_from_args(args, None)


@pytest.mark.parametrize("model,extra", [
    ("yolov3", ["--num-classes", "20"]),
    ("hourglass104", ["--num-classes", "16"]),
    ("lenet5", ["--no-halt-on-nonfinite"]),
    ("resnet50_tpu", ["--cache-val"]),
    ("resnet50_tpu", ["--cache-val", "--num-classes", "100",
                      "--no-halt-on-nonfinite", "--dataset", "imagenet"]),
    ("lenet5", []),
])
def test_flags_change_the_config_as_jax(monkeypatch, model, extra):
    argv = ["-m", model, "--workdir", "unused"] + extra
    want, got = jax_config(monkeypatch, argv), port_config(argv)
    assert got.data.num_classes == want.data.num_classes
    assert got.halt_on_nonfinite == want.halt_on_nonfinite
    assert got.data.cache_val == want.data.cache_val
    assert got.data.dataset == want.data.dataset
    if "--num-classes" in extra:
        assert got.data.num_classes == int(
            extra[extra.index("--num-classes") + 1])


def test_eval_only_without_a_checkpoint_is_refused_with_jaxs_message(
        tmp_path, monkeypatch):
    workdir = str(tmp_path / "empty")
    argv = ["-m", "lenet5", "--workdir", workdir, "--eval-only"]
    monkeypatch.setattr(jax_cli, "setup_compilation_cache", lambda arg: None)
    with pytest.raises(SystemExit) as want:
        jax_cli._run("T", MODELS, _JaxStandIn,
                     lambda cfg, args: (None, None), argv)
    with pytest.raises(SystemExit) as got:
        cli.run_classification("LeNet", ["lenet5"],
                               argv + SMALL[:3] + ["--batch-size", "8"])
    assert str(got.value) == str(want.value)
    assert "--eval-only requires a restored checkpoint" in str(got.value)


def test_eval_only_restores_and_evaluates_once(tmp_path, capsys):
    workdir = str(tmp_path / "run")
    trainer, trained = cli.run_classification(
        "LeNet", ["lenet5"], ["-m", "lenet5", "--workdir", workdir] + SMALL)
    capsys.readouterr()
    trainer, result = cli.run_classification(
        "LeNet", ["lenet5"], ["-m", "lenet5", "--workdir", workdir,
                              "-c", "latest", "--eval-only"] + SMALL)
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    line = [ln for ln in out.splitlines() if ln.startswith("eval: ")]
    assert len(line) == 1 and "top1=" in line[0] and "loss=" in line[0]
    # the same weights on the same validation batches as the training
    # run's own evaluation; no epoch was trained or saved
    for key in ("loss", "top1", "count"):
        assert result[key] == pytest.approx(trained[key], rel=1e-6)
    assert sorted(os.listdir(os.path.join(workdir, "ckpt"))) == [
        "1", "metrics.json"]


def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path):
    prof = tmp_path / "prof"
    cli.run_classification("LeNet", ["lenet5"], [
        "-m", "lenet5", "--workdir", str(tmp_path / "run"),
        "--profile-dir", str(prof)] + SMALL[:-1] + ["2"])
    assert os.listdir(prof) == ["lenet5.pt.trace.json"]
    with open(prof / "lenet5.pt.trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the two steps of epoch 1 ran under the profiler, epoch 2 did not
    assert any("conv" in n for n in names)
    assert sum(n == "ProfilerStep#" or n.startswith("aten::convolution")
               for n in names) >= 1


def test_no_halt_on_nonfinite_keeps_training(tmp_path, monkeypatch):
    """A NaN batch makes epoch 1's loss non-finite: the default halts,
    --no-halt-on-nonfinite trains on to the last epoch."""
    monkeypatch.setenv("DEEPVISION_FAULT_NAN_STEP", "0")
    argv = ["-m", "lenet5"] + SMALL[:-1] + ["2"]
    with pytest.raises(SystemExit, match="diverged"):
        cli.run_classification("LeNet", ["lenet5"], argv + [
            "--workdir", str(tmp_path / "halt")])
    trainer, result = cli.run_classification("LeNet", ["lenet5"], argv + [
        "--workdir", str(tmp_path / "go"), "--no-halt-on-nonfinite"])
    assert sorted(os.listdir(tmp_path / "go" / "ckpt")) == [
        "1", "2", "metrics.json"]


@pytest.mark.parametrize("argv,flag", [
    (["--multihost"], "--multihost"),
    (["--compilation-cache", "off"], "--compilation-cache")])
def test_jax_only_flags_are_refused_by_name(tmp_path, capsys, argv, flag):
    with pytest.raises(SystemExit) as exc:
        cli.run_classification("LeNet", ["lenet5"], [
            "-m", "lenet5", "--workdir", str(tmp_path)] + SMALL + argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} has no counterpart in the port" in err
    assert not os.path.exists(tmp_path / "ckpt")


def test_cache_val_reads_the_validation_files_once(tmp_path, monkeypatch):
    """The ImageNet pipeline under `--cache-val`: the second pass replays
    the first pass's records without opening a file, batch for batch."""
    import torch_records_fixtures as fx
    root = str(tmp_path / "inet")
    fx.write_imagenet(root, "val", [5, 4], num_classes=10)
    opened = []
    read = records.read_records
    monkeypatch.setattr(records, "read_records",
                        lambda path, **kw: opened.append(path)
                        or read(path, **kw))
    pattern = os.path.join(root, "val*")
    ds = inet.build_dataset(pattern, batch_size=3, image_size=32,
                            training=False, cache=True)
    first = [tuple(t.clone() for t in b) for b in ds.batches(0)]
    assert len(opened) == 2
    second = list(ds.batches(1))
    assert len(opened) == 2 and len(first) == len(second) == 3
    for a, b in zip(first, second):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    plain = list(inet.build_dataset(pattern, batch_size=3, image_size=32,
                                    training=False).batches(0))
    assert len(opened) == 4
    for a, b in zip(first, plain):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert np.isfinite(first[0][0].numpy()).all()
