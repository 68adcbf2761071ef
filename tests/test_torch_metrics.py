"""The run log's provenance header and the TensorBoard scalar writer of the
port's `core/metrics.py::MetricsLogger`, against the JAX logger's
(`deepvision_tpu/core/metrics.py`): a new `<name>.jsonl` starts with
`{"meta": {...}}` under JAX's keys (`torch_version` in place of
`jax_version`), a resumed run keeps its one header, only rank 0 writes,
and scalars go to `<log_dir>/tb/<name>` when tensorboard imports (None
when it does not, as JAX's writer without TensorFlow).
"""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deepvision_tpu.core import metrics as jax_metrics  # noqa: E402
from deepvision_tpu_torch import cli  # noqa: E402
from deepvision_tpu_torch.core import metrics  # noqa: E402
from deepvision_tpu_torch.data import records  # noqa: E402


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_header_keys_are_jaxs(tmp_path):
    jl = jax_metrics.MetricsLogger(str(tmp_path / "jax"), name="run",
                                   tensorboard=False)
    jl.log(1, {"loss": 1.5})
    jl.close()
    pl = metrics.MetricsLogger(str(tmp_path / "port"), name="run",
                               tensorboard=False, device="cpu")
    pl.log(1, {"loss": 1.5})
    pl.close()
    want = _lines(tmp_path / "jax" / "run.jsonl")
    got = _lines(tmp_path / "port" / "run.jsonl")
    assert list(want[0]) == list(got[0]) == ["meta"]
    jkeys = ["torch_version" if k == "jax_version" else k
             for k in want[0]["meta"]]
    assert list(got[0]["meta"]) == jkeys
    meta = got[0]["meta"]
    assert meta["platform"] == want[0]["meta"]["platform"] == "cpu"
    assert meta["device_kind"] == "cpu"
    assert meta["n_devices"] == 1 and meta["process"] == "0/1"
    assert meta["torch_version"] == torch.__version__
    assert meta["started_at"].endswith("Z") and len(meta["started_at"]) == 20
    assert got[1]["loss"] == want[1]["loss"] == 1.5


def test_a_resumed_log_keeps_one_header(tmp_path):
    for step in range(3):
        logger = metrics.MetricsLogger(str(tmp_path), name="run",
                                       tensorboard=False, device="cpu")
        logger.log(step, {"loss": float(step)})
        logger.close()
    lines = _lines(tmp_path / "run.jsonl")
    assert [("meta" in ln) for ln in lines] == [True, False, False, False]
    assert [ln["step"] for ln in lines[1:]] == [0, 1, 2]


def test_only_rank_0_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(metrics.mesh, "is_main_process", lambda: False)
    logger = metrics.MetricsLogger(str(tmp_path / "r1"), name="run",
                                   device="cpu")
    logger.log(0, {"loss": 1.0})
    logger.close()
    assert not os.path.exists(tmp_path / "r1")


def test_scalars_go_to_tensorboard(tmp_path):
    logger = metrics.MetricsLogger(str(tmp_path), name="run", device="cpu")
    logger.log(0, {"loss": 2.0, "top1": 0.5}, prefix="val_")
    logger.log(1, {"loss": 1.0}, prefix="val_")
    logger.close()
    tb = tmp_path / "tb" / "run"
    (event_file,) = os.listdir(tb)
    assert event_file.startswith("events.out.tfevents.")
    # TFRecord-framed Event protos: the file-version event, then one a
    # scalar, CRCs checked by the port's reader
    events = list(records.read_records(str(tb / event_file)))
    assert len(events) == 1 + 3
    assert b"val_loss" in events[1] and b"val_top1" in events[2]


def test_no_tensorboard_means_no_writer(tmp_path, monkeypatch):
    for name in ("tensorboard", "tensorboard.compat.proto",
                 "tensorboard.summary.writer.record_writer"):
        monkeypatch.setitem(sys.modules, name, None)   # as if not installed
    assert metrics.make_tb_writer(str(tmp_path / "tb")) is None
    logger = metrics.MetricsLogger(str(tmp_path), name="run", device="cpu")
    logger.log(0, {"loss": 1.0})
    logger.close()
    assert sorted(os.listdir(tmp_path)) == ["run.jsonl"]


def test_the_writer_loads_no_tensorflow(tmp_path):
    """The port never loads TensorFlow, not through tensorboard either
    (a fresh interpreter: TensorFlow is installed here)."""
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "from deepvision_tpu_torch.core.metrics import MetricsLogger\n"
        "log = MetricsLogger(%r, name='run', device='cpu')\n"
        "log.log(0, {'loss': 1.0}); log.close()\n"
        "assert 'tensorflow' not in sys.modules, 'tensorflow loaded'\n"
        "print(sorted(__import__('os').listdir(%r)))\n"
        % (REPO, str(tmp_path), str(tmp_path / "tb" / "run")))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "events.out.tfevents." in proc.stdout


def test_a_training_run_log_starts_with_its_header(tmp_path):
    torch.set_num_threads(1)
    argv = ["-m", "lenet5", "--synthetic", "--device", "cpu",
            "--batch-size", "8", "--steps-per-epoch", "2", "--workdir",
            str(tmp_path)]
    cli.run_classification("LeNet", ["lenet5"], argv + ["--epochs", "1"])
    cli.run_classification("LeNet", ["lenet5"], argv + ["--epochs", "2",
                                                        "-c", "latest"])
    lines = _lines(tmp_path / "lenet5.jsonl")
    assert "meta" in lines[0] and not any("meta" in ln for ln in lines[1:])
    assert lines[0]["meta"]["platform"] == "cpu"
    assert {ln.get("epoch") for ln in lines[1:]} >= {1, 2}
    assert os.listdir(tmp_path / "tb" / "lenet5")

