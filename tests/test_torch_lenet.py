"""Port LeNet-5 (deepvision_tpu_torch/models/lenet.py) and its data
(data/mnist.py, data/digits.py) against the JAX package on the CPU.

Weights are Flax `params` of LeNet5's shapes, filled from a seeded numpy
stream, carried over by the weight bridge. Bounds: the f32 forward within
1e-5 of the largest logit; one Adam step's loss within 1e-6 relative and its parameters within 1e-3
of the step (Adam's first update is lr * g / (|g| + eps): only where |g|
is far above eps is it settled); the digits splits and the idx reader bit
for bit. The digits run: from the JAX package's own initial weights, the
port's trainer reproduces the committed JAX record
(runs/r04_lenet5_digits_cpu) to within 2 of the 360 validation images at
every epoch, and ends at or above 98.0% top-1.
"""

import gzip
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deepvision_tpu.core.config import ScheduleConfig as JaxScheduleConfig
from deepvision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deepvision_tpu.core.steps import \
    make_classification_train_step as jax_make_train_step
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.core.train_state import init_model
from deepvision_tpu.data import digits as jax_digits
from deepvision_tpu.data import mnist as jax_mnist
from deepvision_tpu.models.lenet import LeNet5 as JaxLeNet5
from deepvision_tpu_torch.cli import _classification_data, build_parser
from deepvision_tpu_torch.cli import _config_from_args
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.steps import make_classification_train_step
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.data import digits, mnist
from deepvision_tpu_torch.models.lenet import LeNet5
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_classification_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "runs", "r04_lenet5_digits_cpu",
                      "lenet5_digits.jsonl")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _images(n=8, seed=1):
    return np.random.RandomState(seed).randn(n, 32, 32, 1).astype(np.float32)


def _bridged(x):
    """(JAX LeNet5, the port's with the same weights, the Flax params):
    lecun-scaled kernels and biases away from 0, from a seeded stream."""
    jax_model = JaxLeNet5(num_classes=10)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   if len(s.shape) > 1 else 0.1 * rs.randn(*s.shape))
        .astype(np.float32), shapes)["params"]
    model = LeNet5()
    model.load_state_dict(params_to_state_dict(params, model))
    return jax_model, model, params


def test_parameter_count_and_leaves():
    model = LeNet5()
    assert sum(p.numel() for p in model.parameters()) == 61_706
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == {
        "c1", "c3", "c5", "f6", "output"}


def test_forward_matches_jax():
    x = _images()
    jax_model, model, params = _bridged(x)
    apply = jax.jit(jax_model.apply)
    want = np.asarray(apply({"params": params}, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (8, 10)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_flatten_refuses_a_map_larger_than_one_pixel():
    """Flax flattens C5's NHWC map; over 1x1 that is NCHW's order too, over
    anything larger it is not, so the port refuses it."""
    with pytest.raises(ValueError, match="32x32"):
        LeNet5()(torch.zeros(1, 36, 36, 1))


def test_one_adam_step_matches_jax():
    cfg = get_config("lenet5")
    x = _images(16, seed=2)
    labels = np.random.RandomState(3).randint(0, 10, 16).astype(np.int32)
    jax_model, model, params = _bridged(x)
    tx = jax_build_optimizer(JaxOptimizerConfig(learning_rate=1e-3,
                                                name="adam"),
                             JaxScheduleConfig(), 10, 1)
    state = JaxTrainState.create(jax_model.apply, params, tx)
    step = jax_make_train_step(compute_dtype=jnp.float32, donate=False)
    new, metrics = step(state, jnp.asarray(x), jnp.asarray(labels),
                        jax.random.PRNGKey(0))
    opt = build_optimizer(model.parameters(), cfg.optimizer, cfg.schedule,
                          10, 1)
    port_state = TrainState(model, opt)
    got = make_classification_train_step(compute_dtype=torch.float32)(
        port_state, torch.from_numpy(x), torch.from_numpy(labels))
    assert float(got["loss"]) == pytest.approx(float(metrics["loss"]),
                                               rel=1e-6)
    assert float(got["top1"]) == float(metrics["top1"])
    want = params_to_state_dict(jax.device_get(new.params), model)
    before = params_to_state_dict(params, model)
    for name, p in model.named_parameters():
        g = p.grad.abs()
        settled = g > 1e-5
        diff = (p.detach() - want[name]).abs()
        assert diff[settled].max().item() <= 1e-3 * 1e-3, name
        assert diff.max().item() <= 2e-3, name
        assert (want[name] - before[name]).abs().max().item() > 0


# -- data ----------------------------------------------------------------------

def test_digits_splits_equal_jax_bit_for_bit():
    ours, theirs = digits.load_splits(32), jax_digits.load_splits(32)
    for split_ours, split_theirs in zip(ours, theirs):
        for a, b in zip(split_ours, split_theirs):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert len(ours[0][1]) == digits.TRAIN_EXAMPLES
    assert len(ours[1][1]) == digits.VAL_EXAMPLES


def _write_idx(directory, split, images, labels, gz):
    img_name, lbl_name = mnist.FILES[split]
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(os.path.join(directory, img_name + suffix), "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with opener(os.path.join(directory, lbl_name + suffix), "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_idx_reader_matches_jax(tmp_path, gz):
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (9, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 9).astype(np.uint8)
    for split in ("train", "test"):
        _write_idx(tmp_path, split, images, labels, gz)
    suffix = ".gz" if gz else ""
    img = os.path.join(tmp_path, mnist.FILES["train"][0] + suffix)
    np.testing.assert_array_equal(mnist.read_idx_images(img), images)
    lbl = os.path.join(tmp_path, mnist.FILES["train"][1] + suffix)
    np.testing.assert_array_equal(mnist.read_idx_labels(lbl), labels)
    ours = mnist.load_split(str(tmp_path), "test")
    theirs = jax_mnist.load_split(str(tmp_path), "test")
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape == (9, 32, 32, 1)
    with pytest.raises(ValueError, match="bad magic"):
        mnist.read_idx_images(lbl)


@pytest.mark.parametrize("drop", [True, False])
def test_batches_match_jax(drop):
    rs = np.random.RandomState(5)
    x, y = rs.randn(23, 4, 4, 1), np.arange(23)
    ours = list(mnist.MnistBatches(x, y, 5, shuffle=True, seed=3,
                                   drop_remainder=drop))
    theirs = list(jax_mnist.MnistBatches(x, y, 5, shuffle=True, seed=3,
                                         drop_remainder=drop))
    assert len(ours) == len(theirs) == (4 if drop else 5)
    assert len(mnist.MnistBatches(x, y, 5, drop_remainder=drop)) == len(ours)
    for (a, b), (c, d) in zip(ours, theirs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_cli_serves_mnist_from_data_dir(tmp_path):
    rs = np.random.RandomState(6)
    for split, n in (("train", 20), ("test", 7)):
        _write_idx(tmp_path, split,
                   rs.randint(0, 256, (n, 28, 28)).astype(np.uint8),
                   rs.randint(0, 10, n).astype(np.uint8), gz=True)
    args = build_parser("LeNet", ["lenet5"]).parse_args(
        ["-m", "lenet5", "--data-dir", str(tmp_path), "--batch-size", "8"])
    cfg = _config_from_args(args, None)
    train_fn, val_fn = _classification_data(cfg, args)
    train = list(train_fn(1))
    assert [len(b[1]) for b in train] == [8, 8]
    assert [len(b[1]) for b in val_fn(1)] == [7]
    assert train[0][0].shape == (8, 32, 32, 1)


# -- training --------------------------------------------------------------------

def _val_top1(path):
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    return {r["epoch"]: r["val_top1"] for r in rows if "val_top1" in r}


def test_lenet5_digits_reproduces_the_jax_record(tmp_path):
    """60 epochs of lenet5_digits (adam 1e-3, plateau) from the JAX
    trainer's initial weights: the port's val top-1 follows the committed
    JAX record epoch by epoch and ends at or above 98.0%."""
    cfg = get_config("lenet5_digits")
    init_rng, _ = jax.random.split(jax.random.PRNGKey(cfg.seed))
    params, _ = init_model(JaxLeNet5(num_classes=10), init_rng,
                           jnp.zeros((1, 32, 32, 1)))
    model = LeNet5()
    model.load_state_dict(params_to_state_dict(jax.device_get(params), model))
    trainer = Trainer(cfg, device="cpu", workdir=str(tmp_path), model=model)
    args = build_parser("LeNet", ["lenet5_digits"]).parse_args(
        ["-m", "lenet5_digits"])
    result = trainer.fit(*_classification_data(cfg, args))
    trainer.close()
    want = _val_top1(RECORD)
    got = _val_top1(tmp_path / "lenet5_digits.jsonl")
    assert sorted(got) == sorted(want) == list(range(1, 61))
    assert max(abs(got[e] - want[e]) for e in want) <= 2 / 360 + 1e-6
    assert result["top1"] >= 0.98 and result["best_metric"] >= 0.98


def test_entry_point_trains_on_digits(tmp_path):
    cmd = [sys.executable, os.path.join(REPO, "LeNet", "torch", "train.py"),
           "-m", "lenet5_digits", "--device", "cpu", "--epochs", "1",
           "--workdir", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "params=61,706" in proc.stdout
    assert "epoch 1 step 11" in proc.stdout and "val_count=360" in proc.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "metrics.json"]
    assert os.path.exists(tmp_path / "ckpt" / "1" / "integrity_manifest.json")
