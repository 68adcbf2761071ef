"""The port's YOLO training path (deepvision_tpu_torch/core/{detection,
trainer,optim,schedules,checkpoint}.py, cli.py, YOLO/torch/train.py)
against the JAX package on the CPU.

One train step of the tiny YoloV3 (width_mult 0.125, stages (1, 1, 1, 1,
1), 4 classes, 64 px, f32) runs in both packages from the same bridged
weights on the same `synthetic_batches(seed=0)` batch, with Adam at lr
1e-3. The JAX step is compiled once. Its gradients are read back from the
Adam state (mu = (1 - b1) g after the first update). Bounds:
- loss and components: 1e-4 relative (summation order);
- gradients: 1e-3 of each leaf's largest gradient — they pass back through
  30 conv and BatchNorm layers whose sums run in another order;
- batch_stats after the step: 1e-5 (one f32 mean and biased variance);
- parameters after the Adam step: 1e-6, 0.1% of the step, wherever the
  gradient's sign is settled (|g| above 1e-4 of its leaf's largest, the
  gradients' own agreement): the first Adam update is lr * g / (|g| + eps),
  about lr * sign(g), so a gradient that is zero up to rounding (1.6% of
  the elements here, held under 5%) may step either way in either package. Fed JAX's own
  gradients, the port's Adam chain gives JAX's parameters within 1e-7
  (one f32 rounding of a parameter below 1 in size).
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deepvision_tpu.core.config import ScheduleConfig as JaxScheduleConfig
from deepvision_tpu.core.detection import \
    make_yolo_train_step as jax_make_train_step
from deepvision_tpu.core.optim import build_optimizer
from deepvision_tpu.core.schedules import PlateauState as JaxPlateauState
from deepvision_tpu.core.schedules import build_schedule as jax_schedule
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.data.detection import \
    synthetic_batches as jax_synthetic_batches
from deepvision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deepvision_tpu_torch.cli import run_detection
from deepvision_tpu_torch.core.checkpoint import CheckpointManager
from deepvision_tpu_torch.core.config import OptimizerConfig, ScheduleConfig
from deepvision_tpu_torch.core.detection import make_yolo_train_step
from deepvision_tpu_torch.core.optim import build_optimizer as port_optimizer
from deepvision_tpu_torch.core.optim import clip_by_global_norm_
from deepvision_tpu_torch.core.schedules import PlateauState, build_schedule
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.models.yolo import YoloV3
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_yolo import GRIDS, TINY, flax_yolo_variables

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_yolo_train_step` by name to the JAX package's donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def one_step():
    torch.set_num_threads(1)
    batch = next(jax_synthetic_batches(batch_size=2, image_size=64,
                                       num_classes=4, steps=1, seed=0))
    jax_model = JaxYoloV3(**TINY, dtype=jnp.float32)
    params, stats = flax_yolo_variables(jax_model, batch[0], seed=0)
    tx = build_optimizer(JaxOptimizerConfig(name="adam", learning_rate=LR),
                         JaxScheduleConfig(), 10, 1)
    state = JaxTrainState.create(jax_model.apply, params, tx, stats)
    step = jax_make_train_step(num_classes=4, grid_sizes=GRIDS,
                               compute_dtype=jnp.float32, donate=False)
    new, metrics = step(state, *map(jnp.asarray, batch),
                        jax.random.PRNGKey(0))
    adam = next(s for s in new.opt_state.inner_state if hasattr(s, "mu"))
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                            jax.device_get(adam.mu)),
            "params": jax.device_get(new.params),
            "batch_stats": jax.device_get(new.batch_stats)}

    model = YoloV3(**TINY, dtype=torch.float32)
    before = params_to_state_dict(params, model, stats)
    model.load_state_dict(before)
    opt = port_optimizer(model.parameters(),
                         OptimizerConfig(name="adam", learning_rate=LR),
                         ScheduleConfig(), 10, 1)
    port_state = TrainState(model, opt)
    port_step = make_yolo_train_step(num_classes=4, grid_sizes=GRIDS,
                                     compute_dtype=torch.float32)
    port_batch = next(synthetic_batches(batch_size=2, image_size=64,
                                        num_classes=4, steps=1, seed=0))
    got = port_step(port_state, *map(torch.from_numpy, port_batch))
    return {"want": want, "model": model, "state": port_state,
            "metrics": {k: float(v) for k, v in got.items()},
            "batch": batch, "port_batch": port_batch}


def test_synthetic_batches_are_the_jax_ones_bit_for_bit(one_step):
    for w, g in zip(one_step["batch"], one_step["port_batch"]):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    for w, g in zip(jax_synthetic_batches(batch_size=3, image_size=32,
                                          steps=2, num_boxes=5, seed=4),
                    synthetic_batches(batch_size=3, image_size=32, steps=2,
                                      num_boxes=5, seed=4)):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)


def test_one_step_loss_and_components_match_jax(one_step):
    want, got = one_step["want"]["metrics"], one_step["metrics"]
    assert set(got) == set(want) == {"loss", "xy_loss", "wh_loss",
                                     "class_loss", "obj_loss"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert one_step["state"].step == 1 and one_step["state"].optimizer.count == 1


def _jax_grads(one_step):
    return params_to_state_dict(one_step["want"]["grads"], one_step["model"],
                                one_step["want"]["batch_stats"])


def test_one_step_gradients_match_jax(one_step):
    model = one_step["model"]
    want = _jax_grads(one_step)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == {k for k in want if "running" not in k}
    for name, g in grads.items():
        w = want[name]
        scale = w.abs().max().item()
        assert scale > 0, name
        assert (g - w).abs().max().item() <= 1e-3 * scale, name


def test_one_step_batch_stats_match_jax(one_step):
    """Flax's running variance takes the biased batch variance."""
    model = one_step["model"]
    want = params_to_state_dict(one_step["want"]["params"], model,
                                one_step["want"]["batch_stats"])
    sd = model.state_dict()
    stats = [k for k in want if "running" in k]
    assert len(stats) == 2 * sum(1 for k in sd if k.endswith("running_var"))
    for k in stats:
        torch.testing.assert_close(sd[k], want[k], rtol=1e-5, atol=1e-5)


def test_one_adam_step_matches_jax(one_step):
    model = one_step["model"]
    want = params_to_state_dict(one_step["want"]["params"], model,
                                one_step["want"]["batch_stats"])
    grads = _jax_grads(one_step)
    unsettled = total = 0
    for name, p in model.named_parameters():
        g = grads[name].abs()
        settled = g >= 1e-4 * g.max()
        diff = (p.detach() - want[name]).abs()
        assert diff[settled].max().item() <= LR * 1e-3, name
        assert diff.max().item() <= 2 * LR * (1 + 1e-3), name
        unsettled += int((~settled).sum())
        total += g.numel()
    assert unsettled < 0.05 * total


def test_adam_chain_on_jax_gradients_gives_jax_parameters(one_step):
    """The optimizer alone: clip-free Adam, schedule, -1, lr_scale."""
    fresh = YoloV3(**TINY, dtype=torch.float32)
    batch = one_step["batch"]
    params, stats = flax_yolo_variables(JaxYoloV3(**TINY, dtype=jnp.float32),
                                        batch[0], seed=0)
    fresh.load_state_dict(params_to_state_dict(params, fresh, stats))
    opt = port_optimizer(fresh.parameters(),
                         OptimizerConfig(name="adam", learning_rate=LR),
                         ScheduleConfig(), 10, 1)
    grads = _jax_grads(one_step)
    for name, p in fresh.named_parameters():
        p.grad = grads[name].clone()
    opt.step()
    want = params_to_state_dict(one_step["want"]["params"], fresh,
                                one_step["want"]["batch_stats"])
    for name, p in fresh.named_parameters():
        assert (p.detach() - want[name]).abs().max().item() <= 1e-7, name


def test_plateau_matches_jax():
    metrics = [5.0, 4.0, 4.5, 4.2, 4.1, 3.9, 4.0, 4.0, 4.0, 4.0, 3.0, 3.5]
    for mode in ("min", "max"):
        ref = JaxPlateauState(patience=2, factor=0.5, mode=mode)
        port = PlateauState(patience=2, factor=0.5, mode=mode)
        for m in metrics:
            assert port.update(m) == ref.update(m)
            assert (port.best, port.num_bad_epochs) == (ref.best,
                                                        ref.num_bad_epochs)


@pytest.mark.parametrize("name,kw", [
    ("step", dict(boundaries_epochs=(2, 3.5, 3.5), decay_factor=0.1)),
    ("step", dict(boundaries_epochs=(70, 90), decay_factor=0.5)),
    ("constant", {}),
    ("plateau", {}),
])
def test_schedules_match_optax(name, kw):
    ref = jax_schedule(JaxScheduleConfig(name=name, **kw), 0.01, 4, 10)
    port = build_schedule(ScheduleConfig(name=name, **kw), 0.01, 4, 10)
    for count in range(20):
        assert port(count) == pytest.approx(float(ref(count)), rel=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    import optax
    rs = np.random.RandomState(8)
    grads = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_checkpoints_keep_the_newest_and_the_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, keep_best=True,
                            best_mode="min")
    for epoch, metric in [(1, 3.0), (2, 1.0), (3, 2.0), (4, 2.5), (5, None)]:
        mgr.save(epoch, {"w": torch.full((2,), float(epoch))}, metric=metric)
    assert mgr.best_epoch() == 2 and mgr.epochs() == [2, 4, 5]
    payload, _, epoch = mgr.restore()
    assert epoch == 5 and payload["w"].tolist() == [5.0, 5.0]
    mgr.close()
    again = CheckpointManager(str(tmp_path), keep=2, best_mode="min")
    assert again.best_epoch() == 2 and again.restore(2)[2] == 2
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    with pytest.raises(FileNotFoundError):
        again.restore(3)


def _train(workdir, *extra):
    cmd = [sys.executable, os.path.join(REPO, "YOLO", "torch", "train.py"),
           "-m", "yolov3_digits", "--synthetic", "--device", "cpu",
           "--steps-per-epoch", "2", "--batch-size", "2", "--workdir",
           str(workdir), *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_entry_point_trains_saves_and_resumes(tmp_path):
    first = _train(tmp_path, "--epochs", "1")
    assert first.returncode == 0, first.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "metrics.json"]
    assert os.path.exists(tmp_path / "ckpt" / "1" / "integrity_manifest.json")
    assert "done: best=" in first.stdout
    second = _train(tmp_path, "--epochs", "2", "-c", "latest")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from epoch 1" in second.stdout
    assert "epoch 2 step 4" in second.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2",
                                                     "metrics.json"]
    assert os.path.exists(tmp_path / "ckpt" / "2" / "integrity_manifest.json")
    val = [float(line.split("val_loss=")[1].split()[0])
           for line in second.stdout.splitlines() if "val_loss=" in line]
    assert len(val) == 1 and math.isfinite(val[0])


def test_entry_point_without_device_raises_on_a_host_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_detection("YOLO", ["yolov3_digits"],
                      ["-m", "yolov3_digits", "--synthetic", "--workdir",
                       str(tmp_path)])
    assert not os.listdir(tmp_path)
