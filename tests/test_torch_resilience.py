"""The port's resilience layer (deepvision_tpu_torch/core/resilience.py,
utils/faults.py, and the trainers' recovery paths) against the JAX package
on the CPU.

- `RetryPolicy.delay` equals JAX's exactly for each attempt on the same
  seed, and `FaultInjector.from_env` parses every carried variable as
  JAX's does (fields compared one by one; the same refusals).
- Divergence recovery against JAX: a LeNet-5 config (32 px, batch 8,
  Adam 1e-3, 3 epochs of 2 steps) from the same bridged initial weights
  on the same batches, with the NaN fault at epoch 2's first batch and
  `recover_on_divergence=1`: the same `resilience_divergence_recoveries`
  and `lr_scale` events, the same epochs logged, the same final step, the
  finite epoch losses within 1e-5 relative, and every final weight within
  tests/test_torch_lenet.py's one-Adam-step bound of a settled parameter,
  1e-6, per step taken (6 steps: 6e-6; measured 7.9e-7, c5's kernel).
- The rollback replaces everything that went NaN: parameters, optimizer
  moments and counters, BatchNorm statistics, the EMA and the plateau
  state, and the LR scale becomes plateau x recovery.
- Data retries lose no batch, a checkpoint write is retried until its
  budget runs out, the watchdog fires on a stall only (alone and inside
  `fit`), a budget of 0 (or nothing committed) still halts, a uint8
  device-augment pipeline reaches a non-finite loss from the poisoned
  batch, and the GAN trainer rolls both networks back.
"""

import os
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.core import resilience as jax_resilience
from deepvision_tpu.core.config import DataConfig as JaxDataConfig
from deepvision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deepvision_tpu.core.config import ScheduleConfig as JaxScheduleConfig
from deepvision_tpu.core.config import TrainConfig as JaxTrainConfig
from deepvision_tpu.data.synthetic import SyntheticClassification
from deepvision_tpu.models.lenet import LeNet5 as JaxLeNet5
from deepvision_tpu.utils import faults as jax_faults
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import gan
from deepvision_tpu_torch.core import resilience
from deepvision_tpu_torch.core.config import (DataConfig, OptimizerConfig,
                                              ScheduleConfig, TrainConfig)
from deepvision_tpu_torch.core.integrity import flatten
from deepvision_tpu_torch.core.trainer import Trainer, TrainingDivergedError
from deepvision_tpu_torch.data import gan as gan_data
from deepvision_tpu_torch.models import resnet
from deepvision_tpu_torch.models.lenet import LeNet5
from deepvision_tpu_torch.utils import faults
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict

BATCH, STEPS, LR = 8, 2, 1e-3
ADAM_STEP = 1e-6        # the weights' bound, per step taken
FAULT_VARS = ("DEEPVISION_FAULT_DATA_IO_STEP", "DEEPVISION_FAULT_NAN_STEP",
              "DEEPVISION_FAULT_CKPT_SAVE_FAILS",
              "DEEPVISION_FAULT_CKPT_ASYNC_FAILS",
              "DEEPVISION_FAULT_CKPT_CORRUPT")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    torch.set_num_threads(1)
    for var in FAULT_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DEEPVISION_IO_RETRY_DELAY", "0.01")


def _data(epoch):
    return SyntheticClassification(batch_size=BATCH, image_size=32,
                                   channels=1, num_classes=10,
                                   num_batches=STEPS, seed=epoch)


def _config(cls_train, cls_opt, cls_sched, cls_data, tmp_path, **kw):
    base = dict(name="resil", model="lenet5", batch_size=BATCH,
                total_epochs=3,
                optimizer=cls_opt(name="adam", learning_rate=LR),
                schedule=cls_sched(name="constant"),
                data=cls_data(dataset="synthetic", image_size=32,
                              num_classes=10, channels=1,
                              train_examples=BATCH * STEPS),
                dtype="float32", checkpoint_dir=str(tmp_path / "ckpt"),
                log_every_steps=1)
    base.update(kw)
    return cls_train(**base)


def _port_config(tmp_path, **kw):
    return _config(TrainConfig, OptimizerConfig, ScheduleConfig, DataConfig,
                   tmp_path, **kw)


def _port_trainer(tmp_path, model=None, **kw):
    return Trainer(_port_config(tmp_path, **kw), device="cpu",
                   workdir=str(tmp_path / "wd"), model=model)


# -- the primitives, against JAX -------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"base_delay": 0.01, "max_delay": 0.04, "jitter": 0.0},
    {"base_delay": 0.3, "max_delay": 2.0, "jitter": 0.5, "seed": 7},
    {"max_retries": 9, "seed": 123}])
def test_retry_delays_equal_jax_for_each_attempt(kw):
    ours, theirs = resilience.RetryPolicy(**kw), \
        jax_resilience.RetryPolicy(**kw)
    assert ours == resilience.RetryPolicy(**vars(theirs))
    a, b = random.Random(ours.seed), random.Random(theirs.seed)
    for attempt in range(1, 12):
        assert ours.delay(attempt, a) == theirs.delay(attempt, b)


def test_retry_policy_from_env_and_call_with_retry(monkeypatch):
    env = {"DEEPVISION_IO_RETRIES": "5", "DEEPVISION_IO_RETRY_DELAY": "0.2"}
    assert vars(resilience.RetryPolicy.from_env(env, seed=3)) == vars(
        jax_resilience.RetryPolicy.from_env(env, seed=3))
    p = resilience.RetryPolicy(max_retries=3, base_delay=0.001, jitter=0.0)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert resilience.call_with_retry(flaky, p, what="t") == "ok"
    assert len(calls) == 3
    with pytest.raises(OSError, match="permanent"):
        resilience.call_with_retry(
            lambda: (_ for _ in ()).throw(OSError("permanent")), p, what="t")
    with pytest.raises(ValueError):
        resilience.call_with_retry(
            lambda: (_ for _ in ()).throw(ValueError("not io")), p, what="t")


@pytest.mark.parametrize("env", [
    {}, {"DEEPVISION_FAULT_DATA_IO_STEP": "3"},
    {"DEEPVISION_FAULT_DATA_IO_STEP": "1:2", "DEEPVISION_FAULT_NAN_STEP": "5"},
    {"DEEPVISION_FAULT_NAN_STEP": "0:4"},
    {"DEEPVISION_FAULT_CKPT_SAVE_FAILS": "2",
     "DEEPVISION_FAULT_CKPT_ASYNC_FAILS": "1"},
    {"DEEPVISION_FAULT_CKPT_CORRUPT": "2"},
    {"DEEPVISION_FAULT_CKPT_CORRUPT": "3:truncate"},
    {"DEEPVISION_FAULT_CKPT_CORRUPT": "1:delete_manifest"}])
def test_fault_injector_parses_the_environment_as_jax(env):
    ours, theirs = faults.FaultInjector.from_env(env), \
        jax_faults.FaultInjector.from_env(env)
    for field in ("data_io_step", "data_io_remaining", "nan_step",
                  "ckpt_save_fails", "ckpt_async_fails",
                  "ckpt_corrupt_epoch", "ckpt_corrupt_mode", "active"):
        assert getattr(ours, field) == getattr(theirs, field), field


def test_fault_injector_refuses_what_jax_refuses():
    bad = {"DEEPVISION_FAULT_CKPT_CORRUPT": "2:shred"}
    with pytest.raises(ValueError, match="mode must be one of"):
        jax_faults.FaultInjector.from_env(bad)
    with pytest.raises(ValueError, match="mode must be one of"):
        faults.FaultInjector.from_env(bad)
    with pytest.raises(NotImplementedError, match="A6"):
        faults.FaultInjector.from_env(
            {"DEEPVISION_FAULT_CKPT_CORRUPT": "2:tamper_sharding"})


def test_data_hooks_equal_jax():
    """The same batches come out of both injectors' hooks: the transient
    errors before batch 1, then batch 2's images as f32 NaN."""
    env = {"DEEPVISION_FAULT_DATA_IO_STEP": "1:2",
           "DEEPVISION_FAULT_NAN_STEP": "2"}
    batches = [(np.full((2, 4, 4, 3), i, np.uint8),
                np.arange(2, dtype=np.int32)) for i in range(4)]
    policy = resilience.RetryPolicy(base_delay=0.001)
    got = list(resilience.resilient_batches(
        batches, policy, faults.FaultInjector.from_env(env)))
    want = list(jax_resilience.resilient_batches(
        batches, jax_resilience.RetryPolicy(base_delay=0.001),
        jax_faults.FaultInjector.from_env(env)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[2][0].dtype == np.float32 and np.isnan(got[2][0]).all()


def test_watchdog_fires_on_a_stall_only(capfd):
    assert resilience.StepWatchdog.EXIT_CODE == \
        jax_resilience.StepWatchdog.EXIT_CODE == 70
    fired = []
    wd = resilience.StepWatchdog(
        0.4, diagnostics=lambda: {"last_step": 7, "prefetch_queue_depth": 1},
        name="t", _abort=lambda: fired.append(True))
    for _ in range(3):
        time.sleep(0.15)
        wd.beat()
    assert not fired, "fired while beats were landing"
    time.sleep(1.0)
    wd.stop()
    assert fired, "did not fire on a stall past the threshold"
    err = capfd.readouterr().err
    assert "last_step=7" in err and "prefetch_queue_depth=1" in err
    assert "Thread" in err            # faulthandler's stacks


def test_the_trainer_watchdog_fires_on_a_stalled_iterator(tmp_path,
                                                           capsys):
    """`watchdog_secs` inside fit: the steps of a healthy epoch keep it
    quiet; an iterator that stalls fires it, with the last step."""
    fired = threading.Event()

    def data(epoch):
        yield from _data(epoch)
        if epoch == 2:
            fired.wait(30)        # the stall, released by the abort

    tr = _port_trainer(tmp_path, total_epochs=1, watchdog_secs=1.0,
                       prefetch_batches=1)
    tr.watchdog_abort = fired.set
    tr.fit(data)
    assert not fired.is_set()
    tr2 = _port_trainer(tmp_path, total_epochs=2, watchdog_secs=1.0,
                        prefetch_batches=1)
    tr2.watchdog_abort = fired.set
    tr2.init_state()
    assert tr2.resume() == 1
    tr2.fit(data)
    assert fired.is_set()
    err = capsys.readouterr().err
    assert "no step progress" in err and f"last_step={2 * STEPS}" in err
    tr.close()
    tr2.close()


# -- the trainers' recovery paths ------------------------------------------------

def _bridged_lenet():
    """(Flax params, the port's LeNet-5 with the same weights) from a
    seeded stream."""
    jax_model = JaxLeNet5(num_classes=10)
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1))))
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   if len(s.shape) > 1 else 0.1 * rs.randn(*s.shape))
        .astype(np.float32), shapes)["params"]
    model = LeNet5()
    model.load_state_dict(params_to_state_dict(params, model))
    return params, model


def test_divergence_recovery_matches_jax(tmp_path, monkeypatch):
    from deepvision_tpu.core.trainer import Trainer as JaxTrainer
    monkeypatch.setenv("DEEPVISION_FAULT_NAN_STEP", str(STEPS))
    params, model = _bridged_lenet()
    jcfg = _config(JaxTrainConfig, JaxOptimizerConfig, JaxScheduleConfig,
                   JaxDataConfig, tmp_path / "jax", recover_on_divergence=1)
    jtr = JaxTrainer(jcfg, workdir=str(tmp_path / "jax" / "wd"))
    jtr.init_state((32, 32, 1))
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(
        lambda old, new: jax.device_put(new, old.sharding),
        jtr.state.params, params))
    jtr.fit(_data, None, sample_shape=(32, 32, 1))
    jtr.close()

    tr = _port_trainer(tmp_path, model=model, recover_on_divergence=1)
    tr.fit(_data)
    tr.close()
    hj, hp = jtr.logger.history, tr.logger.history
    for key in ("resilience_divergence_recoveries", "resilience_lr_scale"):
        assert hp[key]["value"] == hj[key]["value"], key
        assert hp[key]["epochs"] == hj[key]["epochs"], key
    assert hp["resilience_lr_scale"]["value"] == [0.5]
    assert hp["epoch_train_loss"]["epochs"] == \
        hj["epoch_train_loss"]["epochs"] == [1, 2, 2, 3]
    for a, b in zip(hp["epoch_train_loss"]["value"],
                    hj["epoch_train_loss"]["value"]):
        assert np.isnan(a) == np.isnan(b)
        if not np.isnan(b):
            assert a == pytest.approx(b, rel=1e-5)
    steps = int(jtr.state.step)
    assert tr.state.step == steps == 3 * STEPS
    assert tr.state.optimizer.lr_scale == 0.5
    want = params_to_state_dict(jax.device_get(jtr.state.params), tr.model)
    for name, p in tr.model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= ADAM_STEP * steps, name


def test_a_spent_budget_still_halts(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPVISION_FAULT_NAN_STEP", "0")
    tr = _port_trainer(tmp_path, recover_on_divergence=3)
    with pytest.raises(TrainingDivergedError, match="no checkpoint"):
        tr.fit(_data)          # nothing committed to roll back to
    tr.close()
    monkeypatch.setenv("DEEPVISION_FAULT_NAN_STEP", str(STEPS))
    tr = _port_trainer(tmp_path / "zero", recover_on_divergence=0)
    with pytest.raises(TrainingDivergedError, match="resume from epoch 1"):
        tr.fit(_data)
    tr.close()


def _reduced_resnet():
    return resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                         block=resnet.BottleneckBlock, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))


def test_rollback_replaces_everything_that_went_nan(tmp_path):
    """Parameters, Adam's moments and counters, BatchNorm statistics, the
    EMA, the step and the plateau state all come back from the committed
    epoch; the LR scale is plateau x recovery."""
    cfg = _port_config(tmp_path, model="resnet50_tpu", ema_decay=0.9,
                       data=DataConfig(dataset="synthetic", image_size=32,
                                       num_classes=10,
                                       train_examples=BATCH * STEPS),
                       schedule=ScheduleConfig(name="plateau",
                                               plateau_patience=0,
                                               plateau_factor=0.5),
                       recover_on_divergence=1, total_epochs=1)
    tr = Trainer(cfg, device="cpu", workdir=str(tmp_path / "wd"),
                 model=_reduced_resnet())
    data = lambda e: SyntheticClassification(  # noqa: E731
        BATCH, 32, 3, 10, STEPS, seed=e)
    tr.fit(data)
    saved = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in flatten(tr.state.state_dict()).items()}
    plateau = (tr.plateau.best, tr.plateau.num_bad_epochs, tr.plateau.scale)
    with torch.no_grad():
        for t in [*tr.model.state_dict().values(), *tr.state.ema]:
            if t.is_floating_point():
                t.fill_(float("nan"))
        for s in tr.state.optimizer.inner.state.values():
            for t in s.values():
                t.fill_(float("nan"))
    tr.state.step += 5
    tr.plateau.best, tr.plateau.num_bad_epochs = float("nan"), 9
    assert tr._recover_from_divergence(2) == 1
    for k, v in flatten(tr.state.state_dict()).items():
        if torch.is_tensor(v):
            assert torch.equal(v, saved[k]), k
        elif k != "optimizer.lr_scale":
            assert v == saved[k], k
    assert (tr.plateau.best, tr.plateau.num_bad_epochs,
            tr.plateau.scale) == plateau
    assert tr.state.optimizer.lr_scale == plateau[2] * 0.5
    tr.close()


def test_a_poisoned_uint8_batch_diverges_the_device_augment_step(
        tmp_path, monkeypatch):
    """The device-augment pipeline ships uint8; the poisoned batch is f32
    NaN, which the staging and the augment take as they are, so the loss
    goes non-finite and the rollback runs."""
    monkeypatch.setenv("DEEPVISION_FAULT_NAN_STEP", str(STEPS))
    cfg = _port_config(tmp_path, model="resnet50_tpu", device_augment=True,
                       data=DataConfig(dataset="synthetic", image_size=32,
                                       num_classes=10,
                                       train_examples=BATCH * STEPS),
                       recover_on_divergence=1, total_epochs=2)
    tr = Trainer(cfg, device="cpu", workdir=str(tmp_path / "wd"),
                 model=_reduced_resnet())
    tr.fit(lambda e: SyntheticClassification(BATCH, 36, 3, 10, STEPS,
                                             seed=e, emit_uint8=True))
    losses = tr.logger.history["epoch_train_loss"]["value"]
    assert np.isnan(losses[1]) and np.isfinite(losses[-1])
    assert tr.logger.history["resilience_divergence_recoveries"][
        "value"] == [1.0]
    tr.close()


def test_data_io_retry_loses_no_batch(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPVISION_FAULT_DATA_IO_STEP", "1:2")
    tr = _port_trainer(tmp_path, total_epochs=2)
    tr.fit(_data)
    assert tr.state.step == 2 * STEPS
    assert tr.logger.history["resilience_data_io_retries"]["value"] == [
        1.0, 2.0]
    tr.close()


def test_checkpoint_write_retry_and_its_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPVISION_FAULT_CKPT_SAVE_FAILS", "2")
    tr = _port_trainer(tmp_path, total_epochs=1)
    tr.fit(_data)
    assert tr.ckpt.latest_epoch() == 1
    assert tr.logger.history["resilience_ckpt_save_retries"]["value"] == [
        1.0, 2.0]
    tr.close()
    monkeypatch.setenv("DEEPVISION_FAULT_CKPT_SAVE_FAILS", "3")
    monkeypatch.setenv("DEEPVISION_IO_RETRIES", "1")
    tr = _port_trainer(tmp_path / "b", total_epochs=1)
    with pytest.raises(OSError, match="injected transient checkpoint-write"):
        tr.fit(_data)
    tr.close()


def test_an_async_write_failure_is_retried_by_the_trainer(tmp_path,
                                                          monkeypatch):
    """Epoch 1's background write fails; epoch 2's save raises it through
    the retry path (logged), and the run ends with epoch 2 committed."""
    monkeypatch.setenv("DEEPVISION_FAULT_CKPT_ASYNC_FAILS", "1")
    tr = _port_trainer(tmp_path, total_epochs=2)
    tr.fit(_data)
    assert tr.ckpt.epochs() == [2]
    assert tr.logger.history["resilience_ckpt_save_retries"]["value"] == [
        1.0]
    tr.close()


def test_gan_rollback_restores_both_networks(tmp_path, monkeypatch):
    """A NaN batch in epoch 3 (the injector on DCGAN's bare image arrays)
    rolls both networks and both optimizers back to epoch 2's {gen, disc}
    checkpoint, halves both LR scales, and the retried epochs train
    clean."""
    monkeypatch.setenv("DEEPVISION_FAULT_NAN_STEP", "2")
    cfg = get_config("dcgan").replace(batch_size=4, total_epochs=4,
                                      recover_on_divergence=1)
    tr = gan.DCGANTrainer(cfg, workdir=str(tmp_path / "gan"), device="cpu")
    metrics = tr.fit(lambda e: gan_data.synthetic_mnist_batches(
        4, steps=1, seed=e), save_every=2)
    assert all(np.isfinite(v) for v in metrics.values())
    assert tr._recoveries == 1
    hist = tr.logger.history
    assert hist["resilience_divergence_recoveries"]["value"] == [1.0]
    assert hist["resilience_lr_scale"]["value"] == [0.5]
    assert hist["train_gen_loss"]["epochs"] == [1, 2, 3, 3, 4]
    assert tr.gen_state.optimizer.lr_scale == \
        tr.disc_state.optimizer.lr_scale == 0.5
    # 4 clean epochs of one step each: the diverged one was rolled back
    assert tr.gen_state.step == tr.disc_state.step == 4
    assert tr.ckpt.epochs() == [2, 4]
    tr.close()
