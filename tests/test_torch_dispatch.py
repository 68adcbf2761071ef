"""k steps per dispatch, the epoch cache and the whole-epoch path, the
trainer's guards, the CLI's lever flags and the flywheel's fine-tune
config in the port (deepvision_tpu_torch/core/{steps,trainer}.py,
data/device_cache.py, cli.py, flywheel/controller.py) against the JAX
package on the CPU.

LeNet-5 (f32, batch 8, its Adam, an EMA at 0.9) from the same weights in both
packages (Flax shapes filled from numpy, `test_torch_lenet._bridged`;
SGD at 0.05 where the two packages are compared, so that a weight's
difference stays the size of its gradient's, which Adam's sign-like
first steps would not keep):
- k = 2 and 4 steps per dispatch against k = 1 in the port's trainer:
  the parameters and the EMA bit for bit (the same steps in the same
  order on the CPU); the dispatch means against JAX's
  `make_multistep_train_step`: 1e-5 relative, the parameters and the EMA
  after two dispatches within 1e-5 of their largest entry (f32);
- the whole-epoch pass against JAX's `make_epoch_train_step`, per step,
  in the cached order and with JAX's own permutation fed in: the same
  bounds; the port's own permutation is a function of (seed, epoch) and
  a resumed run equals an unbroken one bit for bit;
- an epoch over the cache's budget warns `EpochCacheOverflowWarning` and
  trains the epoch the staged loop trains, bit for bit, as do the rest of
  the run's epochs.
"""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from deepvision_tpu import cli as jax_cli  # noqa: E402
from deepvision_tpu.configs import get_config as jax_get_config  # noqa: E402
from deepvision_tpu.core import steps as jax_steps  # noqa: E402
from deepvision_tpu.core.trainer import Trainer as JaxTrainer  # noqa: E402
from deepvision_tpu.core.train_state import \
    TrainState as JaxTrainState  # noqa: E402
from deepvision_tpu.flywheel import controller as jax_controller  # noqa: E402
from deepvision_tpu_torch import cli  # noqa: E402
from deepvision_tpu_torch.configs import get_config  # noqa: E402
from deepvision_tpu_torch.core import steps  # noqa: E402
from deepvision_tpu_torch.core.config import (OptimizerConfig,  # noqa: E402
                                              ScheduleConfig)
from deepvision_tpu_torch.core.optim import build_optimizer  # noqa: E402
from deepvision_tpu_torch.core.train_state import TrainState  # noqa: E402
from deepvision_tpu_torch.core.trainer import Trainer  # noqa: E402
from deepvision_tpu_torch.data import device_cache  # noqa: E402
from deepvision_tpu_torch.flywheel import controller  # noqa: E402
from test_torch_cli_flags import jax_config, port_config  # noqa: E402
from test_torch_lenet import _bridged  # noqa: E402

# The port's steps update their state in place and donate nothing;
# jaxlint resolves the step factories by name to the JAX package's
# donating ones.
# jaxlint: disable-file=DON001

BATCH = 8
EMA = 0.9
SGD_LR = 0.05
RTOL = 1e-5
STEPS = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches(n: int, seed: int = 0) -> list:
    rs = np.random.RandomState(seed)
    return [(rs.randn(BATCH, 32, 32, 1).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.int32)) for _ in range(n)]


def _cfg(**over):
    cfg = get_config("lenet5")
    return cfg.replace(batch_size=BATCH, total_epochs=2, ema_decay=EMA,
                       log_every_steps=2, schedule=ScheduleConfig(),
                       data=dataclasses.replace(cfg.data, train_examples=
                                                STEPS * BATCH), **over)


def _trainer(tmp_path, tag: str, **over) -> Trainer:
    tr = Trainer(_cfg(**over), device="cpu", workdir=str(tmp_path / tag))
    tr.init_state()
    return tr


def _weights(tr: Trainer) -> list:
    return ([p.detach().clone() for p in tr.model.parameters()]
            + [e.clone() for e in tr.state.ema])


def _assert_same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


class Counted:
    """An epoch's batches, counting the ones pulled."""

    def __init__(self, batches):
        self.batches, self.pulled = batches, 0

    def __call__(self, epoch):
        for b in self.batches:
            self.pulled += 1
            yield b


# -- k steps per dispatch ------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
def test_k_steps_per_dispatch_equal_k_1_bit_for_bit(tmp_path, k):
    data = _batches(STEPS)
    one = _trainer(tmp_path, "k1")
    one.fit(lambda e: iter(data))
    many = _trainer(tmp_path, f"k{k}", steps_per_dispatch=k)
    many.fit(lambda e: iter(data))
    _assert_same(_weights(one), _weights(many))
    assert many.state.step == one.state.step == 2 * STEPS
    # a tail shorter than k runs as single steps
    per_epoch = STEPS // k + STEPS % k
    assert many.dispatches_total == 2 * per_epoch
    assert [d["steps"] for d in many.last_epoch_dispatches] == \
        [float(k)] * (STEPS // k) + [1.0] * (STEPS % k)
    assert [m["loss"] for m in many.last_epoch_steps] == \
        [m["loss"] for m in one.last_epoch_steps]
    one.close()
    many.close()


def test_a_dispatch_is_logged_once_at_its_end(tmp_path):
    """log_every 2 with k 4 over 6 steps: one dispatch of 4 (it crosses
    the boundaries at 2 and 4 and is logged once at its end, the mean of
    its 4 steps, as JAX's trainer does), then a tail of 2 single steps
    (logged at 6)."""
    tr = _trainer(tmp_path, "log", steps_per_dispatch=4)
    tr.fit(lambda e: iter(_batches(STEPS)), total_epochs=1)
    tr.close()
    import json
    with open(tmp_path / "log" / "lenet5.jsonl") as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train_loss" in r]
    assert [r["step"] for r in train] == [4, 6]
    means = np.mean([m["loss"] for m in tr.last_epoch_steps[:4]])
    assert train[0]["train_loss"] == pytest.approx(means, rel=1e-6)


@pytest.fixture(scope="module")
def lenet_oracle():
    """JAX's LeNet-5 step (SGD, f32, no donation) compiled once, its
    weights, and the port's model with the same weights."""
    batches = _batches(4, seed=3)
    jax_model, _, params = _bridged(batches[0][0])
    tx = optax.sgd(SGD_LR)
    step = jax_steps.make_classification_train_step(
        compute_dtype=jnp.float32, donate=False)
    return {"model": jax_model, "params": params, "tx": tx, "step": step,
            "batches": batches}


def _port_state(oracle) -> TrainState:
    _, model, _ = _bridged(oracle["batches"][0][0])
    opt = build_optimizer(model.parameters(),
                          OptimizerConfig(name="sgd", learning_rate=SGD_LR,
                                          momentum=0.0),
                          ScheduleConfig(), 10, 1)
    return TrainState(model, opt, ema_decay=EMA)


def _jax_state(oracle):
    return JaxTrainState.create(oracle["model"].apply, oracle["params"],
                                oracle["tx"], ema=True)


def _assert_weights(state: TrainState, jstate) -> None:
    from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
    for tree, ours in ((jstate.params, [p.detach() for p in
                                        state.model.parameters()]),
                       (jstate.ema_params, state.ema)):
        want = params_to_state_dict(jax.device_get(tree), state.model)
        names = [n for n, _ in state.model.named_parameters()]
        for n, got in zip(names, ours):
            w = want[n]
            assert (got - w).abs().max().item() <= \
                RTOL * w.abs().max().item(), n


def test_multistep_means_and_weights_match_jax(lenet_oracle):
    k = 2
    multi = jax_steps.make_multistep_train_step(
        lenet_oracle["step"], k, 2, ema_decay=EMA)
    jstate = _jax_state(lenet_oracle)
    batches = lenet_oracle["batches"]
    rng = jax.random.PRNGKey(0)
    want = []
    for i in range(0, len(batches), k):
        flat = [jnp.asarray(a) for b in batches[i:i + k] for a in b]
        jstate, m = multi(jstate, *flat, rng)
        want.append({n: float(v) for n, v in m.items()})
    state = _port_state(lenet_oracle)
    pmulti = steps.make_multistep_train_step(
        steps.make_classification_train_step(compute_dtype=torch.float32),
        k)
    got = []
    for i in range(0, len(batches), k):
        per_step, mean = pmulti(state, [tuple(map(torch.from_numpy, b))
                                        for b in batches[i:i + k]])
        assert len(per_step) == k
        got.append({n: float(v) for n, v in mean.items()})
    assert state.step == int(jstate.step) == len(batches)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for n in w:
            assert g[n] == pytest.approx(w[n], rel=RTOL), n
    _assert_weights(state, jstate)


def test_a_dispatch_of_the_wrong_size_is_refused():
    multi = steps.make_multistep_train_step(lambda s, *b: {}, 3)
    with pytest.raises(ValueError, match="takes 3 batches"):
        multi(None, [()] * 2)
    with pytest.raises(ValueError, match="k >= 2"):
        steps.make_multistep_train_step(lambda s, *b: {}, 1)


# -- the whole-epoch path --------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
def test_the_epoch_pass_matches_jax_per_step(lenet_oracle, shuffle):
    batches = lenet_oracle["batches"]
    arrays = tuple(np.stack([b[j] for b in batches]) for j in range(2))
    epoch = jax_steps.make_epoch_train_step(
        lenet_oracle["step"], 2, ema_decay=EMA, shuffle=shuffle)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jstate, metrics = epoch(_jax_state(lenet_oracle),
                            *map(jnp.asarray, arrays), rng)
    want = {n: np.asarray(v) for n, v in metrics.items()}
    perm = None
    if shuffle:
        perm = torch.from_numpy(np.asarray(jax.random.permutation(
            jax.random.fold_in(rng, jax_steps.EPOCH_SHUFFLE_TAG),
            len(batches) * BATCH)).astype(np.int64))
    state = _port_state(lenet_oracle)
    pepoch = steps.make_epoch_train_step(
        steps.make_classification_train_step(compute_dtype=torch.float32))
    ticks = []
    per_step = pepoch(state, tuple(map(torch.from_numpy, arrays)), perm,
                      on_step=lambda: ticks.append(state.step))
    assert ticks == [1, 2, 3, 4]
    for n, w in want.items():
        got = np.array([float(m[n]) for m in per_step])
        np.testing.assert_allclose(got, w, rtol=RTOL, err_msg=n)
    _assert_weights(state, jstate)


def test_the_epoch_permutation_is_a_function_of_seed_and_epoch():
    cpu = torch.device("cpu")
    a = steps.draw_epoch_permutation(0, 3, 64, cpu)
    torch.testing.assert_close(a, steps.draw_epoch_permutation(0, 3, 64, cpu))
    assert sorted(a.tolist()) == list(range(64))
    assert not torch.equal(a, steps.draw_epoch_permutation(0, 4, 64, cpu))
    assert not torch.equal(a, steps.draw_epoch_permutation(1, 3, 64, cpu))
    arrays = (torch.arange(2 * 3 * 2).reshape(2, 3, 2),
              torch.arange(6).reshape(2, 3))
    perm = torch.tensor([5, 0, 3, 1, 4, 2])
    x, y = steps.apply_epoch_permutation(arrays, perm)
    torch.testing.assert_close(y.reshape(-1), perm)
    torch.testing.assert_close(x.reshape(6, 2), arrays[0].reshape(6, 2)[perm])


def test_the_second_epoch_pulls_no_host_batch(tmp_path, capsys):
    data = Counted(_batches(STEPS))
    tr = _trainer(tmp_path, "cache", epoch_on_device=True)
    tr.fit(data)
    assert data.pulled == STEPS               # epoch 1 only
    assert tr.dispatches_total == 2
    assert len(tr.last_epoch_steps) == STEPS
    assert "epoch cache: 6 steps x 8 examples" in capsys.readouterr().out
    # shuffled per epoch: not the staged loop's order
    staged = _trainer(tmp_path, "staged")
    staged.fit(lambda e: iter(data.batches))
    assert tr.state.step == staged.state.step
    assert not torch.equal(_weights(tr)[0], _weights(staged)[0])
    tr.close()
    staged.close()


def test_the_cached_order_equals_the_staged_loop_bit_for_bit(tmp_path):
    data = _batches(STEPS)
    cached = _trainer(tmp_path, "c", epoch_on_device=True,
                      epoch_shuffle=False)
    cached.fit(lambda e: iter(data))
    staged = _trainer(tmp_path, "s")
    staged.fit(lambda e: iter(data))
    _assert_same(_weights(cached), _weights(staged))
    assert [m["loss"] for m in cached.last_epoch_steps] == \
        [m["loss"] for m in staged.last_epoch_steps]
    cached.close()
    staged.close()


def test_a_resumed_run_draws_the_same_permutations(tmp_path):
    data = _batches(STEPS)
    straight = _trainer(tmp_path, "straight", epoch_on_device=True)
    straight.fit(lambda e: iter(data), total_epochs=3)
    first = _trainer(tmp_path, "resumed", epoch_on_device=True)
    first.fit(lambda e: iter(data), total_epochs=1)
    first.close()
    again = _trainer(tmp_path, "resumed", epoch_on_device=True)
    assert again.resume() == 1
    again.fit(lambda e: iter(data), total_epochs=3)
    _assert_same(_weights(straight), _weights(again))
    straight.close()
    again.close()


def test_an_epoch_over_the_budget_warns_and_trains_the_staged_epoch(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPVISION_EPOCH_CACHE_MAX_BYTES", "1000")
    data = Counted(_batches(STEPS))
    over = _trainer(tmp_path, "over", epoch_on_device=True)
    with pytest.warns(device_cache.EpochCacheOverflowWarning,
                      match="exceeds the device cache budget"):
        over.fit(data)
    assert over._epoch_fallback and over._epoch_cache is None
    assert data.pulled == 2 * STEPS          # both epochs from the host
    staged = _trainer(tmp_path, "staged")
    staged.fit(lambda e: iter(data.batches))
    _assert_same(_weights(over), _weights(staged))
    over.close()
    staged.close()


@pytest.mark.parametrize("stream,match", [
    ("ragged", "ragged stream"), ("empty", "empty epoch stream"),
    ("budget", "exceeds the device cache budget")])
def test_the_cache_falls_back_with_every_batch_kept(stream, match):
    batches = _batches(4)
    if stream == "ragged":
        batches[2] = (batches[2][0][:5], batches[2][1][:5])
    elif stream == "empty":
        batches = []
    with pytest.warns(device_cache.EpochCacheOverflowWarning, match=match):
        cache, rest = device_cache.build_epoch_cache(
            iter(batches), torch.device("cpu"), shuffle=True,
            max_bytes=(2 * 8 * 32 * 32 * 4 * 2 if stream == "budget"
                       else None))
    assert cache is None
    got = list(rest)
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_the_cache_stacks_the_epoch_on_the_device():
    batches = _batches(3)
    cache, rest = device_cache.build_epoch_cache(iter(batches),
                                                 torch.device("cpu"))
    assert rest is None and cache.steps == 3 and cache.n_batch_args == 2
    assert cache.examples_per_step == BATCH
    assert cache.nbytes == sum(a.nbytes for b in batches for a in b)
    np.testing.assert_array_equal(cache.arrays[0][1].numpy(), batches[1][0])


def test_the_budget_reads_the_environment_first(monkeypatch):
    monkeypatch.delenv("DEEPVISION_EPOCH_CACHE_MAX_BYTES", raising=False)
    assert device_cache.hbm_budget_bytes(torch.device("cpu")) is None
    monkeypatch.setenv("DEEPVISION_EPOCH_CACHE_MAX_BYTES", "2.5e6")
    assert device_cache.hbm_budget_bytes(torch.device("cpu")) == 2_500_000


# -- the trainer's guards ------------------------------------------------------

@pytest.mark.parametrize("over,lever", [
    (dict(steps_per_dispatch=2, accum_steps=2), "accum_steps"),
    (dict(epoch_on_device=True, steps_per_dispatch=2), "steps_per_dispatch"),
    (dict(epoch_on_device=True, accum_steps=2), "accum_steps")])
def test_the_trainer_refuses_lever_pairs_as_jax(tmp_path, over, lever):
    def apply(cfg):
        accum = over.get("accum_steps", 1)
        rest = {k: v for k, v in over.items() if k != "accum_steps"}
        return cfg.replace(optimizer=dataclasses.replace(
            cfg.optimizer, accum_steps=accum), **rest)

    with pytest.raises(ValueError) as want:
        JaxTrainer(apply(jax_get_config("lenet5")),
                   workdir=str(tmp_path / "jax"))
    with pytest.raises(ValueError) as got:
        Trainer(apply(get_config("lenet5")), device="cpu",
                workdir=str(tmp_path / "port"))
    for err in (want, got):
        assert lever in str(err.value)
        assert ("epoch_on_device" in str(err.value)) == \
            bool(over.get("epoch_on_device"))


# -- the CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--log-grad-norm"], ["--mixup-alpha", "0.2"], ["--cutmix-alpha", "1"],
    ["--steps-per-dispatch", "4"], ["--synthetic", "--epoch-on-device"],
    ["--synthetic", "--no-epoch-on-device"],
    ["--synthetic", "--epoch-on-device", "--log-grad-norm",
     "--cutmix-alpha", "0.5"], []])
def test_the_lever_flags_set_the_config_as_jax(monkeypatch, extra):
    argv = ["-m", "lenet5", "--workdir", "unused"] + extra
    want, got = jax_config(monkeypatch, argv), port_config(argv)
    for f in ("log_grad_norm", "mixup_alpha", "cutmix_alpha",
              "steps_per_dispatch", "epoch_on_device", "epoch_shuffle",
              "remat"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("extra", [
    ["--mixup-alpha", "-0.1"], ["--cutmix-alpha", "-1"],
    ["--mixup-alpha", "0.2", "--cutmix-alpha", "1"],
    ["--epoch-on-device"]])
def test_the_lever_flags_refuse_as_jax(monkeypatch, extra):
    argv = ["-m", "resnet50_tpu", "--workdir", "unused"] + extra
    with pytest.raises(SystemExit) as want:
        jax_config(monkeypatch, argv)
    with pytest.raises(SystemExit) as got:
        port_config(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["0", "-2", "x"])
def test_steps_per_dispatch_takes_a_positive_int(value, capsys):
    with pytest.raises(SystemExit) as got:
        port_config(["-m", "lenet5", "--steps-per-dispatch", value])
    assert got.value.code == 2
    with pytest.raises(SystemExit) as want:
        jax_cli.build_parser("T", ["lenet5"]).parse_args(
            ["-m", "lenet5", "--steps-per-dispatch", value])
    assert want.value.code == 2


def test_the_scene_datasets_print_the_cache_note(capsys):
    cfg = get_config("yolov3_digits").replace(epoch_on_device=True)
    cli.check_epoch_on_device(cfg)
    assert "replays epoch 1's scenes" in capsys.readouterr().out


# -- the flywheel's fine-tune --------------------------------------------------

def _controller(tmp_path, name: str = "lenet5"):
    """A flywheel controller with just what `_finetune` reads."""
    import contextlib
    import threading
    fw = object.__new__(controller.FlywheelController)
    fw.sm = types.SimpleNamespace(
        name=name, workdir=str(tmp_path / "run"),
        engine=types.SimpleNamespace(device=torch.device("cpu"),
                                     example_shape=(32, 32, 1)))
    fw.monitor = types.SimpleNamespace(cfg=get_config(name).replace(
        batch_size=4))
    fw.finetune_epochs, fw.finetune_batches = 2, 2
    fw.finetune_steps, fw.tracer = 0, None
    fw._lock = threading.Lock()
    fw._data_fn = None
    fw._span = lambda *a, **k: contextlib.nullcontext()
    return fw


@pytest.mark.parametrize("on_device", [True, False])
def test_the_finetune_config_is_jaxs(tmp_path, on_device):
    stand_in = types.SimpleNamespace(sm=types.SimpleNamespace(name="lenet5"),
                                     finetune_epochs=2)
    want = jax_controller.FlywheelController._finetune_config(
        stand_in, 3, on_device=on_device)
    got = _controller(tmp_path)._finetune_config(3, on_device=on_device)
    for f in ("total_epochs", "epoch_on_device", "epoch_shuffle"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.schedule.name == want.schedule.name == "constant"


@pytest.mark.parametrize("accum", [1, 2])
def test_the_finetune_takes_the_epoch_path_or_falls_back(
        tmp_path, monkeypatch, accum):
    """Eligible: the whole-epoch path. Accumulation makes the trainer
    refuse it: the staged loop, as JAX's controller falls back."""
    import deepvision_tpu_torch.configs as configs
    real = configs.get_config

    def patched(name):
        cfg = real(name)
        return cfg.replace(batch_size=4, optimizer=dataclasses.replace(
            cfg.optimizer, accum_steps=accum))

    monkeypatch.setattr(configs, "get_config", patched)
    built = []
    real_cls = configs.trainer_class_for_config("lenet5")

    class Spy(real_cls):
        def __init__(self, cfg, **kw):
            built.append(cfg.epoch_on_device)
            super().__init__(cfg, **kw)
            self.spied = self
            spies.append(self)

    spies = []
    monkeypatch.setattr(configs, "trainer_class_for_config",
                        lambda name: Spy)
    fw = _controller(tmp_path)
    assert fw._finetune("ep") == 2
    assert fw.finetune_steps == 4
    if accum == 1:
        assert built == [True] and spies[0]._epoch_cache is not None
    else:
        assert built == [True, False] and spies[-1]._epoch_cache is None
