"""Port MobileNet V1 and ShuffleNet V1 (deepvision_tpu_torch/models/
{mobilenet,shufflenet}.py), grouped convs through the weight bridge and
the channel shuffle, against the JAX package on the CPU.

Weights are Flax variables of the shapes `init` gives, filled from numpy
(tests/test_torch_zoo_oracle.py) and carried over by the weight bridge;
inputs are seeded numpy. MobileNet runs at alpha 0.25, ShuffleNet at g=3
(and every other g in eval), both with 10 classes at 32 px, batch 8.

Bounds, relative to the largest value compared:
- grouped convs and the shuffle, f32: 1e-6 and exact;
- f32 eval-mode logits: 1e-5 (summation order only);
- f32 train mode: the updated BatchNorm statistics 1e-4 and the logits
  (neither model has dropout) 1e-4 for ShuffleNet and 2e-4 for MobileNet.
  BatchNorm normalizes the last layers over 8 values (a 1x1 map), which
  amplifies summation order: the JAX package's own logits move by 1.1e-4
  (MobileNet) and 2.7e-5 (ShuffleNet), its statistics by 1.2e-5, when only
  the order of the batch changes;
- bf16 eval-mode logits: 2e-2. The JAX package's own bf16 logits differ
  from its f32 ones by 8.2e-4 (MobileNet) and 7.2e-3 (ShuffleNet) here;
  the port's from the JAX bf16 ones by up to 1.0e-2 (ShuffleNet's
  shortcut average pool sums its bf16 window in f32 and rounds once,
  where XLA on the CPU rounds after every add);
- one full f32 train step against `make_classification_train_step`:
  loss 1e-5 relative, top-1 equal; the BatchNorm statistics after the
  step, and each weight whose gradient in the port exceeds 1e-4 of the
  model's largest (72% of MobileNet's weights, 92% of ShuffleNet's),
  within 1e-3 of its leaf's largest update. Below that a gradient is the
  small remainder of large terms (a train-mode BatchNorm leaves the conv
  before it a gradient orthogonal to the conv's own output, and the
  biases of ShuffleNet's depthwise BatchNorms, which feed a conv and a
  train-mode BatchNorm, a gradient that is 0 in exact arithmetic), summed
  in another order by each package; MobileNet's RMSprop turns such a
  gradient into an update of about 3.16 lr sign(g) in its first step
  (lr g / (sqrt(0.1 g^2) + eps)), so its sign decides the whole update.
`test_*_casts_are_flax_s` pin each rounding of the bf16 path bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepvision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deepvision_tpu.core.config import ScheduleConfig as JaxScheduleConfig
from deepvision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deepvision_tpu.core.steps import \
    make_classification_train_step as jax_make_train_step
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.models import mobilenet as jax_mobilenet
from deepvision_tpu.models import shufflenet as jax_shufflenet
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.steps import make_classification_train_step
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data.synthetic import SyntheticClassification
from deepvision_tpu_torch.models import common, mobilenet, shufflenet
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_zoo_oracle import (bridge, check_engine, check_full_size,
                                   images, jax_apply, port_forward, rel_err,
                                   train_and_resume)

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_classification_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIZE = 8, 32
TRAIN_BOUND = {"mobilenet_v1": 2e-4, "shufflenet_v1": 1e-4}
BF16_BOUND = 2e-2
# the weights compared after a full step: where the port's gradient is
# above SETTLED of the model's largest; at least this share of them
SETTLED = 1e-4
MIN_SETTLED = {"mobilenet_v1": 0.7, "shufflenet_v1": 0.9}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(name: str, dtype: str = "float32", groups: int = 3):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    if name == "mobilenet_v1":
        return (jax_mobilenet.MobileNetV1(num_classes=10, alpha=0.25,
                                          dtype=jd),
                mobilenet.MobileNetV1(10, 0.25, td))
    return (jax_shufflenet.ShuffleNetV1(num_classes=10, groups=groups,
                                        dtype=jd),
            shufflenet.ShuffleNetV1(10, groups, td))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("groups", [2, 3, 4, 8])
def test_channel_shuffle_matches_jax(groups):
    x = np.random.RandomState(0).randn(2, 3, 3, 24).astype(np.float32)
    want = np.asarray(jax_shufflenet.channel_shuffle(jnp.asarray(x), groups))
    got = shufflenet.channel_shuffle(_nchw(x), groups)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("groups,cin,cout,stride", [
    (3, 12, 24, 1), (8, 16, 16, 2), (12, 12, 12, 1), (12, 12, 12, 2)],
    ids=["g3", "g8_s2", "depthwise", "depthwise_s2"])
def test_grouped_conv_bridges_and_matches_flax(groups, cin, cout, stride):
    """feature_group_count's HWIO kernel (kh, kw, in/groups, out) becomes
    OIHW (out, in/groups, kh, kw) under the bridge's existing rule."""
    x = np.random.RandomState(1).randn(2, 8, 8, cin).astype(np.float32)
    conv = fnn.Conv(cout, (3, 3), strides=(stride, stride),
                    feature_group_count=groups, use_bias=False)
    shapes = jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    kernel = np.random.RandomState(2).randn(
        *shapes["params"]["kernel"].shape).astype(np.float32)
    assert kernel.shape == (3, 3, cin // groups, cout)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))
    port = common.Conv(cin, cout, 3, stride, groups=groups)
    sd = params_to_state_dict({"kernel": kernel}, port)
    assert sd["weight"].shape == (cout, cin // groups, 3, 3)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("name,groups", [("mobilenet_v1", 3),
                                         ("shufflenet_v1", 1),
                                         ("shufflenet_v1", 2),
                                         ("shufflenet_v1", 3),
                                         ("shufflenet_v1", 4),
                                         ("shufflenet_v1", 8)],
                         ids=["mobilenet_v1", "shufflenet_g1",
                              "shufflenet_g2", "shufflenet_g3",
                              "shufflenet_g4", "shufflenet_g8"])
def test_eval_logits_match_jax(name, groups):
    jax_model, model = _models(name, groups=groups)
    x = images(BATCH, SIZE)
    variables = bridge(jax_model, model, x)
    want = np.asarray(jax_apply(jax_model, False)(variables, x))
    got = port_forward(model, x, train=False)
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("name", ["mobilenet_v1", "shufflenet_v1"])
def test_train_mode_logits_and_statistics_match_jax(name):
    jax_model, model = _models(name)
    x = images(BATCH, SIZE)
    variables = bridge(jax_model, model, x)
    out, new = jax_apply(jax_model, True)(variables, x)
    got = port_forward(model, x, train=True)
    assert rel_err(got.numpy(), np.asarray(out)) <= TRAIN_BOUND[name]
    want = params_to_state_dict(variables["params"], model,
                                jax.device_get(new["batch_stats"]))
    state = model.state_dict()
    stats = [k for k in want if "running" in k]
    assert len(stats) == 2 * sum(isinstance(m, common.BatchNorm)
                                 for m in model.modules())
    for k in stats:
        assert rel_err(state[k].numpy(), want[k].numpy()) <= 1e-4, k


@pytest.mark.parametrize("name", ["mobilenet_v1", "shufflenet_v1"])
def test_bf16_eval_logits_match_jax(name):
    jax_model, model = _models(name, "bfloat16")
    x = images(BATCH, SIZE)
    variables = bridge(jax_model, model, x)
    want = np.asarray(jax_apply(jax_model, False)(variables, x))
    assert rel_err(port_forward(model, x, False).numpy(), want) \
        <= BF16_BOUND


@pytest.mark.parametrize("name", ["mobilenet_v1", "shufflenet_v1"])
def test_engine_serves_the_model_as_its_own_eval_forward(name):
    _, model = _models(name, "bfloat16")
    check_engine(model, SIZE)


def test_serve_cli_smoke_serves_mobilenet_v1_at_224_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m",
         "mobilenet_v1", "--smoke", "--device", "cpu", "--duration", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "bucket 32: warm" in proc.stdout
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["serve_smoke"] == "pass"
    assert summary["model"] == "mobilenet_v1"


def _hooked(model):
    seen = {}
    for name, m in model.named_modules():
        if name:
            m.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(name, (i[0], o)))
    return seen


def test_mobilenet_casts_are_flax_s():
    """A depthwise-separable block in bf16, bit for bit: each conv reads
    and returns bf16; each BatchNorm returns f32, ReLU applies in f32, and
    the next conv reads that rounded to bf16; the global pool is an f32
    mean rounded to bf16, read by the f32 head."""
    model = mobilenet.MobileNetV1(10, 0.25).train()
    seen = _hooked(model)
    with torch.no_grad():
        out = model(torch.from_numpy(images(2, SIZE)))
    for i in range(13):
        b = f"blocks.{i}"
        dw, bn0, pw, bn1 = (seen[f"{b}.{n}"] for n in
                            ("dw", "BatchNorm_0", "pw", "BatchNorm_1"))
        assert dw[0].dtype == dw[1].dtype == pw[1].dtype == torch.bfloat16
        assert bn0[1].dtype == bn1[1].dtype == torch.float32
        assert torch.equal(bn0[0], dw[1]) and torch.equal(bn1[0], pw[1])
        assert torch.equal(pw[0], F.relu(bn0[1]).bfloat16())
        assert torch.equal(seen[b][1], F.relu(bn1[1]).bfloat16())
    head_in = seen["head"][0]
    want = seen["blocks.12"][1].float().mean(dim=(2, 3)).bfloat16()
    assert torch.equal(head_in, want)
    assert torch.equal(out, F.linear(head_in.float(), model.head.weight,
                                     model.head.bias))


def test_shufflenet_casts_are_flax_s():
    """A shuffle unit in bf16, bit for bit: BN outputs drop to bf16 (after
    an f32 ReLU on the first), the join is relu(x + y) in bf16, at stride 2
    relu(concat(avg_pool(x), y)) with the shortcut first."""
    model = shufflenet.ShuffleNetV1(10).train()
    seen = _hooked(model)
    with torch.no_grad():
        model(torch.from_numpy(images(2, SIZE)))
    for name in ("stage2_unit0", "stage3_unit1"):
        x, out = seen[name]
        bn = [seen[f"{name}.BatchNorm_{i}"][1] for i in range(3)]
        assert all(b.dtype == torch.float32 for b in bn)
        unit = getattr(model, name)
        y1 = F.relu(bn[0]).bfloat16()
        if unit.g1 > 1:
            y1 = shufflenet.channel_shuffle(y1, 3)
        assert torch.equal(seen[f"{name}.dw"][0], y1)
        assert torch.equal(seen[f"{name}.gconv2"][0], bn[1].bfloat16())
        y = bn[2].bfloat16()
        if unit.stride == 2:
            want = F.relu(torch.cat([common.avg_pool(x, 3, 2, "SAME"), y],
                                    dim=1))
        else:
            want = F.relu(x + y)
        assert out.dtype == torch.bfloat16 and torch.equal(out, want)


# -- one full train step against the JAX step --------------------------------

STEPS_PER_EPOCH, EPOCHS = 4, 10


def run_full_step(name: str) -> dict:
    """One f32 step of the config's recipe (optimizer, schedule, label
    smoothing) in both packages from the same weights and batch."""
    cfg = get_config(name)
    images_, labels = next(iter(SyntheticClassification(BATCH, SIZE, 3, 10,
                                                        1, seed=3)))
    jax_model, model = _models(name)
    variables = bridge(jax_model, model, images_)
    params, stats = variables["params"], variables["batch_stats"]
    before = params_to_state_dict(params, model, stats)
    tx = jax_build_optimizer(
        JaxOptimizerConfig(**dataclasses.asdict(cfg.optimizer)),
        JaxScheduleConfig(**dataclasses.asdict(cfg.schedule)),
        STEPS_PER_EPOCH, EPOCHS)
    state = JaxTrainState.create(jax_model.apply, params, tx, stats)
    step = jax_make_train_step(label_smoothing=cfg.label_smoothing,
                               compute_dtype=jnp.float32, donate=False)
    new, metrics = step(state, jnp.asarray(images_), jnp.asarray(labels),
                        jax.random.PRNGKey(0))
    opt = build_optimizer(model.parameters(), cfg.optimizer, cfg.schedule,
                          STEPS_PER_EPOCH, EPOCHS)
    port_state = TrainState(model, opt)
    got = make_classification_train_step(
        label_smoothing=cfg.label_smoothing, compute_dtype=torch.float32)(
        port_state, torch.from_numpy(images_), torch.from_numpy(labels))
    return {"name": name, "model": model, "before": before,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "got": {k: float(v) for k, v in got.items()},
            "want": params_to_state_dict(jax.device_get(new.params), model,
                                         jax.device_get(new.batch_stats))}


@pytest.fixture(scope="module", params=["mobilenet_v1", "shufflenet_v1"])
def full_step(request):
    torch.set_num_threads(1)
    return run_full_step(request.param)


def test_full_step_loss_and_top1_match_jax(full_step):
    got, want = full_step["got"], full_step["metrics"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["top1"] == want["top1"]


def test_full_step_parameters_and_statistics_match_jax(full_step):
    model, before = full_step["model"], full_step["before"]
    grads = {n: p.grad for n, p in model.named_parameters()}
    top = max(g.abs().max() for g in grads.values())
    state = model.state_dict()
    counted = [0, 0]
    for name, want in full_step["want"].items():
        update = (want - before[name]).abs()
        err = (state[name] - want).abs()
        if name in grads:
            settled = grads[name].abs() > SETTLED * top
            update, err = update[settled], err[settled]
            counted[0] += int(settled.sum())
            counted[1] += settled.numel()
            if not settled.any():
                continue
        assert update.max() > 0, name
        assert err.max() <= 1e-3 * update.max(), (name, err.max(),
                                                  update.max())
    assert counted[0] >= MIN_SETTLED[full_step["name"]] * counted[1], counted


# -- full size, serving, the entry points -------------------------------------

@pytest.mark.parametrize("name,count", [("mobilenet_v1", 4_231_976),
                                        ("shufflenet_v1", 1_865_728)])
def test_full_size_counts_bridge_and_serving(name, count):
    engine = check_full_size(name, count)
    assert engine.model.head.weight.dtype == torch.float32
    assert all(m.weight.dtype == torch.bfloat16
               for m in engine.model.modules() if isinstance(m, common.Conv))
    assert all(m.weight.dtype == torch.float32 for m in engine.model.modules()
               if isinstance(m, common.BatchNorm))


def test_shufflenet_refuses_an_unknown_group_count():
    with pytest.raises(ValueError, match="groups"):
        shufflenet.ShuffleNetV1(groups=5)


@pytest.mark.parametrize("family,model", [("MobileNet", "mobilenet_v1"),
                                          ("ShuffleNet", "shufflenet_v1")])
def test_entry_point_trains_saves_and_resumes(family, model, tmp_path,
                                              capsys):
    train_and_resume(family, model, SIZE, tmp_path, capsys)
