"""Port ResNets (deepvision_tpu_torch/models/{common,resnet}.py), the EMA
of the train state and the resnet50_tpu recipe's train step against the
JAX package on the CPU.

The same numpy inputs and weights (seeded) go through both. Weights are
Flax variables (`params` + `batch_stats`) of the shapes `ResNet.init`
gives, filled from numpy (tests/test_torch_yolo.py::flax_yolo_variables:
every BatchNorm scale away from 0 and 1, so no branch is muted), carried
over by the weight bridge. The reduced models have stages (1, 1, 1, 1),
width 8, 10 classes and 32 px inputs, batch 8.

Bounds, relative to the largest logit:
- f32, eval mode: 1e-5 (only the convolutions' summation order differs);
- f32, train mode: 1e-4. BatchNorm normalizes each channel of the last
  stage over 8 values, which amplifies summation-order differences: the
  JAX package's own f32 logits move by up to 2.7e-5 here when only the
  order of the batch changes, and by 6e-4 at batch 2;
- bf16, eval mode: 2e-2 (both round every conv output to bf16 after
  differently ordered sums; each package's bf16 logits differ from its f32
  ones by up to 1.6e-2 here);
- bf16, train mode: 6e-2. The normalization over 8 values amplifies the
  flipped roundings: the JAX package's own bf16 logits differ from its f32
  ones by up to 3.4e-2 here;
- the BatchNorm statistics after one f32 train forward: 1e-5.
At these sizes a bf16 comparison cannot see where a value is rounded (a
join in bf16 instead of f32 moves the logits by less than bf16's own
noise), so `test_block_rounds_where_flax_does` pins the order of the casts
in the port's blocks exactly.
One resnet50_tpu-recipe step (momentum 0.9, weight decay 1e-4 without
decay on 1-D tensors, label smoothing 0.1, EMA 0.9) against the JAX step
and `ema_tree_update`: loss 1e-5 relative; parameters, statistics and EMA
after the step within 1e-3 of each leaf's update (the gradients differ in
summation order as above).
"""

import dataclasses
import functools
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
from deepvision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deepvision_tpu.core.steps import \
    make_classification_train_step as jax_make_train_step
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.core.train_state import ema_tree_update
from deepvision_tpu.models import common as jax_common
from deepvision_tpu.models import resnet as jr
from deepvision_tpu_torch.cli import _classification_data, _config_from_args
from deepvision_tpu_torch.cli import build_parser
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.steps import make_classification_train_step
from deepvision_tpu_torch.core.train_state import TrainState, ema_update_
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.data.synthetic import SyntheticClassification
from deepvision_tpu_torch.models import common, resnet
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from deepvision_tpu_torch.utils.registry import MODELS
from test_torch_yolo import flax_yolo_variables

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_classification_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
BATCH, SIZE = 8, 32
BOUND = {("float32", False): 1e-5, ("float32", True): 1e-4,
         ("bfloat16", False): 2e-2, ("bfloat16", True): 6e-2}

# variant: (JAX constructor, port constructor, their shared kwargs)
VARIANTS = {
    "basic": (jr.ResNet, resnet.ResNet,
              dict(block="BasicBlock")),
    "bottleneck": (jr.ResNet, resnet.ResNet,
                   dict(block="BottleneckBlock")),
    "stride_on_first": (jr.ResNet, resnet.ResNet,
                        dict(block="BottleneckBlock", stride_on_first=True)),
    "project_first_blocks": (jr.ResNet, resnet.ResNet,
                             dict(block="BasicBlock",
                                  project_first_blocks=True)),
    "space_to_depth": (jr.ResNet, resnet.ResNet,
                       dict(block="BottleneckBlock",
                            stem_space_to_depth=True)),
    "lean": (jr.ResNet, resnet.ResNet,
             dict(block="BottleneckBlock", lowp_residual=True,
                  lowp_bn=True)),
    "v2": (jr.ResNetV2, resnet.ResNetV2, {}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _images(n=BATCH, size=SIZE, seed=1):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def _models(variant: str, dtype: str):
    jax_ctor, port_ctor, kw = VARIANTS[variant]
    kw = dict(kw)
    block = kw.pop("block", None)
    jax_kw, port_kw = dict(REDUCED, **kw), dict(REDUCED, **kw)
    if block:
        jax_kw["block"] = getattr(jr, block)
        port_kw["block"] = getattr(resnet, block)
    return (jax_ctor(**jax_kw, dtype=jnp.dtype(dtype)),
            port_ctor(**port_kw, dtype=getattr(torch, dtype)))


def _bridged(variant: str, dtype: str, x: np.ndarray):
    jax_model, model = _models(variant, dtype)
    params, stats = flax_yolo_variables(jax_model, x)
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    return jax_model, model, params, stats


@functools.lru_cache(maxsize=None)
def _jax_apply(jax_model, train: bool):
    if train:
        return jax.jit(lambda v, x: jax_model.apply(
            v, x, train=True, mutable=["batch_stats"]))
    return jax.jit(lambda v, x: jax_model.apply(v, x, train=False))


# -- forward parity ----------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant, dtype, train):
    x = _images()
    jax_model, model, params, stats = _bridged(variant, dtype, x)
    out = _jax_apply(jax_model, train)({"params": params,
                                        "batch_stats": stats}, x)
    want = np.asarray(out[0] if train else out)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max()
    assert err <= BOUND[(dtype, train)] * scale, (err, scale)
    if train and dtype == "float32":
        new_stats = params_to_state_dict(params, model, out[1]["batch_stats"])
        state = model.state_dict()
        for name, value in new_stats.items():
            if "running" in name:
                torch.testing.assert_close(state[name], value, rtol=1e-5,
                                           atol=1e-5, msg=name)


@pytest.mark.parametrize("lowp", [False, True], ids=["f32_join", "lowp"])
@pytest.mark.parametrize("block", ["BasicBlock", "BottleneckBlock"])
def test_block_rounds_where_flax_does(block, lowp):
    """The dtype order of a V1 block, bit for bit: the BatchNorms with ReLU
    return f32 (bf16 under lowp_bn) and the next conv reads them in bf16;
    the last BatchNorm and the projection's return f32 without ReLU; the
    join is relu(y.f32 + residual.f32).bf16 (all in bf16 under the lowp
    flags)."""
    cls = getattr(resnet, block)
    blk = cls(8, 8, strides=2, dtype=torch.bfloat16, lowp_residual=lowp,
              lowp_bn=lowp).train()
    seen = {}
    for name, child in blk.named_children():
        child.register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, (i[0], o)))
    x = torch.randn(2, 8, 6, 6).bfloat16()
    with torch.no_grad():
        out = blk(x)
    bn_dtype = torch.bfloat16 if lowp else torch.float32
    bns = sorted(n for n in seen if n.startswith("_BN_"))
    convs = sorted(n for n in seen if n.startswith("Conv_"))
    assert len(bns) == len(convs) + 1          # the projection's is last
    for name in convs:
        assert seen[name][0].dtype == seen[name][1].dtype == torch.bfloat16
    for name in bns:
        assert seen[name][1].dtype == bn_dtype, name
    for bn, conv in zip(bns, convs[1:]):       # ReLU'd, read in bf16
        torch.testing.assert_close(seen[conv][0],
                                   seen[bn][1].bfloat16(), rtol=0, atol=0)
        assert seen[bn][1].min() >= 0
    y, r = seen[bns[-2]][1], seen[bns[-1]][1]
    join = torch.bfloat16 if lowp else torch.float32
    want = torch.relu(y.to(join) + r.to(join)).bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_v2_stride_two_conv_is_same_padded_at_an_even_size():
    """resnet50v2's 3x3 stride-2 conv pads (0, 1) on an even input, as XLA's
    SAME does; torch's padding=1 would read shifted windows."""
    conv = common.Conv(1, 1, 3, 2, padding="SAME")
    assert conv._pads(torch.zeros(1, 1, 8, 8)) == ((0, 1), (0, 1))
    assert conv._pads(torch.zeros(1, 1, 7, 7)) == ((1, 1), (1, 1))
    block = resnet.PreActBottleneck(16, 8, strides=2)
    assert block.convs[1].flax_padding == "SAME"


def test_convbn_matches_jax():
    x = _images(4, 8)
    jax_model = jax_common.ConvBN(6, kernel=(3, 3), strides=(2, 2),
                                  dtype=jnp.float32)
    params, stats = flax_yolo_variables(jax_model, x)
    model = common.ConvBN(3, 6, 3, 2, dtype=torch.float32)
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    for train in (False, True):
        out = jax_model.apply({"params": params, "batch_stats": stats}, x,
                              train=train, mutable=["batch_stats"])[0]
        model.train(train)
        with torch.no_grad():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(out), rtol=0, atol=1e-5)


# -- the full models: sizes and init -----------------------------------------

@pytest.mark.parametrize("name,count", [("resnet50", 25_557_032),
                                        ("resnet50v2", 25_549_352)])
def test_full_parameter_count_matches_jax(name, count):
    jax_model = jr.ResNet if name == "resnet50" else jr.ResNetV2
    shapes = jax.eval_shape(lambda: jax_model(stage_sizes=(3, 4, 6, 3)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    model = MODELS.get(name)()
    assert want == count
    assert sum(p.numel() for p in model.parameters()) == count
    # every Flax leaf maps onto the port's module, and every entry of it
    # is filled (the bridge raises otherwise)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    params_to_state_dict(zeros["params"], model, zeros["batch_stats"])


def test_init_statistics():
    """he_normal_fanout convs (std sqrt(2 / fan_out), truncated at 2 std)
    without biases, each block's last BatchNorm scale zero, the others one,
    the head normal(0.01) with a zero bias; seeded init repeats."""
    model = MODELS.get("resnet50")(generator=torch.Generator().manual_seed(0))
    again = MODELS.get("resnet50")(generator=torch.Generator().manual_seed(0))
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    convs = [m for m in model.modules() if isinstance(m, common.Conv)]
    assert len(convs) == 53 and all(c.bias is None for c in convs)
    for conv in convs:
        w = conv.weight
        std = (2.0 / (w.shape[0] * w.shape[2] * w.shape[3])) ** 0.5
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
        if w.numel() >= 16384:
            assert abs(w.std().item() - std) < 0.03 * std
    blocks = [m for m in model.modules()
              if isinstance(m, resnet.BottleneckBlock)]
    assert len(blocks) == 16
    for blk in blocks:
        gammas = [m.layers[0].weight for m in blk.main
                  if isinstance(m, resnet._BN)]
        assert [bool(g.eq(0).all()) for g in gammas] == [False, False, True]
        assert all(bool(g.eq(1).all()) for g in gammas[:2])
    head = model.head
    assert abs(head.weight.std().item() - 0.01) < 2e-4
    assert head.bias.eq(0).all()


# -- the EMA and the resnet50_tpu recipe's step ------------------------------

def test_ema_update_is_the_jax_formula():
    rs = np.random.RandomState(0)
    e, p = rs.randn(1000).astype(np.float32), rs.randn(1000).astype(
        np.float32)
    want = np.asarray(ema_tree_update(0.9999, {"w": jnp.asarray(e)},
                                      {"w": jnp.asarray(p)})["w"])
    ema = [torch.from_numpy(e.copy())]
    ema_update_(ema, [torch.from_numpy(p)], 0.9999)
    np.testing.assert_array_equal(ema[0].numpy(), want)


RECIPE_STEPS_PER_EPOCH, RECIPE_EPOCHS = 4, 10


@pytest.fixture(scope="module")
def recipe_step():
    """One resnet50_tpu-recipe step of the reduced bottleneck ResNet in
    both packages from the same weights and batch, f32."""
    torch.set_num_threads(1)
    cfg = get_config("resnet50_tpu")
    opt = dataclasses.asdict(cfg.optimizer)
    sched = dataclasses.asdict(cfg.schedule)
    images, labels = next(iter(SyntheticClassification(BATCH, SIZE, 3, 10, 1,
                                                       seed=3)))
    jax_model, model, params, stats = _bridged("bottleneck", "float32",
                                               images)
    tx = jax_build_optimizer(JaxOptimizerConfig(**opt),
                             JaxScheduleConfig(**sched),
                             RECIPE_STEPS_PER_EPOCH, RECIPE_EPOCHS)
    state = JaxTrainState.create(jax_model.apply, params, tx, stats,
                                 ema=True)
    step = jax_make_train_step(label_smoothing=cfg.label_smoothing,
                               compute_dtype=jnp.float32, donate=False)
    new, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                        jax.random.PRNGKey(0))
    want_ema = ema_tree_update(0.9, new.ema_params, new.params)

    port_opt = build_optimizer(model.parameters(), cfg.optimizer,
                               cfg.schedule, RECIPE_STEPS_PER_EPOCH,
                               RECIPE_EPOCHS)
    port_state = TrainState(model, port_opt, ema_decay=0.9)
    port_step = make_classification_train_step(
        label_smoothing=cfg.label_smoothing, compute_dtype=torch.float32)
    got = port_step(port_state, torch.from_numpy(images),
                    torch.from_numpy(labels))
    port_state.update_ema()
    return {"params": params, "stats": stats, "model": model,
            "state": port_state,
            "want_loss": float(metrics["loss"]), "got_loss": float(got["loss"]),
            "want": params_to_state_dict(jax.device_get(new.params), model,
                                         jax.device_get(new.batch_stats)),
            "want_ema": params_to_state_dict(
                jax.device_get(want_ema), model,
                jax.device_get(new.batch_stats))}


def test_recipe_step_loss_matches_jax(recipe_step):
    assert recipe_step["got_loss"] == pytest.approx(recipe_step["want_loss"],
                                                    rel=1e-5)
    assert recipe_step["state"].optimizer.count == 1


def test_recipe_step_parameters_and_statistics_match_jax(recipe_step):
    model = recipe_step["model"]
    before = params_to_state_dict(recipe_step["params"], model,
                                  recipe_step["stats"])
    got = model.state_dict()
    for name, want in recipe_step["want"].items():
        update = (want - before[name]).abs().max().item()
        assert update > 0, name
        err = (got[name] - want).abs().max().item()
        assert err <= 1e-3 * update, (name, err, update)


def test_recipe_step_ema_matches_jax(recipe_step):
    model, state = recipe_step["model"], recipe_step["state"]
    before = params_to_state_dict(recipe_step["params"], model,
                                  recipe_step["stats"])
    for (name, _), ema in zip(model.named_parameters(), state.ema):
        want = recipe_step["want_ema"][name]
        update = (want - before[name]).abs().max().item()
        assert update > 0, name
        assert (ema - want).abs().max().item() <= 1e-3 * update, name


def test_recipe_step_skips_decay_on_1d_tensors():
    """Under no_decay_bn_bias the optimizer decays the kernels only: the
    BatchNorm scales and biases and the head's bias sit in a group
    without weight decay."""
    cfg = get_config("resnet50_tpu")
    model = resnet.ResNet(**REDUCED, dtype=torch.float32)
    opt = build_optimizer(model.parameters(), cfg.optimizer, cfg.schedule,
                          10, 1)
    groups = opt.inner.param_groups
    assert [g["weight_decay"] for g in groups] == [1e-4, 0.0]
    assert all(p.dim() > 1 for p in groups[0]["params"])
    assert all(p.dim() == 1 for p in groups[1]["params"])


# -- the trainer: EMA cadence, evaluation, checkpoint, discard ---------------

def _tiny_config(**kw):
    cfg = get_config("resnet50").replace(
        batch_size=4, total_epochs=1, dtype="float32", log_every_steps=100,
        model_kwargs={"stage_sizes": (1, 1, 1, 1), "width": 8}, **kw)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, dataset="synthetic", image_size=SIZE, num_classes=10,
        train_examples=8))


def _data(epoch):
    return SyntheticClassification(4, SIZE, 3, 10, 2, seed=epoch)


def test_ema_runs_once_per_applied_update(tmp_path):
    cfg = _tiny_config(ema_decay=0.5)
    cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer,
                                                    accum_steps=2))
    trainer = Trainer(cfg, device="cpu", workdir=str(tmp_path))
    state = trainer.init_state()
    snapshots = []
    for images, labels in SyntheticClassification(4, SIZE, 3, 10, 3, seed=1):
        trainer.run_step((torch.from_numpy(images),
                          torch.from_numpy(labels)))
        snapshots.append([e.clone() for e in state.ema])
    trainer.close()
    assert state.optimizer.count == 1
    initial = [p for p in snapshots[0]]
    changed = [not all(torch.equal(a, b) for a, b in zip(s, initial))
               for s in snapshots]
    # micro-step 1 accumulates, 2 applies (the EMA moves), 3 accumulates
    assert changed == [False, True, True]
    assert all(torch.equal(a, b) for a, b in zip(snapshots[1], snapshots[2]))


def test_evaluate_uses_the_ema_weights_and_swaps_back(tmp_path):
    trainer = Trainer(_tiny_config(ema_decay=0.5), device="cpu",
                      workdir=str(tmp_path))
    state = trainer.init_state()
    with torch.no_grad():
        for e in state.ema:
            e.mul_(0.5)
    raw = [p.detach().clone() for p in state.model.parameters()]
    batches = list(_data(7))
    got = trainer.evaluate(batches)
    for p, r in zip(state.model.parameters(), raw):
        assert torch.equal(p, r)
    ema, state.ema = state.ema, None
    raw_metrics = trainer.evaluate(batches)
    with torch.no_grad():
        for p, e in zip(state.model.parameters(), ema):
            p.copy_(e)
    want = trainer.evaluate(batches)
    trainer.close()
    assert got == want and got != raw_metrics


def test_ema_checkpoint_round_trip_and_discard(tmp_path, capsys):
    trainer = Trainer(_tiny_config(ema_decay=0.9), device="cpu",
                      workdir=str(tmp_path))
    trainer.fit(_data, _data)
    trainer.close()
    saved = trainer.state.state_dict()
    assert saved["ema"] is not None
    fresh = Trainer(_tiny_config(ema_decay=0.9), device="cpu",
                    workdir=str(tmp_path))
    fresh.init_state()
    assert fresh.resume() == 1
    restored = fresh.state.state_dict()
    for name, value in saved["ema"].items():
        assert torch.equal(restored["ema"][name], value), name
    assert not all(torch.equal(saved["ema"][n], p) for n, p in
                   trainer.state.model.named_parameters())
    fresh.close()
    capsys.readouterr()
    plain = Trainer(_tiny_config(), device="cpu", workdir=str(tmp_path))
    plain.init_state()
    plain.resume()
    assert plain.state.ema is not None       # restored from the checkpoint
    plain.fit(_data, _data, total_epochs=2)
    plain.close()
    out = capsys.readouterr().out
    assert ("checkpoint carries EMA weights but ema_decay is unset: "
            "discarding them") in out
    assert plain.state.ema is None
    assert plain.state.state_dict()["ema"] is None


# -- the entry point and its flags -------------------------------------------

def _args(*argv):
    return build_parser("ResNet", ["resnet50", "resnet50_tpu"]).parse_args(
        ["-m", "resnet50_tpu", *argv])


def test_cli_flags_set_ema_augment_and_prefetch():
    cfg = _config_from_args(_args("--ema-decay", "0.99", "--device-augment",
                                  "--prefetch-batches", "3",
                                  "--data-dir", "/data"), None)
    assert (cfg.ema_decay, cfg.device_augment, cfg.prefetch_batches) == (
        0.99, True, 3)
    cfg = _config_from_args(_args("--no-device-augment"), None)
    assert (cfg.ema_decay, cfg.device_augment, cfg.prefetch_batches) == (
        0.9999, False, 2)
    for bad in ("0", "1", "1.5"):
        with pytest.raises(SystemExit):
            _config_from_args(_args("--ema-decay", bad), None)


def test_synthetic_data_under_the_device_augment_is_uint8_at_decode_size():
    args = _args("--synthetic", "--device-augment", "--batch-size", "2",
                 "--steps-per-epoch", "1")
    cfg = _config_from_args(args, None)
    train_fn, val_fn = _classification_data(cfg, args)
    images, labels = next(iter(train_fn(1)))
    assert images.dtype == np.uint8 and images.shape == (2, 256, 256, 3)
    images, _ = next(iter(val_fn(1)))
    assert images.dtype == np.uint8 and images.shape == (2, 256, 256, 3)
    mnist = cfg.replace(data=dataclasses.replace(cfg.data, dataset="mnist"))
    args.synthetic = False
    with pytest.raises(SystemExit, match="device-augment"):
        _classification_data(mnist, args)


def _train(workdir, *extra):
    cmd = [sys.executable, os.path.join(REPO, "ResNet", "torch", "train.py"),
           "-m", "resnet50_tpu", "--synthetic", "--device-augment",
           "--device", "cpu", "--image-size", "32", "--steps-per-epoch", "2",
           "--batch-size", "4", "--workdir", str(workdir), *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_entry_point_trains_saves_and_resumes(tmp_path):
    first = _train(tmp_path, "--epochs", "1")
    assert first.returncode == 0, first.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "metrics.json"]
    assert os.path.exists(tmp_path / "ckpt" / "1" / "integrity_manifest.json")
    assert "params=25,557,032" in first.stdout
    assert "val_top1=" in first.stdout and "done: best=" in first.stdout
    second = _train(tmp_path, "--epochs", "2", "-c", "latest")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from epoch 1" in second.stdout
    assert "epoch 2 step 4" in second.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2",
                                                     "metrics.json"]
    state = torch.load(tmp_path / "ckpt" / "2" / "state.pt",
                       weights_only=True)
    assert len(state["ema"]) == 161
