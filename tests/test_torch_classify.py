"""The port's classification training path (deepvision_tpu_torch/core/
{losses,steps,trainer,train_state}.py, data/synthetic.py, models/vit.py's
dropout, cli.py and ViT/torch/train.py) against the JAX package on the CPU.

One train step of a vit_tiny-shaped ViT (32 px, patch 8, d=192, 3 heads,
MLP 768, 2 blocks, 10 classes, f32, dropout 0) runs in both packages from
the same weights (Flax shapes filled from a seeded numpy stream, bridged)
on the same synthetic batch, with vit_small's optimizer chain (adam, clip
1.0, cosine after a warmup) and its label smoothing 0.1. The JAX step is
compiled once and lowers attention naively; the port's runs the flash
kernel's plain version under the naive VJP. Its gradients are read back
from the Adam state (mu = (1 - b1) g after the first update: the clipped
gradient). Bounds:
- loss: 1e-5 relative; top-1/top-5: equal (fractions of 4 examples);
- gradients: 1e-4 of each leaf's largest (summation order through two
  blocks, f32), except the key projections' biases, whose gradient is 0
  (softmax ignores a per-query constant added to every score): there both
  stay below 1e-6 of the largest gradient of the model;
- parameters after the step: within 1e-3 of the step (lr 2.5e-4 in the
  warmup) wherever the gradient's sign is settled (|g| above 1e-4 of its
  leaf's largest, and not a key bias); anywhere, at most twice the step.
Losses and top-k: 1e-6 relative (f32 log-softmax). Masked evaluation: the
JAX eval step plus the JAX Trainer.evaluate arithmetic, 1e-5 relative.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.core import losses as jax_losses
from deepvision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deepvision_tpu.core.config import ScheduleConfig as JaxScheduleConfig
from deepvision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deepvision_tpu.core.steps import \
    make_classification_eval_step as jax_make_eval_step
from deepvision_tpu.core.steps import \
    make_classification_train_step as jax_make_train_step
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.data.synthetic import \
    SyntheticClassification as JaxSynthetic
from deepvision_tpu.models.vit import ViT as JaxViT
from deepvision_tpu_torch.cli import _classification_data
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import losses
from deepvision_tpu_torch.core.config import OptimizerConfig, ScheduleConfig
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.steps import (make_classification_eval_step,
                                             make_classification_train_step)
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.data.synthetic import SyntheticClassification
from deepvision_tpu_torch.models.vit import ViT, Dropout
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_classification_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY2 = dict(num_classes=10, patch_size=8, embed_dim=192, depth=2,
             num_heads=3, mlp_dim=768)
OPT = dict(name="adam", learning_rate=1e-3, grad_clip_norm=1.0)
SCHED = dict(name="cosine", warmup_epochs=1)
STEPS_PER_EPOCH, EPOCHS = 4, 2
LR0 = 1e-3 / 4          # the first update's LR: warmup (0 + 1) / 4
SMOOTHING = 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def flax_vit_params(model, x: np.ndarray, seed: int = 0) -> dict:
    """A numpy params tree of `model`'s shapes (no op-by-op init), filled
    from a seeded stream: lecun-scaled kernels, and biases, LayerNorm
    scales, cls token and position embedding away from their init values,
    so a bridge that dropped or misplaced a leaf could not pass."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x)))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        else:                           # bias, cls_token, pos_embed
            v = 0.05 * rs.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def _tiny_config():
    cfg = get_config("vit_tiny")
    return cfg.replace(dtype="float32", model_kwargs={
        **cfg.model_kwargs, "depth": TINY2["depth"]})


def _port_model(params) -> ViT:
    model = ViT(**TINY2, dtype=torch.float32, image_size=32)
    model.load_state_dict(params_to_state_dict(params, model))
    return model


@pytest.fixture(scope="module")
def one_step():
    torch.set_num_threads(1)
    images, labels = next(iter(JaxSynthetic(4, 32, 3, 10, 1, seed=0)))
    jax_model = JaxViT(**TINY2, attention_impl="naive", dtype=jnp.float32)
    params = flax_vit_params(jax_model, images)
    tx = jax_build_optimizer(JaxOptimizerConfig(**OPT),
                             JaxScheduleConfig(**SCHED), STEPS_PER_EPOCH,
                             EPOCHS)
    state = JaxTrainState.create(jax_model.apply, params, tx)
    step = jax_make_train_step(label_smoothing=SMOOTHING,
                               compute_dtype=jnp.float32, donate=False)
    new, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                        jax.random.PRNGKey(0))
    adam = next(s for s in new.opt_state.inner_state if hasattr(s, "mu"))
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                            jax.device_get(adam.mu)),
            "params": jax.device_get(new.params)}

    model = _port_model(params)
    opt = build_optimizer(model.parameters(), OptimizerConfig(**OPT),
                          ScheduleConfig(**SCHED), STEPS_PER_EPOCH, EPOCHS)
    port_state = TrainState(model, opt)
    port_step = make_classification_train_step(
        label_smoothing=SMOOTHING, compute_dtype=torch.float32)
    port_batch = next(iter(SyntheticClassification(4, 32, 3, 10, 1, seed=0)))
    got = port_step(port_state, *map(torch.from_numpy, port_batch))
    return {"want": want, "model": model, "state": port_state,
            "metrics": {k: float(v) for k, v in got.items()},
            "params": params, "batch": (images, labels),
            "port_batch": port_batch, "jax_model": jax_model,
            "jax_state": state}


# -- losses and top-k --------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("classes", [10, 3])
def test_losses_and_topk_match_jax(classes, smoothing):
    rs = np.random.RandomState(classes)
    logits = (3 * rs.randn(16, classes)).astype(np.float32)
    aux = (3 * rs.randn(16, classes)).astype(np.float32)
    labels = rs.randint(0, classes, 16).astype(np.int32)
    t = [torch.from_numpy(a) for a in (logits, aux, labels)]
    j = [jnp.asarray(a) for a in (logits, aux, labels)]
    np.testing.assert_allclose(
        losses.per_example_xent(t[0], t[2], smoothing).numpy(),
        np.asarray(jax_losses.per_example_xent(j[0], j[2], smoothing)),
        rtol=1e-6)
    for outs_t, outs_j in ((t[0], j[0]), ((t[0], t[1]), (j[0], j[1]))):
        assert float(losses.classification_loss(outs_t, t[2], smoothing)) \
            == pytest.approx(float(jax_losses.classification_loss(
                outs_j, j[2], smoothing)), rel=1e-6)
        acc = losses.topk_accuracies(outs_t, t[2])
        want = jax_losses.topk_accuracies(outs_j, j[2])
        assert {k: float(v) for k, v in acc.items()} == \
            {k: float(v) for k, v in want.items()}
        correct = losses.topk_correct(outs_t, t[2])
        for k, v in jax_losses.topk_correct(outs_j, j[2]).items():
            np.testing.assert_array_equal(correct[k].numpy(), np.asarray(v))


def test_synthetic_batches_are_the_jax_ones_bit_for_bit():
    for kw in (dict(seed=3), dict(seed=10**6, emit_uint8=True),
               dict(seed=1, learnable=False)):
        for w, g in zip(JaxSynthetic(3, 8, 2, 7, 2, **kw),
                        SyntheticClassification(3, 8, 2, 7, 2, **kw)):
            for a, b in zip(w, g):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(b, a)


# -- dropout -----------------------------------------------------------------

def test_dropout_masks_come_from_seed_and_step():
    """The masks are a function of (seed, step): the same step repeats,
    another step or seed draws others, and eval mode is the identity."""
    model = ViT(**TINY2, dropout_rate=0.5, image_size=32,
                generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3)
                         .astype(np.float32))
    state = TrainState(model, None, step=3, seed=1)

    def run(step, seed=1):
        state.step, state.seed = step, seed
        with torch.no_grad():
            return model(x, generator=state.dropout_generator())

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.allclose(run(3), run(4))
    assert not torch.allclose(run(3), run(3, seed=2))
    with pytest.raises(ValueError, match="generator"):
        model(x)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)


def test_dropout_drops_at_its_rate_and_rescales():
    """Binomial: 10^5 draws at rate 0.1 have a std of 9.5e-4 in the
    dropped fraction; 5e-3 is over 5 std."""
    drop = Dropout(0.1).train()
    x = torch.ones(100_000)
    y = drop(x, torch.Generator().manual_seed(0))
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - 0.1) < 5e-3
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))


# -- one train step against the JAX step -------------------------------------

def test_one_step_loss_and_topk_match_jax(one_step):
    want, got = one_step["want"]["metrics"], one_step["metrics"]
    assert set(got) == set(want) == {"loss", "top1", "top5"}
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])
    for w, g in zip(one_step["batch"], one_step["port_batch"]):
        np.testing.assert_array_equal(g, w)
    state = one_step["state"]
    assert state.step == 1 and state.optimizer.count == 1


def _zero_gradient(name: str) -> bool:
    return name.endswith("attn.key.bias")


def test_one_step_gradients_match_jax(one_step):
    model = one_step["model"]
    want = params_to_state_dict(one_step["want"]["grads"], model)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    top = max(w.abs().max().item() for w in want.values())
    for name, g in grads.items():
        w = want[name]
        if _zero_gradient(name):
            assert max(g.abs().max().item(), w.abs().max().item()) \
                <= 1e-6 * top, name
            continue
        scale = w.abs().max().item()
        assert scale > 1e-4 * top, name
        assert (g - w).abs().max().item() <= 1e-4 * scale, name


def test_one_step_parameters_match_jax(one_step):
    model = one_step["model"]
    want = params_to_state_dict(one_step["want"]["params"], model)
    grads = params_to_state_dict(one_step["want"]["grads"], model)
    unsettled = total = 0
    for name, p in model.named_parameters():
        g = grads[name].abs()
        settled = (g >= 1e-4 * g.max()) & (not _zero_gradient(name))
        diff = (p.detach() - want[name]).abs()
        if settled.any():
            assert diff[settled].max().item() <= LR0 * 1e-3, name
        assert diff.max().item() <= 2 * LR0 * (1 + 1e-3), name
        unsettled += int((~settled).sum())
        total += g.numel()
    assert unsettled < 0.05 * total


# -- masked evaluation -------------------------------------------------------

def _val_batches():
    """Two full batches of 4 and a partial last one of 3."""
    batches = list(SyntheticClassification(4, 32, 3, 10, 3, seed=5))
    images, labels = batches[-1]
    batches[-1] = (images[:3], labels[:3])
    return batches


def _jax_evaluate(one_step, batches):
    """The JAX eval step with the arithmetic of the JAX Trainer.evaluate on
    one device: pad to the running maximum, mask, sum, divide by count."""
    step = jax_make_eval_step(compute_dtype=jnp.float32)
    state = one_step["jax_state"]
    sums, target = {}, 0
    for images, labels in batches:
        n = len(labels)
        target = max(target, n)
        mask = np.zeros((target,), np.float32)
        mask[:n] = 1.0
        if target != n:
            images = np.pad(images, [(0, target - n)] + [(0, 0)] * 3)
            labels = np.pad(labels, [(0, target - n)])
        m = jax.device_get(step(state, jnp.asarray(images),
                                jnp.asarray(labels), jnp.asarray(mask)))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    count = sums.pop("count")
    return {**{k: v / count for k, v in sums.items()}, "count": count}


def test_masked_eval_of_a_partial_batch_matches_jax(one_step, tmp_path):
    trainer = Trainer(_tiny_config(), device="cpu", workdir=str(tmp_path),
                      model=_port_model(one_step["params"]))
    trainer.init_state()
    batches = _val_batches()
    got = trainer.evaluate(batches)
    want = _jax_evaluate(one_step, batches)
    assert got["count"] == want["count"] == 11.0
    assert set(got) == {"loss", "top1", "top5", "count"}
    for k in ("loss", "top1", "top5"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    trainer.close()


def test_padded_rows_add_nothing(one_step):
    """A batch padded with garbage rows under mask 0 sums to what the
    unpadded batch sums to."""
    state = TrainState(_port_model(one_step["params"]), None)
    step = make_classification_eval_step(compute_dtype=torch.float32)
    images, labels = _val_batches()[-1]
    plain = step(state, torch.from_numpy(images), torch.from_numpy(labels),
                 torch.ones(3))
    junk = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    padded = step(state, torch.from_numpy(np.concatenate([images, junk])),
                  torch.from_numpy(np.concatenate([labels, [7, 7]])
                                   .astype(np.int32)),
                  torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0]))
    assert float(padded["count"]) == 3.0
    for k in ("loss", "top1", "top5"):
        assert float(padded[k]) == pytest.approx(float(plain[k]), rel=1e-6)


# -- the trainer and the entry point -----------------------------------------

def test_trainer_scales_the_lr_by_the_effective_batch(tmp_path):
    cfg = _tiny_config()
    cfg = cfg.replace(batch_size=8, optimizer=dataclasses.replace(
        cfg.optimizer, base_batch_size=32, accum_steps=2))
    trainer = Trainer(cfg, device="cpu", workdir=str(tmp_path))
    assert trainer.opt_cfg.learning_rate == pytest.approx(1e-3 * 16 / 32)
    assert trainer.steps_per_epoch == 512 // 8
    state = trainer.init_state()
    step = trainer.train_step
    for images, labels in SyntheticClassification(8, 32, 3, 10, 3, seed=1):
        step(state, torch.from_numpy(images), torch.from_numpy(labels))
    assert (state.step, state.optimizer.count,
            state.optimizer.mini_step) == (3, 1, 1)
    trainer.close()


@pytest.mark.parametrize("dataset", ["imagenet", "imagenet_flat"])
def test_datasets_not_ported_raise(tmp_path, dataset):
    """Once refused by name, the ImageNet TFRecord and flat-directory
    datasets now feed the classification CLI: its val batches are the JAX
    CLI's, the same records in the same order, pixels within the decode
    and resize gap (tests/test_torch_loaders.py), and its training
    batches have the rank's shape."""
    import tensorflow as tf
    from torch_records_fixtures import write_flat, write_imagenet

    from deepvision_tpu import cli as jax_cli
    from deepvision_tpu.configs import get_config as jax_get_config
    tf.config.set_visible_devices([], "GPU")
    root = str(tmp_path)
    if dataset == "imagenet":
        write_imagenet(root, "train", [6, 5], seed=3)
        write_imagenet(root, "val", [5, 4], seed=4)
    else:
        synsets = write_flat(os.path.join(root, "train_flatten"), n=9)
        write_flat(os.path.join(root, "val_flatten"), n=8, seed=1)
        with open(os.path.join(root, "synsets.txt"), "w") as fh:
            fh.write("\n".join(synsets) + "\n")
    args = argparse.Namespace(synthetic=False, data_dir=root,
                              steps_per_epoch=2, device="cpu")

    def cut(cfg):
        return cfg.replace(batch_size=4, data=dataclasses.replace(
            cfg.data, dataset=dataset, image_size=32))

    train_fn, val_fn = _classification_data(cut(get_config("vit_small")),
                                            args)
    jtrain, jval = jax_cli._classification_data(
        cut(jax_get_config("vit_small")), args)
    got, want = list(val_fn(0)), list(jval(0))
    assert len(got) == len(want) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl.numpy(), wl)
        assert gi.dtype == torch.float32 and gi.shape == wi.shape
        # TFRecords: TensorFlow's default decode against PIL's, 7 levels,
        # through the bicubic (its |weights| sum to at most 1.5625);
        # the flat layout: both decode with PIL, a level apart (PIL rounds
        # between its two resize passes); normalised by the smallest std
        levels = 7 * 1.5625 if dataset == "imagenet" else 1.001
        assert float(np.abs(gi.numpy() - wi).max()) <= levels / 255 / 0.224
    batches = list(train_fn(1))
    assert len(batches) == 2
    assert all(tuple(b[0].shape) == (4, 32, 32, 3) for b in batches)


def test_training_raises_val_top1_above_the_untrained(tmp_path):
    """vit_tiny (bf16 compute, adam 1e-3) on the learnable synthetic set:
    2 epochs of 16 steps at batch 16 lift top-1 on the validation batches
    above the untrained model's."""
    cfg = get_config("vit_tiny").replace(batch_size=16, total_epochs=2)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               train_examples=16 * 16))
    trainer = Trainer(cfg, device="cpu", workdir=str(tmp_path))
    trainer.init_state()

    def val(epoch):
        return SyntheticClassification(16, 32, 3, 10, 2, seed=10**6)

    def train(epoch):
        return SyntheticClassification(16, 32, 3, 10, 16, seed=epoch)

    before = trainer.evaluate(val(0))["top1"]
    result = trainer.fit(train, val)
    trainer.close()
    assert result["count"] == 32.0
    assert result["top1"] > before + 0.2, (before, result)


def _train(workdir, *extra):
    cmd = [sys.executable, os.path.join(REPO, "ViT", "torch", "train.py"),
           "-m", "vit_tiny", "--synthetic", "--device", "cpu",
           "--steps-per-epoch", "2", "--batch-size", "4", "--workdir",
           str(workdir), *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_entry_point_trains_saves_and_resumes(tmp_path):
    first = _train(tmp_path, "--epochs", "1")
    assert first.returncode == 0, first.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "metrics.json"]
    assert os.path.exists(tmp_path / "ckpt" / "1" / "integrity_manifest.json")
    assert "val_top1=" in first.stdout and "done: best=" in first.stdout
    second = _train(tmp_path, "--epochs", "2", "-c", "latest")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from epoch 1" in second.stdout
    assert "epoch 2 step 4" in second.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2",
                                                     "metrics.json"]
    assert os.path.exists(tmp_path / "ckpt" / "2" / "integrity_manifest.json")
