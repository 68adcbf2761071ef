"""The port's segmentation family (deepvision_tpu_torch/{models,core,data}/
segment*.py, the paired device augment, core/metrics.py's confusion
metrics, configs, cli.run_segmentation, UNet/torch/train.py) against the
JAX package on the CPU.

The same numpy inputs and weights (seeded) go through both. Weights are
Flax variables of the shapes `UNetSegmenter.init` gives, filled from numpy
(tests/test_torch_yolo.py::flax_yolo_variables) and carried over by the
weight bridge: `unet_small` (the unet_synthetic / unet_digits model) at 32
px and `unet_resnet50` at 64 px. Each JAX oracle compiles once per model
and mode.

Bounds:
- data (synthetic scenes, digit scenes, batches, palette): bit for bit;
- losses, dice, pixel accuracy: 1e-6 relative; confusion counts, mIoU and
  pixel accuracy of the streaming sums: exact (integer counts);
- the paired augment on JAX's own draws: images 1e-4 (f32, as
  tests/test_torch_device_augment.py), masks exact; the eval stage exact;
- f32 forwards, eval and train mode: 1e-5 of the logits' largest value
  (measured 6e-7 for unet_small); train-mode BatchNorm statistics 5e-5
  (tests/test_torch_pose.py's bound). unet_resnet50's train-mode forward
  at 64 px: 1e-3 (measured 1.7e-4): at stride 32 its BatchNorms take their
  statistics over 8 values a channel (2 images of 2x2), and dividing by
  so small a batch's deviation magnifies the sums' roundings, which run
  in another order in each package;
- bf16 eval forward of unet_resnet50: 5e-2 of the largest logit
  (tests/test_torch_yolo.py's bound for a BatchNorm net in bf16);
- one f32 train step: loss, pixel accuracy and the loss parts 1e-4
  relative, gradients 1e-3 of each leaf's largest (the zero-gradient conv
  biases ahead of a train-mode BatchNorm: none here, the U-Net's convs have
  no bias but the head's), batch_stats 5e-5; the eval step's loss 1e-5
  relative and its confusion exact;
- `SegmentationTrainer.evaluate` against the JAX trainer's on the same
  weights and batches: loss 1e-5 relative, miou and pixel_acc within 1e-6.
No threshold of the JAX gate tests/test_segment.py:228 is taken.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core import metrics as jax_metrics
from deepvision_tpu.core import segment as jax_seg
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.data import device_augment as jax_daug
from deepvision_tpu.data import segmentation as jax_data
from deepvision_tpu.models import segment as jax_models
from deepvision_tpu.parallel import mesh as jax_mesh
from deepvision_tpu_torch import cli
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import metrics
from deepvision_tpu_torch.core import segment as seg
from deepvision_tpu_torch.data import device_augment as daug
from deepvision_tpu_torch.data import segmentation as data
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.models.resnet import BasicBlock
from deepvision_tpu_torch.models.segment import UNetSegmenter
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_device_augment import _jax_draws
from test_torch_yolo import flax_yolo_variables

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_segmentation_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _images(n, size, seed=1):
    return (np.random.RandomState(seed).rand(n, size, size, 3)
            .astype(np.float32) * 2 - 1)


def _masks(n, size, seed=2, classes=C):
    return np.random.RandomState(seed).randint(
        0, classes, (n, size, size)).astype(np.int32)


def _small(dtype="float32"):
    jm = jax_models.UNetSegmenter(num_classes=C, stage_sizes=(1, 1),
                                  block=jax_models.BasicBlock, width=8,
                                  dtype=jnp.dtype(dtype))
    tm = UNetSegmenter(C, (1, 1), BasicBlock, 8, dtype=getattr(torch, dtype))
    return jm, tm


def _load(tm, params, stats):
    tm.load_state_dict(params_to_state_dict(params, tm, stats), strict=False)
    return tm


# -- models ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """unet_small at 32 px, f32: the JAX forward in eval and train mode
    (one compile each) on numpy-filled weights, and the port's model on
    the same weights."""
    jm, tm = _small()
    x = _images(2, 32)
    params, stats = flax_yolo_variables(jm, x)
    v = {"params": params, "batch_stats": stats}
    eval_fn = jax.jit(lambda v, x: jm.apply(v, x))
    train_fn = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                             mutable=["batch_stats"]))
    ev = np.asarray(eval_fn(v, x))
    tr, mut = train_fn(v, x)
    return {"jm": jm, "tm": _load(tm, params, stats), "x": x,
            "params": params, "stats": stats, "eval": ev,
            "train": np.asarray(tr), "stats_after": jax.device_get(
                mut["batch_stats"])}


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_unet_small_forward_matches_jax(small, mode):
    tm = small["tm"]
    tm.train(mode == "train")
    with torch.no_grad():
        got = tm(torch.from_numpy(small["x"]))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, C)
    assert _rel(got.numpy(), small[mode]) <= 1e-5
    if mode == "train":
        stats = params_to_state_dict(small["params"], tm,
                                     small["stats_after"])
        sd = tm.state_dict()
        for k in (k for k in stats if "running" in k):
            torch.testing.assert_close(sd[k], stats[k], rtol=5e-5, atol=5e-5)
        _load(tm, small["params"], small["stats"])


def _jax_forwards(jm, v, x, train: bool) -> dict:
    """The JAX model's eval forward (and train forward) as f32 numpy, one
    compile each."""
    eval_fn = jax.jit(lambda v, x: jm.apply(v, x))
    out = {"eval": np.asarray(eval_fn(v, x).astype(jnp.float32))}
    if train:
        train_fn = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"])[0])
        out["train"] = np.asarray(train_fn(v, x))
    return out


@pytest.fixture(scope="module")
def resnet50():
    """unet_resnet50 at 64 px on numpy-filled weights: the JAX f32 forward
    in eval and train mode and the bf16 eval forward (one compile each)."""
    x = _images(2, 64)
    f32 = jax_models.UNetSegmenter(num_classes=21, dtype=jnp.float32)
    params, stats = flax_yolo_variables(f32, x, seed=3)
    v = {"params": params, "batch_stats": stats}
    out = {"x": x, "params": params, "stats": stats}
    for dtype in ("float32", "bfloat16"):
        jm = jax_models.UNetSegmenter(num_classes=21, dtype=jnp.dtype(dtype))
        for mode, y in _jax_forwards(jm, v, x, dtype == "float32").items():
            out[f"{mode}_{dtype}"] = y
    return out


@pytest.mark.parametrize("mode,dtype,bound", [
    ("eval", "float32", 1e-5), ("train", "float32", 1e-3),
    ("eval", "bfloat16", 5e-2)])
def test_unet_resnet50_forward_matches_jax_at_64px(resnet50, mode, dtype,
                                                   bound):
    cfg = get_config("unet_resnet50").replace(dtype=dtype)
    tm = _load(build_model(cfg), resnet50["params"], resnet50["stats"])
    tm.train(mode == "train")
    with torch.no_grad():
        got = tm(torch.from_numpy(resnet50["x"]))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64, 21)
    assert _rel(got.numpy(), resnet50[f"{mode}_{dtype}"]) <= bound


@pytest.mark.parametrize("name", ["unet_resnet50", "unet_synthetic",
                                  "unet_digits"])
def test_full_size_trees_carry_over_leaf_for_leaf(name):
    """The JAX model of each config, its variables from `jax.eval_shape`
    and numpy fills, onto the port's model of the same config: every leaf
    lands once with its shape, and the parameter counts agree."""
    jcfg = jax_get_config(name)
    from deepvision_tpu.core.trainer import build_model_from_config
    jm, _ = build_model_from_config(jcfg)
    size = jcfg.data.image_size
    params, stats = flax_yolo_variables(jm, np.zeros((1, size, size, 3),
                                                     np.float32))
    tm = build_model(get_config(name))
    sd = params_to_state_dict(params, tm, stats)
    assert set(sd) == {k for k in tm.state_dict()
                       if not k.endswith("num_batches_tracked")}
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))


def test_unet_refuses_misaligned_sizes_with_the_jax_message():
    jm, tm = _small()
    x = np.zeros((1, 36, 32, 3), np.float32)
    with pytest.raises(ValueError) as want:
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        tm(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


# -- losses and metrics ---------------------------------------------------------

def _logits(n=3, size=8, seed=4):
    return np.random.RandomState(seed).randn(n, size, size, C).astype(
        np.float32) * 2


@pytest.mark.parametrize("dice_weight", [0.0, 0.5])
def test_losses_match_jax(dice_weight):
    logits, masks = _logits(), _masks(3, 8)
    want = jax_seg.segmentation_loss(jnp.asarray(logits), jnp.asarray(masks),
                                     dice_weight)
    got = seg.segmentation_loss(torch.from_numpy(logits),
                                torch.from_numpy(masks), dice_weight)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
    assert float(seg.soft_dice_loss(torch.from_numpy(logits),
                                    torch.from_numpy(masks))) == \
        pytest.approx(float(jax_seg.soft_dice_loss(
            jnp.asarray(logits), jnp.asarray(masks))), rel=1e-6)
    assert float(seg.pixel_accuracy(torch.from_numpy(logits),
                                    torch.from_numpy(masks))) == float(
        jax_seg.pixel_accuracy(jnp.asarray(logits), jnp.asarray(masks)))
    assert (seg.DICE_WEIGHT, seg.DICE_EPS) == (jax_seg.DICE_WEIGHT,
                                               jax_seg.DICE_EPS)


@pytest.mark.parametrize("loss", ["softmax_xent", "xent", "xent_dice",
                                  "dice"])
def test_dice_weight_for_matches_jax(loss):
    cfg, jcfg = (c.replace(loss=loss) for c in (
        get_config("unet_synthetic"), jax_get_config("unet_synthetic")))
    try:
        want = jax_seg.dice_weight_for(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            seg.dice_weight_for(cfg)
        assert str(got.value) == str(e)
        return
    assert seg.dice_weight_for(cfg) == want


def test_confusion_and_scores_match_jax():
    rs = np.random.RandomState(5)
    preds, labels = (rs.randint(0, C, (4, 9, 9)) for _ in range(2))
    labels[labels == 3] = 2                 # class 3 absent from the truth
    want = np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(preds), jnp.asarray(labels), C))
    got = metrics.confusion_matrix(torch.from_numpy(preds),
                                   torch.from_numpy(labels), C)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    js, ts = (m.StreamingConfusion(C) for m in (jax_metrics, metrics))
    for _ in range(2):
        js.update(want)
        ts.update(got.numpy())
    a, b = js.result(), ts.result()
    assert (a["miou"], a["pixel_acc"]) == (b["miou"], b["pixel_acc"])
    np.testing.assert_array_equal(a["per_class_iou"], b["per_class_iou"])
    np.testing.assert_array_equal(a["present"], b["present"])
    with pytest.raises(ValueError, match="confusion matrix shape"):
        ts.update(np.zeros((C + 1, C + 1)))


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("emit_uint8", [False, True])
def test_synthetic_segmentation_equals_jax(emit_uint8):
    want = list(jax_data.SyntheticSegmentation(3, 40, 3, C, 2, seed=7,
                                               emit_uint8=emit_uint8))
    got = list(data.SyntheticSegmentation(3, 40, 3, C, 2, seed=7,
                                          emit_uint8=emit_uint8))
    assert len(got) == len(want) == 2
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.dtype == wi.dtype and gm.dtype == wm.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(data.class_palette(11),
                                  jax_data.class_palette(11))
    with pytest.raises(ValueError, match=">= 2 classes"):
        data.SyntheticSegmentation(2, num_classes=1)


def test_digit_scenes_and_batches_equal_jax():
    want = jax_data.segmentation_val_scenes(canvas=64, n_scenes=6)
    got = data.segmentation_val_scenes(canvas=64, n_scenes=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].max() > 0
    for g, w in zip(data.segmentation_batches(got, batch_size=4,
                                              shuffle_seed=3),
                    jax_data.segmentation_batches(want, batch_size=4,
                                                  shuffle_seed=3)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of the 8px"):
        data.segmentation_scenes(got[0], got[1], n_scenes=1, digit_px=12)


# -- the paired device augment --------------------------------------------------

def test_paired_train_augment_matches_jax_on_its_draws():
    rs = np.random.RandomState(8)
    images = rs.randint(0, 256, (6, 40, 40, 3)).astype(np.uint8)
    masks = rs.randint(0, C, (6, 40, 40)).astype(np.uint8)
    rng = jax.random.PRNGKey(9)
    aug = jax.jit(jax_daug.make_paired_train_augment(
        32, mean=(0.5,) * 3, std=(0.5,) * 3, compute_dtype=jnp.float32))
    want_i, want_m = aug(jnp.asarray(images), jnp.asarray(masks), rng)
    draws = _jax_draws(rng, 6, 40, 40, daug.DEFAULT_JITTER)
    got_i, got_m = daug.apply_paired_train_augment(
        torch.from_numpy(images), torch.from_numpy(masks), draws, 32,
        mean=(0.5,) * 3, std=(0.5,) * 3, compute_dtype=torch.float32)
    assert draws.flip.any() and not draws.flip.all()
    assert got_m.dtype == torch.int32 and got_m.shape == (6, 32, 32)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert np.abs(got_i.numpy() - np.asarray(want_i)).max() <= 1e-4
    # the port's own draw path: one draw for both tensors
    gen = torch.Generator().manual_seed(0)
    fi, fm = daug.make_paired_train_augment(32, compute_dtype=torch.float32)(
        torch.from_numpy(images), torch.from_numpy(masks), gen)
    assert fi.shape == (6, 32, 32, 3) and fm.dtype == torch.int32


def test_paired_eval_augment_matches_jax():
    rs = np.random.RandomState(10)
    images = rs.randint(0, 256, (2, 40, 40, 3)).astype(np.uint8)
    masks = rs.randint(0, C, (2, 40, 40)).astype(np.uint8)
    wi, wm = jax_daug.make_paired_eval_augment(32, compute_dtype=jnp.float32)(
        jnp.asarray(images), jnp.asarray(masks))
    gi, gm = daug.make_paired_eval_augment(32, compute_dtype=torch.float32)(
        torch.from_numpy(images), torch.from_numpy(masks))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gm.dtype == torch.int32


# -- steps and the trainer ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step(small):
    """The JAX train step (xent + dice) once on the filled weights, its
    gradients read from Adam's first moment (0.1 g after one step), and
    the JAX eval and predict steps on the same weights."""
    jm = small["jm"]
    x, masks = small["x"], _masks(2, 32, seed=11)
    state = JaxTrainState.create(jm.apply, small["params"], optax.adam(1.0),
                                 small["stats"])
    step = jax_seg.make_segmentation_train_step(
        num_classes=C, compute_dtype=jnp.float32, donate=False,
        dice_weight=0.5)
    new, m = step(state, jnp.asarray(x), jnp.asarray(masks),
                  jax.random.PRNGKey(0))
    mu = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")][0].mu
    ev = jax_seg.make_segmentation_eval_step(
        num_classes=C, compute_dtype=jnp.float32, dice_weight=0.5)(
        state, jnp.asarray(x), jnp.asarray(masks))
    pred = jax_seg.make_segmentation_predict_step(
        compute_dtype=jnp.float32)(state, jnp.asarray(x))
    return {"masks": masks, "metrics": jax.device_get(m),
            "grads": jax.tree_util.tree_map(lambda a: np.asarray(a) / 0.1,
                                            jax.device_get(mu)),
            "stats": jax.device_get(new.batch_stats),
            "eval": jax.device_get(ev), "predict": np.asarray(pred)}


def _port_state(small):
    from deepvision_tpu_torch.core.optim import build_optimizer
    from deepvision_tpu_torch.core.train_state import TrainState
    cfg = get_config("unet_synthetic")
    _, tm = _small()
    _load(tm, small["params"], small["stats"])
    return TrainState(tm, build_optimizer(tm.parameters(), cfg.optimizer,
                                          cfg.schedule, 1, 1))


def test_train_step_matches_jax(small, jax_step):
    state = _port_state(small)
    step = seg.make_segmentation_train_step(compute_dtype=torch.float32,
                                            dice_weight=0.5)
    got = step(state, torch.from_numpy(small["x"]),
               torch.from_numpy(jax_step["masks"]))
    want = jax_step["metrics"]
    assert set(got) == set(want) == {"loss", "pixel_acc", "ce_loss",
                                     "dice_loss"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k
    model = state.model
    grads = params_to_state_dict(jax_step["grads"], model,
                                 jax_step["stats"])
    top = max(grads[n].abs().max().item()
              for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        scale = grads[name].abs().max().item()
        err = (p.grad - grads[name]).abs().max().item()
        assert err <= 1e-3 * max(scale, 1e-6 * top), name
    sd = model.state_dict()
    for k in (k for k in grads if "running" in k):
        torch.testing.assert_close(sd[k], grads[k], rtol=5e-5, atol=5e-5)
    assert state.step == 1


def test_eval_and_predict_steps_match_jax(small, jax_step):
    state = _port_state(small)
    x, masks = torch.from_numpy(small["x"]), torch.from_numpy(
        jax_step["masks"])
    got = seg.make_segmentation_eval_step(
        num_classes=C, compute_dtype=torch.float32, dice_weight=0.5)(
        state, x, masks)
    assert float(got["loss"]) == pytest.approx(
        float(jax_step["eval"]["loss"]), rel=1e-5)
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  jax_step["eval"]["confusion"])
    pred = seg.make_segmentation_predict_step(compute_dtype=torch.float32)(
        state, x)
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), jax_step["predict"])


def test_trainer_evaluate_matches_jax(small, tmp_path):
    """`SegmentationTrainer.evaluate` (the streaming confusion, the finite
    batch mean) against the JAX trainer's on the same weights and two
    batches of the synthetic validation stream."""
    jcfg = jax_get_config("unet_synthetic").replace(batch_size=2)
    jt = jax_seg.SegmentationTrainer(
        jcfg, mesh=jax_mesh.make_mesh(jax.devices()[:1]),
        workdir=str(tmp_path / "jax"))
    jt.init_state((32, 32, 3))
    jt.state = jt.state.replace(params=small["params"],
                                batch_stats=small["stats"])
    batches = list(jax_data.SyntheticSegmentation(2, 32, 3, C, 2, seed=12))
    want = jt.evaluate(batches)
    cfg = get_config("unet_synthetic").replace(batch_size=2)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=32))
    trainer = seg.SegmentationTrainer(cfg, device="cpu",
                                      workdir=str(tmp_path / "port"))
    _load(trainer.model, small["params"], small["stats"])
    trainer.init_state()
    got = trainer.evaluate(batches)
    trainer.close()
    assert set(got) == set(want) == {"loss", "count", "miou", "pixel_acc"}
    assert got["count"] == want["count"] == 2.0
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for k in ("miou", "pixel_acc"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    nan = [(b[0] * np.nan, b[1]) for b in batches[:1]] + batches[1:]
    assert trainer.evaluate(nan)["count"] == 1.0


# -- configs and the entry point ------------------------------------------------

def test_sp2_config_is_refused_by_name():
    with pytest.raises(ValueError, match="ROADMAP A6"):
        get_config("unet_synthetic_sp2")
    with pytest.raises(SystemExit, match="ROADMAP A6"):
        cli.run_segmentation("UNet", ["unet_synthetic_sp2"], [
            "-m", "unet_synthetic_sp2", "--synthetic", "--device", "cpu"])


def test_entry_point_lists_the_jax_models():
    import runpy
    ours = runpy.run_path(os.path.join(REPO, "UNet", "torch", "train.py"),
                          run_name="not_main")["MODELS"]
    theirs = runpy.run_path(os.path.join(REPO, "UNet", "jax", "train.py"),
                            run_name="not_main")["MODELS"]
    assert ours == theirs


def test_synthetic_canvas_and_device_normalize_refusal(tmp_path):
    """--synthetic trains on the 64 px canvas; the digits scenes refuse
    --device-augment."""
    trainer, result = cli.run_segmentation("UNet", ["unet_synthetic"], [
        "-m", "unet_synthetic", "--synthetic", "--device", "cpu",
        "--epochs", "1", "--steps-per-epoch", "1", "--batch-size", "2",
        "--workdir", str(tmp_path / "wd")])
    assert trainer.config.data.image_size == 64
    assert np.isfinite(result["loss"]) and 0.0 <= result["miou"] <= 1.0
    with pytest.raises(SystemExit, match="digits_seg ships float"):
        cli.run_segmentation("UNet", ["unet_digits"], [
            "-m", "unet_digits", "--device-augment", "--device", "cpu",
            "--epochs", "1", "--workdir", str(tmp_path / "d")])


def test_digits_data_recompose_per_epoch(tmp_path):
    """unet_digits' train scenes are composed with seed 1000 + epoch (the
    JAX CLI's), cut to --steps-per-epoch batches; the validation scenes
    are the pinned set."""
    cfg = get_config("unet_digits").replace(batch_size=4)
    args = cli.build_parser("UNet", ["unet_digits"]).parse_args(
        ["-m", "unet_digits", "--steps-per-epoch", "2"])
    train_fn, val_fn = cli._segmentation_data(cfg, args)
    (tr_x, tr_y), _ = jax_data.scan_splits()
    want = jax_data.segmentation_scenes(tr_x, tr_y, n_scenes=512, canvas=64,
                                        seed=1003)
    batches = list(train_fn(3))
    assert len(batches) == 2
    for got, ref in zip(batches, jax_data.segmentation_batches(
            want, batch_size=4, shuffle_seed=3)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    val = next(iter(val_fn(1)))
    np.testing.assert_array_equal(val[0], jax_data.segmentation_val_scenes(
        canvas=64, n_scenes=128)[0][:4])


# -- data parallelism -----------------------------------------------------------

def _seg_ddp_step(workdir: str) -> dict:
    """One f64 train step of a seeded unet_small on this process's rows of
    a global batch of 4 at 32 px, then the evaluation of two global
    batches: the loss, gradients, BatchNorm statistics and eval result."""
    from deepvision_tpu_torch.parallel import mesh
    from test_torch_pose import float64_copy
    cfg = get_config("unet_synthetic").replace(batch_size=4)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=32))
    trainer = seg.SegmentationTrainer(
        cfg, device="cpu", workdir=workdir,
        model=float64_copy(build_model(cfg)))
    trainer.init_state()
    images, masks = _images(4, 32, seed=13), _masks(4, 32, seed=14)
    rows = [mesh.shard_rows(a, mesh.rank(), mesh.world_size())
            for a in (images, masks)]
    loss = float(trainer.run_step(trainer._to_device(rows))["loss"])
    model = trainer.model
    out = {"loss": loss,
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "stats": {k: v.clone() for k, v in model.state_dict().items()
                     if "running" in k},
           "eval": trainer.evaluate([(images, masks),
                                     (images[::-1].copy(),
                                      masks[::-1].copy())])}
    trainer.close()
    return out


def _seg_ddp_rank(out: str) -> None:
    from deepvision_tpu_torch.parallel import mesh
    torch.save(_seg_ddp_step(os.path.join(out, "wd")),
               os.path.join(out, f"rank{mesh.rank()}.pt"))


def test_two_rank_segmentation_step_equals_the_one_process_step(tmp_path):
    """2 gloo ranks (global BatchNorm, DDP-averaged gradients, the global
    confusion) against one process on the same global batch, in f64:
    loss 1e-12 relative, gradients 1e-9 of the largest, BatchNorm
    statistics 1e-12 of the largest (chip_smoke.py's DDP_F64_* bounds);
    the evaluation's confusion-derived mIoU and pixel accuracy equal, its
    loss 1e-12 relative."""
    from deepvision_tpu_torch.parallel import mesh
    mesh.spawn_ranks(_seg_ddp_rank, (str(tmp_path),), world=2, timeout=300)
    one = _seg_ddp_step(str(tmp_path / "one"))
    top = max(g.abs().max().item() for g in one["grads"].values())
    stat_top = max(v.abs().max().item() for v in one["stats"].values())
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-12)
        for n, g in one["grads"].items():
            assert (got["grads"][n] - g).abs().max().item() <= 1e-9 * top, n
        for k, v in one["stats"].items():
            assert (got["stats"][k] - v).abs().max().item() \
                <= 1e-12 * stat_top, k
        assert got["eval"]["count"] == one["eval"]["count"] == 2.0
        assert got["eval"]["loss"] == pytest.approx(one["eval"]["loss"],
                                                    rel=1e-12)
        for k in ("miou", "pixel_acc"):
            assert got["eval"][k] == one["eval"][k], k
