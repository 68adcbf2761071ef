"""The port's pose family (deepvision_tpu_torch/{ops/heatmap,models/hourglass,
data/pose,core/pose,core/eval_pose}.py, cli.run_pose) against the JAX
package on the CPU.

The same numpy inputs and weights (seeded) go through both. Weights are
Flax variables of the shapes `StackedHourglass.init` gives, filled from
numpy (tests/test_torch_yolo.py::flax_yolo_variables) and carried over by
the weight bridge. The tiny model is `StackedHourglass(num_heatmap=4,
num_stack=2, order=2, width_mult=1/16)` at 32 px (8x8 heatmaps).

Bounds:
- heatmaps, loss: 1e-6 (the same f32 operations); keypoint decode exact;
  evaluator summaries equal;
- f32 eval forward: 1e-5 of each stack's largest value (measured 5.4e-7);
- bf16 eval forward: 5e-2, the bound tests/test_torch_yolo.py measured for
  a BatchNorm net in bf16 (measured here 1.7e-2; JAX's own bf16 heads lie
  about as far from its f32 ones);
- one f32 train step: loss 1e-4 relative, gradients 1e-3 of each leaf's
  largest (tests/test_torch_detection_train.py's bounds); batch_stats
  5e-5: the train-mode forward's roundings compound over the two stacks
  before the last statistics, which lie up to 4e-6 (JAX) and 1.7e-5 (the
  port) from the same step in f64, 2.1e-5 from each other.
  The bias of a conv whose output a train-mode BatchNorm normalizes has a
  zero gradient in exact arithmetic (the batch mean takes it away): both
  packages return rounding noise there (up to 2e-4 against the model's
  largest gradient of about 1), so those leaves, found by their zero
  gradient in an f64 step of the port, are held to 1e-3 of the model's
  largest gradient instead;
- two trainer steps from the JAX trainer's initial weights: the logged
  train losses 1e-4 relative. The validation loss after them is not
  compared: Adam's first steps move every parameter by about the learning
  rate whatever its gradient's size, so the zero-gradient biases above
  step by +-lr with the sign of their rounding noise, which differs
  between the packages. Train-mode BatchNorm takes those biases away; the
  eval forward on running statistics still near their init passes them
  on and amplifies them (1.4% apart here).
"""

import copy
import dataclasses
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.core import eval_pose as jax_eval_pose
from deepvision_tpu.core import pose as jax_pose
from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.data import pose as jax_pose_data
from deepvision_tpu.models.hourglass import StackedHourglass as JaxHourglass
from deepvision_tpu.ops import heatmap as jax_heatmap
from deepvision_tpu.parallel import mesh as jax_mesh
from deepvision_tpu.parallel import prefetch as jax_prefetch
from deepvision_tpu_torch import cli
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import eval_pose, pose
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data import pose as pose_data
from deepvision_tpu_torch.models.hourglass import StackedHourglass
from deepvision_tpu_torch.ops import heatmap
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_yolo import flax_yolo_variables

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_pose_train_step` by name to the JAX package's donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_KW = dict(num_stack=2, order=2, width_mult=1 / 16)
TINY = dict(TINY_KW, num_heatmap=4)
SIZE, HM = 32, 8
BOUND = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _keypoints(rs, b, k):
    """Keypoints in and around the unit square, some missing or
    invisible, visibility in {0, 2}."""
    kp_x = rs.uniform(-0.3, 1.3, (b, k)).astype(np.float32)
    kp_y = rs.uniform(-0.3, 1.3, (b, k)).astype(np.float32)
    kp_x[rs.rand(b, k) < 0.1] = -1.0
    vis = (rs.rand(b, k) > 0.2).astype(np.float32) * 2.0
    return kp_x, kp_y, vis


# -- heatmaps and their decode ------------------------------------------------

def test_render_gaussian_heatmaps_match_jax():
    rs = np.random.RandomState(0)
    kp_x, kp_y, vis = _keypoints(rs, 3, 16)
    # rounding half to even: 2.5 -> 2 and 3.5 -> 4 cells, as jnp.round
    kp_x[0, :2] = [2.5 / 16, 3.5 / 16]
    kp_y[0, :2] = [0.5, 0.5]
    vis[0, :2] = 2.0
    # patches at the edges: wholly off (centre 4 cells past), just on
    kp_x[1, :3] = [-4 / 16, 19 / 16, 18 / 16]
    kp_y[1, :3] = [0.5, 0.5, 0.5]
    vis[1, :3] = 2.0
    want = jax.vmap(lambda x, y, v: jax_heatmap.render_gaussian_heatmaps(
        x, y, v, 12, 16))(kp_x, kp_y, vis)
    got = heatmap.render_gaussian_heatmaps(*map(torch.from_numpy,
                                                (kp_x, kp_y, vis)), 12, 16)
    assert got.shape == (3, 12, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    peak = got[0, 6, :, 0:2].argmax(dim=0).tolist()
    assert peak == [2, 4]
    assert got[1, ..., 0].abs().sum() == 0 and got[1, ..., 1].abs().sum() == 0
    assert got[1, ..., 2].abs().sum() > 0


def test_decode_keypoints_exact_with_ties():
    """Heads on a coarse grid of values: several cells share the maximum,
    the first one (in row-major order) wins in both packages."""
    rs = np.random.RandomState(1)
    hm = rs.randint(0, 4, (2, 3, 8, 8, 5)).astype(np.float32) / 2
    hm[0, 0, :, :, 0] = 1.0                         # every cell tied
    want = jax_heatmap.decode_keypoints(jnp.asarray(hm))
    got = heatmap.decode_keypoints(torch.from_numpy(hm))
    for g, w in zip(got, want):
        assert g.shape == (2, 3, 5)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0][0, 0, 0]) == 0.0 and float(got[1][0, 0, 0]) == 0.0


def test_weighted_mse_loss_matches_jax():
    rs = np.random.RandomState(2)
    labels = np.asarray(jax.vmap(
        lambda x, y, v: jax_heatmap.render_gaussian_heatmaps(x, y, v, 8, 8))(
            *_keypoints(rs, 2, 4)))
    outs = [rs.randn(2, 8, 8, 4).astype(np.float32) for _ in range(3)]
    want = float(jax_pose.weighted_mse_loss(jnp.asarray(labels),
                                            [jnp.asarray(o) for o in outs]))
    got = float(pose.weighted_mse_loss(torch.from_numpy(labels),
                                       [torch.from_numpy(o) for o in outs]))
    assert got == pytest.approx(want, rel=1e-6)
    assert pose.FOREGROUND_WEIGHT == jax_pose.FOREGROUND_WEIGHT


def test_synthetic_and_calibration_batches_are_the_jax_ones(tmp_path):
    for w, g in zip(jax_pose_data.synthetic_batches(batch_size=3,
                                                    image_size=16, steps=2,
                                                    seed=4),
                    pose_data.synthetic_batches(batch_size=3, image_size=16,
                                                steps=2, seed=4)):
        for a, b in zip(w, g):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    assert pose_data.NUM_JOINTS == jax_pose_data.NUM_JOINTS
    cfg = get_config("hourglass104")
    trainer = pose.PoseTrainer(cfg.replace(model_kwargs=TINY), device="cpu",
                               workdir=str(tmp_path))
    got = trainer._calibration_batch((SIZE, SIZE, 3), 3, seed=5)
    want = jax_pose.PoseTrainer._calibration_batch(
        type("T", (), {"config": jax_get_config("hourglass104"),
                       "_calibration_batch_size": lambda self: 3})(),
        (SIZE, SIZE, 3), seed=5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_mpii_tfrecords_raise_a_named_error(tmp_path):
    """Once refused by name, the MPII records now feed the pose CLI: its
    val batches are the JAX CLI's record for record (one shard), the
    keypoints equal, the pixels within the decode gap (PIL against
    TensorFlow's default IDCT, 7 levels, through the bilinear resize),
    and `--device-normalize` ships uint8; synthetic data refuses it."""
    import tensorflow as tf
    from torch_records_fixtures import write_mpii

    from deepvision_tpu import cli as jax_cli
    tf.config.set_visible_devices([], "GPU")
    data_dir = write_mpii(str(tmp_path), splits=(("train", 4),
                                                  ("val", 4)))
    argv = ["-m", "hourglass104", "--device", "cpu", "--data-dir",
            data_dir, "--batch-size", "2", "--image-size", "32"]
    parser = cli.build_parser("Hourglass", ["hourglass104"])
    args = parser.parse_args(argv)
    cfg = cli._config_from_args(args, 64)
    train_fn, val_fn = cli._pose_data(cfg, args)
    jcfg = jax_get_config("hourglass104")
    jcfg = jcfg.replace(batch_size=2, data=dataclasses.replace(
        jcfg.data, image_size=32))
    _, jval = jax_cli._pose_data(jcfg, args)
    got, want = list(val_fn(0)), list(jval(0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert float(np.abs(g[0].numpy() - w[0]).max()) <= 7 / 127.5
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    assert len(list(train_fn(1))) == 2
    args = parser.parse_args(argv + ["--device-normalize"])
    _, val_fn = cli._pose_data(cli._config_from_args(args, 64), args)
    assert next(iter(val_fn(0)))[0].dtype == torch.uint8
    args = parser.parse_args(argv + ["--device-normalize", "--synthetic"])
    with pytest.raises(SystemExit, match="synthetic"):
        cli._pose_data(cli._config_from_args(args, 64), args)


# -- the model ----------------------------------------------------------------

def _images(n=2, seed=1, size=SIZE):
    return (np.random.RandomState(seed).rand(n, size, size, 3)
            .astype(np.float32) * 2 - 1)


def _port_model(params, stats, dtype=torch.float32):
    model = StackedHourglass(**TINY, dtype=dtype)
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_flax(dtype):
    x = _images()
    jax_model = JaxHourglass(**TINY, dtype=getattr(jnp, dtype))
    params, stats = flax_yolo_variables(jax_model, x, seed=2)
    apply = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))
    want = apply({"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = _port_model(params, stats, getattr(torch, dtype)).eval()(
            torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and g.shape == (2, HM, HM, 4)
        err = np.abs(g.numpy() - w).max()
        assert err <= BOUND[dtype] * max(1.0, np.abs(w).max()), err


def _tiny_pose_config(cfg):
    """hourglass104's recipe (adam 1e-3, plateau) at f32 on the tiny model,
    logging every step."""
    return cfg.replace(dtype="float32", log_every_steps=1,
                       model_kwargs=TINY_KW)


def _pose_batches(steps, seed):
    return jax_pose_data.synthetic_batches(batch_size=2, image_size=SIZE,
                                           steps=steps, seed=seed)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX PoseTrainer of the tiny f32 config on one device (batch 2,
    32 px, 16 joints), its initial variables, and its compiled train step
    run once on numpy-filled weights (the port's weights are the same)."""
    torch.set_num_threads(1)
    jcfg = _tiny_pose_config(jax_get_config("hourglass104"))
    jcfg = jcfg.replace(batch_size=2, total_epochs=1, data=dataclasses.replace(
        jcfg.data, dataset="synthetic", image_size=SIZE, train_examples=4))
    trainer = jax_pose.PoseTrainer(
        jcfg, mesh=jax_mesh.make_mesh(jax.devices()[:1]),
        workdir=str(tmp_path_factory.mktemp("jax")))
    trainer.init_state((SIZE, SIZE, 3))
    init = jax.device_get({"params": trainer.state.params,
                           "batch_stats": trainer.state.batch_stats})
    batch = next(_pose_batches(1, 1))
    params, stats = flax_yolo_variables(trainer.model, batch[0], seed=0)
    # placed as the trainer's own state (a copy: the step donates it), so
    # the trainer's epoch reuses the step compiled here
    filled = jax.device_put(jax.device_get(trainer.state.replace(
        params=params, batch_stats=stats, opt_state=trainer.tx.init(params))),
        jax.tree_util.tree_map(lambda a: a.sharding, trainer.state))
    staged = jax_prefetch.prefetch_to_device(trainer.mesh, iter([batch]), 1)
    new, metrics = trainer.train_step(filled, *next(iter(staged)),
                                      jax.random.fold_in(trainer.rng, 1))
    staged.close()
    adam = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    assert len(adam) == 1
    step = {"loss": float(metrics["loss"]),
            "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                            jax.device_get(adam[0].mu)),
            "params": jax.device_get(new.params),
            "batch_stats": jax.device_get(new.batch_stats)}
    return {"trainer": trainer, "init": init, "batch": batch,
            "filled": (params, stats), "step": step}


@pytest.fixture(scope="module")
def one_step(jax_trainer, tmp_path_factory):
    """The port's PoseTrainer (the same config) one step on the same
    weights and batch, and the same step's gradients in f64."""
    cfg = _tiny_pose_config(get_config("hourglass104"))
    cfg = cfg.replace(batch_size=2, data=dataclasses.replace(
        cfg.data, image_size=SIZE))
    trainer = pose.PoseTrainer(cfg, device="cpu",
                               workdir=str(tmp_path_factory.mktemp("port")))
    params, stats = jax_trainer["filled"]
    model = trainer.model
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    state = trainer.init_state()
    batch = jax_trainer["batch"]
    f64 = float64_copy(model)
    got = trainer.train_step(state, *map(torch.from_numpy, batch))
    trainer.close()
    labels = heatmap.render_gaussian_heatmaps(
        *map(torch.from_numpy, batch[1:]), HM, HM)
    pose.weighted_mse_loss(labels, f64.train()(
        torch.from_numpy(batch[0]).double())).backward()
    return {"want": jax_trainer["step"], "model": model,
            "loss": float(got["loss"]), "state": state,
            "zero": zero_gradient_leaves(f64)}


def float64_copy(model):
    """A copy of `model` that computes in f64 throughout."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    return m


def zero_gradient_leaves(f64) -> set:
    """Names of the parameters of `f64`, after an f64 backward, whose
    gradient is zero up to f64 rounding (1e-9 of the model's largest)."""
    grads = {n: p.grad.abs().max().item() for n, p in f64.named_parameters()}
    top = max(grads.values())
    return {n for n, g in grads.items() if g <= 1e-9 * top}


def check_gradients(model, want_grads, zero: set) -> None:
    """Each gradient within 1e-3 of its leaf's largest; a leaf whose exact
    gradient is zero within 1e-3 of the model's largest."""
    named = dict(model.named_parameters())
    assert set(named) == {k for k in want_grads if "running" not in k}
    top = max(want_grads[n].abs().max().item() for n in named)
    assert zero and all(n.endswith(".bias") for n in zero), zero
    for name, p in named.items():
        scale = top if name in zero else want_grads[name].abs().max().item()
        err = (p.grad - want_grads[name]).abs().max().item()
        assert err <= 1e-3 * scale, (name, err, scale)


def test_one_train_step_matches_jax(one_step):
    want, model = one_step["want"], one_step["model"]
    assert one_step["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert one_step["state"].step == 1
    check_gradients(model, params_to_state_dict(
        want["grads"], model, want["batch_stats"]), one_step["zero"])
    stats = params_to_state_dict(want["params"], model, want["batch_stats"])
    sd = model.state_dict()
    running = [k for k in stats if "running" in k]
    assert len(running) == 2 * sum(1 for k in sd if k.endswith("running_var"))
    for k in running:
        torch.testing.assert_close(sd[k], stats[k], rtol=5e-5, atol=5e-5)


# -- PCKh ---------------------------------------------------------------------

def test_pose_evaluator_summaries_equal_jax():
    rs = np.random.RandomState(6)
    want = jax_eval_pose.PoseEvaluator(thresholds=(0.5, 0.2))
    got = eval_pose.PoseEvaluator(thresholds=(0.5, 0.2))
    for _ in range(3):
        gt_x, gt_y, vis = _keypoints(rs, 5, 16)
        vis[0, 9] = 0.0                  # a person without a head: skipped
        px = gt_x + rs.randn(5, 16).astype(np.float32) * 0.05
        py = gt_y + rs.randn(5, 16).astype(np.float32) * 0.05
        for ev in (want, got):
            ev.add_batch(px, py, gt_x, gt_y, vis, aspect=1.25)
    assert got.summarize() == want.summarize()
    assert eval_pose.MPII_JOINT_NAMES == jax_eval_pose.MPII_JOINT_NAMES


def test_evaluate_pckh_equals_jax():
    """On the 16 MPII joints (PCKh needs the head pair, joints 8 and 9)."""
    batches = list(jax_pose_data.synthetic_batches(
        batch_size=3, image_size=SIZE, steps=2, seed=7))
    jax_model = JaxHourglass(**TINY_KW, num_heatmap=16, dtype=jnp.float32)
    params, stats = flax_yolo_variables(jax_model, batches[0][0], seed=8)
    apply = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))
    jax_state = type("S", (), {"params": params, "batch_stats": stats,
                               "apply_fn": staticmethod(
                                   lambda v, x, train: apply(v, x))})()
    want = jax_eval_pose.evaluate_pckh(jax_state, batches,
                                       thresholds=(0.5, 1.0))
    model = StackedHourglass(**TINY_KW, num_heatmap=16, dtype=torch.float32)
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    state = TrainState(model, torch.optim.SGD([torch.zeros(1)], lr=0.0))
    got = eval_pose.evaluate_pckh(state, batches, thresholds=(0.5, 1.0))
    assert got == want and "PCKh@0.5" in got


# -- the trainer through the entry point -------------------------------------

def _train_losses(path):
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    return ([r["train_loss"] for r in rows if "train_loss" in r],
            [r["val_loss"] for r in rows if "val_loss" in r])


def test_trainer_steps_through_run_pose_match_the_jax_trainer(
        jax_trainer, tmp_path, monkeypatch):
    """2 steps (batch 2, 32 px, f32) and 2 validation batches through
    `cli.run_pose --device cpu`, from the JAX trainer's initial weights:
    each step's logged loss equals the JAX trainer's (its epoch 1 on the
    same synthetic stream)."""
    jtrainer, init = jax_trainer["trainer"], jax_trainer["init"]
    jtrainer.train_epoch(1, _pose_batches(2, 1))
    jtrainer.close()

    class FromJax(pose.PoseTrainer):
        def init_state(self):
            self.model.load_state_dict(params_to_state_dict(
                init["params"], self.model, init["batch_stats"]),
                strict=False)
            return super().init_state()

    monkeypatch.setattr(pose, "PoseTrainer", FromJax)
    monkeypatch.setattr(cli, "get_config",
                        lambda name: _tiny_pose_config(get_config(name)))
    trainer, result = cli.run_pose("Hourglass", ["hourglass104"], [
        "-m", "hourglass104", "--synthetic", "--device", "cpu",
        "--image-size", str(SIZE), "--batch-size", "2",
        "--steps-per-epoch", "2", "--epochs", "1",
        "--workdir", str(tmp_path / "port")])
    assert trainer.state.step == 2
    want = _train_losses(os.path.join(jtrainer.workdir, "hourglass104.jsonl"))
    got = _train_losses(tmp_path / "port" / "hourglass104.jsonl")
    assert len(got[0]) == len(want[0]) == 2 and len(got[1]) == 1
    assert not want[1]
    for g, w in zip(got[0], want[0]):
        assert g == pytest.approx(w, rel=1e-4)
    assert np.isfinite(result["loss"]) and result["count"] == 2


def test_entry_points_train_evaluate_and_infer(tmp_path, monkeypatch,
                                               capsys):
    """Hourglass/torch/train.py on a workdir pinning the tiny model (one
    step, then validation), evaluate.py --synthetic on it (PCKh lines),
    and infer.py on the committed images with its checkpoint: 16 joint
    lines an image in [0, 1], and a skeleton overlay an image."""
    (tmp_path / "model_kwargs.json").write_text(json.dumps(TINY_KW))
    monkeypatch.setattr(sys, "argv", [
        "train.py", "-m", "hourglass104", "--synthetic", "--device", "cpu",
        "--image-size", str(SIZE), "--batch-size", "2",
        "--steps-per-epoch", "1", "--epochs", "1", "--workdir",
        str(tmp_path)])
    runpy.run_path(os.path.join(REPO, "Hourglass", "torch", "train.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "val_loss=" in out and "done: best=" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "metrics.json"]
    assert os.path.exists(tmp_path / "ckpt" / "1" / "integrity_manifest.json")

    script = lambda name: runpy.run_path(  # noqa: E731
        os.path.join(REPO, "Hourglass", "torch", name), run_name="not_main")
    metrics = script("evaluate.py")["main"](
        ["--synthetic", "--device", "cpu", "--workdir", str(tmp_path),
         "--thresholds", "0.5,1.0"])
    out = capsys.readouterr().out
    assert "PCKh@0.5: " in out and "PCKh@1: " in out
    assert "applying pinned model kwargs" in out
    assert 0 <= metrics["PCKh@0.5"] <= metrics["PCKh@1"] <= 1

    images = [os.path.join(REPO, "tests", "data", "detect", f"img{i}.png")
              for i in range(2)]
    script("infer.py")["main"]([
        "--workdir", str(tmp_path), "--image-size", str(SIZE), "--device",
        "cpu", "--out-dir", str(tmp_path / "poses"), *images])
    lines = capsys.readouterr().out.splitlines()
    assert "resumed from epoch 1" in "\n".join(lines)
    joints = [ln for ln in lines if ln.startswith("  ") and " x=" in ln]
    assert len(joints) == 32 and [ln for ln in lines if ln.endswith(
        ".png:")] == [f"{p}:" for p in images]
    for ln in joints:
        x = float(ln.split(" x=")[1].split()[0])
        y = float(ln.split(" y=")[1].split()[0])
        assert 0 <= x < 1 and 0 <= y < 1
    assert sorted(os.listdir(tmp_path / "poses")) == ["img0_pose.png",
                                                     "img1_pose.png"]
