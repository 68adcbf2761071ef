"""The port's CenterNet family (deepvision_tpu_torch/{ops,models,core}/
centernet.py, cli.run_centernet, ObjectsAsPoints/torch/) against the JAX
package on the CPU.

The same numpy inputs and weights (seeded) go through both. Weights are
Flax variables of the shapes `ObjectsAsPoints.init` gives, filled from
numpy (tests/test_torch_yolo.py::flax_yolo_variables) and carried over by
the weight bridge. The tiny model is `ObjectsAsPoints(num_classes=3,
num_stack=2, order=2, width_mult=1/16)` at 32 px (an 8x8 grid), and
centernet_digits' own model at 64 px.

Bounds:
- targets: 1e-6, their masks exact, including a shared centre cell (the
  last valid box writes), a centre at exactly 1.0 (dropped), a negative
  centre (wraps) and classes out of range;
- focal, masked L1 and centernet losses: 1e-6 relative (sums over the
  grid in another order);
- decode: picks exact, scores 1e-6, on heads of a few coarse values
  (equal logits give equal sigmoids in both packages, so the peak test and
  every tie, zeros included, are decided alike); fewer peaks than K;
- f32 eval forward: 1e-5 of each output's largest value (measured 2.8e-6);
- bf16 eval forward: 5e-2, tests/test_torch_yolo.py's bound for a
  BatchNorm net (measured 2.6e-2);
- one f32 train step: loss components 1e-4 relative, gradients 1e-3 of
  each leaf's largest (the zero-gradient biases of convs feeding a
  train-mode BatchNorm, 1e-3 of the model's largest:
  tests/test_torch_pose.py), batch_stats 5e-5 (as there);
- evaluate_map: summaries within 1e-6, on ground truth taken from the
  model's own top detections, so the mAP is not trivially 0;
- two trainer steps from the JAX trainer's initial weights: the logged
  losses 1e-4 relative (the validation loss is not compared: see
  tests/test_torch_pose.py).
"""

import dataclasses
import json
import math
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core import centernet as jax_core
from deepvision_tpu.core.detection import \
    boxes_calibration_batch as jax_calibration_batch
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.data.detection import \
    synthetic_batches as jax_synthetic_batches
from deepvision_tpu.models.centernet import ObjectsAsPoints as JaxCenterNet
from deepvision_tpu.models.hourglass import StackedHourglass as JaxHourglass
from deepvision_tpu.ops import centernet as jax_ops
from deepvision_tpu.parallel import mesh as jax_mesh
from deepvision_tpu.parallel import prefetch as jax_prefetch
from deepvision_tpu_torch import cli
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import centernet as core
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.models.centernet import ObjectsAsPoints
from deepvision_tpu_torch.models.hourglass import StackedHourglass
from deepvision_tpu_torch.ops import centernet as ops
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_pose import check_gradients, float64_copy, \
    zero_gradient_leaves
from test_torch_yolo import flax_yolo_variables

# The port's step updates its state in place and donates nothing; jaxlint
# resolves `make_centernet_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "tests", "data", "detect")
TINY_KW = dict(num_stack=2, order=2, width_mult=1 / 16)
TINY = dict(TINY_KW, num_classes=3)
SIZE, GRID = 32, 8
BOUND = {"float32": 1e-5, "bfloat16": 5e-2}
jax_encode = jax.jit(jax_ops.encode_labels, static_argnums=(3, 4))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _boxes(rs, b, n):
    xy1 = rs.uniform(-0.05, 0.8, (b, n, 2))
    wh = rs.uniform(0.02, 0.4, (b, n, 2))
    return np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)


def _encode_both(boxes, classes, valid, grid=GRID, num_classes=3):
    want = jax_encode(jnp.asarray(boxes), jnp.asarray(classes),
                      jnp.asarray(valid), grid, num_classes)
    got = ops.encode_labels(torch.from_numpy(boxes),
                            torch.from_numpy(classes),
                            torch.from_numpy(valid), grid, num_classes)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _same_targets(want, got):
    assert set(got) == set(want) == {"heatmap", "size", "offset", "mask"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k == "mask":
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


# -- targets, losses, decode ---------------------------------------------------

def test_gaussian_radius_matches_jax():
    rs = np.random.RandomState(0)
    h, w = (rs.uniform(0, 40, 200).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_ops.gaussian_radius(jnp.asarray(h), jnp.asarray(w)))
    got = ops.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_encode_labels_match_jax_on_random_boxes():
    rs = np.random.RandomState(1)
    boxes = _boxes(rs, 3, 100)
    classes = rs.randint(0, 3, (3, 100)).astype(np.int32)
    valid = (rs.rand(3, 100) < 0.2).astype(np.float32)
    want, got = _encode_both(boxes, classes, valid)
    _same_targets(want, got)
    assert want["mask"].sum() > 20
    one = jax_ops.encode_labels_one(*(jnp.asarray(a[1]) for a in (
        boxes, classes, valid)), GRID, 3)
    _same_targets({k: np.asarray(v) for k, v in one.items()},
                  {k: v.numpy() for k, v in ops.encode_labels_one(
                      *(torch.from_numpy(a[1]) for a in (
                          boxes, classes, valid)), GRID, 3).items()})


def test_encode_labels_shared_cell_edges_and_classes_match_jax():
    """Boxes 0, 1 and 3 share a centre cell, box 2 (invalid) too: box 3,
    the last valid one, writes size and offset. Box 4's centre is exactly
    1.0 (cell 8: dropped); box 5's is negative (cell -1 wraps to 7); box
    6's class is -1 (wraps to 2), box 7's is 3 (out of range: no heatmap
    splat, but its cell is written)."""
    boxes = np.zeros((1, 10, 4), np.float32)
    boxes[0, 0] = [0.30, 0.30, 0.40, 0.42]
    boxes[0, 1] = [0.31, 0.33, 0.39, 0.45]
    boxes[0, 2] = [0.32, 0.31, 0.38, 0.40]
    boxes[0, 3] = [0.29, 0.32, 0.41, 0.41]
    boxes[0, 4] = [0.90, 0.90, 1.10, 1.10]
    boxes[0, 5] = [-0.20, 0.50, 0.06, 0.70]
    boxes[0, 6] = [0.60, 0.10, 0.80, 0.20]
    boxes[0, 7] = [0.10, 0.60, 0.20, 0.90]
    classes = np.array([[0, 1, 2, 1, 0, 2, -1, 3, 0, 0]], np.int32)
    valid = np.array([[1, 1, 0, 1, 1, 1, 1, 1, 0, 0]], np.float32)
    want, got = _encode_both(boxes, classes, valid)
    _same_targets(want, got)
    cell = (0.35 * GRID, 0.365 * GRID)          # boxes 0-3: cell (2, 2)
    assert got["mask"][0, int(cell[1]), int(cell[0])] == 1.0
    np.testing.assert_allclose(got["size"][0, 2, 2], [0.12 * GRID,
                                                      0.09 * GRID], rtol=1e-5)
    assert got["mask"][0, 4:, 0].sum() == 0 and got["mask"][0, 4, 7] == 1.0
    assert got["mask"].sum() == 5               # boxes 4 dropped, 0-3 one
    assert got["heatmap"][0, 1, 5, 2] == 1.0    # box 6 in class 2
    assert got["heatmap"][0, 6, 1].max() < 1.0  # box 7: no class channel


def test_losses_match_jax():
    rs = np.random.RandomState(2)
    boxes = _boxes(rs, 2, 100)
    classes = rs.randint(0, 3, (2, 100)).astype(np.int32)
    valid = np.zeros((2, 100), np.float32)
    valid[:, :6] = 1.0
    targets, _ = _encode_both(boxes, classes, valid)
    outputs = [{"heatmap": rs.randn(2, GRID, GRID, 3).astype(np.float32) * 2,
                "size": rs.randn(2, GRID, GRID, 2).astype(np.float32),
                "offset": rs.randn(2, GRID, GRID, 2).astype(np.float32)}
               for _ in range(2)]
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    jo = [{k: jnp.asarray(v) for k, v in o.items()} for o in outputs]
    to = [{k: torch.from_numpy(v) for k, v in o.items()} for o in outputs]
    pairs = [
        (jax_ops.focal_loss(jo[0]["heatmap"], jt["heatmap"]),
         ops.focal_loss(to[0]["heatmap"], tt["heatmap"])),
        (jax_ops.masked_l1_loss(jo[0]["size"], jt["size"], jt["mask"]),
         ops.masked_l1_loss(to[0]["size"], tt["size"], tt["mask"]))]
    want = jax_ops.centernet_loss(jo, jt)
    got = ops.centernet_loss(to, tt)
    assert set(got) == set(want) == {"heatmap", "size", "offset", "total"}
    pairs += [(want[k], got[k]) for k in want]
    for w, g in pairs:
        assert g.shape == (2,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert (ops.SIZE_LOSS_WEIGHT, ops.OFFSET_LOSS_WEIGHT) == (
        jax_ops.SIZE_LOSS_WEIGHT, jax_ops.OFFSET_LOSS_WEIGHT)


def _coarse_heads(rs, b, g, c, values=(-6.0, -2.0, 0.0, 1.0, 3.0)):
    return {"heatmap": rs.choice(values, (b, g, g, c)).astype(np.float32),
            "size": rs.uniform(0, 4, (b, g, g, 2)).astype(np.float32),
            "offset": rs.uniform(0, 1, (b, g, g, 2)).astype(np.float32)}


@pytest.mark.parametrize("g,c,k", [(8, 3, 100), (4, 2, 20), (6, 5, 7)])
def test_decode_picks_equal_jax_with_ties(g, c, k):
    """Heads of five logit values: plateaus of equal peaks, fewer peaks
    than K (g=8, c=3: the tail is 0-score ties in index order), and more
    (g=6, c=5, K=7)."""
    head = _coarse_heads(np.random.RandomState(g * c), 3, g, c)
    head["heatmap"][0] = 1.0                     # one image a flat plateau
    want = jax_ops.decode({k2: jnp.asarray(v) for k2, v in head.items()},
                          max_detections=k)
    got = ops.decode({k2: torch.from_numpy(v) for k2, v in head.items()},
                     max_detections=k)
    boxes, scores, classes = (np.asarray(w) for w in want)
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), classes)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0].numpy(), boxes, rtol=1e-6, atol=1e-6)
    if k > g * g * c // 4:
        assert (scores == 0).any()               # ties past the last peak


def test_top_k_breaks_ties_by_the_lower_index():
    scores = torch.tensor([[0.0, 1.0, 0.0, 1.0, 0.0]])
    values, idx = ops.top_k_lowest_index(scores, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert idx.tolist() == np.asarray(
        jax.lax.top_k(jnp.asarray(scores.numpy()), 4)[1]).tolist()


# -- the model ----------------------------------------------------------------

def _images(n=2, seed=1, size=SIZE):
    return (np.random.RandomState(seed).rand(n, size, size, 3)
            .astype(np.float32) * 2 - 1)


def _port_model(kw, params, stats, dtype=torch.float32):
    model = ObjectsAsPoints(**kw, dtype=dtype)
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    return model


@pytest.mark.parametrize("which", ["tiny", "centernet_digits"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_flax(which, dtype):
    if which == "tiny":
        kw, size = TINY, SIZE
    else:
        cfg = get_config("centernet_digits")
        kw = dict(cfg.model_kwargs, num_classes=cfg.data.num_classes)
        size = cfg.data.image_size
    x = _images(size=size)
    jax_model = JaxCenterNet(**kw, dtype=getattr(jnp, dtype))
    params, stats = flax_yolo_variables(jax_model, x, seed=3)
    apply = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))
    want = apply({"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = _port_model(kw, params, stats, getattr(torch, dtype)).eval()(
            torch.from_numpy(x))
    assert len(got) == len(want) == kw["num_stack"]
    for gs, ws in zip(got, want):
        assert list(gs) == ["heatmap", "size", "offset"]
        for key, w in ws.items():
            w = np.asarray(w, np.float32)
            g = gs[key]
            assert g.dtype == torch.float32 and g.shape == w.shape
            err = np.abs(g.numpy() - w).max()
            assert err <= BOUND[dtype] * max(1.0, np.abs(w).max()), (key,
                                                                      err)


def test_heatmap_bias_starts_at_the_focal_prior():
    model = ObjectsAsPoints(**TINY)
    for stack in range(2):
        head = getattr(model, f"head_{stack}")
        assert (head.heatmap_conv2.bias == -2.19).all()
        assert (head.size_conv2.bias == 0).all()


@pytest.mark.parametrize("name", ["centernet", "hourglass104"])
def test_full_size_variables_carry_over_leaf_for_leaf(name):
    """The full-size JAX trees (jax.eval_shape, every leaf filled from
    numpy with its own index, as zero-stride views) carried onto the
    port's module built on the meta device: every leaf lands on the name
    whose value identifies it."""
    jax_model = JaxCenterNet() if name == "centernet" else JaxHourglass()
    with torch.device("meta"):
        model = ObjectsAsPoints() if name == "centernet" else \
            StackedHourglass()
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), train=True))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    filled = jax.tree_util.tree_unflatten(treedef, [
        np.broadcast_to(np.float32(i), leaf.shape)
        for i, leaf in enumerate(leaves)])
    sd = params_to_state_dict(filled["params"], model,
                              filled["batch_stats"])
    assert len(sd) == len(leaves)
    assert sorted(float(v.reshape(-1)[0]) for v in sd.values()) == \
        list(range(len(leaves)))
    count = sum(v.numel() for k, v in sd.items() if "running" not in k)
    assert count == sum(p.numel() for p in model.parameters())


# -- one train step through the trainers -------------------------------------

def _tiny_config(cfg):
    """centernet's recipe (adam 1.25e-4, step schedule) at f32 on the tiny
    model, logging every step."""
    return cfg.replace(dtype="float32", log_every_steps=1,
                       model_kwargs=TINY_KW)


def _batches(steps, seed):
    return jax_synthetic_batches(batch_size=2, image_size=SIZE,
                                 num_classes=80, steps=steps, seed=seed)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX CenterNetTrainer of the tiny f32 config on one device (batch
    2, 32 px, 80 classes), its initial variables, and its compiled train
    step run once on numpy-filled weights."""
    torch.set_num_threads(1)
    jcfg = _tiny_config(jax_get_config("centernet"))
    jcfg = jcfg.replace(batch_size=2, total_epochs=1, data=dataclasses.replace(
        jcfg.data, dataset="synthetic", image_size=SIZE, train_examples=4))
    trainer = jax_core.CenterNetTrainer(
        jcfg, mesh=jax_mesh.make_mesh(jax.devices()[:1]),
        workdir=str(tmp_path_factory.mktemp("jax")))
    trainer.init_state((SIZE, SIZE, 3))
    init = jax.device_get({"params": trainer.state.params,
                           "batch_stats": trainer.state.batch_stats})
    batch = next(_batches(1, 1))
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
    step = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                            jax.device_get(adam[0].mu)),
            "params": jax.device_get(new.params),
            "batch_stats": jax.device_get(new.batch_stats)}
    return {"trainer": trainer, "init": init, "batch": batch,
            "filled": (params, stats), "step": step}


def test_one_train_step_matches_jax(jax_trainer, tmp_path):
    cfg = _tiny_config(get_config("centernet"))
    cfg = cfg.replace(batch_size=2, data=dataclasses.replace(
        cfg.data, image_size=SIZE))
    trainer = core.CenterNetTrainer(cfg, device="cpu", workdir=str(tmp_path))
    params, stats = jax_trainer["filled"]
    model = trainer.model
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    state = trainer.init_state()
    batch = tuple(map(torch.from_numpy, jax_trainer["batch"]))
    f64 = float64_copy(model)
    got = {k: float(v) for k, v in trainer.train_step(state, *batch).items()}
    trainer.close()
    targets = ops.encode_labels(*batch[1:], GRID, 80)
    ops.centernet_loss(f64.train()(batch[0].double()),
                       targets)["total"].mean().backward()

    want = jax_trainer["step"]
    assert set(got) == set(want["metrics"]) == {
        "loss", "heatmap_loss", "size_loss", "offset_loss"}
    for k, v in want["metrics"].items():
        assert got[k] == pytest.approx(v, rel=1e-4), k
    check_gradients(model, params_to_state_dict(
        want["grads"], model, want["batch_stats"]), zero_gradient_leaves(f64))
    ref = params_to_state_dict(want["params"], model, want["batch_stats"])
    sd = model.state_dict()
    running = [k for k in ref if "running" in k]
    assert len(running) == 2 * sum(1 for k in sd if k.endswith("running_var"))
    for k in running:
        torch.testing.assert_close(sd[k], ref[k], rtol=5e-5, atol=5e-5)


def _train_losses(path):
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    return [r["train_loss"] for r in rows if "train_loss" in r]


def test_trainer_steps_through_run_centernet_match_the_jax_trainer(
        jax_trainer, tmp_path, monkeypatch):
    """2 steps (batch 2, 32 px, f32) and 2 validation batches through
    `cli.run_centernet --device cpu`, from the JAX trainer's initial
    weights: each step's logged loss equals the JAX trainer's (its epoch 1
    on the same synthetic stream)."""
    jtrainer, init = jax_trainer["trainer"], jax_trainer["init"]
    jtrainer.train_epoch(1, _batches(2, 1))
    jtrainer.close()

    class FromJax(core.CenterNetTrainer):
        def init_state(self):
            self.model.load_state_dict(params_to_state_dict(
                init["params"], self.model, init["batch_stats"]),
                strict=False)
            return super().init_state()

    monkeypatch.setattr(core, "CenterNetTrainer", FromJax)
    monkeypatch.setattr(cli, "get_config",
                        lambda name: _tiny_config(get_config(name)))
    trainer, result = cli.run_centernet("ObjectsAsPoints", ["centernet"], [
        "-m", "centernet", "--synthetic", "--device", "cpu",
        "--image-size", str(SIZE), "--batch-size", "2",
        "--steps-per-epoch", "2", "--epochs", "1",
        "--workdir", str(tmp_path / "port")])
    assert trainer.state.step == 2
    want = _train_losses(os.path.join(jtrainer.workdir, "centernet.jsonl"))
    got = _train_losses(tmp_path / "port" / "centernet.jsonl")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-4)
    assert math.isfinite(result["loss"]) and result["count"] == 2


def test_calibration_batch_is_the_jax_one(tmp_path):
    cfg = get_config("centernet").replace(model_kwargs=TINY_KW)
    trainer = core.CenterNetTrainer(cfg, device="cpu", workdir=str(tmp_path))
    got = trainer._calibration_batch((SIZE, SIZE, 3), 3, seed=4)
    want = jax_calibration_batch(jax_get_config("centernet"),
                                 (SIZE, SIZE, 3), 3, seed=4)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


# -- inference -----------------------------------------------------------------

def _jax_state(jax_model, params, stats):
    return JaxTrainState.create(jax_model.apply, params, optax.identity(),
                                stats)


def test_predict_step_and_evaluate_map_match_jax():
    """f32 on the tiny model: the predict step's picks equal JAX's, and
    evaluate_map (coco and voc) on ground truth made of the first JAX
    predictions of each image gives JAX's summaries."""
    kw = dict(batch_size=2, image_size=SIZE, num_classes=3, steps=2, seed=5)
    batches = list(jax_synthetic_batches(**kw))
    jax_model = JaxCenterNet(**TINY, dtype=jnp.float32)
    params, stats = flax_yolo_variables(jax_model, batches[0][0], seed=6)
    jstate = _jax_state(jax_model, params, stats)
    jpredict = jax_core.make_centernet_predict_step(compute_dtype=jnp.float32)
    state = TrainState(_port_model(TINY, params, stats),
                       torch.optim.SGD([torch.zeros(1)], lr=0.0))
    predict = core.make_centernet_predict_step(compute_dtype=torch.float32)
    for i, batch in enumerate(batches):
        want = [np.asarray(a) for a in jpredict(jstate,
                                                jnp.asarray(batch[0]))]
        got = [t.numpy() for t in predict(state, torch.from_numpy(batch[0]))]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
        gt_boxes, gt_classes, gt_valid = (np.array(a) for a in batch[1:])
        gt_boxes[:, :4], gt_classes[:, :4] = want[0][:, :4], want[2][:, :4]
        gt_boxes[:, 2] += 0.05                  # one near miss per image
        gt_valid[:] = 0.0
        gt_valid[:, :4] = 1.0
        batches[i] = (batch[0], gt_boxes, gt_classes, gt_valid)
    for metric in ("coco", "voc"):
        want = jax_core.evaluate_map(jstate, batches, num_classes=3,
                                     metric=metric,
                                     compute_dtype=jnp.float32)
        got = core.evaluate_map(state, batches, num_classes=3, metric=metric,
                                compute_dtype=torch.float32)
        assert set(got) == set(want) and 0 < got["mAP"] < 1
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (metric, k)


def test_predict_step_runs_on_the_ema_weights_in_inference_mode():
    model = ObjectsAsPoints(**TINY, dtype=torch.float32)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0),
                       ema_decay=0.5)
    state.ema = [torch.zeros_like(e) for e in state.ema]
    x = torch.from_numpy(_images())
    boxes, scores, classes = core.make_centernet_predict_step(
        compute_dtype=torch.float32)(state, x)
    # zero weights: every logit is 0, every score sigmoid(0), ties in
    # index order
    assert torch.all(scores == 0.5) and classes[0, :3].tolist() == [0, 1, 2]
    assert all(p.abs().sum() > 0 for p in model.parameters()
               if p.dim() == 4)
    assert not scores.requires_grad and scores.is_inference()


# -- the entry points ---------------------------------------------------------

def _script(name):
    return runpy.run_path(os.path.join(REPO, "ObjectsAsPoints", "torch",
                                       name), run_name="not_main")


def test_centernet_digits_trains_evaluates_and_detects(tmp_path, monkeypatch,
                                                       capsys):
    """A cut centernet_digits run on the digits_detect scenes through
    ObjectsAsPoints/torch/train.py (2 steps of 32, then the 128 validation
    scenes), evaluate.py on its workdir, and detect.py on the committed
    images."""
    workdir = str(tmp_path / "digits")
    monkeypatch.setattr(sys, "argv", [
        "train.py", "-m", "centernet_digits", "--device", "cpu",
        "--steps-per-epoch", "2", "--epochs", "1", "--workdir", workdir])
    runpy.run_path(os.path.join(REPO, "ObjectsAsPoints", "torch",
                                "train.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "epoch 1 step 2" in out and "val_loss=" in out
    assert sorted(os.listdir(os.path.join(workdir, "ckpt"))) == [
        "1", "metrics.json"]
    assert os.path.exists(os.path.join(workdir, "ckpt", "1",
                                       "integrity_manifest.json"))
    metrics = _script("evaluate.py")["main"](
        ["-m", "centernet_digits", "--device", "cpu", "--workdir", workdir,
         "--metric", "voc", "--max-batches", "1"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "mAP@0.5: " in out
    assert math.isfinite(metrics["mAP"])
    images = [os.path.join(DATA_DIR, f"img{i}.png") for i in range(2)]
    _script("detect.py")["main"](["-m", "centernet_digits", "--workdir",
                                  workdir, "--device", "cpu",
                                  "--score-thresh", "0.0", *images])
    lines = capsys.readouterr().out.splitlines()
    heads = [ln for ln in lines if ln.endswith(" detections")]
    assert [h.split(":")[0] for h in heads] == images
    assert heads[0].endswith(": 100 detections")
    assert sum(ln.startswith("  ") and " score=" in ln for ln in lines) == 200


def test_detection_lines_print_the_jax_format():
    detect = _script("detect.py")
    out = (torch.tensor([[[0.1, 0.2, 0.3, 0.4], [0.0, 0.0, 0.1, 0.1]]]),
           torch.tensor([[0.87654, 0.1]]),
           torch.tensor([[1, 0]], dtype=torch.int32))
    state = TrainState(ObjectsAsPoints(**TINY),
                       torch.optim.SGD([torch.zeros(1)], lr=0.0))
    lines = detect["detection_lines"](lambda s, x: out, state,
                                      np.zeros((8, 4, 4, 3), np.float32),
                                      ["a.png"], ["cat", "dog"], 0.3)
    assert lines == ["a.png: 1 detections",
                     "  dog score=0.877 box=(0.100,0.200,0.300,0.400)"]


def test_evaluate_cli_synthetic_and_the_refused_tfrecord_split(tmp_path,
                                                               capsys):
    out = str(tmp_path / "eval.json")
    (tmp_path / "wd").mkdir()
    (tmp_path / "wd" / "model_kwargs.json").write_text(json.dumps(TINY_KW))
    metrics = _script("evaluate.py")["main"](
        ["-m", "centernet", "--synthetic", "--device", "cpu",
         "--workdir", str(tmp_path / "wd"), "--out", out])
    with open(out) as fp:
        assert json.load(fp) == pytest.approx(metrics)
    assert math.isfinite(metrics["mAP"]) and "mAP: " in capsys.readouterr().out
    # the once refused VOC/COCO val split: the pinned tiny model on the
    # records, its ragged batch kept
    import tensorflow as tf
    from torch_records_fixtures import write_voc
    from deepvision_tpu_torch.data import jpeg
    tf.config.set_visible_devices([], "GPU")
    data_dir = write_voc(str(tmp_path / "voc"), splits=(("val", 3),))
    jpeg.zero_stats()
    metrics = _script("evaluate.py")["main"](
        ["-m", "centernet", "--device", "cpu", "--data-dir", data_dir,
         "--image-size", "64", "--workdir", str(tmp_path / "wd"),
         "--metric", "voc"])
    assert jpeg.images_decoded() == 3 and math.isfinite(metrics["mAP"])


@pytest.mark.parametrize("run,family,name", [
    ("run_centernet", "ObjectsAsPoints", "centernet"),
    ("run_pose", "Hourglass", "hourglass104")])
def test_entry_points_without_device_raise_on_a_host_without_a_card(
        tmp_path, run, family, name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(cli, run)(family, [name], ["-m", name, "--synthetic",
                                           "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)
