"""Port YOLO V3 inference (deepvision_tpu_torch/core/detection.py's
`predict_candidates`, `make_predict_step` and `evaluate_map`, the
digits_detect scenes, YOLO/torch/{detect,evaluate}.py) against the JAX
package on the CPU.

The tiny model is Darknet-53 at width 0.125 with stages (1, 1, 2, 2, 1),
2 classes, 64 px: 3 · (8² + 4² + 2²) = 252 candidate boxes. Its weights
are Flax variables filled from numpy and carried over by
utils/flax_convert.py.

Bounds:
- f32, before NMS: boxes, scores and per-class confidences within 1e-5
  (only the convolutions' summation order differs; measured 1.2e-7);
- bf16, before NMS: within 2e-3 (both round every conv output to bf16,
  in different summation orders; measured 5.5e-4 on these inputs);
- NMS on identical candidates: exact picks and counts (the picks' margins
  checked as in tests/test_torch_nms.py);
- after NMS on the two forwards: the top detections matched greedily by
  class and box proximity (tests/test_detect_golden.py's rule, as
  chip_smoke.py's `match_picks` holds the card to the CPU), each
  score and box within the pre-NMS bound of its dtype; the detect CLI's
  printed lines with test_detect_golden.py's tolerances (3 decimals).
- mAP summaries from the two forwards: within 1e-6 where the picks agree.
"""

import dataclasses
import functools
import json
import math
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu import cli as jax_cli
from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core.detection import evaluate_map as jax_evaluate_map
from deepvision_tpu.core.detection import \
    make_predict_step as jax_make_predict_step
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.data import digits as jax_digits
from deepvision_tpu.data.detection import \
    synthetic_batches as jax_synthetic_batches
from deepvision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deepvision_tpu.ops.boxes import xywh_to_x1y1x2y2 as jax_corners
from deepvision_tpu_torch import cli
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.detection import (DetectionTrainer,
                                                 evaluate_map,
                                                 make_predict_step,
                                                 predict_candidates)
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data import digits
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.models.yolo import YoloV3
from deepvision_tpu_torch.ops.nms import batched_nms
from deepvision_tpu_torch.parallel import mesh
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_nms import check_no_ties
from test_torch_yolo import flax_yolo_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import match_picks  # noqa: E402
DATA_DIR = os.path.join(REPO, "tests", "data", "detect")
TINY = dict(num_classes=2, width_mult=0.125, stage_blocks=(1, 1, 2, 2, 1))
SIZE = 64
BOUND = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
IOU, SCORE = 0.5, 0.05        # evaluate_map's NMS thresholds
DETECT_LINE = re.compile(
    r"^\s+(?P<name>.+) score=(?P<score>[0-9.]+) "
    r"box=\((?P<x1>-?[0-9.]+),(?P<y1>-?[0-9.]+),"
    r"(?P<x2>-?[0-9.]+),(?P<y2>-?[0-9.]+)\)$")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _images(n=4, seed=1):
    return (np.random.RandomState(seed).rand(n, SIZE, SIZE, 3)
            .astype(np.float32) * 2 - 1)


@functools.cache
def tiny(dtype: torch.dtype = torch.float32):
    """(JAX model, params, batch_stats) of the tiny yolov3 at `dtype`."""
    jm = JaxYoloV3(**TINY, dtype=JAX_DTYPE[dtype])
    params, stats = flax_yolo_variables(jm, _images())
    return jm, params, stats


def port_state(dtype: torch.dtype, params, stats,
               ema_decay=None) -> TrainState:
    model = YoloV3(**TINY, dtype=dtype)
    model.load_state_dict(params_to_state_dict(params, model, stats))
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0),
                      seed=0, ema_decay=ema_decay)


def jax_state(jm, params, stats):
    return JaxTrainState.create(jm.apply, params, optax.identity(), stats)


@functools.cache
def _jax_candidates_fn(jm, compute_dtype):
    """The JAX predict step's lines before `batched_nms`, jitted."""

    def candidates(variables, images):
        outputs = jm.apply(variables, images.astype(compute_dtype),
                           train=False, decode=True)
        b = images.shape[0]
        boxes = jnp.concatenate([o[0].reshape(b, -1, 4) for o in outputs], 1)
        obj = jnp.concatenate([o[1].reshape(b, -1) for o in outputs], 1)
        cls = jnp.concatenate([o[2].reshape(b, -1, o[2].shape[-1])
                               for o in outputs], 1)
        conf = obj[..., None].astype(jnp.float32) * cls.astype(jnp.float32)
        return (jax_corners(boxes.astype(jnp.float32)),
                jnp.max(conf, axis=-1), conf)

    return jax.jit(candidates)


def jax_candidates(dtype, x):
    jm, params, stats = tiny(dtype)
    out = _jax_candidates_fn(jm, JAX_DTYPE[dtype])(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    return [np.array(a) for a in out]


@functools.cache
def _jax_predict(compute_dtype, iou, score, max_det=100):
    return jax_make_predict_step(compute_dtype=compute_dtype,
                                 iou_thresh=iou, score_thresh=score,
                                 max_detection=max_det)


def port_candidates(dtype, x):
    _, params, stats = tiny(dtype)
    state = port_state(dtype, params, stats)
    with torch.inference_mode():
        out = predict_candidates(state.model.eval(), torch.from_numpy(x),
                                 dtype)
    return [t.numpy() for t in out]


# -- the predict step --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_candidates_before_nms_match_jax(dtype):
    x = _images()
    got, want = port_candidates(dtype, x), jax_candidates(dtype, x)
    assert [g.shape for g in got] == [(4, 252, 4), (4, 252), (4, 252, 2)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and w.dtype == np.float32
        assert np.abs(g - w).max() <= BOUND[dtype]


def test_nms_on_the_jax_candidates_gives_the_jax_predict_step():
    """The JAX step's own candidates through the port's NMS: exactly the
    JAX step's outputs."""
    x = _images()
    jm, params, stats = tiny()
    boxes, scores, conf = jax_candidates(torch.float32, x)
    check_no_ties(boxes, scores, IOU, SCORE)
    want = [np.asarray(a) for a in _jax_predict(jnp.float32, IOU, SCORE)(
        jax_state(jm, params, stats), jnp.asarray(x))]
    got = [t.numpy() for t in batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(conf), iou_thresh=IOU, score_thresh=SCORE,
        max_detection=100)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_predict_step_matches_jax(dtype):
    x = _images()
    jm, params, stats = tiny(dtype)
    want = [np.asarray(a) for a in _jax_predict(JAX_DTYPE[dtype], IOU,
                                               SCORE)(
        jax_state(jm, params, stats), jnp.asarray(x))]
    out = make_predict_step(compute_dtype=dtype, iou_thresh=IOU,
                            score_thresh=SCORE)(
        port_state(dtype, params, stats), torch.from_numpy(x))
    got = [t.numpy() for t in out]
    assert [g.shape for g in got] == [(4, 100, 4), (4, 100), (4, 100, 2),
                                      (4,)]
    assert got[3].dtype == np.int32 and (got[3] == want[3]).all()
    assert match_picks(got, want, 20, BOUND[dtype]) == 80


def test_casts_sit_where_the_jax_step_puts_them(monkeypatch):
    """The images reach the model at the compute dtype; the decoded heads
    come out f32 (the final convs run in f32, and decode in f32); the
    confidences are objectness x class probability in f32, ranked by
    their largest class, and the boxes corner-converted in f32."""
    _, params, stats = tiny(torch.bfloat16)
    model = port_state(torch.bfloat16, params, stats).model.eval()
    seen = {}
    forward = model.forward

    def spy(images, decode=None):
        seen["input"] = images.dtype
        seen["out"] = forward(images, decode=decode)
        return seen["out"]

    monkeypatch.setattr(model, "forward", spy)
    with torch.inference_mode():
        boxes, scores, conf = predict_candidates(
            model, torch.from_numpy(_images()), torch.bfloat16)
    assert seen["input"] == torch.bfloat16
    assert all(t.dtype == torch.float32 for o in seen["out"] for t in o)
    obj = torch.cat([o[1].reshape(4, -1) for o in seen["out"]], dim=1)
    cls = torch.cat([o[2].reshape(4, -1, 2) for o in seen["out"]], dim=1)
    xywh = torch.cat([o[0].reshape(4, -1, 4) for o in seen["out"]], dim=1)
    assert torch.equal(conf, obj[..., None] * cls)
    assert torch.equal(scores, conf.max(dim=-1).values)
    assert torch.equal(boxes, torch.cat([xywh[..., :2] - xywh[..., 2:] / 2,
                                         xywh[..., :2] + xywh[..., 2:] / 2],
                                        dim=-1))


def test_predict_step_runs_on_the_ema_weights_in_inference_mode():
    """With an EMA the step predicts with the EMA weights (and the
    current BatchNorm statistics), then puts the trained weights back."""
    x = torch.from_numpy(_images(2))
    _, params, stats = tiny()
    state = port_state(torch.float32, params, stats, ema_decay=0.9)
    state.ema = [0.5 * p.detach().clone() for p in state.model.parameters()]
    before = [p.detach().clone() for p in state.model.parameters()]
    step = make_predict_step(compute_dtype=torch.float32, score_thresh=SCORE)
    got = step(state, x)
    assert all(t.is_inference() for t in got)
    assert all(torch.equal(p, b) for p, b in
               zip(state.model.parameters(), before))
    halved = port_state(torch.float32, params, stats)
    with torch.no_grad():
        for p in halved.model.parameters():
            p.mul_(0.5)
    want = step(halved, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = step(port_state(torch.float32, params, stats), x)
    assert not torch.equal(plain[1], got[1])


def test_evaluate_map_matches_jax_over_two_synthetic_batches():
    jm, params, stats = tiny()
    kw = dict(batch_size=2, image_size=SIZE, num_classes=2, steps=2)
    for a, b in zip(synthetic_batches(**kw), jax_synthetic_batches(**kw)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    # the picks agree: the same detections from both forwards
    state = port_state(torch.float32, params, stats)
    jstate = jax_state(jm, params, stats)
    for batch in synthetic_batches(**kw):
        got = [t.numpy() for t in make_predict_step(
            compute_dtype=torch.float32, score_thresh=SCORE)(
            state, torch.from_numpy(batch[0]))]
        want = [np.asarray(a) for a in _jax_predict(jnp.float32, IOU, SCORE)(
            jstate, jnp.asarray(batch[0]))]
        assert (got[3] == want[3]).all()
        assert match_picks(got, want, 100,
                           BOUND[torch.float32]) == got[3].sum()
    for metric in ("coco", "voc"):
        got = evaluate_map(state, synthetic_batches(**kw), num_classes=2,
                           metric=metric, compute_dtype=torch.float32)
        want = jax_evaluate_map(jstate, jax_synthetic_batches(**kw),
                                num_classes=2, metric=metric,
                                compute_dtype=jnp.float32)
        assert set(got) == set(want) and "mAP" in got
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (metric, k)


# -- the digits_detect scenes ------------------------------------------------

@pytest.fixture(scope="module")
def scans():
    return digits.scan_splits(), jax_digits.scan_splits()


def _same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed", [1, 2, 1000])
def test_digits_scenes_equal_jax_bit_for_bit(scans, seed):
    ((tr_x, tr_y), _), _ = scans
    kw = dict(n_scenes=24, canvas=128, seed=seed)
    _same(digits.detection_scenes(tr_x, tr_y, **kw),
          jax_digits.detection_scenes(tr_x, tr_y, **kw))


def test_digits_splits_val_scenes_and_batches_equal_jax(scans):
    port, ref = scans
    for (a, b), (c, d) in zip(port, ref):
        _same((a, b), (c, d))
    kw = dict(train_scenes=16, val_scenes=8)
    for a, b in zip(digits.detection_splits(**kw),
                    jax_digits.detection_splits(**kw)):
        _same(a, b)
    va = digits.detection_val_scenes(canvas=128, n_scenes=8)
    _same(va, jax_digits.detection_val_scenes(canvas=128, n_scenes=8))
    got = list(digits.detection_batches(va, batch_size=3, shuffle_seed=4))
    want = list(jax_digits.detection_batches(va, batch_size=3,
                                             shuffle_seed=4))
    assert len(got) == len(want) == 2          # drop-remainder
    for a, b in zip(got, want):
        _same(a, b)
    with pytest.raises(ValueError, match="multiple of the 8px"):
        digits.detection_scenes(va[0], va[2], n_scenes=1, digit_px=12)


def _cli_args(**kw):
    return cli.build_parser("YOLO", ["yolov3_digits"]).parse_args(
        ["-m", "yolov3_digits", "--device", "cpu"]
        + [f"--{k.replace('_', '-')}={v}" for k, v in kw.items()])


def test_digits_detect_epochs_are_the_jax_clis(monkeypatch):
    """The training CLI's digits_detect data: epoch e's scenes composed
    from seed 1000 + e and shuffled with seed e, the val scenes pinned —
    the JAX CLI's batches bit for bit; under 2 ranks each takes its half
    of every training batch; --steps-per-epoch cuts the epoch."""
    args = _cli_args(batch_size=64)
    cfg = cli._config_from_args(args, 64)
    train_fn, val_fn = cli._detection_data(cfg, args)
    jcfg = jax_get_config("yolov3_digits").replace(batch_size=64)
    jtrain, jval = jax_cli._detection_data(jcfg, args)
    for epoch in (1, 2):
        got, want = list(train_fn(epoch)), list(jtrain(epoch))
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            _same(a, b)
    got, want = list(val_fn(1)), list(jval(1))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _same(a, b)
    whole = next(iter(jtrain(3)))
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    train_fn, _ = cli._detection_data(cfg, args)
    _same(next(iter(train_fn(3))), tuple(a[32:] for a in whole))
    monkeypatch.undo()
    args = _cli_args(batch_size=64, steps_per_epoch=3)
    train_fn, _ = cli._detection_data(cli._config_from_args(args, 64), args)
    assert len(list(train_fn(1))) == 3


def test_tfrecord_detection_data_is_refused_by_name(tmp_path):
    """Once refused by name, the VOC/COCO records now feed the detection
    CLI: the val batches are the JAX CLI's record for record (one shard),
    targets equal, pixels within the decode gap (PIL against TensorFlow's
    default IDCT, 7 levels, through the bilinear resize); the training
    epoch runs its single pass."""
    import tensorflow as tf
    from torch_records_fixtures import write_voc
    tf.config.set_visible_devices([], "GPU")
    data_dir = write_voc(str(tmp_path), splits=(("train", 5), ("val", 5)))
    argv = ["-m", "yolov3_voc", "--device", "cpu", "--data-dir", data_dir,
            "--batch-size", "2", "--image-size", "64"]
    args = cli.build_parser("YOLO", ["yolov3_voc"]).parse_args(argv)
    cfg = cli._config_from_args(args, 64)
    train_fn, val_fn = cli._detection_data(cfg, args)
    jcfg = jax_get_config("yolov3_voc")
    jcfg = jcfg.replace(batch_size=2, data=dataclasses.replace(
        jcfg.data, image_size=64))
    jtrain, jval = jax_cli._detection_data(jcfg, args)
    got, want = list(val_fn(0)), list(jval(0))
    assert len(got) == len(want) == 2          # drop_remainder, as JAX
    for g, w in zip(got, want):
        assert float(np.abs(g[0].numpy() - w[0]).max()) <= 7 / 127.5
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    assert len(list(train_fn(1))) == len(list(jtrain(1))) == 2


# -- the entry points --------------------------------------------------------

def _script(name):
    return runpy.run_path(os.path.join(REPO, "YOLO", "torch", name),
                          run_name="not_main")


def _workdir_with_tiny_weights(tmp_path, dtype=torch.bfloat16):
    """A yolov3 workdir pinning the tiny architecture in model_kwargs.json,
    its epoch-0 checkpoint the carried JAX weights."""
    workdir = str(tmp_path / "wd")
    os.makedirs(workdir)
    with open(os.path.join(workdir, "model_kwargs.json"), "w") as fp:
        json.dump({"num_classes": 2, "width_mult": 0.125,
                   "stage_blocks": [1, 1, 2, 2, 1]}, fp)
    _, params, stats = tiny(dtype)
    trainer = DetectionTrainer(get_config("yolov3"), device="cpu",
                               workdir=workdir)
    assert trainer.config.model_kwargs["width_mult"] == 0.125
    trainer.model.load_state_dict(
        params_to_state_dict(params, trainer.model, stats))
    trainer.init_state()
    trainer.ckpt.save(0, trainer.state.state_dict())
    trainer.close()
    return workdir


def test_workdir_model_kwargs_pin_the_architecture(tmp_path):
    workdir = _workdir_with_tiny_weights(tmp_path)
    trainer = DetectionTrainer(get_config("yolov3"), device="cpu",
                               workdir=workdir)
    assert trainer.model.num_classes == 2
    assert [p.shape for p in trainer.model.parameters()] == [
        p.shape for p in YoloV3(**TINY).parameters()]
    trainer.init_state()
    assert trainer.resume() == 0
    trainer.close()
    bare = DetectionTrainer(get_config("yolov3_digits"), device="cpu",
                            workdir=str(tmp_path / "none"))
    assert bare.config.model_kwargs == {"num_classes": 10, "width_mult": 0.25}


def _parse(stdout):
    per_image, current = {}, None
    for line in stdout.splitlines():
        m = re.match(r"^(?P<path>\S+\.png): (?P<n>\d+) detections$", line)
        if m:
            current = os.path.basename(m.group("path"))
            per_image[current] = []
            continue
        m = DETECT_LINE.match(line)
        if m and current:
            per_image[current].append({
                "name": m.group("name"), "score": float(m.group("score")),
                "box": [float(m.group(k)) for k in ("x1", "y1", "x2", "y2")]})
    return per_image


def test_detect_cli_on_the_committed_images_matches_jax(tmp_path, capsys):
    """detect.py on tests/data/detect/img{0,1}.png at 64 px from a workdir
    holding the carried weights: its top-10 lines per image match the JAX
    predict step on the same images and weights (bf16, as both CLIs
    run)."""
    from PIL import Image

    workdir = _workdir_with_tiny_weights(tmp_path)
    images = [os.path.join(DATA_DIR, f"img{i}.png") for i in range(2)]
    detect = _script("detect.py")
    detect["main"](["--workdir", workdir, "--image-size", "64",
                    "--score-thresh", "0.25", "--device", "cpu", *images])
    out = capsys.readouterr().out
    assert "no checkpoint found" not in out
    got = _parse(out)
    assert set(got) == {"img0.png", "img1.png"}, out

    batch = np.zeros((8, 64, 64, 3), np.float32)
    for i, path in enumerate(images):
        img = Image.open(path).convert("RGB").resize((64, 64))
        batch[i] = np.asarray(img, np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(detect["load_images"](images, 64), batch)
    jm, params, stats = tiny(torch.bfloat16)
    boxes, scores, probs, counts = (np.asarray(a) for a in _jax_predict(
        jnp.bfloat16, 0.5, 0.25)(jax_state(jm, params, stats),
                                 jnp.asarray(batch)))
    names = ["person", "bicycle"]      # 80-class config: the COCO names
    for i, path in enumerate(images):
        dets = got[os.path.basename(path)][:10]
        assert len(dets) == 10 and int(counts[i]) >= 10
        want = [{"name": names[int(np.argmax(probs[i, d]))],
                 "score": float(scores[i, d]), "box": boxes[i, d].tolist()}
                for d in range(int(counts[i]))]
        unmatched = list(want)
        for g in dets:
            best = min(unmatched, key=lambda w: (
                g["name"] != w["name"],
                float(np.abs(np.array(g["box"]) - w["box"]).max())))
            assert g["name"] == best["name"]
            np.testing.assert_allclose(g["score"], best["score"], atol=0.02)
            np.testing.assert_allclose(g["box"], best["box"], rtol=2e-3,
                                       atol=0.03)
            unmatched.remove(best)


def test_detection_lines_print_the_jax_format():
    """The chunk-to-lines function the CLI and the card's smoke share."""
    detect = _script("detect.py")
    boxes = torch.tensor([[[0.1, 0.2, 0.3, 0.4], [0.0, 0.0, 0.0, 0.0]]])
    out = (boxes, torch.tensor([[0.87654, 0.0]]),
           torch.tensor([[[0.1, 0.9], [0.0, 0.0]]]),
           torch.tensor([1], dtype=torch.int32))
    state = port_state(torch.float32, *tiny()[1:])
    lines = detect["detection_lines"](lambda s, x: out, state,
                                      np.zeros((8, 4, 4, 3), np.float32),
                                      ["a.png"], ["cat", "dog"])
    assert lines == ["a.png: 1 detections",
                     "  dog score=0.877 box=(0.100,0.200,0.300,0.400)"]


def test_evaluate_cli_synthetic_writes_a_finite_map(tmp_path, capsys):
    out = str(tmp_path / "eval.json")
    metrics = _script("evaluate.py")["main"](
        ["-m", "yolov3_digits", "--synthetic", "--device", "cpu",
         "--workdir", str(tmp_path / "wd"), "--out", out])
    with open(out) as fp:
        written = json.load(fp)
    assert written == pytest.approx(metrics)
    assert math.isfinite(written["mAP"]) and "mAP@0.95" in written
    assert "mAP: " in capsys.readouterr().out


def test_evaluate_cli_refuses_the_tfrecord_split(tmp_path, capsys):
    """Once refused, the VOC/COCO val split now evaluates: the tiny
    workdir's weights on the records, the ragged batch kept (5 images
    against the config's batch of 128), the difficult flags carried, a
    finite mAP written."""
    import tensorflow as tf
    from torch_records_fixtures import write_voc
    tf.config.set_visible_devices([], "GPU")
    data_dir = write_voc(str(tmp_path / "voc"), splits=(("val", 5),))
    workdir = _workdir_with_tiny_weights(tmp_path)
    from deepvision_tpu_torch.data import jpeg
    jpeg.zero_stats()
    out = str(tmp_path / "eval.json")
    metrics = _script("evaluate.py")["main"](
        ["-m", "yolov3", "--device", "cpu", "--workdir", workdir,
         "--data-dir", data_dir, "--image-size", "64", "--metric", "voc",
         "--out", out])
    assert jpeg.images_decoded() == 5
    with open(out) as fp:
        assert json.load(fp) == pytest.approx(metrics)
    assert math.isfinite(metrics["mAP"])
    assert "WARNING" not in capsys.readouterr().out   # the checkpoint


def test_yolov3_digits_trains_then_evaluates(tmp_path, monkeypatch, capsys):
    """A cut yolov3_digits run on the digits_detect scenes through
    YOLO/torch/train.py (2 steps, then the validation scenes), then
    evaluate.py on its workdir."""
    workdir = str(tmp_path / "digits")
    monkeypatch.setattr(sys, "argv", [
        "train.py", "-m", "yolov3_digits", "--device", "cpu",
        "--batch-size", "32", "--steps-per-epoch", "2", "--epochs", "1",
        "--image-size", "64", "--workdir", workdir])
    runpy.run_path(os.path.join(REPO, "YOLO", "torch", "train.py"),
                   run_name="__main__")
    assert os.listdir(os.path.join(workdir, "ckpt"))
    metrics = _script("evaluate.py")["main"](
        ["-m", "yolov3_digits", "--device", "cpu", "--workdir", workdir,
         "--metric", "voc", "--max-batches", "1"])
    out = capsys.readouterr().out
    assert "no checkpoint found" not in out and "resumed from epoch 1" in out
    assert math.isfinite(metrics["mAP"]) and "mAP@0.5" in metrics
