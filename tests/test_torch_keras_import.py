"""The Keras h5 importers (deepvision_tpu_torch/utils/{keras,order}_
convert.py, deepvision_tpu_torch/tools/import_keras_checkpoint.py)
against the JAX package on the CPU, every file read by the port's own
HDF5 reader.

- yolov3, tiny (tests/test_keras_convert.py's Keras model in the
  reference's layer names: WIDTH_MULT 0.125, STAGE_BLOCKS (1, 1, 2, 2, 1),
  2 classes): `load_h5_weights` and `convert_yolov3` equal JAX's array for
  array, and the imported model's f32 raw heads equal JAX's `apply` on
  JAX's own tree within 2e-5 of the largest head value (measured 1.4e-6);
- hourglass104 at one stack, width 1/16: an h5 of auto-named layers
  (`conv2d`, `conv2d_1`, ..., `batch_normalization_k`) in the order JAX's
  `flax_modules_in_call_order` gives, written on disk in a shuffled order:
  the port's `convert_by_call_order` state dict equals
  `params_to_state_dict` of JAX's `convert_by_call_order` exactly, and
  the heatmaps JAX's within 2e-5 of the largest (measured 8.5e-7);
- the call-order pairing's four refusals (count, kind, shape, bias either
  way) raise JAX's words, word for word;
- the tool: its workdir's manifest and `imported_from`, `YOLO/torch/
  train.py -c latest` resuming it, "does not fit" for an 80-class h5 given
  to `-m yolov3_voc`, and `--device` defaulting to the card."""

import json
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
h5py = pytest.importorskip("h5py")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from deepvision_tpu.models.hourglass import (  # noqa: E402
    StackedHourglass as JaxHourglass)
from deepvision_tpu.models.yolo import YoloV3 as JaxYoloV3  # noqa: E402
from deepvision_tpu.utils import keras_convert as jax_keras  # noqa: E402
from deepvision_tpu.utils import order_convert as jax_order  # noqa: E402
from deepvision_tpu_torch.core import integrity  # noqa: E402
from deepvision_tpu_torch.core.checkpoint import (  # noqa: E402
    CheckpointManager)
from deepvision_tpu_torch.models.common import Conv, Dense  # noqa: E402
from deepvision_tpu_torch.models.hourglass import (  # noqa: E402
    StackedHourglass)
from deepvision_tpu_torch.models.yolo import YoloV3  # noqa: E402
from deepvision_tpu_torch.tools import (  # noqa: E402
    import_keras_checkpoint as tool)
from deepvision_tpu_torch.utils import keras_convert  # noqa: E402
from deepvision_tpu_torch.utils import order_convert  # noqa: E402
from deepvision_tpu_torch.utils.flax_convert import (  # noqa: E402
    params_to_state_dict)
from test_keras_convert import (NUM_CLASSES, STAGE_BLOCKS,  # noqa: E402
                                WIDTH_MULT, build_seeded_keras_yolo,
                                write_legacy_h5)
from test_torch_import_checkpoint import _same_tree  # noqa: E402

torch.set_num_threads(1)

HEADS_RTOL = 2e-5
HEATMAP_RTOL = 2e-5
HOURGLASS = dict(num_heatmap=4, num_stack=1, num_residual=1, order=4,
                 width_mult=0.0625)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def yolo_h5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("yolo") / "yolov3_best.h5")
    write_legacy_h5(build_seeded_keras_yolo(), path)
    return path


def test_yolov3_convert_equals_jax_array_for_array(yolo_h5):
    got, want = (keras_convert.load_h5_weights(yolo_h5),
                 jax_keras.load_h5_weights(yolo_h5))
    _same_tree(got, want, "h5")
    _same_tree(keras_convert.convert_yolov3(got, STAGE_BLOCKS)[0],
               jax_keras.convert_yolov3(want, STAGE_BLOCKS)[0], "params")
    _same_tree(keras_convert.convert_yolov3(got, STAGE_BLOCKS)[1],
               jax_keras.convert_yolov3(want, STAGE_BLOCKS)[1], "stats")
    for name in ("hourglass104", "centernet"):
        with pytest.raises(KeyError) as port:
            keras_convert.convert(name, got)
        with pytest.raises(KeyError) as ref:
            jax_keras.convert(name, want)
        assert str(port.value) == str(ref.value)


def test_yolov3_heads_equal_jax_apply(yolo_h5):
    params, stats = jax_keras.convert_yolov3(
        jax_keras.load_h5_weights(yolo_h5), STAGE_BLOCKS)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    want = JaxYoloV3(num_classes=NUM_CLASSES, width_mult=WIDTH_MULT,
                     stage_blocks=STAGE_BLOCKS, dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False, decode=False)
    tm = YoloV3(num_classes=NUM_CLASSES, width_mult=WIDTH_MULT,
                stage_blocks=STAGE_BLOCKS, dtype=torch.float32)
    assert keras_convert.stage_blocks_of(tm) == STAGE_BLOCKS
    tm.load_state_dict(keras_convert.to_state_dict(
        "yolov3", keras_convert.load_h5_weights(yolo_h5), tm), strict=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), decode=False)
    assert len(got) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= HEADS_RTOL * scale


def _auto_named_h5(path, ordered, variables, seed):
    """Seeded Keras weights for JAX's weighted modules `ordered`, named as
    Keras counts them per kind, written in the TF 2.1 layout in a shuffled
    order."""
    prefix = {"Conv": "conv2d", "BatchNorm": "batch_normalization",
              "Dense": "dense", "ConvTranspose": "conv2d_transpose"}
    rs = np.random.RandomState(seed)
    counts, layers = {}, []
    for path_, kind in ordered:
        node = variables["params"]
        for p in path_:
            node = node[p]
        k = counts.get(kind, 0)
        counts[kind] = k + 1
        name = prefix[kind] + (f"_{k}" if k else "")
        if kind == "BatchNorm":
            c = node["scale"].shape
            w = {"gamma": rs.uniform(0.7, 1.3, c),
                 "beta": rs.uniform(-0.3, 0.3, c),
                 "moving_mean": rs.uniform(-0.3, 0.3, c),
                 "moving_variance": rs.uniform(0.5, 2.0, c)}
        else:
            shape = node["kernel"].shape
            w = {"kernel": rs.randn(*shape) * np.sqrt(
                2.0 / np.prod(shape[:-1]))}
            if "bias" in node:
                w["bias"] = rs.uniform(-0.3, 0.3, node["bias"].shape)
        layers.append((name, w))
    with h5py.File(path, "w") as f:
        for i in rs.permutation(len(layers)):
            name, w = layers[i]
            g = f.create_group(name).create_group(name)
            for attr, value in w.items():
                g.create_dataset(f"{attr}:0", data=value.astype(np.float32))
    return layers


def test_hourglass_call_order_equals_jax_exactly(tmp_path):
    jm = JaxHourglass(dtype=jnp.float32, **HOURGLASS)
    x0 = jnp.zeros((1, 64, 64, 3))
    ordered, variables = jax_order.flax_modules_in_call_order(
        jm, jax.random.PRNGKey(0), x0)
    path = str(tmp_path / "hourglass.h5")
    _auto_named_h5(path, ordered, variables, seed=4)

    port_layers = order_convert.layers_from_legacy_h5(path)
    jax_layers = jax_order.layers_from_legacy_h5(path)
    assert [k for k, _ in port_layers] == [k for k, _ in jax_layers]
    for (_, g), (_, w) in zip(port_layers, jax_layers):
        _same_tree(g, w)

    tm = StackedHourglass(dtype=torch.float32, **HOURGLASS)
    got = order_convert.convert_by_call_order(tm, port_layers,
                                              torch.zeros(1, 64, 64, 3))
    params, stats = jax_order.convert_by_call_order(
        jm, jax_layers, jax.random.PRNGKey(0), x0)
    want = params_to_state_dict(params, tm, stats)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name

    tm.load_state_dict(got, strict=False)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(x), train=False)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    assert len(out) == len(ref) == 1
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= HEATMAP_RTOL * np.abs(r).max()


class _FlaxTiny(fnn.Module):
    bias: bool = True

    @fnn.compact
    def __call__(self, x, train=False):
        y = fnn.Conv(3, (1, 1), use_bias=self.bias)(x)
        return fnn.Dense(2)(y.mean(axis=(1, 2)))


class _TorchTiny(torch.nn.Module):
    def __init__(self, bias=True):
        super().__init__()
        self.Conv_0 = Conv(2, 3, 1, use_bias=bias)
        self.Dense_0 = Dense(3, 2)

    def forward(self, x):
        return self.Dense_0(self.Conv_0(x.permute(0, 3, 1, 2)).mean(
            dim=(2, 3)))


_CONV = {"kernel": np.zeros((1, 1, 2, 3), np.float32),
         "bias": np.zeros((3,), np.float32)}
_DENSE = {"kernel": np.zeros((3, 2), np.float32),
          "bias": np.zeros((2,), np.float32)}


@pytest.mark.parametrize("bias,layers,match", [
    (True, [("Conv", _CONV)], "count mismatch"),
    (True, [("BatchNorm", {}), ("Dense", _DENSE)],
     "checkpoint layer is BatchNorm"),
    (True, [("Conv", dict(_CONV, kernel=np.zeros((1, 1, 2, 5), np.float32))),
            ("Dense", _DENSE)], "shape"),
    (True, [("Conv", {"kernel": _CONV["kernel"]}), ("Dense", _DENSE)],
     "model has one, checkpoint lacks one"),
    (False, [("Conv", _CONV), ("Dense", _DENSE)],
     "model lacks one, checkpoint has one"),
], ids=["count", "kind", "shape", "bias_missing", "bias_extra"])
def test_mismatches_raise_jax_words(bias, layers, match):
    with pytest.raises(ValueError, match=match) as ref:
        jax_order.convert_by_call_order(_FlaxTiny(bias), layers,
                                        jax.random.PRNGKey(0),
                                        jnp.zeros((1, 4, 4, 2)))
    with pytest.raises(ValueError) as port:
        order_convert.convert_by_call_order(_TorchTiny(bias), layers,
                                            torch.zeros(1, 4, 4, 2))
    assert str(port.value) == str(ref.value)


TINY_YOLO = {"width_mult": 0.0625, "stage_blocks": [1, 1, 1, 1, 1]}


def _tiny_yolo_h5(tmp_path, pins=TINY_YOLO):
    """A reference-named h5 of yolov3 (80 classes) at `pins`, written by
    chip_smoke.py's writer; its weights as state_dict entries."""
    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.models import build_model
    cfg = get_config("yolov3")
    with torch.device("meta"):
        layout = build_model(cfg.replace(model_kwargs={**cfg.model_kwargs,
                                                       **pins}))
    tree, expected = chip_smoke.yolo_reference_tree(
        layout, np.random.default_rng(6))
    path = str(tmp_path / "yolov3_coco.h5")
    chip_smoke.write_h5(path, tree)
    return path, expected


def _pinned_workdir(tmp_path, name):
    wd = str(tmp_path / name)
    os.makedirs(wd)
    with open(os.path.join(wd, "model_kwargs.json"), "w") as fp:
        json.dump(TINY_YOLO, fp)
    return wd


def test_the_tool_workdir_resumes_and_keeps_its_origin(tmp_path):
    from deepvision_tpu_torch.cli import run_detection
    path, expected = _tiny_yolo_h5(tmp_path)
    wd = _pinned_workdir(tmp_path, "wd")
    assert tool.main(["-m", "yolov3", "--h5", path, "--workdir", wd,
                      "--epoch", "40", "--device", "cpu"]) == {
        "workdir": wd, "epoch": 40}
    ckpt = os.path.join(wd, "ckpt")
    assert integrity.verify_files(os.path.join(ckpt, "40"))[0] == \
        integrity.OK
    manager = CheckpointManager(ckpt)
    try:
        state, host, epoch = manager.restore(verify="strict")
        assert epoch == 40 and host["imported_from"] == path
    finally:
        manager.close()
    tm = YoloV3(dtype=torch.float32, **TINY_YOLO)
    tm.load_state_dict(state["model"])
    assert chip_smoke.unequal_leaves(tm.state_dict(), expected) == []
    trainer, _ = run_detection("YOLO", ["yolov3"], argv=[
        "-m", "yolov3", "--synthetic", "-c", "latest", "--epochs", "41",
        "--image-size", "64", "--batch-size", "2", "--steps-per-epoch", "1",
        "--workdir", wd, "--device", "cpu"])
    assert trainer.state.step == 1
    manager = CheckpointManager(ckpt)
    try:
        assert manager.epochs() == [40, 41]
    finally:
        manager.close()


def test_an_80_class_h5_does_not_fit_yolov3_voc(tmp_path):
    path, _ = _tiny_yolo_h5(tmp_path)
    wd = _pinned_workdir(tmp_path, "voc")
    with pytest.raises(SystemExit, match=(
            r"does not fit yolov3_voc: Flax leaf "
            r"'tower_large/final_conv/kernel' has shape")):
        tool.main(["-m", "yolov3_voc", "--h5", path, "--workdir", wd,
                   "--device", "cpu"])
    assert not os.path.exists(os.path.join(wd, "ckpt", "0"))


def test_the_import_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                               tmp_path):
    """The default `--device` is the card: without one the tool raises
    before it reads the file or writes the workdir."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = str(tmp_path / "wd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["-m", "yolov3", "--h5", str(tmp_path / "missing.h5"),
                   "--workdir", wd])
    assert not os.path.exists(wd)
