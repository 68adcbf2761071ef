"""The checkpoint classifier (deepvision_tpu_torch/core/classify.py and
`python -m deepvision_tpu_torch.tools.classify`) against the JAX
package's `core/classify.py` on the CPU.

- `load_class_names` and `load_metrics` equal JAX's, the latter on the
  committed `runs/r04_lenet5_digits_cpu` and on a port run's log (its meta
  header and a non-finite value included).
- `Classifier.preprocess` against JAX's on the same images (a JPEG, a PNG,
  an HWC array; the MNIST-format gray path at 28 px and resized): within
  one uint8 level after normalization, the flat loader's bound (the port
  resamples PIL's bilinear as an antialiased bilinear rounded to uint8).
- `Classifier.predict` against JAX's on shared weights (a 2-block f32
  vit_tiny, its Flax weights bridged into the port's model, and LeNet-5):
  the same classes in the same order, probabilities within 1e-5.
- The tool restores a run's checkpoint (the EMA weights where the run kept
  them), prints each image's top-k, and refuses without a checkpoint with
  JAX's message.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deepvision_tpu import configs as jax_configs  # noqa: E402
from deepvision_tpu.core import classify as jax_classify  # noqa: E402
from deepvision_tpu_torch import configs  # noqa: E402
from deepvision_tpu_torch.core import classify  # noqa: E402
from deepvision_tpu_torch.tools import classify as tool  # noqa: E402
from deepvision_tpu_torch.utils.flax_convert import \
    params_to_state_dict  # noqa: E402

STD_MIN = 0.224                         # IMAGENET_STD's smallest
LEVEL = 1.001 / 255 / STD_MIN
PROB_TOL = 1e-5
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
PNG = os.path.join(REPO, "tests", "data", "detect", "img0.png")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _f32_vit(get):
    """`get_config` with vit_tiny at f32 and 2 blocks (the JAX and the
    port's configs alike)."""
    def patched(name):
        cfg = get(name)
        if name != "vit_tiny":
            return cfg
        return cfg.replace(dtype="float32", model_kwargs={
            **cfg.model_kwargs, "depth": 2})
    return patched


@pytest.fixture
def f32_configs(monkeypatch):
    monkeypatch.setattr(jax_configs, "get_config",
                        _f32_vit(jax_configs.get_config))
    from deepvision_tpu_torch import cli
    for module in (configs, cli):
        monkeypatch.setattr(module, "get_config",
                            _f32_vit(configs.get_config))


def _jpeg() -> str:
    return os.path.join(FIXTURES, "q90_420.jpg")


# -- class names and metrics -----------------------------------------------------

@pytest.mark.parametrize("kind", ["none", "json", "text"])
def test_class_names_are_jaxs(tmp_path, kind):
    path = None
    if kind == "json":
        path = str(tmp_path / "indices.json")
        with open(path, "w") as f:
            json.dump({"0": ["n01440764", "tench"], "3": "goldfish",
                       "7": ["n7", "seven"]}, f)
    elif kind == "text":
        path = str(tmp_path / "names.txt")
        with open(path, "w") as f:
            f.write("cat\n\ndog\n  bird \n")
    want = jax_classify.load_class_names(path, num_classes=10)
    assert classify.load_class_names(path, num_classes=10) == want


def test_metrics_of_the_committed_run_are_jaxs():
    run = os.path.join(REPO, "runs", "r04_lenet5_digits_cpu")
    want = jax_classify.load_metrics(run)
    got = classify.load_metrics(run)
    assert got == want and "val_top1" in got
    assert classify.load_metrics(os.path.join(REPO, "no_such_run")) == {}


def test_metrics_of_a_port_run_are_jaxs(tmp_path):
    from deepvision_tpu_torch.core.metrics import MetricsLogger
    log = MetricsLogger(str(tmp_path), name="run", tensorboard=False)
    log.log(1, {"loss": 2.0, "top1": 0.5}, prefix="train_", epoch=1)
    log.log(2, {"loss": float("nan")}, prefix="val_", epoch=1)
    log.close()
    with open(tmp_path / "run.jsonl") as f:
        assert "meta" in json.loads(f.readline())
    got = classify.load_metrics(str(tmp_path))
    want = jax_classify.load_metrics(str(tmp_path))
    assert json.dumps(got) == json.dumps(want)
    assert np.isnan(got["val_loss"]["value"][0])


# -- preprocessing and top-k ---------------------------------------------------

@pytest.fixture
def vit_pair(tmp_path, f32_configs):
    """JAX's classifier and the port's on an empty workdir each (random
    weights), the port's model given JAX's weights."""
    want = jax_classify.Classifier("vit_tiny", workdir=str(tmp_path / "j"))
    got = classify.Classifier("vit_tiny", workdir=str(tmp_path / "p"),
                              device="cpu")
    model = got.trainer.state.model
    params = jax.device_get(want.trainer.state.params)
    model.load_state_dict(params_to_state_dict(params, model))
    yield want, got
    got.close()
    want.trainer.close()


def _image(kind: str):
    if kind == "jpeg":
        return _jpeg()
    if kind == "png":
        return PNG
    rs = np.random.RandomState(4)
    return rs.randint(0, 256, (45, 70, 3)).astype(np.uint8)


@pytest.mark.parametrize("kind", ["jpeg", "png", "array"])
def test_preprocess_and_top_k_are_jaxs(vit_pair, kind):
    want_clf, got_clf = vit_pair
    image = _image(kind)
    want = want_clf.preprocess(image)
    got = got_clf.preprocess(image)
    assert tuple(got.shape) == want.shape == (1, 32, 32, 3)
    assert float(np.abs(got.numpy() - want).max()) <= LEVEL
    # the same input through both models: the same classes, in order
    logits = got_clf.trainer.state.model.eval()(torch.from_numpy(want))
    probs = torch.softmax(logits[0], -1).detach().numpy()
    ref = want_clf.predict(image, top=10)
    order = np.argsort(probs)[::-1][:10]
    assert [got_clf.class_names[i] for i in order] == [n for n, _ in ref]
    np.testing.assert_allclose(probs[order], [p for _, p in ref],
                               atol=PROB_TOL)
    top = got_clf.predict(image, top=3)
    assert len(top) == 3 and all(0 <= p <= 1 for _, p in top)


def test_the_image_bytes_decode_as_the_path(vit_pair):
    _, clf = vit_pair
    with open(_jpeg(), "rb") as f:
        data = f.read()
    torch.testing.assert_close(clf.preprocess(data), clf.preprocess(_jpeg()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("side", [28, 40])
def test_the_gray_path_is_jaxs(tmp_path, side):
    from PIL import Image
    rs = np.random.RandomState(side)
    gray = rs.randint(0, 256, (side, side)).astype(np.uint8)
    path = str(tmp_path / "digit.png")
    Image.fromarray(gray).save(path)
    want_clf = jax_classify.Classifier("lenet5", workdir=str(tmp_path / "j"))
    got_clf = classify.Classifier("lenet5", workdir=str(tmp_path / "p"),
                                  device="cpu")
    model = got_clf.trainer.state.model
    model.load_state_dict(params_to_state_dict(
        jax.device_get(want_clf.trainer.state.params), model))
    for image in (path, gray, gray[..., None]):
        want = want_clf.preprocess(image)
        got = got_clf.preprocess(image)
        assert tuple(got.shape) == want.shape == (1, 32, 32, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    ref = want_clf.predict(path)
    top = got_clf.predict(path)
    assert [n for n, _ in top] == [n for n, _ in ref]
    np.testing.assert_allclose([p for _, p in top], [p for _, p in ref],
                               atol=PROB_TOL)
    got_clf.close()
    want_clf.trainer.close()


def test_rgb_to_gray_is_pils():
    from PIL import Image
    rs = np.random.RandomState(0)
    rgb = rs.randint(0, 256, (7, 9, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    got = classify.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, want)


# -- the tool ------------------------------------------------------------------

@pytest.fixture
def trained(tmp_path, f32_configs):
    """A one-epoch vit_tiny run (2 steps) with an EMA."""
    from deepvision_tpu_torch import cli
    workdir = str(tmp_path / "run")
    cli.run_classification("ViT", ["vit_tiny"], [
        "-m", "vit_tiny", "--synthetic", "--device", "cpu", "--batch-size",
        "4", "--steps-per-epoch", "2", "--epochs", "1", "--ema-decay", "0.5",
        "--workdir", workdir])
    return workdir


def test_the_tool_classifies_with_the_runs_ema_weights(trained, capsys):
    out = tool.main(["-m", "vit_tiny", "--workdir", trained, "--device",
                     "cpu", "--top", "3", _jpeg(), PNG])
    printed = capsys.readouterr().out
    assert "resumed from epoch 1" in printed
    assert set(out) == {_jpeg(), PNG}
    clf = classify.Classifier("vit_tiny", workdir=trained, device="cpu")
    state = clf.trainer.state
    assert clf.epoch == 1 and state.ema is not None
    for path, top in out.items():
        assert path in printed and len(top) == 3
        assert top == clf.predict(path, top=3)
        # the EMA weights, not the raw ones
        x = clf.preprocess(path)
        with torch.no_grad(), state.ema_weights():
            ema = state.model.eval()(x)
        raw = state.model.eval()(x)
        torch.testing.assert_close(clf.logits(path), ema)
        assert not torch.allclose(ema, raw)
    clf.close()


def test_the_tool_refuses_without_a_checkpoint_as_jax(tmp_path, capsys,
                                                      f32_configs):
    workdir = str(tmp_path / "empty")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import importlib
    jax_tool = importlib.import_module("classify")
    argv = ["-m", "vit_tiny", "--workdir", workdir, _jpeg()]
    with pytest.raises(SystemExit) as want:
        jax_tool.main(argv)
    with pytest.raises(SystemExit) as got:
        tool.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
