"""Checkpoint restore into the port's engine (deepvision_tpu_torch/serve/
engine.py::load_checkpoint_weights, `PredictEngine.from_config(workdir=)`,
the `-c/--checkpoint` and `--workdir` of `python -m
deepvision_tpu_torch.serve`) on the CPU.

Each family trains a few steps through its own entry point into a workdir;
the engine restored from it must answer exactly what an engine built on
the trainer's restored weights answers (the EMA weights, where the run
kept them, with the current BatchNorm statistics: what `Trainer.evaluate`
scores), and the segmentation masks must equal the trainer's predict step
on them. The restore is verified: the provenance carries the epoch's
manifest digest. Both run on the same device at the same batch size, so the bound
is equality. GAN configs are refused with the JAX engine's message
(deepvision_tpu/serve/engine.py:103-106, read from its source: the JAX
serve package does not import on this jax, see ROADMAP Queue C).
"""

import copy
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from deepvision_tpu_torch import cli
from deepvision_tpu_torch.configs import get_config, trainer_class_for_config
from deepvision_tpu_torch.core import integrity
from deepvision_tpu_torch.core.segment import make_segmentation_predict_step
from deepvision_tpu_torch.serve import cli as serve_cli
from deepvision_tpu_torch.serve.engine import (PredictEngine,
                                               load_checkpoint_weights)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _restored_trainer(name, workdir, epoch=None):
    """The config's trainer resumed from `workdir` on the CPU."""
    trainer = trainer_class_for_config(name)(get_config(name), device="cpu",
                                             workdir=workdir)
    trainer.init_state()
    assert trainer.resume(epoch) is not None
    trainer.close()
    return trainer


@pytest.fixture(scope="module")
def unet_workdir(tmp_path_factory):
    """unet_synthetic trained 2 epochs of 2 steps with an EMA (so the EMA
    weights and the trained ones differ), a checkpoint each epoch."""
    torch.set_num_threads(1)      # module scope: before the autouse one
    workdir = str(tmp_path_factory.mktemp("unet"))
    cli.run_segmentation("UNet", ["unet_synthetic"], [
        "-m", "unet_synthetic", "--synthetic", "--device", "cpu",
        "--epochs", "2", "--steps-per-epoch", "2", "--batch-size", "2",
        "--ema-decay", "0.9", "--workdir", workdir])
    return workdir


def test_served_masks_equal_the_predict_step_on_ema_weights(unet_workdir):
    args = serve_cli.build_parser().parse_args(
        ["-m", "unet_synthetic", "--workdir", unet_workdir, "--device",
         "cpu", "--buckets", "1,4"])
    serve_cli.validate_args(serve_cli.build_parser(), args)
    server = serve_cli.build_server(args)
    try:
        described = server.fleet.describe()["unet_synthetic"]
        engine = server.engine
        manifest = integrity.load_manifest(
            os.path.join(unet_workdir, "ckpt", "2"))
        assert engine.provenance == described["weights"] == {
            "weights": "checkpoint", "checkpoint_epoch": 2,
            "verified": True,
            "manifest_sha256": integrity.manifest_digest(manifest),
            "resharded": False}
        trainer = _restored_trainer("unet_synthetic", unet_workdir)
        assert trainer.state.ema is not None
        predict = make_segmentation_predict_step(compute_dtype=torch.float32)
        x = np.random.RandomState(0).uniform(-1, 1, (4, 64, 64, 3)).astype(
            np.float32)
        want = predict(trainer.state, torch.from_numpy(x)).numpy()
        served = server.fleet.get().submit(x).result(timeout=60)
        assert served.dtype == np.int32 and served.shape == (4, 64, 64)
        np.testing.assert_array_equal(served, want)
        np.testing.assert_array_equal(engine.predict(x[:1]), want[:1])
        # over HTTP: /healthz reports the provenance, /predict the masks
        t = threading.Thread(target=lambda: server.serve(port=0),
                             daemon=True)
        t.start()
        assert server.ready.wait(60)
        base = f"http://127.0.0.1:{server.bound_port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            assert json.loads(resp.read())["weights"] == engine.provenance
        req = urllib.request.Request(
            f"{base}/predict", data=json.dumps(
                {"instances": x[:2].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            np.testing.assert_array_equal(
                json.loads(resp.read())["predictions"], want[:2])
        server.stop()
        t.join(timeout=60)
        assert not t.is_alive()
        # the trained (not averaged) weights answer otherwise
        with torch.inference_mode():
            raw = trainer.model.eval()(torch.from_numpy(x)).argmax(-1)
        assert (raw.numpy() != want).any()
    finally:
        server.close()


def test_a_named_epoch_is_restored(unet_workdir):
    engine = PredictEngine.from_config("unet_synthetic", device="cpu",
                                       buckets=(1,), workdir=unet_workdir,
                                       checkpoint="1", verbose=False)
    assert engine.provenance["checkpoint_epoch"] == 1
    trainer = _restored_trainer("unet_synthetic", unet_workdir, epoch=1)
    x = np.random.RandomState(1).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    predict = make_segmentation_predict_step(compute_dtype=torch.float32)
    np.testing.assert_array_equal(
        engine.predict(x), predict(trainer.state, torch.from_numpy(x)))
    with pytest.raises(FileNotFoundError, match="epoch 7"):
        PredictEngine.from_config("unet_synthetic", device="cpu",
                                  workdir=unet_workdir, checkpoint=7,
                                  verbose=False)


def _ema_state_dict(trainer):
    """The trainer's model state with the EMA parameters in place of the
    trained ones (BatchNorm statistics as they are)."""
    sd = copy.deepcopy(trainer.model.state_dict())
    if trainer.state.ema is not None:
        names = [n for n, _ in trainer.model.named_parameters()]
        sd.update(dict(zip(names, trainer.state.ema)))
    return sd


@pytest.mark.parametrize("family,name,argv", [
    ("YOLO", "yolov3_digits", ["--synthetic", "--image-size", "64"]),
    ("ObjectsAsPoints", "centernet_digits", ["--synthetic", "--image-size",
                                             "64"]),
    ("ResNet", "resnet50_tpu", ["--synthetic", "--image-size", "32",
                                "--learning-rate", "1e-3"]),
], ids=["yolov3_digits", "centernet_digits", "resnet50_tpu"])
def test_every_served_family_restores(tmp_path, family, name, argv):
    """One step of each family through its entry point, then the engine
    from the workdir against an engine on the trainer's restored (EMA,
    for resnet50_tpu) weights: the same answers, leaf for leaf."""
    run = {"YOLO": cli.run_detection, "ObjectsAsPoints": cli.run_centernet,
           "ResNet": cli.run_classification}[family]
    workdir = str(tmp_path)
    run(family, [name], ["-m", name, "--device", "cpu", "--epochs", "1",
                         "--steps-per-epoch", "1", "--batch-size", "2",
                         "--workdir", workdir] + argv)
    engine = PredictEngine.from_config(name, device="cpu", buckets=(1,),
                                       workdir=workdir, verbose=False)
    assert engine.provenance["weights"] == "checkpoint"
    trainer = _restored_trainer(name, workdir)
    assert (trainer.state.ema is not None) == (name == "resnet50_tpu")
    ref = PredictEngine.from_config(name, device="cpu", buckets=(1,),
                                    state_dict=_ema_state_dict(trainer),
                                    verbose=False)
    x = np.random.RandomState(2).uniform(-1, 1, (1, *engine.example_shape))
    got, want = engine.predict(x), ref.predict(x)
    flat = (lambda t: [t] if isinstance(t, np.ndarray) else [
        leaf for v in (t.values() if isinstance(t, dict) else t)
        for leaf in flat(v)])
    for g, w in zip(flat(got), flat(want)):
        np.testing.assert_array_equal(g, w)


def test_nothing_restorable_serves_seeded_weights_with_a_warning(tmp_path,
                                                                 capsys):
    engine = PredictEngine.from_config("unet_synthetic", device="cpu",
                                       buckets=(1,), workdir=str(tmp_path))
    assert "serving RANDOM weights" in capsys.readouterr().out
    assert engine.provenance["weights"] == "random-init"
    assert engine.provenance["checkpoint_epoch"] is None
    seeded = PredictEngine.from_config("unet_synthetic", device="cpu",
                                       buckets=(1,), verbose=False)
    x = np.zeros((1, 64, 64, 3), np.float32)
    np.testing.assert_array_equal(engine.predict(x), seeded.predict(x))


@pytest.mark.parametrize("name", ["dcgan", "cyclegan"])
def test_gan_configs_are_refused_with_the_jax_message(tmp_path, name):
    with pytest.raises(ValueError) as got:
        load_checkpoint_weights(name, str(tmp_path))
    with open(os.path.join(REPO, "deepvision_tpu", "serve",
                           "engine.py")) as fh:
        source = fh.read()
    parts = ("config {name!r} is adversarial — serve a generator via ",
             "tools/export.py instead (no single logits apply fn)")
    assert all(f'f"{part}"' in source for part in parts)
    assert str(got.value) == "".join(parts).format(name=name)
    with pytest.raises(ValueError, match="adversarial"):
        PredictEngine.from_config(name, device="cpu", verbose=False)


def test_cli_flag_coupling(tmp_path):
    parser = serve_cli.build_parser()
    for argv, msg in ((["-m", "unet_synthetic", "-c", "1"], "needs --workdir"),
                      (["-m", "unet_synthetic,lenet5", "--workdir",
                        str(tmp_path)], "restores one model")):
        with pytest.raises(SystemExit):
            serve_cli.validate_args(parser, parser.parse_args(argv))


def test_serve_smoke_from_a_workdir(unet_workdir, capsys):
    """`python -m deepvision_tpu_torch.serve -m unet_synthetic --workdir
    <dir> --smoke` serves the restored masks under load."""
    assert serve_cli.main(["-m", "unet_synthetic", "--workdir",
                           unet_workdir, "--device", "cpu", "--smoke",
                           "--duration", "0.5", "--buckets", "1,4"]) == 0
    assert '"serve_smoke": "pass"' in capsys.readouterr().out
    assert os.path.isdir(os.path.join(unet_workdir, "ckpt"))
