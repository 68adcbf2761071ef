"""The GAN checkpoint importer (deepvision_tpu_torch/utils/gan_convert.py,
deepvision_tpu_torch/tools/import_gan_checkpoint.py) against the JAX
package on the CPU, every bundle read by the port's own reader.

The reference's networks are built here as Keras models in its grammar
(`gan_convert.py`'s docstrings: DCGAN's Sequential generator and
discriminator, CycleGAN's generator with 2 residual blocks whose layer
holds conv1/bn1/conv2/bn2, the PatchGAN), every weight seeded
(tests/test_keras_convert.py::seed_keras_weights), and saved by
`tf.train.Checkpoint` as the reference's trainers save them: current
Keras writes `_operations/N/_kernel` keys. The same weights are saved
again under TF 2.1's `layer_with_weights-N/kernel` keys with
`tf.raw_ops.SaveV2`, so both key dialects are read.

- `convert_object` equals JAX's array for array for all six objects, in
  both dialects;
- the port's DCGAN generator and discriminator, CycleGAN generator and
  PatchGAN on the imported weights equal JAX's `apply` on JAX's trees,
  and the Keras models themselves, within 1e-4 of the largest output
  (measured: at most 8.3e-6 against JAX, 1.7e-5 against Keras, the DCGAN
  generator both times);
- the tool: the checkpoint's `epoch` (else `step`) counter as the epoch, a
  workdir that `DCGAN/torch/inference.py` and `main.py --resume` take,
  a full-size cyclegan one that `CycleGAN/torch/inference.py` takes,
  the structure check's message for a wrong `--n-blocks`, and the
  unknown-object `KeyError` in JAX's words."""

import os
import re
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from deepvision_tpu.models import gan as jax_gan  # noqa: E402
from deepvision_tpu.utils import gan_convert as jax_gan_convert  # noqa: E402
from deepvision_tpu_torch.models import gan as port_gan  # noqa: E402
from deepvision_tpu_torch.tools import (  # noqa: E402
    import_gan_checkpoint as tool)
from deepvision_tpu_torch.utils import gan_convert  # noqa: E402
from deepvision_tpu_torch.utils.flax_convert import (  # noqa: E402
    params_to_state_dict)
from deepvision_tpu_torch.utils.tf_checkpoint import crc32c_np  # noqa: E402
from test_keras_convert import seed_keras_weights  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_RTOL = 1e-4
N_BLOCKS = 2
L = tf.keras.layers


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dcgan():
    gen = tf.keras.Sequential([
        L.Input((100,)), L.Dense(7 * 7 * 256, use_bias=False),
        L.BatchNormalization(), L.LeakyReLU(0.3), L.Reshape((7, 7, 256)),
        L.Conv2DTranspose(128, 5, strides=1, padding="same", use_bias=False),
        L.BatchNormalization(), L.LeakyReLU(0.3),
        L.Conv2DTranspose(64, 5, strides=2, padding="same", use_bias=False),
        L.BatchNormalization(), L.LeakyReLU(0.3),
        L.Conv2DTranspose(1, 5, strides=2, padding="same", use_bias=False,
                          activation="tanh")])
    disc = tf.keras.Sequential([
        L.Input((28, 28, 1)), L.Conv2D(64, 5, strides=2, padding="same"),
        L.LeakyReLU(0.3), L.Dropout(0.3),
        L.Conv2D(128, 5, strides=2, padding="same"), L.LeakyReLU(0.3),
        L.Dropout(0.3), L.Flatten(), L.Dense(1)])
    return gen, disc


class ResNetBlock(L.Layer):
    """`CycleGAN/tensorflow/models.py:17-38`'s block: its sublayers carry
    the names the checkpoint keys on."""

    def __init__(self, features, **kwargs):
        super().__init__(**kwargs)
        self.conv1 = L.Conv2D(features, 3, use_bias=False)
        self.bn1 = L.BatchNormalization()
        self.conv2 = L.Conv2D(features, 3, use_bias=False)
        self.bn2 = L.BatchNormalization()

    def call(self, x, training=False):
        pad = [[0, 0], [1, 1], [1, 1], [0, 0]]
        y = tf.pad(x, pad, mode="REFLECT")
        y = tf.nn.relu(self.bn1(self.conv1(y), training=training))
        y = tf.pad(y, pad, mode="REFLECT")
        return x + self.bn2(self.conv2(y), training=training)


def _cyclegan(n_blocks=N_BLOCKS, size=32):
    pad3 = [[0, 0], [3, 3], [3, 3], [0, 0]]
    x = inputs = L.Input((size, size, 3))
    x = L.Lambda(lambda t: tf.pad(t, pad3, mode="REFLECT"))(x)
    x = L.Conv2D(64, 7, use_bias=False)(x)
    x = L.ReLU()(L.BatchNormalization()(x))
    for f in (128, 256):
        x = L.Conv2D(f, 3, strides=2, padding="same", use_bias=False)(x)
        x = L.ReLU()(L.BatchNormalization()(x))
    for _ in range(n_blocks):
        x = ResNetBlock(256)(x)
    for f in (128, 64):
        x = L.Conv2DTranspose(f, 3, strides=2, padding="same",
                              use_bias=False)(x)
        x = L.ReLU()(L.BatchNormalization()(x))
    x = L.Lambda(lambda t: tf.pad(t, pad3, mode="REFLECT"))(x)
    gen = tf.keras.Model(inputs, L.Conv2D(3, 7, activation="tanh")(x))
    y = inputs = L.Input((size, size, 3))
    y = L.LeakyReLU(0.2)(L.Conv2D(64, 4, strides=2, padding="same")(y))
    for f, s in ((128, 2), (256, 2), (512, 1)):
        y = L.Conv2D(f, 4, strides=s, padding="same", use_bias=False)(y)
        y = L.LeakyReLU(0.2)(L.BatchNormalization()(y))
    disc = tf.keras.Model(inputs, L.Conv2D(1, 4, padding="same")(y))
    return gen, disc


def _tf21_names(path):
    """The bundle at `path` again, under TF 2.1's keys: each object's
    weighted layers numbered `layer_with_weights-N` in order, `_kernel`
    written `kernel`."""
    reader = tf.train.load_checkpoint(path)
    key = re.compile(r"^(?P<obj>[a-z_0-9]+)/(_functional/)?_operations/"
                     r"(?P<op>\d+)/(?P<rest>.+)$")
    ops, tensors = {}, {}
    for name in reader.get_variable_to_shape_map():
        m = key.match(name)
        if m:
            ops.setdefault(m["obj"], set()).add(int(m["op"]))
    for name in reader.get_variable_to_shape_map():
        m = key.match(name)
        if not m:
            continue
        n = sorted(ops[m["obj"]]).index(int(m["op"]))
        rest = m["rest"].replace("_kernel/", "kernel/")
        tensors[f"{m['obj']}/layer_with_weights-{n}/{rest}"] = \
            reader.get_tensor(name)
    for counter in ("epoch", "step"):
        tensors[f"{counter}/.ATTRIBUTES/VARIABLE_VALUE"] = reader.get_tensor(
            f"{counter}/.ATTRIBUTES/VARIABLE_VALUE")
    names = sorted(tensors)
    prefix = os.path.join(os.path.dirname(path), "tf21", "ckpt-1")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(tensors[n]) for n in names])
    return prefix


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The six networks seeded, saved by tf.train.Checkpoint with the
    `epoch` and `step` counters; {dialect: checkpoint path} and the
    Keras models."""
    gen, disc = _dcgan()
    cg_gen, cg_disc = _cyclegan()
    cg_gen2, cg_disc2 = _cyclegan()
    models = {"generator": gen, "discriminator": disc,
              "generator_a2b": cg_gen, "generator_b2a": cg_gen2,
              "discriminator_a": cg_disc, "discriminator_b": cg_disc2}
    for model in models.values():
        seed_keras_weights(model)
    root = tmp_path_factory.mktemp("reference")
    path = tf.train.Checkpoint(
        epoch=tf.Variable(7, dtype=tf.int64),
        step=tf.Variable(12, dtype=tf.int64), **models).save(
        str(root / "ck"))
    return {"keras3": path, "tf21": _tf21_names(path)}, models


def _same(got, want, where=""):
    assert isinstance(got, dict) and set(got) == set(want), where
    for key in want:
        if isinstance(want[key], dict):
            _same(got[key], want[key], f"{where}/{key}")
        else:
            assert got[key].dtype == np.asarray(want[key]).dtype, where
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{where}/{key}")


def _kw(obj):
    return {"n_blocks": N_BLOCKS} if obj.startswith("generator_") else {}


@pytest.mark.parametrize("dialect", ["keras3", "tf21"])
@pytest.mark.parametrize("obj", sorted(gan_convert.CONVERTERS))
def test_convert_object_equals_jax_array_for_array(reference, dialect, obj):
    path = reference[0][dialect]
    reader = gan_convert.open_reader(path)
    got = gan_convert.convert_object(reader, obj, **_kw(obj))
    want = jax_gan_convert.convert_object(path, obj, **_kw(obj))
    _same(got[0], want[0], f"{obj} params")
    _same(got[1], want[1], f"{obj} batch_stats")


NETWORKS = {
    "generator": (jax_gan.DCGANGenerator, port_gan.DCGANGenerator, (2, 100)),
    "discriminator": (jax_gan.DCGANDiscriminator,
                      port_gan.DCGANDiscriminator, (2, 28, 28, 1)),
    "generator_a2b": (lambda: jax_gan.CycleGANGenerator(n_blocks=N_BLOCKS),
                      lambda: port_gan.CycleGANGenerator(N_BLOCKS),
                      (1, 32, 32, 3)),
    "discriminator_a": (jax_gan.PatchGANDiscriminator,
                        port_gan.PatchGANDiscriminator, (1, 32, 32, 3)),
}


@pytest.mark.parametrize("obj", sorted(NETWORKS))
def test_imported_networks_equal_jax_apply(reference, obj):
    path = reference[0]["keras3"]
    jax_model, port_model, shape = NETWORKS[obj]
    params, stats = jax_gan_convert.convert_object(path, obj, **_kw(obj))
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    want = np.asarray(jax_model().apply(variables, jnp.asarray(x),
                                        train=False))
    module = port_model()
    got_params, got_stats = gan_convert.convert_object(
        gan_convert.open_reader(path), obj, **_kw(obj))
    module.load_state_dict(params_to_state_dict(got_params, module,
                                                got_stats or None),
                           strict=False)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    keras = reference[1][obj](x, training=False).numpy()
    for ref in (want, keras):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= OUT_RTOL * np.abs(ref).max()


def test_unknown_object_raises_jax_key_error(reference):
    path = reference[0]["keras3"]
    with pytest.raises(KeyError) as port:
        gan_convert.convert_object(gan_convert.open_reader(path), "nope")
    with pytest.raises(KeyError) as ref:
        jax_gan_convert.convert_object(path, "nope")
    assert str(port.value) == str(ref.value)
    assert "known:" in str(port.value)


def test_dcgan_import_resumes_at_its_step_and_feeds_the_entry_points(
        reference, tmp_path):
    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.gan import DCGANTrainer
    path, models = reference
    wd = str(tmp_path / "wd")
    got = tool.main(["--family", "dcgan", "--ckpt", path["tf21"],
                     "--workdir", wd, "--device", "cpu"])
    # the bundle holds both counters: `epoch` is read before `step`, as
    # the JAX tool reads them
    assert got == {"workdir": wd, "epoch": 7}
    trainer = DCGANTrainer(get_config("dcgan"), workdir=wd, device="cpu")
    try:
        assert trainer.resume(verify="strict") == 7
        z = np.random.RandomState(2).randn(2, 100).astype(np.float32)
        with torch.no_grad():
            ours = trainer.generator.eval()(torch.from_numpy(z)).numpy()
    finally:
        trainer.close()
    theirs = models["generator"](z, training=False).numpy()
    assert np.abs(ours - theirs).max() <= 1e-4
    out = str(tmp_path / "grid.png")
    runpy.run_path(os.path.join(REPO, "DCGAN", "torch", "inference.py"),
                   run_name="not_main")["main"](
        ["--workdir", wd, "--num", "4", "--out", out, "--device", "cpu"])
    assert os.path.exists(out)
    main = runpy.run_path(os.path.join(REPO, "DCGAN", "torch", "main.py"),
                          run_name="not_main")["main"]
    trainer, metrics = main(["--synthetic", "--resume", "--epochs", "8",
                             "--steps-per-epoch", "1", "--batch-size", "2",
                             "--workdir", wd, "--device", "cpu"])
    assert trainer.start_epoch == 8 and np.isfinite(metrics["gen_loss"])


def test_a_wrong_n_blocks_names_the_blocks(reference, tmp_path):
    with pytest.raises(SystemExit, match=(
            r"generators: structure mismatch — no Flax leaf fills "
            r"\['a2b\.CycleGANResBlock_2\.BatchNorm_0\.bias'")):
        tool.main(["--family", "cyclegan", "--ckpt", reference[0]["keras3"],
                   "--workdir", str(tmp_path / "wd"), "--n-blocks", "3",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="error: no tf.train checkpoint"):
        tool.main(["--family", "cyclegan", "--ckpt", str(tmp_path),
                   "--device", "cpu"])


def test_a_full_cyclegan_import_feeds_its_inference(tmp_path):
    """9 blocks at full width from chip_smoke.py's writer (TF 2.1 names):
    the epoch counter, the weights, `CycleGAN/torch/inference.py`."""
    from PIL import Image
    rng = np.random.default_rng(3)
    tensors = {"epoch/.ATTRIBUTES/VARIABLE_VALUE": np.array(5, np.int64)}
    expected = {}
    with torch.device("meta"):
        image = torch.zeros((1, 32, 32, 3))
        for obj, module in (("generator_a2b", port_gan.CycleGANGenerator()),
                            ("discriminator_b",
                             port_gan.PatchGANDiscriminator())):
            got, want = chip_smoke.gan_reference_tensors(obj, module, image,
                                                         rng)
            tensors.update(got)
            expected[obj] = want
    # the other two networks are the same weights under their names
    for src, dst in (("generator_a2b", "generator_b2a"),
                     ("discriminator_b", "discriminator_a")):
        tensors.update({k.replace(src, dst, 1): v for k, v in tensors.items()
                        if k.startswith(src + "/")})
    ref = tmp_path / "ref"
    ref.mkdir()
    chip_smoke.write_tf_checkpoint(str(ref / "ckpt-5"), tensors, crc32c_np)
    wd = str(tmp_path / "wd")
    assert tool.main(["--family", "cyclegan", "--ckpt", str(ref),
                      "--workdir", wd, "--device", "cpu"])["epoch"] == 5
    src = str(tmp_path / "in.png")
    Image.fromarray(np.full((20, 24, 3), 90, np.uint8)).save(src)
    runpy.run_path(os.path.join(REPO, "CycleGAN", "torch", "inference.py"),
                   run_name="not_main")["main"](
        ["--workdir", wd, "--image-size", "32", "--direction", "b2a",
         "--out-dir", str(tmp_path / "out"), "--device", "cpu", src])
    assert Image.open(str(tmp_path / "out" / "in_b2a.png")).size == (64, 32)
    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.gan import CycleGANTrainer
    trainer = CycleGANTrainer(get_config("cyclegan"), workdir=wd,
                              device="cpu")
    try:
        assert trainer.resume(verify="strict") == 5
        for obj, prefix in (("generator_a2b", "b2a"),
                            ("discriminator_b", "a")):
            module = (trainer.generators if obj.startswith("generator")
                      else trainer.discriminators)[prefix]
            assert chip_smoke.unequal_leaves(module.state_dict(),
                                             expected[obj]) == []
    finally:
        trainer.close()
