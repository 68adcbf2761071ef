"""Model export (deepvision_tpu_torch/core/export.py, tools/export.py,
CycleGAN/torch/convert.py, Hourglass/torch/main.py) against the JAX
package on the CPU.

The same seeded numpy weights go through both packages (Flax variables
filled from numpy, carried over by utils/flax_convert.py) and the same
numpy inputs through the JAX apply and the exported program.

Bounds:
- lenet5 (f32): the program against JAX's apply and against JAX's own
  SavedModel loaded by TensorFlow, 1e-5 (tests/test_export.py's bound);
- vit_tiny at 2 blocks, f32: 1e-4 (tests/test_torch_vit.py's f32 bound:
  the two differ only in summation order), JAX's attention through
  `attention(impl="interpret")`;
- the CycleGAN generator (1 block, 64 px) exported and rewritten against
  JAX's `rewrite_transposed_convs(apply)`: 1e-5 of the largest output
  (tests/test_torch_gan.py's bound for its eval forward);
- each rewritten generator against its un-rewritten self: rtol 1e-5,
  atol 1e-6 (tests/test_export.py::test_rewrite_transposed_convs_exact_
  dcgan's bounds);
- a program saved and loaded in a fresh process: bit for bit.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepvision_tpu.core import export as jax_export
from deepvision_tpu.models import gan as jax_gan_models
from deepvision_tpu.models.lenet import LeNet5 as JaxLeNet5
from deepvision_tpu.models.vit import ViT as JaxViT
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import export
from deepvision_tpu_torch.models import gan as gan_models
from deepvision_tpu_torch.models.lenet import LeNet5
from deepvision_tpu_torch.models.vit import ViT
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_gan import flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _load(module, params, stats=None):
    module.load_state_dict(params_to_state_dict(params, module, stats or None),
                           strict=False)
    return module.eval()


def _run(program, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return program.module()(torch.from_numpy(x)).numpy()


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the exported programs against the JAX package -------------------------

def test_lenet5_program_matches_jax_apply_and_its_saved_model(tmp_path):
    tf = pytest.importorskip("tensorflow")
    x = np.random.RandomState(0).rand(2, 32, 32, 1).astype(np.float32)
    jax_model = JaxLeNet5(num_classes=10)
    params, _ = flax_variables(jax_model, x, init_kw={})
    variables = {"params": params}

    def apply_fn(v, images):
        return jax_model.apply(v, images, train=False)

    want = np.asarray(apply_fn(variables, jnp.asarray(x)))
    path = str(tmp_path / "program")
    program = export.export_program(_load(LeNet5(num_classes=10), params),
                                    (32, 32, 1), path, batch_size=2,
                                    name="lenet5")
    got = _run(export.load_program(path), x)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_run(program, x), got, rtol=0, atol=0)

    saved = str(tmp_path / "saved_model")
    jax_export.export_saved_model(apply_fn, variables, (32, 32, 1), saved,
                                  batch_size=2)
    tf_out = tf.saved_model.load(saved).signatures["serving_default"](
        images=tf.constant(x))
    np.testing.assert_allclose(got, list(tf_out.values())[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_signature_names_the_static_nhwc_f32_input(tmp_path):
    path = str(tmp_path / "program")
    program = export.export_program(LeNet5(num_classes=10), (32, 32, 1),
                                    path, batch_size=3, name="lenet5")
    assert export.load_signature(path) == {
        "input": "images", "shape": [3, 32, 32, 1], "dtype": "float32",
        "config": "lenet5", "device": "cpu"}
    inputs = [n for n in program.graph.nodes if n.op == "placeholder"
              and n.name == "images"]
    assert len(inputs) == 1
    assert tuple(inputs[0].meta["val"].shape) == (3, 32, 32, 1)
    assert export.transposed_convs(program) == 0


def test_vit_tiny_program_holds_one_k1_node_per_block_and_matches_jax():
    kw = dict(get_config("vit_tiny").model_kwargs)
    kw.update(depth=2, attention_impl="interpret")
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    jax_model = JaxViT(num_classes=10, dtype=jnp.float32, **kw)
    params = jax.device_get(jax_model.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"])
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rs.randn(*np.shape(a)).astype(
            np.float32), params)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    kw["attention_impl"] = "auto"
    model = _load(ViT(num_classes=10, image_size=32, **kw), params)
    program = export.export_program(model, (32, 32, 3), batch_size=2)
    assert export.flash_attention_nodes(program) == 2
    got = _run(program, x)
    assert got.shape == (2, 10)
    assert np.abs(got - want).max() <= 1e-4


def test_cyclegan_generator_rewritten_matches_jax_rewrite():
    x = (np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
         * 2 - 1)
    jax_model = jax_gan_models.CycleGANGenerator(n_blocks=1)
    params, stats = flax_variables(jax_model, x, init_kw={"train": False})
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jax_export.rewrite_transposed_convs(
        lambda v, images: jax_model.apply(v, images, train=False))(
            variables, jnp.asarray(x)))
    model = _load(gan_models.CycleGANGenerator(n_blocks=1), params, stats)
    raw = torch.export.export(model, (torch.from_numpy(x),), strict=False)
    assert export.transposed_convs(raw) == 2
    program = export.export_program(model, (64, 64, 3))
    assert export.transposed_convs(program) == 0
    got = _run(program, x)
    assert got.shape == (1, 64, 64, 3)
    assert _rel(got, want) <= 1e-5
    with torch.no_grad():
        eager = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["export", "core_aten"])
def test_dcgan_generator_rewrite_is_exact(form):
    """The rewrite on the program as `torch.export` gives it
    (`conv_transpose2d` nodes) and on its core-ATen form
    (`convolution(transposed=True)` nodes)."""
    model = gan_models.DCGANGenerator(
        generator=torch.Generator().manual_seed(0)).eval()
    noise = torch.from_numpy(np.random.RandomState(0).randn(2, 100).astype(
        np.float32))
    program = torch.export.export(model, (noise,), strict=False)
    if form == "core_aten":
        program = program.run_decompositions()
    assert export.transposed_convs(program) == 3
    rewritten = export.rewrite_transposed_convs(program)
    assert export.transposed_convs(rewritten) == 0
    with torch.no_grad():
        want = model(noise).numpy()
        got = rewritten.module()(noise).numpy()
    assert got.shape == (2, 28, 28, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel,stride,padding,out_pad,groups,dilation", [
    (3, 2, 1, 1, 1, 1), (4, 2, 1, 0, 2, 1), (3, 3, 0, 2, 1, 2),
    (5, 1, 3, 0, 1, 1)])
def test_rewrite_matches_conv_transpose2d(kernel, stride, padding, out_pad,
                                          groups, dilation):
    """Padding, a padding past the kernel (a crop), output padding,
    groups and dilation, against torch's own transposed convolution."""
    rs = np.random.RandomState(kernel + stride)
    w = torch.from_numpy(rs.randn(4, 6 // groups, kernel, kernel).astype(
        np.float32))
    b = torch.from_numpy(rs.randn(6).astype(np.float32))

    class Up(torch.nn.Module):
        def forward(self, x):
            return F.conv_transpose2d(x, w, b, stride, padding, out_pad,
                                      groups, dilation)

    x = torch.from_numpy(rs.randn(2, 4, 7, 9).astype(np.float32))
    program = export.rewrite_transposed_convs(
        torch.export.export(Up(), (x,), strict=False))
    assert export.transposed_convs(program) == 0
    with torch.no_grad():
        np.testing.assert_allclose(program.module()(x).numpy(),
                                   Up()(x).numpy(), rtol=1e-5, atol=1e-6)


def test_program_reloads_bit_for_bit_in_a_fresh_process(tmp_path):
    """A fresh interpreter registers K1's operator through `load_program`
    and gives the saved program's answer bit for bit."""
    kw = dict(get_config("vit_tiny").model_kwargs, depth=2)
    model = ViT(num_classes=10, image_size=32, dtype=torch.float32,
                generator=torch.Generator().manual_seed(4), **kw)
    path = str(tmp_path / "program")
    program = export.export_program(model, (32, 32, 3), path, batch_size=2)
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from deepvision_tpu_torch.core.export import load_program\n"
        "p = load_program(sys.argv[1])\n"
        "x = torch.from_numpy(np.load(sys.argv[2]))\n"
        "with torch.no_grad():\n"
        "    np.save(sys.argv[3], p.module()(x).numpy())\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", code, path,
                    str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                   check=True, env=env, cwd=REPO, timeout=300)
    got = np.load(tmp_path / "y.npy")
    np.testing.assert_array_equal(got, _run(program, x))


# -- the tools: flags, restore, refusal -------------------------------------

class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parser captured")
        self.parser = parser


def jax_parser(monkeypatch, relpath: str) -> argparse.ArgumentParser:
    """The parser a JAX-side script builds in its `main`, captured at its
    `parse_args` (nothing after it runs)."""
    spec = importlib.util.spec_from_file_location(
        "jax_script_" + relpath.replace("/", "_").replace(".", "_"),
        os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(sys, "argv", [relpath])
    with pytest.raises(_Parsed) as got:
        mod.main()
    monkeypatch.undo()
    return got.value.parser


def port_script(relpath: str):
    spec = importlib.util.spec_from_file_location(
        "port_script_" + relpath.replace("/", "_").replace(".", "_"),
        os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(parser) -> dict:
    return {tuple(a.option_strings): (a.default, a.type, a.nargs,
                                      getattr(a, "choices", None))
            for a in parser._actions if a.option_strings
            and a.dest != "help"}


def _port_parser(relpath: str):
    if relpath.startswith("tools/"):
        from deepvision_tpu_torch.tools import export as export_tool
        from deepvision_tpu_torch.tools import import_torch_checkpoint
        return {"tools/export.py": export_tool,
                "tools/import_torch_checkpoint.py":
                    import_torch_checkpoint}[relpath].build_parser()
    return port_script(relpath.replace("/jax/", "/torch/")).build_parser()


@pytest.mark.parametrize("relpath,changed", [
    ("tools/export.py", {}),
    ("tools/import_torch_checkpoint.py", {}),
    ("CycleGAN/jax/convert.py", {("--output",): "<direction>.pt2"}),
    ("Hourglass/jax/main.py", {})])
def test_the_tools_take_the_jax_scripts_flags(monkeypatch, relpath,
                                              changed):
    """Every flag of the JAX script, with its default, type and choices;
    the port adds `--device`, the card by default, to each."""
    want = _flags(jax_parser(monkeypatch, relpath))
    got = _flags(_port_parser(relpath))
    extra = set(got) - set(want)
    assert extra == {("--device",)} and got[("--device",)][0] == "cuda"
    for flags, spec in want.items():
        if flags in changed:
            assert flags in got
            continue
        assert got[flags] == spec, flags


@pytest.fixture
def lenet_run(tmp_path):
    from deepvision_tpu_torch.cli import run_classification
    wd = str(tmp_path / "lenet_wd")
    run_classification("LeNet", ["lenet5"], argv=[
        "-m", "lenet5", "--synthetic", "--epochs", "1", "--batch-size", "16",
        "--steps-per-epoch", "2", "--workdir", wd, "--device", "cpu"])
    return wd


def test_export_tool_restores_the_run_as_the_engine_does(lenet_run,
                                                         tmp_path, capsys):
    from deepvision_tpu_torch.serve.engine import load_checkpoint_weights
    from deepvision_tpu_torch.tools import export as export_tool

    out = str(tmp_path / "exported")
    got = export_tool.main(["-m", "lenet5", "--workdir", lenet_run,
                            "--saved-model", out, "--batch-size", "4",
                            "--device", "cpu"])
    assert got["epoch"] == 1 and f"wrote {out}" in capsys.readouterr().out
    assert export.load_signature(out)["shape"] == [4, 32, 32, 1]
    model = load_checkpoint_weights("lenet5", lenet_run, verbose=False)[0]
    x = np.random.RandomState(6).rand(4, 32, 32, 1).astype(np.float32)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_run(export.load_program(out), x), want,
                               rtol=1e-6, atol=1e-6)


def test_export_tool_refusals(tmp_path):
    from deepvision_tpu_torch.tools import export as export_tool
    with pytest.raises(SystemExit, match="no checkpoint restorable"):
        export_tool.main(["-m", "lenet5", "--workdir",
                          str(tmp_path / "empty"), "--saved-model",
                          str(tmp_path / "x"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="adversarial"):
        export_tool.main(["-m", "cyclegan", "--workdir", str(tmp_path),
                          "--saved-model", str(tmp_path / "x"),
                          "--device", "cpu"])
    with pytest.raises(SystemExit):        # argparse's error: exit 2
        export_tool.main(["-m", "lenet5", "--device", "cpu"])


def test_hourglass_main_exports_the_best_epoch_to_a_url(tmp_path,
                                                        monkeypatch):
    """A one-step hourglass104 run at 64 px, resumed with `--checkpoint
    latest` and the epochs it has (nothing more trains), copied to a
    `memory://` destination file for file; output.txt names it; a
    protocol without its package is refused by name before training."""
    import fsspec

    from deepvision_tpu_torch.cli import run_pose
    from deepvision_tpu_torch.data.fs import RemotePathError

    wd = str(tmp_path / "hg_wd")
    run_pose("Hourglass", ["hourglass104"], argv=[
        "-m", "hourglass104", "--synthetic", "--epochs", "1",
        "--batch-size", "2", "--steps-per-epoch", "1", "--workdir", wd,
        "--device", "cpu"])
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    main = port_script("Hourglass/torch/main.py").main
    dst = main(["--epochs", "1", "--checkpoint", "latest", "--synthetic",
                "--batch_size", "2", "--workdir", wd, "--export-dir",
                "memory://hg-export", "--version", "0.0.2",
                "--device", "cpu"])
    assert dst == "memory://hg-export/hourglass-v0.0.2-epoch-1"
    src = os.path.join(wd, "ckpt", "1")
    mem = fsspec.filesystem("memory")
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as fp:
            assert mem.cat_file(f"/hg-export/hourglass-v0.0.2-epoch-1/"
                                f"{name}") == fp.read()
    assert len(mem.ls("/hg-export/hourglass-v0.0.2-epoch-1")) == len(
        os.listdir(src))
    assert open(tmp_path / "output.txt").read() == dst + "\n"
    monkeypatch.setitem(sys.modules, "gcsfs", None)
    with pytest.raises(RemotePathError, match="gcsfs"):
        main(["--epochs", "1", "--workdir", wd, "--export-dir",
              "gs://bucket/x", "--device", "cpu"])
