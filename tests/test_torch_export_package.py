"""AOTInductor packages on the CPU (deepvision_tpu_torch/core/export.py's
`compile_package`, `load_package`; `--tflite` of
deepvision_tpu_torch/tools/export.py; CycleGAN/torch/convert.py) against
the JAX package. Two compiles, each tens of seconds of C++ on the CPU,
each of a saved run whose weights are seeded Flax variables carried over
by utils/flax_convert.py:

- vit_tiny (bf16, 4 blocks) through the export tool: the package calls
  K1's operator through the proxy executor, counted by its CPU
  implementation (the plain version): 4 calls a run, none inlined; its
  answer within 2e-2 of the largest logit of the program's (the package
  fuses the bf16 elementwise work in f32 where the program rounds after
  every op; measured 8.2e-3) and within 5e-2 of JAX's apply through
  `attention(impl="interpret")` (tests/test_torch_vit.py's bf16 bound;
  measured 8.1e-3, the program 1.2e-2);
- a CycleGAN generator (9 blocks, 32 px) through convert.py: no
  transposed convolution in the kept program, no K1 call; the package
  within 1e-4 of the largest value of the eager generator (f32; measured
  4.3e-6) and of JAX's `rewrite_transposed_convs(apply)` (measured
  3.8e-6).

Without a compile: a package that records fewer K1 calls than its
program makes is refused by name, and a `$CXX` that cannot link OpenMP
is passed over for the next compiler (none that can: refused by name).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._inductor

from deepvision_tpu.core import export as jax_export
from deepvision_tpu.models import gan as jax_gan_models
from deepvision_tpu.models.vit import ViT as JaxViT
from deepvision_tpu_torch.configs import get_config, trainer_class_for_config
from deepvision_tpu_torch.core import export
from deepvision_tpu_torch.ops import attention as attention_ops
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_export import port_script
from test_torch_gan import flax_variables


@pytest.fixture
def counted_k1(monkeypatch):
    """The calls of K1's CPU implementation, as a kernel counts its
    launches."""
    torch.set_num_threads(1)
    calls = {"n": 0}
    plain = attention_ops.flash_attention_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_ops, "flash_attention_reference", counted)
    return calls


def _saved_run(name, root, params):
    """Epoch 1 of `name` in `root`, its weights the Flax `params`."""
    tr = trainer_class_for_config(name)(get_config(name), device="cpu",
                                        workdir=root)
    try:
        tr.init_state()
        tr.model.load_state_dict(params_to_state_dict(params, tr.model))
        tr.ckpt.save(1, tr.state.state_dict(),
                     host_state={"best_metric": 0.0})
    finally:
        tr.close()
    return root


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1.0))


def test_vit_package_calls_k1_through_the_proxy_executor(counted_k1,
                                                         tmp_path):
    from deepvision_tpu_torch.tools import export as export_tool

    kw = dict(get_config("vit_tiny").model_kwargs,
              attention_impl="interpret")
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    jax_model = JaxViT(num_classes=10, dtype=jnp.bfloat16, **kw)
    params = jax.device_get(jax_model.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"])
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rs.randn(*np.shape(a)).astype(
            np.float32), params)
    jax_want = jax_model.apply({"params": params}, jnp.asarray(x))
    wd = _saved_run("vit_tiny", str(tmp_path / "wd"), params)
    program_dir, package = str(tmp_path / "program"), str(
        tmp_path / "vit_tiny.tflite")
    export_tool.main(["-m", "vit_tiny", "--workdir", wd, "--saved-model",
                      program_dir, "--tflite", package, "--batch-size", "2",
                      "--device", "cpu"])
    depth = get_config("vit_tiny").model_kwargs["depth"]
    program = export.load_program(program_dir)
    assert export.flash_attention_nodes(program) == depth
    assert export.package_operators(package).count(
        export.FLASH_ATTENTION_TARGET) == depth
    runner = export.load_package(package)
    counted_k1["n"] = 0
    with torch.no_grad():
        got = runner(torch.from_numpy(x))
        assert counted_k1["n"] == depth
        want = program.module()(torch.from_numpy(x))
    assert got.shape == (2, 10) and got.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 2e-2, err
    assert _rel(got.numpy(), jax_want) <= 5e-2


def test_cyclegan_convert_writes_a_package_without_transposed_convs(
        counted_k1, tmp_path, capsys):
    from deepvision_tpu_torch.core.gan import CycleGANTrainer

    x = (np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
         * 2 - 1)
    jax_model = jax_gan_models.CycleGANGenerator(n_blocks=9)
    params, stats = flax_variables(jax_model, x, init_kw={"train": False})
    jax_want = jax_export.rewrite_transposed_convs(
        lambda v, images: jax_model.apply(v, images, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    wd = str(tmp_path / "cg")
    tr = CycleGANTrainer(get_config("cyclegan"), workdir=wd, device="cpu")
    try:
        gen = tr.generators["b2a"]
        gen.load_state_dict(params_to_state_dict(params, gen, stats),
                            strict=False)
        tr.ckpt.save(1, {"gen": tr.gen_state.state_dict(),
                         "disc": tr.disc_state.state_dict()},
                     host_state={})
    finally:
        tr.close()
    out, kept = str(tmp_path / "b2a.pt2"), str(tmp_path / "program")
    port_script("CycleGAN/torch/convert.py").main([
        "--workdir", wd, "--direction", "b2a", "--image-size", "32",
        "--output", out, "--saved-model-dir", kept, "--no-optimize",
        "--device", "cpu"])
    assert f"wrote {out}" in capsys.readouterr().out
    program = export.load_program(kept)
    assert export.transposed_convs(program) == 0
    assert export.package_operators(out) == []
    tr = CycleGANTrainer(get_config("cyclegan"), workdir=wd, device="cpu")
    try:
        assert tr.resume() == 1
        with torch.no_grad():
            want = tr.generators["b2a"].eval()(torch.from_numpy(x))
    finally:
        tr.close()
    counted_k1["n"] = 0
    with torch.no_grad():
        got = export.load_package(out)(torch.from_numpy(x))
    assert counted_k1["n"] == 0
    assert got.shape == (1, 32, 32, 3)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    assert _rel(got.numpy(), jax_want) <= 1e-4


def test_missing_proxy_call_is_refused_by_name(monkeypatch, tmp_path):
    """`compile_package` refuses a package whose record of its proxy
    calls lacks a K1 call that the program makes (the record read as
    empty here), instead of writing it."""
    from deepvision_tpu_torch.models.vit import ViT

    calls = []
    monkeypatch.setattr(export, "package_operators",
                        lambda path: calls.append(path) or [])
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package",
                        lambda program, package_path, **kw: open(
                            package_path, "wb").close() or package_path)
    model = ViT(num_classes=10, patch_size=8, embed_dim=24, depth=1,
                num_heads=3, mlp_dim=48, image_size=16)
    program = export.export_program(model, (16, 16, 3))
    out = str(tmp_path / "vit.pt2")
    with pytest.raises(export.ExportError, match="deepvision.flash_"):
        export.compile_package(program, out)
    assert calls and not os.path.exists(out)
    assert os.listdir(tmp_path) == []


def test_package_compiler_passes_over_a_cxx_without_openmp(monkeypatch,
                                                          tmp_path):
    """A `$CXX` that cannot link `-fopenmp` (a gcc without its
    `libgomp.spec`) is passed over for the next compiler; with none that
    links, the export is refused by name."""
    broken = tmp_path / "broken-g++"
    broken.write_text("#!/bin/sh\necho \"cannot read spec file "
                      "'libgomp.spec'\" >&2\nexit 1\n")
    broken.chmod(0o755)
    monkeypatch.setenv("CXX", str(broken))
    export.package_compiler.cache_clear()
    try:
        assert export.package_compiler() == "g++"
        monkeypatch.setenv("PATH", str(tmp_path))
        export.package_compiler.cache_clear()
        with pytest.raises(export.ExportError, match="libgomp.spec"):
            export.package_compiler()
    finally:
        export.package_compiler.cache_clear()
