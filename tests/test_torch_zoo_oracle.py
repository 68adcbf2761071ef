"""Shared oracle of the zoo parity tests (tests/test_torch_alexnet_vgg.py,
test_torch_inception.py, test_torch_mobile.py): a JAX model's variables
from `jax.eval_shape` filled from numpy, carried onto the port's module by
the weight bridge, and the JAX forward compiled once per model and mode;
the engine's checks at a reduced and at the full size, and a family's
entry point run in this process."""

import copy
import functools
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flax_variables(model, x: np.ndarray, seed: int = 0):
    """(params, batch_stats) numpy trees of `model`'s train-mode shapes
    (batch_stats {} without BatchNorm), filled from a seeded numpy stream:
    lecun-scaled kernels, and biases, BatchNorm scales and statistics away
    from their init values, so a dropped or misplaced leaf shows."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=True))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = 1.0 + 0.2 * rs.rand(*shape)
        else:                           # bias, mean
            v = 0.1 * rs.randn(*shape)
        return v.astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled.get("batch_stats", {})


def bridge(jax_model, model: torch.nn.Module, x: np.ndarray, seed: int = 0):
    """Fill `jax_model`'s variables and load them into `model` (in place);
    returns the Flax variables dict."""
    params, stats = flax_variables(jax_model, x, seed)
    model.load_state_dict(params_to_state_dict(params, model, stats),
                          strict=False)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


@functools.lru_cache(maxsize=None)
def jax_apply(jax_model, train: bool):
    """The compiled forward: eval, or train mode without dropout's effect
    on the outputs compared (its rng is fixed) and the new statistics."""
    if train:
        return jax.jit(lambda v, x: jax_model.apply(
            v, x, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)}))
    return jax.jit(lambda v, x: jax_model.apply(v, x, train=False))


def rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def images(n: int, size: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def port_forward(model: torch.nn.Module, x: np.ndarray, train: bool,
                 seed: int = 0):
    model.train(train)
    with torch.no_grad():
        return model(torch.from_numpy(x),
                     generator=torch.Generator().manual_seed(seed))


def check_engine(model: torch.nn.Module, size: int) -> None:
    """`model` served by the engine on the CPU at buckets (1, 4): its
    `reference` of a batch of 3 equals the model's own eval forward (the
    weights cast once equal the weights cast per call) bit for bit, and
    the batch padded to the bucket of 4 answers the same within 1e-3 of
    the largest logit (another batch size may take another kernel)."""
    own = copy.deepcopy(model).eval()
    engine = PredictEngine(model, example_shape=(size, size, 3),
                           device="cpu", buckets=(1, 4), verbose=False)
    x = images(3, size, seed=5)
    ref = engine.reference(x)
    with torch.no_grad():
        want = own(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ref, want)
    got = engine.predict(x)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-3


def jax_full_size_shapes(name: str):
    """The JAX model of config `name` and its train-mode variable shapes
    at the config's image size (`jax.eval_shape`: no compile)."""
    from deepvision_tpu.configs import get_config as jax_get_config
    from deepvision_tpu.core.trainer import build_model_from_config
    jcfg = jax_get_config(name)
    jax_model, _ = build_model_from_config(jcfg)
    size = jcfg.data.image_size
    return jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, 3)), train=True))


def check_full_size(name: str, count: int) -> PredictEngine:
    """The config's model at full size, built once, by the engine: its
    parameter count equals the JAX model's, every Flax leaf (BatchNorm
    statistics included) bridges onto it with none left over, and a batch
    of 3 padded to the bucket of 4 answers what the exact batch of 3
    answers. Returns the engine."""
    shapes = jax_full_size_shapes(name)
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    engine = PredictEngine.from_config(name, device="cpu", buckets=(1, 4),
                                       verbose=False)
    model = engine.model
    assert want == count
    assert sum(p.numel() for p in model.parameters()) == count
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    sd = params_to_state_dict(zeros["params"], model,
                              zeros.get("batch_stats"))
    assert set(sd) == {k for k in model.state_dict()
                       if not k.endswith("num_batches_tracked")}
    x = images(3, engine.example_shape[0], seed=5)
    got = engine.predict(x)
    assert got.shape == (3, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, engine.reference(x), rtol=0,
                               atol=1e-2 * np.abs(got).max())
    return engine


def run_entry_point(family: str, argv, capsys) -> str:
    """`python <family>/torch/train.py <argv>` in this process (runpy),
    its standard output."""
    old = sys.argv
    sys.argv = [f"{family}/torch/train.py", *argv]
    try:
        runpy.run_path(os.path.join(REPO, family, "torch", "train.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def train_and_resume(family: str, model: str, size: int, workdir,
                     capsys) -> None:
    """2 synthetic steps on the CPU and a checkpoint, then `-c latest`
    resumed for a second epoch."""
    argv = ["-m", model, "--synthetic", "--device", "cpu", "--image-size",
            str(size), "--steps-per-epoch", "2", "--batch-size", "2",
            "--learning-rate", "1e-3", "--workdir", str(workdir)]
    first = run_entry_point(family, argv + ["--epochs", "1"], capsys)
    assert f"[{model}] epoch 1 step 2" in first and "done: best=" in first
    assert sorted(os.listdir(workdir / "ckpt")) == ["1", "metrics.json"]
    assert os.path.exists(workdir / "ckpt" / "1" / "integrity_manifest.json")
    second = run_entry_point(family, argv + ["--epochs", "2", "-c",
                                             "latest"], capsys)
    assert "resumed from epoch 1" in second
    assert "epoch 2 step 4" in second
    assert sorted(os.listdir(workdir / "ckpt")) == ["1", "2",
                                                    "metrics.json"]
    assert os.path.exists(workdir / "ckpt" / "2" / "integrity_manifest.json")
