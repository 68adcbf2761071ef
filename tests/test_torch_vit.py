"""Port ViT (deepvision_tpu_torch/models/vit.py) against the JAX ViT on the
CPU, on weights made by Flax `init` and carried over by the weight bridge
(deepvision_tpu_torch/utils/flax_convert.py).

Bounds: f32 1e-4 on logits of unit scale — the two differ only in
summation order; bf16 5e-2 — both round activations to bf16 after every
projection, but their GEMMs sum in different orders, so a bf16 ulp (0.4%)
flips here and there and compounds over the two blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core.config import OptimizerConfig as jax_opt_config
from deepvision_tpu.core.config import ScheduleConfig as jax_sched_config
from deepvision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deepvision_tpu.models.vit import ViT as JaxViT
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.config import ScheduleConfig
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.models.vit import ViT
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict

SMALL = dict(num_classes=10, patch_size=8, embed_dim=64, depth=2,
             num_heads=2, mlp_dim=128)
BOUND = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flax_params(dtype, x, seed=0):
    model = JaxViT(**SMALL, attention_impl="interpret",
                   dtype=getattr(jnp, dtype))
    params = jax.device_get(
        model.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    return model, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_flax_on_bridged_weights(dtype):
    x = np.random.RandomState(1).rand(3, 32, 32, 3).astype(np.float32) * 2 - 1
    jax_model, params = _flax_params(dtype, x)
    # make the zero-initialized leaves (biases, cls token) carry signal so
    # a bridge that dropped or misplaced one could not pass
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rs.randn(*np.shape(a)).astype(
            np.float32), params)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    model = ViT(**SMALL, dtype=getattr(torch, dtype), image_size=32).eval()
    model.load_state_dict(params_to_state_dict(params, model))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert np.abs(got.numpy() - want).max() <= BOUND[dtype]


def test_bridge_maps_each_leaf_once_with_the_layout_rules():
    x = np.zeros((1, 32, 32, 3), np.float32)
    _, params = _flax_params("float32", x)
    model = ViT(**SMALL, image_size=32)
    sd = params_to_state_dict(params, model)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        sd["blocks.1.attn.query.weight"].numpy(),
        params["block1"]["attn"]["query"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["patch_embed.weight"].numpy(),
        params["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["norm.weight"].numpy(),
                                  params["norm"]["scale"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_raises_on_a_missing_extra_or_misshapen_leaf(fault):
    x = np.zeros((1, 32, 32, 3), np.float32)
    _, params = _flax_params("float32", x)
    params = jax.tree_util.tree_map(np.asarray, params)
    if fault == "missing":
        del params["block0"]["ln_mlp"]["scale"]
    elif fault == "extra":
        params["block0"]["mlp_in"]["gate"] = np.zeros(128, np.float32)
    else:
        params["head"]["bias"] = np.zeros(11, np.float32)
    with pytest.raises((KeyError, ValueError)):
        params_to_state_dict(params, ViT(**SMALL, image_size=32))


# fields of the JAX configs that no ported path reads yet (the mesh's
# model and spatial axes; the on-disk input pipelines' settings)
NOT_CARRIED = {
    "TrainConfig": {"model_parallel", "spatial_backend",
                    "spatial_parallel"},
    "OptimizerConfig": set(), "ScheduleConfig": set(),
    "DataConfig": {"num_parallel_calls", "shuffle_buffer"},
}


@pytest.mark.parametrize("name", ["vit_tiny", "vit_small", "lenet5",
                                  "lenet5_digits", "resnet34", "resnet50",
                                  "resnet101", "resnet152", "resnet50v2",
                                  "resnet50_tpu", "alexnet1", "alexnet2",
                                  "vgg16", "vgg19", "inception_v1",
                                  "inception_v3", "mobilenet_v1",
                                  "shufflenet_v1", "hourglass104",
                                  "centernet", "objects_as_points",
                                  "centernet_digits", "unet_resnet50",
                                  "unet_synthetic", "unet_digits", "dcgan",
                                  "cyclegan"])
def test_configs_equal_the_jax_package(name):
    """Every field the port's dataclasses carry equals the JAX config's —
    the optimizer, schedule and data configs field by field — and the JAX
    fields the port does not carry are exactly NOT_CARRIED."""
    ours, theirs = get_config(name), jax_get_config(name)

    def compare(a, b, where):
        cls = type(a).__name__
        ours_f = {f.name for f in dataclasses.fields(a)}
        theirs_f = {f.name for f in dataclasses.fields(b)}
        assert theirs_f - ours_f == NOT_CARRIED[cls], cls
        assert ours_f <= theirs_f, cls
        for f in sorted(ours_f):
            va, vb = getattr(a, f), getattr(b, f)
            if dataclasses.is_dataclass(va):
                compare(va, vb, f"{where}.{f}")
            else:
                assert va == vb, f"{where}.{f}: {va!r} != {vb!r}"

    compare(ours, theirs, name)


def test_vit_small_adam_ignores_weight_decay_as_the_jax_chain_does():
    """vit_small sets adam with weight_decay 5e-2; the JAX chain adds no
    decayed weights for adam, so the update equals that of the same config
    with weight_decay 0, also in the port."""
    cfg = get_config("vit_small")
    assert cfg.optimizer.name == "adam" and cfg.optimizer.weight_decay > 0
    rs = np.random.RandomState(3)
    w0 = rs.randn(4, 3).astype(np.float32)
    grads = [rs.randn(4, 3).astype(np.float32) for _ in range(3)]
    results = []
    for wd in (cfg.optimizer.weight_decay, 0.0):
        opt_cfg = dataclasses.replace(cfg.optimizer, weight_decay=wd)
        tx = jax_build_optimizer(jax_opt_config(**dataclasses.asdict(
            opt_cfg)), jax_sched_config(), 10, 1)
        params = {"w": jnp.asarray(w0)}
        state = tx.init(params)
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = build_optimizer([p], opt_cfg, ScheduleConfig(), 10, 1)
        for g in grads:
            upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
            params = optax.apply_updates(params, upd)
            p.grad = torch.from_numpy(g.copy())
            opt.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["w"]), rtol=0,
                                   atol=1e-7)
        results.append(p.detach().clone())
    torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)


def test_seeded_init_is_reproducible_and_flax_shaped():
    a = ViT(**SMALL, image_size=32, generator=torch.Generator().manual_seed(0))
    b = ViT(**SMALL, image_size=32, generator=torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    assert torch.count_nonzero(a.cls_token) == 0
    w = a.blocks[0].mlp_in.weight            # lecun_normal, fan_in 64
    assert abs(w.std().item() - 64 ** -0.5) < 0.02
    assert w.abs().max().item() <= 2 * 64 ** -0.5 / 0.87962566103423978
