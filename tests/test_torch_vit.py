"""Port ViT (deepvision_tpu_torch/models/vit.py) against the JAX ViT on the
CPU, on weights made by Flax `init` and carried over by the weight bridge
(deepvision_tpu_torch/utils/flax_convert.py).

Bounds: f32 1e-4 on logits of unit scale — the two differ only in
summation order; bf16 5e-2 — both round activations to bf16 after every
projection, but their GEMMs sum in different orders, so a bf16 ulp (0.4%)
flips here and there and compounds over the two blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.models.vit import ViT as JaxViT
from deepvision_tpu_torch.configs import get_config
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


@pytest.mark.parametrize("name", ["vit_tiny", "vit_small"])
def test_configs_equal_the_jax_package(name):
    ours, theirs = get_config(name), jax_get_config(name)
    for field in ("name", "model", "family", "model_kwargs", "dtype", "seed"):
        assert getattr(ours, field) == getattr(theirs, field), field
    for field in ("image_size", "channels", "num_classes",
                  "normalize_on_device", "mean", "std"):
        assert getattr(ours.data, field) == getattr(theirs.data, field), field


def test_seeded_init_is_reproducible_and_flax_shaped():
    a = ViT(**SMALL, image_size=32, generator=torch.Generator().manual_seed(0))
    b = ViT(**SMALL, image_size=32, generator=torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    assert torch.count_nonzero(a.cls_token) == 0
    w = a.blocks[0].mlp_in.weight            # lecun_normal, fan_in 64
    assert abs(w.std().item() - 64 ** -0.5) < 0.02
    assert w.abs().max().item() <= 2 * 64 ** -0.5 / 0.87962566103423978
