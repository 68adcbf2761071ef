"""Port AlexNet and VGG (deepvision_tpu_torch/models/{alexnet,vgg}.py) and
the shared pieces they use (`lrn`, the Flax pools, the NHWC flatten)
against the JAX package on the CPU.

Weights are Flax variables of the shapes `init` gives (from
`jax.eval_shape`), filled from numpy (tests/test_torch_zoo_oracle.py) and
carried over by the weight bridge; the inputs are seeded numpy. The models have 10
classes; AlexNet runs at 67 px (63 px is the least whose last pool has an
output), VGG at 32 px (5 pools to 1x1), batch 4.

Bounds, relative to the largest output:
- the shared functions, f32: 1e-6 (LRN's window sum runs as a cumsum on
  both sides, in another order);
- f32 eval-mode logits: 1e-5 (only the convolutions' summation order
  differs; measured up to 1.4e-6);
- bf16 eval-mode logits: 1.5e-2. Each package rounds every layer's output
  to bf16 after differently ordered sums: the JAX package's own bf16
  logits differ from its f32 ones by 7.3e-3 (alexnet1), 4.5e-3
  (alexnet2), 2.6e-3 (vgg16) and 2.3e-3 (vgg19) at these sizes; the port's
  from the JAX package's bf16 ones by up to 4.2e-3.
Every output of these models in train mode has dropout on its path (masks
cannot match JAX's bits), so train mode is held to the dropout sites and
the generator instead. `test_casts_are_flax_s` pins each rounding of the
bf16 path bit for bit, which a bf16 bound at this size cannot see.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepvision_tpu.models import alexnet as jax_alexnet
from deepvision_tpu.models import vgg as jax_vgg
from deepvision_tpu.models.common import lrn as jax_lrn
from deepvision_tpu_torch.models import alexnet, common, vgg
from test_torch_zoo_oracle import (bridge, check_engine, check_full_size,
                                   images, jax_apply, port_forward, rel_err,
                                   run_entry_point, train_and_resume)

SIZE = {"alexnet1": 67, "alexnet2": 67, "vgg16": 32, "vgg19": 32}
BF16_BOUND = 1.5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(name: str, dtype: str):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    size = SIZE[name]
    if name.startswith("alexnet"):
        jcls = (jax_alexnet.AlexNetV1 if name == "alexnet1"
                else jax_alexnet.AlexNetV2)
        pcls = alexnet.AlexNetV1 if name == "alexnet1" else alexnet.AlexNetV2
        return (jcls(num_classes=10, dtype=jd),
                pcls(10, td, image_size=size))
    return (jax_vgg.VGG(depths=jax_vgg._DEPTHS[name], num_classes=10,
                        dtype=jd),
            vgg.VGG(vgg.DEPTHS[name], 10, td, image_size=size))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.float().permute(0, 2, 3, 1).numpy()


# -- the shared pieces --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", [{}, {"torch_size": 5},
                                  {"torch_size": 96}, {"torch_size": 64}],
                         ids=["paper", "torch_5", "torch_96", "torch_64"])
def test_lrn_matches_jax(form, dtype):
    x = images(2, 5, seed=3).repeat(32, axis=-1) * 4    # 96 channels
    x = x[..., :64] if form.get("torch_size") == 64 else x
    want = np.asarray(jax_lrn(jnp.asarray(x).astype(dtype), **form)
                      .astype(jnp.float32))
    got = common.lrn(_nchw(x).to(getattr(torch, dtype)), **form)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert rel_err(_nhwc(got), want) <= 1e-6
    else:
        # the same f32 arithmetic on the same bf16 input, rounded once
        assert rel_err(_nhwc(got), want) <= 2 ** -8


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("window", [2, 3])
def test_pools_match_flax(kind, padding, size, stride, window):
    x = images(2, size, seed=4)
    fn = fnn.max_pool if kind == "max" else fnn.avg_pool
    want = np.asarray(fn(jnp.asarray(x), (window, window),
                         strides=(stride, stride), padding=padding))
    port = common.max_pool if kind == "max" else common.avg_pool
    got = _nhwc(port(_nchw(x), window, stride, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_same_pools_pad_asymmetrically_at_stride_2_on_an_even_size():
    """XLA's SAME at stride 2 on 8 pads (0, 1): the max pool pads -inf (a
    negative input keeps its max), the average pool divides by the full
    window, zero padding counted."""
    x = -torch.ones(1, 1, 8, 8)
    assert common.max_pool(x, 3, 2, "SAME").eq(-1).all()
    avg = common.avg_pool(x, 3, 2, "SAME")
    assert avg[0, 0, 0, 0] == -1 and avg[0, 0, -1, -1] == pytest.approx(
        -4 / 9)
    assert common.out_size(8, 3, 2, "SAME") == avg.shape[-1] == 4


def test_flatten_is_nhwc_order():
    x = torch.arange(2 * 3 * 2 * 2.).view(2, 3, 2, 2)
    want = x.permute(0, 2, 3, 1).reshape(2, -1)
    assert torch.equal(common.flatten_nhwc(x), want)


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(SIZE))
def test_eval_logits_match_jax(name):
    jax_model, model = _models(name, "float32")
    x = images(4, SIZE[name])
    variables = bridge(jax_model, model, x)
    want = np.asarray(jax_apply(jax_model, False)(variables, x))
    got = port_forward(model, x, train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("name", list(SIZE))
def test_bf16_eval_logits_match_jax(name):
    jax_model, model = _models(name, "bfloat16")
    x = images(4, SIZE[name])
    variables = bridge(jax_model, model, x)
    want = np.asarray(jax_apply(jax_model, False)(variables, x))
    assert rel_err(port_forward(model, x, False).numpy(), want) \
        <= BF16_BOUND


@pytest.mark.parametrize("name", list(SIZE))
def test_engine_serves_the_model_as_its_own_eval_forward(name):
    _, model = _models(name, "bfloat16")
    check_engine(model, SIZE[name])
    assert model.Dense_0.weight.dtype == torch.bfloat16
    assert model.Dense_2.weight.dtype == torch.float32


@pytest.mark.parametrize("name", ["alexnet1", "vgg16"])
def test_dropout_sites_draw_from_the_generator(name):
    """Train mode differs from eval only through dropout (no BatchNorm):
    the same generator seed repeats the output, another changes it."""
    _, model = _models(name, "float32")
    x = images(2, SIZE[name])
    a, b = (port_forward(model, x, True, seed=0) for _ in range(2))
    c = port_forward(model, x, True, seed=1)
    e = port_forward(model, x, False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, e)
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(torch.from_numpy(x))


def test_casts_are_flax_s():
    """AlexNet V1's bf16 path, bit for bit: each conv and hidden dense
    rounds its product to bf16 and then adds its bf16 bias; ReLU runs in
    bf16; the LRN computes in f32 and rounds once; the head reads the bf16
    activations in f32."""
    model = alexnet.AlexNetV1(10, torch.bfloat16, image_size=67).eval()
    seen = {}
    for name, m in model.named_children():
        m.register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, (i[0], o)))
    x = torch.from_numpy(images(2, 67))
    with torch.no_grad():
        out = model(x)
    for name in [f"Conv_{i}" for i in range(5)] + ["Dense_0", "Dense_1"]:
        m, (i, o) = getattr(model, name), seen[name]
        assert i.dtype == o.dtype == torch.bfloat16, name
        w, b = m.weight.bfloat16(), m.bias.bfloat16()
        with torch.no_grad():
            if isinstance(m, common.Conv):
                want = F.conv2d(common._pad(i, m._pads(i)), w, None,
                                m.stride) + b[:, None, None]
            else:
                want = F.linear(i, w) + b
        assert torch.equal(o, want), name
    with torch.no_grad():
        c1 = seen["Conv_0"][1]
        want = common.max_pool(common.lrn(F.relu(c1), torch_size=96), 3, 2)
        assert torch.equal(seen["Conv_1"][0], want)
        # f32 inside, one rounding to bf16 at the end
        assert torch.equal(common.lrn(F.relu(c1), torch_size=96),
                           common.lrn(F.relu(c1).float(),
                                      torch_size=96).bfloat16())
        head_in = seen["Dense_2"][0]
        assert head_in.dtype == torch.bfloat16
        assert torch.equal(out, F.linear(head_in.float(),
                                         model.Dense_2.weight,
                                         model.Dense_2.bias))


# -- full size: parameter counts, the bridge, serving -------------------------

FULL = {"alexnet1": 62_378_344, "alexnet2": 61_838_248,
        "vgg16": 138_357_544, "vgg19": 143_667_240}


@pytest.mark.parametrize("name", list(FULL))
def test_full_size_counts_bridge_and_serving(name):
    engine = check_full_size(name, FULL[name])
    assert engine.model.Dense_0.weight.dtype == torch.bfloat16
    assert engine.model.Dense_2.weight.dtype == torch.float32


def test_alexnet_refuses_a_size_without_output():
    with pytest.raises(ValueError, match="at least 63 px"):
        alexnet.AlexNetV1(image_size=62)
    alexnet.AlexNetV2(10, image_size=63)
    with pytest.raises(ValueError, match="at least 32 px"):
        vgg.VGG(vgg.DEPTHS["vgg16"], image_size=31)


# -- the entry points ---------------------------------------------------------

@pytest.mark.parametrize("family,model,size", [("AlexNet", "alexnet2", 67),
                                               ("VGG", "vgg16", 32)])
def test_entry_point_trains_saves_and_resumes(family, model, size, tmp_path,
                                              capsys):
    train_and_resume(family, model, size, tmp_path, capsys)


def test_entry_point_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        run_entry_point("AlexNet", ["-m", "alexnet1", "--synthetic"], capsys)
