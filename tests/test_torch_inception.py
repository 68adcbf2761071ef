"""Port Inception V1 / GoogLeNet and Inception V3
(deepvision_tpu_torch/models/inception.py) against the JAX package on the
CPU.

Weights are Flax variables of the shapes `init` gives, filled from numpy
(tests/test_torch_zoo_oracle.py) and carried over by the weight bridge;
inputs are seeded numpy. 10 classes; V1 at 96 px (its aux heads see a 1x1
pooled map), V3 at 107 px (the least at which its aux head exists), batch
8.

Bounds, relative to the largest value compared:
- f32 eval-mode logits: 1e-5 (summation order only; measured up to
  5.8e-7);
- f32 train mode: V1's every output has dropout on its path (masks cannot
  match JAX's bits), so only its updated BatchNorm statistics are held,
  at 1e-4 (measured 4.1e-5; the JAX package's own move by 4.2e-5 when
  only the order of the batch changes). V3's aux head has no dropout: its
  logits at 1e-3 and the statistics at 2e-4. Its aux path normalizes over
  8 values (a 1x1 map) and the last blocks over 32: the JAX package's own
  aux logits move by 3.5e-4 and its statistics by 9.7e-5 when only the
  order of the batch changes (the port's differ by 2.9e-4 and 5.9e-5);
- bf16 eval-mode logits: 1e-2. The JAX package's own bf16 logits differ
  from its f32 ones by 2.8e-3 (V1) and 2.1e-3 (V3) here; the port's from
  the JAX bf16 ones by up to 2.7e-3.
`test_casts_are_flax_s` pins each rounding of a ConvBN and the branch
order of the modules bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepvision_tpu.models import inception as jax_inception
from deepvision_tpu_torch.models import common, inception
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from deepvision_tpu_torch.utils.registry import MODELS
from test_torch_zoo_oracle import (bridge, check_engine, check_full_size,
                                   images, jax_apply, port_forward, rel_err,
                                   train_and_resume)

BATCH = 8
V1_SIZE, V3_SIZE = 96, 107
BF16_BOUND = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _v1(dtype: str = "float32", use_bn: bool = True):
    return (jax_inception.InceptionV1(num_classes=10, use_bn=use_bn,
                                      dtype=jnp.dtype(dtype)),
            inception.InceptionV1(10, use_bn=use_bn,
                                  dtype=getattr(torch, dtype),
                                  image_size=V1_SIZE))


def _v3(dtype: str = "float32", size: int = V3_SIZE):
    return (jax_inception.InceptionV3(num_classes=10,
                                      dtype=jnp.dtype(dtype)),
            inception.InceptionV3(10, dtype=getattr(torch, dtype),
                                  image_size=size))


def _stats_err(model, variables, new_stats) -> float:
    want = params_to_state_dict(variables["params"], model,
                                jax.device_get(new_stats))
    state = model.state_dict()
    names = [k for k in want if "running" in k]
    assert len(names) == 2 * sum(isinstance(m, common.BatchNorm)
                                 for m in model.modules())
    return max(rel_err(state[k].numpy(), want[k].numpy()) for k in names)


# -- forward parity -----------------------------------------------------------

@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "no_bn"])
def test_v1_eval_logits_match_jax(use_bn):
    jax_model, model = _v1(use_bn=use_bn)
    x = images(BATCH, V1_SIZE)
    variables = bridge(jax_model, model, x)
    want = np.asarray(jax_apply(jax_model, False)(variables, x))
    got = port_forward(model, x, train=False)
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    assert rel_err(got.numpy(), want) <= 1e-5


def test_v1_train_mode_statistics_match_jax():
    jax_model, model = _v1()
    x = images(BATCH, V1_SIZE)
    variables = bridge(jax_model, model, x)
    out, new = jax_apply(jax_model, True)(variables, x)
    got = port_forward(model, x, train=True)
    assert len(got) == len(out) == 3
    assert all(g.shape == (BATCH, 10) for g in got)
    assert _stats_err(model, variables, new["batch_stats"]) <= 1e-4


def test_v3_eval_logits_match_jax():
    jax_model, model = _v3()
    x = images(BATCH, V3_SIZE)
    variables = bridge(jax_model, model, x)
    want = np.asarray(jax_apply(jax_model, False)(variables, x))
    assert rel_err(port_forward(model, x, False).numpy(), want) <= 1e-5


def test_v3_train_mode_aux_logits_and_statistics_match_jax():
    jax_model, model = _v3()
    x = images(BATCH, V3_SIZE)
    variables = bridge(jax_model, model, x)
    (_, aux), new = jax_apply(jax_model, True)(variables, x)
    main, got_aux = port_forward(model, x, train=True)
    assert main.shape == got_aux.shape == (BATCH, 10)
    assert rel_err(got_aux.numpy(), np.asarray(aux)) <= 1e-3
    assert _stats_err(model, variables, new["batch_stats"]) <= 2e-4


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_bf16_eval_logits_match_jax(version):
    jax_model, model = _v1("bfloat16") if version == "v1" else _v3(
        "bfloat16")
    x = images(BATCH, V1_SIZE if version == "v1" else V3_SIZE)
    variables = bridge(jax_model, model, x)
    want = np.asarray(jax_apply(jax_model, False)(variables, x))
    assert rel_err(port_forward(model, x, False).numpy(), want) \
        <= BF16_BOUND


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_engine_serves_the_model_as_its_own_eval_forward(version):
    _, model = _v1("bfloat16") if version == "v1" else _v3("bfloat16")
    check_engine(model, V1_SIZE if version == "v1" else V3_SIZE)


def test_googlenet_is_inception_v1():
    assert MODELS.get("googlenet") is MODELS.get("inception_v1") \
        is inception.InceptionV1


def test_casts_are_flax_s():
    """bf16, bit for bit: a ConvBN convolves in bf16, normalizes in f32,
    applies ReLU in f32 and rounds once; an inception module concatenates
    y1, y2, y3 and the pool branch in that order; V3's InceptionC creates
    each split's (1, 3) conv before its (3, 1) and concatenates them in
    that order."""
    model = inception.InceptionV1(10, image_size=V1_SIZE).train()
    mod = model.mod3a
    seen = {}
    for name, m in mod.named_modules():
        if name:
            m.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(name, (i[0], o)))
    x = torch.randn(2, 192, 6, 6).bfloat16()
    with torch.no_grad():
        out = mod(x)
    for i in range(6):
        conv = seen[f"ConvBN_{i}.Conv_0"]
        bn = seen[f"ConvBN_{i}.BatchNorm_0"]
        assert conv[1].dtype == torch.bfloat16
        assert bn[1].dtype == torch.float32 and torch.equal(bn[0], conv[1])
        assert torch.equal(seen[f"ConvBN_{i}"][1], F.relu(bn[1]).bfloat16())
    y = [seen[f"ConvBN_{i}"][1] for i in (0, 2, 4, 5)]
    assert torch.equal(out, torch.cat(y, dim=1))
    assert torch.equal(seen["ConvBN_5"][0],
                       common.max_pool(x, 3, 1, "SAME"))
    block = inception.InceptionC(1280, torch.bfloat16, None)
    kernels = [c.layers[0].kernel_size for c in block.convs]
    assert kernels == [(1, 1), (1, 1), (1, 3), (3, 1), (1, 1), (3, 3),
                       (1, 3), (3, 1), (1, 1)]


# -- sizes: the aux kernel, the refusals, full size ---------------------------

def _jax_v3_aux_kernel(size: int):
    shapes = jax.eval_shape(lambda: jax_inception.InceptionV3(
        num_classes=10).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, 3)), train=True))
    return shapes["params"]["aux"]["ConvBN_1"]["Conv_0"]["kernel"].shape


@pytest.mark.parametrize("size,side", [(107, 1), (139, 1), (299, 5)])
def test_v3_aux_kernel_is_the_pooled_map(size, side):
    model = inception.InceptionV3(10, image_size=size)
    conv = model.aux.ConvBN_1.Conv_0
    assert conv.weight.shape == (768, 128, side, side)
    assert _jax_v3_aux_kernel(size) == (side, side, 128, 768)


def test_v3_refuses_train_mode_below_107_px_where_jax_divides_by_zero():
    with pytest.raises(ZeroDivisionError):
        _jax_v3_aux_kernel(99)
    _, model = _v3(size=99)
    assert model.aux_heads is None and not hasattr(model, "aux")
    x = torch.from_numpy(images(2, 99))
    model.eval()
    with torch.no_grad():
        assert model(x).shape == (2, 10)      # eval works, as in JAX
    model.train()
    with pytest.raises(ValueError, match="at least 107 px"):
        model(x, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="at least 75 px"):
        inception.InceptionV3(10, image_size=74)
    trunk = inception.InceptionV3(10, aux=False, image_size=75).train()
    with torch.no_grad():
        out = trunk(torch.from_numpy(images(2, 75)),
                    generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 10)


def test_v1_refuses_train_mode_where_its_aux_map_vanishes():
    model = inception.InceptionV1(10, image_size=64).train()
    assert model.aux_min_size == 65
    with pytest.raises(ValueError, match="at least 65 px"):
        model(torch.from_numpy(images(2, 64)),
              generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name,count", [("inception_v1", 13_385_816),
                                        ("inception_v3", 27_161_264)])
def test_full_size_counts_bridge_and_serving(name, count):
    engine = check_full_size(name, count)
    assert engine.model.head.weight.dtype == torch.float32


def test_entry_point_trains_saves_and_resumes(tmp_path, capsys):
    train_and_resume("Inception", "inception_v1", V1_SIZE, tmp_path, capsys)
