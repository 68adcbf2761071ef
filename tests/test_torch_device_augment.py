"""Port device augmentation (deepvision_tpu_torch/data/device_augment.py)
against the JAX package on the CPU.

JAX's PRNG bits cannot be reproduced, so the port's transform is fed JAX's
own draws (`_crop_flip_draws` for the offsets and flips, `_factor` for the
jitter factors, from the keys JAX's train augment splits) and held against
JAX's train augment on the same uint8 images: f32 within 1e-4 (the
contrast and saturation means sum in another order; outputs are a few
units), bf16 within 2e-2 (one bf16 rounding of such values). The eval
augment is the same crop and normalization on both sides: 1e-6. The
port's own draws are checked for their ranges and rates, and the train
step's augment for repeating per (seed, step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.data import device_augment as jax_daug
from deepvision_tpu_torch.core.config import decode_image_size
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data import device_augment as daug

B, D, S = 6, 40, 32
BOUND = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _uint8(b=B, d=D, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, d, d, c)) \
        .astype(np.uint8)


def _jax_draws(rng, b, h, w, jitter, flip_prob=0.5) -> daug.TrainDraws:
    """The draws JAX's train augment makes from `rng`."""
    tops, lefts, flip, keys = jax_daug._crop_flip_draws(rng, b, h, w, S,
                                                        flip_prob)
    factors = [None if not s else
               torch.from_numpy(np.array(jax_daug._factor(k, s, b))
                                .reshape(b))
               for k, s in zip(keys, jitter)]
    return daug.TrainDraws(torch.from_numpy(np.array(tops)).long(),
                           torch.from_numpy(np.array(lefts)).long(),
                           torch.from_numpy(np.array(flip)), *factors)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jitter", [daug.DEFAULT_JITTER, (0.4, 0.0, 0.3),
                                    (0.0, 0.0, 0.0)],
                         ids=["default", "partial", "none"])
@pytest.mark.parametrize("channels", [3, 1])
def test_train_augment_matches_jax_on_its_draws(dtype, jitter, channels):
    images = _uint8(c=channels)
    mean = daug.channel_stats((0.485, 0.456, 0.406), channels)
    std = daug.channel_stats((0.229, 0.224, 0.225), channels)
    rng = jax.random.PRNGKey(7)
    augment = jax.jit(jax_daug.make_train_augment(
        S, mean=mean, std=std, jitter=jitter, compute_dtype=jnp.dtype(dtype)))
    want = np.asarray(augment(jnp.asarray(images), rng).astype(jnp.float32))
    draws = _jax_draws(rng, B, D, D, jitter)
    got = daug.apply_train_augment(torch.from_numpy(images), draws, S,
                                   mean=mean, std=std,
                                   compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, S, S, channels)
    assert draws.flip.any() and not draws.flip.all()
    assert np.abs(got.float().numpy() - want).max() <= BOUND[dtype]


def test_eval_augment_matches_jax():
    images = _uint8()
    want = np.asarray(jax_daug.make_eval_augment(S, compute_dtype=jnp.float32)(
        jnp.asarray(images)))
    got = daug.make_eval_augment(S, compute_dtype=torch.float32)(
        torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_channel_stats_and_decode_size_match_jax():
    for values, channels in (((0.1, 0.2, 0.3), 3), ((0.1, 0.2, 0.3), 1),
                             ((0.5,), 1)):
        assert daug.channel_stats(values, channels) == \
            jax_daug.channel_stats(values, channels)
    assert daug.DEFAULT_JITTER == jax_daug.DEFAULT_JITTER
    for size in (32, 224, 299, 1):
        assert decode_image_size(size) == jax_daug.decode_image_size(size)


def test_draws_keep_their_ranges_and_rates():
    """Offsets in [0, D - S] on each axis (a rectangle: the shorter axis
    clipped, as JAX's draws are), factors in [1 - s, 1 + s], and a flip
    rate of 0.5: over 4000 draws its std is 7.9e-3, 0.03 is over 3.8 std."""
    gen = torch.Generator().manual_seed(0)
    d = daug.draw_train_params(4000, 40, 36, S, gen, jitter=(0.2, 0.5, 0.0))
    assert d.tops.min() == 0 and d.tops.max() == 8
    assert d.lefts.min() == 0 and d.lefts.max() == 4
    for factor, s in ((d.brightness, 0.2), (d.contrast, 0.5)):
        assert factor.min() >= 1 - s and factor.max() <= 1 + s
        assert factor.min() < 1 - 0.9 * s and factor.max() > 1 + 0.9 * s
    assert d.saturation is None
    assert abs(d.flip.float().mean().item() - 0.5) < 0.03
    identity = daug.draw_train_params(8, S, S, S, gen)
    assert identity.tops.eq(0).all() and identity.lefts.eq(0).all()


def test_train_step_augment_repeats_per_seed_and_step():
    """The train step draws from the state's generator of (seed, step) on
    the `augment` stream: the same step repeats, another step or seed
    draws otherwise, and the dropout stream is another."""
    augment = daug.make_train_augment(S, compute_dtype=torch.float32)
    state = TrainState(torch.nn.Linear(1, 1), None, seed=1)
    images = torch.from_numpy(_uint8())

    def run(step, seed=1, stream="augment"):
        state.step, state.seed = step, seed
        return augment(images, state.step_generator(stream))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), run(3, seed=2))
    assert not torch.equal(run(3), run(3, stream=""))
