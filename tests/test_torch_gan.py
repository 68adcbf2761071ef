"""The port's GAN family (deepvision_tpu_torch/models/{common,gan}.py's
ConvTranspose, 1-D BatchNorm and reflection pad, models/gan.py,
core/{gan,eval_gan}.py, data/gan.py, utils/image_pool.py, the DCGAN and
CycleGAN entry points) against the JAX package on the CPU.

The same numpy inputs and weights (seeded) go through both; weights are
Flax variables of `init`'s shapes filled from numpy and carried over by the
weight bridge. The steps' noise, dropout masks and pool draws are the
port's own, so the parity steps take them from JAX: the DCGAN step gets
the noise JAX draws (fold_in(rng, step), split 4, the first), with dropout
off on both sides (the JAX step built on the discriminator's apply with
train=False, which only turns dropout off: it has no BatchNorm). The
gradients of a JAX step come from Adam's first moment (0.1 g after one
step). Each JAX oracle compiles once.

Bounds:
- ConvTranspose, BatchNorm, reflection pad: 1e-5 of the largest output
  (measured 7e-7); running statistics 1e-6;
- f32 forwards of the four networks, eval and train mode: 1e-5 of the
  largest output (measured 7e-6 for the train-mode CycleGAN generator);
- one DCGAN step and each CycleGAN phase: losses 1e-5 relative, gradients
  1e-3 of each leaf's largest, batch_stats 5e-5 (tests/test_torch_pose.py's
  bounds); a leaf whose gradient is near zero is held to 1e-3 of the
  network's largest. The CycleGAN generator phase's gradients are held to
  the exact (f64) ones instead: see its test;
- ImagePool, data: equal, pick for pick and bit for bit; Frechet: 1e-9
  relative; LeNet features: 1e-5 of the largest.
"""

import os
import runpy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.core import eval_gan as jax_eval_gan
from deepvision_tpu.core import gan as jax_gan
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.data import gan as jax_gan_data
from deepvision_tpu.models import gan as jax_models
from deepvision_tpu.models.lenet import LeNet5 as JaxLeNet5
from deepvision_tpu.utils.image_pool import ImagePool as JaxImagePool
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import eval_gan
from deepvision_tpu_torch.core import gan
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data import gan as gan_data
from deepvision_tpu_torch.models import gan as models
from deepvision_tpu_torch.models.common import (BatchNorm, ConvTranspose,
                                                Dropout, reflect_pad)
from deepvision_tpu_torch.models.lenet import LeNet5
from deepvision_tpu_torch.tools import gan_images
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from deepvision_tpu_torch.utils.image_pool import ImagePool
from test_torch_lenet import _write_idx
from test_torch_pose import float64_copy

# The port's steps update their states in place and donate nothing;
# jaxlint resolves the step factories by name to the JAX package's
# donating ones.
# jaxlint: disable-file=DON001

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def flax_variables(model, x, seed=0, init_kw=None):
    """(params, batch_stats) numpy trees of `model`'s shapes at `x` (its
    `init` called with `init_kw`, {"train": True} when None), filled from
    a seeded numpy stream (lecun-scaled kernels; biases, BatchNorm scales
    and statistics away from their init); batch_stats {} without
    BatchNorm."""
    if init_kw is None:
        init_kw = {"train": True}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), **init_kw))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = 1.0 + 0.2 * rs.rand(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        return v.astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled.get("batch_stats", {})


def _load(tm, params, stats):
    tm.load_state_dict(params_to_state_dict(params, tm, stats or None),
                       strict=False)
    return tm


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# -- the primitives -------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride,size", [
    (5, 1, 7), (5, 2, 7), (5, 2, 14), (3, 2, 16), (3, 2, 7), (3, 2, 9),
    (5, 2, 5)])
def test_conv_transpose_matches_flax(kernel, stride, size):
    """Every (kernel, stride) of the two GANs at their sizes and at odd
    ones, with a bias, on a non-square input."""
    m = fnn.ConvTranspose(4, (kernel, kernel), strides=(stride, stride),
                          padding="SAME")
    x = np.random.RandomState(size).randn(2, size, size + 1, 3).astype(
        np.float32)
    params, _ = flax_variables(m, x, init_kw={})
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    t = _load(ConvTranspose(3, 4, kernel, stride, use_bias=True), params, {})
    with torch.no_grad():
        got = t(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, size * stride,
                                       (size + 1) * stride, 4)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("shape", [(5, 12), (3, 4, 6, 5)], ids=["1d", "2d"])
def test_batch_norm_with_keras_constants_matches_flax(shape):
    """Flax BatchNorm(momentum 0.99, epsilon 1e-3) on (B, C) (DCGAN's
    Dense output) and on NHWC: the train output, the biased running
    update, then the eval output."""
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 3 + 1
    m = fnn.BatchNorm(momentum=0.99, epsilon=1e-3)
    params, stats = flax_variables(m, x, init_kw={
        "use_running_average": False})
    v = {"params": params, "batch_stats": stats}
    want, mut = m.apply(v, jnp.asarray(x), use_running_average=False,
                        mutable=["batch_stats"])
    bn = BatchNorm(shape[-1], eps=1e-3, momentum=0.99)
    assert bn.momentum == pytest.approx(0.01)
    _load(bn, params, stats)
    t = torch.from_numpy(x if x.ndim == 2 else x.transpose(0, 3, 1, 2))
    back = (lambda y: y) if x.ndim == 2 else (
        lambda y: y.permute(0, 2, 3, 1))
    with torch.no_grad():
        got = back(bn.train()(t))
    assert _rel(got.numpy(), want) <= 1e-5
    new = jax.device_get(mut["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"],
                               rtol=1e-6, atol=1e-6)
    want = m.apply({"params": params, "batch_stats": new}, jnp.asarray(x),
                   use_running_average=True)
    with torch.no_grad():
        got = back(bn.eval()(t))
    assert _rel(got.numpy(), want) <= 1e-5


def test_reflect_pad_matches_jnp():
    x = np.random.RandomState(2).randn(2, 7, 9, 3).astype(np.float32)
    for pad in (1, 3):
        want = np.asarray(jax_models._reflect_pad(jnp.asarray(x), pad))
        got = reflect_pad(torch.from_numpy(x).permute(0, 3, 1, 2), pad)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_dropout_keeps_its_contract():
    """Rate 0.3: keeps 70% (over 60,000 draws the rate's std is 1.9e-3,
    0.01 is over 5 std), scales the kept by 1 / 0.7, draws its mask from
    the generator (the same seed, the same mask), and is the identity in
    eval mode; train mode without a generator raises."""
    drop = Dropout(0.3)
    x = torch.ones(60, 1000) * 2.0
    a = drop.train()(x, torch.Generator().manual_seed(5))
    b = drop(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(a[kept], torch.tensor(2.0 / 0.7))
    assert not torch.equal(a, drop(x, torch.Generator().manual_seed(6)))
    assert torch.equal(drop.eval()(x, None), x)
    with pytest.raises(ValueError, match="generator"):
        drop.train()(x, None)


# -- the four networks ----------------------------------------------------------

NETS = {
    "dcgan_generator": (lambda: jax_models.DCGANGenerator(),
                        lambda: models.DCGANGenerator(), (3, 100)),
    "dcgan_discriminator": (lambda: jax_models.DCGANDiscriminator(),
                            lambda: models.DCGANDiscriminator(),
                            (3, 28, 28, 1)),
    "cyclegan_generator": (lambda: jax_models.CycleGANGenerator(n_blocks=2),
                           lambda: models.CycleGANGenerator(2),
                           (2, 32, 32, 3)),
    "patchgan_discriminator": (lambda: jax_models.PatchGANDiscriminator(),
                               lambda: models.PatchGANDiscriminator(),
                               (2, 32, 32, 3)),
}


@pytest.mark.parametrize("name", list(NETS))
def test_network_forwards_match_jax(name):
    """Eval mode, then train mode (batch statistics, and the running ones
    after it; the DCGAN discriminator has no BatchNorm and its train mode
    is dropout: held with dropout off, which is its eval forward)."""
    make_jax, make_port, shape = NETS[name]
    jm, tm = make_jax(), make_port()
    x = np.random.RandomState(3).uniform(-1, 1, shape).astype(np.float32)
    params, stats = flax_variables(jm, x)
    _load(tm, params, stats)
    v = {"params": params, **({"batch_stats": stats} if stats else {})}
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert _rel(got.numpy(), jm.apply(v, jnp.asarray(x))) <= 1e-5
    if not stats:
        return
    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= 1e-5
    new = params_to_state_dict(params, tm, jax.device_get(
        mut["batch_stats"]))
    sd = tm.state_dict()
    for k in (k for k in new if "running" in k):
        torch.testing.assert_close(sd[k], new[k], rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("name,shape", [
    ("dcgan_generator", (1, 100)), ("dcgan_discriminator", (1, 28, 28, 1)),
    ("cyclegan_generator", (1, 256, 256, 3)),
    ("patchgan_discriminator", (1, 256, 256, 3))])
def test_full_size_trees_carry_over_leaf_for_leaf(name, shape):
    """The full-size JAX networks (CycleGAN's 9 blocks at 256 px), their
    variables from `jax.eval_shape` and numpy fills, onto the port's:
    every leaf lands once with its shape."""
    jm = {"dcgan_generator": jax_models.DCGANGenerator(),
          "dcgan_discriminator": jax_models.DCGANDiscriminator(),
          "cyclegan_generator": jax_models.CycleGANGenerator(),
          "patchgan_discriminator": jax_models.PatchGANDiscriminator()}[name]
    tm = {"dcgan_generator": models.DCGANGenerator,
          "dcgan_discriminator": models.DCGANDiscriminator,
          "cyclegan_generator": models.CycleGANGenerator,
          "patchgan_discriminator": models.PatchGANDiscriminator}[name]()
    params, stats = flax_variables(jm, np.zeros(shape, np.float32))
    sd = params_to_state_dict(params, tm, stats or None)
    assert set(sd) == {k for k in tm.state_dict()
                       if not k.endswith("num_batches_tracked")}
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))


# -- steps ----------------------------------------------------------------------

def _adam_grads(state):
    mu = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")][0].mu
    return jax.tree_util.tree_map(lambda a: np.asarray(a) / 0.1,
                                  jax.device_get(mu))


def _port_state(model):
    cfg = get_config("dcgan")
    return TrainState(model, build_optimizer(model.parameters(),
                                             cfg.optimizer, cfg.schedule,
                                             1, 1))


def _check_grads(model, want, zero_scale=False):
    named = dict(model.named_parameters())
    assert set(named) == {k for k in want if "running" not in k}
    top = max(want[n].abs().max().item() for n in named)
    for name, p in named.items():
        scale = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-3 * max(scale, 1e-3 * top), (name, err, scale)


def _check_stats(model, want):
    sd = model.state_dict()
    running = [k for k in want if "running" in k]
    assert running
    for k in running:
        torch.testing.assert_close(sd[k], want[k], rtol=5e-5, atol=5e-5)


def test_dcgan_step_matches_jax():
    """One step on numpy-filled weights: both losses, both networks'
    gradients against the pre-update parameters, the generator's
    BatchNorm statistics from its one train-mode pass."""
    jg, jd = jax_models.DCGANGenerator(), jax_models.DCGANDiscriminator()
    rs = np.random.RandomState(4)
    images = rs.uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
    gp, gs = flax_variables(jg, np.zeros((4, 100), np.float32), seed=1)
    dp, _ = flax_variables(jd, images, seed=2)
    gst = JaxTrainState.create(jg.apply, gp, optax.adam(1.0), gs)
    dst = JaxTrainState.create(jd.apply, dp, optax.adam(1.0))

    def disc_apply_det(variables, x, train=False, rngs=None):
        return jd.apply(variables, x, train=False)

    rng = jax.random.PRNGKey(7)
    step = jax_gan.make_dcgan_train_step(jg.apply, disc_apply_det, 100,
                                         donate=False)
    new_g, new_d, m = step(gst, dst, jnp.asarray(images), rng)
    noise = np.array(jax.random.normal(jax.random.split(
        jax.random.fold_in(rng, 0), 4)[0], (4, 100)))

    gen = _load(models.DCGANGenerator(), gp, gs)
    disc = models.DCGANDiscriminator()
    _load(disc, dp, {})
    for d in disc.dropouts:
        d.rate = 0.0
    g_state, d_state = _port_state(gen), _port_state(disc)
    got = gan.make_dcgan_train_step(100)(
        g_state, d_state, torch.from_numpy(images), torch.from_numpy(noise))
    for k in ("gen_loss", "disc_loss"):
        assert float(got[k]) == pytest.approx(float(m[k]), rel=1e-5), k
    _check_grads(gen, params_to_state_dict(_adam_grads(new_g), gen,
                                           jax.device_get(new_g.batch_stats)))
    _check_grads(disc, params_to_state_dict(_adam_grads(new_d), disc))
    _check_stats(gen, params_to_state_dict(
        gp, gen, jax.device_get(new_g.batch_stats)))
    assert g_state.step == d_state.step == 1


@pytest.fixture(scope="module")
def cyclegan_oracle():
    """Both JAX CycleGAN phases once (2 blocks, 32 px, batch 2) on
    numpy-filled generators and discriminators: losses, gradients, and the
    generators' and discriminators' BatchNorm statistics after the
    generator phase."""
    jg, jd = jax_models.CycleGANGenerator(n_blocks=2), \
        jax_models.PatchGANDiscriminator()
    rs = np.random.RandomState(5)
    arrays = [rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
              for _ in range(4)]
    gv = {k: flax_variables(jg, arrays[0], seed=i)
          for i, k in enumerate(("a2b", "b2a"))}
    dv = {k: flax_variables(jd, arrays[0], seed=2 + i)
          for i, k in enumerate(("a", "b"))}
    gst = JaxTrainState.create(jg.apply, {k: v[0] for k, v in gv.items()},
                               optax.adam(1.0),
                               {k: v[1] for k, v in gv.items()})
    dst = JaxTrainState.create(jd.apply, {k: v[0] for k, v in dv.items()},
                               optax.adam(1.0),
                               {k: v[1] for k, v in dv.items()})
    gstep = jax_gan.make_cyclegan_generator_step(jg.apply, jd.apply)
    dstep = jax_gan.make_cyclegan_discriminator_step(jd.apply)
    new_g, dbs, fa, fb, gm = gstep(gst, dst, *map(jnp.asarray, arrays[:2]))
    new_d, dm = dstep(dst, *map(jnp.asarray, arrays))
    return {"arrays": arrays, "gv": gv, "dv": dv,
            "gen": {"metrics": jax.device_get(gm),
                    "grads": _adam_grads(new_g),
                    "stats": jax.device_get(new_g.batch_stats),
                    "disc_stats": jax.device_get(dbs),
                    "fakes": (np.asarray(fa), np.asarray(fb))},
            "disc": {"metrics": jax.device_get(dm),
                     "grads": _adam_grads(new_d),
                     "stats": jax.device_get(new_d.batch_stats)}}


def _cyclegan_pairs(oracle):
    gens = torch.nn.ModuleDict({k: _load(models.CycleGANGenerator(2), *v)
                                for k, v in oracle["gv"].items()})
    discs = torch.nn.ModuleDict({k: _load(models.PatchGANDiscriminator(), *v)
                                 for k, v in oracle["dv"].items()})
    return gens, discs


def _tree(per_net, pair, stats=None):
    return {f"{k}.{n}": t for k, net in pair.items()
            for n, t in params_to_state_dict(
                per_net[k], net, None if stats is None else stats[k]).items()}


def _cyclegan_generator_phase(oracle, dtype):
    """The port's generator phase on the oracle's weights and reals in
    `dtype`: (metrics, fakes, generators, discriminators)."""
    gens, discs = _cyclegan_pairs(oracle)
    if dtype == torch.float64:
        gens, discs = (float64_copy(m) for m in (gens, discs))
    g_state, d_state = _port_state(gens), _port_state(discs)
    m, fa, fb = gan.make_cyclegan_generator_step()(
        g_state, d_state, *(torch.from_numpy(a).to(dtype)
                            for a in oracle["arrays"][:2]))
    return m, (fa, fb), gens, discs


def test_cyclegan_generator_phase_matches_jax(cyclegan_oracle):
    """Losses, the fakes, both generators' BatchNorm statistics (six
    train-mode passes in JAX's order) and the discriminators' (they
    advance in their train-mode passes of this phase), and the
    generators' gradients: the port's and JAX's f32 gradients each within
    2e-2 of each leaf's largest of the exact (f64) ones, where both lie
    1.1e-2 away (measured): two passes through each generator and a
    train-mode BatchNorm after every conv make f32 ill-conditioned here."""
    want = cyclegan_oracle["gen"]
    m, fakes, gens, discs = _cyclegan_generator_phase(cyclegan_oracle,
                                                      torch.float32)
    assert set(m) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert float(m[k]) == pytest.approx(float(v), rel=1e-5), k
    for got, ref in zip(fakes, want["fakes"]):
        assert _rel(got.numpy(), ref) <= 1e-5
    params = {k: v[0] for k, v in cyclegan_oracle["gv"].items()}
    _check_stats(gens, _tree(params, gens, want["stats"]))
    dparams = {k: v[0] for k, v in cyclegan_oracle["dv"].items()}
    _check_stats(discs, _tree(dparams, discs, want["disc_stats"]))
    assert all(p.grad is None for p in discs.parameters())
    _, _, exact, _ = _cyclegan_generator_phase(cyclegan_oracle,
                                               torch.float64)
    exact = {n: p.grad for n, p in exact.named_parameters()}
    jax_grads = _tree(want["grads"], gens, want["stats"])
    for name, p in gens.named_parameters():
        scale = exact[name].abs().max().item()
        for got in (p.grad, jax_grads[name]):
            assert (got.double() - exact[name]).abs().max().item() \
                <= 2e-2 * scale, name


def test_cyclegan_discriminator_phase_matches_jax(cyclegan_oracle):
    want = cyclegan_oracle["disc"]
    _, discs = _cyclegan_pairs(cyclegan_oracle)
    d_state = _port_state(discs)
    m = gan.make_cyclegan_discriminator_step()(
        d_state, *map(torch.from_numpy, cyclegan_oracle["arrays"]))
    for k, v in want["metrics"].items():
        assert float(m[k]) == pytest.approx(float(v), rel=1e-5), k
    _check_grads(discs, _tree(want["grads"], discs, want["stats"]))
    dparams = {k: v[0] for k, v in cyclegan_oracle["dv"].items()}
    _check_stats(discs, _tree(dparams, discs, want["stats"]))


def test_losses_match_jax():
    rs = np.random.RandomState(6)
    a, b = (rs.randn(3, 5).astype(np.float32) for _ in range(2))
    for target in (0.0, 1.0):
        assert float(gan._bce_logits(torch.from_numpy(a), target)) == \
            pytest.approx(float(jax_gan._bce_logits(jnp.asarray(a), target)),
                          rel=1e-6)
        assert float(gan._mse(torch.from_numpy(a), target)) == \
            pytest.approx(float(jax_gan._mse(jnp.asarray(a), target)),
                          rel=1e-6)
    assert float(gan._mae(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(float(jax_gan._mae(jnp.asarray(a), jnp.asarray(b))),
                      rel=1e-6)
    assert (gan.LAMBDA_CYCLE, gan.LAMBDA_ID) == (jax_gan.LAMBDA_CYCLE,
                                                 jax_gan.LAMBDA_ID)


# -- the pool, evaluation, data -------------------------------------------------

@pytest.mark.parametrize("size", [0, 3, 50])
def test_image_pool_picks_as_jax(size):
    rs = np.random.RandomState(7)
    ours, theirs = ImagePool(size, seed=11), JaxImagePool(size, seed=11)
    for _ in range(12):
        batch = rs.rand(4, 2, 2, 3).astype(np.float32)
        np.testing.assert_array_equal(ours.query(batch), theirs.query(batch))
    assert len(ours.pool) == len(theirs.pool) == min(size, 48)


def test_frechet_matches_jax():
    rs = np.random.RandomState(8)
    a = rs.randn(200, 6)
    b = rs.randn(150, 6) * 1.3 + 0.4
    want = jax_eval_gan.frechet_from_features(a, b)
    assert eval_gan.frechet_from_features(a, b) == pytest.approx(want,
                                                                 rel=1e-9)
    assert want > 0.1
    for x, y in zip(eval_gan.gaussian_stats(a),
                    jax_eval_gan.gaussian_stats(a)):
        np.testing.assert_array_equal(x, y)
    m = rs.randn(6, 6)
    np.testing.assert_allclose(eval_gan._psd_sqrt(m @ m.T),
                               jax_eval_gan._psd_sqrt(m @ m.T), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="at least 2 samples"):
        eval_gan.gaussian_stats(a[:1])


def test_lenet_features_match_jax():
    """The F6 embedding of 28 px images padded with -1 to 32 px, on the
    same LeNet-5 weights; 36 px images are refused."""
    jm = JaxLeNet5(num_classes=10)
    x = np.random.RandomState(9).uniform(-1, 1, (3, 28, 28, 1)).astype(
        np.float32)
    params, _ = flax_variables(jm, np.zeros((1, 32, 32, 1), np.float32))
    want = jax_eval_gan.lenet_feature_fn(params)(x)
    model = _load(LeNet5(), params, {})
    got = eval_gan.lenet_feature_fn(model)(x)
    assert got.shape == want.shape == (3, 84)
    assert _rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="36px"):
        eval_gan.lenet_feature_fn(model)(np.zeros((1, 36, 36, 1)))


def test_synthetic_batches_equal_jax(tmp_path):
    for a, b in zip(gan_data.synthetic_mnist_batches(3, steps=2, seed=4),
                    jax_gan_data.synthetic_mnist_batches(3, steps=2, seed=4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(gan_data.synthetic_two_domain_batches(2, 16, 2, seed=5),
                    jax_gan_data.synthetic_two_domain_batches(2, 16, 2,
                                                              seed=5)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # the once refused two-domain records: JAX's eval batches, the pixels
    # within the decode gap (PIL against TensorFlow's default IDCT, 7
    # levels, through the bilinear resize)
    import tensorflow as tf
    from torch_records_fixtures import write_cyclegan
    tf.config.set_visible_devices([], "GPU")
    root = os.path.join(write_cyclegan(str(tmp_path)), "toy")
    paths = [os.path.join(root, f"train{d}.tfrecord") for d in "AB"]
    got = list(gan_data.build_two_domain_dataset(
        *paths, batch_size=2, image_size=16, training=False))
    want = list(jax_gan_data.build_two_domain_dataset(
        *paths, batch_size=2, image_size=16, training=False)
        .as_numpy_iterator())
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert float(np.abs(x.numpy() - y).max()) <= 7 / 127.5


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_mnist_gan_batches_equal_jax(tmp_path, gz):
    rs = np.random.RandomState(10)
    images = rs.randint(0, 256, (11, 28, 28)).astype(np.uint8)
    _write_idx(tmp_path, "train", images,
               rs.randint(0, 10, 11).astype(np.uint8), gz)
    for drop in (True, False):
        got = list(gan_data.mnist_gan_batches(str(tmp_path), 4, seed=3,
                                              drop_remainder=drop))
        want = list(jax_gan_data.mnist_gan_batches(str(tmp_path), 4, seed=3,
                                                   drop_remainder=drop))
        assert len(got) == len(want) == (2 if drop else 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert got[0].min() >= -1.0 and got[0].max() <= 1.0


# -- trainers and entry points --------------------------------------------------

def test_dcgan_trainer_checkpoints_both_networks_and_resumes(tmp_path):
    cfg = get_config("dcgan").replace(batch_size=4, total_epochs=2)
    trainer = gan.DCGANTrainer(cfg, workdir=str(tmp_path), device="cpu")
    metrics = trainer.fit(lambda e: gan_data.synthetic_mnist_batches(
        4, steps=2, seed=e))
    assert np.isfinite(metrics["gen_loss"]) and len(
        trainer.last_epoch_steps) == 2
    assert trainer.ckpt.epochs() == [2]       # every 2 epochs and the last
    fresh = gan.DCGANTrainer(cfg, workdir=str(tmp_path), device="cpu")
    assert fresh.resume() == 2 and fresh.start_epoch == 3
    for a, b in zip(trainer._payload().values(), fresh._payload().values()):
        for k in a["model"]:
            assert torch.equal(a["model"][k], b["model"][k]), k
        assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4
        assert a["step"] == b["step"] == 4
    samples = fresh.generate(5, seed=1)
    assert samples.shape == (5, 28, 28, 1) and np.abs(samples).max() <= 1
    np.testing.assert_array_equal(samples, fresh.generate(5, seed=1))
    trainer.close()
    fresh.close()


def test_cyclegan_trainer_runs_both_phases_through_the_pools(tmp_path):
    cfg = get_config("cyclegan").replace(batch_size=2, total_epochs=1)
    trainer = gan.CycleGANTrainer(cfg, workdir=str(tmp_path), device="cpu",
                                  n_blocks=1,
                                  steps_per_epoch=2)
    assert (trainer.pool_a2b.rng.get_state()[1][:4].tolist()
            == JaxImagePool(50, seed=cfg.seed).rng.get_state()[1][:4]
            .tolist())
    assert (trainer.pool_b2a.rng.get_state()[1][:4].tolist()
            == JaxImagePool(50, seed=cfg.seed + 1).rng.get_state()[1][:4]
            .tolist())
    metrics = trainer.fit(lambda e: gan_data.synthetic_two_domain_batches(
        2, 16, steps=2, seed=e))
    assert set(metrics) >= {"loss_gen_total", "loss_dis_total"}
    assert len(trainer.pool_a2b.pool) == len(trainer.pool_b2a.pool) == 4
    fresh = gan.CycleGANTrainer(cfg, workdir=str(tmp_path), device="cpu",
                                n_blocks=1)
    assert fresh.resume() == 1
    x = np.random.RandomState(0).uniform(-1, 1, (2, 16, 16, 3))
    for d in ("a2b", "b2a"):
        np.testing.assert_array_equal(trainer.translate(x, d),
                                      fresh.translate(x, d))
    trainer.close()
    fresh.close()


def test_linear_decay_is_anchored_to_the_epoch_length(tmp_path):
    """cyclegan's LR holds to epoch 100, then falls linearly to 0 at 200,
    in updates of `steps_per_epoch`."""
    cfg = get_config("cyclegan")
    trainer = gan.CycleGANTrainer(cfg, workdir=str(tmp_path), device="cpu",
                                  n_blocks=1,
                                  steps_per_epoch=3)
    sched = trainer.gen_state.optimizer.schedule
    assert sched(299) == pytest.approx(2e-4)
    assert sched(450) == pytest.approx(1e-4)
    assert sched(600) == 0.0
    trainer.close()


def test_adversarial_trainers_refuse_a_process_group(monkeypatch, tmp_path):
    from deepvision_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="ROADMAP A6"):
        gan.DCGANTrainer(get_config("dcgan"), workdir=str(tmp_path),
                         device="cpu")


def test_a_nonfinite_epoch_halts_with_the_resume_flag(tmp_path):
    from deepvision_tpu_torch.core.trainer import TrainingDivergedError
    cfg = get_config("dcgan").replace(batch_size=2)
    trainer = gan.DCGANTrainer(cfg, workdir=str(tmp_path), device="cpu")
    with pytest.raises(TrainingDivergedError, match="no checkpoint"):
        trainer.fit(lambda e: iter([np.full((2, 28, 28, 1), np.nan,
                                            np.float32)]))
    trainer.close()


def test_dcgan_entry_points(tmp_path, capsys):
    main = runpy.run_path(os.path.join(REPO, "DCGAN", "torch", "main.py"),
                          run_name="not_main")
    with pytest.raises(SystemExit):
        main["main"](["--recover-on-divergence", "-1", "--synthetic"])
    assert "must be >= 0" in capsys.readouterr().err
    wd = str(tmp_path / "wd")
    trainer, metrics = main["main"](
        ["--synthetic", "--steps-per-epoch", "1", "--epochs", "1",
         "--batch-size", "2", "--device", "cpu", "--workdir", wd,
         "--recover-on-divergence", "1"])
    assert np.isfinite(metrics["gen_loss"])
    assert trainer.config.recover_on_divergence == 1
    out = str(tmp_path / "grid.png")
    runpy.run_path(os.path.join(REPO, "DCGAN", "torch", "inference.py"),
                   run_name="not_main")["main"](
        ["--workdir", wd, "--num", "5", "--out", out, "--device", "cpu"])
    from PIL import Image
    assert Image.open(out).size == (84, 84)


def test_cyclegan_entry_points(tmp_path, capsys):
    train = runpy.run_path(os.path.join(REPO, "CycleGAN", "torch",
                                        "train.py"), run_name="not_main")
    with pytest.raises(SystemExit):
        train["main"](["--device", "cpu"])
    assert "--dataset is required" in capsys.readouterr().err
    # the once refused two-domain records: an epoch is every zipped batch
    import tensorflow as tf
    from torch_records_fixtures import write_cyclegan
    tf.config.set_visible_devices([], "GPU")
    records = write_cyclegan(str(tmp_path / "records"))
    trainer, metrics = train["main"](
        ["--dataset", "toy", "--tfrecords-dir", records, "--image-size",
         "16", "--batch-size", "2", "--epochs", "1", "--device", "cpu",
         "--workdir", str(tmp_path / "rec_wd")])
    assert len(trainer.last_epoch_steps) == 2     # min(5, 4) // 2
    assert np.isfinite(metrics["loss_gen_total"])
    assert "Total batches per epoch: 2" in capsys.readouterr().out
    wd = str(tmp_path / "wd")
    trainer, metrics = train["main"](
        ["--synthetic", "--image-size", "16",
         "--batch-size", "2", "--steps-per-epoch", "1", "--epochs", "1",
         "--device", "cpu", "--workdir", wd])
    assert trainer.last_epoch_steps and np.isfinite(metrics["loss_gen_total"])
    from PIL import Image
    src = str(tmp_path / "in.png")
    Image.fromarray(np.zeros((20, 24, 3), np.uint8)).save(src)
    runpy.run_path(os.path.join(REPO, "CycleGAN", "torch", "inference.py"),
                   run_name="not_main")["main"](
        ["--workdir", wd, "--image-size", "16",
         "--out-dir", str(tmp_path / "out"), "--device", "cpu", src])
    assert Image.open(str(tmp_path / "out" / "in_a2b.png")).size == (32, 16)


def test_image_helpers_and_the_named_pil_error(monkeypatch):
    """The grid and the pair as the JAX scripts compute them; without PIL
    the inference scripts raise a named error."""
    imgs = np.random.RandomState(11).uniform(-1.2, 1.2, (5, 4, 4, 1))
    grid = gan_images.tile_grid(imgs)
    assert grid.shape == (12, 12) and grid.dtype == np.uint8
    np.testing.assert_array_equal(
        grid[4:8, 0:4], (imgs[3, ..., 0] * 127.5 + 127.5).clip(0, 255)
        .astype(np.uint8))
    assert not grid[8:, 4:].any()
    src, dst = imgs[0].repeat(3, -1), imgs[1].repeat(3, -1)
    np.testing.assert_array_equal(
        gan_images.side_by_side(src, dst),
        ((np.concatenate([src, dst], 1) + 1.0) * 127.5).clip(0, 255)
        .astype(np.uint8))
    import sys
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        gan_images.load_pil()
