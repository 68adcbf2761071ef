"""The port's LR schedules and optimizer chain (deepvision_tpu_torch/core/
{schedules,optim}.py) against the JAX package's optax ones on the CPU.

Schedules: every schedule at the warmup edge, mid-decay and the end, with
fractional updates per epoch, within 1e-6 of the base LR (optax computes
in f32, the port in f64: near the end of a cosine, where the LR is small,
f32's rounding of the cosine is the whole difference).

Optimizers: each chain of `build_optimizer` runs 3 updates on a small
parameter tree (a dense kernel, a bias, a conv kernel) from the same seeded
gradients in both packages, under a warmup + cosine schedule, and the
parameters agree within 1e-6 absolute at f32 (values of unit scale, a few
f32 roundings per update: torch's fused update formulas round at other
places than optax's). The gradients sit away from 0, so Adam's first step,
about lr * sign(g), is settled.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deepvision_tpu.core.config import ScheduleConfig as JaxScheduleConfig
from deepvision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deepvision_tpu.core.optim import set_lr_scale as jax_set_lr_scale
from deepvision_tpu.core.schedules import build_schedule as jax_schedule
from deepvision_tpu_torch.core.config import OptimizerConfig, ScheduleConfig
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.schedules import build_schedule

SHAPES = {"dense": (4, 3), "bias": (3,), "conv": (2, 2, 3, 4)}
SCHED = dict(name="cosine", warmup_epochs=1, min_lr=1e-3)
STEPS_PER_EPOCH, EPOCHS = 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name,kw,spe,epochs", [
    ("cosine", dict(warmup_epochs=5), 3, 90),
    ("cosine", dict(warmup_epochs=1.5, min_lr=1e-4), 2.5, 8),
    ("cosine", {}, 4, 5),
    ("linear_decay", dict(decay_start_epoch=3), 2, 8),
    ("linear_decay", dict(decay_start_epoch=3, warmup_epochs=2), 2.5, 8),
    ("step", dict(boundaries_epochs=(2, 4), warmup_epochs=3), 2, 8),
    ("constant", dict(warmup_epochs=2), 1.5, 4),
    ("plateau", dict(warmup_epochs=1), 3, 4),
], ids=lambda v: str(v))
def test_schedules_match_optax(name, kw, spe, epochs):
    """Counts 0 to past the end: the warmup edge (the base schedule's
    boundaries stay at their absolute steps), mid-decay and the floor."""
    ref = jax_schedule(JaxScheduleConfig(name=name, **kw), 0.1, spe, epochs)
    port = build_schedule(ScheduleConfig(name=name, **kw), 0.1, spe, epochs)
    total = int(spe * epochs)
    for count in sorted({0, 1, 2, int(spe * kw.get("warmup_epochs", 0)),
                         total // 2, total - 1, total, total + 3,
                         *range(0, total + 2, max(1, total // 17))}):
        assert port(count) == pytest.approx(float(ref(count)), rel=0,
                                            abs=1e-6 * 0.1), count


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="unknown schedule"):
        build_schedule(ScheduleConfig(name="exp"), 0.1, 2, 2)
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer([torch.nn.Parameter(torch.zeros(2))],
                        OptimizerConfig(name="lamb"), ScheduleConfig(), 2, 2)
    with pytest.raises(ValueError, match="accum_steps"):
        build_optimizer([torch.nn.Parameter(torch.zeros(2))],
                        OptimizerConfig(accum_steps=0), ScheduleConfig(), 2,
                        2)


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(n, seed=7):
    """n gradient trees, each element at least 0.05 away from 0."""
    out = []
    for i in range(n):
        g = _tree(seed + i)
        out.append({k: np.where(v >= 0, v + 0.05, v - 0.05).astype(np.float32)
                    for k, v in g.items()})
    return out


def _run_jax(opt_cfg, grads, scale_at=None):
    tx = jax_build_optimizer(
        JaxOptimizerConfig(**dataclasses.asdict(opt_cfg)),
        JaxScheduleConfig(**SCHED), STEPS_PER_EPOCH, EPOCHS)
    params = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    state = tx.init(params)
    for i, g in enumerate(grads):
        if i == scale_at:
            state = jax_set_lr_scale(state, 0.5)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
    return {k: np.asarray(v) for k, v in params.items()}


def _port_optimizer(opt_cfg):
    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in _tree(0).items()}
    opt = build_optimizer(list(params.values()), opt_cfg,
                          ScheduleConfig(**SCHED), STEPS_PER_EPOCH, EPOCHS)
    return params, opt


def _feed(params, opt, grads, scale_at=None, start=0):
    for i, g in enumerate(grads, start):
        if i == scale_at:
            opt.set_lr_scale(0.5)
        opt.zero_grad()
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()


CASES = {
    "sgd_wd": OptimizerConfig(name="sgd", learning_rate=0.1, momentum=0.0,
                              weight_decay=1e-2),
    "momentum_nesterov_wd": OptimizerConfig(
        name="momentum", learning_rate=0.1, momentum=0.9, nesterov=True,
        weight_decay=1e-2),
    "rmsprop_wd": OptimizerConfig(name="rmsprop", learning_rate=0.01,
                                  rmsprop_decay=0.9, eps=1e-3,
                                  weight_decay=1e-2),
    "adam_ignored_wd_clip": OptimizerConfig(
        name="adam", learning_rate=0.01, weight_decay=5e-2,
        grad_clip_norm=1.0),
    "adamw_no_decay_bn_bias": OptimizerConfig(
        name="adamw", learning_rate=0.01, weight_decay=0.1,
        no_decay_bn_bias=True),
    "momentum_accum_2": OptimizerConfig(
        name="sgd", learning_rate=0.1, weight_decay=1e-2, accum_steps=2,
        no_decay_bn_bias=True, grad_clip_norm=2.0),
    "adamw_accum_2": OptimizerConfig(name="adamw", learning_rate=0.01,
                                     weight_decay=0.1, accum_steps=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax_over_three_updates(case):
    """3 applied updates (6 micro-batches under accum_steps 2), the plateau
    scale halved before the last one."""
    opt_cfg = CASES[case]
    grads = _grads(3 * opt_cfg.accum_steps)
    scale_at = len(grads) - opt_cfg.accum_steps
    want = _run_jax(opt_cfg, grads, scale_at)
    params, opt = _port_optimizer(opt_cfg)
    _feed(params, opt, grads, scale_at)
    assert opt.count == 3
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    # the updates moved every tensor
    for k, v in _tree(0).items():
        assert np.abs(want[k] - v).max() > 1e-3, k


def test_no_decay_bn_bias_leaves_one_dimensional_tensors_undecayed():
    """With a zero gradient, adamw moves only what it decays: rank > 1."""
    opt_cfg = OptimizerConfig(name="adamw", learning_rate=0.1,
                              weight_decay=0.5, no_decay_bn_bias=True)
    params, opt = _port_optimizer(opt_cfg)
    zeros = [{k: np.zeros(s, np.float32) for k, s in SHAPES.items()}]
    _feed(params, opt, zeros)
    start = _tree(0)
    np.testing.assert_array_equal(params["bias"].detach().numpy(),
                                  start["bias"])
    for k in ("dense", "conv"):
        assert not np.allclose(params[k].detach().numpy(), start[k])


@pytest.mark.parametrize("case", ["momentum_accum_2", "adamw_accum_2",
                                  "rmsprop_wd"])
def test_state_dict_resumes_mid_accumulation(case):
    """A state saved after 3 micro-batches (one update and half of the
    next) and loaded into a fresh optimizer continues exactly as the
    uninterrupted one."""
    opt_cfg = CASES[case]
    grads = _grads(6)
    params, opt = _port_optimizer(opt_cfg)
    _feed(params, opt, grads)
    params2, opt2 = _port_optimizer(opt_cfg)
    _feed(params2, opt2, grads[:3])
    saved = opt2.state_dict()
    weights = {k: p.detach().clone() for k, p in params2.items()}
    params3, opt3 = _port_optimizer(opt_cfg)
    with torch.no_grad():
        for k, p in params3.items():
            p.copy_(weights[k])
    opt3.load_state_dict(saved)
    _feed(params3, opt3, grads[3:], start=3)
    assert opt3.count == opt.count
    for k in params:
        torch.testing.assert_close(params3[k], params[k], rtol=0, atol=0)
