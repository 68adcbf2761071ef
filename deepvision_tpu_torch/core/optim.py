"""Optimizer factory (own copy of deepvision_tpu/core/optim.py).

The JAX package builds one optax chain: `clip_by_global_norm` (when
`grad_clip_norm` is set), then the optimizer's own part, then
`scale_by_schedule`, `scale(-1)` and `scale(lr_scale)`, the last written by
the host-side plateau between epochs; under `accum_steps > 1` all of it
sits inside `optax.MultiSteps`. The parts:

- `sgd` / `momentum`: L2-coupled weight decay (`add_decayed_weights`), then
  `trace(momentum, nesterov)` when `momentum` is nonzero;
- `rmsprop`: `scale_by_rms` (nu starts at 0; optax's default puts eps
  inside the square root), then the weight decay;
- `adam`: `scale_by_adam` and no weight decay at all;
- `adamw`: `scale_by_adam`, then the weight decay.

`no_decay_bn_bias` decays only tensors of rank > 1.

`Optimizer` runs that chain with the LR of each update set to
schedule(count) * lr_scale. Where a `torch.optim` class computes the same
update it does the work: `SGD` for sgd/momentum (its coupled decay and
momentum buffer are `add_decayed_weights` and `trace`), `Adam` for adam
(the YOLO configs' update, unchanged), `AdamW` for adamw (p·(1 - lr·wd)
before the Adam step is the decay added after the scaling). RMSprop is
written out: `torch.optim.RMSprop` adds eps outside the square root and
the decay before the scaling.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from .config import OptimizerConfig, ScheduleConfig
from .schedules import Schedule, build_schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: when the global L2 norm g of
    `grads` is at least `max_norm`, every gradient becomes t / g * max_norm.
    No host sync: the choice is a tensor op."""
    if not grads:
        return
    wide = torch.promote_types(grads[0].dtype, torch.float32)
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.to(wide)) for g in grads]))
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, g / norm.to(g.dtype) * max_norm))


class ScaleByRMS(torch.optim.Optimizer):
    """optax `scale_by_rms(decay, eps)` followed by `add_decayed_weights`:
    nu = decay·nu + (1 - decay)·g², u = g / sqrt(nu + eps) + wd·p, p -= lr·u
    (nu starts at 0)."""

    def __init__(self, params, lr: float, decay: float, eps: float,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu, g, decay = state["nu"], p.grad, group["decay"]
                nu.copy_((1 - decay) * g.square() + decay * nu)
                u = g * torch.rsqrt(nu + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.sub_(group["lr"] * u)


def _param_groups(params: List[torch.nn.Parameter], cfg: OptimizerConfig,
                  weight_decay: float) -> list:
    if not weight_decay or not cfg.no_decay_bn_bias:
        return [{"params": params, "weight_decay": weight_decay}]
    decayed = [p for p in params if p.dim() > 1]
    kept = [p for p in params if p.dim() <= 1]
    return [g for g in ({"params": decayed, "weight_decay": weight_decay},
                        {"params": kept, "weight_decay": 0.0}) if g["params"]]


class Optimizer:
    """The chain of one `OptimizerConfig` over `params`: `zero_grad`,
    `step` (an applied update, or one micro-batch of an accumulation),
    `set_lr_scale`, `state_dict` / `load_state_dict`."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimizerConfig, schedule: Schedule):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        self.accum_steps = cfg.accum_steps
        self.lr_scale = 1.0
        self.count = 0      # updates applied: the schedule's step count
        self.mini_step = 0  # micro-batches accumulated toward the next one
        self.acc_grads: Optional[List[torch.Tensor]] = None
        lr, wd = schedule(0), cfg.weight_decay
        name = cfg.name
        if name in ("sgd", "momentum"):
            self.inner = torch.optim.SGD(
                _param_groups(self.params, cfg, wd), lr=lr,
                momentum=cfg.momentum,
                nesterov=bool(cfg.nesterov and cfg.momentum))
        elif name == "rmsprop":
            self.inner = ScaleByRMS(_param_groups(self.params, cfg, wd),
                                    lr=lr, decay=cfg.rmsprop_decay,
                                    eps=cfg.eps)
        elif name == "adam":
            # the JAX chain adds no decayed weights for adam
            # (deepvision_tpu/core/optim.py:61-62): a configured
            # weight_decay (vit_small's 5e-2) is ignored there, so here too
            self.inner = torch.optim.Adam(self.params, lr=lr,
                                          betas=(cfg.beta1, cfg.beta2),
                                          eps=cfg.eps)
        elif name == "adamw":
            self.inner = torch.optim.AdamW(
                _param_groups(self.params, cfg, wd), lr=lr,
                betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)
        else:
            raise ValueError(f"unknown optimizer {name!r}")

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """optax.MultiSteps: fold this micro-batch's gradients into their
        running mean; True (with the mean in `.grad`) on the k-th."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.acc_grads is None:
            self.acc_grads = [torch.zeros_like(g) for g in grads]
        n = self.mini_step
        for acc, g in zip(self.acc_grads, grads):
            acc.add_((g - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.accum_steps:
            return False
        for p, acc in zip(self.params, self.acc_grads):
            p.grad = acc
        self.acc_grads = None
        self.mini_step = 0
        return True

    def step(self) -> None:
        if self.accum_steps > 1 and not self._accumulate():
            return
        if self.grad_clip_norm:
            clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.grad_clip_norm)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count) * self.lr_scale
        self.inner.step()
        self.count += 1

    def set_lr_scale(self, scale: float) -> None:
        """The plateau's scale (deepvision_tpu/core/optim.py::set_lr_scale)."""
        self.lr_scale = float(scale)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "lr_scale": self.lr_scale, "mini_step": self.mini_step,
                "acc_grads": self.acc_grads}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.lr_scale = float(state["lr_scale"])
        self.mini_step = int(state["mini_step"])
        acc = state["acc_grads"]
        self.acc_grads = (None if acc is None else
                          [a.to(p.device) for a, p in zip(acc, self.params)])


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    opt_cfg: OptimizerConfig, sched_cfg: ScheduleConfig,
                    steps_per_epoch: float, total_epochs: int) -> Optimizer:
    """The optimizer of `opt_cfg` over `params`, its schedule built from
    `sched_cfg` in applied updates: under accumulation steps_per_epoch /
    accum_steps updates per epoch, kept fractional."""
    if opt_cfg.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got "
                         f"{opt_cfg.accum_steps}")
    schedule = build_schedule(sched_cfg, opt_cfg.learning_rate,
                              steps_per_epoch / opt_cfg.accum_steps,
                              total_epochs)
    return Optimizer(params, opt_cfg, schedule)
