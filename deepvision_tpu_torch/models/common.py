"""Shared building blocks of the port's model zoo (own copy of
deepvision_tpu/models/common.py: `he_normal_fanout`, `ConvBN`, `lrn`; and
the Flax-numerics `Conv`, `ConvTranspose`, `Dense`, `BatchNorm`, `Dropout`,
pools and `reflect_pad` every model uses).

Numerics follow Flax where they differ from torch's defaults:
- `Conv` and `Dense` compute at the compute dtype from f32 master weights,
  cast per call as Flax's `dtype=` policy does (no autocast), and below
  f32 add the bias to the rounded product, as Flax does. Conv padding is
  Flax's: "SAME" (XLA's: a stride-2 3x3 conv on an even input pads 0
  before and 1 after, which `nn.Conv2d(padding=1)` does not), "VALID", or
  explicit `[(lo, hi), (lo, hi)]`; `groups` is Flax's
  `feature_group_count`;
- `ConvTranspose` is Flax's `nn.ConvTranspose` with its defaults
  (`transpose_kernel=False`, "SAME"): the kernel, not flipped, slides
  over the input dilated by the stride and padded as `lax.conv_transpose`
  pads it, and the output is the input size times the stride. That is
  not `nn.ConvTranspose2d` with the kernel carried over;
- `max_pool` and `avg_pool` are `nn.max_pool` and `nn.avg_pool` on NCHW:
  VALID by default, SAME padded as XLA pads (asymmetric at stride 2 on an
  even size), max with -inf, avg with zeros counted in the divisor
  (flax's `count_include_pad=True`); `flatten_nhwc` flattens in Flax's
  NHWC order, so the Dense after it takes a Flax kernel unchanged;
- `BatchNorm` normalizes NCHW, or (B, C) as Flax's BatchNorm does a
  Dense output, in f32 (in f64 for an f64 input: Flax's
  `promote_types(float32, x.dtype)`), with the batch
  statistics in training and the running ones in eval, and returns its
  `dtype`. Its momentum is Flax's (0.9 keeps 90% of the running value;
  torch's convention is the complement), and the running variance takes
  the BIASED batch variance, as Flax's does (torch feeds the unbiased one).
  Under a process group (parallel/mesh.py) the batch statistics are those
  of the global batch, as under the JAX mesh: all-reduced sums, the mean
  first and then the squared deviations from it, with the backward
  carrying the all-reduce too (`_GlobalBatchNorm`); every rank's running
  statistics stay equal.

`ComputeWeights.cast_compute_weights_` casts, once, for serving, the
weights of every `Conv` and `Dense` that runs below f32; BatchNorm and the
f32 heads keep f32.

Children that Flax names itself (`Conv_0`, `BatchNorm_0`, ...) carry the
same names here through `flax_auto_names`, so `utils/flax_convert.py` maps
a Flax `params` + `batch_stats` pair onto a port module leaf for leaf.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from ..utils.flax_convert import flax_auto_names

Padding = Union[str, Sequence[Tuple[int, int]]]
Size2 = Union[int, Tuple[int, int]]

# flax variance_scaling("truncated_normal") divides the standard deviation
# by that of a unit normal truncated to [-2, 2]
TRUNCATED_NORMAL_STD = 0.87962566103423978


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pair(v: Size2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def out_size(size: int, kernel: int, stride: int = 1,
             padding: Padding = "VALID") -> int:
    """Length of a conv or pool output along one spatial dim under Flax's
    padding (one (lo, hi) pair when explicit); below 1 the map is gone."""
    if padding == "SAME":
        return -(-size // stride)
    lo, hi = (0, 0) if padding == "VALID" else padding
    return (size + lo + hi - kernel) // stride + 1


def _flax_pads(x: torch.Tensor, kernel: Tuple[int, int],
               stride: Tuple[int, int], padding: Padding
               ) -> Tuple[Tuple[int, int], ...]:
    """(top, bottom), (left, right) pads of Flax's `padding` on NCHW `x`."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tuple(_same_pads(x.shape[d], kernel[i], stride[i])
                     for i, d in enumerate((-2, -1)))
    return tuple(tuple(p) for p in padding)


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def max_pool(x: torch.Tensor, window: Size2, strides: Optional[Size2] = None,
             padding: Padding = "VALID") -> torch.Tensor:
    """flax `nn.max_pool` on NCHW: pads with -inf, as XLA does."""
    window, strides = _pair(window), _pair(strides or 1)
    x = _pad(x, _flax_pads(x, window, strides, padding), -math.inf)
    return F.max_pool2d(x, window, strides)


def avg_pool(x: torch.Tensor, window: Size2, strides: Optional[Size2] = None,
             padding: Padding = "VALID") -> torch.Tensor:
    """flax `nn.avg_pool` on NCHW (`count_include_pad=True`): the window's
    sum over zero padding, divided by the window's size. torch sums a bf16
    window in f32 and rounds once; XLA on the CPU rounds after every add."""
    window, strides = _pair(window), _pair(strides or 1)
    x = _pad(x, _flax_pads(x, window, strides, padding))
    return F.avg_pool2d(x, window, strides)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in f32, or in its own dtype where that is wider (f64): JAX's
    upcast of low-precision floats for reductions and normalizations."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def global_avg_pool(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Mean over H and W of NCHW `x`, summed in f32 (as `jnp.mean` sums
    bf16) and returned in `dtype`."""
    return at_least_f32(x).mean(dim=(2, 3)).to(dtype)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C) in Flax's NHWC order."""
    return x.permute(0, 2, 3, 1).flatten(1)


def lrn(x: torch.Tensor, depth_radius: int = 2, bias: float = 2.0,
        alpha: float = 1e-4, beta: float = 0.75,
        torch_size: int = 0) -> torch.Tensor:
    """Local response normalization across the channels of NCHW `x`
    (`deepvision_tpu/models/common.py::lrn`). The defaults are the paper's
    (n=5, k=2); `torch_size=n` is `torch.nn.LocalResponseNorm(n)`: k=1,
    alpha / n, the asymmetric window of n // 2 channels before and
    (n - 1) // 2 after. In f32 whatever the input: a sliding window sum
    of squares by pad, cumsum and shifted subtract; the result in x's
    dtype."""
    if torch_size:
        before, after = torch_size // 2, (torch_size - 1) // 2
        bias, alpha = 1.0, alpha / torch_size
    else:
        before = after = depth_radius
    n = before + after + 1
    x32 = at_least_f32(x)
    run = torch.cumsum(F.pad(x32 * x32, (0, 0, 0, 0, before, after)), dim=1)
    run = F.pad(run, (0, 0, 0, 0, 1, 0))
    win = run[:, n:] - run[:, :-n]
    return (x32 / torch.pow(bias + alpha * win, beta)).to(x.dtype)


def _add_children(parent: nn.Module, children: Sequence[nn.Module]
                  ) -> List[nn.Module]:
    """Register `children` under Flax's auto names; return them as a plain
    list (kept on a plain attribute, so nothing registers twice)."""
    for name, child in flax_auto_names(children):
        parent.add_module(name, child)
    return list(children)


def truncated_normal_(weight: torch.Tensor, std: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's truncated normal: N(0, std) cut at +-2 std."""
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's default kernel init, variance_scaling(1, "fan_in",
    "truncated_normal"), on a torch (out, in, ...) weight."""
    fan_in = weight[0].numel()
    return truncated_normal_(weight, (1.0 / fan_in) ** 0.5
                             / TRUNCATED_NORMAL_STD, generator)


def he_normal_fanout_(weight: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """`he_normal_fanout` = variance_scaling(2.0, "fan_out",
    "truncated_normal") on a torch OIHW weight: fan-out = kh * kw * out."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    return truncated_normal_(weight, (2.0 / fan_out) ** 0.5
                             / TRUNCATED_NORMAL_STD, generator)


class Conv(nn.Conv2d):
    """Flax `nn.Conv` at the compute dtype `dtype`, padding "SAME" (the
    default), "VALID" or `[(lo, hi), (lo, hi)]`, `groups` feature groups."""

    def __init__(self, in_features: int, features: int,
                 kernel: Size2, strides: Size2 = 1,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 padding: Padding = "SAME", groups: int = 1):
        super().__init__(in_features, features, kernel, stride=strides,
                         padding=0, bias=use_bias, groups=groups)
        if isinstance(padding, str) and padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or "
                             f"[(lo, hi), (lo, hi)], got {padding!r}")
        self.dtype = dtype
        self.flax_padding = (padding if isinstance(padding, str)
                             else tuple(tuple(p) for p in padding))

    def _pads(self, x: torch.Tensor) -> Tuple[Tuple[int, int], ...]:
        return _flax_pads(x, self.kernel_size, self.stride,
                          self.flax_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad(x.to(self.dtype), self._pads(x))
        weight = self.weight.to(self.dtype)
        if self.bias is None or self.dtype == torch.float32:
            bias = None if self.bias is None else self.bias
            return F.conv2d(x, weight, bias, self.stride, groups=self.groups)
        # Flax rounds the product to the compute dtype, then adds the bias
        return (F.conv2d(x, weight, None, self.stride, groups=self.groups)
                + self.bias.to(self.dtype)[:, None, None])


def _transpose_pads(kernel: int, stride: int) -> Tuple[int, int]:
    """`lax.conv_transpose`'s SAME padding of one spatial dim: the (low,
    high) zeros around the stride-dilated input, so that the output is
    input * stride long."""
    total = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return low, total - low


class ConvTranspose(nn.Module):
    """Flax `nn.ConvTranspose(features, kernel, strides, padding="SAME")`
    at the compute dtype `dtype`: the correlation of the kernel, as it is,
    with the input dilated by the stride and padded by `_transpose_pads`.
    It runs as `F.conv_transpose2d` with the kernel flipped and its
    channels swapped (that op pads kernel - 1 on each side), cropped or
    padded to Flax's pads. The weight is OIHW (out, in, kh, kw), as a
    `Conv`'s, so the weight bridge maps Flax's HWIO kernel onto it."""

    def __init__(self, in_features: int, features: int, kernel: Size2,
                 strides: Size2 = 1, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.stride = _pair(kernel), _pair(strides)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               *self.kernel_size))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(self.dtype).transpose(0, 1).flip(2, 3)
        y = F.conv_transpose2d(x.to(self.dtype), weight, stride=self.stride)
        (top, bottom), (left, right) = (
            tuple(p - (k - 1) for p in _transpose_pads(k, s))
            for k, s in zip(self.kernel_size, self.stride))
        y = F.pad(y, (left, right, top, bottom))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`jnp.pad(mode="reflect")` of H and W of NCHW `x`."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


class Dense(nn.Linear):
    """Flax `nn.Dense` at `dtype`: input, weight and bias cast to it (an
    f32 head promotes a bf16 input); below f32 the bias is added to the
    rounded product, as Flax does."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True):
        super().__init__(in_features, features, bias=use_bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight = x.to(self.dtype), self.weight.to(self.dtype)
        if self.bias is None or self.dtype == torch.float32:
            return F.linear(x, weight, self.bias)
        return F.linear(x, weight) + self.bias.to(self.dtype)


class Dropout(nn.Module):
    """flax.linen.Dropout: in train mode, keep each element with
    probability 1 - rate, scaled by 1 / (1 - rate), the mask drawn from
    `generator`; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs the step's generator "
                             "(forward(x, generator=...))")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class ComputeWeights:
    """Mixin of the port's CNN classifiers: the engine's one cast of the
    weights that run at the compute dtype."""

    @torch.no_grad()
    def cast_compute_weights_(self):
        """Cast, once, the weights of every `Conv` and `Dense` computing
        below f32 to their dtype, so no forward pays that cast again (a
        serving step: the optimizer keeps f32 masters). BatchNorm and the
        f32 heads keep f32, as the training forward computes them."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense)) and m.dtype != torch.float32:
                m.to(m.dtype)
        return self


_recompute = threading.local()


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """Marks the body as the recompute of a train forward in the backward
    (core/remat.py) on this thread: a train-mode `BatchNorm` there
    normalizes as in the forward but leaves its running statistics as
    the forward left them (one update a step, as JAX's `batch_stats`)."""
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


def in_recompute() -> bool:
    return getattr(_recompute, "on", False)


class BatchNorm(nn.BatchNorm2d):
    """Flax `nn.BatchNorm(momentum, epsilon)` on NCHW or (B, C): f32
    normalization (f64 for an f64 input), output in `dtype` (f32 unless a
    model asks for its compute dtype). The statistics reduce every axis
    but the channels'."""

    def __init__(self, features: int, *, eps: float, momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_f32(x)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        if mesh.is_initialized():
            return self._global_batch_norm(x).to(self.dtype)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if in_recompute():
            return y.to(self.dtype)
        # the running statistics take the biased batch variance, as Flax's
        # do (torch's own update would fold in var * n / (n - 1))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, *range(2, x.ndim)),
                                       correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y.to(self.dtype)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch (`_GlobalBatchNorm`), and the
        running statistics from its mean and biased variance."""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps)
        if in_recompute():
            return y
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


def _channels(t: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast against NCHW."""
    return t[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalization of NCHW `x` with the statistics of the global
    batch, every rank holding as many rows (the trainer checks that the
    batch divides the world). Returns (y, mean, biased variance).

    The statistics come from all-reduced per-channel sums in two steps,
    the global mean first, then the sum of squared deviations from it.
    Each rank contributes its own count n, mean m_r and squared
    deviations M2_r = n var_r (one Welford pass, `torch.var_mean`), so the
    second sum is sum_r M2_r + n (m_r - mean)^2: the squared deviations of
    all rows from the global mean, exactly, and with no E[x^2] - E[x]^2
    to cancel in f32. The backward all-reduces the per-channel sums of dy
    and dy (x - mean): every rank's rows reach every rank's output through
    the statistics. The weight and bias gradients stay this rank's: DDP
    averages them. On the card the normalization and its backward run
    PyTorch's fused batch-norm kernels, on the CPU plain tensor ops."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        n = x.numel() // x.shape[1]
        count = n * mesh.world_size()
        var_r, mean_r = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        mean = mesh.all_reduce_(mean_r * n) / count
        var = mesh.all_reduce_(var_r * n + n * (mean_r - mean).square()
                               ) / count
        invstd = torch.rsqrt(var + eps)
        if x.is_cuda:
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            y = (x - _channels(mean)) * _channels(invstd * weight) \
                + _channels(bias)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        if x.is_cuda:
            fmt = (torch.channels_last
                   if x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
            dy = dy.contiguous(memory_format=fmt)
            sum_dy, sum_dy_xmu, grad_w, grad_b = \
                torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                 True, True, True)
        else:
            xmu = x - _channels(mean)
            sum_dy = dy.sum(dim=(0, 2, 3))
            sum_dy_xmu = (dy * xmu).sum(dim=(0, 2, 3))
            grad_w, grad_b = sum_dy_xmu * invstd, sum_dy
        sum_dy, sum_dy_xmu = mesh.all_reduce_(
            torch.cat([sum_dy, sum_dy_xmu])).split(c)
        if x.is_cuda:
            count = torch.tensor([ctx.count], dtype=torch.int32,
                                 device=x.device)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight,
                                                 sum_dy, sum_dy_xmu, count)
        else:
            dx = (dy - _channels(sum_dy / ctx.count)
                  - xmu * _channels(invstd.square() * sum_dy_xmu
                                    / ctx.count)) \
                * _channels(invstd * weight)
        return dx, grad_w, grad_b, None


class ConvBN(nn.Module):
    """Conv → BatchNorm → (optional) ReLU, returned in the compute dtype
    (`deepvision_tpu/models/common.py::ConvBN`): the conv has no bias
    unless `use_bias` or `use_bn=False`, its kernel `he_normal_fanout`;
    the BatchNorm runs in f32 with Flax momentum 0.9, epsilon 1e-5."""

    def __init__(self, in_features: int, features: int,
                 kernel: Size2 = 3, strides: Size2 = 1,
                 padding: Padding = "SAME", use_bias: bool = False,
                 relu: bool = True, use_bn: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5, *,
                 groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        conv = Conv(in_features, features, kernel, strides,
                    use_bias=use_bias or not use_bn, dtype=dtype,
                    padding=padding, groups=groups)
        bn = ([BatchNorm(features, eps=bn_epsilon, momentum=bn_momentum)]
              if use_bn else [])
        self.layers = _add_children(self, [conv] + bn)
        with torch.no_grad():
            he_normal_fanout_(conv.weight, generator)
            if conv.bias is not None:
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        if self.relu:
            x = F.relu(x)
        return x.to(self.dtype)
