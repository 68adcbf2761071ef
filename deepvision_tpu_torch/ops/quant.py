"""int8 post-training quantization of a served forward (port of
deepvision_tpu/ops/quant.py).

The JAX package quantizes the closed jaxpr of the engine's predict. The
port has no jaxpr: it watches the eager forward itself, through a
`torch.overrides.TorchFunctionMode` that sees every `F.conv2d` and
`F.linear` in call order, as the jaxpr replay sees every
`conv_general_dilated` and `dot_general` in equation order. Three
stages, as in JAX:

1. `plan_quantization(model, forward, head_dims)`: run the forward once
   and classify every conv and dense call. A call quantizes when its
   weight operand is a parameter of `model` (followed through dtype casts
   only, as JAX follows `convert_element_type`), it touches none of
   `head_dims` (every size of its unpadded input, weight and output: the
   f32 heads, `core/scoring.serving_head_dims`), and its contraction is
   at most `MAX_ACC_TAPS` deep. A product of two activations counts as
   `skipped_attention`; a call of K1 (`ops/attention.flash_attention`,
   overridable by the mode) as `fused_attention`: attention stays in
   float on its kernel.
2. `calibrate(plan, forward)`: run the forward on the pinned batch and
   keep one per-tensor scale per planned call, `absmax / 127` (1/127 when
   the activation is all zero), in planned order.
3. `Int8Mode(plan, qweights)`: the int8 twin. Every planned call becomes
   `q_x = clip(round(x.f32 * (1/s_x)), -127, 127)` in int8, an int8 x
   int8 product accumulated in int32, and `acc.f32 * (s_w * s_x)` cast to
   the call's own dtype, with the bias added after that (JAX's conv and
   dot carry no bias). Every other call runs unchanged.

Weights are quantized per output channel from the f32 masters
(`quantize_weights`), data-free, so a new weight generation is
re-quantized under the pinned activation scales and never recalibrated.
`calibrate.passes` counts calibrations in the process.

The int8 products: `int8_matmul` (`torch._int_mm`, zero-padded to the
shapes the card takes: more than 16 rows, inner and output sizes
multiples of 8; padding with zeros is exact), convolutions through
im2col on the int8 activation (a strided view copied once into the
product's rows), grouped convolutions group by group, and depthwise ones
as an int32 sum over the taps. Each accumulates in int32, exactly, so
equal int8 operands give equal accumulators on the CPU and on the card.
A shape they cannot take raises: the plan decides what stays in float,
never the device.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Mapping, \
    Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .attention import flash_attention

QMAX = 127.0

# int8 x int8 partial products are <= 127^2; int32 accumulation is exact
# while taps * 127^2 < 2^31. Deeper contractions stay in float.
MAX_ACC_TAPS = (2 ** 31 - 1) // (127 * 127)

#: the heavy calls the plan classifies, by the function the mode sees
HEAVY = {F.conv2d: "conv2d", F.linear: "linear"}
# provenance survives dtype (and device) casts only
_CASTS = frozenset({torch.Tensor.to, torch.Tensor.float,
                    torch.Tensor.bfloat16, torch.Tensor.half,
                    torch.Tensor.double, torch.Tensor.type})
# products of two tensors outside HEAVY: the naive attention's QK^T and PV
_CONTRACTIONS = frozenset({torch.einsum, torch.matmul, torch.bmm,
                           torch.Tensor.matmul, torch.Tensor.__matmul__})


class QuantRefusal(ValueError):
    """The plan refused the whole program, with a machine-readable
    `reason`: attention exists but no projection could be planned, so
    int8 would quantize nothing (serve/quantize.arm_int8 turns it into a
    `refused_plan` decision)."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class QuantOp:
    """One planned call: its position among the forward's conv and dense
    calls, which of the two it is, and the parameter it multiplies."""
    position: int
    prim: str                      # "conv2d" | "linear"
    param: str                     # the weight's name in model.state_dict()
    weight_shape: Tuple[int, ...]


@dataclasses.dataclass
class QuantPlan:
    """The structural half of PTQ. `act_scales` stays None until
    `calibrate` fills it, one scale per op in planned order."""
    ops: List[QuantOp]
    heavy_calls: int               # conv and dense calls in the forward
    skipped_head: int = 0
    skipped_other: int = 0
    skipped_attention: int = 0
    fused_attention: int = 0
    act_scales: Optional[List[float]] = None

    @property
    def params(self) -> FrozenSet[str]:
        return frozenset(op.param for op in self.ops)

    def summary(self) -> dict:
        return {"quantized": len(self.ops),
                "skipped_head": self.skipped_head,
                "skipped_other": self.skipped_other,
                "skipped_attention": self.skipped_attention,
                "fused_attention": self.fused_attention,
                "calibrated": self.act_scales is not None}


def _conv_args(args, kwargs) -> tuple:
    """(input, weight, bias, stride, padding, dilation, groups) of one
    `F.conv2d` call, positional or keyword."""
    names = ("input", "weight", "bias", "stride", "padding", "dilation",
             "groups")
    bound = dict(zip(names, (None, None, None, 1, 0, 1, 1)))
    bound.update(zip(names, args))
    bound.update(kwargs)
    return tuple(bound[n] for n in names)


def _linear_args(args, kwargs) -> tuple:
    bound = {"input": None, "weight": None, "bias": None}
    bound.update(zip(("input", "weight", "bias"), args))
    bound.update(kwargs)
    return bound["input"], bound["weight"], bound["bias"]


def _taps(prim: str, weight: torch.Tensor) -> int:
    """Accumulation depth of one output element: the int32 bound."""
    if prim == "conv2d":
        return int(math.prod(weight.shape[1:]))
    return int(weight.shape[-1])


class _PlanMode(TorchFunctionMode):
    """Watches one forward: follows parameters through casts, remembers
    each padded tensor's shape before its padding (JAX's conv takes the
    unpadded input), and classifies the conv and dense calls."""

    def __init__(self, model: torch.nn.Module, head_dims: FrozenSet[int],
                 record: Optional[Sequence[int]] = None):
        super().__init__()
        self.head_dims = frozenset(head_dims)
        self._prov: Dict[int, str] = {
            id(p): n for n, p in model.named_parameters()}
        self._unpadded: Dict[int, Tuple[int, ...]] = {}
        self._alive: List[torch.Tensor] = []   # keeps the ids above unique
        self._record = None if record is None else set(record)
        self.absmax: Dict[int, float] = {}
        self.ops: List[QuantOp] = []
        self.heavy = 0
        self.counts = {"skipped_head": 0, "skipped_other": 0,
                       "skipped_attention": 0, "fused_attention": 0}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _CASTS:
            src = args[0]
            if id(src) in self._prov and isinstance(out, torch.Tensor) \
                    and out.is_floating_point():
                self._prov[id(out)] = self._prov[id(src)]
                self._alive.append(out)
        elif func is F.pad:
            self._unpadded[id(out)] = self._unpadded.get(
                id(args[0]), tuple(args[0].shape))
            self._alive.append(out)
        elif func in HEAVY:
            self._heavy(HEAVY[func], args, kwargs, out)
        elif func is flash_attention:
            self.counts["fused_attention"] += 1
        elif func in _CONTRACTIONS:
            operands = [a for a in (args[1:] if func is torch.einsum
                                    else args)
                        if isinstance(a, torch.Tensor)]
            if all(a.is_floating_point() and id(a) not in self._prov
                   for a in operands):
                self.counts["skipped_attention"] += 1
            else:
                self.counts["skipped_other"] += 1
        return out

    def _heavy(self, prim: str, args, kwargs, out: torch.Tensor) -> None:
        position = self.heavy
        self.heavy += 1
        x, w = (_conv_args(args, kwargs) if prim == "conv2d"
                else _linear_args(args, kwargs))[:2]
        if self._record is not None:
            if position in self._record:
                self.absmax[position] = float(x.float().abs().max())
            return
        floats = x.is_floating_point() and w.is_floating_point()
        if id(w) not in self._prov or not floats:
            if floats and id(x) not in self._prov:
                self.counts["skipped_attention"] += 1
            else:
                self.counts["skipped_other"] += 1
            return
        dims = {int(d) for shape in (self._unpadded.get(id(x), x.shape),
                                     w.shape, out.shape) for d in shape}
        if self.head_dims & dims:
            self.counts["skipped_head"] += 1
            return
        if _taps(prim, w) > MAX_ACC_TAPS:
            self.counts["skipped_other"] += 1
            return
        self.ops.append(QuantOp(position=position, prim=prim,
                                param=self._prov[id(w)],
                                weight_shape=tuple(w.shape)))


def plan_quantization(model: torch.nn.Module, forward: Callable[[], Any],
                      head_dims: Iterable[int] = frozenset()) -> QuantPlan:
    """The structural plan of `forward()` (a call of `model`'s forward on
    some batch): which conv and dense calls quantize. Raises QuantRefusal
    when attention exists but nothing quantizes."""
    mode = _PlanMode(model, frozenset(head_dims))
    with torch.no_grad(), mode:
        forward()
    c = mode.counts
    if (c["skipped_attention"] or c["fused_attention"]) and not mode.ops:
        raise QuantRefusal(
            f"attention program has {c['skipped_attention']} float "
            f"activation×activation contraction(s) and "
            f"{c['fused_attention']} fused kernel call(s) but ZERO "
            f"quantizable projection weights — int8 serving would be a "
            f"no-op; refusing rather than silently serving a "
            f"half-quantized model",
            reason="attention_projections_unquantizable")
    return QuantPlan(ops=mode.ops, heavy_calls=mode.heavy, **c)


_passes_lock = threading.Lock()


def calibrate(plan: QuantPlan, model: torch.nn.Module,
              forward: Callable[[], Any]) -> QuantPlan:
    """Fill `plan.act_scales` from one run of `forward()` on the pinned
    calibration batch: each planned call's activation absmax over 127, as
    Python floats, in planned order. Counted in `calibrate.passes`."""
    mode = _PlanMode(model, frozenset(),
                     record=[op.position for op in plan.ops])
    with torch.no_grad(), mode:
        forward()
    if mode.heavy != plan.heavy_calls:
        raise ValueError(f"the calibration forward made {mode.heavy} conv "
                         f"and dense calls; the plan was built over "
                         f"{plan.heavy_calls}")
    plan.act_scales = [
        # an all-zero activation still needs a nonzero scale; 1/127 maps
        # 0 to 0 exactly
        (m / QMAX if m > 0.0 else 1.0 / QMAX)
        for m in (mode.absmax[op.position] for op in plan.ops)]
    with _passes_lock:
        calibrate.passes += 1
    return plan


calibrate.passes = 0


# -- weights ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QWeight:
    """One planned weight: int8 in the parameter's own layout, and its
    f32 scale per output channel (dim 0)."""
    w: torch.Tensor
    s: torch.Tensor

    def to(self, device) -> "QWeight":
        return QWeight(self.w.to(device), self.s.to(device))


def quantize_weight(master: torch.Tensor) -> QWeight:
    """Per-output-channel symmetric int8 of one f32 weight: `s =
    absmax / 127` over every dim but the first (1/127 for an all-zero
    channel), `w = clip(round(w / s), -127, 127)`."""
    w = master.detach().float()
    absmax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = torch.where(absmax > 0, absmax / QMAX,
                        torch.full_like(absmax, 1.0 / QMAX))
    wq = torch.clamp(torch.round(w / scale.view(-1, *[1] * (w.ndim - 1))),
                     -QMAX, QMAX).to(torch.int8)
    return QWeight(wq, scale)


def quantize_weights(plan: QuantPlan, masters: Mapping[str, torch.Tensor]
                     ) -> List[QWeight]:
    """The planned weights of one generation, from its f32 masters (name
    -> tensor), in planned order. Data-free: the activation scales stay
    those of the calibration."""
    out = []
    for op in plan.ops:
        master = masters[op.param]
        if tuple(master.shape) != op.weight_shape:
            raise ValueError(f"{op.param} has shape {tuple(master.shape)}; "
                             f"the plan was built over {op.weight_shape}")
        out.append(quantize_weight(master))
    return out


def tree_nbytes(tensors: Iterable[torch.Tensor]) -> int:
    """Total payload bytes of some tensors."""
    return int(sum(t.numel() * t.element_size() for t in tensors))


def int8_state_nbytes(plan: QuantPlan, state: Mapping[str, torch.Tensor]
                      ) -> int:
    """Bytes of the int8 weight tree as the JAX package counts it: each
    planned weight as int8 plus its f32 scales, every other floating leaf
    of `state` as f32."""
    planned = plan.params
    total = 0
    for name, t in state.items():
        if not t.is_floating_point():
            continue
        total += (t.numel() + 4 * t.shape[0] if name in planned
                  else 4 * t.numel())
    return total


# -- the int8 products --------------------------------------------------------

_calls_lock = threading.Lock()


def _count(fn) -> None:
    with _calls_lock:
        fn.calls += 1


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times (N, K) int8 transposed -> (M, N) int32, through
    `torch._int_mm`, zero-padded to M > 16 and K, N multiples of 8.
    Counted in `int8_matmul.calls`."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), _ceil8(k), _ceil8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    _count(int8_matmul)
    return out[:m, :n]


int8_matmul.calls = 0


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_gemm(qx: torch.Tensor, qw: torch.Tensor,
               stride: Tuple[int, int]) -> torch.Tensor:
    """One group of an int8 conv on padded NCHW `qx`: im2col (a strided
    view of the NHWC activation, copied once as the product's rows) and
    `int8_matmul`. Returns the (N, O, Ho, Wo) int32 accumulator."""
    n = qx.shape[0]
    o, c, kh, kw = qw.shape
    sh, sw = stride
    nhwc = qx.permute(0, 2, 3, 1)
    if kh == kw == 1:
        patches = nhwc[:, ::sh, ::sw]                    # (N, Ho, Wo, C)
    else:
        patches = nhwc.unfold(1, kh, sh).unfold(2, kw, sw)  # (..., C, kh, kw)
    ho, wo = patches.shape[1], patches.shape[2]
    acc = int8_matmul(patches.reshape(n * ho * wo, c * kh * kw),
                      qw.reshape(o, c * kh * kw))
    return acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def int8_depthwise(qx: torch.Tensor, qw: torch.Tensor,
                    stride: Tuple[int, int]) -> torch.Tensor:
    """A depthwise int8 conv (one input channel per output channel) as
    an int32 sum over the kernel's taps. Counted in
    `int8_depthwise.calls`."""
    n, c, h, w = qx.shape
    _, _, kh, kw = qw.shape
    sh, sw = stride
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    w32 = qw.to(torch.int32)
    acc = torch.zeros((n, c, ho, wo), dtype=torch.int32, device=qx.device)
    for i in range(kh):
        for j in range(kw):
            tap = qx[:, :, i:i + sh * (ho - 1) + 1:sh,
                     j:j + sw * (wo - 1) + 1:sw]
            acc += tap.to(torch.int32) * w32[:, 0, i, j].view(1, c, 1, 1)
    _count(int8_depthwise)
    return acc


int8_depthwise.calls = 0


def int8_conv2d(qx: torch.Tensor, qw: torch.Tensor, stride=1, padding=0,
                dilation=1, groups: int = 1) -> torch.Tensor:
    """int8 NCHW activation x int8 OIHW weight -> int32 NCHW accumulator,
    the exact integer counterpart of `F.conv2d` (zero padding, any
    stride, feature groups; no dilation)."""
    if isinstance(padding, str) or _pair(dilation) != (1, 1):
        raise ValueError(f"int8 conv takes explicit padding and no "
                         f"dilation, got padding={padding!r} "
                         f"dilation={dilation!r}")
    ph, pw = _pair(padding)
    if ph or pw:
        qx = F.pad(qx, (pw, pw, ph, ph))
    stride = _pair(stride)
    o, cg = qw.shape[:2]
    if groups == 1:
        return _conv_gemm(qx, qw, stride)
    if cg == 1 and o == groups == qx.shape[1]:
        return int8_depthwise(qx, qw, stride)
    og = o // groups
    return torch.cat([_conv_gemm(qx[:, g * cg:(g + 1) * cg],
                                 qw[g * og:(g + 1) * og], stride)
                      for g in range(groups)], dim=1)


def quantize_activation(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """`clip(round(x.f32 * (1/s_x)), -127, 127)` as int8."""
    return torch.clamp(torch.round(x.float() * (1.0 / s_x)),
                       -QMAX, QMAX).to(torch.int8)


def int8_accumulate(prim: str, args, kwargs, qw: QWeight, s_x: float
                    ) -> torch.Tensor:
    """The int32 accumulator of one planned `F.conv2d` / `F.linear` call
    (its own arguments) at int8: the activation quantized by `s_x`, times
    `qw.w`."""
    if prim == "conv2d":
        x, w, _, stride, padding, dilation, groups = _conv_args(args, kwargs)
    else:
        x, w, _ = _linear_args(args, kwargs)
    if tuple(w.shape) != tuple(qw.w.shape):
        raise ValueError(f"a planned {prim} got a weight of shape "
                         f"{tuple(w.shape)}; the quantized one is "
                         f"{tuple(qw.w.shape)}")
    qx = quantize_activation(x, s_x)
    if prim == "conv2d":
        return int8_conv2d(qx, qw.w, stride, padding, dilation, groups)
    return int8_matmul(qx.reshape(-1, qx.shape[-1]), qw.w).reshape(
        *qx.shape[:-1], qw.w.shape[0])


def int8_call(prim: str, args, kwargs, qw: QWeight, s_x: float
              ) -> torch.Tensor:
    """The int8 twin of one planned `F.conv2d` / `F.linear` call:
    `int8_accumulate`, the dequant `acc.f32 * (s_w * s_x)` cast to the
    call's dtype, then the bias."""
    x, w, bias = (_conv_args(args, kwargs)[:3] if prim == "conv2d"
                  else _linear_args(args, kwargs))
    acc = int8_accumulate(prim, args, kwargs, qw, s_x)
    scale = qw.s * s_x
    if prim == "conv2d":
        scale = scale.view(1, -1, 1, 1)
    y = (acc.float() * scale).to(torch.result_type(x, w))
    if bias is not None:
        y = y + (bias.view(1, -1, 1, 1) if prim == "conv2d" else bias)
    return y


class Int8Mode(TorchFunctionMode):
    """The int8 twin of a planned forward: run the forward under it with
    one generation's `qweights` (`quantize_weights`, on the forward's
    device). Planned calls, found by position, run `int8_call`; every
    other call, K1's included, runs unchanged. `check()` after the
    forward raises if it made another number of conv and dense calls than
    the plan saw."""

    def __init__(self, plan: QuantPlan, qweights: Sequence[QWeight]):
        super().__init__()
        if plan.act_scales is None:
            raise ValueError("plan is not calibrated — run calibrate() "
                             "first")
        if len(qweights) != len(plan.ops):
            raise ValueError(f"{len(qweights)} quantized weights for a plan "
                             f"of {len(plan.ops)}")
        self.plan = plan
        self._by_position = {op.position: (op, qw, s) for op, qw, s
                             in zip(plan.ops, qweights, plan.act_scales)}
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HEAVY:
            entry = self._by_position.get(self.calls)
            self.calls += 1
            if entry is not None:
                op, qw, s_x = entry
                if HEAVY[func] != op.prim:
                    raise ValueError(f"call {self.calls - 1} is a "
                                     f"{HEAVY[func]}; the plan has a "
                                     f"{op.prim} there")
                return int8_call(op.prim, args, kwargs, qw, s_x)
        return func(*args, **kwargs)

    def check(self) -> None:
        if self.calls != self.plan.heavy_calls:
            raise ValueError(f"the int8 forward made {self.calls} conv and "
                             f"dense calls; the plan was built over "
                             f"{self.plan.heavy_calls}")
