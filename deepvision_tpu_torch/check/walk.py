"""The op stream of one traced unit, and the cost model over it (the
counterpart of deepvision_tpu/check/jaxpr_walk.py).

The JAX package walks a closed jaxpr. The port has no jaxpr: a unit runs
its real step once under `Recorder`, a `TorchDispatchMode` that sees
every ATen op below autograd (the backward included) and every call of
the port's operators, `deepvision::flash_attention` (K1) and
`deepvision::best_iou` (K2). Under a `FakeTensorMode` (check/harness.py)
the ops carry shapes and dtypes only: no data, no FLOPs, no device
memory. On real tensors (the card) the recorder only watches.

The heavy ops carry the compute policy, as `conv_general_dilated` and
`dot_general` do in a jaxpr:

- `aten.convolution`, transposed or not, and `aten.convolution_backward`,
  counted as the one or two products its `output_mask` asks for;
- `aten.mm`, `addmm`, `bmm`, `baddbmm` (and `mv`, `addmv`, `dot`);
- `aten._int_mm`, the int8 x int8 -> int32 product of ops/quant.py;
- the int32 tap sum of ops/quant.py::int8_depthwise: each tap's `mul`
  of two int32 tensors widened from int8, grouped by the accumulator it
  is added into.

FLOPs follow JAX's convention (`_conv_flops`, `_dot_flops`):

- a conv is 2·|out|·kh·kw·C_in/groups. The port pads explicitly and
  convolves with no padding, where JAX's conv takes the unpadded input:
  the recorder remembers each zero-padded tensor's unpadded shape
  (`aten.constant_pad_nd`), and the input gradient is charged on it, as
  JAX's transposed conv writes the unpadded input: 2·|x|·kh·kw·C_out/g.
  The weight gradient is the forward's count. A reflection pad is data,
  and is not undone (JAX pads with `jnp.pad` there too);
- a transposed conv is JAX's conv with `lhs_dilation`, as Flax's SAME
  `ConvTranspose` runs it: its output is the input times the stride per
  spatial dim, and it is charged 2·|that output|·kh·kw·C_in/g, whatever
  crop the port applies to torch's wider output afterwards;
- a product is 2·|out|·K; `_int_mm` on the operands' unpadded shapes
  (ops/quant.py pads them to the card's tile sizes with zeros);
- a depthwise int8 tap is 2·|out| (one multiply-add per output).

K1's node is charged its math, 4·B·H·N²·D FLOPs (Q Kᵀ and P V), and the
bytes of Q, K, V and O, not the kernel's tiles: its row equals the naive
lowering's FLOPs. K2's node is charged the bytes of its bound, B·N·16 +
B·M·16 + B·N·4 over its segments, and no FLOPs (its body has no product).

A composite op that reaches the recorder whole (under inference mode)
is decomposed first, so a forward records the same ops with and without
autograd. `bytes` is the fusion-blind sum of every op's operand and
result bytes, and `eqns` counts the ops. Both skip what moves no data and varies with
the PyTorch release: views, `prim` and profiler ops, `lift_fresh` and
`_local_scalar_dense`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

FLASH_ATTENTION = "deepvision.flash_attention"
BEST_IOU = "deepvision.best_iou"

_CONV = {"aten.convolution"}
_CONV_BWD = {"aten.convolution_backward"}
# product ops -> the positions of their two operands
_DOTS = {"aten.mm": (0, 1), "aten.bmm": (0, 1), "aten.addmm": (1, 2),
         "aten.baddbmm": (1, 2), "aten.mv": (0, 1), "aten.addmv": (1, 2),
         "aten.dot": (0, 1)}
_INT_MM = "aten._int_mm"
# ops that pass a tensor's logical (unpadded) shape on unchanged
_SAME_SHAPE = {"aten.clone", "aten.alias", "aten.detach", "aten._to_copy",
               "aten.contiguous"}
_TRANSPOSE_2D = {"aten.t", "aten.transpose", "aten.permute"}
# no data moved: skipped by `bytes` and `eqns`
_SKIP = {"aten.lift_fresh", "aten._local_scalar_dense"}


def op_name(func) -> str:
    """`aten.convolution` for `aten.convolution.default`."""
    return f"{func.namespace}.{func._opname}"


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _numel(shape: Sequence[int]) -> int:
    return int(math.prod(int(d) for d in shape))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class HeavyOp:
    """One product that carries the compute policy."""
    name: str
    kind: str                      # conv | conv_bwd | dot | int_mm |
    #                                depthwise | flash_attention | best_iou
    flops: int
    operands: Tuple[torch.dtype, ...]
    out_dtype: torch.dtype
    shape: Tuple[int, ...]         # the (first) result's shape
    dims: FrozenSet[int]           # every size of its operands and results
    group: int = 0                 # depthwise: the accumulator's id

    @property
    def in_kernel(self) -> bool:
        """A node of K1 or K2: its precision is the kernel's own."""
        return self.kind in ("flash_attention", "best_iou")


@dataclasses.dataclass
class Trace:
    """What `Recorder` saw of one run."""
    flops: int = 0
    bytes: int = 0
    eqns: int = 0
    heavy: List[HeavyOp] = dataclasses.field(default_factory=list)
    nodes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def cost(self) -> Dict[str, int]:
        return {"flops": int(self.flops), "bytes": int(self.bytes),
                "eqns": int(self.eqns)}

    def count(self, name: str) -> int:
        """Calls of one op (`deepvision.best_iou`, `aten.mm`, ...)."""
        return int(self.nodes.get(name, 0))

    def products(self) -> List[HeavyOp]:
        """The heavy ops with each depthwise tap sum merged into one."""
        out: List[HeavyOp] = []
        merged: Dict[int, HeavyOp] = {}
        for op in self.heavy:
            if op.kind != "depthwise":
                out.append(op)
                continue
            head = merged.get(op.group)
            if head is None:
                head = merged[op.group] = dataclasses.replace(op)
                out.append(head)
            else:
                head.flops += op.flops
        return out


def _conv_fwd_flops(out_shape, weight_shape, transposed: bool, groups: int,
                    in_shape, stride) -> int:
    kh_kw = _numel(weight_shape[2:])
    if not transposed:
        return 2 * _numel(out_shape) * kh_kw * int(weight_shape[1])
    # JAX's lhs-dilated conv of a SAME ConvTranspose: input x stride
    n, c_out = int(out_shape[0]), int(out_shape[1])
    spatial = _numel(int(d) * int(s) for d, s in zip(in_shape[2:], stride))
    return 2 * n * c_out * spatial * kh_kw * (int(weight_shape[0]) // groups)


def _input_grad_flops(in_shape, weight_shape, transposed: bool,
                      groups: int) -> int:
    kh_kw = _numel(weight_shape[2:])
    c_out_per_group = (int(weight_shape[1]) if transposed
                       else int(weight_shape[0]) // groups)
    return 2 * _numel(in_shape) * kh_kw * c_out_per_group


class Recorder(TorchDispatchMode):
    """Records the op stream of whatever runs under it into `trace`."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        # id -> (tensor kept alive, its logical shape): padded tensors
        self._logical: Dict[int, Tuple[torch.Tensor, Tuple[int, ...]]] = {}
        # ids of int32 tensors widened from int8, and of tap products
        self._widened: Dict[int, torch.Tensor] = {}
        self._taps: Dict[int, Tuple[torch.Tensor, HeavyOp]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "aten" \
                and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            # under inference mode a composite op (aten.linear, aten.to)
            # reaches the mode whole; decomposed here it records as the
            # ops autograd would have run
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace in ("prim", "profiler"):
            return out
        name = op_name(func)
        self.trace.nodes[name] += 1
        self._track(name, func, args, out)
        if func.is_view or name in _SKIP:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.trace.eqns += 1
        heavy = self._heavy(name, args, kwargs, ins, outs)
        if heavy is not None:
            self.trace.heavy.append(heavy)
            self.trace.flops += heavy.flops
        if name == BEST_IOU:
            self.trace.bytes += _best_iou_bytes(args)
        else:
            self.trace.bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    # -- provenance ---------------------------------------------------------

    def logical_shape(self, t: torch.Tensor) -> Tuple[int, ...]:
        entry = self._logical.get(id(t))
        return entry[1] if entry is not None and entry[0] is t \
            else tuple(t.shape)

    def _track(self, name, func, args, out) -> None:
        if not isinstance(out, torch.Tensor) or not args \
                or not isinstance(args[0], torch.Tensor):
            return
        src = args[0]
        if name == "aten.constant_pad_nd":
            value = args[2] if len(args) > 2 else 0
            if value == 0:
                self._logical[id(out)] = (out, self.logical_shape(src))
        elif id(src) in self._logical and self._logical[id(src)][0] is src:
            shape = self._logical[id(src)][1]
            if name in _SAME_SHAPE and out.dim() == src.dim():
                self._logical[id(out)] = (out, shape)
            elif name in _TRANSPOSE_2D and out.dim() == 2 == src.dim():
                self._logical[id(out)] = (out, shape[::-1])
        if name == "aten._to_copy" and src.dtype == torch.int8 \
                and out.dtype == torch.int32:
            self._widened[id(out)] = out
        elif func.is_view and self._widened.get(id(src)) is src:
            self._widened[id(out)] = out

    def _is_widened(self, t) -> bool:
        return isinstance(t, torch.Tensor) and self._widened.get(id(t)) is t

    # -- heavy ops ----------------------------------------------------------

    def _heavy(self, name, args, kwargs, ins, outs) -> Optional[HeavyOp]:
        def make(kind, flops, operands, result):
            dims = frozenset(int(d) for t in ins + outs for d in t.shape)
            return HeavyOp(name, kind, int(flops),
                           tuple(t.dtype for t in operands), result.dtype,
                           tuple(result.shape), dims)

        if name in _CONV:
            x, w = args[0], args[1]
            stride, transposed, groups = args[3], bool(args[6]), int(args[8])
            flops = _conv_fwd_flops(outs[0].shape, w.shape, transposed,
                                    groups, x.shape, stride)
            return make("conv", flops, (x, w), outs[0])
        if name in _CONV_BWD:
            grad, x, w = args[0], args[1], args[2]
            stride, transposed, groups = args[4], bool(args[7]), int(args[9])
            mask = args[10]
            flops = 0
            if mask[0]:
                flops += _input_grad_flops(self.logical_shape(x), w.shape,
                                           transposed, groups)
            if mask[1]:
                flops += _conv_fwd_flops(grad.shape, w.shape, transposed,
                                         groups, x.shape, stride)
            result = next(t for t in outs)
            return make("conv_bwd", flops, (grad, x, w), result)
        if name in _DOTS:
            i, j = _DOTS[name]
            a, b = args[i], args[j]
            k = int(a.shape[-1])
            return make("dot", 2 * outs[0].numel() * k, (a, b), outs[0])
        if name == _INT_MM:
            a, b = args[0], args[1]
            m, k = self.logical_shape(a)
            n = self.logical_shape(b)[1]
            self._logical[id(outs[0])] = (outs[0], (m, n))
            return make("int_mm", 2 * m * n * k, (a, b), outs[0])
        if name == FLASH_ATTENTION:
            q = args[0]
            b, h, n, d = (int(s) for s in q.shape)
            return make("flash_attention", 4 * b * h * n * n * d,
                        tuple(args[:3]), outs[0])
        if name == BEST_IOU:
            return make("best_iou", 0, tuple(_tensors(args)), outs[0])
        if name == "aten.mul" and len(args) == 2 \
                and self._is_widened(args[0]) and self._is_widened(args[1]):
            op = make("depthwise", 2 * outs[0].numel(), args, outs[0])
            self._taps[id(outs[0])] = (outs[0], op)
            return op
        if name == "aten.add_" and len(args) == 2 \
                and isinstance(args[1], torch.Tensor):
            entry = self._taps.pop(id(args[1]), None)
            if entry is not None and entry[0] is args[1]:
                entry[1].group = id(args[0])
        return None


def _best_iou_bytes(args) -> int:
    """K2's bound bytes: each predicted box (16 B) and GT box (16 B)
    read once, each best IoU (4 B) written once."""
    preds, gt = args[0], args[1]
    b, m = int(gt.shape[0]), int(gt.shape[1])
    n = sum(int(p.shape[1]) for p in preds)
    return b * n * 16 + b * m * 16 + b * n * 4


def param_bytes(state: Dict[str, torch.Tensor]) -> int:
    """Bytes of a predict unit's weight arguments: the f32 masters a
    generation is handed to the engine as (its floating leaves at 4 bytes
    each, the count `serve/quantize.weight_bytes` reports as
    `weight_bytes_bf16`), whatever the engine casts them to."""
    return int(sum(4 * t.numel() for t in state.values()
                   if t.is_floating_point()))
