"""Model export: an eval-mode module → a `torch.export` program → an
AOTInductor package (port of deepvision_tpu/core/export.py).

The JAX package bridges Flax to TensorFlow: `jax2tf.convert` of the apply
function with the trained variables closed over, saved as a SavedModel,
optionally converted to TFLite (the reference's
`CycleGAN/tensorflow/convert.py:8-14`). The port's counterparts:

- `export_program` ↔ `export_saved_model`: `torch.export.export` of the
  eval-mode module with its weights inside, one NHWC f32 input named
  `images` with a static batch, written by `torch.export.save` beside a
  small signature JSON. `load_program` reads it back in any process.
- `compile_package` ↔ `convert_tflite`: the artifact that runs without
  the training framework's Python is an AOTInductor package
  (`torch._inductor.aoti_compile_and_package`); `export_package` ↔
  `export_tflite` does both steps, `load_package` runs it. TFLite's
  `Optimize.DEFAULT` is weight quantization, which a float package has
  no counterpart of: the CLIs accept `--no-optimize` and ignore it.
- `rewrite_transposed_convs` ↔ the JAX function of that name: every
  transposed convolution becomes zero-stuffing plus a plain convolution,
  exact up to round-off, a no-op without transposed convs, applied on
  every export as the JAX package applies it.

Kernel K1 is the registered operator `deepvision::flash_attention`
(ops/attention.py): an exported graph holds one node per attention call,
and a package calls the operator through AOTInductor's proxy executor,
so on a CUDA tensor the hand-written kernel launches; the plain version
is never inlined into a package (`compile_package` checks the package's
own record of the operators it calls).
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import tempfile
import time
import zipfile
from typing import Optional, Sequence

import torch
from torch import nn

#: the program's input name, as in the JAX SavedModel's signature
INPUT_NAME = "images"
PROGRAM_FILE = "program.pt2"
SIGNATURE_FILE = "signature.json"
#: K1's operator as an exported graph names it, and as a package's
#: record of its proxy-executor calls names it
FLASH_ATTENTION_OP = "deepvision.flash_attention"
FLASH_ATTENTION_TARGET = "deepvision::flash_attention"


class ExportError(RuntimeError):
    """An export that cannot keep its contract (an operator of the port's
    own that a package would not call)."""


class _Serve(nn.Module):
    """`module(images)`: the program's one input carries the signature's
    name."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, images: torch.Tensor):
        return self.module(images)


def _register_operators() -> None:
    """Import the modules that register the port's operators, so that a
    program or package naming them loads in a fresh process."""
    from ..ops import attention  # noqa: F401


def _zero_stuff(x: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """Insert `s-1` zeros between the elements of each spatial dim of an
    N, C, *spatial tensor (expand, concatenate zeros, reshape, slice), the
    explicit form of a transposed convolution's input dilation."""
    for dim, s in enumerate(stride, start=2):
        if s <= 1:
            continue
        n = x.shape[dim]
        xe = x.unsqueeze(dim + 1)
        y = torch.cat([xe] + [torch.zeros_like(xe)] * (s - 1), dim + 1)
        shape = list(x.shape)
        shape[dim] = n * s
        x = y.reshape(shape).narrow(dim, 0, n * s - (s - 1))
    return x


def _stuffed_conv_transpose(x, weight, bias=None, stride=1, padding=0,
                            output_padding=0, groups=1, dilation=1):
    """`conv_transpose{1,2,3}d` as zero-stuffing plus a plain convolution:
    the input dilated by the stride, padded by d*(k-1)-p before and that
    plus the output padding after (a negative pad crops), correlated with
    the kernel flipped and its in and out channels swapped per group."""
    nd = weight.dim() - 2

    def tup(v):
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * nd

    stride, padding, output_padding, dilation = map(
        tup, (stride, padding, output_padding, dilation))
    ks = weight.shape[2:]
    x = _zero_stuff(x, stride)
    pads = []
    for k, p, d, op in reversed(list(zip(ks, padding, dilation,
                                         output_padding))):
        low = d * (k - 1) - p
        pads += [low, low + op]
    x = torch.constant_pad_nd(x, pads, 0.0)
    cin, per_group = weight.shape[:2]
    w = (weight.reshape(groups, cin // groups, per_group, *ks)
         .transpose(1, 2).reshape(groups * per_group, cin // groups, *ks)
         .flip(list(range(2, 2 + nd))))
    return torch.ops.aten.convolution.default(
        x, w, bias, [1] * nd, [0] * nd, list(dilation), False, [0] * nd,
        groups)


def _is_transposed_conv(node) -> bool:
    aten = torch.ops.aten
    if node.op != "call_function":
        return False
    if node.target in (aten.conv_transpose1d.default,
                       aten.conv_transpose2d.input,
                       aten.conv_transpose3d.input):
        return True
    return node.target is aten.convolution.default and bool(node.args[6])


def transposed_convs(program) -> int:
    """How many transposed convolutions `program`'s graph holds."""
    return sum(_is_transposed_conv(n) for n in program.graph.nodes)


def rewrite_transposed_convs(program):
    """Re-express every transposed convolution of an exported program as
    zero-insertion plus a plain convolution (the JAX package's rewrite of
    lhs-dilated convolutions, which TFLite mis-lowers).

    The pass retargets each `aten.convolution(transposed=True)` node to
    the `conv_transpose<n>d` op of the same arguments, then re-traces the
    program with those ops decomposed by `_stuffed_conv_transpose`, so
    every new node carries its shapes. Zero-stuffing is the definition of
    a transposed convolution, so the result equals the input program's up
    to float round-off; a program without one comes back as it is."""
    if not transposed_convs(program):
        return program
    aten = torch.ops.aten
    by_rank = {1: aten.conv_transpose1d.default,
               2: aten.conv_transpose2d.input,
               3: aten.conv_transpose3d.input}
    graph = program.graph_module.graph
    for node in graph.nodes:
        if node.op == "call_function" \
                and node.target is aten.convolution.default \
                and node.args[6]:
            x, w, b, stride, pad, dil, _, out_pad, groups = node.args
            node.target = by_rank[len(stride)]
            node.args = (x, w, b, stride, pad, out_pad, groups, dil)
    program.graph_module.recompile()
    return program.run_decompositions(
        {op: _stuffed_conv_transpose for op in by_rank.values()})


def flash_attention_nodes(program) -> int:
    """How many calls of K1's operator `program`'s graph holds."""
    return sum(n.op == "call_function" and FLASH_ATTENTION_OP in str(n.target)
               for n in program.graph.nodes)


def export_program(module: nn.Module, input_shape: Sequence[int],
                   path: Optional[str] = None, *, batch_size: int = 1,
                   name: Optional[str] = None):
    """`torch.export` of the eval-mode `module` with its weights inside,
    on the device its weights lie on; transposed convolutions rewritten.

    `input_shape` is per example, (H, W, C) for an image model; the
    program takes one f32 tensor `images` of (batch_size, *input_shape).
    With `path` the program is written there as a directory holding
    `program.pt2` and `signature.json` (input name, shape, dtype, config
    name, device). Returns the `ExportedProgram`."""
    module = module.eval()
    device = next(module.parameters()).device
    example = torch.zeros((batch_size, *input_shape), dtype=torch.float32,
                          device=device)
    program = torch.export.export(_Serve(module), (example,), strict=False)
    program = rewrite_transposed_convs(program)
    if path is not None:
        os.makedirs(path, exist_ok=True)
        torch.export.save(program, os.path.join(path, PROGRAM_FILE))
        with open(os.path.join(path, SIGNATURE_FILE), "w") as fp:
            json.dump({"input": INPUT_NAME,
                       "shape": [batch_size, *map(int, input_shape)],
                       "dtype": "float32", "config": name,
                       "device": str(device)}, fp, indent=1)
    return program


def load_signature(path: str) -> dict:
    with open(os.path.join(path, SIGNATURE_FILE)) as fp:
        return json.load(fp)


def load_program(path: str):
    """The `ExportedProgram` that `export_program` wrote to `path`, with
    the port's operators registered first; run it as
    `program.module()(images)`."""
    _register_operators()
    return torch.export.load(os.path.join(path, PROGRAM_FILE))


def package_operators(path: str) -> list:
    """The names of the operators a package calls through AOTInductor's
    proxy executor, from the package's own JSON record of them."""
    names = []
    with zipfile.ZipFile(path) as zf:
        for entry in zf.namelist():
            if not entry.endswith(".json"):
                continue
            try:
                doc = json.loads(zf.read(entry))
            except ValueError:
                continue
            for node in (doc.get("nodes", []) if isinstance(doc, dict)
                         else []):
                target = node.get("node", {}).get("target")
                if target:
                    names.append(target)
    return names


@functools.cache
def package_compiler() -> str:
    """The C++ compiler AOTInductor builds a package with: the first of
    `$CXX`, `g++`, `c++` and `clang++` that links an OpenMP program (the
    package's wrapper is linked with `-fopenmp`). A `$CXX` that cannot,
    such as a gcc without its `libgomp.spec`, is passed over; with none
    that can, `ExportError` names what was tried."""
    tried = []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cpp")
        with open(src, "w") as fh:
            fh.write("#include <omp.h>\nint main() { "
                     "return omp_get_max_threads() < 1; }\n")
        for cxx in dict.fromkeys(c for c in (os.environ.get("CXX"), "g++",
                                             "c++", "clang++") if c):
            try:
                done = subprocess.run(
                    [cxx, "-fopenmp", src, "-o", os.path.join(tmp, "omp")],
                    capture_output=True, text=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired) as exc:
                tried.append(f"{cxx}: {exc}")
                continue
            if done.returncode == 0:
                return cxx
            tried.append(f"{cxx}: {done.stderr.strip()[-200:]}")
    raise ExportError("no C++ compiler here links OpenMP, which an "
                      "AOTInductor package needs: " + "; ".join(tried))


def compile_package(program, path: str) -> str:
    """Compile `program` with AOTInductor (the C++ compiler
    `package_compiler` picks) into the package `path` (any file name). A
    program that calls K1's operator must give a package that calls it
    too: one whose record names the operator fewer times than the graph
    does raises `ExportError`."""
    import torch._inductor
    configs = {"cpp.cxx": (package_compiler(),)}
    want = flash_attention_nodes(program)
    out_dir = os.path.dirname(os.path.abspath(path))
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=out_dir, prefix=".package-")
    try:
        built = torch._inductor.aoti_compile_and_package(
            program, package_path=os.path.join(tmp, "package.pt2"),
            inductor_configs=configs)
        got = package_operators(built).count(FLASH_ATTENTION_TARGET)
        if got < want:
            raise ExportError(
                f"the program calls {FLASH_ATTENTION_OP} {want} times but "
                f"the package records {got} calls through the proxy "
                f"executor: it would not launch the kernel")
        os.replace(built, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def export_package(module: nn.Module, input_shape: Sequence[int],
                   output_path: str, *, batch_size: int = 1,
                   saved_model_dir: Optional[str] = None,
                   name: Optional[str] = None) -> str:
    """One call from module to package: `export_program` (written to
    `saved_model_dir` when given) then `compile_package`, each step's
    seconds printed."""
    t0 = time.perf_counter()
    program = export_program(module, input_shape, saved_model_dir,
                             batch_size=batch_size, name=name)
    t1 = time.perf_counter()
    print(f"[export] program exported in {t1 - t0:.1f}s", flush=True)
    compile_package(program, output_path)
    print(f"[export] package compiled in {time.perf_counter() - t1:.1f}s",
          flush=True)
    return output_path


def load_package(path: str):
    """The compiled package at `path`, with the port's operators
    registered first: call it as `runner(images)`."""
    _register_operators()
    import torch._inductor
    return torch._inductor.aoti_load_package(path)
