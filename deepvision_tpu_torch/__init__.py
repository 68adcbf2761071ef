"""PyTorch + CUDA port of deepvision_tpu for NVIDIA Hopper (H100).

The JAX package `deepvision_tpu` is the reference and stays as it is; this
package mirrors its layout (`configs.py`, `core/`, `models/`, `ops/`,
`serve/`, `utils/`) so every module has a counterpart under the same name.
It imports `torch`, never `jax`, and nothing of `deepvision_tpu`: what it
needs from there it keeps as its own copy.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"` / `--device cpu`); without a card and without that request
they raise instead of carrying on quietly on the CPU.

Kernels: the flash-attention forward (`ops/attention.py`) is a hand-written
CUDA kernel for sm_90a (`csrc/flash_attention.cu`), built with nvcc at first
use into `.cache/deepvision_tpu_torch/kernels/` (`ops/_build.py`).
"""
