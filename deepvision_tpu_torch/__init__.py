"""PyTorch + CUDA port of deepvision_tpu for NVIDIA Hopper (H100).

The JAX package `deepvision_tpu` is the reference and stays as it is; this
package mirrors its layout (`configs.py`, `cli.py`, `core/`, `data/`,
`models/`, `ops/`, `serve/`, `utils/`) so every module has a counterpart
under the same name.
It imports `torch`, never `jax`, and nothing of `deepvision_tpu`: what it
needs from there it keeps as its own copy.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"` / `--device cpu`); without a card and without that request
they raise instead of carrying on quietly on the CPU.

Kernels, each a hand-written CUDA kernel for sm_90a built with nvcc at first
use into `.cache/deepvision_tpu_torch/kernels/` (`ops/_build.py`): the
flash-attention forward (`ops/attention.py`, `csrc/flash_attention.cu`) and
the YOLO loss's best IoU (`ops/best_iou.py`, `csrc/best_iou.cu`).
"""
