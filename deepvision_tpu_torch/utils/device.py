"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU. Without a
card and without that request they raise: a serving process that quietly
fell back to the CPU would answer every request hundreds of times slower
and nothing would say why. Under a process group (parallel/mesh.py) each rank
drives its own card: `cuda` is `cuda:LOCAL_RANK`.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..parallel import mesh


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means `cuda`: the current card, or under a process group
    card LOCAL_RANK. A CUDA device on a host without one raises, and so
    does a rank whose card is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the CLI) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", mesh.local_rank()
                               if mesh.is_initialized()
                               else torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} does not exist: this host has "
                               f"{torch.cuda.device_count()} card(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def device_name(device: torch.device) -> str:
    """Human-readable name of `device` (the card's name on CUDA)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def to_device(array, device: torch.device) -> torch.Tensor:
    """A batch array on `device`: a host array through `torch.as_tensor`,
    a tensor (the record loaders make theirs on the card) moved only if
    it lies elsewhere."""
    if isinstance(array, torch.Tensor):
        return array.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(array)).to(device, non_blocking=True)


def to_host(array) -> np.ndarray:
    """A batch array as numpy (a tensor on any device copied back)."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def pad_rows(array, target: int):
    """`array` zero-padded along its first axis to `target` rows (numpy
    or a tensor, kept as it came)."""
    n = len(array)
    if isinstance(array, torch.Tensor):
        pad = array.new_zeros((target - n, *array.shape[1:]))
        return torch.cat([array, pad])
    array = np.asarray(array)
    return np.pad(array, [(0, target - n)] + [(0, 0)] * (array.ndim - 1))
