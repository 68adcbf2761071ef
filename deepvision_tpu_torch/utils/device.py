"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU. Without a
card and without that request they raise: a serving process that quietly
fell back to the CPU would answer every request hundreds of times slower
and nothing would say why.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means `cuda`. A CUDA device on a host without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the CLI) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def device_name(device: torch.device) -> str:
    """Human-readable name of `device` (the card's name on CUDA)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
