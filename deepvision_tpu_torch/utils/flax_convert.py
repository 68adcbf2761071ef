"""Weight bridge: the JAX package's Flax `params` tree → the port's
`state_dict`.

The tree is nested dicts of arrays (numpy, or anything `np.asarray` takes),
as `jax.device_get(variables["params"])` returns it. Leaf rules:

- Dense `kernel` (in, out) → `weight` (out, in);
- Conv `kernel` HWIO → `weight` OIHW;
- LayerNorm `scale` → `weight`; every `bias` stays `bias`;
- any other leaf (`cls_token`, `pos_embed`) keeps its name and value.

Module names map one to one, except that Flax's numbered `block<i>`
children are the port's `blocks.<i>`. Every Flax leaf is used exactly once:
a leaf the module does not have, a module parameter no leaf fills, two
leaves landing on one name, or a shape that does not match all raise.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"^block(\d+)$")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray
                  ) -> Tuple[str, np.ndarray]:
    *modules, leaf = path
    modules = [f"blocks.{m.group(1)}" if (m := _BLOCK.match(name)) else name
               for name in modules]
    if leaf == "kernel":
        if value.ndim == 2:
            value, leaf = value.T, "weight"
        elif value.ndim == 4:
            value, leaf = value.transpose(3, 2, 0, 1), "weight"
        else:
            raise ValueError(f"kernel {'/'.join(path)} has unsupported rank "
                             f"{value.ndim}")
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*modules, leaf]), value


def params_to_state_dict(params: Mapping, module: torch.nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """Convert a Flax `params` tree into a state_dict for `module` (f32
    tensors on the CPU), checked leaf for leaf against the module's own."""
    expected = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    sources: Dict[str, str] = {}
    for path, value in _leaves(params):
        name, value = _convert_leaf(path, value)
        src = "/".join(path)
        if name in out:
            raise ValueError(f"Flax leaves {sources[name]!r} and {src!r} "
                             f"both map to {name!r}")
        if name not in expected:
            raise KeyError(f"Flax leaf {src!r} ({name!r}) has no "
                           f"counterpart in {type(module).__name__}")
        if tuple(value.shape) != tuple(expected[name].shape):
            raise ValueError(f"Flax leaf {src!r} has shape {value.shape}, "
                             f"{name!r} expects "
                             f"{tuple(expected[name].shape)}")
        out[name] = torch.tensor(value, dtype=torch.float32)
        sources[name] = src
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"no Flax leaf fills {missing} of "
                       f"{type(module).__name__}")
    return out
