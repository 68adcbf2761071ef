"""Weight bridge: the JAX package's Flax variables (`params`, and
`batch_stats` where the model has BatchNorm) → the port's `state_dict`.

Each tree is nested dicts of arrays (numpy, or anything `np.asarray`
takes), as `jax.device_get(variables["params"])` returns it. Leaf rules:

- Dense `kernel` (in, out) → `weight` (out, in);
- Conv `kernel` HWIO → `weight` OIHW;
- LayerNorm and BatchNorm `scale` → `weight`; every `bias` stays `bias`;
- `batch_stats` `mean` / `var` → the BatchNorm buffers `running_mean` /
  `running_var`;
- any other leaf (`cls_token`, `pos_embed`) keeps its name and value.

Module names map one to one, except that Flax's numbered `block<i>`
children are the port's `blocks.<i>`. Children that Flax names itself
(`<Class>_<i>`, counted per class in creation order) carry the same names
in the port, which registers them through `flax_auto_names`. Every Flax
leaf is used exactly once: a leaf the module does not have, a module entry
no leaf fills, two leaves landing on one name, or a shape that does not
match all raise.
"""

from __future__ import annotations

import re
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional,
                    Tuple)

import numpy as np
import torch

_BLOCK = re.compile(r"^block(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}
# torch's BatchNorm counts its training steps in this buffer; Flax keeps no
# such leaf, so it is the one state_dict entry no Flax leaf fills
_UNFILLED = "num_batches_tracked"


def flax_auto_names(modules: Iterable[torch.nn.Module]
                    ) -> List[Tuple[str, torch.nn.Module]]:
    """The names Flax gives unnamed children: `<ClassName>_<i>`, i counting
    the children of that class in creation order (`ConvBNLeaky_0`,
    `ConvBNLeaky_1`, `DarknetResidual_0`, ...). A port module registers its
    children under these names so the bridge maps them one to one."""
    counts: Dict[str, int] = {}
    named = []
    for m in modules:
        cls = type(m).__name__
        named.append((f"{cls}_{counts.get(cls, 0)}", m))
        counts[cls] = counts.get(cls, 0) + 1
    return named


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray,
                  stats: bool = False) -> Tuple[str, np.ndarray]:
    *modules, leaf = path
    modules = [f"blocks.{m.group(1)}" if (m := _BLOCK.match(name)) else name
               for name in modules]
    if stats:
        if leaf not in _STATS:
            raise KeyError(f"batch_stats leaf {'/'.join(path)!r} is not a "
                           f"BatchNorm mean or var")
        leaf = _STATS[leaf]
    elif leaf == "kernel":
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


def params_to_state_dict(params: Mapping, module: torch.nn.Module,
                         batch_stats: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    """Convert a Flax `params` tree (and its `batch_stats` tree, for a model
    with BatchNorm) into a state_dict for `module` (f32 tensors on the
    CPU), checked leaf for leaf against the module's own. The result loads
    with `load_state_dict(..., strict=False)` when the module has
    `num_batches_tracked` buffers, which it leaves as they are."""
    expected = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    sources: Dict[str, str] = {}
    leaves = [(p, v, False) for p, v in _leaves(params)]
    leaves += [(p, v, True) for p, v in _leaves(batch_stats or {})]
    for path, value, stats in leaves:
        name, value = _convert_leaf(path, value, stats)
        src = ("batch_stats/" if stats else "") + "/".join(path)
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
    missing = sorted(k for k in set(expected) - set(out)
                     if k.rsplit(".", 1)[-1] != _UNFILLED)
    if missing:
        raise KeyError(f"no Flax leaf fills {missing} of "
                       f"{type(module).__name__}")
    return out
