"""Import the reference's GAN `tf.train.Checkpoint` weights (own copy of
deepvision_tpu/utils/gan_convert.py), read by the port's own tensor-bundle
reader (utils/tf_checkpoint.py) in place of TensorFlow.

The reference saves its GANs with `tf.train.Checkpoint(...)` +
CheckpointManager (DCGAN: `DCGAN/tensorflow/main.py:34-39`, objects
`generator`/`discriminator`; CycleGAN: `CycleGAN/tensorflow/train.py:
134-148`, objects `generator_a2b`/`generator_b2a`/`discriminator_a`/
`discriminator_b`), not Keras h5.

Variable paths differ across Keras generations (`layer_with_weights-N/...`
in the TF 2.1 era that produced the published checkpoints; `_functional/
_operations/N/...` in current Keras, which also writes Conv and Dense
kernels as `_kernel`), so parsing keys on the ordered numeric layer index
plus the stable attribute names (kernel/bias/gamma/beta/moving_mean/
moving_variance) and, inside the CycleGAN ResNetBlock, its fixed sublayer
names (`conv1/bn1/conv2/bn2`, `CycleGAN/tensorflow/models.py:17-28`).

The converters return the JAX importer's Flax trees, which
utils/flax_convert.py's leaf rules carry onto the port's modules.
- Conv2D kernels are HWIO in Keras and Flax: copied as they are.
- Conv2DTranspose kernels are (kh, kw, out, in) in Keras and compute the
  gradient of a conv; Flax's `nn.ConvTranspose` (and the port's
  `ConvTranspose`) applies its kernel as it is, so the kernel becomes
  (kh, kw, in, out), flipped in space.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np

from .tf_checkpoint import CheckpointReader, crc32c_np, load_checkpoint

_ATTRS = ("kernel", "bias", "gamma", "beta", "moving_mean", "moving_variance")
_SUBLAYER_ORDER = {"conv1": 0, "bn1": 1, "conv2": 2, "bn2": 3}


def open_reader(ckpt_path: str, crc: Callable[[bytes], int] = crc32c_np
                ) -> CheckpointReader:
    """Resolve a checkpoint prefix (`.../ck-5`) or a directory (latest is
    used) into one reader, shared across `convert_object` calls so a
    multi-object import reads the index once. `crc` checks every block
    and tensor (utils/tf_checkpoint.py)."""
    return load_checkpoint(ckpt_path, crc)


def load_object_groups(ckpt_or_reader, obj: str) -> List[Dict[str, np.ndarray]]:
    """Read one checkpointed object's weight layers, in execution order.

    Returns a list of {attr: array} groups, one per weighted Keras layer,
    ordered by layer index (and sublayer position inside the reference's
    ResNetBlock). Accepts a path (prefix or directory) or an
    `open_reader` result.
    """
    reader = (ckpt_or_reader if hasattr(ckpt_or_reader, "get_tensor")
              else open_reader(ckpt_or_reader))
    pat = re.compile(rf"^{re.escape(obj)}/(?P<body>.+)/\.ATTRIBUTES/VARIABLE_VALUE$")
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for name in reader.get_variable_to_shape_map():
        m = pat.match(name)
        if not m:
            continue
        parts = m.group("body").split("/")
        attr = parts[-1].lstrip("_")  # Keras 3 writes Conv/Dense as `_kernel`
        if attr not in _ATTRS or "OPTIMIZER" in name:
            continue
        gkey = "/".join(parts[:-1])
        groups.setdefault(gkey, {})[attr] = reader.get_tensor(name)
    if not groups:
        raise KeyError(f"checkpoint has no weights under object {obj!r}")

    def sort_key(gkey: str):
        key = []
        for p in gkey.split("/"):
            if p.isdigit():
                key.append((0, int(p)))
            elif p.startswith("layer_with_weights-"):
                key.append((0, int(p.rsplit("-", 1)[-1])))
            elif p in _SUBLAYER_ORDER:
                key.append((1, _SUBLAYER_ORDER[p]))
        return tuple(key)

    return [groups[k] for k in sorted(groups, key=sort_key)]


def _check_count(groups: List[Dict], expect: int, what: str) -> None:
    """The JAX converters' assertion, raised also under `python -O`."""
    if len(groups) != expect:
        raise ValueError(f"{what}: {len(groups)} weight layers in the "
                         f"checkpoint, {expect} expected")


def _take_bn(group, params, stats, name):
    params[name] = {"scale": group["gamma"], "bias": group["beta"]}
    stats[name] = {"mean": group["moving_mean"],
                   "var": group["moving_variance"]}


def _conv(group) -> Dict:
    out = {"kernel": group["kernel"]}
    if "bias" in group:
        out["bias"] = group["bias"]
    return out


def _conv_transpose(group) -> Dict:
    k = np.transpose(group["kernel"], (0, 1, 3, 2))[::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(k)}
    if "bias" in group:
        out["bias"] = group["bias"]
    return out


def convert_dcgan_generator(groups: List[Dict]) -> Tuple[Dict, Dict]:
    """Dense → BN → CT128 → BN → CT64 → BN → CT1
    (`DCGAN/tensorflow/models.py:30-65`)."""
    _check_count(groups, 7, "DCGAN generator")
    params: Dict = {}
    stats: Dict = {}
    params["Dense_0"] = {"kernel": groups[0]["kernel"]}
    _take_bn(groups[1], params, stats, "BatchNorm_0")
    params["ConvTranspose_0"] = _conv_transpose(groups[2])
    _take_bn(groups[3], params, stats, "BatchNorm_1")
    params["ConvTranspose_1"] = _conv_transpose(groups[4])
    _take_bn(groups[5], params, stats, "BatchNorm_2")
    params["ConvTranspose_2"] = _conv_transpose(groups[6])
    return params, stats


def convert_dcgan_discriminator(groups: List[Dict]) -> Tuple[Dict, Dict]:
    """conv64 → conv128 → dense(1) (`DCGAN/tensorflow/models.py:8-27`)."""
    _check_count(groups, 3, "DCGAN discriminator")
    params = {"Conv_0": _conv(groups[0]), "Conv_1": _conv(groups[1]),
              "Dense_0": {"kernel": groups[2]["kernel"],
                          "bias": groups[2]["bias"]}}
    return params, {}


def cyclegan_blocks(groups: List[Dict]) -> int:
    """The residual blocks of a CycleGAN generator's weight layers: 3
    encode convs and BNs, 4 layers a block, 2 decode transposed convs and
    BNs, the last conv."""
    return (len(groups) - 11) // 4


def convert_cyclegan_generator(groups: List[Dict],
                               n_blocks: int = 9) -> Tuple[Dict, Dict]:
    """c7s1-64, d128, d256, R256×n, u128, u64, c7s1-3
    (`CycleGAN/tensorflow/models.py:41-78`)."""
    _check_count(groups, 6 + 4 * n_blocks + 2 * 2 + 1,
                 f"CycleGAN generator of {n_blocks} blocks")
    params: Dict = {}
    stats: Dict = {}
    it = iter(groups)
    for i in range(3):  # encode: conv + bn
        params[f"Conv_{i}"] = _conv(next(it))
        _take_bn(next(it), params, stats, f"BatchNorm_{i}")
    for b in range(n_blocks):  # transform: conv1 bn1 conv2 bn2
        bp: Dict = {}
        bs: Dict = {}
        bp["Conv_0"] = _conv(next(it))
        _take_bn(next(it), bp, bs, "BatchNorm_0")
        bp["Conv_1"] = _conv(next(it))
        _take_bn(next(it), bp, bs, "BatchNorm_1")
        params[f"CycleGANResBlock_{b}"] = bp
        stats[f"CycleGANResBlock_{b}"] = bs
    for i in range(2):  # decode: convT + bn
        params[f"ConvTranspose_{i}"] = _conv_transpose(next(it))
        _take_bn(next(it), params, stats, f"BatchNorm_{3 + i}")
    params["Conv_3"] = _conv(next(it))  # c7s1-3 (has bias)
    return params, stats


def convert_cyclegan_discriminator(groups: List[Dict]) -> Tuple[Dict, Dict]:
    """C64 → (C128, C256, C512 each + BN) → C1 patch head
    (`CycleGAN/tensorflow/models.py:81-104`)."""
    _check_count(groups, 8, "PatchGAN discriminator")
    params: Dict = {}
    stats: Dict = {}
    it = iter(groups)
    params["Conv_0"] = _conv(next(it))
    for i in range(3):
        params[f"Conv_{1 + i}"] = _conv(next(it))
        _take_bn(next(it), params, stats, f"BatchNorm_{i}")
    params["Conv_4"] = _conv(next(it))
    return params, stats


# checkpointed-object name (as the reference constructs it) → converter +
# the registered model name
CONVERTERS = {
    "generator": (convert_dcgan_generator, "dcgan_generator"),
    "discriminator": (convert_dcgan_discriminator, "dcgan_discriminator"),
    "generator_a2b": (convert_cyclegan_generator, "cyclegan_generator"),
    "generator_b2a": (convert_cyclegan_generator, "cyclegan_generator"),
    "discriminator_a": (convert_cyclegan_discriminator, "patchgan_discriminator"),
    "discriminator_b": (convert_cyclegan_discriminator, "patchgan_discriminator"),
}


def convert_object(ckpt_or_reader, obj: str, **kw) -> Tuple[Dict, Dict]:
    """(params, batch_stats) for one checkpointed object by its reference
    name."""
    if obj not in CONVERTERS:
        raise KeyError(f"unknown GAN checkpoint object {obj!r}; "
                       f"known: {', '.join(sorted(CONVERTERS))}")
    fn, _ = CONVERTERS[obj]
    return fn(load_object_groups(ckpt_or_reader, obj), **kw)

