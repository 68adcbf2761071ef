"""Import the reference's Keras `save_weights` h5 checkpoints (own copy of
deepvision_tpu/utils/keras_convert.py), read by the port's own HDF5
reader (utils/h5.py) in place of h5py.

The reference's TF2 trainers save best-on-val-loss weights as h5
(`YOLO/tensorflow/train.py:244-257`), keyed by the builder's deterministic
layer names (`yolov3.py:23-235`: `conv2d_0_conv2d`, `residual_2_5_1x1_bn`,
`detector_scale_large_3x3_1_conv2d`, ...). Keras Conv2D kernels are HWIO,
as Flax's, so `convert` builds the JAX importer's Flax trees (BN gamma/
beta/moving_* renamed scale/bias/mean/var and placed in the tree), and
`to_state_dict` carries them onto the port's module through
utils/flax_convert.py.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .h5 import visit_datasets


def load_h5_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Flatten a Keras save_weights h5 into {layer_name: {weight: array}}.

    Handles nested submodels (the reference wraps Darknet as an inner
    `darknet_53` model, `yolov3.py:92`) by walking groups down to datasets
    and keying on the dataset's parent group name, in h5py's visit order
    (a later dataset of the same layer and weight name wins)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, array in visit_datasets(path):
        parts = name.split("/")
        layer = parts[-2] if len(parts) >= 2 else parts[0]
        weight = parts[-1].split(":")[0]
        out.setdefault(layer, {})[weight] = array
    return out


def _cbl(weights: Dict, name: str) -> Tuple[Dict, Dict]:
    """One DarknetConv (`<name>_conv2d` + `<name>_bn`) → the ConvBNLeaky
    tree ({Conv_0, BatchNorm_0} params + BN stats)."""
    conv = weights[f"{name}_conv2d"]
    bn = weights[f"{name}_bn"]
    p = {"Conv_0": {"kernel": conv["kernel"]},
         "BatchNorm_0": {"scale": bn["gamma"], "bias": bn["beta"]}}
    s = {"BatchNorm_0": {"mean": bn["moving_mean"],
                         "var": bn["moving_variance"]}}
    return p, s


def convert_yolov3(weights: Dict[str, Dict[str, np.ndarray]],
                   stage_blocks: Sequence[int] = (1, 2, 8, 8, 4)
                   ) -> Tuple[Dict, Dict]:
    """Reference YoloV3 h5 weights → (params, batch_stats) in the JAX
    YoloV3's tree (darknet53/tower_*/lateral_* naming)."""
    params: Dict = {}
    stats: Dict = {}

    # -- backbone: conv2d_0 stem, conv2d_{i+1} downsamples, residual_{i}_{j}
    dk_p: Dict = {}
    dk_s: Dict = {}
    dk_p["ConvBNLeaky_0"], dk_s["ConvBNLeaky_0"] = _cbl(weights, "conv2d_0")
    r = 0
    for stage, blocks in enumerate(stage_blocks):
        key = f"ConvBNLeaky_{stage + 1}"
        dk_p[key], dk_s[key] = _cbl(weights, f"conv2d_{stage + 1}")
        for j in range(blocks):
            blk_p: Dict = {}
            blk_s: Dict = {}
            for k, tap in enumerate(("1x1", "3x3")):
                sub = f"ConvBNLeaky_{k}"
                blk_p[sub], blk_s[sub] = _cbl(
                    weights, f"residual_{stage}_{j}_{tap}")
            dk_p[f"DarknetResidual_{r}"] = blk_p
            dk_s[f"DarknetResidual_{r}"] = blk_s
            r += 1
    params["darknet53"] = dk_p
    stats["darknet53"] = dk_s

    # -- detection towers + lateral transitions
    for scale in ("large", "medium", "small"):
        t_p: Dict = {}
        t_s: Dict = {}
        names = [f"detector_scale_{scale}_{tap}"
                 for tap in ("1x1_1", "3x3_1", "1x1_2", "3x3_2", "1x1_3",
                             "3x3_3")]
        for k, name in enumerate(names):
            sub = f"ConvBNLeaky_{k}"
            t_p[sub], t_s[sub] = _cbl(weights, name)
        final = weights[f"detector_scale_{scale}_final_conv2d"]
        t_p["final_conv"] = {"kernel": final["kernel"], "bias": final["bias"]}
        params[f"tower_{scale}"] = t_p
        stats[f"tower_{scale}"] = t_s
    for scale in ("medium", "small"):
        p, s = _cbl(weights, f"detector_scale_{scale}_1x1_0")
        params[f"lateral_{scale}"] = p
        stats[f"lateral_{scale}"] = s
    return params, stats


def convert(model_name: str, weights: Dict,
            stage_blocks: Sequence[int] = (1, 2, 8, 8, 4)
            ) -> Tuple[Dict, Dict]:
    if model_name in ("yolov3", "yolov3_voc"):
        return convert_yolov3(weights, stage_blocks)
    raise KeyError(f"no keras-weights converter for {model_name!r} "
                   f"(available: ['yolov3', 'yolov3_voc'])")


def stage_blocks_of(module) -> Tuple[int, ...]:
    """The residual blocks per stage of a port YoloV3 (its Darknet-53's
    layers: the stem, then each stage's downsample and residuals)."""
    from ..models.yolo import DarknetResidual
    blocks = []
    for layer in module.darknet53.layers[1:]:
        if isinstance(layer, DarknetResidual):
            blocks[-1] += 1
        else:
            blocks.append(0)
    return tuple(blocks)


def to_state_dict(model_name: str, weights: Dict, module) -> Dict:
    """The h5's `weights` (`load_h5_weights`) as the port's state_dict for
    `module` (a YoloV3 of `model_name`'s config, its stage depths read from
    the module): `convert`'s trees, then utils/flax_convert.py's
    `params_to_state_dict`, checked leaf for leaf against the module."""
    from .flax_convert import params_to_state_dict
    params, batch_stats = convert(model_name, weights,
                                  stage_blocks_of(module))
    return params_to_state_dict(params, module, batch_stats)
