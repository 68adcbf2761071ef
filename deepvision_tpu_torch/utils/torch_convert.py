"""Import the reference's PyTorch checkpoints (own copy of
deepvision_tpu/utils/torch_convert.py, numpy only).

The reference publishes trained `.pt` checkpoints per model README
(`ResNet/pytorch/README.md:71`: `{epoch, model, optimizer, scheduler,
loggers}` dicts saved by `ResNet/pytorch/train.py:417-428`). `convert`
maps the `model` state_dict onto the JAX package's Flax-layout trees,
array for array what the JAX importer gives:

- conv weights OIHW → HWIO;
- linear weights (out, in) → (in, out);
- BatchNorm weight/bias/running_mean/running_var → scale/bias + mean/var
  batch_stats;
- `module.`-prefixed keys (their `nn.DataParallel` wrap,
  `ResNet/pytorch/train.py:352-355`) are stripped.

`to_state_dict` composes it with utils/flax_convert.py into the port's
own state_dict of a module built with the importer's pins, so the one
mapping serves both packages.

Architectural caveat, handled: the reference strides bottlenecks on conv1
(`resnet50.py:101-106`), the zoo defaults to the 3x3 — build the model with
`model_kwargs={"stride_on_first": True}` (what
`tools/import_torch_checkpoint.py` pins) so imported weights compute the
same function.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

RESNET_TORCH_STAGES = ("conv2x", "conv3x", "conv4x", "conv5x")
RESNET_STAGE_SIZES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv_w(sd, key):
    """torch OIHW → flax HWIO."""
    return _np(sd[key]).transpose(2, 3, 1, 0)


def strip_data_parallel(sd: Dict) -> Dict:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def _bn(sd, prefix) -> Tuple[Dict, Dict]:
    p = {"BatchNorm_0": {"scale": _np(sd[prefix + ".weight"]),
                         "bias": _np(sd[prefix + ".bias"])}}
    s = {"BatchNorm_0": {"mean": _np(sd[prefix + ".running_mean"]),
                         "var": _np(sd[prefix + ".running_var"])}}
    return p, s


class _RecordingDict(dict):
    """Records key reads so leftover-weight detection can catch a checkpoint
    whose depth doesn't match the requested model (e.g. a resnet152 .pt fed to
    -m resnet101 — every indexed key exists, widths match, output is garbage)."""

    def __init__(self, base):
        super().__init__(base)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def _convert_resnet(state_dict: Dict, stage_sizes, convs_per_block: int,
                    block_name: str) -> Tuple[Dict, Dict]:
    """Shared reference-ResNet mapper: stem_conv/_BN_0, per-block
    Conv_j/_BN_j (+ proj/_BN_<convs_per_block>), head."""
    sd = _RecordingDict(strip_data_parallel(state_dict))
    params: Dict = {"stem_conv": {"kernel": _conv_w(sd, "conv1.weight")}}
    stats: Dict = {}
    params["_BN_0"], stats["_BN_0"] = _bn(sd, "bn1")
    params["head"] = {"kernel": _np(sd["linear.weight"]).T,
                      "bias": _np(sd["linear.bias"])}

    b = 0
    for stage, n in zip(RESNET_TORCH_STAGES, stage_sizes):
        for i in range(n):
            t = f"{stage}.{i}"
            blk_p: Dict = {}
            blk_s: Dict = {}
            for j in range(convs_per_block):
                blk_p[f"Conv_{j}"] = {"kernel": _conv_w(sd, f"{t}.conv{j + 1}.weight")}
                blk_p[f"_BN_{j}"], blk_s[f"_BN_{j}"] = _bn(sd, f"{t}.bn{j + 1}")
            if f"{t}.projection.0.weight" in sd:
                blk_p["proj"] = {"kernel": _conv_w(sd, f"{t}.projection.0.weight")}
                blk_p[f"_BN_{convs_per_block}"], blk_s[f"_BN_{convs_per_block}"] = \
                    _bn(sd, f"{t}.projection.1")
            params[f"{block_name}_{b}"] = blk_p
            stats[f"{block_name}_{b}"] = blk_s
            b += 1

    leftover = {k for k in sd if k not in sd.used
                and not k.endswith("num_batches_tracked")}
    if leftover:
        raise ValueError(
            f"{len(leftover)} unconsumed weights (e.g. {sorted(leftover)[:3]}) "
            f"— checkpoint depth doesn't match stage_sizes={tuple(stage_sizes)}; "
            f"wrong -m model for this .pt?")
    return params, stats


def convert_resnet_bottleneck(state_dict: Dict, stage_sizes) -> Tuple[Dict, Dict]:
    """Reference bottleneck-ResNet state_dict → (params, batch_stats) matching
    `models/resnet.py` naming (stem_conv/_BN_0/BottleneckBlock_i/head)."""
    return _convert_resnet(state_dict, stage_sizes, 3, "BottleneckBlock")


def _linear_w(sd, key, flatten_hwc: Tuple[int, int, int] = None):
    """torch (out, in) → flax (in, out); `flatten_hwc=(H, W, C)` additionally
    permutes a first-FC weight from torch's CHW flatten order to our NHWC
    flatten order (`x.reshape(n, -1)` of an NHWC tensor)."""
    w = _np(sd[key])
    if flatten_hwc is not None:
        h, wd, c = flatten_hwc
        w = w.reshape(w.shape[0], c, h, wd).transpose(2, 3, 1, 0)
        return w.reshape(h * wd * c, -1)
    return w.T


def convert_sequential_cnn(state_dict: Dict, first_fc_hwc: Tuple[int, int, int]
                           ) -> Tuple[Dict, Dict]:
    """Reference VGG / AlexNet state_dicts → Flax trees.

    Both families are `features` (convs at Sequential indices among
    ReLU/LRN/MaxPool) + `classifier` (Linears at indices among Dropout/ReLU)
    (`VGG/pytorch/models/vgg16.py:25-110`, `AlexNet/pytorch/models/
    alexnet_v2.py:30-64`). Convs map in index order to Conv_0.. and Linears
    to Dense_0..; the first Linear's weight is permuted from the torch CHW
    flatten to our NHWC flatten (`first_fc_hwc` = conv output (H, W, C))."""
    sd = _RecordingDict(strip_data_parallel(state_dict))
    conv_idx = sorted(int(k.split(".")[1]) for k in sd
                      if k.startswith("features.") and k.endswith(".weight"))
    fc_idx = sorted(int(k.split(".")[1]) for k in sd
                    if k.startswith("classifier.") and k.endswith(".weight"))
    params: Dict = {}
    for j, i in enumerate(conv_idx):
        params[f"Conv_{j}"] = {"kernel": _conv_w(sd, f"features.{i}.weight"),
                               "bias": _np(sd[f"features.{i}.bias"])}
    for j, i in enumerate(fc_idx):
        params[f"Dense_{j}"] = {
            "kernel": _linear_w(sd, f"classifier.{i}.weight",
                                first_fc_hwc if j == 0 else None),
            "bias": _np(sd[f"classifier.{i}.bias"])}
    leftover = {k for k in sd if k not in sd.used}
    if leftover:
        raise ValueError(f"unconsumed weights: {sorted(leftover)[:5]}")
    return params, {}


def convert_lenet5(state_dict: Dict) -> Tuple[Dict, Dict]:
    """Reference LeNet-5 state_dict → Flax trees (`LeNet/pytorch/models/
    lenet5.py:24-60`: convs at features indices 0/4/8 among Tanh/AvgPool,
    Linears at classifier 0/2). C5's 1x1 spatial output makes the flatten
    permutation trivial."""
    sd = _RecordingDict(strip_data_parallel(state_dict))
    conv_names = ("c1", "c3", "c5")
    conv_idx = sorted(int(k.split(".")[1]) for k in sd
                      if k.startswith("features.") and k.endswith(".weight"))
    params: Dict = {}
    for name, i in zip(conv_names, conv_idx):
        params[name] = {"kernel": _conv_w(sd, f"features.{i}.weight"),
                        "bias": _np(sd[f"features.{i}.bias"])}
    for name, i in zip(("f6", "output"), (0, 2)):
        params[name] = {"kernel": _linear_w(sd, f"classifier.{i}.weight"),
                        "bias": _np(sd[f"classifier.{i}.bias"])}
    leftover = {k for k in sd if k not in sd.used}
    if leftover:
        raise ValueError(f"unconsumed weights: {sorted(leftover)[:5]}")
    return params, {}


def convert_mobilenet_v1(state_dict: Dict) -> Tuple[Dict, Dict]:
    """Reference MobileNetV1 state_dict → Flax trees: Sequential index 0/1 are
    the stem conv+BN, indices 3..15 the 13 DepthwiseSeparableConv blocks with
    dw.conv/dw.bn/pw.conv/pw.bn children, plus the `linear` head
    (`MobileNet/pytorch/models/mobilenet_v1.py:27-91`)."""
    sd = _RecordingDict(strip_data_parallel(state_dict))
    params: Dict = {"stem": {"kernel": _conv_w(sd, "features.0.weight")}}
    stats: Dict = {}
    stem_bn_p, stem_bn_s = _bn(sd, "features.1")
    params["BatchNorm_0"] = stem_bn_p["BatchNorm_0"]
    stats["BatchNorm_0"] = stem_bn_s["BatchNorm_0"]
    for i in range(13):
        t = f"features.{3 + i}"
        blk_p: Dict = {"dw": {"kernel": _conv_w(sd, f"{t}.dw.conv.weight")},
                       "pw": {"kernel": _conv_w(sd, f"{t}.pw.conv.weight")}}
        blk_s: Dict = {}
        for j, sub in enumerate(("dw", "pw")):
            p, s = _bn(sd, f"{t}.{sub}.bn")
            blk_p[f"BatchNorm_{j}"] = p["BatchNorm_0"]
            blk_s[f"BatchNorm_{j}"] = s["BatchNorm_0"]
        params[f"block{i}"] = blk_p
        stats[f"block{i}"] = blk_s
    params["head"] = {"kernel": _np(sd["linear.weight"]).T,
                      "bias": _np(sd["linear.bias"])}
    leftover = {k for k in sd if k not in sd.used
                and not k.endswith("num_batches_tracked")}
    if leftover:
        raise ValueError(f"unconsumed weights: {sorted(leftover)[:5]}")
    return params, stats


def infer_basic_stage_sizes(state_dict: Dict) -> Tuple[int, ...]:
    """Blocks per stage, counted from the checkpoint keys. The reference's
    `resnet34.py` actually builds 2 blocks per stage (a latent quirk — the
    file cites Table 1's 34-layer column but passes num_blocks=2,
    `resnet34.py:38-41`), so depth must follow the weights, not the name."""
    sd = strip_data_parallel(state_dict)
    sizes = []
    for stage in RESNET_TORCH_STAGES:
        n = 0
        while f"{stage}.{n}.conv1.weight" in sd:
            n += 1
        sizes.append(n)
    return tuple(sizes)


def convert_resnet_basic(state_dict: Dict) -> Tuple[Dict, Dict]:
    """Reference basic-block ResNet state_dict → Flax trees matching
    `models/resnet.py` BasicBlock naming. Build the model with
    `stage_sizes=infer_basic_stage_sizes(sd)` and `project_first_blocks=True`
    (the reference projects block 0 of every stage, `resnet34.py:116-128`)."""
    return _convert_resnet(state_dict, infer_basic_stage_sizes(state_dict),
                           2, "BasicBlock")


_INCEPTION_STEM = {"conv7x7": "stem1", "conv1x1": "stem2a", "conv3x3": "stem2b"}
_INCEPTION_BRANCHES = ("branch1_conv1x1", "branch2_conv1x1", "branch2_conv3x3",
                       "branch3_conv1x1", "branch3_conv5x5", "branch4_conv1x1")
_INCEPTION_MODULES = ("3a", "3b", "4a", "4b", "4c", "4d", "4e", "5a", "5b")


def convert_inception_v1(state_dict: Dict) -> Tuple[Dict, Dict]:
    """Reference GoogLeNet state_dict → Flax trees for
    `InceptionV1(use_bn=False)` (the reference's BN-free BasicConv2d stack,
    `Inception/pytorch/models/inception_v1.py:27-75,133-142,164-190`).

    conv7x7/conv1x1/conv3x3 → stem1/stem2a/stem2b; inception_Xy branches map
    in declaration order onto ConvBN_0..5; aux heads keep their avg-pool conv
    + two Linears (first permuted from CHW flatten); `linear` → head."""
    sd = _RecordingDict(strip_data_parallel(state_dict))

    def basic_conv(prefix):
        return {"Conv_0": {"kernel": _conv_w(sd, f"{prefix}.conv.weight"),
                           "bias": _np(sd[f"{prefix}.conv.bias"])}}

    params: Dict = {}
    for torch_name, ours in _INCEPTION_STEM.items():
        params[ours] = basic_conv(torch_name)
    for m in _INCEPTION_MODULES:
        params[f"mod{m}"] = {
            f"ConvBN_{j}": basic_conv(f"inception_{m}.{branch}")
            for j, branch in enumerate(_INCEPTION_BRANCHES)}
    for aux in ("aux1", "aux2"):
        if f"{aux}.features.1.conv.weight" not in sd:
            continue
        c = _np(sd[f"{aux}.features.1.conv.weight"]).shape[0]
        fc_in = _np(sd[f"{aux}.classifier.0.weight"]).shape[1]
        hw = int(round((fc_in // c) ** 0.5))
        params[aux] = {
            "ConvBN_0": basic_conv(f"{aux}.features.1"),
            "Dense_0": {"kernel": _linear_w(sd, f"{aux}.classifier.0.weight",
                                            (hw, hw, c)),
                        "bias": _np(sd[f"{aux}.classifier.0.bias"])},
            "Dense_1": {"kernel": _linear_w(sd, f"{aux}.classifier.3.weight"),
                        "bias": _np(sd[f"{aux}.classifier.3.bias"])},
        }
    params["head"] = {"kernel": _np(sd["linear.weight"]).T,
                      "bias": _np(sd["linear.bias"])}
    leftover = {k for k in sd if k not in sd.used}
    if leftover:
        raise ValueError(f"unconsumed weights: {sorted(leftover)[:5]}")
    return params, {}


# final conv-output geometry (H, W, C) feeding the first FC at 224px input
SEQUENTIAL_CNN_FC_HWC = {
    "vgg16": (7, 7, 512),
    "vgg19": (7, 7, 512),
    "alexnet1": (6, 6, 256),
    "alexnet2": (6, 6, 256),
}


def convert(model_name: str, state_dict: Dict) -> Tuple[Dict, Dict]:
    """Dispatch by registry model name. Raises KeyError for models without a
    converter yet (extend RESNET_STAGE_SIZES / add a mapper)."""
    if model_name in RESNET_STAGE_SIZES:
        return convert_resnet_bottleneck(state_dict,
                                         RESNET_STAGE_SIZES[model_name])
    if model_name == "resnet34":
        return convert_resnet_basic(state_dict)
    if model_name in SEQUENTIAL_CNN_FC_HWC:
        return convert_sequential_cnn(state_dict,
                                      SEQUENTIAL_CNN_FC_HWC[model_name])
    if model_name == "mobilenet_v1":
        return convert_mobilenet_v1(state_dict)
    if model_name == "lenet5":
        return convert_lenet5(state_dict)
    if model_name in ("inception_v1", "googlenet"):
        return convert_inception_v1(state_dict)
    available = sorted(set(RESNET_STAGE_SIZES) | set(SEQUENTIAL_CNN_FC_HWC)
                       | {"resnet34", "mobilenet_v1", "inception_v1", "lenet5"})
    raise KeyError(
        f"no torch-checkpoint converter for {model_name!r} "
        f"(available: {available})")


def to_state_dict(model_name: str, state_dict: Dict, module) -> Dict:
    """The reference checkpoint `state_dict` of `model_name` as the port's
    state_dict for `module` (built with the importer's pins): `convert`,
    then utils/flax_convert.py's `params_to_state_dict`, checked leaf for
    leaf against the module."""
    from .flax_convert import params_to_state_dict
    params, batch_stats = convert(model_name, state_dict)
    return params_to_state_dict(params, module, batch_stats or None)
