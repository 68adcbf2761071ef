"""Typed configs: the fields of deepvision_tpu/core/config.py that the
port's serve path and its trainers read (own copy), and
`decode_image_size`. Defaults equal the JAX package's. The mesh's model
and spatial axes (`model_parallel`, `spatial_parallel`,
`spatial_backend`) are the JAX fields no ported path reads yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# Canonical ImageNet channel statistics in [0,1] units (torchvision
# convention), the defaults of DataConfig.mean/std as in the JAX package.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# The detection pipelines normalize to [-1, 1] (x/127.5 - 1): as mean/std
# in [0,1] units that is (0.5, 0.5), the on-device input_norm their steps
# use when the pipeline ships raw uint8.
UNIT_RANGE_NORM = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))


def decode_image_size(image_size: int) -> int:
    """The size the host decodes and resizes to for the device-augment path
    (data/device_augment.py): the Rescale(256) -> crop(224) headroom ratio,
    at least one spare pixel so the random crop has offsets to draw.
    224 -> 256."""
    return max(image_size + 1, (image_size * 256) // 224)


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "sgd"               # sgd | momentum | rmsprop | adam | adamw
    learning_rate: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0       # L2-coupled (sgd), added after the
                                    # scaling (rmsprop, adamw); adam ignores it
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    rmsprop_decay: float = 0.9
    grad_clip_norm: Optional[float] = None
    # linear LR scaling: learning_rate * effective batch / base_batch_size;
    # None keeps the configured LR
    base_batch_size: Optional[int] = None
    # gradient accumulation: one update per `accum_steps` micro-batches, on
    # their mean gradient; the schedule counts applied updates
    accum_steps: int = 1
    # decay only tensors of rank > 1 (no decay of biases and norm scales)
    no_decay_bn_bias: bool = False


@dataclasses.dataclass
class ScheduleConfig:
    name: str = "constant"          # constant | step | cosine | plateau | linear_decay
    warmup_epochs: float = 0.0
    boundaries_epochs: Tuple[float, ...] = ()   # step schedule
    decay_factor: float = 0.1
    # plateau: host-driven, scales the LR after `plateau_patience` epochs
    # without improvement of the watched metric
    plateau_patience: int = 2
    plateau_factor: float = 0.1
    plateau_mode: str = "max"       # watch val top-1 ('max') or val loss ('min')
    min_lr: float = 0.0             # cosine: the floor, as alpha = min_lr / lr
    decay_start_epoch: int = 100    # linear_decay: constant until this epoch


@dataclasses.dataclass
class DataConfig:
    dataset: str = "synthetic"
    data_dir: str = ""              # dataset root (idx files for MNIST)
    image_size: int = 224
    channels: int = 3               # input channels (1 for MNIST-family)
    num_classes: int = 1000
    train_examples: int = 1281167
    val_examples: int = 50000
    # Ship raw uint8 pixels to the device and normalize ((x/255-mean)/std)
    # there instead of on the host (core/steps.normalize_input).
    normalize_on_device: bool = False
    # keep the validation records in host RAM after the first epoch
    # (the ImageNet TFRecord pipeline, `--cache-val`)
    cache_val: bool = False
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD


@dataclasses.dataclass
class TrainConfig:
    name: str = "model"
    model: str = "resnet50"
    # Trainer family this config belongs to: classification | detection |
    # pose | centernet | segmentation | gan.
    family: str = "classification"
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_size: int = 256           # global batch
    eval_batch_size: Optional[int] = None
    total_epochs: int = 100
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    loss: str = "softmax_xent"
    label_smoothing: float = 0.0
    aux_loss_weight: float = 0.3    # weight of auxiliary heads' losses
    dtype: str = "bfloat16"         # compute dtype; params stay f32
    seed: int = 0
    log_every_steps: int = 10
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    keep_best: bool = True
    # Polyak averaging: validation and the best checkpoint use
    # ema = d * ema + (1 - d) * params; None disables it
    ema_decay: Optional[float] = None
    # ship uint8 at decode_image_size(image_size) and crop, flip, jitter
    # and normalize on the device (data/device_augment.py; classification
    # only); the step's input_norm is then off
    device_augment: bool = False
    # raise TrainingDivergedError when an epoch's mean train loss is
    # non-finite, naming the last checkpoint to resume from
    halt_on_nonfinite: bool = True
    # training batches staged ahead on the device by a producer thread
    # (parallel/prefetch.py); 1 stages inline
    prefetch_batches: int = 2
    # recompute the train forward's activations in the backward
    # (`torch.utils.checkpoint`, core/remat.py): the dense layers' matmuls
    # are kept, everything else is recomputed, as JAX's
    # dots_with_no_batch_dims_saveable policy does
    remat: bool = False
    # mixup (classification): each step blends the batch with a
    # permutation of itself, lam ~ Beta(a, a); 0 is off
    mixup_alpha: float = 0.0
    # CutMix (classification): a box of the permuted batch pasted in, lam
    # the exact kept fraction; exclusive with mixup_alpha
    cutmix_alpha: float = 0.0
    # the global L2 norm of the gradients as the step metric `grad_norm`
    # (under accumulation, the micro-batch's)
    log_grad_norm: bool = False
    # k train steps per host dispatch: the metrics come back as the k
    # steps' mean, the EMA advances after each step; not with
    # accum_steps > 1
    steps_per_dispatch: int = 1
    # stage the first trained epoch on the device once (data/
    # device_cache.py) and run every later epoch from it with no host
    # batch; an epoch over the budget trains through the staged loop with
    # EpochCacheOverflowWarning. Not with steps_per_dispatch > 1 or
    # accum_steps > 1
    epoch_on_device: bool = False
    # the on-device epoch's permutation of the examples, a function of
    # (seed, epoch); off replays the cached order
    epoch_shuffle: bool = True
    # divergence recovery (core/resilience.py): when an epoch's mean loss
    # is non-finite, roll back to the last committed checkpoint, scale the
    # LR by recovery_lr_factor and retry the epoch, up to this many times a
    # run; then the halt fires. 0 halts at once. Needs halt_on_nonfinite
    # (the trigger) and a committed checkpoint to roll back to
    recover_on_divergence: int = 0
    # multiplied into a persistent LR scale at every rollback (composed
    # with the plateau's scale)
    recovery_lr_factor: float = 0.5
    # integrity mode of a restore (-c, --auto-resume, a rollback):
    # "fallback" quarantines a corrupt epoch (corrupt-<epoch>/) and resumes
    # from the next-newest one that verifies, "strict" raises, "off"
    # restores blindly (core/checkpoint.py)
    resume_verify: str = "fallback"
    # in-process step watchdog (resilience.StepWatchdog): abort with
    # diagnostics (exit 70) when no step completes for this many seconds;
    # None is off
    watchdog_secs: Optional[float] = None
    # SIGTERM/SIGINT during fit(): finish the step in flight, commit a
    # checkpoint, exit 0 with the resume hint
    graceful_shutdown: bool = True

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
