"""Registered configs of the port (own copy of deepvision_tpu/configs.py:
the LeNet, AlexNet, VGG, Inception, ResNet, MobileNet, ShuffleNet, ViT,
YOLO, Stacked Hourglass, CenterNet, U-Net segmentation, DCGAN and
CycleGAN entries, and `trainer_class_for_config`). Every field the port's
dataclasses carry equals the JAX package's; tests/test_torch_vit.py and
tests/test_torch_yolo.py hold them against it. A JAX config that needs a
field the port does not carry yet is refused by name (`NOT_PORTED`).
"""

from __future__ import annotations

from .core.config import (DataConfig, OptimizerConfig, ScheduleConfig,
                          TrainConfig)
from .utils.registry import CONFIGS


def _imagenet(image_size=224, **kw):
    return DataConfig(dataset="imagenet", image_size=image_size,
                      num_classes=1000, train_examples=1281167,
                      val_examples=50000, **kw)


# -- LeNet-5 on MNIST (32 px after the 28 -> 32 pad, grayscale): adam 1e-3,
#    plateau /10 after 2 epochs without a better val top-1, f32. ----
CONFIGS.register("lenet5", TrainConfig(
    name="lenet5", model="lenet5", batch_size=256, total_epochs=20,
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
    schedule=ScheduleConfig(name="plateau", plateau_patience=2,
                            plateau_mode="max"),
    data=DataConfig(dataset="mnist", image_size=32, channels=1,
                    num_classes=10, train_examples=60000, val_examples=10000),
    dtype="float32",
))

# -- LeNet-5 on scikit-learn's bundled handwritten digits (8 px scans
#    upsampled to 32 px, data/digits.py): the offline real-data gate. ----
CONFIGS.register("lenet5_digits", TrainConfig(
    name="lenet5_digits", model="lenet5", batch_size=128, total_epochs=60,
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
    schedule=ScheduleConfig(name="plateau", plateau_patience=5,
                            plateau_mode="max"),
    data=DataConfig(dataset="digits", image_size=32, channels=1,
                    num_classes=10, train_examples=1437, val_examples=360),
    dtype="float32",
))

# -- AlexNet (Krizhevsky 2012 section 5): momentum 0.9, weight decay 5e-4,
#    lr 0.01 divided by 10 after 2 epochs without a better val top-1;
#    alexnet1 at 227 px, alexnet2 at 224. ----
for _name in ("alexnet1", "alexnet2"):
    CONFIGS.register(_name, TrainConfig(
        name=_name, model=_name, batch_size=128, total_epochs=90,
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.01,
                                  momentum=0.9, weight_decay=5e-4),
        schedule=ScheduleConfig(name="plateau", plateau_patience=2,
                                plateau_factor=0.1, plateau_mode="max"),
        data=_imagenet(227 if _name == "alexnet1" else 224),
    ))

# -- VGG (Simonyan 2014 section 3.1): batch 256, momentum 0.9, weight decay
#    5e-4, lr 0.01 divided by 10 on a plateau of val top-1. ----
for _name in ("vgg16", "vgg19"):
    CONFIGS.register(_name, TrainConfig(
        name=_name, model=_name, batch_size=256, total_epochs=74,
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.01,
                                  momentum=0.9, weight_decay=5e-4),
        schedule=ScheduleConfig(name="plateau", plateau_patience=2,
                                plateau_factor=0.1, plateau_mode="max"),
        data=_imagenet(),
    ))

# -- Inception V1 (Szegedy 2014 section 5): momentum 0.9, lr 0.05 after 2
#    warmup epochs, x0.96 per epoch applied every 8 epochs, weight decay
#    1e-4; the aux heads' losses weighted 0.3. ----
CONFIGS.register("inception_v1", TrainConfig(
    name="inception_v1", model="inception_v1", batch_size=256,
    total_epochs=90,
    optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                              momentum=0.9, weight_decay=1e-4),
    schedule=ScheduleConfig(name="step", warmup_epochs=2,
                            boundaries_epochs=tuple(range(8, 90, 8)),
                            decay_factor=0.96 ** 8),
    aux_loss_weight=0.3,
    data=_imagenet(),
))

# -- Inception V3 (Szegedy 2015 section 8): RMSprop decay 0.9 eps 1.0, lr
#    0.045 x0.94 every 2 epochs, gradient clip 2.0, label smoothing 0.1,
#    aux weight 0.3, 299 px. ----
CONFIGS.register("inception_v3", TrainConfig(
    name="inception_v3", model="inception_v3", batch_size=256,
    total_epochs=100,
    optimizer=OptimizerConfig(name="rmsprop", learning_rate=0.045,
                              rmsprop_decay=0.9, eps=1.0,
                              grad_clip_norm=2.0),
    schedule=ScheduleConfig(name="step",
                            boundaries_epochs=tuple(range(2, 100, 2)),
                            decay_factor=0.94),
    label_smoothing=0.1, aux_loss_weight=0.3,
    data=_imagenet(299),
))

# -- ResNet: batch 256, momentum 0.9, lr 0.1 scaled linearly from a base
#    batch of 256, weight decay 1e-4, cosine after 5 warmup epochs, label
#    smoothing 0.1, ImageNet at 224 px. ----
for _name in ("resnet34", "resnet50", "resnet101", "resnet152",
              "resnet50v2"):
    CONFIGS.register(_name, TrainConfig(
        name=_name, model=_name, batch_size=256, total_epochs=90,
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.1,
                                  momentum=0.9, weight_decay=1e-4,
                                  base_batch_size=256),
        schedule=ScheduleConfig(name="cosine", warmup_epochs=5),
        label_smoothing=0.1,
        data=_imagenet(),
    ))

# -- ResNet-50, the large-batch recipe: resnet50's, plus no weight decay on
#    1-D tensors (BatchNorm scales and biases, the head's bias) and EMA
#    weights (0.9999) for evaluation. Batch 1024 is the JAX package's
#    8-chip global batch (128 per chip); lr 0.1 at 256 scales with it. ----
CONFIGS.register("resnet50_tpu", TrainConfig(
    name="resnet50_tpu", model="resnet50", batch_size=1024, total_epochs=90,
    optimizer=OptimizerConfig(name="momentum", learning_rate=0.1,
                              momentum=0.9, weight_decay=1e-4,
                              base_batch_size=256, no_decay_bn_bias=True),
    schedule=ScheduleConfig(name="cosine", warmup_epochs=5),
    label_smoothing=0.1, ema_decay=0.9999,
    data=_imagenet(),
))

# -- MobileNet V1 (Howard 2017 section 4): RMSprop decay 0.9, lr 0.045
#    x0.94 every 2 epochs, weight decay 4e-5. ----
CONFIGS.register("mobilenet_v1", TrainConfig(
    name="mobilenet_v1", model="mobilenet_v1", batch_size=256,
    total_epochs=90,
    optimizer=OptimizerConfig(name="rmsprop", learning_rate=0.045,
                              rmsprop_decay=0.9, weight_decay=4e-5),
    schedule=ScheduleConfig(name="step",
                            boundaries_epochs=tuple(range(2, 90, 2)),
                            decay_factor=0.94),
    data=_imagenet(),
))

# -- ShuffleNet V1, g=3 (Zhang 2017 section 4): batch 512, momentum 0.9,
#    lr 0.25 decaying linearly to 0 from the first epoch, weight decay
#    4e-5, label smoothing 0.1. ----
CONFIGS.register("shufflenet_v1", TrainConfig(
    name="shufflenet_v1", model="shufflenet_v1", batch_size=512,
    total_epochs=90,
    optimizer=OptimizerConfig(name="momentum", learning_rate=0.25,
                              momentum=0.9, weight_decay=4e-5),
    schedule=ScheduleConfig(name="linear_decay", decay_start_epoch=0),
    label_smoothing=0.1,
    data=_imagenet(),
))

# -- vit_tiny: the CPU-feasible smoke/parity surface — 32px / patch 8 → 17
#    tokens, d=192, 3 heads of 64. ----
CONFIGS.register("vit_tiny", TrainConfig(
    name="vit_tiny", model="vit", batch_size=32, total_epochs=4,
    model_kwargs={"patch_size": 8, "embed_dim": 192, "depth": 4,
                  "num_heads": 3, "mlp_dim": 768, "attention_impl": "auto"},
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
    schedule=ScheduleConfig(name="constant"),
    data=DataConfig(dataset="synthetic", image_size=32, channels=3,
                    num_classes=10, train_examples=512, val_examples=128),
))

# -- ViT-Small/16 — 224px / patch 16 → 197 tokens, d=384, 6 heads of 64,
#    depth 8, MLP 1536, 1000 classes, bf16 compute with an f32 head; adam
#    with a clip at 1.0 (its weight_decay is ignored: see core/optim.py),
#    cosine decay after 5 warmup epochs, label smoothing 0.1, on the
#    flattened-directory ImageNet loader. ----
CONFIGS.register("vit_small", TrainConfig(
    name="vit_small", model="vit", batch_size=256, total_epochs=90,
    model_kwargs={"patch_size": 16, "embed_dim": 384, "depth": 8,
                  "num_heads": 6, "mlp_dim": 1536, "dropout_rate": 0.1,
                  "attention_impl": "auto"},
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3,
                              weight_decay=5e-2, grad_clip_norm=1.0),
    schedule=ScheduleConfig(name="cosine", warmup_epochs=5),
    label_smoothing=0.1,
    data=DataConfig(dataset="imagenet_flat", image_size=224, num_classes=1000,
                    train_examples=1281167, val_examples=50000),
))

# -- YOLO V3: 416px, batch 16 per replica in the reference (128 is the
#    multi-chip global batch), 300 epochs, COCO 80 classes; Adam lr .01 with
#    a plateau /10 after 10 bad epochs watching val loss. ----
CONFIGS.register("yolov3", TrainConfig(
    name="yolov3", model="yolov3", family="detection", batch_size=128,
    total_epochs=300,
    optimizer=OptimizerConfig(name="adam", learning_rate=0.01),
    schedule=ScheduleConfig(name="plateau", plateau_patience=10,
                            plateau_factor=0.1, plateau_mode="min"),
    data=DataConfig(dataset="detection", image_size=416, num_classes=80,
                    train_examples=118287, val_examples=5000),
))

# -- YOLO V3 on VOC2007 (20 classes, 2501 trainval images). ----
CONFIGS.register("yolov3_voc", TrainConfig(
    name="yolov3_voc", model="yolov3", family="detection", batch_size=32,
    total_epochs=300,
    model_kwargs={"num_classes": 20},
    optimizer=OptimizerConfig(name="adam", learning_rate=0.01),
    schedule=ScheduleConfig(name="plateau", plateau_patience=10,
                            plateau_factor=0.1, plateau_mode="min"),
    data=DataConfig(dataset="detection", image_size=416, num_classes=20,
                    train_examples=2501, val_examples=2510),
))

# -- YOLO on scanned-digit detection scenes (data/digits.py, the
#    digits_detect dataset), Darknet-53 at a quarter width on a 128px
#    canvas. ----
CONFIGS.register("yolov3_digits", TrainConfig(
    name="yolov3_digits", model="yolov3", family="detection", batch_size=32,
    total_epochs=150,
    model_kwargs={"num_classes": 10, "width_mult": 0.25},
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
    schedule=ScheduleConfig(name="step", boundaries_epochs=(70, 90),
                            decay_factor=0.1),
    data=DataConfig(dataset="digits_detect", image_size=128, num_classes=10,
                    train_examples=512, val_examples=128),
))

# -- Stacked Hourglass: MPII's 16 joints at 256 px (64 px heatmaps), batch
#    16 per replica in the reference (128 is the multi-chip global batch),
#    Adam 1e-3, plateau /10 after 10 bad epochs watching val loss. ----
CONFIGS.register("hourglass104", TrainConfig(
    name="hourglass104", model="hourglass104", family="pose", batch_size=128,
    total_epochs=100,
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
    schedule=ScheduleConfig(name="plateau", plateau_patience=10,
                            plateau_factor=0.1, plateau_mode="min"),
    data=DataConfig(dataset="pose", image_size=256, num_classes=16,
                    train_examples=22246, val_examples=2958),
))

# -- CenterNet / ObjectsAsPoints: the 2-stack hourglass at 256 px, COCO's
#    80 classes; Adam 1.25e-4, /10 at epochs 90 and 120 (Zhou 2019 section
#    5.2). `objects_as_points` is the same recipe under the paper's name
#    (its own runs/ workdir). ----
_CENTERNET = TrainConfig(
    name="centernet", model="centernet", family="centernet", batch_size=64,
    total_epochs=140,
    optimizer=OptimizerConfig(name="adam", learning_rate=1.25e-4),
    schedule=ScheduleConfig(name="step", boundaries_epochs=(90, 120),
                            decay_factor=0.1),
    data=DataConfig(dataset="detection", image_size=256, num_classes=80,
                    train_examples=118287, val_examples=5000),
)
CONFIGS.register("centernet", _CENTERNET)
CONFIGS.register("objects_as_points", _CENTERNET.replace(
    name="objects_as_points"))

# -- CenterNet on the digits_detect scenes (data/digits.py): one stack of
#    order 2 at a quarter width on a 64 px canvas (16 px grid). ----
CONFIGS.register("centernet_digits", _CENTERNET.replace(
    name="centernet_digits", batch_size=32, total_epochs=30,
    model_kwargs={"num_stack": 1, "order": 2, "width_mult": 0.25},
    optimizer=OptimizerConfig(name="adam", learning_rate=5e-4),
    schedule=ScheduleConfig(name="step", boundaries_epochs=(20, 26),
                            decay_factor=0.1),
    data=DataConfig(dataset="digits_detect", image_size=64, num_classes=10,
                    train_examples=512, val_examples=128),
))


# -- DCGAN on MNIST: batch 256, 50 epochs, two Adam(1e-4) optimizers, a
#    checkpoint every 2 epochs, the last 3 kept. ----
CONFIGS.register("dcgan", TrainConfig(
    name="dcgan", model="dcgan", family="gan", batch_size=256, total_epochs=50,
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-4),
    schedule=ScheduleConfig(name="constant"),
    data=DataConfig(dataset="mnist", image_size=28, channels=1, num_classes=10,
                    train_examples=60000, val_examples=10000),
    dtype="float32", keep_checkpoints=3, keep_best=False,
))

# -- CycleGAN: 200 epochs, Adam 2e-4 (beta1 0.5), the LR decaying linearly
#    to 0 after epoch 100, lambda_cycle 10 and lambda_id 5 (core/gan.py),
#    batch 8. ----
CONFIGS.register("cyclegan", TrainConfig(
    name="cyclegan", model="cyclegan", family="gan", batch_size=8,
    total_epochs=200,
    optimizer=OptimizerConfig(name="adam", learning_rate=2e-4, beta1=0.5),
    schedule=ScheduleConfig(name="linear_decay", decay_start_epoch=100),
    data=DataConfig(dataset="cyclegan", image_size=256, num_classes=0,
                    train_examples=1000, val_examples=100),
    dtype="float32", keep_checkpoints=3, keep_best=False,
))

# -- U-Net over the ResNet-50 encoder at 224 px, 21 classes (the VOC
#    convention), momentum SGD with cosine after 2 warmup epochs, on the
#    synthetic shapes-and-masks scenes (data/segmentation.py). ----
CONFIGS.register("unet_resnet50", TrainConfig(
    name="unet_resnet50", model="unet_resnet50", family="segmentation",
    batch_size=32, total_epochs=60,
    optimizer=OptimizerConfig(name="momentum", learning_rate=0.02,
                              momentum=0.9, weight_decay=1e-4,
                              base_batch_size=32),
    schedule=ScheduleConfig(name="cosine", warmup_epochs=2),
    data=DataConfig(dataset="seg_synthetic", image_size=224, num_classes=21,
                    train_examples=2048, val_examples=256,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
))

# -- The CPU-sized synthetic recipe: unet_small (BasicBlock encoder of two
#    stages, width 8) on 64 px shapes-and-masks scenes, f32. ----
CONFIGS.register("unet_synthetic", TrainConfig(
    name="unet_synthetic", model="unet_small", family="segmentation",
    batch_size=32, total_epochs=8,
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
    schedule=ScheduleConfig(name="constant"),
    data=DataConfig(dataset="seg_synthetic", image_size=64, num_classes=6,
                    train_examples=256, val_examples=64,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    dtype="float32",
))

# -- Scanned-digit segmentation scenes (data/segmentation.py: real
#    scikit-learn digits pasted into 64 px scenes, 11 classes =
#    background + 10 digits), with the cross-entropy + dice loss. ----
CONFIGS.register("unet_digits", TrainConfig(
    name="unet_digits", model="unet_small", family="segmentation",
    batch_size=32, total_epochs=30, loss="xent_dice",
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
    schedule=ScheduleConfig(name="step", boundaries_epochs=(20, 26),
                            decay_factor=0.1),
    data=DataConfig(dataset="digits_seg", image_size=64, num_classes=11,
                    train_examples=512, val_examples=128,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    dtype="float32",
))

# JAX configs the port refuses by name until it carries what they need
NOT_PORTED = {
    "unet_synthetic_sp2": (
        "unet_synthetic_sp2 trains with spatial_parallel=2 and "
        "spatial_backend='shard_map' (H sharded over a spatial mesh), which "
        "the port does not carry yet (ROADMAP A6); train unet_synthetic"),
}


def get_config(name: str) -> TrainConfig:
    if name in NOT_PORTED:
        raise ValueError(NOT_PORTED[name])
    return CONFIGS.get(name)


def trainer_class_for_config(name: str):
    """The supervised trainer class of a config's `family`; None for an
    adversarial config (core/gan.py builds its own pair of networks)."""
    family = get_config(name).family
    if family == "gan":
        return None
    from .core.centernet import CenterNetTrainer
    from .core.detection import DetectionTrainer
    from .core.pose import PoseTrainer
    from .core.segment import SegmentationTrainer
    from .core.trainer import Trainer
    classes = {"classification": Trainer, "detection": DetectionTrainer,
               "pose": PoseTrainer, "centernet": CenterNetTrainer,
               "segmentation": SegmentationTrainer}
    if family not in classes:
        raise ValueError(
            f"config {name!r} declares unknown trainer family {family!r}; "
            f"expected one of {sorted(classes) + ['gan']}")
    return classes[family]
