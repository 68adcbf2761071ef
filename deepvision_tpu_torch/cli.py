"""Command line of the port's training entry points (own copy of
deepvision_tpu/cli.py: `build_parser`, `_run`, the data factories,
`run_classification`, `run_detection`, `run_centernet`, `run_pose` and
`run_segmentation`).

`python ResNet/torch/train.py -m resnet50_tpu --synthetic --device-augment`
trains ResNet-50 on the card, `python LeNet/torch/train.py -m
lenet5_digits --device cpu` LeNet-5 on the bundled digits on the CPU,
`python ViT/torch/train.py -m vit_small --synthetic` ViT-Small/16 and
`python YOLO/torch/train.py -m yolov3 --synthetic --image-size 416`
YOLO V3 (`-m yolov3_digits --device cpu` on the digits_detect scenes of
the bundled digits), `python ObjectsAsPoints/torch/train.py -m centernet
--synthetic --image-size 256` CenterNet (`-m centernet_digits` on the
digits_detect scenes) and `python Hourglass/torch/train.py -m
hourglass104 --synthetic --image-size 256` the Stacked Hourglass and
`python UNet/torch/train.py -m unet_resnet50 --synthetic --image-size 224
--device-augment` the U-Net segmenter (`-m unet_digits --device cpu` on
the digit segmentation scenes). The
flags are the JAX CLI's (`-m`, `-c`, `--data-dir`, `--dataset`, `--synthetic`,
`--epochs`, `--batch-size`, `--eval-batch-size`, `--learning-rate`,
`--accum-steps`, `--no-decay-bn-bias`, `--ema-decay`, `--device-normalize`,
`--device-augment`,
`--prefetch-batches`, `--steps-per-epoch`, `--seed`, `--workdir`,
`--num-classes`, `--no-halt-on-nonfinite`, `--cache-val`, `--profile-dir`
(a `torch.profiler` trace of the first epoch), `--eval-only` (restore,
evaluate once, print `eval: ...`), the step's levers `--log-grad-norm`,
`--mixup-alpha`, `--cutmix-alpha`, `--steps-per-dispatch` and
`--epoch-on-device/--no-epoch-on-device` (the in-memory datasets only, as
in the JAX CLI), and the resilience flags `--auto-resume`, `--resume
{strict,fallback}`, `--recover-on-divergence N`, `--watchdog-secs S` (or
DEEPVISION_WATCHDOG_SECS) and `--no-graceful-shutdown`), plus `--device`
and `--image-size`. Remat has no flag, as in the JAX CLI: it is the
config's `remat`. The JAX CLI's `--multihost` and `--compilation-cache`
are refused by name (`REFUSED_FLAGS`); its mesh flags are not ported yet
(ROADMAP A6).

Real datasets read the JAX package's on-disk formats: `--data-dir` holds
the `train*`/`val*` TFRecords of ImageNet (`imagenet`, the classifiers'
default), VOC/COCO (`detection`: yolov3, centernet) or MPII (`pose`:
hourglass104), or the flat `train_flatten/`, `val_flatten/` and
`synsets.txt` of `imagenet_flat` (data/records.py, data/imagenet.py,
data/imagenet_flat.py, data/detection.py, data/pose.py). On the card the
records decode on the card (nvJPEG, data/jpeg.py) and batches come out as
CUDA tensors; `--device cpu` decodes with PIL.

Data parallelism needs no flag, as in the JAX CLI: under
`torchrun --standalone --nproc_per_node=N ResNet/torch/train.py ...` each
process is one rank (NCCL on the cards, gloo with `--device cpu`),
`--batch-size` is the global batch and each rank's pipeline makes its own
`batch-size // N` rows of every training batch; the validation batches
are global and the trainer splits them. Only rank 0 prints and writes.
A checkpoint is whole under DDP, so `--auto-resume` under another world
size restores it natively (`resharded` stays false; model and spatial
resharding are ROADMAP A6).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import itertools
import os
from typing import Callable, Optional, Sequence, Tuple

from .configs import get_config
from .core.config import TrainConfig
from .parallel import mesh
from .utils.device import resolve_device

SYNTH_STEPS_DEFAULT = 8

# flags of the JAX training CLI that have no counterpart in the port: each
# is refused by name with the reason, never accepted and ignored
REFUSED_FLAGS = {
    "--multihost": "it forces jax.distributed.initialize(); the port's "
                   "ranks join a process group under torchrun, which sets "
                   "the environment parallel/mesh.py reads",
    "--compilation-cache": "it sets XLA's persistent compilation cache, "
                           "which the port's eager PyTorch has no "
                           "counterpart of",
}


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def build_parser(family: str, models: Sequence[str]) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=f"Train {family} models with the PyTorch port (CUDA). "
                    f"Models: {', '.join(models)}")
    p.add_argument("-m", "--model", required=True, choices=list(models))
    p.add_argument("-c", "--checkpoint", default=None,
                   help="resume from this epoch number, or 'latest'")
    p.add_argument("--data-dir", default=None,
                   help="dataset root (idx files for MNIST)")
    p.add_argument("--dataset", default=None,
                   help="override the config's dataset flavor (imagenet: "
                        "TFRecords; imagenet_flat: the reference's "
                        "flattened directory)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (smoke test, no dataset "
                        "needed; detection, pose and segmentation train on "
                        "a 64 px canvas, CenterNet on 128 px, unless "
                        "--image-size)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--eval-batch-size", type=int, default=None,
                   help="validation batch size (defaults to --batch-size)")
    p.add_argument("--learning-rate", type=float, default=None,
                   help="override the config's base learning rate (taken "
                        "as it is: no linear scaling by batch)")
    p.add_argument("--accum-steps", type=_positive_int, default=None,
                   help="gradient accumulation: average grads over k "
                        "micro-batches per optimizer update (effective "
                        "batch = batch-size * k)")
    p.add_argument("--log-grad-norm", action="store_true",
                   help="log the global L2 gradient norm per step "
                        "(divergence forensics; informs grad_clip_norm)")
    p.add_argument("--mixup-alpha", type=float, default=None,
                   help="mixup augmentation strength (classification; "
                        "lam ~ Beta(a, a), typical 0.1-0.4)")
    p.add_argument("--cutmix-alpha", type=float, default=None,
                   help="CutMix augmentation strength (classification; "
                        "pasted-box blending, typical 1.0; exclusive with "
                        "--mixup-alpha)")
    p.add_argument("--steps-per-dispatch", type=_positive_int, default=None,
                   help="run k train steps per host dispatch, issued back "
                        "to back with no host sync; metrics surface as the "
                        "k-step mean; incompatible with --accum-steps")
    p.add_argument("--epoch-on-device", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="whole-epoch training from the device: stage the "
                        "first epoch on the card once and run every epoch "
                        "from it with no host batch. In-memory datasets "
                        "only (synthetic/mnist/digits/seg scenes); the "
                        "per-epoch reshuffle happens on the device, drawn "
                        "from (seed, epoch); an epoch over the memory "
                        "budget falls back to the staged path with a "
                        "named warning")
    p.add_argument("--no-decay-bn-bias", action="store_true",
                   help="exclude 1-D params (norm scales, biases) from "
                        "weight decay")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="Polyak averaging: validate and pick the best "
                        "checkpoint with the EMA of the weights (typical "
                        "0.999-0.9999)")
    p.add_argument("--device-normalize", action="store_true",
                   help="ship raw uint8 pixels and normalize inside the "
                        "step (a quarter of the bytes; the TFRecord "
                        "pipelines: ImageNet, detection, pose)")
    p.add_argument("--device-augment", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="classification and segmentation: ship uint8 at "
                        "the padded decode size and crop/flip/jitter/"
                        "normalize on the device (a quarter of the "
                        "host->device bytes; synthetic data; segmentation "
                        "crops and flips the mask with its image)")
    p.add_argument("--prefetch-batches", type=_positive_int, default=None,
                   help="stage this many training batches ahead on the "
                        "device from a producer thread (default 2; 1 "
                        "stages inline)")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override steps per epoch (synthetic/smoke; "
                        "cuts a digits_detect training epoch)")
    p.add_argument("--seed", type=int, default=None,
                   help="override the config's seed (weights and data)")
    p.add_argument("--workdir", default=None,
                   help="checkpoints and metrics (default runs/<config>)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the latest checkpoint if one exists "
                        "(preemption recovery; starts fresh otherwise)")
    p.add_argument("--resume", choices=["strict", "fallback"], default=None,
                   help="checkpoint integrity mode for -c/--auto-resume: "
                        "'fallback' (default) verifies the integrity "
                        "manifest and on corruption quarantines the bad "
                        "epoch (corrupt-<N>/) and resumes from the next-"
                        "newest epoch that verifies; 'strict' refuses to "
                        "restore an unverified checkpoint (audit with "
                        "`python -m deepvision_tpu_torch fsck`)")
    p.add_argument("--recover-on-divergence", type=int, default=None,
                   metavar="N",
                   help="when an epoch's loss goes non-finite, roll back to "
                        "the last committed checkpoint, scale the LR down, "
                        "and retry — up to N times before halting with the "
                        "usual divergence error (default 0: halt only)")
    p.add_argument("--watchdog-secs", type=float,
                   default=os.environ.get("DEEPVISION_WATCHDOG_SECS"),
                   metavar="S",
                   help="in-process stall watchdog: abort (exit 70) with "
                        "diagnostics when no train step completes for S "
                        "seconds — set S above the first step's time; "
                        "default off (env DEEPVISION_WATCHDOG_SECS)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome/Perfetto trace-event JSON of the "
                        "run on exit: per log-window spans splitting host "
                        "data wait from step dispatch, and checkpoint "
                        "commits, tagged with the prefetcher's transfer "
                        "ledger")
    p.add_argument("--no-graceful-shutdown", action="store_true",
                   help="disable the SIGTERM/SIGINT handler that commits a "
                        "checkpoint and exits 0 on preemption")
    p.add_argument("--num-classes", type=int, default=None,
                   help="override output classes/keypoints (e.g. MPII=16 "
                        "heatmaps, custom VOC subsets)")
    p.add_argument("--no-halt-on-nonfinite", action="store_true",
                   help="keep training after a NaN/inf epoch loss instead "
                        "of halting with the last-good checkpoint")
    p.add_argument("--cache-val", action="store_true",
                   help="cache the validation records in host RAM after "
                        "the first epoch (classification ImageNet "
                        "TFRecords)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first epoch "
                        "here (<config>.pt.trace.json, Chrome/Perfetto)")
    p.add_argument("--eval-only", action="store_true",
                   help="restore (-c/--auto-resume) and run validation "
                        "once; no training")
    p.add_argument("--multihost", action="store_true",
                   help=f"refused: {REFUSED_FLAGS['--multihost']}")
    p.add_argument("--compilation-cache", default=None, metavar="DIR|off",
                   help=f"refused: {REFUSED_FLAGS['--compilation-cache']}")
    p.add_argument("--image-size", type=int, default=None,
                   help="override the image size; the JAX CLI has no such "
                        "flag. With --synthetic it replaces the 64 px "
                        "canvas, so a synthetic run can train at the "
                        "config's full size (416 for yolov3)")
    return p


def _config_from_args(args, synthetic_image_size: Optional[int]
                      ) -> TrainConfig:
    try:
        cfg = get_config(args.model)
    except ValueError as e:              # a config refused by name
        raise SystemExit(f"error: {e}")
    if args.num_classes:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, num_classes=args.num_classes))
    if args.dataset:
        over = {"dataset": args.dataset}
        if args.dataset == "mnist":
            over.update(image_size=32, channels=1)   # 28 -> 32, grayscale
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **over))
    if args.epochs:
        cfg = cfg.replace(total_epochs=args.epochs)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.eval_batch_size:
        cfg = cfg.replace(eval_batch_size=args.eval_batch_size)
    if args.learning_rate:
        cfg = cfg.replace(optimizer=dataclasses.replace(
            cfg.optimizer, learning_rate=args.learning_rate,
            base_batch_size=None))
    if args.accum_steps:
        cfg = cfg.replace(optimizer=dataclasses.replace(
            cfg.optimizer, accum_steps=args.accum_steps))
    if args.log_grad_norm:
        cfg = cfg.replace(log_grad_norm=True)
    if args.no_decay_bn_bias:
        cfg = cfg.replace(optimizer=dataclasses.replace(
            cfg.optimizer, no_decay_bn_bias=True))
    if args.ema_decay is not None:
        if not 0.0 < args.ema_decay < 1.0:
            raise SystemExit(f"--ema-decay must be in (0, 1), got "
                             f"{args.ema_decay}")
        cfg = cfg.replace(ema_decay=args.ema_decay)
    if args.mixup_alpha is not None:
        if args.mixup_alpha < 0.0:
            raise SystemExit(f"--mixup-alpha must be >= 0, got "
                             f"{args.mixup_alpha}")
        cfg = cfg.replace(mixup_alpha=args.mixup_alpha)
    if args.cutmix_alpha is not None:
        if args.cutmix_alpha < 0.0:
            raise SystemExit(f"--cutmix-alpha must be >= 0, got "
                             f"{args.cutmix_alpha}")
        cfg = cfg.replace(cutmix_alpha=args.cutmix_alpha)
    if cfg.mixup_alpha > 0.0 and cfg.cutmix_alpha > 0.0:
        raise SystemExit("--mixup-alpha and --cutmix-alpha are mutually "
                         "exclusive; pass one of them")
    if args.device_normalize:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, normalize_on_device=True))
    if args.device_augment is not None:
        cfg = cfg.replace(device_augment=args.device_augment)
    if args.cache_val:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, cache_val=True))
    if args.no_halt_on_nonfinite:
        cfg = cfg.replace(halt_on_nonfinite=False)
    if args.steps_per_dispatch:
        cfg = cfg.replace(steps_per_dispatch=args.steps_per_dispatch)
    if args.prefetch_batches:
        cfg = cfg.replace(prefetch_batches=args.prefetch_batches)
    if args.epoch_on_device is not None:
        cfg = cfg.replace(epoch_on_device=args.epoch_on_device)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.resume:
        cfg = cfg.replace(resume_verify=args.resume)
    if args.recover_on_divergence is not None:
        if args.recover_on_divergence < 0:
            raise SystemExit(f"--recover-on-divergence must be >= 0, got "
                             f"{args.recover_on_divergence}")
        cfg = cfg.replace(recover_on_divergence=args.recover_on_divergence)
    if args.watchdog_secs is not None:
        secs = float(args.watchdog_secs)
        if secs <= 0:
            raise SystemExit(f"--watchdog-secs must be > 0, got {secs}")
        cfg = cfg.replace(watchdog_secs=secs)
    if args.no_graceful_shutdown:
        cfg = cfg.replace(graceful_shutdown=False)
    if args.synthetic:
        n_batches = args.steps_per_epoch or SYNTH_STEPS_DEFAULT
        synth = dict(dataset="synthetic",
                     train_examples=cfg.batch_size * n_batches)
        if synthetic_image_size:
            synth["image_size"] = synthetic_image_size
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **synth))
    if args.image_size:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=args.image_size))
    if cfg.epoch_on_device:
        check_epoch_on_device(cfg)
    return cfg


# the datasets the epoch cache may hold: in memory and epoch-stationary
CACHEABLE = {"synthetic", "seg_synthetic", "mnist", "digits", "digits_seg",
             "digits_detect"}


def check_epoch_on_device(cfg: TrainConfig) -> None:
    """`--epoch-on-device` on an in-memory, epoch-stationary dataset only,
    with the JAX CLI's refusal and its note on the scene datasets."""
    if cfg.data.dataset not in CACHEABLE:
        raise SystemExit(
            f"--epoch-on-device caches one epoch device-resident and "
            f"needs an in-memory, epoch-stationary dataset "
            f"({', '.join(sorted(CACHEABLE))}); dataset="
            f"{cfg.data.dataset!r} streams from disk — use the default "
            f"double-buffered staged path (--prefetch-batches) there")
    if cfg.data.dataset in ("digits_seg", "digits_detect") and \
            mesh.is_main_process():
        # these pipelines compose new scenes each epoch; under the cache
        # that becomes "epoch 1's scenes, reshuffled on the device"
        print(f"[{cfg.name}] --epoch-on-device: {cfg.data.dataset} "
              f"normally re-composes scenes per epoch; the cache replays "
              f"epoch 1's scenes with a device-side (seed, epoch) "
              f"reshuffle instead", flush=True)


def _synthetic_data(cfg: TrainConfig, make_batches: Callable) -> Tuple:
    """Train and val epoch factories over `make_batches(batch_size, steps,
    seed, rank)`: the train epoch draws from seed `epoch`, each rank its
    own rows; the val set is 2 global batches from seed 10**6, as in the
    JAX package."""
    n_batches = max(1, cfg.data.train_examples // cfg.batch_size)
    eval_batch = cfg.eval_batch_size or cfg.batch_size
    per_rank, rank = cfg.batch_size // mesh.world_size(), mesh.rank()
    return (lambda epoch: make_batches(per_rank, n_batches, epoch, rank),
            lambda epoch: make_batches(eval_batch, 2, 10**6, 0))


def _array_pair_fns(cfg: TrainConfig, train_xy, test_xy) -> Tuple:
    """Train and val epoch factories over in-memory (images, labels)
    arrays, the shape of the mnist and digits pipelines: the train epoch
    shuffled from seed `epoch` with the last partial batch dropped, each
    rank taking its rows of every batch; the val set in order with it
    kept, as global batches."""
    from .data.mnist import MnistBatches

    def train_fn(epoch):
        return MnistBatches(*train_xy, cfg.batch_size, shuffle=True,
                            seed=epoch, rank=mesh.rank(),
                            world=mesh.world_size())

    def val_fn(epoch):
        return MnistBatches(*test_xy, cfg.eval_batch_size or cfg.batch_size,
                            shuffle=False, drop_remainder=False)

    return train_fn, val_fn


def _tfrecord_data(build: Callable, cfg: TrainConfig, args, device,
                   default_dir: str, bounded_train_steps: bool = False,
                   builder_hint: str = "") -> Tuple:
    """Train and val epoch factories over the `train*` and `val*` TFRecords
    of `--data-dir` (the JAX CLI's `_tfrecord_data`): the rank's files and
    rows in training, global batches over every val file (the trainer
    splits them). ImageNet repeats its records, so its epoch is bounded to
    `train_examples // batch_size` steps; the single-pass sets run whole
    unless `--steps-per-epoch`."""
    from .data.pipeline import epoch_iterator
    data = cfg.data
    data_dir = args.data_dir or data.data_dir or default_dir

    def check(split: str) -> str:
        pattern = os.path.join(data_dir, f"{split}*")
        if "://" not in pattern and not glob.glob(pattern):
            hint = f" Build them with {builder_hint}." if builder_hint else ""
            raise SystemExit(
                f"no TFRecords match {pattern!r}: point --data-dir at the "
                f"dataset (or use --synthetic for a smoke run).{hint}")
        return pattern

    world, rank = mesh.world_size(), mesh.rank()
    val_ds = build(check("val"), training=False,
                   batch_size=cfg.eval_batch_size or cfg.batch_size,
                   image_size=data.image_size, device=device)
    if getattr(args, "eval_only", False):
        return _no_train_data, lambda epoch: epoch_iterator(val_ds)
    train_ds = build(check("train"), training=True,
                     batch_size=cfg.batch_size // world,
                     image_size=data.image_size, num_process=world,
                     process_index=rank, seed=cfg.seed, device=device)
    steps = args.steps_per_epoch
    if steps is None and bounded_train_steps:
        steps = data.train_examples // cfg.batch_size
    return (lambda epoch: epoch_iterator(train_ds, steps, epoch),
            lambda epoch: epoch_iterator(val_ds))


def _no_train_data(epoch):
    raise RuntimeError("training data was not built (--eval-only)")


def _classification_data(cfg: TrainConfig, args, device=None) -> Tuple:
    data = cfg.data
    if (data.normalize_on_device and not cfg.device_augment
            and data.dataset != "imagenet"):
        raise SystemExit(
            "--device-normalize is supported by the TFRecord ImageNet "
            f"pipeline only (dataset={data.dataset!r} normalizes on host)")
    if cfg.device_augment and data.dataset not in (
            "synthetic", "imagenet", "imagenet_flat"):
        raise SystemExit(
            "--device-augment needs a host-decode-only pipeline: synthetic, "
            f"imagenet (TFRecords), or imagenet_flat — dataset="
            f"{data.dataset!r} ships pre-transformed float batches")
    if args.synthetic or data.dataset == "synthetic":
        from .core.config import decode_image_size
        from .data.synthetic import SyntheticClassification
        # under the device augment: uint8 at the padded decode size, the
        # contract of the decode-only loaders
        size = (decode_image_size(data.image_size) if cfg.device_augment
                else data.image_size)
        return _synthetic_data(cfg, lambda batch, steps, seed, rank:
                               SyntheticClassification(
                                   batch, size, data.channels,
                                   data.num_classes, steps, seed=seed,
                                   emit_uint8=cfg.device_augment,
                                   rank=rank))
    if data.dataset == "mnist":
        from .data.mnist import load_split
        data_dir = args.data_dir or data.data_dir or "dataset/mnist"
        return _array_pair_fns(cfg, load_split(data_dir, "train"),
                               load_split(data_dir, "test"))
    if data.dataset == "digits":
        from .data.digits import load_splits
        return _array_pair_fns(cfg, *load_splits(data.image_size))
    if data.dataset in ("imagenet", "imagenet_flat"):
        device = device or resolve_device(args.device)
    if data.dataset == "imagenet":
        from .data import imagenet as inet

        def build(pattern, *, training, **kw):
            # the val records cached after the first epoch (--cache-val)
            return inet.build_dataset(
                pattern, training=training,
                normalize_on_host=not data.normalize_on_device,
                host_decode_only=cfg.device_augment, mean=data.mean,
                std=data.std, cache=data.cache_val and not training, **kw)

        return _tfrecord_data(
            build,
            cfg, args, device, "dataset/tfrecord", bounded_train_steps=True,
            builder_hint="Datasets/ILSVRC2012/build_imagenet_tfrecord.py")
    if data.dataset == "imagenet_flat":
        # the reference's flat layout: dataset/{train_flatten,val_flatten}/
        # and synsets.txt; the rank's files in training, every file in eval
        from .data.imagenet_flat import FlatImageNet
        data_dir = args.data_dir or data.data_dir or "dataset"
        synsets = os.path.join(data_dir, "synsets.txt")
        common = dict(image_size=data.image_size,
                      host_decode_only=cfg.device_augment, device=device)
        val_ds = FlatImageNet(os.path.join(data_dir, "val_flatten"), synsets,
                              training=False,
                              batch_size=cfg.eval_batch_size or cfg.batch_size,
                              **common)
        if getattr(args, "eval_only", False):
            return _no_train_data, lambda epoch: val_ds
        train_ds = FlatImageNet(
            os.path.join(data_dir, "train_flatten"), synsets, training=True,
            batch_size=cfg.batch_size // mesh.world_size(),
            num_shards=mesh.world_size(), shard_index=mesh.rank(),
            seed=cfg.seed, **common)
        steps = args.steps_per_epoch
        return (lambda epoch: itertools.islice(iter(train_ds), steps),
                lambda epoch: val_ds)
    raise ValueError(f"unknown dataset {data.dataset!r}")


def _guard_device_normalize_synthetic(cfg: TrainConfig, args) -> None:
    """--device-normalize needs a pipeline that emits raw uint8; the
    synthetic generators yield floats that were never [0, 255] pixels."""
    if cfg.data.normalize_on_device and (args.synthetic
                                         or cfg.data.dataset == "synthetic"):
        raise SystemExit("--device-normalize is incompatible with synthetic "
                         "data (random floats were never raw pixels)")


def _detection_data(cfg: TrainConfig, args, device=None) -> Tuple:
    from .data import detection as det
    data = cfg.data
    _guard_device_normalize_synthetic(cfg, args)
    if args.synthetic or data.dataset == "synthetic":
        return _synthetic_data(cfg, lambda batch, steps, seed, rank:
                               det.synthetic_batches(
                                   batch_size=batch,
                                   image_size=data.image_size,
                                   num_classes=data.num_classes, steps=steps,
                                   seed=seed, rank=rank))
    if data.dataset == "digits_detect":
        # real scanned digits composed into detection scenes: train scenes
        # composed anew each epoch (seed 1000 + epoch) and shuffled, each
        # rank taking its rows of every global batch, the first
        # --steps-per-epoch batches when given (as the JAX CLI cuts its
        # TFRecord epochs); the validation scenes pinned (data/digits.py),
        # as global batches
        if data.normalize_on_device:
            raise SystemExit("--device-normalize is incompatible with "
                             "digits_detect (scenes are already float "
                             "[-1,1], not raw pixels)")
        from .data.digits import (detection_batches, detection_scenes,
                                  detection_val_scenes, scan_splits)
        (tr_x, tr_y), _ = scan_splits()
        va = detection_val_scenes(canvas=data.image_size,
                                  n_scenes=data.val_examples)
        rank, world = mesh.rank(), mesh.world_size()

        def train_fn(epoch):
            tr = detection_scenes(tr_x, tr_y, n_scenes=data.train_examples,
                                  canvas=data.image_size, seed=1000 + epoch)
            batches = detection_batches(tr, batch_size=cfg.batch_size,
                                        shuffle_seed=epoch)
            for batch in itertools.islice(batches, args.steps_per_epoch):
                yield tuple(mesh.shard_rows(a, rank, world) for a in batch)

        return train_fn, lambda epoch: detection_batches(
            va, batch_size=cfg.batch_size)
    if data.dataset != "detection":
        raise ValueError(f"detection families read 'detection' TFRecords, "
                         f"not dataset={data.dataset!r}")
    return _tfrecord_data(
        functools.partial(det.build_dataset,
                          normalize_on_host=not data.normalize_on_device),
        cfg, args, device or resolve_device(args.device),
        "dataset/tfrecords",
        builder_hint="Datasets/VOC2007|VOC2012|MSCOCO/tfrecords.py")


def _run(family: str, models: Sequence[str], trainer_factory: Callable,
         make_data: Callable, argv: Optional[Sequence[str]] = None,
         synthetic_image_size: Optional[int] = None):
    """Parse → process group (a torchrun launch) → device → config
    overrides → trainer → data → fit. Returns the (closed) trainer and
    fit's result, so a caller can read the trained state. A process group
    this call brought up is destroyed at its end; one that was up before
    is adopted and left up."""
    parser = build_parser(family, models)
    args = parser.parse_args(argv)
    for flag, why in REFUSED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            parser.error(f"{flag} has no counterpart in the port: {why}")
    owned = not mesh.is_initialized() and mesh.maybe_init_distributed(
        "gloo" if args.device == "cpu" else None)
    try:
        device = resolve_device(args.device)
        cfg = _config_from_args(args, synthetic_image_size)
        workdir = args.workdir or os.path.join("runs", cfg.name)
        trainer = trainer_factory(cfg, workdir, device)
        if args.trace_out:
            trainer.arm_tracing(args.trace_out)
        train_fn, val_fn = make_data(cfg, args, device)
        trainer.init_state()
        restored = None
        if args.checkpoint:
            restored = trainer.resume(None if args.checkpoint == "latest"
                                      else int(args.checkpoint))
        elif args.auto_resume:
            # preemption recovery: the latest checkpoint if there is one,
            # a fresh start otherwise
            restored = trainer.resume()
        from .core.trainer import fit_and_close, say
        if args.eval_only:
            result = _evaluate_only(trainer, restored, val_fn)
        else:
            result = fit_and_close(trainer, train_fn, val_fn,
                                   profile_dir=args.profile_dir)
            say(f"done: best={result.get('best_metric')}")
    finally:
        if owned:
            mesh.destroy()
    return trainer, result


def _evaluate_only(trainer, restored: Optional[int], val_fn) -> dict:
    """`--eval-only`: one evaluation of the restored weights (the tail of a
    migration: import a checkpoint, then `train.py -m <model> -c latest
    --eval-only`); refused when nothing was restored, since random
    weights would print a plausible-looking number."""
    from .core.trainer import say
    try:
        if restored is None:
            raise SystemExit(
                "--eval-only requires a restored checkpoint: pass -c "
                f"latest|N (and check --workdir; nothing restorable in "
                f"{trainer.workdir!r})")
        result = trainer.evaluate(val_fn(0))
    finally:
        trainer.close()
    say("eval: " + " ".join(f"{k}={v:.4f}" for k, v in result.items()))
    return result


def run_classification(family: str, models: Sequence[str],
                       argv: Optional[Sequence[str]] = None):
    """Classification entry point — `python train.py -m resnet50_tpu
    [-c latest]`. Synthetic runs keep the config's image size, as in the
    JAX package."""
    from .core.trainer import Trainer
    return _run(family, models,
                lambda c, w, d: Trainer(c, device=d, workdir=w),
                _classification_data, argv)


def run_detection(family: str, models: Sequence[str],
                  argv: Optional[Sequence[str]] = None):
    """Detection (YOLO) entry point — `python train.py -m yolov3
    [-c latest]`. Synthetic runs use a 64 px canvas, as in the JAX
    package, unless `--image-size` says otherwise."""
    from .core.detection import DetectionTrainer
    return _run(family, models,
                lambda c, w, d: DetectionTrainer(c, device=d, workdir=w),
                _detection_data, argv, synthetic_image_size=64)


def _pose_data(cfg: TrainConfig, args, device=None) -> Tuple:
    from .data import pose as pose_data
    data = cfg.data
    _guard_device_normalize_synthetic(cfg, args)
    if args.synthetic or data.dataset == "synthetic":
        return _synthetic_data(cfg, lambda batch, steps, seed, rank:
                               pose_data.synthetic_batches(
                                   batch_size=batch,
                                   image_size=data.image_size, steps=steps,
                                   seed=seed, rank=rank))
    if data.dataset != "pose":
        raise ValueError(f"pose families read 'pose' TFRecords, not "
                         f"dataset={data.dataset!r}")
    return _tfrecord_data(
        functools.partial(pose_data.build_dataset,
                          normalize_on_host=not data.normalize_on_device),
        cfg, args, device or resolve_device(args.device),
        "dataset/tfrecords_mpii",
        builder_hint="Datasets/MPII/tfrecords_mpii.py")


def run_centernet(family: str, models: Sequence[str],
                  argv: Optional[Sequence[str]] = None):
    """CenterNet entry point — `python train.py -m centernet [-c latest]`,
    on the detection batches of `run_detection`. Synthetic runs use a
    128 px canvas (the stride-4 stem and the order-5 hourglass need 2^5 on
    the quarter grid), as in the JAX package, unless `--image-size`."""
    from .core.centernet import CenterNetTrainer
    return _run(family, models,
                lambda c, w, d: CenterNetTrainer(c, device=d, workdir=w),
                _detection_data, argv, synthetic_image_size=128)


def run_pose(family: str, models: Sequence[str],
             argv: Optional[Sequence[str]] = None):
    """Pose (Stacked Hourglass) entry point — `python train.py -m
    hourglass104 [-c latest]`. Synthetic runs use a 64 px canvas, as in
    the JAX package, unless `--image-size`."""
    from .core.pose import PoseTrainer
    return _run(family, models,
                lambda c, w, d: PoseTrainer(c, device=d, workdir=w),
                _pose_data, argv, synthetic_image_size=64)


def _segmentation_data(cfg: TrainConfig, args, device=None) -> Tuple:
    from .data import segmentation as seg_data
    data = cfg.data
    if args.synthetic or data.dataset in ("synthetic", "seg_synthetic"):
        if data.normalize_on_device and not cfg.device_augment:
            raise SystemExit("--device-normalize is incompatible with the "
                             "synthetic segmentation backend (scenes are "
                             "already float [-1,1]); use --device-augment "
                             "for the uint8 pair staging contract")
        from .core.config import decode_image_size
        # under the device augment: uint8 image and mask pairs at the
        # padded decode size, the staging contract of the paired augment
        size = (decode_image_size(data.image_size) if cfg.device_augment
                else data.image_size)
        return _synthetic_data(cfg, lambda batch, steps, seed, rank:
                               seg_data.SyntheticSegmentation(
                                   batch, size, data.channels,
                                   data.num_classes, steps, seed=seed,
                                   emit_uint8=cfg.device_augment,
                                   rank=rank))
    if data.dataset == "digits_seg":
        # real scanned digits composed into segmentation scenes: train
        # scenes composed anew each epoch (seed 1000 + epoch) and shuffled,
        # each rank taking its rows of every global batch, the first
        # --steps-per-epoch batches when given; the validation scenes
        # pinned (seed 2), as global batches
        if cfg.device_augment or data.normalize_on_device:
            raise SystemExit("digits_seg ships float [-1,1] scenes — "
                             "--device-augment/--device-normalize need the "
                             "uint8 staging backends (seg_synthetic)")
        from .data.digits import scan_splits
        (tr_x, tr_y), _ = scan_splits()
        va = seg_data.segmentation_val_scenes(canvas=data.image_size,
                                              n_scenes=data.val_examples)
        rank, world = mesh.rank(), mesh.world_size()

        def train_fn(epoch):
            tr = seg_data.segmentation_scenes(
                tr_x, tr_y, n_scenes=data.train_examples,
                canvas=data.image_size, seed=1000 + epoch)
            batches = seg_data.segmentation_batches(
                tr, batch_size=cfg.batch_size, shuffle_seed=epoch)
            for batch in itertools.islice(batches, args.steps_per_epoch):
                yield tuple(mesh.shard_rows(a, rank, world) for a in batch)

        return train_fn, lambda epoch: seg_data.segmentation_batches(
            va, batch_size=cfg.eval_batch_size or cfg.batch_size)
    raise ValueError(f"segmentation families read 'seg_synthetic' or "
                     f"'digits_seg' data, not dataset={data.dataset!r}")


def run_segmentation(family: str, models: Sequence[str],
                     argv: Optional[Sequence[str]] = None):
    """Segmentation (U-Net) entry point — `python train.py -m unet_resnet50
    [-c latest]`. Synthetic runs use a 64 px canvas, as in the JAX
    package, unless `--image-size` says otherwise (unet_small needs H and
    W divisible by 8, the ResNet-50 encoder by 32)."""
    from .core.segment import SegmentationTrainer
    return _run(family, models,
                lambda c, w, d: SegmentationTrainer(c, device=d, workdir=w),
                _segmentation_data, argv, synthetic_image_size=64)
