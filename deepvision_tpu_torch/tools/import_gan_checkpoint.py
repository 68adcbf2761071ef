"""Import a reference GAN `tf.train.Checkpoint` into the port's checkpoint
format (own copy of tools/import_gan_checkpoint.py).

    python -m deepvision_tpu_torch.tools.import_gan_checkpoint \\
        --family dcgan --ckpt ./checkpoints [--workdir runs/dcgan]
    python -m deepvision_tpu_torch.tools.import_gan_checkpoint \\
        --family cyclegan --ckpt ./checkpoints-horse2zebra [--n-blocks 9]

The reference's GAN trainers checkpoint with `tf.train.Checkpoint` +
CheckpointManager: DCGAN saves objects `generator`/`discriminator` and a
`step` counter (`DCGAN/tensorflow/main.py:34-39`), CycleGAN
`generator_a2b`/`generator_b2a`/`discriminator_a`/`discriminator_b` and an
`epoch` counter (`CycleGAN/tensorflow/train.py:134-148`). The bundle is
read by the port's own reader (utils/tf_checkpoint.py, every CRC checked:
on the card by the decoder library's SSE4.2 CRC32C, on the CPU in numpy
lanes), the weights map through utils/gan_convert.py onto the port's GAN
trainer built on `--device` (the card by default), every leaf checked
against the trainer's networks (utils/flax_convert.py), and the pair is
saved as the counter's epoch (or `--epoch`) by the trainer's
CheckpointManager: `DCGAN/torch/inference.py`,
`CycleGAN/torch/inference.py` and `--resume` take it.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a reference GAN tf.train checkpoint")
    p.add_argument("--family", required=True, choices=["dcgan", "cyclegan"])
    p.add_argument("--ckpt", required=True,
                   help="tf.train checkpoint prefix (.../ckpt-40) or the "
                        "reference's checkpoint directory (latest is used)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--n-blocks", type=int, default=9,
                   help="CycleGAN generator residual blocks (reference: 9)")
    p.add_argument("--epoch", type=int, default=None,
                   help="epoch to record (default: the checkpoint's own "
                        "epoch/step counter)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu: "
                        "where the models are built and the weights loaded")
    return p


def _read_counter(reader, names=("epoch", "step")) -> int:
    """The reference persists the epoch (CycleGAN) / step (DCGAN) as a
    checkpointed tf.Variable: recovered for the save's number."""
    for name in names:
        key = f"{name}/.ATTRIBUTES/VARIABLE_VALUE"
        if reader.has_tensor(key):
            return int(reader.get_tensor(key))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"workdir", "epoch"}."""
    args = build_parser().parse_args(argv)

    from ..configs import get_config
    from ..core.gan import CycleGANTrainer, DCGANTrainer
    from ..data.jpeg import host_crc32c
    from ..utils import gan_convert
    from ..utils.device import resolve_device
    from ..utils.flax_convert import params_to_state_dict
    from ..utils.tf_checkpoint import crc32c_np

    device = resolve_device(args.device)
    try:
        # one reader for the counter and every object: the index is read
        # once however many networks the family has
        reader = gan_convert.open_reader(
            args.ckpt, crc=(host_crc32c(device) if device.type == "cuda"
                            else crc32c_np))
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}")
    epoch = args.epoch if args.epoch is not None else _read_counter(reader)

    cfg = get_config(args.family)
    workdir = args.workdir or os.path.join("runs", cfg.name)
    if args.family == "dcgan":
        trainer = DCGANTrainer(cfg, workdir=workdir, device=device)
        pairs = {"generator": (trainer.generator, gan_convert.convert_object(
            reader, "generator")),
            "discriminator": (trainer.discriminator,
                              gan_convert.convert_object(reader,
                                                         "discriminator"))}
    else:
        trainer = CycleGANTrainer(cfg, workdir=workdir, device=device,
                                  n_blocks=args.n_blocks)
        gens = {}
        for name in ("a2b", "b2a"):
            groups = gan_convert.load_object_groups(reader,
                                                    f"generator_{name}")
            # converted at the checkpoint's own depth, so a wrong
            # --n-blocks shows as the blocks the two sides disagree on
            gens[name] = gan_convert.convert_cyclegan_generator(
                groups, n_blocks=gan_convert.cyclegan_blocks(groups))
        discs = {name: gan_convert.convert_object(reader,
                                                  f"discriminator_{name}")
                 for name in ("a", "b")}
        # the ModuleDicts' keys are the trees' first level
        pairs = {what: (module, ({k: v[0] for k, v in trees.items()},
                                 {k: v[1] for k, v in trees.items()}))
                 for what, module, trees in (
                     ("generators", trainer.generators, gens),
                     ("discriminators", trainer.discriminators, discs))}
    try:
        for what, (module, (params, stats)) in pairs.items():
            # every leaf against the freshly built module, so a wrong
            # --n-blocks or a truncated checkpoint fails here, its leaves
            # named, not at inference time
            try:
                weights = params_to_state_dict(params, module, stats or None)
            except (KeyError, ValueError) as e:
                raise SystemExit(f"{what}: structure mismatch — {e.args[0]}")
            module.load_state_dict(weights, strict=False)
        trainer.ckpt.save(epoch, trainer._payload())
        trainer.ckpt.flush()
    finally:
        trainer.close()
    print(f"imported {args.family} checkpoint {args.ckpt} -> {workdir} "
          f"(epoch {epoch})")
    return {"workdir": workdir, "epoch": epoch}


if __name__ == "__main__":
    main()
