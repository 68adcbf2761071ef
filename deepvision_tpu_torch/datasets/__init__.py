"""The dataset builders without TensorFlow (own copies of `Datasets/` and
`CycleGAN/jax/{tfrecords,celeba}.py`): raw datasets to the TFRecords the
port's loaders (`data/`) and the JAX package's read, and the flat and
split directory layouts.

Each runs as `python -m deepvision_tpu_torch.datasets.<name>` with the JAX
script's flags and defaults, plus `--device` (the card unless the caller
asks for the CPU): `voc2007`, `voc2012`, `coco`, `mpii`, `imagenet`,
`imagenet_flatten`, `imagenet_boxes`, `cyclegan` and `celeba`. On the CPU
the records equal the JAX builders' byte for byte; on the card the few
images the builders re-encode go through nvJPEG (`images.py`).
"""
