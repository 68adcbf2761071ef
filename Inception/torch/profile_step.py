#!/usr/bin/env python
"""Where an inception_v3 train step's time goes on the card, by kernel family.

    python Inception/torch/profile_step.py [--batch-size 256] [--steps 5]

Inception V3 at full width (299 px, 1000 classes, the aux head weighted
0.3, bf16 convs with f32 BatchNorm and heads, RMSprop with eps 1.0 and a
clip at 2.0, label smoothing 0.1): the step alone, images/s, peak memory,
its bound and the device split by kernel family
(deepvision_tpu_torch/tools/profile_classification.py). Exits non-zero
without a card.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.tools.profile_classification import \
    main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main("inception_v3"))
