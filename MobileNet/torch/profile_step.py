#!/usr/bin/env python
"""Where a mobilenet_v1 train step's time goes on the card, by kernel family.

    python MobileNet/torch/profile_step.py [--batch-size 256] [--steps 5]

MobileNet V1 at full width (alpha 1.0, 224 px, 1000 classes, bf16 convs
with f32 BatchNorm and head, RMSprop): the step alone, images/s, peak
memory, its bound and the device split by kernel family
(deepvision_tpu_torch/tools/profile_classification.py). Exits non-zero
without a card.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.tools.profile_classification import \
    main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main("mobilenet_v1"))
