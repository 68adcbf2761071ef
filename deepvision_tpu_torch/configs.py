"""Registered configs of the port (own copy of deepvision_tpu/configs.py,
ViT entries only). The hyperparameters equal the JAX package's;
tests/test_torch_vit.py holds them against it.
"""

from __future__ import annotations

from .core.config import DataConfig, TrainConfig
from .utils.registry import CONFIGS

# -- vit_tiny: the CPU-feasible smoke/parity surface — 32px / patch 8 → 17
#    tokens, d=192, 3 heads of 64. ----
CONFIGS.register("vit_tiny", TrainConfig(
    name="vit_tiny", model="vit",
    model_kwargs={"patch_size": 8, "embed_dim": 192, "depth": 4,
                  "num_heads": 3, "mlp_dim": 768, "attention_impl": "auto"},
    data=DataConfig(image_size=32, channels=3, num_classes=10),
))

# -- ViT-Small/16 — 224px / patch 16 → 197 tokens, d=384, 6 heads of 64,
#    depth 8, MLP 1536, 1000 classes, bf16 compute with an f32 head. ----
CONFIGS.register("vit_small", TrainConfig(
    name="vit_small", model="vit",
    model_kwargs={"patch_size": 16, "embed_dim": 384, "depth": 8,
                  "num_heads": 6, "mlp_dim": 1536, "dropout_rate": 0.1,
                  "attention_impl": "auto"},
    data=DataConfig(image_size=224, num_classes=1000),
))


def get_config(name: str) -> TrainConfig:
    return CONFIGS.get(name)
