"""Vision Transformer (Dosovitskiy et al. 2021), port of
deepvision_tpu/models/vit.py.

Patchify (strided Conv) → learned cls token + position embedding → pre-LN
transformer encoder → LayerNorm → f32 classification head. The attention
goes through `ops.attention.attention`: the flash kernel on a CUDA tensor,
its plain version on a CPU tensor.

Parameter names follow the Flax module tree (`patch_embed`, `cls_token`,
`pos_embed`, `blocks.<i>.{ln_attn,attn.{query,key,value,out},ln_mlp,
mlp_in,mlp_out}`, `norm`, `head`) so `utils/flax_convert.py` maps a Flax
`params` tree onto this module leaf for leaf. Numerics follow Flax where it
differs from torch's defaults: LayerNorm eps 1e-6 with its statistics in
f32 even under bf16, tanh-approximate GELU, and projections that cast
their weights to the activation dtype (Flax's `dtype=` policy) while the
head stays f32. The public input is NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..utils.registry import MODELS

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)


class Dense(nn.Linear):
    """`nn.Linear` at the activation dtype: the weights are cast to it, as
    Flax's `nn.Dense(dtype=...)` casts its f32 params per call. Free once
    the weights already have that dtype (`ViT.cast_compute_weights_`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class PatchEmbed(nn.Conv2d):
    """Non-overlapping p x p patches → embed_dim, at the activation dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """Flax LayerNorm: eps 1e-6, normalization in f32, result cast back to
    the activation dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention with explicit Q/K/V/out projections."""

    def __init__(self, dim: int, num_heads: int, attention_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads

        def split(y):  # (b, n, c) -> a (b, h, n, d) view, no copy
            return y.view(b, n, h, c // h).permute(0, 2, 1, 3)

        out = attention(split(self.query(x)), split(self.key(x)),
                        split(self.value(x)), impl=self.attention_impl)
        # the kernel's output is a (b, n, h, d) tensor seen as (b, h, n, d):
        # merging the heads back is a view
        return self.out(out.permute(0, 2, 1, 3).reshape(b, n, c))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dropout_rate: float = 0.0, attention_impl: str = "auto"):
        super().__init__()
        self.ln_attn = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads, attention_impl)
        self.ln_mlp = LayerNorm(dim)
        self.mlp_in = Dense(dim, mlp_dim)
        self.mlp_out = Dense(mlp_dim, dim)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dropout(self.attn(self.ln_attn(x)))
        y = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.dropout(self.mlp_out(y))


@MODELS.register("vit")
class ViT(nn.Module):
    def __init__(self, num_classes: int = 10, patch_size: int = 8,
                 embed_dim: int = 192, depth: int = 4, num_heads: int = 3,
                 mlp_dim: int = 768, dropout_rate: float = 0.0,
                 attention_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, *,
                 image_size: int = 32, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} not divisible by "
                             f"patch {patch_size}")
        self.dtype = dtype
        self.patch_embed = PatchEmbed(channels, embed_dim, patch_size,
                                      stride=patch_size)
        tokens = (image_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim))
        self.dropout = nn.Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_dim, dropout_rate,
                         attention_impl) for _ in range(depth))
        self.norm = LayerNorm(embed_dim)
        self.head = nn.Linear(embed_dim, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initializers, drawn from `generator`: lecun_normal
        (truncated at 2 std) kernels, zero biases, unit LayerNorm scales,
        a zero cls token and a N(0, 0.02) position embedding."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                # flax variance_scaling("truncated_normal") divides by the
                # std of a unit normal truncated to [-2, 2]
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.zeros_(self.cls_token)
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)

    @torch.no_grad()
    def cast_compute_weights_(self) -> "ViT":
        """Cast, once, the weights that run at the compute dtype — the patch
        conv, the encoder projections, the cls token and the position
        embedding — so no forward pays that cast again. The LayerNorms and
        the head keep their f32 weights, as the JAX model computes them in
        f32."""
        for m in self.modules():
            if isinstance(m, (Dense, PatchEmbed)):
                m.to(self.dtype)
        self.cls_token.data = self.cls_token.data.to(self.dtype)
        self.pos_embed.data = self.pos_embed.data.to(self.dtype)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) images → (B, num_classes) f32 logits."""
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)        # (b, h*w, d), (h, w) row-major
        b = x.shape[0]
        cls = self.cls_token.to(self.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.dropout(x)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return self.head(x[:, 0].float())
