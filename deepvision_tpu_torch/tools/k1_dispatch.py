"""Host cost of one call of K1 (ops/attention.py::flash_attention) on the
card, layer by layer.

    python -m deepvision_tpu_torch.tools.k1_dispatch [--repeats 7] \\
        [--out k1_dispatch.json]

At vit_small's attention shape (6 heads, 197 tokens, head dim 64, bf16) at
each serving bucket, in the model's strided layout, it times as
chip_smoke.py's phase 3 times `ms` (utils/timing.py::loop_ms, a host loop
of 50 calls) three ways of issuing the same launch: `wrapper`, the public
`flash_attention`; `operator`, the registered operator it calls, where
the package has one; `launch`, the launch alone (`_launch`). Each is
repeated `--repeats` times, interleaved, and the median and the least
are kept; `device_ms` (utils/timing.py::graph_ms) is the kernel's device
time, which none of the three should move. The difference between two
layers is the host cost of the one above. The tool reads nothing but the
package's own names, so a copy of it placed in another checkout measures
that checkout's package (two commits compared in one run on one card).
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Optional, Sequence

import torch

BUCKETS = (1, 8, 32)
HEADS, TOKENS, HEAD_DIM = 6, 197, 64


def _strided_qkv(b: int, gen: torch.Generator):
    """q, k, v as vit_small's (B, N, H*D) projections seen as (B, H, N, D)."""
    return [torch.randn((b, TOKENS, HEADS * HEAD_DIM), generator=gen)
            .to("cuda", torch.bfloat16).view(b, TOKENS, HEADS, HEAD_DIM)
            .permute(0, 2, 1, 3) for _ in range(3)]


def measure(repeats: int = 7) -> dict:
    from ..ops import attention
    from ..utils.timing import graph_ms, loop_ms

    gen = torch.Generator().manual_seed(0)
    scale = HEAD_DIM ** -0.5
    rows = []
    for b in BUCKETS:
        q, k, v = _strided_qkv(b, gen)
        layers = {"wrapper": lambda: attention.flash_attention(q, k, v)}
        if hasattr(attention, "flash_attention_op"):
            layers["operator"] = lambda: attention.flash_attention_op(
                q, k, v, scale)
        layers["launch"] = lambda: attention._launch(q, k, v, scale)
        times = {name: [] for name in layers}
        for _ in range(repeats):
            for name, fn in layers.items():
                times[name].append(loop_ms(fn))
        row = {"bucket": b, "shape": [b, HEADS, TOKENS, HEAD_DIM],
               "device_ms": graph_ms(layers["wrapper"])}
        for name, got in times.items():
            row[f"{name}_ms"] = statistics.median(got)
            row[f"{name}_min_ms"] = min(got)
        rows.append(row)
    return {"device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "repeats": repeats, "rows": rows}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=7)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_dispatch times K1 on the card; no CUDA device "
                         "is available")
    got = measure(args.repeats)
    text = json.dumps(got)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return got


if __name__ == "__main__":
    main()
