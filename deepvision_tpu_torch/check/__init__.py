"""The port's IR audit (port of deepvision_tpu/check/, jaxvet).

The JAX audit traces every registered step to a jaxpr and walks it. The
port runs every registered step once under fake tensors with a
`TorchDispatchMode` on top (check/walk.py), so the same rules read the
ATen op stream the step really runs, its backward and optimizer update
included, with no data, no FLOPs and no device memory:

  DTYPE   no f32 conv or product op inside a declared-bf16 step outside
          the deliberate f32 heads; f32 steps do not drop to bf16;
          predict outputs are f32
  COST    per-step FLOPs (the JAX audit's convention, so every row but
          the fused attention one equals CHECK_COST.json's), bytes and
          op count, diffed against the committed CHECK_COST_TORCH.json
  SERVE   the PredictEngine's default buckets cover each servable
          config's input spec
  QUANT   the int8 serving twins run their planned layers as int8 x
          int8 -> int32 products, with the weight-byte cut
  TRACE   every registered (config, model, step-factory) builds and runs

Kernels K1 and K2 are registered operators (`deepvision::flash_attention`,
`deepvision::best_iou`): each call is one node of the recorded stream,
charged its math and its bound's bytes.

CLI:      python -m deepvision_tpu_torch.check [units...]
              [--format text|json|github] [--select DTYPE,COST,...]
              [--update-cost]
Library:  audit([...]) -> ([Finding], report)
Exit codes: 0 clean, 1 findings, 2 usage error (the mesh half of the JAX
audit, DONATE, COLL, `mesh` and `spatial`, refused by name).
docs/CHECKING_TORCH.md documents it.
"""

from .cli import audit, main
from .rules import ALL_CHECKS, Finding

__all__ = ["ALL_CHECKS", "Finding", "audit", "main"]
