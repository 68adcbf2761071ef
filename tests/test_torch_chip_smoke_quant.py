"""chip_smoke.py's phase 20 (int8 serving) rehearsed on the CPU at a small
size, the card stood in for by the CPU
(tests/test_torch_chip_smoke.py::_card_on_the_cpu): vit_tiny (32 px, 4
blocks) in place of vit_small, resnet50_tpu and mobilenet_v1 at 32 px,
buckets (1, 4), one iteration a timing, and two seeded vit_tiny epochs
in place of phase 16's run. Every sub-phase runs end to end: the plans
(vit_tiny 25 / 1 / 4), one calibration each, K1's plain version counted
as the kernel counts its launches (depth a dispatch at int8), the int8
products counted, the accumulators of the picked ops equal on both sides
of `p20_accumulators`, the fault refused, `--serve-precision int8` armed
before traffic, the HTTP override, /healthz, /metrics and the hot reload
under the pinned scales."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _card_on_the_cpu  # noqa: E402


def _stash(root):
    """Epochs 1 and 2 of vit_tiny, committed with their manifests as the
    trainer writes them (epoch 2 the weights of epoch 1, scaled)."""
    from deepvision_tpu_torch.configs import trainer_class_for_config
    tr = trainer_class_for_config("vit_tiny")(
        chip_smoke.get_config("vit_tiny"), device="cpu", workdir=root)
    try:
        tr.init_state()
        for epoch in (1, 2):
            tr.ckpt.save(epoch, tr.state.state_dict(),
                         host_state={"best_metric": 0.0})
            tr.ckpt.flush()
            with torch.no_grad():
                for p in tr.state.model.parameters():
                    p.mul_(1.05)
    finally:
        tr.close()
    return root


@pytest.fixture
def tiny_p20(monkeypatch):
    from deepvision_tpu_torch.ops import attention as attention_ops
    _card_on_the_cpu(monkeypatch)
    torch.set_num_threads(1)
    plain = attention_ops.flash_attention_reference

    def counted(*args, **kwargs):
        chip_smoke.flash_attention.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_ops, "flash_attention_reference", counted)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name, value in (("P20_DEVICE", "cpu"), ("P20_VIT", "vit_tiny"),
                        ("P20_SIZE", 32), ("P20_BUCKETS", (1, 4)),
                        ("P20_ITERS", 1), ("P16_MODEL", "vit_tiny"),
                        ("P16_DEVICE", "cpu")):
        monkeypatch.setattr(chip_smoke, name, value)


def test_phase_20_rehearses_on_the_cpu(tiny_p20, tmp_path):
    out = chip_smoke.check_int8_serving(_stash(str(tmp_path / "stash")))
    depth = chip_smoke.get_config("vit_tiny").model_kwargs["depth"]
    a, b, c, d = out["20a"], out["20b"], out["20c"], out["20d"]
    assert a["plan"] == (25, 1, 4) and a["calibrations"] == 1
    assert a["counts"]["flash_attention"] == 2 * depth
    assert b["plan"] == (53, 1, 0) and c["plan"] == (27, 1, 0)
    assert c["counts"]["int8_depthwise"] > 0
    assert set(b["accumulators"]) == {"stem", "1x1"}
    assert b["accumulators"]["stem"]["weight"][1:] == [3, 7, 7]
    assert c["accumulators"]["depthwise"]["weight"][1] == 1
    assert d["fault"] == "refused_regression" and d["calibrations"] == 1
    assert d["after_epoch"] == 2
