"""chip_smoke.py's phase 17 (the replica tier and the flywheel) rehearsed on
the CPU at a small size, the card stood in for by the CPU
(tests/test_torch_chip_smoke.py::_card_on_the_cpu): vit_tiny (32 px, 4
blocks) in place of vit_small at 224 px, its four epochs trained as phase
16 trains them, 1 s load windows, the tier's replicas launched with
`--device cpu`, and the fine-tune at batch 8. Every sub-phase runs end to
end: 17a's tier subprocess with two replicas, the clean windows through
the router and straight to a replica, a replica SIGKILLed under traffic
and readmitted with zero failures, the clean roll onto both replicas and
the regressing one stopped after the first, the merged /metrics, SIGTERM
and exit 0; 17b's episode promoted through drift, fine-tune, gate and
canary, then the refusals opening the circuit, with K1's plain version
counted as the kernel counts its launches (depth x (fine-tune steps +
dispatches)). The replicas' own launch counts are the card's only: their
plain version counts nothing."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _card_on_the_cpu  # noqa: E402


@pytest.fixture
def tiny_p17(monkeypatch):
    from deepvision_tpu_torch.data.synthetic import SyntheticClassification
    from deepvision_tpu_torch.flywheel.controller import FlywheelController
    from deepvision_tpu_torch.ops import attention as attention_ops
    _card_on_the_cpu(monkeypatch)
    torch.set_num_threads(1)
    plain = attention_ops.flash_attention_reference

    def counted(*args, **kwargs):
        chip_smoke.flash_attention.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_ops, "flash_attention_reference", counted)

    def small_batches(fw, epoch):
        cfg = fw.monitor.cfg
        return SyntheticClassification(
            8, image_size=fw.sm.engine.example_shape[0],
            channels=cfg.data.channels, num_classes=cfg.data.num_classes,
            num_batches=fw.finetune_batches, seed=epoch)

    # the fine-tune at batch 8 in place of the config's
    monkeypatch.setattr(FlywheelController, "_data", small_batches)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name, value in (("P16_MODEL", "vit_tiny"), ("P16_DEVICE", "cpu"),
                        ("P16_TRAIN_BATCH", 4), ("P16_TIMEOUT", 120),
                        ("P17_MODEL", "vit_tiny"), ("P17_DEVICE", "cpu"),
                        ("P17_LOAD_SECS", 1.0), ("P17_CLIENTS", 4),
                        ("P17_CANARY_WINDOW", 0.5),
                        ("P17_TIMEOUT", 120)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_phase_17_rehearses_on_the_cpu(tiny_p17):
    stash = chip_smoke.p16_checkpoints()
    out = chip_smoke.check_tier_and_flywheel(stash, (1.0, 2.0))
    a, b = out["17a"], out["17b"]
    assert a["exit_code"] == 0 and a["false_ejections"] == 0
    assert [r["state"] for r in a["rolls"]] == ["promoted", "rolled_back"]
    assert a["respawn_compile"]["cache_misses"] == 0
    assert a["answers"] > 0 and a["stats"]["responses_5xx"] == 0
    depth = chip_smoke.get_config("vit_tiny").model_kwargs["depth"]
    assert b["launches"] == depth * (b["finetune_steps"] + b["dispatches"])
    # 3 fine-tunes: the promoted one and two refusals, the first backing off
    assert b["finetune_steps"] == 3 * chip_smoke.P17_FINETUNE_BATCHES
    assert [d for d, _, _ in b["decisions"]] == [
        "promoted", "refused_gate", "refused_gate"]
    assert b["backoffs"] == [chip_smoke.P17_BACKOFF_S]
    assert b["counters"]["circuit_opened"] == 1


def test_a_failed_tier_phase_stops_the_tier(monkeypatch, tmp_path):
    """When 17a fails after the tier started, the tier subprocess (and so
    its replicas) is stopped before the error propagates."""
    import subprocess
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(120)"])
    monkeypatch.setattr(chip_smoke, "p17_start_tier",
                        lambda root, logs: (proc, "http://127.0.0.1:1"))
    monkeypatch.setattr(chip_smoke, "p15_workdir",
                        lambda tag: str(tmp_path / tag))
    (tmp_path / "17_logs").mkdir()
    (tmp_path / "17_logs" / "tier.out").write_text("")

    def fails(*args):
        raise AssertionError("17a: references failed")

    monkeypatch.setattr(chip_smoke, "p16_commit", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "p16_references", fails)
    try:
        with pytest.raises(AssertionError, match="17a"):
            chip_smoke.check_p17_tier("unused", (1.0, 2.0))
        assert proc.poll() is not None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
