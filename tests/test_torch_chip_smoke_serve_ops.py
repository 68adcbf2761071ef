"""chip_smoke.py's phase 16 (running the server) rehearsed on the CPU at a
small size, the card stood in for by the CPU
(tests/test_torch_chip_smoke.py::_card_on_the_cpu): vit_tiny (32 px, 4
blocks) in place of vit_small at 224 px, trained at batch 4, a 1 s canary,
0.5 s load windows, and 16e's subprocess with `--device cpu`. Every
sub-phase runs end to end: the four epochs committed one at a time, the
promotion, the cached refusal and the canary rollback over HTTP, K1's
plain version counted as the kernel counts its launches (depth x
dispatches of both generations), the breaker's 500s, 503 and probe, the
autoscaler's rise and fall, /metrics and /trace, and SIGTERM draining
under traffic."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _card_on_the_cpu  # noqa: E402


@pytest.fixture
def tiny_p16(monkeypatch):
    from deepvision_tpu_torch.ops import attention as attention_ops
    _card_on_the_cpu(monkeypatch)
    torch.set_num_threads(1)
    plain = attention_ops.flash_attention_reference

    def counted(*args, **kwargs):
        chip_smoke.flash_attention.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_ops, "flash_attention_reference", counted)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name, value in (("P16_MODEL", "vit_tiny"), ("P16_DEVICE", "cpu"),
                        ("P16_TRAIN_BATCH", 4), ("P16_CANARY_WINDOW", 1.0),
                        ("P16_LOAD_SECS", 0.5), ("P16_CLIENTS", 3),
                        ("P16_LOAD_CLIENTS", 24), ("P16_TIMEOUT", 120)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_phase_16_rehearses_on_the_cpu(tiny_p16):
    out = chip_smoke.check_serve_ops()
    a = out["16a"]
    depth = chip_smoke.get_config("vit_tiny").model_kwargs["depth"]
    assert a["launches"] == depth * a["dispatches"] > 0
    assert a["by_generation"]["candidate"] > 0
    assert [(d["decision"] or {}).get("decision") for d in a["decisions"]] \
        == ["promoted", "refused_gate", None, "rolled_back_canary"]
    assert a["timings"]["shadow_examples"] == 64
    assert out["16b"]["statuses"][-3][0] == 503
    assert out["16c"]["peak_workers"] > 1
    assert out["16d"]["render_ms"]["3_models_ms"] > 0
    assert out["16e"]["outcomes"]["(200, None)"] > 0


def test_a_failed_sub_phase_stops_16e_server(monkeypatch):
    """When a sub-phase before 16e fails, the phase still stops the
    server subprocess it started with the phase."""
    import subprocess
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(120)"])
    monkeypatch.setattr(chip_smoke, "p16_start_drain",
                        lambda: (proc, "http://127.0.0.1:1"))

    def fails():
        raise AssertionError("16a: training failed")

    monkeypatch.setattr(chip_smoke, "p16_checkpoints", fails)
    try:
        with pytest.raises(AssertionError, match="16a"):
            chip_smoke.check_serve_ops()
        assert proc.poll() is not None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
