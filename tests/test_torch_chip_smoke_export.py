"""chip_smoke.py's phase 21 (model export and the checkpoint importer)
rehearsed on the CPU at a small size, the card stood in for by the CPU
(tests/test_torch_chip_smoke.py::_card_on_the_cpu): vit_tiny (32 px, 4
blocks) exported at batch 2 from a saved epoch in place of phase 6's
vit_small run, a saved cyclegan epoch converted at 32 px in place of
phase 14d's run, a one-step hourglass104 run at 64 px in place of 18e's,
and the imported ResNet-50 served at 64 px. The two exports run as the
script runs them, as processes started before the phase and collected in
it (two AOTInductor compiles on the CPU); K1's plain version is counted
as the kernel counts its launches (4 in one call of the program and of
the package)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _card_on_the_cpu  # noqa: E402


@pytest.fixture
def tiny_p21(monkeypatch, tmp_path):
    from deepvision_tpu_torch.ops import attention as attention_ops
    _card_on_the_cpu(monkeypatch)
    torch.set_num_threads(1)
    plain = attention_ops.flash_attention_reference

    def counted(*args, **kwargs):
        chip_smoke.flash_attention.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_ops, "flash_attention_reference", counted)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    for name, value in (("P21_DEVICE", "cpu"), ("P21_VIT", "vit_tiny"),
                        ("P21_BATCH", 2), ("P21_CG_SIZE", 32),
                        ("P21_IMPORT_SIZE", 64), ("P21_ITERS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)


def _runs(root):
    """The three run dirs phase 21 reads: a saved vit_tiny epoch, a saved
    cyclegan epoch, a one-step hourglass104 run."""
    from deepvision_tpu_torch.cli import run_pose
    from deepvision_tpu_torch.configs import trainer_class_for_config

    vit = os.path.join(root, "vit")
    tr = trainer_class_for_config("vit_tiny")(
        chip_smoke.get_config("vit_tiny"), device="cpu", workdir=vit)
    try:
        tr.init_state()
        tr.ckpt.save(1, tr.state.state_dict(),
                     host_state={"best_metric": 0.0})
    finally:
        tr.close()
    cg = os.path.join(root, "cg")
    tr = chip_smoke.CycleGANTrainer(chip_smoke.get_config("cyclegan"),
                                    workdir=cg, device="cpu")
    try:
        tr.ckpt.save(1, {"gen": tr.gen_state.state_dict(),
                         "disc": tr.disc_state.state_dict()},
                     host_state={})
    finally:
        tr.close()
    pose = os.path.join(root, "pose")
    run_pose("Hourglass", ["hourglass104"], argv=[
        "-m", "hourglass104", "--synthetic", "--epochs", "1",
        "--batch-size", "2", "--steps-per-epoch", "1", "--workdir", pose,
        "--device", "cpu"])
    return vit, cg, pose


def test_phase_21_rehearses_on_the_cpu(tiny_p21, tmp_path):
    vit, cg, pose = _runs(str(tmp_path / "runs"))
    export_run = chip_smoke.start_p21_export(vit)
    convert_run = chip_smoke.start_p21_convert(cg)
    # both compile at a lower priority than the phases they run beside
    base = os.getpriority(os.PRIO_PROCESS, 0)
    for run in (export_run, convert_run):
        assert os.getpriority(os.PRIO_PROCESS, run["proc"].pid) == min(
            base + chip_smoke.P21_NICE, 19)
    out = chip_smoke.check_export(export_run, convert_run, vit, cg, pose)
    depth = chip_smoke.get_config("vit_tiny").model_kwargs["depth"]
    a, b, c, d = out["21a"], out["21b"], out["21c"], out["21d"]
    assert a["launches"] == {"program": depth, "package": depth}
    assert a["errors"]["program"] <= chip_smoke.P21_PROGRAM_RTOL
    assert a["seconds"]["export_s"] is not None
    assert a["seconds"]["compile_s"] is not None
    assert set(a["ms"]) == {"eager", "program", "package"}
    assert b["counts"] == (0, 0)
    assert set(b["ms"]) == {"eager", "export", "rewritten", "package"}
    assert c["epoch"] == 1 and c["files"] >= 3
    assert d["error"] <= chip_smoke.CPU_RTOL
    assert export_run["proc"].poll() == 0 == convert_run["proc"].poll()


def test_a_failed_export_fails_the_phase(tiny_p21, tmp_path):
    """An export process that exits non-zero fails phase 21 with its
    log's tail; nothing is caught."""
    run = chip_smoke.start_p21_export(str(tmp_path / "no_run"))
    with pytest.raises(AssertionError, match="no checkpoint restorable"):
        chip_smoke.check_p21_export(run, str(tmp_path / "no_run"))
