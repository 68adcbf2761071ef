"""Preemption of the port's trainer as a process (the contracts of the JAX
package's tests/test_resilience.py and tests/test_preemption.py, on
`LeNet/torch/train.py -m lenet5 --synthetic --device cpu`):

- SIGTERM after the first checkpoint: the run finishes its step, commits
  a verified epoch, prints the resume hint and exits 0; a relaunch with
  `--auto-resume` continues from it and finishes;
- SIGKILL once two epochs are committed (the newest one's manifest left
  to the race), then bit rot on the newest epoch: the relaunch
  quarantines it and resumes from an older epoch that verifies, and the
  dead writer's temporary directory is gone.
"""

import os
import re
import signal
import subprocess
import sys
import time

import pytest

from deepvision_tpu.core import integrity as jax_integrity
from deepvision_tpu_torch.core import integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _cmd(workdir, epochs):
    return [sys.executable, os.path.join(REPO, "LeNet", "torch", "train.py"),
            "-m", "lenet5", "--synthetic", "--device", "cpu", "--epochs",
            str(epochs), "--steps-per-epoch", "2", "--batch-size", "16",
            "--workdir", str(workdir), "--auto-resume"]


def _wait_for(predicate, what, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    pytest.fail(f"{what} within {timeout}s")


def test_sigterm_commits_a_verified_epoch_and_auto_resume_finishes(
        tmp_path):
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.Popen(_cmd(tmp_path, 100000), env=ENV,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        _wait_for(lambda: integrity.committed_epochs(ckpt),
                  "no committed checkpoint")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-2000:]
    got = re.search(r"graceful preemption: checkpoint committed at epoch "
                    r"(\d+)", out)
    assert got and "--auto-resume" in out, out[-2000:]
    epoch = int(got.group(1))
    assert integrity.committed_epochs(ckpt)[-1] == epoch
    step_dir = os.path.join(ckpt, str(epoch))
    assert jax_integrity.verify_files(step_dir)[0] == jax_integrity.OK

    relaunch = subprocess.run(_cmd(tmp_path, epoch + 1), env=ENV,
                              capture_output=True, text=True, timeout=300)
    assert relaunch.returncode == 0, relaunch.stderr[-2000:]
    assert f"resumed from epoch {epoch}" in relaunch.stdout
    assert "done: best=" in relaunch.stdout
    assert integrity.committed_epochs(ckpt)[-1] == epoch + 1


def test_sigkill_during_saves_then_resume_lands_on_a_verified_epoch(
        tmp_path):
    ckpt = tmp_path / "ckpt"
    proc = subprocess.Popen(_cmd(tmp_path, 100000), env=ENV,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)

    def two_committed():
        epochs = integrity.committed_epochs(str(ckpt))
        return len(epochs) >= 2 and (ckpt / str(epochs[-2])
                                     / integrity.MANIFEST_NAME).exists()

    try:
        _wait_for(two_committed, "no two committed checkpoints")
        proc.send_signal(signal.SIGKILL)     # no cleanup, saves in flight
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    newest = integrity.committed_epochs(str(ckpt))[-1]
    step_dir = ckpt / str(newest)
    target = max((os.path.join(r, f) for r, _, fs in os.walk(step_dir)
                  for f in fs if f != integrity.MANIFEST_NAME),
                 key=os.path.getsize)
    with open(target, "r+b") as fp:
        fp.seek(os.path.getsize(target) // 2)
        byte = fp.read(1)
        fp.seek(-1, 1)
        fp.write(bytes([byte[0] ^ 0x80]))

    relaunch = subprocess.run(_cmd(tmp_path, newest + 1), env=ENV,
                              capture_output=True, text=True, timeout=300)
    assert relaunch.returncode == 0, relaunch.stderr[-2000:]
    got = re.search(r"resumed from epoch (\d+)", relaunch.stdout)
    assert got, relaunch.stdout[-2000:]
    assert int(got.group(1)) < newest
    assert "QUARANTINED" in relaunch.stderr
    assert any(d.name.startswith("corrupt-") for d in ckpt.iterdir())
    assert not [d for d in os.listdir(ckpt) if d.startswith(".tmp-")]
    for e in integrity.committed_epochs(str(ckpt)):
        assert jax_integrity.verify_files(str(ckpt / str(e)))[0] == \
            jax_integrity.OK
