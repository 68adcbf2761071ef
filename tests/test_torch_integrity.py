"""The port's checkpoint integrity layer (deepvision_tpu_torch/core/
integrity.py, core/checkpoint.py, `python -m deepvision_tpu_torch fsck`,
the engine's verified restore) against the JAX package on the CPU.

The JAX package's `integrity.verify_files`, `integrity.audit` and its fsck
(`deepvision_tpu/__main__.py`) are the oracle: they read the directories
the port writes, and their verdicts, records and JSON summaries must equal
the port's exactly, on clean, truncated, bit-flipped and manifest-less
epochs. The restore modes (fallback, strict, off), the legacy layouts, the
quarantine names, the async write's failure path and the host snapshot are
held to the JAX tests' contracts (tests/test_checkpoint_integrity.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from deepvision_tpu.__main__ import main as jax_fsck_main
from deepvision_tpu.core import integrity as jax_integrity
from deepvision_tpu_torch import cli
from deepvision_tpu_torch.__main__ import main as fsck_main
from deepvision_tpu_torch.core import integrity
from deepvision_tpu_torch.core.checkpoint import (CheckpointCorruptionError,
                                                  CheckpointManager)
from deepvision_tpu_torch.core.resilience import RetryPolicy
from deepvision_tpu_torch.serve import cli as serve_cli
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.utils.faults import FaultInjector

FAST = RetryPolicy(max_retries=3, base_delay=0.01, max_delay=0.02)
DAMAGE = ("clean", "truncate", "bitflip", "delete_manifest")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _payload(k=1):
    return {"model": {"w": torch.arange(32, dtype=torch.float32) * k,
                      "b": torch.ones(4, 4, dtype=torch.bfloat16) * k},
            "optimizer": {"count": k, "lr_scale": 1.0},
            "step": k, "ema": None}


def _mgr(path, **kw):
    kw.setdefault("keep", 8)
    kw.setdefault("keep_best", False)
    kw.setdefault("retry_policy", FAST)
    return CheckpointManager(str(path), **kw)


def _save_epochs(path, *epochs, **kw):
    m = _mgr(path, **kw)
    for e in epochs:
        m.save(e, _payload(e), host_state={"best_metric": float(e)})
    m.flush()
    return m


def _largest_file(step_dir):
    return max((os.path.join(r, f) for r, _, fs in os.walk(step_dir)
                for f in fs if f != integrity.MANIFEST_NAME),
               key=os.path.getsize)


def _bitflip(path):
    with open(path, "r+b") as fp:
        fp.seek(os.path.getsize(path) // 2)
        byte = fp.read(1)
        fp.seek(-1, 1)
        fp.write(bytes([byte[0] ^ 0x80]))


def _damaged(root, mode, monkeypatch):
    """Epochs 1 and 2 written by the port, epoch 2 damaged after its
    commit by the injector (DEEPVISION_FAULT_CKPT_CORRUPT=2:<mode>)."""
    if mode != "clean":
        monkeypatch.setenv("DEEPVISION_FAULT_CKPT_CORRUPT", f"2:{mode}")
    _save_epochs(root, 1, 2, fault_injector=FaultInjector.from_env()).close()
    return str(root)


# -- the manifest, against the JAX verifier ------------------------------------

def test_manifest_roundtrip_and_the_jax_verifier_accepts_it(tmp_path):
    m = _save_epochs(tmp_path / "ckpt", 1)
    step_dir = str(tmp_path / "ckpt" / "1")
    assert sorted(os.listdir(step_dir)) == [
        "host.json", integrity.MANIFEST_NAME, "state.pt"]
    manifest = integrity.load_manifest(step_dir)
    assert manifest["format_version"] == jax_integrity.MANIFEST_VERSION
    assert manifest["epoch"] == 1 and manifest["writer"]["pid"]
    leaf = manifest["leaves"]["model.w"]
    assert leaf["shape"] == [32] and leaf["dtype"] == "float32"
    assert manifest["leaves"]["model.b"]["dtype"] == "bfloat16"
    assert "repr_sha256" in manifest["leaves"]["step"]
    for rel, rec in manifest["files"].items():
        assert os.path.getsize(os.path.join(step_dir, rel)) == rec["bytes"]
    assert manifest["total_bytes"] == sum(
        r["bytes"] for r in manifest["files"].values())
    want = (jax_integrity.OK, f"{len(manifest['files'])} files verified")
    assert integrity.verify_files(step_dir) == want
    assert jax_integrity.verify_files(step_dir) == want
    assert jax_integrity.manifest_digest(manifest) == \
        integrity.manifest_digest(manifest)

    state, host, epoch = m.restore(verify="strict")
    assert epoch == 1 and host == {"best_metric": 1.0}
    assert torch.equal(state["model"]["w"], _payload(1)["model"]["w"])
    assert torch.equal(state["model"]["b"], _payload(1)["model"]["b"])
    info = m.last_restore_info
    assert info["verified"] is True and info["fallback_skipped"] == 0
    assert info["manifest_sha256"] == integrity.manifest_digest(manifest)
    m.close()


def test_leaf_hashes_are_numpy_bytes(tmp_path):
    """A leaf's hash is the sha256 of its contiguous bytes, as the JAX
    package hashes `np.ascontiguousarray(arr).tobytes()`."""
    import hashlib
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()
    entry = integrity.tensor_entry(t)
    arr = np.ascontiguousarray(t.numpy())
    assert entry == {"shape": [4, 3], "dtype": "float32",
                     "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


@pytest.mark.parametrize("mode", DAMAGE)
def test_jax_verify_files_and_audit_agree_with_the_port(tmp_path, mode,
                                                        monkeypatch):
    root = _damaged(tmp_path / "ckpt", mode, monkeypatch)
    for e in (1, 2):
        step_dir = os.path.join(root, str(e))
        assert integrity.verify_files(step_dir) == \
            jax_integrity.verify_files(step_dir)
        assert integrity.verify_epoch(root, e) == \
            jax_integrity.verify_epoch(root, e)
    want = {"clean": jax_integrity.OK, "truncate": jax_integrity.CORRUPT,
            "bitflip": jax_integrity.CORRUPT,
            "delete_manifest": jax_integrity.MISSING_MANIFEST}[mode]
    assert integrity.verify_files(os.path.join(root, "2"))[0] == want
    assert integrity.audit(root) == jax_integrity.audit(root)


@pytest.mark.parametrize("mode", DAMAGE)
def test_fsck_json_summary_equals_jax_and_exit_codes(tmp_path, mode,
                                                     monkeypatch, capsys):
    """`fsck --format json` prints the JAX fsck's document on the same
    directory; exit 0 when clean, 1 with a corrupt epoch (also right after
    --quarantine repaired it), then 0; 2 for a path that is no
    directory."""
    wd = tmp_path / "run"
    _damaged(wd / "ckpt", mode, monkeypatch)
    rc_jax = jax_fsck_main(["fsck", str(wd), "--format", "json"])
    want = json.loads(capsys.readouterr().out)
    rc = fsck_main(["fsck", str(wd), "--format", "json"])
    got = json.loads(capsys.readouterr().out)
    assert got == want and rc == rc_jax
    corrupt = mode in ("truncate", "bitflip")
    assert rc == (1 if corrupt else 0)
    assert got["fsck"] == ("corrupt" if corrupt else "ok")

    assert fsck_main(["fsck", str(wd), "--quarantine"]) == rc
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["quarantined"] is corrupt
    assert (wd / "ckpt" / "corrupt-2").is_dir() == (mode != "clean")
    assert fsck_main(["fsck", str(wd), "--json"]) == 0
    text = capsys.readouterr().out
    assert jax_fsck_main(["fsck", str(wd), "--json"]) == 0
    assert capsys.readouterr().out == text
    if mode != "clean":
        assert "QUARANTINED" in text
    assert fsck_main(["fsck", str(tmp_path / "nope")]) == 2


def test_fsck_scans_a_runs_root_and_empty_dirs(tmp_path, capsys):
    _save_epochs(tmp_path / "runs" / "a" / "ckpt", 1).close()
    _save_epochs(tmp_path / "runs" / "b" / "ckpt", 1, 2).close()
    (tmp_path / "runs" / "no_ckpt_here").mkdir()
    assert fsck_main(["fsck", str(tmp_path / "runs")]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["epochs_audited"] == 3
    (tmp_path / "empty").mkdir()
    assert fsck_main(["fsck", str(tmp_path / "empty"), "--format",
                      "json"]) == 0
    assert json.loads(capsys.readouterr().out)["checkpoint_dirs"] == 0


# -- restore modes ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["truncate", "bitflip", "delete_manifest"])
def test_fallback_quarantines_and_lands_on_the_older_epoch(tmp_path, mode,
                                                          monkeypatch):
    root = _damaged(tmp_path / "ckpt", mode, monkeypatch)
    monkeypatch.delenv("DEEPVISION_FAULT_CKPT_CORRUPT", raising=False)
    m = _mgr(root)
    state, _, epoch = m.restore()
    assert epoch == 1
    assert torch.equal(state["model"]["w"], _payload(1)["model"]["w"])
    assert (tmp_path / "ckpt" / "corrupt-2").is_dir()
    assert not (tmp_path / "ckpt" / "2").exists()
    assert m.last_restore_info["fallback_skipped"] == 1
    # the epoch number is free again: a retrained epoch 2 saves fresh
    m.save(2, _payload(20))
    m.flush()
    state, _, epoch = m.restore(verify="strict")
    assert epoch == 2 and state["step"] == 20
    m.close()


def test_strict_raises_and_quarantines_nothing(tmp_path, monkeypatch):
    root = _damaged(tmp_path / "ckpt", "truncate", monkeypatch)
    m = _mgr(root)
    with pytest.raises(CheckpointCorruptionError, match="strict"):
        m.restore(verify="strict")
    assert (tmp_path / "ckpt" / "2").is_dir()
    assert not (tmp_path / "ckpt" / "corrupt-2").exists()
    # the escape hatch: verify off restores the older epoch named
    assert m.restore(1, verify="off")[2] == 1
    assert m.last_restore_info["verified"] is False
    m.close()


def test_every_generation_corrupt_raises(tmp_path):
    m = _save_epochs(tmp_path / "ckpt", 1, 2)
    for e in (1, 2):
        _bitflip(_largest_file(str(tmp_path / "ckpt" / str(e))))
    with pytest.raises(CheckpointCorruptionError,
                       match="passed verification"):
        m.restore()
    assert sorted(integrity.quarantined_dirs(str(tmp_path / "ckpt"))) == [
        "corrupt-1", "corrupt-2"]
    m.close()


def test_deep_check_refuses_leaves_that_disagree(tmp_path):
    """A manifest whose leaf hash disagrees with the loaded tensor (the
    files themselves verify) is corruption too."""
    m = _save_epochs(tmp_path / "ckpt", 1, 2)
    step_dir = str(tmp_path / "ckpt" / "2")
    manifest = integrity.load_manifest(step_dir)
    manifest["leaves"]["model.w"]["sha256"] = "0" * 64
    integrity.write_manifest(step_dir, manifest)
    with pytest.raises(CheckpointCorruptionError, match="model.w"):
        m.restore(verify="strict")
    assert m.restore()[2] == 1
    m.close()


def test_legacy_checkpoints_restore_with_warning(tmp_path, capfd):
    """The earlier port's `<epoch>.pt` files, and epoch directories of a
    run with no manifest anywhere, restore unverified with a warning in
    every mode; a fresh save next to them is verified."""
    root = tmp_path / "ckpt"
    root.mkdir()
    torch.save({"state": _payload(3), "host": {"best_metric": 0.5}},
               root / "3.pt")
    m = _mgr(root)
    assert m.epochs() == [3]
    state, host, epoch = m.restore(verify="strict")
    assert epoch == 3 and host == {"best_metric": 0.5}
    assert torch.equal(state["model"]["w"], _payload(3)["model"]["w"])
    assert m.last_restore_info["legacy"] is True
    assert m.last_restore_info["verified"] is False
    assert "legacy" in capfd.readouterr().err
    m.save(4, _payload(4))
    m.flush()
    assert m.restore()[2] == 4 and m.last_restore_info["verified"]
    m.close()

    bare = tmp_path / "bare"
    _save_epochs(bare, 1).close()
    os.remove(bare / "1" / integrity.MANIFEST_NAME)
    m = _mgr(bare)
    assert m.restore(verify="strict")[2] == 1
    assert m.last_restore_info["legacy"] is True
    assert "no integrity manifest" in capfd.readouterr().err
    m.close()


def test_quarantine_naming_collision(tmp_path):
    root = tmp_path / "ckpt"
    for expected in ("corrupt-7", "corrupt-7.2", "corrupt-7.3"):
        (root / "7").mkdir(parents=True)
        dest = integrity.quarantine_epoch(str(root), 7)
        assert os.path.basename(dest) == expected
    assert integrity.quarantined_dirs(str(root)) == \
        jax_integrity.quarantined_dirs(str(root))


def test_keep_and_best_prune_whole_epoch_directories(tmp_path):
    m = _mgr(tmp_path / "ckpt", keep=2, keep_best=True, best_mode="min")
    for epoch, metric in [(1, 3.0), (2, 1.0), (3, 2.0), (4, 2.5)]:
        m.save(epoch, _payload(epoch), metric=metric)
    assert m.latest_epoch() == 4 and m.best_epoch() == 2
    assert m.epochs() == [2, 3, 4]
    assert integrity.committed_epochs(str(tmp_path / "ckpt")) == [2, 3, 4]
    m.close()


# -- the async write -----------------------------------------------------------

def test_async_failure_surfaces_at_flush(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPVISION_FAULT_CKPT_ASYNC_FAILS", "1")
    m = _mgr(tmp_path / "ckpt", fault_injector=FaultInjector.from_env())
    m.save(1, _payload(1))
    with pytest.raises(OSError, match="injected async"):
        m.flush()
    m.save(2, _payload(2))      # the manager stays usable
    m.flush()
    assert m.restore()[2] == 2
    m.close()


def test_async_failure_is_retried_at_the_next_save(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPVISION_FAULT_CKPT_ASYNC_FAILS", "1")
    events = []
    m = _mgr(tmp_path / "ckpt", fault_injector=FaultInjector.from_env(),
             on_retry=lambda what, attempt, exc, delay:
             events.append((what, attempt, str(exc))))
    m.save(1, _payload(1))
    m._drain()
    m.save(2, _payload(2))
    assert events and events[0][:2] == ("ckpt_save", 1)
    assert "injected async" in events[0][2]
    m.flush()           # consumed by the retry: nothing pending
    assert m.epochs() == [2]
    m.close()


def test_the_snapshot_survives_in_place_mutation(tmp_path):
    """save() returns before the write; every tensor mutated in place right
    after it must not reach the checkpoint, and its hashes match."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = torch.optim.Adam(model.parameters())
    model(torch.randn(5, 4)).sum().backward()
    opt.step()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict()}
    before = {k: v.clone() for k, v in
              integrity.flatten(state).items() if torch.is_tensor(v)}
    m = _mgr(tmp_path / "ckpt")
    m.save(1, state)
    with torch.no_grad():
        for t in integrity.flatten(state).values():
            if torch.is_tensor(t):
                t.add_(1)
    m.flush()
    got, _, _ = m.restore(verify="strict")
    for k, v in integrity.flatten(got).items():
        if torch.is_tensor(v):
            assert torch.equal(v, before[k]), k
    m.close()


def test_a_save_failure_is_retried_and_the_budget_runs_out(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("DEEPVISION_FAULT_CKPT_SAVE_FAILS", "2")
    events = []
    m = _mgr(tmp_path / "a", fault_injector=FaultInjector.from_env(),
             on_retry=lambda *a: events.append(a[:2]))
    m.save(1, _payload(1))
    m.flush()
    assert events == [("ckpt_save", 1), ("ckpt_save", 2)]
    assert m.epochs() == [1]
    m.close()
    monkeypatch.setenv("DEEPVISION_FAULT_CKPT_SAVE_FAILS", "3")
    m = _mgr(tmp_path / "b", fault_injector=FaultInjector.from_env(),
             retry_policy=RetryPolicy(max_retries=1, base_delay=0.01))
    with pytest.raises(OSError, match="injected transient checkpoint-write"):
        m.save(1, _payload(1))
    m.close()


# -- the engine ---------------------------------------------------------------

def test_engine_provenance_refusal_and_no_verify(tmp_path, capsys):
    wd = str(tmp_path / "wd")
    cli.run_classification("LeNet", ["lenet5"], [
        "-m", "lenet5", "--synthetic", "--device", "cpu", "--batch-size",
        "4", "--steps-per-epoch", "1", "--epochs", "1", "--workdir", wd])
    step_dir = os.path.join(wd, "ckpt", "1")
    assert jax_integrity.verify_files(step_dir)[0] == jax_integrity.OK
    engine = PredictEngine.from_config("lenet5", device="cpu", buckets=(1,),
                                       workdir=wd, verbose=False)
    manifest = integrity.load_manifest(step_dir)
    assert engine.provenance == {
        "weights": "checkpoint", "checkpoint_epoch": 1, "verified": True,
        "manifest_sha256": jax_integrity.manifest_digest(manifest),
        "resharded": False}
    x = np.random.RandomState(0).randn(1, 32, 32, 1).astype(np.float32)
    want = engine.predict(x)

    args = serve_cli.build_parser().parse_args(
        ["-m", "lenet5", "--workdir", wd, "--device", "cpu", "--buckets",
         "1", "--no-verify"])
    server = serve_cli.build_server(args)
    try:
        assert server.engine.provenance["verified"] is False
        assert server.engine.provenance["manifest_sha256"] is None
        np.testing.assert_array_equal(server.engine.predict(x), want)
    finally:
        server.close()
    assert "UNVERIFIED" in capsys.readouterr().out

    _bitflip(_largest_file(step_dir))
    with pytest.raises(CheckpointCorruptionError, match="strict"):
        PredictEngine.from_config("lenet5", device="cpu", buckets=(1,),
                                  workdir=wd, verbose=False)
    assert os.path.isdir(step_dir)      # refused, not quarantined
