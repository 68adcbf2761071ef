"""The port's drift-triggered flywheel (deepvision_tpu_torch/flywheel/) held
to the JAX package's own code on the same inputs.

The oracle is deepvision_tpu/flywheel/{drift,controller}.py on a JAX
engine: its controller reaches the JAX serve modules (the promotion
controller and the reloader) through the stand-in package of
tests/test_torch_serve_ops.py::jax_serve_modules. Both sides serve twin
lenet5 run dirs: epoch 1 is the JAX trainer's seeded init, committed by
the JAX trainer on one side and carried across by utils/flax_convert.py
into a port checkpoint on the other (the `twin_engines` recipe of
tests/test_torch_promote.py).

What is held equal, each with its tolerance:

- `DriftMonitor` fed the same sampled rows (its observer tap called
  directly, so no batcher timing enters) under the same
  DEEPVISION_FAULT_DRIFT_SHIFT: windows, breaches and the consecutive
  streak after every tick (exactly), the input shift (to 1e-6), the watch
  decay after both sides promote the same scaled weights (to 1e-6: the
  two engines' argmaxes on the pinned shard agree, lenet5 being f32 on
  both), the trigger after the hysteresis windows, and the streak reset
  by a single spike;
- `FlywheelController`: an episode that promotes (the sequence of states
  the ticks return, the counters, and one `flywheel_id` on the events,
  the spans, the decision record and /healthz on each side), refusals
  that back off and then open the circuit at `max_attempts = 2` (the
  state sequence, counters and committed epochs), `reset_circuit`;
- the construction contracts and the CLI flag contract (the same errors);
- observer chaining: the promotion controller's tap keeps seeing every
  batch, and the monitor keeps copies, never the batch.

The fine-tunes run each side's own trainer (JAX's tries its whole-epoch
on-device path; the port's is the staged loop), so the committed weights
differ: the gate's decisions are compared, not the scores.
"""

import glob
import json
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.configs import \
    trainer_class_for_config as jax_trainer_class
from deepvision_tpu.core.metrics import MetricsLogger as JaxMetricsLogger
from deepvision_tpu.obs.trace import Tracer as JaxTracer
from deepvision_tpu.utils.faults import FaultInjector as JaxFaultInjector
from deepvision_tpu_torch.configs import get_config, trainer_class_for_config
from deepvision_tpu_torch.core import integrity
from deepvision_tpu_torch.core.metrics import MetricsLogger
from deepvision_tpu_torch.flywheel import (FLYWHEEL_STATES, DriftMonitor,
                                           FlywheelController)
from deepvision_tpu_torch.models.lenet import LeNet5
from deepvision_tpu_torch.obs.trace import Tracer
from deepvision_tpu_torch.serve.batcher import result_within
from deepvision_tpu_torch.serve.cli import build_parser, main, validate_args
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.serve.fleet import ModelFleet
from deepvision_tpu_torch.serve.promote import PromotionController
from deepvision_tpu_torch.utils.faults import FaultInjector
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_serve_ops import jax_serve_modules

SAMPLE = (32, 32, 1)
MONITOR = {"window_examples": 8, "sample_per_batch": 4,
           "hysteresis_windows": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX serve modules and flywheel, loaded while the stand-in is
    in place (the controller imports serve.reload when it is built)."""
    with jax_serve_modules("engine", "fleet", "promote", "reload",
                           "cli") as mods:
        from deepvision_tpu import flywheel as jax_flywheel
        mods.flywheel = jax_flywheel
        yield mods


@pytest.fixture(scope="module")
def epoch1(tmp_path_factory):
    """Epoch 1 of a lenet5 run dir on each side, the same weights: the
    JAX trainer's seeded init, committed by it, and carried across into a
    port checkpoint."""
    root = tmp_path_factory.mktemp("epoch1")
    jwd, pwd = str(root / "jax" / "lenet5"), str(root / "port" / "lenet5")
    trainer = jax_trainer_class("lenet5")(jax_get_config("lenet5"),
                                          workdir=jwd)
    try:
        trainer.init_state(SAMPLE)
        params = jax.device_get(trainer.state.params)
        trainer.ckpt.save(1, trainer.state, {"best_metric": 0.0})
        trainer.ckpt.flush()
    finally:
        trainer.close()
    sd = params_to_state_dict(params, LeNet5())
    ptr = trainer_class_for_config("lenet5")(get_config("lenet5"),
                                             device="cpu", workdir=pwd)
    try:
        ptr.init_state()
        ptr.model.load_state_dict(sd)
        ptr.ckpt.save(1, ptr.state.state_dict(),
                      host_state={"best_metric": 0.0})
        ptr.ckpt.flush()
    finally:
        ptr.close()
    return jwd, pwd, sd, params


@pytest.fixture
def run_dirs(epoch1, tmp_path):
    """Fresh copies of both epoch-1 run dirs for one test."""
    jwd, pwd, sd, params = epoch1
    out = []
    for side, src in (("jax", jwd), ("port", pwd)):
        dst = str(tmp_path / side / "lenet5")
        shutil.copytree(src, dst)
        out.append(dst)
    return out[0], out[1], sd, params


def _gated(side, jax_side, workdir, logger=None):
    """(fleet, served model, promotion controller) of one side."""
    if side == "jax":
        engine = jax_side.engine.PredictEngine.from_config(
            "lenet5", workdir=workdir, buckets=(1, 4), verbose=False)
        fleet = jax_side.fleet.ModelFleet()
        sm = fleet.add(engine, workdir=workdir, max_delay_ms=2.0)
        promoter = jax_side.promote.PromotionController(
            sm, canary_frac=0.3, canary_window_s=0.1, logger=logger)
    else:
        engine = PredictEngine.from_config("lenet5", device="cpu",
                                           workdir=workdir, buckets=(1, 4),
                                           verbose=False)
        fleet = ModelFleet()
        sm = fleet.add(engine, workdir=workdir, max_delay_ms=2.0)
        promoter = PromotionController(sm, canary_frac=0.3,
                                       canary_window_s=0.1, logger=logger)
    return fleet, sm, promoter


def _rows(n, seed, shift=0.0):
    x = np.random.RandomState(seed).randn(n, *SAMPLE).astype(np.float32)
    return x + np.float32(shift)


def _feed(monitor, seed, shift=0.0):
    """One window of sampled rows through the monitor's observer tap (two
    batches of 4: the window is 8)."""
    for k in range(2):
        monitor._observe("live", [0.001], 0.001, None, sample={
            "images": _rows(4, 100 * seed + k, shift), "outputs": None,
            "trace_ref": None})


def _snap(monitor):
    return (monitor.windows, monitor.breaches, monitor.consecutive,
            monitor.triggered_id is not None)


# -- the drift monitor --------------------------------------------------------

def test_drift_monitor_equals_jax(jax_side, run_dirs):
    """A one-window spike (rows shifted by 5 by hand) that a clean window
    resets, then the fault from window 2 on: breach, breach, trigger;
    then both sides promote the same halved weights and a clean window
    shows the watch decay. Every tick's counters equal; shifts and decays
    within 1e-6."""
    jwd, pwd, sd, params = run_dirs
    fault = {"drift_shift_window": 2, "drift_shift_magnitude": 3.0}
    sides = {}
    for side, wd, fi in (("jax", jwd, JaxFaultInjector),
                         ("port", pwd, FaultInjector)):
        fleet, sm, _ = _gated(side, jax_side, wd)
        cls = (jax_side.flywheel.DriftMonitor if side == "jax"
               else DriftMonitor)
        sides[side] = (fleet, sm, cls(sm, faults=fi(**fault), **MONITOR))
    trace = {"jax": [], "port": []}
    minted = {}
    try:
        for w, shift in enumerate((5.0, 0.0, 0.0, 0.0, 0.0)):
            for side, (_, _, mon) in sides.items():
                _feed(mon, w, shift)
                fid = mon.tick()
                if fid is not None:
                    minted[side] = (w, fid)
                trace[side].append((_snap(mon), mon.last_input_shift,
                                    mon.last_watch_decay))
        # the same weights halved go live on both sides
        jcand = {"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) * 0.5, params)}
        pcand = LeNet5()
        pcand.load_state_dict({k: v * 0.5 for k, v in sd.items()})
        sides["jax"][1].engine.stage_candidate(jcand)
        sides["port"][1].engine.stage_candidate(pcand)
        for side, (_, sm, mon) in sides.items():
            sm.engine.promote_candidate()
            mon.reset_trigger()
            _feed(mon, 9)
            mon.tick()
            trace[side].append((_snap(mon), mon.last_input_shift,
                                mon.last_watch_decay))
    finally:
        for fleet, _, _ in sides.values():
            fleet.drain(timeout=30)
    for (ps, pshift, pdecay), (js, jshift, jdecay) in zip(trace["port"],
                                                          trace["jax"]):
        assert ps == js
        assert abs(pshift - jshift) <= 1e-6, (pshift, jshift)
        assert abs(pdecay - jdecay) <= 1e-6, (pdecay, jdecay)
    counts = [t[0] for t in trace["port"]]
    # spike, reset by a clean window, then two fault windows trigger once
    assert counts[:5] == [(1, 1, 1, False), (2, 1, 0, False),
                          (3, 2, 1, False), (4, 3, 2, True),
                          (5, 4, 3, True)]
    assert minted["port"][0] == minted["jax"][0] == 3
    assert minted["port"][1].startswith("fw-")
    assert trace["port"][-1][2] != 0.0          # the halved weights decay
    desc = sides["port"][2].describe()
    assert set(desc) == set(sides["jax"][2].describe())


def test_monitor_chains_the_promoters_tap_and_copies_rows(jax_side,
                                                          run_dirs):
    """Built after the promotion controller, the monitor calls the tap it
    found first (the canary keeps its evidence), then keeps COPIES of at
    most sample_per_batch rows of live batches only."""
    _, pwd, _, _ = run_dirs
    fleet, sm, promoter = _gated("port", jax_side, pwd)
    seen = []
    prev = sm.batcher.observer
    assert prev == promoter._observe

    def recording(gen, lats, disp, err, sample=None):
        seen.append((gen, sample["images"].shape))
        return prev(gen, lats, disp, err, sample=sample)

    sm.batcher.observer = recording
    mon = DriftMonitor(sm, **MONITOR)
    try:
        assert sm.batcher.observer == mon._observe
        x = _rows(3, 1)
        result_within(sm.submit(x), 60.0)
        deadline = time.monotonic() + 10
        while mon.describe()["buffered"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen == [("live", (3, *SAMPLE))]
        assert mon.describe()["buffered"] == 3
        kept = mon._rows[0]
        np.testing.assert_array_equal(kept, x[0])
        assert not np.shares_memory(kept, x)
        mon._observe("candidate", [0.0], 0.0, None,
                     sample={"images": x, "outputs": None})
        mon._observe("live", [0.0], 0.0, RuntimeError("x"),
                     sample={"images": x, "outputs": None})
        assert mon.describe()["buffered"] == 3   # neither is kept
    finally:
        fleet.drain(timeout=30)


# -- the controller -----------------------------------------------------------

def _controller(side, jax_side, sm, **kw):
    if side == "jax":
        return jax_side.flywheel.FlywheelController(
            sm, faults=JaxFaultInjector(drift_shift_window=0,
                                        drift_shift_magnitude=3.0), **kw)
    return FlywheelController(
        sm, faults=FaultInjector(drift_shift_window=0,
                                 drift_shift_magnitude=3.0), **kw)


def _events(logdir):
    with open(glob.glob(os.path.join(logdir, "*.jsonl"))[0]) as fp:
        return [json.loads(line) for line in fp if line.strip()]


def test_episode_promotes_with_one_id_everywhere_as_jax(jax_side, run_dirs,
                                                        tmp_path):
    jwd, pwd, _, _ = run_dirs
    got = {}
    for side, wd, logger_cls, tracer_cls in (
            ("jax", jwd, JaxMetricsLogger, JaxTracer),
            ("port", pwd, MetricsLogger, Tracer)):
        logdir = str(tmp_path / f"logs_{side}")
        logger = logger_cls(logdir, name="serve")
        tracer = tracer_cls(sample=1.0)
        fleet, sm, promoter = _gated(side, jax_side, wd, logger)
        fw = _controller(side, jax_side, sm, tick_every_s=0, logger=logger,
                         tracer=tracer, finetune_epochs=1,
                         finetune_batches=2, **MONITOR)
        try:
            assert sm.flywheel is fw
            states = []
            for w in range(3):
                _feed(fw.monitor, w)
                states.append(fw.tick())
                if states[-1] == "promoted":
                    break
            fid = fw.last_flywheel_id
            health = sm.describe()["flywheel"]
            # rebaselined: the shifted distribution is the new normal
            _feed(fw.monitor, 7)
            states.append(fw.tick())
            spans = {s["name"] for s in tracer.spans()
                     if s["args"].get("flywheel_id") == fid}
            epoch = sm.engine.provenance["checkpoint_epoch"]
            record = promoter.history[-1]
        finally:
            fleet.drain(timeout=30)
            logger.close()
        keys = sorted({k for e in _events(logdir)
                       if e.get("flywheel_id") == fid for k in e
                       if k.startswith("resilience_flywheel")
                       or k.startswith("resilience_promote_promoted")})
        got[side] = {"states": states, "counters": dict(fw.counters),
                     "state": fw.state, "epoch": epoch,
                     "decision": record["decision"],
                     "record_id": record.get("flywheel_id") == fid,
                     "health": (health["flywheel_id"] == fid,
                                health["state"], health["counters"]),
                     "spans": sorted(spans & {"flywheel_finetune",
                                              "flywheel_train_epoch",
                                              "flywheel_gate"}),
                     "keys": keys, "fid": fid.startswith("fw-")}
    assert got["port"] == got["jax"]
    # the port counts the optimizer steps its fine-tune ran (1 epoch of 2)
    assert fw.finetune_steps == 2 and health["finetune_steps"] == 2
    assert got["port"]["states"] == ["monitoring", "promoted", "monitoring"]
    assert got["port"]["epoch"] == 2 and got["port"]["record_id"]
    assert got["port"]["spans"] == ["flywheel_finetune", "flywheel_gate",
                                    "flywheel_train_epoch"]
    assert "resilience_flywheel_drift_detected" in got["port"]["keys"]


class _AlwaysRegress(FaultInjector):
    """Every candidate epoch regresses: each retry's NEW epoch still
    fails the gate."""

    def promote_regression(self, epoch):
        return "accuracy"


class _JaxAlwaysRegress(JaxFaultInjector):
    def promote_regression(self, epoch):
        return "accuracy"


def test_refusals_back_off_then_open_the_circuit_as_jax(jax_side, run_dirs):
    jwd, pwd, _, _ = run_dirs
    got = {}
    for side, wd, regress in (("jax", jwd, _JaxAlwaysRegress),
                              ("port", pwd, _AlwaysRegress)):
        fleet, sm, promoter = _gated(side, jax_side, wd)
        promoter.faults = regress()
        fw = _controller(side, jax_side, sm, tick_every_s=0,
                         finetune_epochs=1, finetune_batches=2,
                         max_attempts=2, backoff_base_s=1.0,
                         backoff_max_s=5.0, **MONITOR)
        x = _rows(2, 11)
        ref = np.asarray(sm.engine.predict(x))
        states, backoff = [], []
        try:
            for w in range(4):               # refused, then backing off
                _feed(fw.monitor, w)
                states.append(fw.tick())
                backoff.append(fw.describe()["backoff_s"] > 0.0)
            time.sleep(1.05)                 # the backoff lapses
            w = 4
            while fw.state != "circuit_open" and w < 12:
                _feed(fw.monitor, w)
                states.append(fw.tick())
                w += 1
            evals = promoter.shadow_evals
            _feed(fw.monitor, 20)
            states.append(fw.tick())
            idle = promoter.shadow_evals == evals
            served = np.asarray(sm.engine.predict(x))
            fw.reset_circuit()
            after = (fw.state, fw.failures, fw.monitor.triggered_id)
        finally:
            fleet.drain(timeout=30)
        got[side] = {
            "states": states, "backoff": backoff,
            "counters": dict(fw.counters), "episodes": fw.episodes,
            "decisions": [(r["decision"], r["epoch"])
                          for r in promoter.history],
            "committed": integrity.committed_epochs(
                os.path.join(wd, "ckpt")),
            "idle": idle, "incumbent": sm.engine.provenance[
                "checkpoint_epoch"],
            "unchanged": bool(np.array_equal(served, ref)),
            "after_reset": after}
    assert got["port"] == got["jax"]
    p = got["port"]
    assert p["states"][:4] == ["monitoring", "refused", "refused", "refused"]
    assert p["states"][-2:] == ["circuit_open", "circuit_open"]
    assert p["decisions"] == [("refused_gate", 2), ("refused_gate", 3)]
    assert p["committed"] == [1, 2, 3] and p["incumbent"] == 1
    assert p["counters"]["circuit_opened"] == 1 and p["idle"]
    assert p["after_reset"] == ("monitoring", 0, None)


def test_construction_contracts_equal_jax(jax_side, run_dirs):
    """A static-weights model and a model without the gate are refused
    with the same errors."""
    jwd, pwd, _, _ = run_dirs
    msgs = {}
    for side, wd in (("jax", jwd), ("port", pwd)):
        ctl = (jax_side.flywheel.FlywheelController if side == "jax"
               else FlywheelController)
        if side == "jax":
            fleet = jax_side.fleet.ModelFleet()
            mk = lambda w: jax_side.engine.PredictEngine.from_config(  # noqa
                "lenet5", workdir=w, buckets=(1,), verbose=False)
        else:
            fleet = ModelFleet()
            mk = lambda w: PredictEngine.from_config(  # noqa: E731
                "lenet5", device="cpu", workdir=w, buckets=(1,),
                verbose=False)
        static = fleet.add(mk(None))
        out = []
        try:
            with pytest.raises(ValueError) as e:
                ctl(static, tick_every_s=0)
            out.append(str(e.value))
        finally:
            fleet.drain(timeout=30)
        fleet2 = (jax_side.fleet.ModelFleet() if side == "jax"
                  else ModelFleet())
        sm = fleet2.add(mk(wd), workdir=wd)
        try:
            with pytest.raises(ValueError) as e:
                ctl(sm, tick_every_s=0)
            out.append(str(e.value))
        finally:
            fleet2.drain(timeout=30)
        msgs[side] = out
    assert msgs["port"] == msgs["jax"]
    assert "static weights" in msgs["port"][0]
    assert "promotion controller" in msgs["port"][1]
    assert FLYWHEEL_STATES == jax_side.flywheel.FLYWHEEL_STATES


@pytest.mark.parametrize("argv", [
    ["-m", "lenet5", "--flywheel-every", "1"],
    ["-m", "lenet5", "--reload-every", "1", "--promote-gate", "-0.02",
     "--flywheel-every", "-1"],
])
def test_flywheel_cli_flag_contract_equals_jax(jax_side, capsys, argv):
    """--flywheel-every needs --promote-gate, and a negative cadence is
    refused: the same error as the JAX CLI's."""
    errors = []
    for parser, validate in ((jax_side.cli.build_parser(),
                              jax_side.cli.validate_args),
                             (build_parser(), validate_args)):
        with pytest.raises(SystemExit):
            validate(parser, parser.parse_args(argv))
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ")[1] == errors[1].split("error: ")[1]
    with pytest.raises(SystemExit):
        main(argv)


def test_flywheel_stands_in_for_the_reload_poller():
    """The port lets --flywheel-every supply the gate's candidates (its
    own reloader proposes what it commits), so `--promote-gate` with
    `--flywheel-every` and no `--reload-every` parses; the gate alone
    still needs a candidate source."""
    parser = build_parser()
    validate_args(parser, parser.parse_args(
        ["-m", "lenet5", "--promote-gate", "-0.02", "--flywheel-every",
         "0.5"]))
    with pytest.raises(SystemExit):
        validate_args(parser, parser.parse_args(
            ["-m", "lenet5", "--promote-gate", "-0.02"]))
