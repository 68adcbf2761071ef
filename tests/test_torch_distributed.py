"""Data parallelism of the port (deepvision_tpu_torch/parallel/mesh.py and
what it reaches: the global-batch BatchNorm, the DDP-wrapped train state,
the trainers' sharded steps and evaluation, the checkpoints, the per-rank
data and the CLI) on the CPU over gloo.

Ranks are processes spawned by `mesh.spawn_ranks` (a FileStore in a
temporary directory, no port: the tests run under xdist), each on one
thread, killed after 300 s. Three spawns of
2 ranks carry every check: one for the steps (against JAX and against one
process), the refusals and the random streams; one for the evaluation and
the checkpoints; and `dryrun_multichip(2)`. Several tests read each.

Bounds:
- (a) the 2-rank step against the JAX step over a 2-device mesh
  (`make_classification_train_step(mesh=...)`), from the same bridged
  weights on the same global batch: the reduced bottleneck ResNet and the
  resnet50_tpu recipe of tests/test_torch_resnet.py, f32, and its
  single-process parity bound: loss 1e-5 relative; parameters and
  BatchNorm statistics within 1e-3 of each leaf's update;
- (b) 2 ranks against one process on the same global batch, through the
  trainer (`run_step`, then `evaluate` of global batches). yolov3_digits
  (64 px, K2's plain version) in f64: chip_smoke.py's DDP_F64_* bounds
  (loss 1e-12 relative; gradients 1e-9 of the largest gradient;
  BatchNorm statistics 1e-12 of the largest value), the eval loss 1e-12
  relative, and the updated weights 1e-7 of the largest update: Adam's
  first update lr * g / (|g| + eps) has slope lr / eps = 1e5 at g = 0, so
  a gradient that is zero up to rounding moves by more than its own
  difference (1.06e-9 measured). vit_tiny (K1's plain version under
  autograd, which takes f32 and bf16 only) in f32: loss, gradients and
  eval loss 1e-6 relative (4.9e-8 measured for the gradients), and the
  weights 1e-4 of the largest update (1.5e-5 measured) wherever the
  gradient's sign is settled, |g| above 1e-5 of the largest gradient
  (0.3% of the elements are not, held under 5%: there the first Adam
  update, about lr * sign(g), may step either way);
- (c) a 2-rank classification eval with a partial last batch against the
  one-process eval (the reduced ResNet in f64, so each row's loss differs
  by f64 rounding only): `count` exactly, loss and top-k 1e-12 relative;
- (d) checkpoints and (f) random streams: equal, tensor for tensor;
- (h) divergence recovery under DDP: lenet5 in f32 with the NaN fault on
  rank 1's rows of epoch 2's first batch rolls both ranks back at once
  (the same events as the one-process run poisoned whole), the ranks'
  states equal, and the weights within 1e-6 of the one-process run's on
  the same global batches (3.0e-8 measured: summation order only).
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

from deepvision_tpu_torch.cli import (_config_from_args, build_parser,
                                      run_classification)
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.detection import DetectionTrainer
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.steps import make_classification_train_step
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.data.mnist import MnistBatches
from deepvision_tpu_torch.data.synthetic import SyntheticClassification
from deepvision_tpu_torch.graft_entry import dryrun_multichip
from deepvision_tpu_torch.models import build_model, resnet
from deepvision_tpu_torch.parallel import mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (DDP_F64_GRAD_RTOL, DDP_F64_LOSS_RTOL,  # noqa: E402
                        DDP_F64_STAT_RTOL, DDP_F64_WEIGHT_RTOL,
                        f64_step_errors, float64_copy, same_tree)

# The port's steps update their state in place and donate nothing; jaxlint
# resolves `make_classification_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001

WORLD = 2
REDUCED = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
RECIPE = ("resnet50_tpu", 4, 10)       # config, steps per epoch, epochs
RESNET_ARGS = ["-m", "resnet50_tpu", "--synthetic", "--device", "cpu",
               "--image-size", "32", "--batch-size", "4",
               "--steps-per-epoch", "2", "--epochs", "1"]
# (h): lenet5 (f32) under the NaN fault at epoch 2's first batch, with one
# recovery: 3 epochs of 2 steps at global batch 4
ROLLBACK_ARGS = ["-m", "lenet5", "--synthetic", "--device", "cpu",
                 "--batch-size", "4", "--steps-per-epoch", "2", "--epochs",
                 "3", "--learning-rate", "1e-3", "--recover-on-divergence",
                 "1"]
ROLLBACK_WEIGHT_TOL = 1e-6
# (b): config -> (its trainer, image size, dtype). vit_tiny runs K1's plain
# version, which takes f32 and bf16 only
STEP_CASES = {"yolov3_digits": (DetectionTrainer, 64, "float64"),
              "vit_tiny": (Trainer, 32, "float32")}
CASE_BOUNDS = {"yolov3_digits": {"loss": DDP_F64_LOSS_RTOL,
                                 "grad": DDP_F64_GRAD_RTOL,
                                 "weight": 1e-7, "stat": DDP_F64_STAT_RTOL,
                                 "eval": 1e-12},
               "vit_tiny": {"loss": 1e-6, "grad": 1e-6, "weight": 1e-4,
                            "stat": 0.0, "eval": 1e-6}}
SETTLED = 1e-5          # |g| over the largest gradient: a settled sign


# -- the ranks ------------------------------------------------------------

def _worker(job, out):
    torch.save(JOBS[job](out), os.path.join(out, f"{job}{mesh.rank()}.pt"))


def _spawn(job: str, out) -> list:
    """Run `job` on WORLD ranks; each rank's result, by rank."""
    mesh.spawn_ranks(_worker, (job, str(out)), world=WORLD, timeout=300)
    return [torch.load(os.path.join(out, f"{job}{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _rows(*arrays):
    """This rank's rows of each global array, as tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        mesh.shard_rows(a, mesh.rank(), mesh.world_size()))) for a in arrays)


def _recipe_batch():
    return next(iter(SyntheticClassification(8, 32, 3, 10, 1, seed=3)))


def _recipe_step(model) -> dict:
    """One resnet50_tpu-recipe step (f32) of `model` on this process's
    rows of the recipe batch."""
    name, steps, epochs = RECIPE
    cfg = get_config(name)
    state = TrainState(model, build_optimizer(
        model.parameters(), cfg.optimizer, cfg.schedule, steps, epochs))
    step = make_classification_train_step(
        label_smoothing=cfg.label_smoothing, compute_dtype=torch.float32)
    metrics = step(state, *_rows(*_recipe_batch()))
    return {"loss": float(metrics["loss"]),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _case_batches(name):
    """(global train batch, global eval batches) of a (b) model."""
    if name == "yolov3_digits":
        size = STEP_CASES[name][1]
        return (next(synthetic_batches(batch_size=4, image_size=size,
                                       num_classes=10, steps=1, seed=0)),
                list(synthetic_batches(batch_size=4, image_size=size,
                                       num_classes=10, steps=2, seed=1)))
    return (next(iter(SyntheticClassification(4, 32, 3, 10, 1, seed=0))),
            list(SyntheticClassification(4, 32, 3, 10, 2, seed=1)))


def _case_model(name):
    """(config, model) of a (b) case, the model in the case's dtype."""
    _, size, dtype = STEP_CASES[name]
    cfg = get_config(name)
    cfg = cfg.replace(batch_size=4, dtype="float32",
                      data=dataclasses.replace(cfg.data, image_size=size))
    if dtype == "float64":
        return cfg.replace(dtype=dtype), float64_copy(build_model(cfg))
    return cfg, build_model(cfg)


def _trainer_step(name, workdir) -> dict:
    """One train step of case `name` through its trainer on this
    process's rows, then the trainer's evaluation of the global eval
    batches: loss, gradients, model state and eval metrics."""
    cfg, model = _case_model(name)
    trainer = STEP_CASES[name][0](cfg, model=model, device="cpu",
                                  workdir=workdir)
    trainer.init_state()
    batch, evals = _case_batches(name)
    metrics = trainer.run_step(_rows(*batch))
    out = {"loss": float(metrics["loss"]),
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "state": {k: v.clone() for k, v in model.state_dict().items()},
           "eval": trainer.evaluate(evals)}
    trainer.close()
    return out


def _refusal(cfg, workdir):
    try:
        Trainer(cfg, device="cpu", workdir=workdir).close()
    except ValueError as e:
        return str(e)
    return None


def _draws() -> dict:
    """Dropout and augment draws of step 3 of a seed-0 state."""
    model = resnet.ResNet(**REDUCED, dtype=torch.float32)
    state = TrainState(model, build_optimizer(
        model.parameters(), get_config("resnet50_tpu").optimizer,
        get_config("resnet50_tpu").schedule, 1, 1))
    state.step = 3
    return {s: torch.rand(6, generator=state.step_generator(s))
            for s in ("", "augment")}


def _job_steps(out) -> dict:
    model = resnet.ResNet(**REDUCED, block=resnet.BottleneckBlock,
                          dtype=torch.float32)
    model.load_state_dict(torch.load(os.path.join(out, "a_weights.pt")),
                          strict=False)
    lenet = get_config("lenet5")
    wd = os.path.join(out, "wd")
    return {"a": _recipe_step(model),
            **{name: _trainer_step(name, os.path.join(out, name))
               for name in STEP_CASES},
            "e": [_refusal(lenet.replace(batch_size=3), wd),
                  _refusal(lenet.replace(batch_size=4, eval_batch_size=5),
                           wd)],
            "f": _draws()}


def _val_set():
    rs = np.random.RandomState(5)
    return (rs.randn(11, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, 11).astype(np.int32))


def _eval(workdir) -> dict:
    """The evaluation (EMA weights swapped in) of the reduced ResNet in
    f64 on an 11-row val set in global batches of 4: 4, 4 and a partial
    3."""
    cfg = get_config("resnet50_tpu").replace(batch_size=4, eval_batch_size=4,
                                             dtype="float64")
    model = float64_copy(resnet.ResNet(
        **REDUCED, block=resnet.BottleneckBlock, dtype=torch.float32,
        generator=torch.Generator().manual_seed(0)))
    trainer = Trainer(cfg, model=model, device="cpu", workdir=workdir)
    trainer.init_state()
    out = trainer.evaluate(MnistBatches(*_val_set(), 4, shuffle=False,
                                        drop_remainder=False))
    trainer.close()
    return out


def _resumed_state(workdir, argv):
    """A trainer of `argv`'s config resumed from `workdir`: (the restored
    epoch, its state)."""
    args = build_parser("ResNet", ["resnet50_tpu"]).parse_args(argv)
    trainer = Trainer(_config_from_args(args, None), device="cpu",
                      workdir=workdir)
    trainer.init_state()
    epoch = trainer.resume()
    trainer.close()
    return epoch, trainer.state.state_dict()


def _rollback_run(workdir, poison: bool) -> dict:
    """ROLLBACK_ARGS's trainer on global synthetic batches (this rank's
    rows of each), the NaN fault armed in this process when `poison`: its
    final state and resilience events."""
    args = build_parser("LeNet", ["lenet5"]).parse_args(ROLLBACK_ARGS)
    cfg = _config_from_args(args, None)

    def data(epoch):
        for batch in SyntheticClassification(cfg.batch_size, 32, 1, 10, 2,
                                              seed=epoch):
            yield _rows(*batch)

    if poison:
        os.environ["DEEPVISION_FAULT_NAN_STEP"] = "2"
    try:
        trainer = Trainer(cfg, device="cpu", workdir=workdir)
    finally:
        os.environ.pop("DEEPVISION_FAULT_NAN_STEP", None)
    trainer.fit(data)
    trainer.close()
    h = trainer.logger.history
    return {"state": trainer.state.state_dict(),
            "recoveries": h["resilience_divergence_recoveries"]["value"],
            "lr_scale": h["resilience_lr_scale"]["value"],
            "epochs": h["epoch_train_loss"]["epochs"]}


def _job_ckpt(out) -> dict:
    one = os.path.join(out, "one")
    epoch, state = _resumed_state(one, RESNET_ARGS)
    saved = torch.load(os.path.join(one, "ckpt", "1", "state.pt"),
                       weights_only=True)
    two = os.path.join(out, "two")
    trainer, result = run_classification(
        "ResNet", ["resnet50_tpu"], RESNET_ARGS + ["--workdir", two])
    return {"resumed_epoch": epoch,
            "resumed_equal": same_tree(state, saved),
            "trained": trainer.state.state_dict(), "result": result,
            "eval": _eval(os.path.join(out, "eval")),
            # only rank 1's batch is poisoned: the epoch's loss is a
            # global mean, so both ranks roll back together
            "rollback": _rollback_run(os.path.join(out, "rollback"),
                                      poison=mesh.rank() == 1)}


JOBS = {"steps": _job_steps, "ckpt": _job_ckpt}


# -- (a), (b), (e), (f): the steps spawn --------------------------------------

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX mesh step, the port's one-process references, and the
    2-rank results of the steps job."""
    import jax
    import jax.numpy as jnp

    from deepvision_tpu.core.config import \
        OptimizerConfig as JaxOptimizerConfig
    from deepvision_tpu.core.config import \
        ScheduleConfig as JaxScheduleConfig
    from deepvision_tpu.core.optim import \
        build_optimizer as jax_build_optimizer
    from deepvision_tpu.core.steps import \
        make_classification_train_step as jax_make_train_step
    from deepvision_tpu.core.train_state import TrainState as JaxTrainState
    from deepvision_tpu.models import resnet as jr
    from deepvision_tpu.parallel import mesh as jmesh
    from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
    from test_torch_yolo import flax_yolo_variables

    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("steps")
    images, labels = _recipe_batch()
    jax_model = jr.ResNet(**REDUCED, block=jr.BottleneckBlock,
                          dtype=jnp.float32)
    port_model = resnet.ResNet(**REDUCED, block=resnet.BottleneckBlock,
                               dtype=torch.float32)
    params, stats = flax_yolo_variables(jax_model, images)
    before = params_to_state_dict(params, port_model, stats)
    torch.save(before, os.path.join(out, "a_weights.pt"))

    name, steps_per_epoch, epochs = RECIPE
    cfg = get_config(name)
    tx = jax_build_optimizer(
        JaxOptimizerConfig(**dataclasses.asdict(cfg.optimizer)),
        JaxScheduleConfig(**dataclasses.asdict(cfg.schedule)),
        steps_per_epoch, epochs)
    jmesh2 = jmesh.make_mesh(jax.devices()[:WORLD])
    repl = jmesh.replicated(jmesh2)
    state = JaxTrainState.create(jax_model.apply, params, tx, stats)
    state = state.replace(**{k: jax.device_put(getattr(state, k), repl)
                             for k in ("params", "batch_stats", "opt_state",
                                       "step")})
    step = jax_make_train_step(label_smoothing=cfg.label_smoothing,
                               compute_dtype=jnp.float32, mesh=jmesh2,
                               donate=False)
    new, metrics = step(state, *jmesh.shard_batch_pytree(
        jmesh2, (images, labels)), jax.random.PRNGKey(0))
    ranks = _spawn("steps", out)
    return {"ranks": ranks, "before": before,
            "jax_loss": float(metrics["loss"]),
            "jax": params_to_state_dict(jax.device_get(new.params),
                                        port_model,
                                        jax.device_get(new.batch_stats)),
            "one": {n: _trainer_step(n, str(out / f"one_{n}"))
                    for n in STEP_CASES},
            "draws": _draws()}


def test_two_rank_step_loss_matches_the_jax_mesh_step(steps):
    for r in steps["ranks"]:
        assert r["a"]["loss"] == pytest.approx(steps["jax_loss"], rel=1e-5)


def test_two_rank_step_parameters_and_statistics_match_the_jax_mesh_step(
        steps):
    got = steps["ranks"][0]["a"]["state"]
    for name, want in steps["jax"].items():
        update = (want - steps["before"][name]).abs().max().item()
        assert update > 0, name
        err = (got[name] - want).abs().max().item()
        assert err <= 1e-3 * update, (name, err, update)


def test_ranks_hold_equal_weights_and_statistics_after_a_step(steps):
    zero, one = (r["a"]["state"] for r in steps["ranks"])
    assert same_tree(zero, one)


def _settled_weight_error(one: dict, ranks: list, before: dict) -> tuple:
    """Largest weight difference over the largest update where the
    gradient's sign is settled, and the share of elements where it is
    not."""
    top = max((one["state"][n] - before[n]).abs().max().item()
              for n in one["grads"])
    top_grad = max(g.abs().max().item() for g in one["grads"].values())
    err, loose, total = 0.0, 0, 0
    for n, g in one["grads"].items():
        settled = g.abs() >= SETTLED * top_grad
        loose += int((~settled).sum())
        total += g.numel()
        for r in ranks:
            diff = (r["state"][n] - one["state"][n]).abs()[settled]
            err = max(err, diff.max().item() if diff.numel() else 0.0)
    return err / top, loose / total


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_rank_step_equals_the_one_process_step(steps, name):
    """In f64 every weight is held; in f32 (vit_tiny) only where the
    gradient's sign is settled: the first Adam update, lr * g / (|g| +
    eps), is about lr * sign(g), so a gradient that is zero up to f32
    rounding (under 5% of the elements) may step either way."""
    before = dict(_case_model(name)[1].named_parameters())
    one, ranks = steps["one"][name], [r[name] for r in steps["ranks"]]
    err = f64_step_errors(one, ranks, before)
    if STEP_CASES[name][2] == "float32":
        err["weight"], loose = _settled_weight_error(one, ranks, before)
        assert loose < 0.05, loose
    for key, bound in CASE_BOUNDS[name].items():
        if key != "eval":
            assert err[key] <= bound, (key, err)
    assert err["counters"], err


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_rank_eval_equals_the_one_process_eval(steps, name):
    want = steps["one"][name]["eval"]
    for r in steps["ranks"]:
        got = r[name]["eval"]
        assert got["count"] == want["count"]
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=CASE_BOUNDS[name]["eval"],
                                           abs=1e-12), k


def test_batches_that_do_not_divide_the_world_are_refused(steps):
    for r in steps["ranks"]:
        assert r["e"] == [
            "global batch_size=3 must be divisible by the mesh data axis "
            "(2 devices); nearest valid: 2",
            "global eval_batch_size=5 must be divisible by the mesh data "
            "axis (2 devices); nearest valid: 4"]


def test_random_streams_differ_by_rank_and_rank_0_draws_the_one_process_stream(
        steps):
    one = steps["draws"]
    zero, other = (r["f"] for r in steps["ranks"])
    for stream in one:
        assert torch.equal(zero[stream], one[stream])
        assert not torch.equal(other[stream], one[stream])


def test_one_process_streams_are_the_unranked_hash():
    """Without a process group the (seed, step, stream) hash is the one
    the port always used: its draws repeat across releases."""
    import hashlib
    draws = _draws()
    for stream, key in (("", "0:3"), ("augment", "0:3:augment")):
        seed = int.from_bytes(hashlib.blake2b(
            key.encode(), digest_size=8).digest(), "little") >> 1
        want = torch.rand(6, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(draws[stream], want)


# -- (c), (d): the checkpoint and eval spawn ---------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("ckpt")
    run_classification("ResNet", ["resnet50_tpu"],
                       RESNET_ARGS + ["--workdir", str(out / "one")])
    ranks = _spawn("ckpt", out)
    two = str(out / "two")
    return {"ranks": ranks, "two": two,
            "resumed": _resumed_state(two, RESNET_ARGS),
            "eval": _eval(str(out / "eval_one")),
            "rollback": _rollback_run(str(out / "rollback_one"),
                                      poison=True)}


def test_two_rank_eval_with_a_partial_batch_equals_the_one_process_eval(
        ckpt):
    want = ckpt["eval"]
    assert want["count"] == 11
    for r in ckpt["ranks"]:
        got = r["eval"]
        assert got["count"] == want["count"]
        for k in ("loss", "top1", "top5"):
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_two_ranks_resume_a_one_process_checkpoint(ckpt):
    for r in ckpt["ranks"]:
        assert r["resumed_epoch"] == 1 and r["resumed_equal"]


def test_a_two_rank_run_writes_one_checkpoint_from_rank_0(ckpt):
    two = ckpt["two"]
    assert sorted(os.listdir(os.path.join(two, "ckpt"))) == [
        "1", "metrics.json"]
    assert os.path.exists(os.path.join(two, "ckpt", "1",
                                       "integrity_manifest.json"))
    with open(os.path.join(two, "resnet50_tpu.jsonl")) as fh:
        lines = fh.read().splitlines()
    assert sum("epoch_train_loss" in line for line in lines) == 1
    assert sum("val_loss" in line for line in lines) == 1
    zero, one = (r["result"] for r in ckpt["ranks"])
    assert zero == one and zero["count"] == 8


def test_one_process_resumes_a_two_rank_checkpoint(ckpt):
    epoch, state = ckpt["resumed"]
    assert epoch == 1
    assert state["ema"] is not None
    for r in ckpt["ranks"]:
        assert same_tree(state, r["trained"])


def test_both_ranks_roll_back_at_once_and_match_one_process(ckpt):
    one = ckpt["rollback"]
    assert one["recoveries"] == [1.0] and one["lr_scale"] == [0.5]
    assert one["epochs"] == [1, 2, 2, 3]
    zero, first = (r["rollback"] for r in ckpt["ranks"])
    for r in (zero, first):
        assert (r["recoveries"], r["lr_scale"], r["epochs"]) == (
            one["recoveries"], one["lr_scale"], one["epochs"])
        assert r["state"]["step"] == one["state"]["step"] == 6
    assert same_tree(zero["state"], first["state"])
    for k, v in one["state"]["model"].items():
        diff = (zero["state"]["model"][k] - v).abs().max().item()
        assert diff <= ROLLBACK_WEIGHT_TOL, (k, diff)


# -- (g) -------------------------------------------------------------------

def test_dryrun_multichip_runs_its_steps_on_two_ranks(capfd):
    dryrun_multichip(WORLD, "cpu", threads=1)
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("dryrun_multichip:")]
    assert len(lines) == 3, lines
    assert "n=2 backend=gloo" in lines[0] and "global_batch=4" in lines[0]
    losses = [float(line.rsplit("loss=", 1)[1]) for line in lines[:2]]
    assert all(math.isfinite(v) for v in losses), lines
    assert "accum_steps=2" in lines[2] and "micro-step 2" in lines[2]


# -- no spawn --------------------------------------------------------------

@pytest.mark.parametrize("batch,world", [(3, 2), (5, 2), (7, 4), (6, 4),
                                         (10, 8), (13, 8), (8, 8)])
def test_batch_check_speaks_the_jax_words(batch, world):
    import jax

    from deepvision_tpu.parallel import mesh as jmesh
    jax_mesh = jmesh.make_mesh(jax.devices()[:world])
    try:
        jmesh.check_batch_divisible(batch, jax_mesh, what="eval_batch_size")
        want = None
    except ValueError as e:
        want = str(e)
    try:
        mesh.check_batch_divisible(batch, world, what="eval_batch_size")
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want


def test_shard_rows_and_padding():
    a = np.arange(12)
    assert [mesh.shard_rows(a, r, 3).tolist() for r in range(3)] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    assert mesh.pad_to_multiple(11, 4) == 12
    assert mesh.pad_to_multiple(12, 4) == 12
    with pytest.raises(ValueError, match="nearest valid"):
        mesh.shard_rows(a, 0, 5)


def test_no_group_is_one_process(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.maybe_init_distributed() is False
    assert not mesh.is_initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main_process()) == (
        0, 1, True)
    assert mesh.agree_any(True) and not mesh.agree_any(False)
    t = torch.ones(3)
    assert mesh.all_reduce_(t) is t
    m = {"loss": torch.tensor(2.0)}
    assert mesh.global_means(m) is m


def test_rank_0_makes_the_one_process_synthetic_batches():
    for make in (lambda **kw: SyntheticClassification(4, 8, 3, 10, 2, seed=5,
                                                      **kw),
                 lambda **kw: synthetic_batches(batch_size=4, image_size=32,
                                                steps=2, seed=5, **kw)):
        base, zero, one = (list(make(**kw)) for kw in (
            {}, {"rank": 0}, {"rank": 1}))
        for b, z, o in zip(base, zero, one):
            for x, y, w in zip(b, z, o):
                np.testing.assert_array_equal(x, y)
                assert x.shape == w.shape
            assert not np.array_equal(b[0], o[0])


def test_ranks_split_each_global_digits_batch():
    images = np.arange(40, dtype=np.float32)[:, None]
    labels = np.arange(40, dtype=np.int32)
    whole = list(MnistBatches(images, labels, 8, shuffle=True, seed=3))
    parts = [list(MnistBatches(images, labels, 8, shuffle=True, seed=3,
                               rank=r, world=WORLD)) for r in range(WORLD)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 5
    for i, (x, y) in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([p[i][1] for p in parts]), y)
        np.testing.assert_array_equal(
            np.concatenate([p[i][0] for p in parts]), x)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, torn down after."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        yield
    finally:
        mesh.destroy()


def test_global_batch_norm_at_world_1_is_batch_norm(world_of_one,
                                                    monkeypatch):
    """Under a group of one, the global-batch BatchNorm's forward, running
    statistics and gradients are the one-process module's (f64, 1e-12),
    and its backward passes `gradcheck`."""
    from deepvision_tpu_torch.models.common import (BatchNorm,
                                                    _GlobalBatchNorm)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 3, 5, 6, generator=g, dtype=torch.float64) * 3 + 1
         ).requires_grad_(True)
    w = torch.rand(3, generator=g, dtype=torch.float64).requires_grad_(True)
    b = torch.randn(3, generator=g, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w, b: _GlobalBatchNorm.apply(x, w, b, 1e-5)[0], (x, w, b))
    dy = torch.randn(x.shape, generator=g, dtype=torch.float64)

    def run():
        bn = BatchNorm(3, eps=1e-5, dtype=torch.float64).double().train()
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        xi = x.detach().clone().requires_grad_(True)
        y = bn(xi)
        (y * dy).sum().backward()
        return [y, bn.running_mean, bn.running_var, xi.grad, bn.weight.grad,
                bn.bias.grad]

    grouped = run()
    monkeypatch.setattr(mesh, "is_initialized", lambda: False)
    for got, want in zip(grouped, run()):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
