"""chip_smoke.py's tensor-core gate, on listings shaped like `cuobjdump
-sass` of the attention library: it passes only when every bf16 kernel
(DMAX 64 and 128, 16-byte and scalar copies) is listed once with HMMA.
And the wiring of its phase 11 (data parallelism): the argv and
environment each worker gets, a failing or hanging worker failing the
phase, and the f64 step comparison with its bounds on CPU tensors. Phases
12 and 13 rehearse on the CPU at small sizes, the card stood in for by the
CPU."""

import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def _sass(**override):
    """{mangled kernel: HMMA count} as the build lists it: the four bf16
    kernels and the three f32 ones, in an anonymous namespace."""
    hmma = {f"_ZN12_GLOBAL__N_119flash_attention_fwdIfLi{d}EEEvPKT_"
            f"S3_S3_PS1_iiNS_7StridesES4_S4_S4_f": 0 for d in (32, 64, 128)}
    for (dmax, vec), tag in chip_smoke.TC_KERNELS.items():
        hmma[f"_ZN12_GLOBAL__N_122{tag}vPK13__nv_bfloat16S2_S2_PS0_ii"
             f"NS_7StridesES4_S4_S4_f"] = 2 * dmax
    for tag, count in override.items():
        for raw in [r for r in hmma if tag in r]:
            if count is None:
                del hmma[raw]
            else:
                hmma[raw] = count
    return hmma


def test_gate_passes_on_the_built_listing():
    chip_smoke.check_tensor_cores(_sass())


@pytest.mark.parametrize("case", [
    {"ILi64ELb1EE": 0},            # the served kernel without HMMA
    {"ILi128ELb0EE": 0},
    {"ILi64ELb0EE": None},         # a kernel missing from the listing
    {"fwd_tc": None},              # no bf16 kernel at all
], ids=["dmax64-vec-no-hmma", "dmax128-scalar-no-hmma",
        "dmax64-scalar-missing", "none-listed"])
def test_gate_fails(case):
    with pytest.raises(AssertionError):
        chip_smoke.check_tensor_cores(_sass(**case))


def test_gate_fails_on_an_empty_listing():
    with pytest.raises(AssertionError):
        chip_smoke.check_tensor_cores({})


# -- the best-IoU kernel's SASS counts --------------------------------------

_K2 = "_ZN12_GLOBAL__N_115best_iou_kernelENS_8SegmentsEPKfi"
_LISTING = f"""
	code for sm_90a
		Function : {_K2}
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
.L_x_1:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FMNMX.NAN R5, R4, R6, !PT ;
        /*0030*/                   MUFU.RCP R7, R5 ;
        /*0040*/                   MUFU.RCP R8, R5 ;
.L_x_2:
        /*0050*/                   FMNMX.NAN R5, R4, R6, !PT ;
        /*0060*/                   MUFU.RCP R7, R5 ;
        /*0070*/               @P1 BRA `(.L_x_2) ;
        /*0080*/               @P0 BRA `(.L_x_1) ;
.L_x_3:
        /*0090*/                   FADD R5, R4, R6 ;
        /*00a0*/                   FMNMX R5, R4, R6, !PT ;
        /*00b0*/                   MUFU.RCP R7, R5 ;
        /*00c0*/                   MUFU.RCP R7, R5 ;
        /*00d0*/              @!P2 BRA 0x90 ;
        /*00e0*/                   EXIT ;
"""


def test_sass_counts_find_the_innermost_loop_with_most_divisions():
    from deepvision_tpu_torch.tools.build_report import parse_sass
    sass = parse_sass(_LISTING)
    assert list(sass) == [_K2] and len(sass[_K2]) == 15
    assert sass[_K2][7] == (0x70, "@P1 BRA 0x50")     # label resolved
    counts = chip_smoke.sass_counts(sass)
    assert counts["instructions"] == 15
    assert counts["MUFU.RCP"] == 5 and counts["FMNMX"] == 3
    # .L_x_1's loop holds .L_x_2's, so it is not innermost; of the two
    # innermost loops the one at 0x90 has two divisions
    assert counts["loop"]["instructions"] == 5
    assert counts["loop"]["MUFU.RCP"] == 2
    assert counts["loop"]["by_opcode"] == {"MUFU": 2, "FADD": 1,
                                           "FMNMX": 1, "BRA": 1}
    assert counts["loop_instructions_per_pair"] == 2.5


def test_sass_counts_fail_without_the_kernel():
    with pytest.raises(AssertionError):
        chip_smoke.sass_counts({"_Z5otherv": []})


# -- what the best-IoU check reports ----------------------------------------

def test_abs_err_is_zero_where_both_agree_on_inf_and_nan():
    inf, nan = float("inf"), float("nan")
    out = chip_smoke.torch.tensor([inf, -inf, nan, 0.5, -0.0])
    ref = chip_smoke.torch.tensor([inf, -inf, nan, 0.5, 0.0])
    assert chip_smoke.abs_err(out, ref) == 0.0
    assert chip_smoke.same(out, ref)


@pytest.mark.parametrize("got", [float("nan"), float("inf"), 0.25],
                         ids=["nan-for-value", "inf-for-value", "value"])
def test_abs_err_reports_any_disagreement(got):
    ref = chip_smoke.torch.tensor([float("inf"), 0.5])
    out = chip_smoke.torch.tensor([float("inf"), got])
    err = chip_smoke.abs_err(out, ref)
    assert not err <= chip_smoke.IOU_TOL
    assert not chip_smoke.same(out, ref)


def test_best_iou_bound_counts_16_operations_per_pair():
    t, by = chip_smoke.best_iou_bound(16, 8112 + 2028 + 507, 100)
    assert by == "operations"
    assert t == pytest.approx(16 * 16 * 10647 * 100 / 67e12 * 1e3)
    t, by = chip_smoke.best_iou_bound(16, 10647, 1)
    assert by == "bytes"


# -- phase 6's comparisons ----------------------------------------------------

def test_same_tree_compares_nested_state_exactly():
    t = chip_smoke.torch.arange(4.0)
    a = {"model": {"w": t}, "optimizer": {"inner": {"state": {0: {
        "exp_avg": t * 2}}, "param_groups": [{"lr": 1e-3,
                                              "betas": (0.9, 0.999)}]},
        "count": 3, "acc_grads": None}, "step": 3}
    b = {"model": {"w": t.clone()}, "optimizer": {"inner": {"state": {0: {
        "exp_avg": t * 2}}, "param_groups": [{"lr": 1e-3,
                                              "betas": (0.9, 0.999)}]},
        "count": 3, "acc_grads": None}, "step": 3}
    assert chip_smoke.same_tree(a, b)
    b["optimizer"]["inner"]["state"][0]["exp_avg"][1] += 1e-6
    assert not chip_smoke.same_tree(a, b)
    b["optimizer"]["inner"]["state"][0]["exp_avg"] = t * 2
    b["optimizer"]["count"] = 4
    assert not chip_smoke.same_tree(a, b)
    b["optimizer"]["count"] = 3
    del b["step"]
    assert not chip_smoke.same_tree(a, b)


def test_vit_grad_rel_scales_each_tensor_and_the_zero_key_bias():
    """Each gradient's difference over its own largest value; the key
    biases' (0 up to rounding) over the model's largest."""
    torch = chip_smoke.torch
    cpu = {"blocks.0.attn.query.weight": torch.tensor([2.0, -4.0]),
           "blocks.0.attn.key.bias": torch.tensor([1e-9, -1e-9])}
    card = {"blocks.0.attn.query.weight": torch.tensor([2.0, -4.004]),
            "blocks.0.attn.key.bias": torch.tensor([3e-9, 0.0])}
    assert chip_smoke.vit_grad_rel(card, cpu) == pytest.approx(1e-3, rel=1e-4)
    card["blocks.0.attn.key.bias"] = torch.tensor([0.04, 0.0])
    assert chip_smoke.vit_grad_rel(card, cpu) == pytest.approx(1e-2, rel=1e-4)


def test_zoo_phases_drive_every_zoo_config_through_its_entry_point():
    """Phase 9 trains each zoo config through the `MODELS` list of its
    family's `torch/train.py`, and phase 10 serves configs it trains."""
    import runpy
    repo = os.path.dirname(chip_smoke.__file__)
    for family, names in chip_smoke.ZOO_MODELS.items():
        entry = runpy.run_path(os.path.join(repo, family, "torch",
                                            "train.py"), run_name="zoo")
        assert entry["MODELS"] == names, family
    assert {n for names in chip_smoke.ZOO_MODELS.values() for n in names} \
        == set(chip_smoke.ZOO)
    assert all(chip_smoke.ZOO[n][0] in chip_smoke.ZOO_MODELS
               for n in chip_smoke.ZOO)
    assert set(chip_smoke.ZOO_SERVED) <= set(chip_smoke.ZOO)


def test_no_dropout_sets_every_rate_to_zero():
    from deepvision_tpu_torch.models.common import Dropout
    from deepvision_tpu_torch.models.inception import InceptionV1
    model = chip_smoke.no_dropout(InceptionV1(10, image_size=96))
    rates = [m.rate for m in model.modules() if isinstance(m, Dropout)]
    assert rates == [0.0, 0.0, 0.0]          # the head's, aux1's, aux2's


def test_step_bound_counts_convs_and_dense_layers():
    """A 3x3/2 conv of 3 -> 8 channels on 8x8 (4*4*8 outputs of 27
    multiply-adds), a depthwise 3x3 (4*4*8 of 9) and a dense 128 -> 10 (10
    of 128): 5,888 MACs, 11,776 operations an image; the step bound is 3
    forwards at the bf16 peak unless the bytes take longer."""
    torch = chip_smoke.torch
    from deepvision_tpu_torch.models import common
    from deepvision_tpu_torch.models.inception import InceptionV3
    from deepvision_tpu_torch.tools import profile_classification as pc

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = common.Conv(3, 8, 3, 2)
            self.dw = common.Conv(8, 8, 3, groups=8)
            self.head = common.Dense(128, 10)

        def forward(self, x, generator=None):
            x = self.dw(self.conv(x.permute(0, 3, 1, 2)))
            return self.head(common.flatten_nhwc(x))

    assert pc.forward_flops(Tiny(), torch.zeros(2, 8, 8, 3)) \
        == 2 * 2 * 5_888
    ms, by = pc.step_bound_ms(1e15, 0, 0)
    assert by == "operations" and ms == pytest.approx(3e15 / 989e12 * 1e3)
    ms, by = pc.step_bound_ms(1.0, 3.35e12, 0)
    assert by == "bytes" and ms == pytest.approx(1e3)
    # train mode counts the aux head too
    v3 = InceptionV3(10, image_size=107)
    x = torch.zeros(2, 107, 107, 3)
    aux = v3.aux
    with_aux = pc.forward_flops(v3, x)
    per_aux = 2 * 2 * (128 * 768 + 768 * 128 + 768 * 10)
    assert aux.convs[1].layers[0].kernel_size == (1, 1)
    assert with_aux - pc.forward_flops(
        InceptionV3(10, aux=False, image_size=107), x) == per_aux


@pytest.mark.parametrize("name", ["inception_v1", "inception_v3",
                                  "shufflenet_v1", "alexnet2"])
def test_float64_copy_computes_every_layer_in_f64(name):
    """The reference step of phase 9 and the zoo's card tests: every
    module of the f64 copy returns f64 (LRN, BatchNorm, pools, heads), in
    train mode with the aux heads, and its loss stays f64; the model it
    copies keeps its f32 weights."""
    torch = chip_smoke.torch
    from deepvision_tpu_torch.core import losses
    from deepvision_tpu_torch.models import alexnet, inception, shufflenet
    model = {"inception_v1": lambda: inception.InceptionV1(
                 10, image_size=96),
             "inception_v3": lambda: inception.InceptionV3(
                 10, image_size=107),
             "shufflenet_v1": lambda: shufflenet.ShuffleNetV1(10),
             "alexnet2": lambda: alexnet.AlexNetV2(10, image_size=67)}[name]()
    size = {"inception_v1": 96, "inception_v3": 107, "alexnet2": 67}.get(
        name, 32)
    ref = chip_smoke.float64_copy(chip_smoke.no_dropout(model)).train()
    dtypes = set()
    for m in ref.modules():
        m.register_forward_hook(lambda m, i, o: dtypes.update(
            t.dtype for t in (o if isinstance(o, tuple) else (o,))))
    out = ref(torch.zeros(2, size, size, 3, dtype=torch.float64).normal_(),
              generator=torch.Generator().manual_seed(0))
    assert dtypes == {torch.float64}
    loss = losses.classification_loss(out, torch.arange(2))
    assert loss.dtype == torch.float64
    assert all(p.dtype == torch.float32 for p in model.parameters())


# -- phase 11: data parallelism ----------------------------------------------

def _flag(argv, name):
    return argv[argv.index(name) + 1]


def test_phase_11_workers_get_the_entry_points_argv(tmp_path):
    """11a runs phases 5 and 8's entry-point arguments under a torchrun
    launch of one process over NCCL; 11b two ranks over gloo, each the
    only process of its host (LOCAL_RANK 0: both on card 0), meeting at
    one address, with global batches that divide the world."""
    plans = chip_smoke.ddp_plans(str(tmp_path), 29511)
    spec, commands, envs = plans["11a"]
    assert spec["backend"] == "nccl" and "f64" not in spec
    (cmd,) = commands
    assert cmd[1:] == ["-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node=1",
                       os.path.abspath(chip_smoke.__file__)]
    assert envs == [None]
    (yolo_family, yolo), (resnet_family, resnet) = spec["runs"]
    assert (yolo_family, resnet_family) == ("YOLO", "ResNet")
    assert (_flag(yolo, "-m"), _flag(yolo, "--image-size"),
            _flag(yolo, "--batch-size"), _flag(yolo, "--steps-per-epoch"),
            _flag(yolo, "--device")) == (
        chip_smoke.YOLO_MODEL, "416", str(chip_smoke.YOLO_BATCH),
        str(chip_smoke.DDP_YOLO_STEPS), "cuda")
    assert (_flag(resnet, "-m"), _flag(resnet, "--batch-size"),
            _flag(resnet, "--steps-per-epoch"), _flag(resnet, "--device")
            ) == (chip_smoke.RESNET_MODEL, str(chip_smoke.RESNET_BATCH),
                  str(chip_smoke.DDP_RESNET_STEPS), "cuda")
    assert "--device-augment" in resnet
    assert _flag(yolo, "--workdir") != _flag(resnet, "--workdir")

    spec, commands, envs = plans["11b"]
    assert spec["backend"] == "gloo" and spec["f64"]
    assert len(commands) == len(envs) == chip_smoke.DDP_RANKS == 2
    assert all(c[1:] == [os.path.abspath(chip_smoke.__file__)]
               for c in commands)
    assert [e["RANK"] for e in envs] == ["0", "1"]
    assert {(e["WORLD_SIZE"], e["LOCAL_RANK"], e["MASTER_ADDR"],
             e["MASTER_PORT"]) for e in envs} == {
        ("2", "0", "127.0.0.1", "29511")}
    (_, yolo), (_, resnet) = spec["runs"]
    for argv, batch in ((yolo, chip_smoke.DDP2_YOLO_BATCH),
                        (resnet, chip_smoke.DDP2_RESNET_BATCH)):
        assert _flag(argv, "--batch-size") == str(batch)
        assert batch % chip_smoke.DDP_RANKS == 0
        assert _flag(argv, "--device") == "cuda"
        assert _flag(argv, "--workdir").startswith(spec["out"])
    assert _flag(yolo, "--image-size") == "416"
    assert "--device-augment" in resnet
    assert chip_smoke.DDP_F64_BATCH % chip_smoke.DDP_RANKS == 0


def test_a_failing_worker_fails_the_phase(tmp_path):
    ok = [sys.executable, "-c", "print('fine')"]
    bad = [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
    logs = [str(tmp_path / f"w{i}.log") for i in range(2)]
    chip_smoke.run_workers([ok, ok], [None, None], logs)
    with pytest.raises(AssertionError,
                       match=r"(?s)exit codes \[0, 3\].*boom"):
        chip_smoke.run_workers([ok, bad], [None, None], logs)


def test_a_worker_that_outlives_its_time_is_killed_and_fails(tmp_path):
    slow = [sys.executable, "-c", "import time; time.sleep(60)"]
    logs = [str(tmp_path / "w.log")]
    with pytest.raises(AssertionError, match="exit codes None"):
        chip_smoke.run_workers([slow], [None], logs, timeout=1.0)


def test_workers_started_early_are_collected_later(tmp_path):
    """11b's way: the workers start, run on beside later phases, and are
    waited for afterwards; a failure still fails the phase with its log's
    tail."""
    ok = [sys.executable, "-c", "import time; time.sleep(0.5)"]
    bad = [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
    logs = [str(tmp_path / f"w{i}.log") for i in range(2)]
    procs = chip_smoke.start_workers([ok, ok], [None, None], logs)
    assert all(p.poll() is None for p in procs)
    chip_smoke.wait_workers(procs, logs)
    procs = chip_smoke.start_workers([ok, bad], [None, None], logs)
    with pytest.raises(AssertionError,
                       match=r"(?s)exit codes \[0, 3\].*boom"):
        chip_smoke.wait_workers(procs, logs)


def test_a_ddp_phase_started_early_yields_each_ranks_record(tmp_path):
    """`start_ddp_phase` writes the spec and starts one worker a rank with
    `--ddp-worker <spec>`; `wait_ddp_phase` returns the records the ranks
    wrote beside it, by rank."""
    write = ("import json, os, sys; r = os.environ['RANK']; "
             "out = os.path.dirname(sys.argv[2]); "
             "json.dump({'rank': int(r)}, "
             "open(os.path.join(out, f'rank{r}.json'), 'w'))")
    spec = {"out": str(tmp_path), "backend": "gloo"}
    envs = [dict(os.environ, RANK=str(r)) for r in range(2)]
    run = chip_smoke.start_ddp_phase(
        spec, [[sys.executable, "-c", write]] * 2, envs)
    ranks = chip_smoke.wait_ddp_phase("phase 11b", run)
    assert [r["rank"] for r in ranks] == [0, 1]
    with open(tmp_path / "spec.json") as fh:
        assert json.load(fh) == spec
    # 11a's way, started and waited for in one call, on the same path
    assert chip_smoke.ddp_phase(
        "phase 11a", spec, [[sys.executable, "-c", write]] * 2, envs) == ranks


def test_lines_printed_beside_11b_say_so(capsys, monkeypatch):
    """While 11b's ranks train on the card, every log line says so, so
    that its times are not read as taken on a card of its own."""
    monkeypatch.setattr(chip_smoke, "BESIDE", set())
    chip_smoke.phase("alone")
    chip_smoke.BESIDE.add("11b's 2 training ranks")
    chip_smoke.phase("12a step 55.9 ms")
    chip_smoke.BESIDE.clear()
    chip_smoke.phase("alone again")
    alone, shared, again = capsys.readouterr().out.splitlines()
    assert "beside" not in alone and "beside" not in again
    assert shared.endswith("beside 11b's 2 training ranks] 12a step 55.9 ms")


def test_an_exception_exits_the_script_non_zero(tmp_path):
    """A phase's AssertionError leaves `python chip_smoke.py` with a
    non-zero exit: here a worker spec whose entry point does not exist."""
    spec = tmp_path / "spec.json"
    spec.write_text('{"out": "%s", "backend": "gloo", "runs": '
                    '[["NoSuchFamily", []]]}' % tmp_path)
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="0")
    proc = subprocess.run([sys.executable, chip_smoke.__file__,
                           "--ddp-worker", str(spec)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not (tmp_path / "rank0.json").exists()


def _step_record(seed=0):
    torch = chip_smoke.torch
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    return {"loss": 2.5,
            "grads": {"w": torch.randn(4, 3, generator=g, dtype=f64)},
            "state": {"w": torch.randn(4, 3, generator=g, dtype=f64),
                      "bn.running_mean": torch.rand(3, generator=g,
                                                    dtype=f64),
                      "bn.num_batches_tracked": torch.tensor(1)}}


def _perturbed(key, name, delta):
    r = _step_record()
    if key == "loss":
        r["loss"] += delta
    else:
        r[key] = dict(r[key])
        r[key][name] = r[key][name] + delta
    return r


def test_f64_step_errors_hold_equal_steps():
    one = _step_record()
    before = {"w": one["state"]["w"] - 0.1}
    err = chip_smoke.f64_step_errors(one, [_step_record(), _step_record()],
                                     before)
    assert err == {"loss": 0.0, "grad": 0.0, "weight": 0.0, "stat": 0.0,
                   "counters": True}
    chip_smoke.check_f64_step_errors(err)


@pytest.mark.parametrize("key,name,delta,field", [
    ("loss", None, 1e-9, "loss"),
    ("grads", "w", 1e-6, "grad"),
    ("state", "w", 1e-8, "weight"),
    ("state", "bn.running_mean", 1e-9, "stat"),
    ("state", "bn.num_batches_tracked", 1, "counters"),
], ids=["loss", "gradient", "weight", "statistic", "counter"])
def test_f64_step_errors_catch_one_rank_off(key, name, delta, field):
    """One rank's step off the one-process step in one place, by more
    than the bound there (the weights' update is 0.1 here), fails the
    check and names the place."""
    one = _step_record()
    before = {"w": one["state"]["w"] - 0.1}
    err = chip_smoke.f64_step_errors(
        one, [_step_record(), _perturbed(key, name, delta)], before)
    off = [k for k, v in err.items() if (v is False if k == "counters"
                                          else v > 0)]
    assert off == [field]
    with pytest.raises(AssertionError, match="two-rank f64 step"):
        chip_smoke.check_f64_step_errors(err)


# -- phase 12: yolov3 inference ----------------------------------------------

class _FakeTrainer:
    """Stands in for the restored phase 5 trainer."""

    def __init__(self, restored=1):
        self.restored = restored
        self.closed = False

    def init_state(self):
        pass

    def resume(self):
        return self.restored

    def close(self):
        self.closed = True


def _fake_phase_12(monkeypatch, restored=1, fail=None, launch=None):
    """Phase 12 with each sub-phase replaced: `fail` names the one that
    raises, `launch` the one that bumps a kernel's launch count."""
    calls = []

    def sub(name, result):
        def run(*args):
            calls.append(name)
            if name == fail:
                raise AssertionError(f"{name} failed")
            if name == launch:
                chip_smoke.best_iou.launches += 1
            return result
        return run

    monkeypatch.setattr(chip_smoke, "DetectionTrainer",
                        lambda *a, **k: _FakeTrainer(restored))
    monkeypatch.setattr(chip_smoke, "check_predict", sub("predict", {}))
    monkeypatch.setattr(chip_smoke, "check_detection_entry_points",
                        sub("entry", None))
    monkeypatch.setattr(chip_smoke, "check_detection_serving",
                        sub("serve", {}))
    monkeypatch.setattr(chip_smoke, "start_p12_evaluation", lambda: {})
    monkeypatch.setattr(chip_smoke, "finish_p12_evaluation",
                        sub("evaluate", {}))
    monkeypatch.setattr(chip_smoke.best_iou, "launches", 7)
    monkeypatch.setattr(chip_smoke.flash_attention, "launches", 9)
    return calls


def test_phase_12_runs_every_sub_phase_with_the_counts_zeroed(monkeypatch):
    calls = _fake_phase_12(monkeypatch)
    out = chip_smoke.check_detection_inference(
        {"config": None, "workdir": "wd"})
    assert calls == ["predict", "entry", "serve", "evaluate"]
    assert "serve" in out and "evaluate" in out
    assert (chip_smoke.flash_attention.launches,
            chip_smoke.best_iou.launches) == (0, 0)


@pytest.mark.parametrize("fail", ["predict", "entry", "serve", "evaluate"])
def test_a_failing_sub_phase_fails_phase_12(monkeypatch, fail):
    _fake_phase_12(monkeypatch, fail=fail)
    with pytest.raises(AssertionError, match=f"{fail} failed"):
        chip_smoke.check_detection_inference({"config": None,
                                              "workdir": "wd"})


@pytest.mark.parametrize("launch", ["predict", "entry", "serve",
                                    "evaluate"])
def test_a_kernel_launch_on_the_inference_path_fails_phase_12(monkeypatch,
                                                              launch):
    _fake_phase_12(monkeypatch, launch=launch)
    with pytest.raises(AssertionError, match="a kernel ran"):
        chip_smoke.check_detection_inference({"config": None,
                                              "workdir": "wd"})


def test_phase_12_fails_when_phase_5s_checkpoint_does_not_restore(
        monkeypatch):
    calls = _fake_phase_12(monkeypatch, restored=None)
    with pytest.raises(AssertionError, match="did not restore"):
        chip_smoke.check_detection_inference({"config": None,
                                              "workdir": "wd"})
    assert calls == []


def test_leaf_errors_compare_json_lists_with_the_reference_tree():
    np = chip_smoke.np
    ref = ((np.ones((1, 2, 4)), np.full((1, 2, 1), 4.0)),
           (np.zeros((1, 1, 4)), np.ones((1, 1, 1))))
    answer = [[a.tolist() for a in scale] for scale in ref]
    assert chip_smoke.leaf_rel_err(answer, ref) == 0.0
    answer[0][1][0][1][0] = 5.0             # 1 off a leaf whose largest is 4
    assert chip_smoke.leaf_rel_err(answer, ref) == 0.25
    with pytest.raises(AssertionError, match="shapes differ"):
        chip_smoke.leaf_rel_err([[np.ones((1, 3, 4)), ref[0][1]], ref[1]],
                                ref)
    with pytest.raises(AssertionError, match="outputs"):
        chip_smoke.leaf_rel_err(answer[:1], ref)


def test_match_picks_needs_each_top_pick_in_the_other_run():
    torch = chip_smoke.torch
    boxes = torch.tensor([[[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9],
                           [0.0, 0.0, 0.0, 0.0]]])
    want = (boxes, torch.tensor([[0.9, 0.8, 0.0]]),
            torch.tensor([[[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]]]),
            torch.tensor([2]))
    swapped = (boxes[:, [1, 0, 2]], torch.tensor([[0.8, 0.9, 0.0]]),
               want[2][:, [1, 0, 2]], torch.tensor([2]))
    assert chip_smoke.match_picks(swapped, want, 10, 1e-6) == 2
    moved = (boxes + 0.01, *want[1:])
    with pytest.raises(AssertionError, match="no match"):
        chip_smoke.match_picks(moved, want, 10, 1e-3)
    other_class = (boxes, want[1], want[2][:, :, [1, 0]], want[3])
    with pytest.raises(AssertionError, match="no match"):
        chip_smoke.match_picks(other_class, want, 1, 1e-3)


class HostEvent:
    """torch.cuda.Event on the host clock."""

    def __init__(self, **_):
        self.t = None

    def record(self, *_):
        self.t = chip_smoke.time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _card_on_the_cpu(monkeypatch, pinned=None):
    """The card's device, CUDA events, memory counters and profiler stood
    in for by the CPU, the host clock, 0 and a count of 1; the workers get
    `--device cpu`, and a `--workdir` they name pins the `pinned` model
    kwargs."""
    torch = chip_smoke.torch
    from deepvision_tpu_torch import cli
    from deepvision_tpu_torch.core import trainer as trainer_mod
    from deepvision_tpu_torch.serve import engine as engine_mod

    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    for module in (cli, trainer_mod, engine_mod):
        monkeypatch.setattr(module, "resolve_device", cpu)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(torch.nn.Module, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_profile",
                        lambda fn: (fn(), (1, 0.0))[1])
    run_workers = chip_smoke.run_workers

    def on_the_cpu(cmds, envs, logs, timeout):
        for cmd in cmds:
            if pinned and "--workdir" in cmd:
                wd = cmd[cmd.index("--workdir") + 1]
                os.makedirs(wd, exist_ok=True)
                with open(os.path.join(wd, "model_kwargs.json"), "w") as fh:
                    chip_smoke.json.dump(pinned, fh)
        run_workers([c + ["--device", "cpu"] for c in cmds], envs, logs,
                    timeout)

    monkeypatch.setattr(chip_smoke, "run_workers", on_the_cpu)
    torch.set_num_threads(2)


def test_phase_12_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """Phase 12's sub-phases end to end on the CPU at a small size
    (yolov3_digits at 64 px, batch 4): the card's device, CUDA events and
    profiler stood in for by the CPU, the host clock and a count of 1."""
    _card_on_the_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "YOLO_MODEL", "yolov3_digits")
    workdir = str(tmp_path / "wd")
    trainer, _ = chip_smoke.run_detection("YOLO", ["yolov3_digits"], [
        "-m", "yolov3_digits", "--synthetic", "--image-size", "64",
        "--batch-size", "4", "--steps-per-epoch", "1", "--epochs", "1",
        "--device", "cpu", "--workdir", workdir])
    out = chip_smoke.check_detection_inference(
        {"config": trainer.config, "workdir": workdir})
    assert out["nms_ms"] > 0 and out["forward_ms"] > 0
    assert set(out["serve"]["batch_ms"]) == {1, 8}
    assert out["evaluate"]["seconds"] > 0
    assert (chip_smoke.flash_attention.launches,
            chip_smoke.best_iou.launches) == (0, 0)


# -- phase 13: CenterNet and pose ------------------------------------------------

TINY_P13 = dict(num_stack=2, order=2, width_mult=1 / 16)


def _tiny_p13(monkeypatch):
    """Phase 13 at 32 px, batch 2, on the tiny models of both families
    (their configs otherwise as registered); returns the configs."""
    from deepvision_tpu_torch import cli
    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.serve import engine as engine_mod

    def tiny(name):
        cfg = get_config(name)
        if name not in chip_smoke.P13_MODELS:
            return cfg
        return cfg.replace(model_kwargs=TINY_P13)

    for module in (chip_smoke, cli, engine_mod):
        monkeypatch.setattr(module, "get_config", tiny)
    counts = {name: (family, sum(p.numel() for p in chip_smoke.build_model(
        tiny(name)).parameters()))
        for name, (family, _) in chip_smoke.P13_MODELS.items()}
    monkeypatch.setattr(chip_smoke, "P13_MODELS", counts)
    monkeypatch.setattr(chip_smoke, "P13_SIZE", 32)
    monkeypatch.setattr(chip_smoke, "P13_BATCH", 2)


def test_phase_13_rehearses_on_the_cpu(monkeypatch):
    """Phase 13 end to end on the CPU with the tiny models at 32 px: the
    trainings through both entry points and their checkpoints, both
    predict steps, decode and PCKh card against CPU (the CPU against
    itself), both evaluate.py workers, serving; the f64 step check stood
    in for (it needs the card; test_p13_steps_run_in_f64_and_f32 runs its
    steps)."""
    _card_on_the_cpu(monkeypatch, pinned=TINY_P13)
    _tiny_p13(monkeypatch)
    steps = []
    monkeypatch.setattr(chip_smoke, "check_step_against_f64",
                        lambda cfg, model, batch, name, what, make_step,
                        cpu_f32, ref: steps.append((name, len(batch))) or {})
    out = chip_smoke.check_centernet_and_pose()
    assert steps == [("13a centernet", 4), ("13b hourglass104", 4)]
    for name in ("centernet", "hourglass104"):
        rec = out[name]
        assert len(rec["losses"]) == 2 and rec["predict"]["forward_ms"] > 0
        assert set(rec["serve"]["batch_ms"]) == {1, 8}
        assert rec["serve"]["cpu_err"] == 0.0
    assert out["centernet"]["predict"]["decode_ms"] > 0
    assert (chip_smoke.flash_attention.launches,
            chip_smoke.best_iou.launches) == (0, 0)


def test_a_kernel_launch_fails_phase_13(monkeypatch):
    def launch(name, tag, cpu_side=None):
        chip_smoke.best_iou.launches += 1
        return {"trainer": None}

    monkeypatch.setattr(chip_smoke, "check_p13_training", launch)
    monkeypatch.setattr(chip_smoke, "check_centernet_predict",
                        lambda trainer: {})
    monkeypatch.setattr(chip_smoke, "check_pose_predict", lambda trainer: {})
    monkeypatch.setattr(chip_smoke, "check_p13_serving",
                        lambda name, cpu_engine=None: {})
    monkeypatch.setattr(chip_smoke, "p13_cpu_side", lambda: {
        name: {"cpu_engine": None} for name in chip_smoke.P13_MODELS})
    monkeypatch.setattr(chip_smoke, "start_p13_evaluations", lambda: {})
    monkeypatch.setattr(chip_smoke, "finish_p13_evaluations",
                        lambda run: {})
    with pytest.raises(AssertionError, match="a kernel ran"):
        chip_smoke.check_centernet_and_pose()


@pytest.mark.parametrize("name", ["centernet", "hourglass104"])
def test_p13_steps_run_in_f64_and_f32(monkeypatch, name):
    """The steps phase 13 holds card against CPU with, on the CPU: the f64
    step renders f64 targets and computes an f64 loss, and the f32 step
    lies within the f32 bounds of it."""
    torch = chip_smoke.torch
    _tiny_p13(monkeypatch)
    cfg = chip_smoke.get_config(name).replace(dtype="float32")
    cfg = cfg.replace(data=chip_smoke.dataclasses.replace(cfg.data,
                                                          image_size=32))
    trainer_cls = {"centernet": chip_smoke.CenterNetTrainer,
                   "hourglass104": chip_smoke.PoseTrainer}[name]
    model = chip_smoke.build_model(cfg)
    batch = trainer_cls._calibration_batch(
        type("T", (), {"config": cfg})(), (32, 32, 3), 2)
    make_step = chip_smoke.p13_step_factory(name, cfg)
    cpu = torch.device("cpu")
    loss64, grads64 = chip_smoke.train_step_grads(cfg, model, batch, cpu,
                                                  torch.float64, make_step)
    loss32, grads32 = chip_smoke.train_step_grads(cfg, model, batch, cpu,
                                                  make_step=make_step)
    assert all(g.dtype == torch.float64 for g in grads64.values())
    assert abs(loss32 - loss64) <= chip_smoke.ZOO_LOSS_RTOL * abs(loss64)
    assert chip_smoke.grad_rel(grads32, grads64)[0] <= chip_smoke.ZOO_GRAD_RTOL


def test_coarse_heads_tie_everywhere_and_leave_zero_picks():
    """Image 0 is one plateau (its picks the first cells, in index order),
    image 1 has one peak a class (fewer than the picks: zero scores)."""
    heads = chip_smoke.coarse_heads(3, 8, 4, seed=0)
    boxes, scores, classes = chip_smoke.cn_ops.decode(heads,
                                                      max_detections=10)
    assert classes[0].tolist() == [0, 1, 2, 3] * 2 + [0, 1]
    assert (scores[0] == scores[0, 0]).all()
    assert (scores[1, :4] > 0).all() and (scores[1, 4:] == 0).all()
    assert classes[1, :4].tolist() == [3, 2, 1, 0]
