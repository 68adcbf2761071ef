"""The port's IR audit (deepvision_tpu_torch/check) held to the JAX
package's (deepvision_tpu/check, jaxvet): the FLOPs of every unit against
the JAX audit run live here (through the `jax.extend.core` shim of
test_torch_quant.py) and against the committed CHECK_COST.json, the
committed CHECK_COST_TORCH.json's coverage, the clean tree's silence, the
SERVE rule, the CLI's contract, and kernel K2 as the operator
`deepvision::best_iou`, one node in a traced yolov3 train step.

The one FLOPs row that differs is named: `attn/vit_tiny/fused`. The JAX
audit weights each dot of the Pallas kernel's body by its grid, so its
fused row counts the TPU tiles' padding (N 197 -> 256 keys, D 64 -> 128
lanes); the port counts K1 by its math, 4·B·H·N²·D, so its fused row is
JAX's naive row.
"""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX audit's targets run live, each a small config of one family or
# one of the pseudo-targets
LIVE = ("lenet5", "vit_tiny", "yolov3_digits", "centernet_digits",
        "unet_synthetic", "dcgan", "attn", "quant")
JAX_FUSED, JAX_NAIVE = 8_914_237_440, 6_646_781_952
# vit_tiny at 112 px: B 8, H 3, 4 layers; K1's tiles pad N 197 -> 256 and
# D 64 -> 128, and each layer's two products are charged on the tiles
PADDING = 4 * 2 * 2 * 8 * 3 * (256 * 256 * 128 - 197 * 197 * 64)
# rows whose FLOPs differ from CHECK_COST.json's, with JAX's figure
NAMED = {"attn/vit_tiny/fused": JAX_FUSED}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _drop_jax_check():
    for k in [k for k in sys.modules
              if k == "deepvision_tpu.check"
              or k.startswith("deepvision_tpu.check.")]:
        del sys.modules[k]


@pytest.fixture(scope="module")
def jax_cost():
    """The JAX audit's cost rows of the LIVE targets, traced here."""
    from test_torch_quant import jax_quant_modules
    torch.set_num_threads(1)
    rows = {}
    with jax_quant_modules():
        _drop_jax_check()
        try:
            from deepvision_tpu.check.cli import audit
            for target in LIVE:
                _, report = audit([target], select=["COST"])
                rows[target] = report["cost"]
        finally:
            _drop_jax_check()
    return rows


@pytest.fixture(scope="module")
def port_audit():
    """The port's audit of the LIVE targets: (findings, report)."""
    from deepvision_tpu_torch.check import audit
    torch.set_num_threads(1)
    return audit(list(LIVE))


def _target_rows(cost: dict, target: str) -> dict:
    prefix = {"attn": "attn/", "quant": "quant/"}.get(target, target + "/")
    return {k: v for k, v in cost.items() if k.startswith(prefix)}


@pytest.mark.parametrize("target", LIVE)
def test_flops_equal_the_live_jax_audit(target, jax_cost, port_audit):
    _, report = port_audit
    port = _target_rows(report["cost"], target)
    jax_rows = jax_cost[target]
    assert set(port) == set(jax_rows)
    for name, row in port.items():
        want = jax_rows[name]["flops"]
        if name == "attn/vit_tiny/fused":
            # the Pallas grid's padding, not work: the port's fused row is
            # the naive lowering's
            assert (want, row["flops"]) == (JAX_FUSED, JAX_NAIVE)
            assert want - row["flops"] == PADDING
            assert jax_rows["attn/vit_tiny/naive"]["flops"] == row["flops"]
        else:
            assert row["flops"] == want, name


def test_the_live_targets_audit_clean(port_audit):
    findings, report = port_audit
    assert findings == [], [f.format() for f in findings]
    assert report["skipped"] == {}


def _baseline(name):
    with open(os.path.join(REPO, name)) as fp:
        return json.load(fp)


def _port_cost_units():
    from deepvision_tpu_torch.check import harness
    units = [u for name in harness.config_names()
             for u in harness.config_unit_names(name)
             if not u.endswith("/predict")]
    return set(units + harness.epoch_unit_names()
               + harness.quant_unit_names() + harness.attn_unit_names())


def test_baseline_covers_exactly_the_port_units():
    data = _baseline("CHECK_COST_TORCH.json")
    from deepvision_tpu_torch.check.harness import AUDIT_BATCH
    assert data["audit_batch"] == AUDIT_BATCH
    assert set(data["units"]) == _port_cost_units()
    assert len(data["units"]) == 95
    for row in data["units"].values():
        assert {"flops", "bytes", "eqns"} <= set(row)


def test_baseline_flops_equal_check_cost_row_for_row():
    port = _baseline("CHECK_COST_TORCH.json")["units"]
    jax_units = _baseline("CHECK_COST.json")["units"]
    for name, row in port.items():
        want = NAMED.get(name, row["flops"])
        assert jax_units[name]["flops"] == want, name
        if "param_bytes" in row:
            assert row["param_bytes"] == jax_units[name]["param_bytes"], name
    assert port["attn/vit_tiny/fused"]["flops"] == \
        jax_units["attn/vit_tiny/naive"]["flops"] == JAX_NAIVE
    # JAX's rows the port has none of: the mesh half and the config the
    # port refuses by name (ROADMAP A6)
    assert set(jax_units) - set(port) == {
        "mesh_serve/lenet5", "mesh_serve/resnet50", "mesh_serve/vit_tiny",
        "unet_synthetic_sp2/train", "unet_synthetic_sp2/eval",
        "unet_synthetic_sp2/serve"}


def test_registry_hygiene_every_config_has_units():
    from deepvision_tpu_torch.check import harness
    from deepvision_tpu_torch.configs import (NOT_PORTED, get_config,
                                              trainer_class_for_config)
    names = harness.config_names()
    assert len(names) == 30 and not set(names) & set(NOT_PORTED)
    for name in names:
        cfg = get_config(name)
        assert cfg.family in harness._FAMILY_BUILDERS, name
        assert (trainer_class_for_config(name) is None) == \
            (cfg.family == "gan")
        units = harness.config_unit_names(name)
        assert units and all(u.startswith(name + "/") for u in units)
    assert sum(len(harness.config_unit_names(n)) for n in names) == 96


def test_serve_rule_catches_bucket_drift():
    from deepvision_tpu_torch.check.harness import TracedUnit
    from deepvision_tpu_torch.check.rules import check_serve

    unit = TracedUnit("x/serve", "x", "predict", serve={
        "buckets": (1, 8, 32), "max_batch": 16,
        "example_shape": (32, 32, 1), "probe_outs": {1: []}})
    assert any("max_batch 16" in f.message for f in check_serve(unit))
    unit.serve["max_batch"] = 32
    unit.serve["buckets"] = (8, 32)   # no batch-of-1 bucket
    assert any("batch-of-1" in f.message for f in check_serve(unit))
    unit.serve["buckets"] = (1, 8, 32)
    unit.serve["probe_outs"] = {1: [((2, 10), torch.float32)]}
    assert any("batch dim" in f.message for f in check_serve(unit))


def test_serve_units_take_the_engines_default_buckets():
    from deepvision_tpu_torch.check.harness import engine_buckets
    assert engine_buckets() == ((1, 8, 32), 32)


@pytest.mark.parametrize("argv,named", [
    (["definitely_not_a_config"], "unknown config"),
    (["--select", "BOGUS"], "unknown check"),
    (["--update-cost", "lenet5"], "--update-cost"),
    (["--select", "DONATE"], "mesh half"),
    (["--select", "COLL"], "mesh half"),
    (["mesh"], "mesh half"),
    (["spatial"], "mesh half"),
    (["unet_synthetic_sp2"], "spatial_parallel=2"),
    (["--format", "yaml"], ""),
])
def test_cli_usage_errors(argv, named, capsys):
    from deepvision_tpu_torch.check.cli import main
    assert main(argv) == 2
    assert named in capsys.readouterr().err


def test_cli_clean_json(capsys):
    from deepvision_tpu_torch.check.cli import main

    rc = main(["lenet5_digits", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["findings"] == []
    assert out["units"] == ["lenet5_digits/train", "lenet5_digits/eval",
                            "lenet5_digits/serve"]
    assert set(out["cost"]) == set(out["units"])
    assert {"flops", "bytes", "eqns"} <= set(
        out["cost"]["lenet5_digits/train"])
    assert "param_bytes" in out["cost"]["lenet5_digits/serve"]
    assert out["summary"]["units"] == 3
    assert out["summary"]["findings"] == 0


def test_cli_github_and_text_formats(capsys):
    from deepvision_tpu_torch.check.cli import main
    assert main(["lenet5", "--format", "github", "--select", "DTYPE"]) == 0
    assert "audit: clean (3 units)" in capsys.readouterr().out
    assert main(["lenet5", "--select", "TRACE"]) == 0
    assert "audit: clean (3 units, 0 skipped)" in capsys.readouterr().out


def test_a_yolov3_train_step_holds_one_best_iou_node():
    """K2 in the graph it runs in: the traced yolov3_digits train step
    holds exactly one `deepvision.best_iou` node (the loss's three scales
    in one call), charged K2's bound bytes and no FLOPs."""
    from deepvision_tpu_torch.check import harness
    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.ops.yolo import MAX_BOXES

    cfg = get_config("yolov3_digits")
    with harness.fake_tensors():
        units = harness._detection_units("yolov3_digits", cfg)
    train, evaluate = units[0], units[1]
    assert train.trace.count("deepvision.best_iou") == 1
    assert evaluate.trace.count("deepvision.best_iou") == 1
    (k2,) = [op for op in train.trace.heavy if op.kind == "best_iou"]
    assert k2.flops == 0
    assert train.trace.count("deepvision.flash_attention") == 0
    # its node alone: the bound's bytes, each box read once, each best
    # IoU written once, over the three scales at 128 px (grids 16, 8, 4)
    from deepvision_tpu_torch.ops.best_iou import best_iou
    b, ns = harness.AUDIT_BATCH, [3 * g * g for g in (16, 8, 4)]
    with harness.fake_tensors():
        preds = [torch.empty((b, n, 4)) for n in ns]
        gt = torch.empty((b, MAX_BOXES, 4))
        trace, _ = harness.record(best_iou, preds, gt)
    n = sum(ns)
    assert trace.count("deepvision.best_iou") == 1
    assert trace.bytes == b * n * 16 + b * MAX_BOXES * 16 + b * n * 4


def test_best_iou_operator_cpu_is_the_reference_bit_for_bit():
    from deepvision_tpu_torch.ops.best_iou import (best_iou, best_iou_op,
                                                   best_iou_reference)
    gen = torch.Generator().manual_seed(3)

    def boxes(b, n):
        xy = torch.rand((b, n, 2), generator=gen)
        wh = torch.rand((b, n, 2), generator=gen) * 0.5
        return torch.cat([xy, xy + wh], dim=-1)

    preds, gt = [boxes(2, 700), boxes(2, 40), boxes(2, 9)], boxes(2, 7)
    gt[:, 5:] = 0.0                                   # padded GT rows
    got = best_iou_op(preds, gt)
    want = best_iou_reference(preds, gt)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert torch.equal(best_iou(preds[0], gt), want[0])
    assert torch.equal(best_iou(preds[0].double(), gt.double()), want[0])
    assert torch.ops.deepvision.best_iou.default is not None
    # the wrapper detaches: the operator never sees a tensor needing grad
    leaf = preds[1].clone().requires_grad_(True)
    assert not best_iou(leaf, gt).requires_grad


def test_best_iou_operator_refuses_what_the_kernel_would():
    from deepvision_tpu_torch.ops.best_iou import best_iou
    with pytest.raises(ValueError):
        best_iou(torch.zeros((2, 5, 3)), torch.zeros((2, 4, 4)))
    with pytest.raises(TypeError):
        best_iou(torch.zeros((2, 5, 4), dtype=torch.int32),
                 torch.zeros((2, 4, 4)))
    with pytest.raises(ValueError):
        best_iou(torch.zeros((3, 5, 4)), torch.zeros((2, 4, 4)))


def test_k1_is_one_node_a_layer_charged_its_math():
    from deepvision_tpu_torch.check import harness
    with harness.fake_tensors():
        unit = harness._attn_unit("fused")
    depth = 4
    assert unit.trace.count("deepvision.flash_attention") == depth
    k1 = [op for op in unit.trace.heavy if op.kind == "flash_attention"]
    b, h, n, d = harness.AUDIT_BATCH, 3, 197, 64
    assert [op.flops for op in k1] == [4 * b * h * n * n * d] * depth


def test_int8_products_are_counted_by_their_math():
    """`_int_mm` on ops/quant.py's zero-padded operands is charged its
    unpadded shapes, and a depthwise int8 conv's int32 tap sum is one
    product of 2·|out|·kh·kw."""
    from deepvision_tpu_torch.check import harness
    from deepvision_tpu_torch.ops import quant

    with harness.fake_tensors():
        x = torch.empty((2, 6, 9, 9), dtype=torch.int8)
        w = torch.empty((5, 6, 3, 3), dtype=torch.int8)
        dw = torch.empty((6, 1, 3, 3), dtype=torch.int8)
        trace, out = harness.record(
            lambda: (quant.int8_conv2d(x, w, 1, 1),
                     quant.int8_conv2d(x, dw, 2, 1, groups=6)))
    mm, dwc = trace.products()
    assert (mm.kind, mm.out_dtype) == ("int_mm", torch.int32)
    assert mm.flops == 2 * (2 * 9 * 9) * 5 * (6 * 9)
    assert dwc.kind == "depthwise" and dwc.out_dtype == torch.int32
    assert tuple(out[1].shape) == (2, 6, 5, 5)
    assert dwc.flops == 2 * (2 * 6 * 5 * 5) * 9
    assert trace.flops == mm.flops + dwc.flops


def test_every_factory_declares_its_claim():
    """The claim side: each step factory annotates its step with its
    compute dtype and kind (core/steps.py::annotate_step)."""
    from deepvision_tpu_torch.core import (centernet, detection, gan, pose,
                                           segment, steps)
    bf16 = torch.bfloat16
    built = {
        "train": [steps.make_classification_train_step(compute_dtype=bf16),
                  detection.make_yolo_train_step(num_classes=2,
                                                 grid_sizes=(4,)),
                  centernet.make_centernet_train_step(num_classes=2, grid=4),
                  pose.make_pose_train_step(heatmap_size=(4, 4)),
                  segment.make_segmentation_train_step(),
                  gan.make_dcgan_train_step(8),
                  gan.make_cyclegan_generator_step(),
                  gan.make_cyclegan_discriminator_step()],
        "eval": [steps.make_classification_eval_step(),
                 detection.make_yolo_eval_step(num_classes=2,
                                               grid_sizes=(4,)),
                 centernet.make_centernet_eval_step(num_classes=2, grid=4),
                 pose.make_pose_eval_step(heatmap_size=(4, 4)),
                 segment.make_segmentation_eval_step(num_classes=2)],
        "predict": [detection.make_predict_step(),
                    centernet.make_centernet_predict_step(),
                    segment.make_segmentation_predict_step()]}
    for kind, fns in built.items():
        for fn in fns:
            assert fn.audit_claim["kind"] == kind
            assert fn.audit_claim["compute_dtype"] in (torch.bfloat16,
                                                       torch.float32)
    inner = steps.make_classification_train_step(compute_dtype=torch.float32)
    for wrapped in (steps.make_multistep_train_step(inner, 2),
                    steps.make_epoch_train_step(inner)):
        assert wrapped.audit_claim == {"compute_dtype": torch.float32,
                                       "kind": "train"}
