"""chip_smoke.py's tensor-core gate, on listings shaped like `cuobjdump
-sass` of the attention library: it passes only when every bf16 kernel
(DMAX 64 and 128, 16-byte and scalar copies) is listed once with HMMA."""

import os
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
