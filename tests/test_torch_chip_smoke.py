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
