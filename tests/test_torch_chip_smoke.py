"""chip_smoke.py's planted faults and the bf16 forward kernel, read as source.

The planted-faults phase runs only on the card: it edits one text in a
kernel source per fault, rebuilds, and expects a named check to reject the
copy. A kernel rewrite that removes or duplicates a fault's text would only
show there, after a chip run. These checks read the sources on the CPU.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

import chip_smoke

CSRC = Path(__file__).resolve().parent.parent / "torchft_tpu_torch" / "csrc"


@pytest.mark.parametrize("fault", chip_smoke.PLANTED_FAULTS, ids=lambda f: f[0])
def test_planted_fault_text_occurs_once_in_its_source(fault):
    name, source, old, new, check = fault
    text = (CSRC / source).read_text()
    assert text.count(old) == 1, f"{name!r}: its text occurs {text.count(old)} times in {source}"
    assert new != old and check
    assert source in chip_smoke.FAULT_CHECKS


def _fwd_kernel_body() -> str:
    text = (CSRC / "flash_attention.cu").read_text()
    start = text.index("flash_fwd_wgmma_kernel(const FlashParams p) {")
    return text[start:text.index("\n}\n", start)]


def test_bf16_forward_issues_wgmma_for_both_products_and_no_wmma():
    body = _fwd_kernel_body()
    assert "wgmma_ss_qk<N>(s, q_desc" in body, "S = Q.K^T through wgmma"
    assert "wgmma_rs_pv<D>(o, a," in body, "O += P.V through wgmma, P from registers"
    for absent in ("wmma::", "strip_abt", "strip_pv", "sO[", "sS[", "sP["):
        assert absent not in body, absent


def test_bf16_forward_fills_a_two_stage_ring_with_cp_async():
    text = (CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int kFwdStages = [2-9];", text)
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in text
    body = _fwd_kernel_body()
    assert "load_stage((it + kFwdStages - 1) % kFwdStages, fetch);" in body
    assert "cp_async_wait_for_wgmma<kFwdStages - 2>();" in body
    assert body.count("__syncthreads()") == 1, "one barrier per KV tile"


def test_bf16_forward_pins_its_registers_before_each_wgmma_fence():
    # Register writes the compiler could sink past wgmma.fence would land
    # while an mma_async reads or writes them, which PTX leaves undefined.
    body = _fwd_kernel_body()
    fences = [m.start() for m in re.finditer(r"wgmma_fence\(\);", body)]
    assert len(fences) == 2, "one fence for Q.K^T, one for P.V"
    qk, pv = (body[body.rindex("\n\n", 0, f):f] for f in fences)
    assert "fence_regs(s);" in qk
    assert "fence_regs(o);" in pv and "fence_regs(pr);" in pv
