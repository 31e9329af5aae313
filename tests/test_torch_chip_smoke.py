"""chip_smoke.py's planted faults and the bf16 kernels, read as source.

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
    name, source, _, _, check = fault
    text = (CSRC / source).read_text()
    for old, new in chip_smoke.fault_edits(fault):
        assert text.count(old) == 1, f"{name!r}: its text occurs {text.count(old)} times in {source}"
        assert new != old
    assert check
    assert source in chip_smoke.FAULT_CHECKS


def _kernel_body(kernel: str) -> str:
    text = (CSRC / "flash_attention.cu").read_text()
    start = text.index(f"{kernel}(const FlashParams p) {{")
    return text[start:text.index("\n}\n", start)]


def _fwd_kernel_body() -> str:
    return _kernel_body("flash_fwd_wgmma_kernel")


def test_bf16_forward_issues_wgmma_for_both_products_and_no_wmma():
    body = _fwd_kernel_body()
    assert "wgmma_ss_qk<N>(s, q_desc" in body, "S = Q.K^T through wgmma"
    assert "wgmma_rs_pv<D>(o, a," in body, "O += P.V through wgmma, P from registers"
    for absent in ("wmma::", "strip_abt", "strip_pv", "sO[", "sS[", "sP["):
        assert absent not in body, absent


def test_bf16_forward_fills_a_two_stage_ring_with_cp_async():
    text = (CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int kStages = [2-9];", text)
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in text
    body = _fwd_kernel_body()
    assert "load_stage((it + kStages - 1) % kStages, fetch);" in body
    assert "cp_async_wait_for_wgmma<kStages - 2>();" in body
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


# The backward kernels' products, each through wgmma: (kernel, the text
# that issues each product).
BWD_PRODUCTS = {
    "flash_bwd_dkv_wgmma_kernel": (
        "wgmma_ss_qk<BQ>(sT, k_desc",  # S^T = K.Q^T
        "wgmma_ss_qk<BQ>(dpT, v_desc",  # dP^T = V.dO^T
        "wgmma_rs_pv<D>(dv, a,",  # dV += P^T.dO, P^T from registers
        "wgmma_rs_pv<D>(dk, b,",  # dK += dS^T.Q, dS^T from registers
    ),
    "flash_bwd_dq_wgmma_kernel": (
        "wgmma_ss_qk<N>(s, q_desc",  # S = Q.K^T
        "wgmma_ss_qk<N>(dp, do_desc",  # dP = dO.V^T
        "wgmma_rs_pv<D>(dq, a,",  # dQ += dS.K, dS from registers
    ),
}


@pytest.mark.parametrize("kernel", sorted(BWD_PRODUCTS))
def test_bf16_backward_issues_wgmma_for_every_product_and_no_wmma(kernel):
    body = _kernel_body(kernel)
    for product in BWD_PRODUCTS[kernel]:
        assert body.count(product) == 1, product
    assert body.count("wgmma_ss_qk<") == 2 and body.count("wgmma_rs_pv<") == len(BWD_PRODUCTS[kernel]) - 2
    text = (CSRC / "flash_attention.cu").read_text()
    for absent in ("wmma::", "<mma.h>"):
        assert absent not in text, absent
    for absent in ("strip_abt", "strip_pv", "load_tile"):
        assert absent not in body, absent


@pytest.mark.parametrize("kernel", sorted(BWD_PRODUCTS))
def test_bf16_backward_fills_a_two_stage_ring_with_cp_async(kernel):
    body = _kernel_body(kernel)
    assert body.count("load_rows_async<") >= 4, "own tiles once, the streamed tiles per stage"
    assert "cp_async_4(" in body, "positions (and lse, delta) through cp.async"
    assert "load_stage((it + kStages - 1) % kStages, fetch);" in body
    assert "cp_async_wait_for_wgmma<kStages - 2>();" in body
    assert "cp_async_wait_for_wgmma<0>();" in body, "no copy outlives the block"
    assert body.count("__syncthreads()") == 1, "one barrier per streamed tile"


@pytest.mark.parametrize("kernel", sorted(BWD_PRODUCTS))
def test_bf16_backward_pins_its_registers_before_each_wgmma_fence(kernel):
    body = _kernel_body(kernel)
    fences = [m.start() for m in re.finditer(r"wgmma_fence\(\);", body)]
    assert len(fences) == 2, "one fence for the first products, one for the second"
    first, second = (body[body.rindex("\n\n", 0, f):f] for f in fences)
    if kernel == "flash_bwd_dkv_wgmma_kernel":
        pinned = (("sT", "dpT"), ("dv", "dk", "pT", "dsT"))
    else:
        pinned = (("s", "dp"), ("dq", "ds"))
    for before, names in zip((first, second), pinned):
        for name in names:
            assert f"fence_regs({name});" in before, name


def test_resources_kernel_codes_match_the_source_and_cover_every_kernel():
    # flash_resources passes a kernel's code to tpuft_flash_resources; a
    # code that named another kernel would check the wrong instance's
    # registers and spills.
    from torchft_tpu_torch.ops import flash_attention as fa

    src = (CSRC / "flash_attention.cu").read_text()
    codes = {
        name: int(re.search(rf"constexpr int {const} = (\d+);", src).group(1))
        for name, const in (
            ("flash_fwd", "kFwd"),
            ("flash_bwd_dq", "kDq"),
            ("flash_bwd_dkv", "kDkv"),
        )
    }
    assert fa._KERNEL_CODE == codes
    assert set(fa._KERNEL_CODE) == set(fa.launches)
