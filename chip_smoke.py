#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (torchft_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels (nvcc, into
build/torch_kernels/) and the native coordination plane (g++, into
build/torch_native/) from the sources in the checkout, all at once.
Phases, each printing one JSON line:

1. device: the card's name and power limit, torch and CUDA versions; an
   sm_90 card is required.
2. build: each build's time and the kernels' register/spill summary.
3. kernel_checks, kernels: the flash kernels (B3-B5) against their plain
   PyTorch versions on the card, at the train step's shapes (b=4, s=2048,
   8 query heads of 128 over 4 KV heads, bf16), on a ragged partial with
   permuted positions, on a fully masked hop, and in f32 on a small case;
   then their times beside the plain version, the card's bound and, as a
   yardstick the port never calls, scaled_dot_product_attention.
4. codec_checks, codec: the blockwise codec kernels (B1 quantize, B2
   dequantize) byte for byte against their plain versions, fp8 and int8,
   at the FT-DDP path's bucket shapes (16 MiB of bf16 gradients as f32,
   and the largest single-leaf bucket, the 32768 x 1024 embedding), on a
   ragged size, on zero, subnormal and half-way rows, and on rows holding
   NaN and +-inf; the same bytes again against the host codec on the CPU,
   which the wire's reduce runs; then their times, bounds and plain times.
5. train: the flagship Llama (large_bench_config, 24 layers at full
   width, remat "none") takes 5 steps of make_fused_step with SGD
   momentum 0.9 at batch 4 x 2048 from seeded random weights; launch
   counts are read around exactly this run. Then a 2-layer copy of the
   same widths takes 2 steps with the kernels and 2 with dense attention,
   and their losses must agree.
6. profile: 2 more steps of the flagship model under torch.profiler, for
   device time by kernel group and the device's busy share.
7. ft_ddp: two replica groups, each a process of its own on the one card,
   build the flagship model from seed 0 and take FT_STEPS steps of
   Optimizer.make_step_fn(loss_fn, should_quantize=True) under their own
   Managers (init_sync=False, ProcessGroupNative, 16 MiB buckets), with
   different batches; this process runs the lighthouse. Every step must
   commit, kernels B1 and B2 must launch once per bucket per step, the
   flash kernels once per layer per step, and the groups' parameter
   digests must be equal at the end. The averaged gradient of step 0 must
   lie within two fp8 steps of the mean of both groups' plain gradients,
   on leaves from both buckets' dtypes. The groups share the card, so
   their step time over the train phase's is printed as such, not as the
   fault-tolerance overhead.
8. planted_faults: copies of the kernels with known faults (a skipped GQA
   head, a skipped KV or query tile, a max that drops NaN, ...), built and
   checked in parallel; the run fails unless the checks reject every one.

Then the kernels line, the card's nvidia-smi line and, last, the result.
Any failure raises and exits non-zero; without a CUDA device it exits
non-zero before printing a result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Tol:
    """A kernel's output against its plain version's: element by element
    ``|got - want| <= rtol * |want| + floor * rms``, where rms is the larger
    of the row's and the whole tensor's RMS of want, and
    ``||got - want|| <= norm * ||want||`` over the whole tensor."""

    rtol: float
    floor: float
    norm: float


# Both versions round p and ds to bf16 at the same points and sum in f32
# in other orders, then round the output to its type once: rtol 2^-6 is
# two bf16 ulps of the output (an ulp is at most 2^-7 of the value). The
# forward also rounds p under a running rather than the final row max, so
# each p's rounding differs (up to 2^-9 of it) and an output entry near 0
# is off by up to a few 2^-9 of its row's scale: the floor is 2% of the
# RMS. The error's norm stays under 1% of the output's.
BF16 = Tol(rtol=2.0**-6, floor=2e-2, norm=1e-2)
# f32 throughout: summation order alone.
F32 = Tol(rtol=1e-5, floor=1e-4, norm=1e-5)
# lse is f32 in both, from the same f32 scores.
LSE_ATOL = 1e-4
# Flash against dense attention through a 2-layer model, bf16: the two
# paths round at different points; the loss is a mean over 8192 tokens.
# About 10x the difference measured on the card.
LOSS_ATOL = 1e-3

TRAIN_STEPS = 5
PROFILE_STEPS = 2
BATCH = 4
# FT-DDP: the first step carries the groups' warm-up; 3 more are steady.
FT_STEPS = 4
FT_GROUPS = 2
FT_TIMEOUT_S = 600

# Known faults for the planted_faults phase: (name, source in csrc/, text
# in it, its replacement, the check that must reject it). Flash tile 16
# covers keys or queries 1024-1087, so only the later rows lose a small
# share of their terms.
PLANTED_FAULTS = (
    ("fwd drops the P.V of KV tile 16", "flash_attention.cu",
     "    strip_pv<T, kBlockK, D>(sP + r0 * L::LDP,",
     "    if (kt != 16) strip_pv<T, kBlockK, D>(sP + r0 * L::LDP,",
     "flash_fwd out"),
    ("dq drops the dS.K of KV tile 16", "flash_attention.cu",
     "    strip_pv<T, kBlockK, D>(sDS + r0 * L::LDP,",
     "    if (kt != 16) strip_pv<T, kBlockK, D>(sDS + r0 * L::LDP,",
     "flash_bwd_dq"),
    ("dk/dv skip the last query head of each GQA group", "flash_attention.cu",
     "for (int g = 0; g < group; ++g) {",
     "for (int g = 0; g < group - 1; ++g) {",
     "flash_bwd_dkv"),
    ("dk/dv skip query tile 16", "flash_attention.cu",
     "if (qmax < kmin) continue;",
     "if (qmax < kmin || qt == 16) continue;",
     "flash_bwd_dkv"),
    ("quantize's max drops a NaN (fmaxf)", "quantization.cu",
     "return (a > b || a != a) ? a : b;  // a NaN on either side wins",
     "return fmaxf(a, b);",
     "quantize_blocks fp8 nonfinite"),  # only a row holding NaN shows it
    ("quantize's max skips the last lane of a row", "quantization.cu",
     "#pragma unroll\n  for (int offset = 16;",
     "if (lane == 31) m = 0.0f;\n#pragma unroll\n  for (int offset = 16;",
     "quantize_blocks fp8"),
    ("int8 rounds half away from zero", "quantization.cu",
     "float r = rintf(v);",
     "float r = roundf(v);",
     "quantize_blocks int8"),
    ("a NaN quotient takes the sign CUDA's division gives it", "quantization.cu",
     "if (v != v) return (x == x || signbit(x)) ? 0xFF : 0x7F;",
     "if (v != v) return signbit(v) ? 0xFF : 0x7F;",
     "quantize_blocks fp8 nonfinite"),
    ("dequantize leaves each row's last element unscaled", "quantization.cu",
     "  r.w *= scale;",
     "  if (quad % 64 != 63) r.w *= scale;",
     "dequantize_blocks fp8"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of fn over iters calls, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, got, want, tol: Tol) -> dict:
    """Holds got to want within tol; raises naming the check if not. The
    RMS of the floor is the larger of the row's (the last axis: one head's
    vector) and the whole tensor's, since a row's intermediate roundings
    scale with that row."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = torch.maximum(want.square().mean(-1, keepdim=True).sqrt(),
                        want.square().mean().sqrt())
    ratio = err / (tol.rtol * want.abs() + tol.floor * rms)
    at = ratio.argmax().item()
    rel_norm = (err.norm() / want.norm()).item()
    result = {"max_abs_err": err.max().item(), "rel_norm_err": rel_norm,
              "worst_over_tol": ratio.flatten()[at].item()}
    if not (result["worst_over_tol"] <= 1.0 and rel_norm <= tol.norm):
        index = list(torch.unravel_index(torch.tensor(at), want.shape))
        raise AssertionError(
            f"{name}: {result} against {tol}; worst at {[int(i) for i in index]}: "
            f"got {got.flatten()[at].item()}, want {want.flatten()[at].item()}"
        )
    return result


def check_abs(name: str, got, want, atol: float) -> dict:
    err = (got.float() - want.float()).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{name}: max abs error {err} > {atol}")
    return {"max_abs_err": err}


def causal_pairs(q_positions, k_positions) -> int:
    """Unmasked (query, key) pairs summed over the batch: the work these
    inputs need, counted from their positions."""
    import torch

    keys = torch.sort(k_positions, dim=1).values
    return int(torch.searchsorted(keys, q_positions, right=True).sum().item())


def bound_ms(nbytes: int, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def phase_device():
    import torch

    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit({
        "phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "capability": list(cap),
        "count": torch.cuda.device_count(),
    })
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs an sm_90 (Hopper) card, found sm_{cap[0]}{cap[1]}")
    return smi


def phase_build():
    """Builds every kernel library and the native plane at once (one
    compiler process each, started together) and reports each build."""
    from torchft_tpu_torch import _build, _native
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quantization as q

    builds = {"flash_attention": fa._library, "quantization": q._library,
              "native": _native.load}
    errors = {}

    def run(name, fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — raised below, on this thread
            errors[name] = e

    start = time.perf_counter()
    threads = [threading.Thread(target=run, args=item) for item in builds.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"build failed: {errors or 'a build did not finish'}")
    report = {"phase": "build", "seconds": time.perf_counter() - start,
              "native_seconds": _native.build_log.get("seconds")}
    for name in ("flash_attention", "quantization"):
        log = _build.build_log.get(name, {})
        ptxas = log.get("ptxas", "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", ptxas)]
        report[name] = {
            "nvcc_seconds": log.get("seconds"), "kernel_instances": len(regs),
            "max_registers": max(regs, default=None), "spill_store_bytes": sum(spills),
        }
    emit(report)


def check_kernels():
    """Each kernel against its plain version. Returns the train step's
    inputs (for timing) and each kernel's max abs error at those shapes."""
    import torch

    from torchft_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(1)
    dev = "cuda"

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    # -- the train step's shapes
    b, s, h, kv, d = BATCH, 2048, 8, 4, 128
    scale = d**-0.5
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, kv, d), randn(b, s, kv, d)
    pos = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s).contiguous()

    out, lse = fa.flash_fwd(q, k, v, pos, pos, scale)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, pos, pos, scale)
    checks = {
        "flash_fwd out": check("flash_fwd out", out, ref_out, BF16),
        "flash_fwd lse": check_abs("flash_fwd lse", lse, ref_lse, LSE_ATOL),
    }
    delta = (do.float() * ref_out.float()).sum(-1)
    bwd = (q, k, v, do, ref_lse, delta, pos, pos, scale, torch.bfloat16)
    dq = fa.flash_bwd_dq(*bwd)
    ref_dq = fa.flash_bwd_dq_reference(*bwd)
    checks["flash_bwd_dq"] = check("flash_bwd_dq", dq, ref_dq, BF16)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(*bwd)
    checks["flash_bwd_dkv dk"] = check("flash_bwd_dkv dk", dk, ref_dk, BF16)
    checks["flash_bwd_dkv dv"] = check("flash_bwd_dkv dv", dv, ref_dv, BF16)
    errs = {
        "flash_fwd": max(checks["flash_fwd out"]["max_abs_err"],
                         checks["flash_fwd lse"]["max_abs_err"]),
        "flash_bwd_dq": checks["flash_bwd_dq"]["max_abs_err"],
        "flash_bwd_dkv": max(checks["flash_bwd_dkv dk"]["max_abs_err"],
                             checks["flash_bwd_dkv dv"]["max_abs_err"]),
    }

    # -- ragged partial: permuted query positions, sq != sk, f32 gradients
    pb, psq, psk = 2, 200, 328
    pq, pdo = randn(pb, psq, h, d), randn(pb, psq, h, d)
    pk, pv = randn(pb, psk, kv, d), randn(pb, psk, kv, d)
    pqp = torch.randperm(psk, device=dev, generator=gen)[:psq].int().expand(pb, psq).contiguous()
    pkp = torch.arange(psk, device=dev, dtype=torch.int32).expand(pb, psk).contiguous()
    po, pl = fa.flash_attention_partial(pq, pk, pv, pqp, pkp)
    rpo, rpl = fa.flash_fwd_reference(pq, pk, pv, pqp, pkp, scale)
    checks["partial out"] = check("partial out", po, rpo, BF16)
    checks["partial lse"] = check_abs("partial lse", pl, rpl, LSE_ATOL)
    pgrads = fa.flash_attention_partial_bwd(pq, pk, pv, pdo, rpo, rpl, pqp, pkp, scale)
    pdelta = (pdo.float() * rpo.float()).sum(-1)
    pargs = (pq, pk, pv, pdo, rpl, pdelta, pqp, pkp, scale, torch.float32)
    rpgrads = (fa.flash_bwd_dq_reference(*pargs), *fa.flash_bwd_dkv_reference(*pargs))
    for name, got, want in zip(("dq", "dk", "dv"), pgrads, rpgrads):
        checks[f"partial {name}"] = check(f"partial {name}", got, want, BF16)
    mo, ml = fa.flash_attention_partial(pq, pk, pv, pqp, pkp + 10_000)
    if mo.abs().max().item() != 0.0 or not bool((ml == -1e30).all()):
        raise AssertionError("fully masked hop: expected out = 0 and lse = -1e30")

    # -- f32 instantiations, small
    fq, fk, fv, fdo = (randn(1, 192, n, 64, dtype=torch.float32) for n in (4, 2, 2, 4))
    fpos = torch.arange(192, device=dev, dtype=torch.int32)[None]
    fo, fl = fa.flash_fwd(fq, fk, fv, fpos, fpos, 0.125)
    rfo, rfl = fa.flash_fwd_reference(fq, fk, fv, fpos, fpos, 0.125)
    checks["f32 out"] = check("f32 out", fo, rfo, F32)
    checks["f32 lse"] = check_abs("f32 lse", fl, rfl, LSE_ATOL)
    fdelta = (fdo * rfo).sum(-1)
    fargs = (fq, fk, fv, fdo, rfl, fdelta, fpos, fpos, 0.125, torch.float32)
    f_got = (fa.flash_bwd_dq(*fargs), *fa.flash_bwd_dkv(*fargs))
    f_want = (fa.flash_bwd_dq_reference(*fargs), *fa.flash_bwd_dkv_reference(*fargs))
    for name, got, want in zip(("dq", "dk", "dv"), f_got, f_want):
        checks[f"f32 {name}"] = check(f"f32 {name}", got, want, F32)

    emit({"phase": "kernel_checks", "bf16": BF16.__dict__, "f32": F32.__dict__,
          "lse_atol": LSE_ATOL, "checks": checks})
    return (q, k, v, do, pos, scale, bwd), errs


def phase_kernels():
    """Checks, times and bounds. Returns the per-kernel entries of the
    kernels line (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    (q, k, v, do, pos, scale, bwd), errs = check_kernels()
    b, s, h, d = q.shape

    ms = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, pos, pos, scale), 20),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(*bwd), 20),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(*bwd), 20),
    }
    plain_ms = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, pos, pos, scale), 5),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_reference(*bwd), 5),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_reference(*bwd), 5),
    }
    # Yardstick only: one PyTorch call for the same function (heads-major,
    # transposed outside the timed region). Its backward computes dq, dk
    # and dv in one call, so it stands beside both backward kernels.
    tq, tk, tv = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    tdo = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(tq, tk, tv, is_causal=True, enable_gqa=True)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(sdpa, 20)
    sdpa_out = sdpa()
    sdpa_bwd = cuda_ms(
        lambda: torch.autograd.grad(sdpa_out, (tq, tk, tv), tdo, retain_graph=True), 20
    )
    sdpa_fwd_bwd = cuda_ms(
        lambda: torch.autograd.grad(sdpa(), (tq, tk, tv), tdo), 20
    )
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}

    # -- bounds from this run's inputs
    pairs = causal_pairs(pos, pos)  # per batch, summed; per query head below
    e = 2  # bf16 bytes
    qkv_bytes = (q.numel() + k.numel() + v.numel()) * e + 2 * pos.numel() * 4
    row_bytes = b * s * h * 4  # one f32 per row and head
    work = {
        "flash_fwd": (qkv_bytes + q.numel() * e + row_bytes, 2 * 2 * d * pairs * h),
        "flash_bwd_dq": (qkv_bytes + do.numel() * e + 2 * row_bytes + q.numel() * e,
                         3 * 2 * d * pairs * h),
        "flash_bwd_dkv": (qkv_bytes + do.numel() * e + 2 * row_bytes + 2 * k.numel() * e,
                          4 * 2 * d * pairs * h),
    }
    replaces = {
        "flash_fwd": "torchft_tpu/ops/flash_attention.py:73",
        "flash_bwd_dq": "torchft_tpu/ops/flash_attention.py:257",
        "flash_bwd_dkv": "torchft_tpu/ops/flash_attention.py:304",
    }
    entries = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        nbytes, flops = work[name]
        bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        entries.append({
            "name": name, "route": "cuda",
            "source": "torchft_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[name], "launches": None,
            "max_abs_err": errs[name], "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms[name],
        })
    emit({
        "phase": "kernels", "shape": {"b": b, "s": s, "h": h, "kv": k.shape[2], "d": d,
                                      "dtype": "bf16"},
        "ms": ms, "plain_ms": plain_ms,
        "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd,
        "tflops": {n: work[n][1] / (ms[n] * 1e-3) / 1e12 for n in ms},
        "bound_ms": {x["name"]: x["bound_ms"] for x in entries},
    })
    return entries


# The codec's cases: the FT-DDP path's bucket shapes and the rows that a
# naive kernel gets wrong. Rows of 256 elements, f32.
FLAGSHIP_BUCKET_ELEMENTS = 16 * 1024 * 1024 // 2  # 16 MiB of bf16 gradients
FLAGSHIP_LARGEST_LEAF = 32768 * 1024  # the embedding, a bucket of its own


def codec_cases():
    """(name, f32 tensor on the card) for the codec checks."""
    import torch

    gen = torch.Generator("cuda").manual_seed(4)

    def randn(n, std=1.0):
        return torch.randn(n, device="cuda", generator=gen) * std

    # Gradients arrive as bf16 and are cast to f32 in the bucket.
    yield "bucket_16MiB", randn(FLAGSHIP_BUCKET_ELEMENTS, 1e-3).bfloat16().float()
    yield "largest_leaf", randn(FLAGSHIP_LARGEST_LEAF, 1e-2).bfloat16().float()
    yield "ragged", randn(1000 * 256 - 37, 3.0)
    rows = randn(6 * 256, 1e-4).reshape(6, 256)
    rows[1] = 0.0
    rows[2] = -0.0
    rows[3] = randn(256, 1e-39)  # f32 subnormals
    rows[4, :128] = 0.0
    yield "zero_and_subnormal", rows.reshape(-1)
    # Rows whose max is 127 or 448 (scale 1.0) put x.5 on the int8 grid and
    # the fp8 midpoints on fp8's.
    ties = torch.arange(-127, 128, device="cuda", dtype=torch.float32) + 0.5
    half_way = torch.stack([
        torch.cat([torch.tensor([127.0], device="cuda"), ties[:255]]),
        torch.cat([torch.tensor([448.0], device="cuda"), torch.linspace(-447.0, 447.0, 255, device="cuda")]),
    ])
    yield "half_way", half_way.reshape(-1)
    special = randn(8 * 256, 10.0).reshape(8, 256)
    special[0, 3] = float("nan")
    special[1, 100] = -float("nan")
    special[2, 7] = float("inf")
    special[3, 255] = -float("inf")
    special[4, 0], special[4, 9] = float("inf"), -float("inf")
    special[5] = randn(256, 1000.0)
    special[5, 17] = float("nan")  # scale 1.0: values past 464 become NaN
    yield "nonfinite", special.reshape(-1)


def check_codec():
    """B1 and B2 against their plain versions on the card and against the
    host codec on the CPU (the wire's dequantize-sum-requantize): payload
    and scales byte for byte, dequantized values equal (NaN where NaN).
    Raises naming the check. Returns each kernel's max abs error (0 when
    they agree) and the bucket inputs for timing."""
    import torch

    from torchft_tpu_torch.ops import quantization as q

    summary, bucket = {}, None
    errs = {"quantize_blocks": 0.0, "dequantize_blocks": 0.0}

    def finite_err(a, b):
        both = a.isfinite() & b.isfinite()
        return (a[both] - b[both]).abs().max().item() if bool(both.any()) else 0.0

    def same_codes(what, payload, scales, want_payload, want_scales):
        got_bytes, want_bytes = payload.view(torch.uint8), want_payload.view(torch.uint8)
        got_scales, want_scales = scales.view(torch.int32), want_scales.view(torch.int32)
        if not (torch.equal(got_bytes, want_bytes) and torch.equal(got_scales, want_scales)):
            bad = (got_bytes != want_bytes).nonzero()[:3].tolist()
            raise AssertionError(
                f"{what}: {int((got_bytes != want_bytes).sum())} payload bytes and "
                f"{int((got_scales != want_scales).sum())} scales differ; first payload "
                f"differences at {bad}"
            )

    def same_values(what, out, want):
        same = (out == want) | (out.isnan() & want.isnan())
        if not bool(same.all()):
            raise AssertionError(f"{what}: {int((~same).sum())} values differ")

    for name, x in codec_cases():
        blocks = q._as_blocks(x)
        if name == "bucket_16MiB":
            bucket = blocks
        host_x = x.cpu()
        for wire in ("fp8", "int8"):
            payload, scales = q.quantize_blocks_kernel(blocks, wire)
            want_payload, want_scales = q.quantize_blocks_reference(blocks, wire)
            same_codes(f"quantize_blocks {wire} {name}", payload, scales, want_payload, want_scales)
            out = q.dequantize_blocks_kernel(payload, scales)
            want = q.dequantize_blocks_reference(payload, scales)
            same_values(f"dequantize_blocks {wire} {name}", out, want)
            # The host codec on the CPU, which the wire's reduce runs.
            host_payload, host_scales = q.quantize_blocks(host_x, wire=wire)
            same_codes(f"quantize_blocks {wire} {name} vs the host codec", payload.cpu(),
                       scales.cpu(), host_payload, host_scales)
            same_values(f"dequantize_blocks {wire} {name} vs the host codec", out.cpu(),
                        q.dequantize_blocks_reference(host_payload, host_scales))
            errs["dequantize_blocks"] = max(errs["dequantize_blocks"], finite_err(out, want))
            errs["quantize_blocks"] = max(errs["quantize_blocks"], finite_err(
                out, q.dequantize_blocks_reference(want_payload, want_scales)))
            summary[f"{wire} {name}"] = {"n_blocks": blocks.shape[0],
                                         "payload_bytes_equal_to_gpu_plain_and_host": True,
                                         "dequantized_equal": True}
    torch.cuda.synchronize()
    return summary, bucket, errs


def phase_codec():
    """Checks, times and bounds of B1/B2 at the 16 MiB bucket shape; returns
    their entries for the kernels line (launches filled in later)."""
    import torch

    from torchft_tpu_torch.ops import quantization as q

    summary, blocks, errs = check_codec()
    emit({"phase": "codec_checks", "rule": "payload and scales byte-equal to the plain "
          "version on the card and to the host codec on the CPU, dequantized values "
          "equal (NaN where NaN)", "checks": summary})
    n = blocks.numel()
    entries, report = [], {}
    for wire in ("fp8", "int8"):
        payload, scales = q.quantize_blocks_kernel(blocks, wire)
        ms = {
            "quantize_blocks": cuda_ms(lambda: q.quantize_blocks_kernel(blocks, wire), 50),
            "dequantize_blocks": cuda_ms(lambda: q.dequantize_blocks_kernel(payload, scales), 50),
        }
        plain = {
            "quantize_blocks": cuda_ms(lambda: q.quantize_blocks_reference(blocks, wire), 10),
            "dequantize_blocks": cuda_ms(lambda: q.dequantize_blocks_reference(payload, scales), 10),
        }
        # Each input read once, each output written once: f32 in, one byte
        # and a quarter of a scale byte per element out (and the reverse).
        nbytes = 4 * n + n + 4 * blocks.shape[0]
        report[wire] = {"ms": ms, "plain_ms": plain, "bytes": nbytes,
                        "gb_per_s": {k: nbytes / (v * 1e-3) / 1e9 for k, v in ms.items()}}
        if wire != "fp8":
            continue
        # f32 operations per element: abs, max, divide and convert to
        # quantize; convert and multiply to dequantize.
        for kernel, replaces, ops in (
            ("quantize_blocks", "torchft_tpu/ops/quantization.py:261", 4 * n),
            ("dequantize_blocks", "torchft_tpu/ops/quantization.py:322", 2 * n),
        ):
            bms, by = bound_ms(nbytes, ops, PEAK_F32_FLOPS)
            entries.append({
                "name": kernel, "route": "cuda",
                "source": "torchft_tpu_torch/csrc/quantization.cu", "replaces": replaces,
                "launches": None, "max_abs_err": errs[kernel], "ms": ms[kernel],
                "plain_ms": plain[kernel], "bound_ms": bms, "bound_by": by,
                # No single PyTorch call computes the blockwise codec.
                "library_ms": None,
            })
    emit({"phase": "codec", "shape": {"n_blocks": blocks.shape[0], "block": 256,
                                      "what": "one 16 MiB bf16 bucket as f32"},
          "bound_ms": entries[0]["bound_ms"], "by_wire": report})
    return entries


def _loss(model, tokens):
    return model(tokens[:, :-1], targets=tokens[:, 1:])


def phase_train():
    """Slice 1's path, then its profile. Returns the flash kernels' launch
    counts over that path's steps and its steady step time."""
    import torch

    from torchft_tpu_torch.models.llama import Llama, large_bench_config
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.optim import make_fused_step, sgd

    cfg = large_bench_config(remat="none")
    gen = torch.Generator("cuda").manual_seed(0)
    model = Llama(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_fused_step(model, sgd(0.01, momentum=0.9)(model.parameters()), _loss)
    seq = cfg.max_seq_len
    batches = torch.randint(
        0, cfg.vocab_size, (TRAIN_STEPS, BATCH, seq + 1), device="cuda", generator=gen
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        start = time.perf_counter()
        loss = step(batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        losses.append(loss.item())
    counts = dict(fa.launches)

    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"step-0 loss {losses[0]} is far from ln(vocab) {math.log(cfg.vocab_size)}")
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in counts.values()):
        raise AssertionError(f"launch counts {counts}, expected {want} each ({cfg.n_layers} per step)")
    steady = statistics.median(step_ms[1:])
    emit({
        "phase": "train", "config": "large_bench_config(remat='none')", "params": n_params,
        "batch": BATCH, "seq": seq, "losses": losses, "step_ms": step_ms,
        "steady_step_ms": steady, "tokens_per_s": BATCH * seq / (steady * 1e-3),
        "max_memory_allocated": peak, "launches": counts,
    })
    phase_profile(step, batches, PROFILE_STEPS)
    del model, step, batches
    torch.cuda.empty_cache()

    # Flash against dense through a 2-layer copy of the same widths.
    small = replace(cfg, n_layers=2)
    tokens = torch.randint(0, cfg.vocab_size, (2, BATCH, seq + 1), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    per_impl = {}
    for impl in ("flash", "dense"):
        m = Llama(replace(small, attention_impl=impl), device="cuda",
                  generator=torch.Generator("cuda").manual_seed(3))
        st = make_fused_step(m, sgd(0.01, momentum=0.9)(m.parameters()), _loss)
        per_impl[impl] = [st(tokens[i]).item() for i in range(2)]
        del m, st
    diffs = [abs(a - b) for a, b in zip(per_impl["flash"], per_impl["dense"])]
    emit({"phase": "flash_vs_dense", "layers": 2, "losses": per_impl,
          "max_abs_diff": max(diffs), "atol": LOSS_ATOL})
    if max(diffs) > LOSS_ATOL:
        raise AssertionError(f"flash and dense losses differ by {max(diffs)} > {LOSS_ATOL}")
    return counts, steady


# Leaves whose step-0 gradients the ft_ddp phase holds against the plain
# mean: the f32 norms' bucket and bf16 weights, the lm head among them.
FT_CHECKED_LEAVES = ("layers.0.attn_norm.scale", "layers.0.attn.wq.weight",
                     "layers.12.mlp.w_down.weight", "final_norm.scale", "lm_head.weight")


def ft_group(group: int, lighthouse: str, steps: int, work: str) -> None:
    """One replica group of the ft_ddp phase, in a process of its own:
    prints a JSON line per step and one at the end, and saves its plain and
    averaged step-0 gradients of FT_CHECKED_LEAVES under ``work``."""
    import torch

    from torchft_tpu_torch import metrics
    from torchft_tpu_torch.ddp import _bucket_cap_bytes, _plan_buckets
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models.llama import Llama, large_bench_config
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.optim import Optimizer, _backward, sgd
    from torchft_tpu_torch.parallel.native_pg import ProcessGroupNative
    from torchft_tpu_torch.parallel.store import StoreClient, StoreServer

    cfg = large_bench_config(remat="none")
    # Every group builds the same weights from seed 0 (init_sync=False).
    model = Llama(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    store = StoreServer()
    manager = Manager(
        pg=ProcessGroupNative(timeout=300.0), min_replica_size=FT_GROUPS,
        store=StoreClient(store.address()), store_addr=store.address(),
        lighthouse_addr=lighthouse, replica_id=f"group{group}", init_sync=False,
        timeout=300.0, quorum_timeout=300.0,
    )
    try:
        opt = Optimizer(manager, sgd(0.01, momentum=0.9)(model.parameters()), model)
        quorum_s = []
        step = opt.make_step_fn(_loss, should_quantize=True, on_quorum=quorum_s.append)
        n_buckets = len(_plan_buckets(list(model.parameters()), _bucket_cap_bytes()))
        # Different data per group.
        batches = torch.randint(
            0, cfg.vocab_size, (steps, BATCH, cfg.max_seq_len + 1), device="cuda",
            generator=torch.Generator("cuda").manual_seed(100 + group),
        )
        leaves = dict(model.named_parameters())
        # This group's own gradient of step 0, outside the FT step.
        _backward(model, _loss, (batches[0],), 1)
        plain = {name: leaves[name].grad.cpu() for name in FT_CHECKED_LEAVES}
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        q.reset_launches()
        fa.reset_launches()
        for i in range(steps):
            before = dict(q.launches)
            pipe0 = metrics.histogram_stats("tpuft_quantized_pipeline_seconds")["sum"]
            reduce0 = metrics.histogram_stats("tpuft_quantized_reduce_seconds")["sum"]
            wait0 = metrics.histogram_stats("tpuft_wire_bucket_seconds", path="fp8")["sum"]
            start = time.perf_counter()
            loss, committed = step(batches[i])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            if i == 0:
                # The optimizer stepped with the averaged gradient in .grad.
                averaged = {name: leaves[name].grad.clone() for name in FT_CHECKED_LEAVES}
            emit({
                "phase": "ft_ddp_step", "group": group, "step": i, "ms": ms,
                "quorum_ms": quorum_s[-1] * 1e3,
                "wire_ms": (metrics.histogram_stats("tpuft_quantized_pipeline_seconds")["sum"]
                            - pipe0) * 1e3,
                # Of wire_ms: the host's dequantize-sum-requantize.
                "host_reduce_ms": (metrics.histogram_stats(
                    "tpuft_quantized_reduce_seconds")["sum"] - reduce0) * 1e3,
                "wire_wait_ms": (metrics.histogram_stats(
                    "tpuft_wire_bucket_seconds", path="fp8")["sum"] - wait0) * 1e3,
                "committed": committed, "loss": loss.item(), "buckets": n_buckets,
                "launches": {k: q.launches[k] - before[k] for k in q.launches},
            })
        counts = {**q.launches, **fa.launches}
        torch.save({"plain": plain, "averaged": {k: v.cpu() for k, v in averaged.items()}},
                   Path(work) / f"grads{group}.pt")
        digest = hashlib.sha256()
        for param in model.parameters():
            digest.update(param.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
        emit({
            "phase": "ft_ddp_group", "group": group, "launches": counts,
            "buckets": n_buckets, "step": manager.current_step(),
            "batches_committed": manager.batches_committed(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "params_sha256": digest.hexdigest(),
        })
    finally:
        manager.shutdown(wait=False)
        store.shutdown()


def check_averaged_gradients(plain, averaged):
    """Holds each group's averaged step-0 gradient against the mean of the
    groups' plain gradients, leaf by leaf. The average passes two
    quantizations (each group's bucket, then the requantized sum), so it may
    differ by two fp8 steps of its block, and an fp8 step is at most 1/14 of
    the block's max (32 at 448); the bf16 leaves add their own rounding, at
    most one bf16 step (2**-7 relative). A wire that sums misses by the
    mean itself, one that drops a peer by half the groups' difference.
    Returns the largest error over its tolerance per leaf."""
    import torch

    ratios = {}
    for name in plain[0]:
        g = [p[name].double().reshape(-1, 256) for p in plain]
        if torch.equal(g[0], g[1]):
            raise AssertionError(f"ft_ddp gradients: {name}: both groups' plain gradients "
                                 f"are equal, so the check cannot see a dropped peer")
        mean = (g[0] + g[1]) / 2
        block_max = torch.maximum(g[0].abs().amax(1), g[1].abs().amax(1))[:, None]
        tol = 2 * block_max / 14 + mean.abs() * 2.0 ** -7
        for group, avg in enumerate(averaged):
            err = (avg[name].double().reshape(-1, 256) - mean).abs()
            if not bool((err <= tol).all()):
                worst = int((err - tol).argmax())
                raise AssertionError(
                    f"ft_ddp gradients: {name}: group {group}'s averaged gradient misses "
                    f"the plain mean at {int((err > tol).sum())} elements, by "
                    f"{err.view(-1)[worst].item()} against {tol.view(-1)[worst].item()}")
            ratios[name] = max(ratios.get(name, 0.0), (err / tol.clamp_min(1e-300)).max().item())
    return ratios


def phase_ft_ddp(plain_step_ms: float):
    """Two replica groups of FT-DDP with the fp8 codec on the one card.
    Returns B1/B2 launch counts summed over the groups."""
    import torch

    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.models.llama import large_bench_config
    from torchft_tpu_torch.ops import flash_attention as fa

    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=FT_GROUPS, join_timeout_ms=1000)
    work = Path(tempfile.mkdtemp(prefix="ft_ddp_"))
    procs, outputs = [], []
    try:
        for group in range(FT_GROUPS):
            # Files, not pipes: a group blocked on a full pipe would stall
            # its peer inside a collective.
            with open(work / f"{group}.out", "w") as out, open(work / f"{group}.err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--ft-group", str(group),
                     lighthouse.address(), str(FT_STEPS), str(work)],
                    cwd=ROOT, stdout=out, stderr=err, text=True,
                    env={**os.environ, "TPUFT_LOG": "warn"},
                ))
        deadline = time.monotonic() + FT_TIMEOUT_S
        for group, proc in enumerate(procs):
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            outputs.append((proc.returncode, (work / f"{group}.out").read_text(),
                            (work / f"{group}.err").read_text()))
        grads = [torch.load(work / f"grads{group}.pt") if rc == 0 else None
                 for group, (rc, _, _) in enumerate(outputs)]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        lighthouse.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    steps, groups = [], []
    for group, (rc, out, err) in enumerate(outputs):
        if rc != 0:
            raise AssertionError(f"ft_ddp group {group} exited {rc}: {err.strip()[-2000:]}")
        for line in out.splitlines():
            if line.startswith("{"):
                record = json.loads(line)
                (steps if record["phase"] == "ft_ddp_step" else groups).append(record)
    for record in steps:
        print(json.dumps(record), flush=True)
    for record in groups:
        print(json.dumps(record), flush=True)
    if len(groups) != FT_GROUPS or len(steps) != FT_GROUPS * FT_STEPS:
        raise AssertionError(f"ft_ddp: expected {FT_GROUPS} groups of {FT_STEPS} steps")
    for record in steps:
        want = record["buckets"]
        if not record["committed"] or any(n != want for n in record["launches"].values()):
            raise AssertionError(f"ft_ddp step did not commit or launch each codec kernel "
                                 f"once per bucket ({want}): {record}")
        if not math.isfinite(record["loss"]):
            raise AssertionError(f"ft_ddp: non-finite loss {record}")
    digests = {g["params_sha256"] for g in groups}
    if len(digests) != 1:
        raise AssertionError(f"ft_ddp: the groups' parameters differ: {digests}")
    if any(g["step"] != FT_STEPS or g["batches_committed"] != FT_GROUPS * FT_STEPS for g in groups):
        raise AssertionError(f"ft_ddp: step accounting {groups}")
    want = large_bench_config().n_layers * FT_STEPS
    for g in groups:
        if any(g["launches"][name] != want for name in fa.launches):
            raise AssertionError(f"ft_ddp group {g['group']}: flash launch counts "
                                 f"{g['launches']}, expected {want} each")
    ratios = check_averaged_gradients([x["plain"] for x in grads], [x["averaged"] for x in grads])
    steady = [r["ms"] for r in steps if r["step"] > 0]
    summary = {
        "phase": "ft_ddp", "groups": FT_GROUPS, "steps": FT_STEPS,
        "buckets_per_step": steps[0]["buckets"],
        "steady_step_ms": statistics.median(steady),
        "quorum_ms_p50": statistics.median(r["quorum_ms"] for r in steps if r["step"] > 0),
        "wire_ms_per_step_p50": statistics.median(r["wire_ms"] for r in steps if r["step"] > 0),
        "wire_ms_per_bucket": statistics.median(r["wire_ms"] for r in steps if r["step"] > 0)
        / steps[0]["buckets"],
        "host_reduce_ms_per_step_p50": statistics.median(
            r["host_reduce_ms"] for r in steps if r["step"] > 0),
        "plain_step_ms_same_call": plain_step_ms,
        # Two groups time-share one card: this is not the FT overhead.
        "ft_step_over_plain_step_two_groups_sharing_one_card":
            statistics.median(steady) / plain_step_ms,
        "params_sha256_equal": True,
        # Step 0's averaged gradient against the plain mean: the largest
        # error over its tolerance (two fp8 steps of the block), per leaf.
        "step0_gradient_err_over_tol": ratios,
        "max_memory_allocated_per_group": [g["max_memory_allocated"] for g in groups],
    }
    emit(summary)
    launches = {"quantize_blocks": 0, "dequantize_blocks": 0}
    for g in groups:
        for name in launches:
            launches[name] += g["launches"][name]
    return launches


# Kernel names to a group of the step's device time.
PROFILE_GROUPS = (
    ("flash attention kernels", r"flash_(fwd|bwd)"),
    ("matrix products", r"gemm|cutlass|xmma|nvjet|sm90_|ampere_|cublas"),
    ("reductions", r"reduce|Reduce|softmax|Softmax|norm"),
    ("elementwise and copies",
     r"elementwise|Elementwise|vectorized|copy|Copy|fill|Fill|index|Index|scatter|gather|cat"),
)


def phase_profile(step, batches, steps: int) -> None:
    """Profiles ``steps`` more train steps: device time per step by kernel
    group, the busy share (summed kernel time over wall time; the step runs
    on one stream) and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(steps):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps

    averages = prof.key_averages()
    cpu_keys = {e.key for e in averages if e.device_type != torch.autograd.DeviceType.CUDA}
    kernels = []
    for evt in averages:
        # Device kernels and copies only. A host-side range (the optimizer's
        # step) is mirrored on the device under the same name and would
        # count its kernels twice.
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key in cpu_keys:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((evt.key, us / 1e3 / steps, evt.count / steps))
    device_ms = sum(ms for _, ms, _ in kernels)
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_group = {}
    for name, ms, _ in kernels:
        group = next((g for g, pattern in PROFILE_GROUPS if re.search(pattern, name)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    kernels.sort(key=lambda kern: -kern[1])
    emit({
        "phase": "profile", "steps": steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
        "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": n[:120], "ms_per_step": ms, "launches_per_step": c}
            for n, ms, c in kernels[:12]
        ],
    })


# The check each planted fault's copy runs, by source.
FAULT_CHECKS = {"flash_attention.cu": "check_kernels", "quantization.cu": "check_codec"}


def phase_planted_faults() -> None:
    """Builds one copy of the kernels per planted fault, all at once, and
    fails unless the kernel checks reject each with the expected check."""
    csrc = ROOT / "torchft_tpu_torch" / "csrc"
    work = Path(tempfile.mkdtemp(prefix="planted_faults_"))
    procs = []
    try:
        for i, (name, source, old, new, _) in enumerate(PLANTED_FAULTS):
            text = (csrc / source).read_text()
            if text.count(old) != 1:
                raise AssertionError(f"planted fault {name!r}: its text is not in {source} once")
            copy = work / str(i)
            shutil.copytree(ROOT / "torchft_tpu_torch", copy / "torchft_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            (copy / "torchft_tpu_torch" / "csrc" / source).write_text(text.replace(old, new))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.{FAULT_CHECKS[source]}()"],
                cwd=copy, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            ))
        results = []
        for (name, _, _, _, expect), proc in zip(PLANTED_FAULTS, procs):
            _, stderr = proc.communicate(timeout=600)
            caught = re.search(r"AssertionError: ([^:]+):", stderr)
            results.append({
                "fault": name, "exit": proc.returncode,
                "caught_by": caught.group(1) if caught else None,
                "detail": stderr.strip().splitlines()[-1][:400] if stderr.strip() else "",
            })
        emit({"phase": "planted_faults", "faults": results})
        for (name, _, _, _, expect), result in zip(PLANTED_FAULTS, results):
            if result["exit"] == 0 or not (result["caught_by"] or "").startswith(expect):
                raise AssertionError(f"planted fault {name!r} was not caught by {expect!r}: {result}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TPUFT_LOG", "warn")  # the lighthouse's per-quorum lines
    smi = phase_device()
    phase_build()
    entries = phase_codec() + phase_kernels()
    counts, plain_step_ms = phase_train()
    counts.update(phase_ft_ddp(plain_step_ms))
    phase_planted_faults()
    for entry in entries:
        entry["launches"] = counts[entry["name"]]
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ft-group"]:
        # One replica group of the ft_ddp phase:
        # --ft-group GROUP LIGHTHOUSE STEPS WORKDIR.
        sys.path.insert(0, str(ROOT))
        ft_group(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), sys.argv[5])
        sys.exit(0)
    sys.exit(main())
