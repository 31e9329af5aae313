#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (torchft_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from the
sources in the checkout (nvcc, into build/torch_kernels/). Phases, each
printing one JSON line:

1. device: the card's name and power limit, torch and CUDA versions; an
   sm_90 card is required.
2. build: the kernels' build time and register/spill summary.
3. kernel_checks: each kernel against its plain PyTorch version on the
   card, at the train step's shapes (b=4, s=2048, 8 query heads of 128
   over 4 KV heads, bf16), on a ragged partial with permuted positions,
   on a fully masked hop, and in f32 on a small case.
4. kernels: times with CUDA events beside the plain version, the card's
   bound and, as a yardstick the port never calls, PyTorch's
   scaled_dot_product_attention.
5. train: the flagship Llama (large_bench_config, 24 layers at full
   width, remat "none") takes 5 steps of make_fused_step with SGD
   momentum 0.9 at batch 4 x 2048 from seeded random weights; launch
   counts are read around exactly this run. Then a 2-layer copy of the
   same widths takes 2 steps with the kernels and 2 with dense attention,
   and their losses must agree.
6. profile: 2 more steps of the flagship model under torch.profiler, for
   device time by kernel group and the device's busy share.
7. planted_faults: copies of the kernels with known faults (a skipped GQA
   head, a skipped KV or query tile), built and checked in parallel; the
   run fails unless the kernel checks reject every one.

Then the kernels line, the card's nvidia-smi line and, last, the result.
Any failure raises and exits non-zero; without a CUDA device it exits
non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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

# Known faults for the planted_faults phase: (name, text in
# csrc/flash_attention.cu, its replacement, the check that must reject it).
# Tile 16 covers keys or queries 1024-1087, so only the later rows lose a
# small share of their terms.
PLANTED_FAULTS = (
    ("fwd drops the P.V of KV tile 16",
     "    strip_pv<T, kBlockK, D>(sP + r0 * L::LDP,",
     "    if (kt != 16) strip_pv<T, kBlockK, D>(sP + r0 * L::LDP,",
     "flash_fwd out"),
    ("dq drops the dS.K of KV tile 16",
     "    strip_pv<T, kBlockK, D>(sDS + r0 * L::LDP,",
     "    if (kt != 16) strip_pv<T, kBlockK, D>(sDS + r0 * L::LDP,",
     "flash_bwd_dq"),
    ("dk/dv skip the last query head of each GQA group",
     "for (int g = 0; g < group; ++g) {",
     "for (int g = 0; g < group - 1; ++g) {",
     "flash_bwd_dkv"),
    ("dk/dv skip query tile 16",
     "if (qmax < kmin) continue;",
     "if (qmax < kmin || qt == 16) continue;",
     "flash_bwd_dkv"),
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
    from torchft_tpu_torch import _build
    from torchft_tpu_torch.ops import flash_attention as fa

    start = time.perf_counter()
    fa._library()
    log = _build.build_log.get("flash_attention", {})
    ptxas = log.get("ptxas", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", ptxas)]
    emit({
        "phase": "build", "seconds": time.perf_counter() - start,
        "nvcc_seconds": log.get("seconds"), "kernel_instances": len(regs),
        "max_registers": max(regs, default=None), "spill_store_bytes": sum(spills),
    })


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


def _loss(model, tokens):
    return model(tokens[:, :-1], targets=tokens[:, 1:])


def phase_train():
    """The main path, then its profile. Returns the kernels' launch
    counts over the main path's steps."""
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
    return counts


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


def phase_planted_faults() -> None:
    """Builds one copy of the kernels per planted fault, all at once, and
    fails unless the kernel checks reject each with the expected check."""
    source = (ROOT / "torchft_tpu_torch" / "csrc" / "flash_attention.cu").read_text()
    work = Path(tempfile.mkdtemp(prefix="planted_faults_"))
    procs = []
    try:
        for i, (name, old, new, _) in enumerate(PLANTED_FAULTS):
            if source.count(old) != 1:
                raise AssertionError(f"planted fault {name!r}: its text is not in the source once")
            copy = work / str(i)
            shutil.copytree(ROOT / "torchft_tpu_torch", copy / "torchft_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            (copy / "torchft_tpu_torch" / "csrc" / "flash_attention.cu").write_text(
                source.replace(old, new))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; chip_smoke.check_kernels()"],
                cwd=copy, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            ))
        results = []
        for (name, _, _, expect), proc in zip(PLANTED_FAULTS, procs):
            _, stderr = proc.communicate(timeout=600)
            caught = re.search(r"AssertionError: ([^:]+):", stderr)
            results.append({
                "fault": name, "exit": proc.returncode,
                "caught_by": caught.group(1) if caught else None,
                "detail": stderr.strip().splitlines()[-1][:400] if stderr.strip() else "",
            })
        emit({"phase": "planted_faults", "faults": results})
        for (name, _, _, expect), result in zip(PLANTED_FAULTS, results):
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
    smi = phase_device()
    phase_build()
    entries = phase_kernels()
    counts = phase_train()
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
    sys.exit(main())
