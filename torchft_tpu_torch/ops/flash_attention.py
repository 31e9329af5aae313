"""Causal GQA flash attention: hand-written Hopper kernels and their plain
PyTorch versions (counterpart of torchft_tpu/ops/flash_attention.py).

Three CUDA kernels in ``csrc/flash_attention.cu`` replace the JAX
package's three Pallas kernels:

- ``flash_fwd`` replaces ``_flash_fwd``/``_fwd_kernel``: online-softmax
  forward, returns ``out`` in the input type and a per-row f32 ``lse``;
- ``flash_bwd_dq`` replaces the dq pass of ``flash_attention_partial_bwd``
  (``_bwd_dq_kernel``);
- ``flash_bwd_dkv`` replaces its dk/dv pass (``_bwd_dkv_kernel``), with
  the GQA group summed inside the kernel so dk/dv are written once, as
  ``(b, sk, kv_heads, d)``.

Each masks from explicit int32 position arrays (``q_pos >= k_pos``), skips
a tile wholly above the diagonal, and gives fully masked rows ``out = 0``,
``lse = -1e30``. They read q/k/v in the model's ``(b, s, heads, d)``
layout through strides, so no transposes are made. The three bf16
kernels run on Hopper's wgmma with their accumulators in registers and
the streamed side (K/V, or Q/dO for dk/dv) through a cp.async ring; the
source says what bounds each kernel on the H100 and how its design meets
it. ``flash_resources`` reads a kernel's registers, local memory and
resident blocks per SM from the loaded library.

Every wrapper takes its kernel for a CUDA tensor and its plain version
for a CPU tensor; there is no fallback from one to the other. The kernels
take bf16 or f32, a head_dim of 64 or 128, a last dim of stride 1 and
16-byte aligned rows, and raise on anything else. ``delta = rowsum(dO*O)``
is plain PyTorch, as it is XLA outside the kernels in JAX.

``launches`` counts kernel launches per kernel (never plain-version calls),
so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "flash_attention",
    "flash_attention_partial",
    "flash_attention_partial_bwd",
    "merge_attention_partials",
    "flash_fwd",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "flash_fwd_reference",
    "flash_resources",
    "flash_bwd_dq_reference",
    "flash_bwd_dkv_reference",
    "launches",
    "reset_launches",
]

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernel codes of ``tpuft_flash_resources`` (kFwd, kDq, kDkv in the source).
_KERNEL_CODE = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}

# Kernel launches since the last reset_launches(), by kernel.
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class _Params(ctypes.Structure):
    """``FlashParams`` in csrc/flash_attention.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "dout", "qpos", "kpos", "lse", "delta",
            "out", "lse_out", "dq", "dk", "dv",
        )]
        + [(f"{t}_{s}", ctypes.c_longlong)
           for t in ("q", "k", "v", "do") for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_int) for n in ("b", "sq", "sk", "h", "kvh", "d")]
        + [("scale", ctypes.c_float)]
    )


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernels' library, built from csrc/ at first use."""
    global _lib
    if _lib is None:
        from torchft_tpu_torch._build import load_library

        lib = load_library("flash_attention")
        ptr, i32, i32p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.tpuft_flash_fwd.argtypes = [ptr, i32, ptr]
        lib.tpuft_flash_bwd_dq.argtypes = [ptr, i32, i32, ptr]
        lib.tpuft_flash_bwd_dkv.argtypes = [ptr, i32, i32, ptr]
        lib.tpuft_flash_resources.argtypes = [i32, i32, i32, i32, i32, i32p]
        for fn in (lib.tpuft_flash_fwd, lib.tpuft_flash_bwd_dq, lib.tpuft_flash_bwd_dkv,
                   lib.tpuft_flash_resources):
            fn.restype = i32
        _lib = lib
    return _lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path); False when
    every one lies on a CUDA device (the kernel path). Raises otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        f"flash attention needs all tensors on the CPU or on one CUDA "
        f"device, got {sorted(str(t.device) for t in tensors)}"
    )


def _check_operand(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dim, strides {x.stride()}")
    vec = 16 // x.element_size()
    if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:-1]):
        raise ValueError(f"{name} rows must be 16-byte aligned, strides {x.stride()}")


def _kernel_params(q, k, v, q_positions, k_positions, scale, d_out=None):
    """Validates the operands of a kernel launch and fills FlashParams.
    Returns (params, dtype code, the int32 position tensors the params
    point into, which the caller holds until the launch is queued)."""
    b, sq, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take bf16 or f32, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in {_HEAD_DIMS}, got {d}")
    named = [("q", q), ("k", k), ("v", v)] + ([("d_out", d_out)] if d_out is not None else [])
    for name, x in named:
        _check_operand(name, x, q.dtype)
    qp = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    kp = k_positions.to(device=q.device, dtype=torch.int32).contiguous()
    p = _Params()
    p.q, p.k, p.v, p.qpos, p.kpos = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr()
    )
    p.q_sb, p.q_ss, p.q_sh = q.stride()[:3]
    p.k_sb, p.k_ss, p.k_sh = k.stride()[:3]
    p.v_sb, p.v_ss, p.v_sh = v.stride()[:3]
    if d_out is not None:
        p.dout = d_out.data_ptr()
        p.do_sb, p.do_ss, p.do_sh = d_out.stride()[:3]
    p.b, p.sq, p.sk, p.h, p.kvh, p.d = b, sq, k.shape[1], h, k.shape[2], d
    p.scale = scale
    return p, _DTYPE_CODE[q.dtype], (qp, kp)


def _launch(kernel: str, entry, p: _Params, device: torch.device, *flags: int) -> None:
    """Launches ``entry`` on ``device``'s current stream, raises if the
    launch was refused, and counts it."""
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = entry(ctypes.byref(p), *flags, stream)
    if rc:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {rc}")
    launches[kernel] += 1


def _check_shapes(q, k, v, q_positions, k_positions) -> None:
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"n_heads {h} not a multiple of kv_heads {k.shape[2]}")
    if tuple(q_positions.shape) != (b, sq) or tuple(k_positions.shape) != (b, k.shape[1]):
        raise ValueError("positions must be (b, sq) and (b, sk)")


# ------------------------------------------------------- forward (B3)


def flash_fwd_reference(q, k, v, q_positions, k_positions, scale):
    """Plain version of the ``flash_fwd`` kernel: the same function computed
    densely. Scores and sums in f32; p is cast to v's type before P.V, as
    the kernel does. Returns (out in q.dtype, lse (b, sq, h) f32)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * scale
    mask = (q_positions[:, :, None] >= k_positions[:, None, :])[:, None, None]
    s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v.float())
    empty = m <= _NEG_INF
    l = l.clamp_min(1e-30)
    out = torch.where(empty, 0.0, pv / l)
    lse = torch.where(empty, _NEG_INF, m + torch.log(l))[..., 0]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


def flash_fwd(q, k, v, q_positions, k_positions, scale):
    """Forward kernel (replaces torchft_tpu _fwd_kernel): (out, lse) of
    causal attention masked by the given positions."""
    _check_shapes(q, k, v, q_positions, k_positions)
    if _on_cpu(q, k, v, q_positions, k_positions):
        return flash_fwd_reference(q, k, v, q_positions, k_positions, scale)
    b, sq, h, d = q.shape
    p, code, held = _kernel_params(q, k, v, q_positions, k_positions, scale)  # noqa: F841
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    p.out, p.lse_out = out.data_ptr(), lse.data_ptr()
    _launch("flash_fwd", _library().tpuft_flash_fwd, p, q.device, code)
    return out, lse


# -------------------------------------------------- backward (B4 and B5)


def _bwd_terms(q, k, v, d_out, lse, delta, q_positions, k_positions, scale):
    """p recomputed from the given lse (masked entries exactly 0) and
    ``ds = p * (dO.V^T - delta) * scale``, both f32 (b, kv, group, sq, sk),
    with q and dO split by GQA group."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    dog = d_out.reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float()) * scale
    mask = (q_positions[:, :, None] >= k_positions[:, None, :])[:, None, None]
    lse_g = lse.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)[..., None]
    delta_g = delta.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog.float(), v.float())
    return p, p * (dp - delta_g) * scale, qg, dog


def flash_bwd_dq_reference(q, k, v, d_out, lse, delta, q_positions, k_positions, scale, out_dtype):
    """Plain version of the ``flash_bwd_dq`` kernel: ds cast to k's type
    before dS.K, as the kernel does."""
    _, ds, _, _ = _bwd_terms(q, k, v, d_out, lse, delta, q_positions, k_positions, scale)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(q.shape).to(out_dtype)


def flash_bwd_dkv_reference(q, k, v, d_out, lse, delta, q_positions, k_positions, scale, out_dtype):
    """Plain version of the ``flash_bwd_dkv`` kernel: p cast to dO's type
    and ds to q's type before their products, GQA group summed in f32."""
    p, ds, qg, dog = _bwd_terms(q, k, v, d_out, lse, delta, q_positions, k_positions, scale)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p.to(d_out.dtype).float(), dog.float())
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds.to(q.dtype).float(), qg.float())
    return dk.to(out_dtype), dv.to(out_dtype)


def _bwd_launch(kernel, q, k, v, d_out, lse, delta, q_positions, k_positions, scale, out_dtype):
    """Validates, allocates the gradients ``kernel`` writes and launches it."""
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"gradients come in {q.dtype} or float32, not {out_dtype}")
    b, sq, h, d = q.shape
    p, code, held = _kernel_params(q, k, v, q_positions, k_positions, scale, d_out=d_out)  # noqa: F841
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    if lse.shape != (b, sq, h) or delta.shape != (b, sq, h):
        raise ValueError("lse and delta must be (b, sq, h)")
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    if kernel == "flash_bwd_dq":
        grads = (torch.empty((b, sq, h, d), dtype=out_dtype, device=q.device),)
        p.dq = grads[0].data_ptr()
        entry = _library().tpuft_flash_bwd_dq
    else:
        grads = tuple(torch.empty(k.shape, dtype=out_dtype, device=q.device) for _ in range(2))
        p.dk, p.dv = grads[0].data_ptr(), grads[1].data_ptr()
        entry = _library().tpuft_flash_bwd_dkv
    _launch(kernel, entry, p, q.device, code, int(out_dtype == torch.float32))
    return grads


def flash_bwd_dq(q, k, v, d_out, lse, delta, q_positions, k_positions, scale, out_dtype):
    """dq kernel (replaces torchft_tpu _bwd_dq_kernel), given the global
    lse and ``delta = rowsum(dO*O)``, both (b, sq, h) f32."""
    args = (q, k, v, d_out, lse, delta, q_positions, k_positions, scale, out_dtype)
    _check_shapes(q, k, v, q_positions, k_positions)
    if _on_cpu(q, k, v, d_out, lse, delta, q_positions, k_positions):
        return flash_bwd_dq_reference(*args)
    return _bwd_launch("flash_bwd_dq", *args)[0]


def flash_bwd_dkv(q, k, v, d_out, lse, delta, q_positions, k_positions, scale, out_dtype):
    """dk/dv kernel (replaces torchft_tpu _bwd_dkv_kernel): (dk, dv) as
    (b, sk, kv_heads, d), the GQA group summed inside the kernel."""
    args = (q, k, v, d_out, lse, delta, q_positions, k_positions, scale, out_dtype)
    _check_shapes(q, k, v, q_positions, k_positions)
    if _on_cpu(q, k, v, d_out, lse, delta, q_positions, k_positions):
        return flash_bwd_dkv_reference(*args)
    return _bwd_launch("flash_bwd_dkv", *args)


def flash_resources(
    kernel: str, dtype: torch.dtype, head_dim: int, seq: int,
    out_dtype: Optional[torch.dtype] = None,
) -> Dict[str, int]:
    """One kernel instance's resources on the current card: ``kernel`` is a
    key of ``_KERNEL_CODE``, ``out_dtype`` the gradients' type (default
    ``dtype``), ``seq`` the sequence length its shared memory is sized for.
    Returns resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads per block,
    and registers and local-memory bytes per thread (``cudaFuncGetAttributes``;
    local memory holds spills and stack)."""
    out_f32 = int(out_dtype == torch.float32 and dtype != torch.float32)
    out = (ctypes.c_int * 4)()
    rc = _library().tpuft_flash_resources(
        _KERNEL_CODE[kernel], _DTYPE_CODE[dtype], out_f32, head_dim, seq, out
    )
    if rc:
        raise RuntimeError(f"{kernel} resources query failed with CUDA error {rc}")
    keys = ("blocks_per_sm", "threads_per_block", "registers", "local_bytes")
    return dict(zip(keys, out))


def _attention_backward(*args):
    return (flash_bwd_dq(*args), *flash_bwd_dkv(*args))


# ---------------------------------------------------------- public surface


def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s).contiguous()


class _FlashAttention(torch.autograd.Function):
    """Full causal attention: kernel forward, kernel dq and dk/dv backward
    from the saved (out, lse) — the port of ``_flash_core``'s custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        pos = _arange_positions(q.shape[0], q.shape[1], q.device)
        out, lse = flash_fwd(q, k, v, pos, pos, scale)
        ctx.save_for_backward(q, k, v, out, lse, pos)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, pos = ctx.saved_tensors
        d_out = d_out.contiguous()
        delta = (d_out.float() * out.float()).sum(dim=-1)
        dq, dk, dv = _attention_backward(
            q, k, v, d_out, lse, delta, pos, pos, ctx.scale, q.dtype
        )
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """Fused causal GQA attention with a kernel backward.

    Shapes: q (b, s, h, d); k/v (b, s, kv_heads, d); h % kv_heads == 0.
    ``block_q``/``block_k`` are kept for the JAX signature and not used:
    the CUDA kernels fix their own tiles (128 rows a block for bf16, 64
    for f32), chosen for the H100's shared memory, registers and wgmma
    shapes (see csrc/flash_attention.cu).
    """
    del block_q, block_k
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"n_heads {q.shape[2]} not a multiple of kv_heads {k.shape[2]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, float(scale))


def flash_attention_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal-attention partial over an arbitrary KV block, masked by
    the explicit global positions (b, sq) / (b, sk). Returns (out (b, sq,
    h, d) in q.dtype, lse (b, sq, h) f32); fully masked rows come back as
    out = 0, lse = -1e30. Forward only. Block sizes as in
    :func:`flash_attention`."""
    del block_q, block_k
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_fwd(q, k, v, q_positions, k_positions, float(scale))


def flash_attention_partial_bwd(
    q, k, v, d_out, out, lse,
    q_positions, k_positions,
    scale,
    block_q: int = 512,
    block_k: int = 1024,
    delta: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """Backward of one partial over an arbitrary KV block, given the GLOBAL
    logsumexp ``lse`` (b, sq, h) f32: this KV block's exact (dk, dv) and
    this query shard's dq contribution. ``delta = rowsum(dO*O)`` may be
    passed in (ring callers reuse it across hops). Returns (dq, dk, dv) in
    ``out_dtype`` (default f32); dk/dv are group-summed to (b, sk,
    kv_heads, d)."""
    del block_q, block_k
    if out_dtype is None:
        out_dtype = torch.float32
    if delta is None:
        delta = (d_out.float() * out.float()).sum(dim=-1)
    return _attention_backward(
        q, k, v, d_out, lse, delta, q_positions, k_positions, float(scale), out_dtype
    )


def merge_attention_partials(out_a, lse_a, out_b, lse_b):
    """Combines two normalized attention partials of the same queries over
    disjoint KV sets via their logsumexps. out: (..., d) f32; lse: (...,)
    f32 with -1e30 as the empty sentinel. Plain PyTorch: the JAX package
    has no kernel for it."""
    m = torch.maximum(lse_a, lse_b)
    # exp(-1e30 - -1e30) = 1 would resurrect rows empty on both sides.
    both_empty = m <= _NEG_INF
    wa = torch.where(both_empty, 0.0, torch.exp(lse_a - m))
    wb = torch.where(both_empty, 0.0, torch.exp(lse_b - m))
    safe_l = (wa + wb).clamp_min(1e-30)
    out = (out_a * wa[..., None] + out_b * wb[..., None]) / safe_l[..., None]
    lse = torch.where(both_empty, _NEG_INF, m + torch.log(safe_l))
    return out, lse
