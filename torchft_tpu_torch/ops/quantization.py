"""Block quantization (fp8/int8/int4) for bandwidth-compressed collectives
(counterpart of torchft_tpu/ops/quantization.py).

Arrays are flattened, padded to a multiple of ``block`` (256) and viewed as
``(n_blocks, block)``; each block carries one f32 scale, ``maxabs / qmax``
(1.0 for a block whose max is 0 or NaN). The payload is ``x / scale`` as
fp8 e4m3fn (qmax 448), rounded half-to-even to int8 (qmax 127), or rounded
to [-7, 7] and packed two int4 nibbles a byte, low nibble first (qmax 7).
The wire buffer is ``[format tag || scales || payload]``. Every function
here gives the JAX package's bytes.

Two halves, as in the reference:

- the host codec (:func:`quantize_blocks`, :func:`dequantize_blocks`,
  :func:`reduce_quantized`, :func:`pack_arrays`, :func:`unpack_arrays`) on
  torch CPU tensors, for the wire's fused dequantize-reduce-requantize;
- the device codec (:func:`quantize_blocks_device`,
  :func:`dequantize_blocks_device`, :func:`make_tree_fp8_codec`), which
  quantizes gradients where they live. On a CUDA tensor fp8 and int8 run
  kernels B1 and B2 (``csrc/quantization.cu``); int4 stays plain torch on
  every device, as the reference keeps it in jnp.

Where the reference's own paths disagree, this module follows the jnp
device codec: a float to int8 or int4 conversion saturates and sends NaN
to 0 (XLA's convert). numpy's host cast wraps out-of-range values instead,
which only a block that holds a NaN can reach (its scale is 1.0).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "BLOCK",
    "FP8_MAX",
    "INT8_MAX",
    "INT4_MAX",
    "WIRE_DTYPE_ENV",
    "WIRE_HEADER_BYTES",
    "default_wire",
    "wire_of",
    "payload_cols",
    "quantize_blocks",
    "dequantize_blocks",
    "reduce_quantized",
    "pack_arrays",
    "unpack_arrays",
    "quantize_blocks_kernel",
    "quantize_blocks_reference",
    "dequantize_blocks_kernel",
    "dequantize_blocks_reference",
    "quantize_blocks_device",
    "dequantize_blocks_device",
    "make_tree_fp8_codec",
    "launches",
    "reset_launches",
]

BLOCK = 256
FP8_MAX = 448.0  # float8_e4m3fn dynamic range
INT8_MAX = 127.0
INT4_MAX = 7.0  # symmetric nibbles: [-7, 7], -8 never produced
WIRE_DTYPE_ENV = "TPUFT_WIRE_DTYPE"
# Largest |x| that rounds to a finite e4m3fn value: 464 is the midpoint
# between 448 and the NaN pattern and rounds to even (448). Above it the
# reference's non-saturating cast (ml_dtypes, XLA) gives NaN.
_FP8_ROUNDS_FINITE = 464.0

_WIRE_DTYPES = {"fp8": torch.float8_e4m3fn, "int8": torch.int8, "int4": torch.uint8}
_WIRE_QMAX = {"fp8": FP8_MAX, "int8": INT8_MAX, "int4": INT4_MAX}
_KERNEL_WIRES = {"fp8": 0, "int8": 1}  # codes of csrc/quantization.cu

# Launches of each kernel wrapper (counted where the kernel launches, never
# on the CPU path).
launches: Dict[str, int] = {"quantize_blocks": 0, "dequantize_blocks": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def payload_cols(wire: str, block: int = BLOCK) -> int:
    """Per-block wire payload width in bytes (int4 packs two per byte)."""
    if wire == "int4" and block % 2:
        raise ValueError(f"int4 requires an even block size, got {block}")
    return block // 2 if wire == "int4" else block


def _resolve_wire(wire: Optional[str]) -> str:
    """Validates an explicit wire choice; None means the env default."""
    if wire is None:
        return default_wire()
    if wire not in _WIRE_DTYPES:
        raise ValueError(f"wire={wire!r} is not one of {sorted(_WIRE_DTYPES)}")
    return wire


def default_wire() -> str:
    """The process-wide wire format: ``TPUFT_WIRE_DTYPE`` or ``"fp8"``."""
    wire = os.environ.get(WIRE_DTYPE_ENV, "fp8")
    if wire not in _WIRE_DTYPES:
        raise ValueError(f"{WIRE_DTYPE_ENV}={wire!r} is not one of {sorted(_WIRE_DTYPES)}")
    return wire


def wire_of(payload: torch.Tensor) -> str:
    """Wire format of an existing payload tensor, by dtype."""
    for name, dtype in _WIRE_DTYPES.items():
        if payload.dtype == dtype:
            return name
    raise TypeError(f"tensor dtype {payload.dtype} is not a known wire payload format")


# ---------------------------------------------------------------------------
# Plain versions of kernels B1 and B2
# ---------------------------------------------------------------------------


def _scales(maxabs: torch.Tensor, wire: str) -> torch.Tensor:
    # NaN > 0 is False: a block holding a NaN keeps scale 1.0, as in numpy
    # and jnp (their max propagates the NaN into maxabs). The divisor is a
    # tensor on maxabs's device: on CUDA, torch divides by a Python scalar
    # as a multiply by its reciprocal, which rounds otherwise.
    qmax = torch.full_like(maxabs, _WIRE_QMAX[wire])
    return torch.where(maxabs > 0, maxabs / qmax, torch.ones_like(maxabs))


def _to_fp8(scaled: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even f32 ``scaled = blocks / scale`` -> e4m3fn, with
    NaN for NaN, infinities and magnitudes that round past 448 (sign kept),
    as ml_dtypes and XLA cast. torch's own cast saturates some of those, so
    they are set here.

    A NaN quotient takes its sign as the x86 host's division gives it, on
    every device: a NaN input keeps its own sign, and an invalid division
    (inf/inf, 0/0) gives the negative default NaN. CUDA's division returns
    a positive NaN in both cases."""
    bits = scaled.to(torch.float8_e4m3fn).view(torch.uint8)
    special = torch.isnan(scaled) | (scaled.abs() > _FP8_ROUNDS_FINITE)
    negative = torch.where(
        torch.isnan(scaled), ~torch.isnan(blocks) | torch.signbit(blocks), torch.signbit(scaled)
    )
    nan_bits = torch.where(negative, 0xFF, 0x7F).to(torch.uint8)
    return torch.where(special, nan_bits, bits).view(torch.float8_e4m3fn)


def _to_int8(rounded: torch.Tensor) -> torch.Tensor:
    """Saturating f32 -> int8 with NaN -> 0 (XLA's convert)."""
    return torch.nan_to_num(rounded, nan=0.0).clamp(-128.0, 127.0).to(torch.int8)


def _pack_int4(values: torch.Tensor) -> torch.Tensor:
    """(n, block) int8 in [-7, 7] -> (n, block//2) uint8, low nibble first."""
    u = values.to(torch.uint8) & 0xF
    return u[:, 0::2] | (u[:, 1::2] << 4)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_int4`, with 4-bit sign extension."""
    both = torch.stack([packed & 0xF, (packed >> 4) & 0xF], dim=-1)
    both = both.reshape(packed.shape[0], -1).to(torch.int16)
    return ((both ^ 8) - 8).to(torch.int8)


def quantize_blocks_reference(
    blocks: torch.Tensor, wire: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B1 (and the host codec's math): f32
    ``(n_blocks, block)`` -> (payload, scales f32 ``(n_blocks,)``)."""
    maxabs = blocks.abs().amax(dim=1)  # NaN propagates
    scales = _scales(maxabs, wire)
    scaled = blocks / scales[:, None]
    if wire == "fp8":
        return _to_fp8(scaled, blocks), scales
    values = _to_int8(torch.round(scaled))  # half to even
    return (_pack_int4(values) if wire == "int4" else values), scales


def _decode(payload: torch.Tensor) -> torch.Tensor:
    if payload.dtype == torch.uint8:
        payload = _unpack_int4(payload)
    return payload.to(torch.float32)


def dequantize_blocks_reference(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B2: ``payload.float() * scale`` per row,
    f32 ``(n_blocks, block)`` (int4 unpacked first)."""
    return _decode(payload) * scales[:, None]


# ---------------------------------------------------------------------------
# Kernels B1 and B2
# ---------------------------------------------------------------------------


def _library():
    from torchft_tpu_torch._build import load_library

    lib = load_library("quantization")
    if not getattr(lib, "_declared", False):
        for fn in (lib.tpuft_quantize_blocks, lib.tpuft_dequantize_blocks):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib._declared = True
    return lib


def _check_cuda(tensor: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {tensor.device}")
    if tensor.dtype != dtype or tuple(tensor.shape) != shape or not tensor.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape}, got "
            f"{tensor.dtype} {tuple(tensor.shape)} (contiguous={tensor.is_contiguous()})"
        )
    if tensor.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor")


def quantize_blocks_kernel(
    blocks: torch.Tensor, wire: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 (replaces ``quantize_blocks_pallas``): f32
    ``(n_blocks, 256)`` -> (fp8 or int8 payload, f32 scales). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if wire not in _KERNEL_WIRES:
        raise ValueError(f"kernel B1 takes wire 'fp8' or 'int8', got {wire!r}")
    if blocks.device.type == "cpu":
        return quantize_blocks_reference(blocks, wire)
    n_blocks = blocks.shape[0] if blocks.dim() == 2 else -1
    _check_cuda(blocks, "quantize_blocks", torch.float32, (n_blocks, BLOCK))
    payload = torch.empty((n_blocks, BLOCK), dtype=_WIRE_DTYPES[wire], device=blocks.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=blocks.device)
    if n_blocks:
        rc = _library().tpuft_quantize_blocks(
            blocks.data_ptr(), payload.data_ptr(), scales.data_ptr(), n_blocks,
            _KERNEL_WIRES[wire], torch.cuda.current_stream(blocks.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"quantize_blocks kernel launch failed (CUDA error {rc})")
        launches["quantize_blocks"] += 1
    return payload, scales


def dequantize_blocks_kernel(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel B2 (replaces ``dequantize_blocks_pallas``): fp8 or int8
    ``(n_blocks, 256)`` and f32 scales -> f32 ``(n_blocks, 256)``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    wire = wire_of(payload)
    if wire not in _KERNEL_WIRES:
        raise ValueError(f"kernel B2 takes fp8 or int8 payloads, got {payload.dtype}")
    if payload.device.type == "cpu":
        return dequantize_blocks_reference(payload, scales)
    n_blocks = payload.shape[0] if payload.dim() == 2 else -1
    _check_cuda(payload, "dequantize_blocks payload", payload.dtype, (n_blocks, BLOCK))
    _check_cuda(scales, "dequantize_blocks scales", torch.float32, (n_blocks,))
    out = torch.empty((n_blocks, BLOCK), dtype=torch.float32, device=payload.device)
    if n_blocks:
        rc = _library().tpuft_dequantize_blocks(
            payload.data_ptr(), scales.data_ptr(), out.data_ptr(), n_blocks,
            _KERNEL_WIRES[wire], torch.cuda.current_stream(payload.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"dequantize_blocks kernel launch failed (CUDA error {rc})")
        launches["dequantize_blocks"] += 1
    return out


# ---------------------------------------------------------------------------
# Host codec
# ---------------------------------------------------------------------------


def _as_blocks(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Flat f32 view of ``x`` as ``(n_blocks, block)``, zero-padded."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def quantize_blocks(
    array: torch.Tensor, block: int = BLOCK, wire: Optional[str] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (payload (n_blocks, payload_cols(wire)), scales f32
    (n_blocks,)) of a CPU tensor: 1 byte an element for fp8/int8,
    nibble-packed uint8 at block//2 bytes for int4."""
    wire = _resolve_wire(wire)
    payload_cols(wire, block)  # validates an even block for int4
    return quantize_blocks_reference(_as_blocks(array, block), wire)


def dequantize_blocks(
    payload: torch.Tensor, scales: torch.Tensor, shape: Sequence[int], dtype: torch.dtype
) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks` (drops padding)."""
    flat = dequantize_blocks_reference(payload, scales).reshape(-1)
    size = 1
    for dim in shape:
        size *= int(dim)
    return flat[:size].reshape(tuple(shape)).to(dtype)


def reduce_quantized(
    payloads: Sequence[torch.Tensor], scales: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dequantize-sum-requantize over per-rank quantized chunks:
    accumulates in f32 and emits a payload and scales for the sum in the
    inputs' wire format."""
    wire = wire_of(payloads[0])
    acc = dequantize_blocks_reference(payloads[0], scales[0])
    for payload, scale in zip(payloads[1:], scales[1:]):
        acc += dequantize_blocks_reference(payload, scale)
    return quantize_blocks_reference(acc, wire)


_WIRE_TAGS = {"fp8": 0, "int8": 1, "int4": 2}
_TAG_WIRES = {tag: name for name, tag in _WIRE_TAGS.items()}
# One leading byte names the payload format on the wire, so a cross-rank
# TPUFT_WIRE_DTYPE disagreement is a hard error instead of fp8 bits decoded
# as int8.
WIRE_HEADER_BYTES = 1


def pack_arrays(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Packs [format tag || scales || payload] into one uint8 CPU buffer."""
    tag = torch.tensor([_WIRE_TAGS[wire_of(payload)]], dtype=torch.uint8)
    return torch.cat([
        tag,
        scales.to(torch.float32).contiguous().view(torch.uint8).reshape(-1),
        payload.contiguous().view(torch.uint8).reshape(-1),
    ])


def unpack_arrays(
    buf: torch.Tensor, n_blocks: int, block: int = BLOCK, wire: Optional[str] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_arrays`. The embedded tag is authoritative;
    passing ``wire`` asserts the peer used the expected format."""
    tag_wire = _TAG_WIRES.get(int(buf[0]))
    if tag_wire is None:
        raise ValueError(f"unknown wire format tag {int(buf[0])} in buffer")
    if wire is not None and wire != tag_wire:
        raise ValueError(
            f"wire format mismatch: peer sent {tag_wire!r}, this rank expects "
            f"{wire!r} — TPUFT_WIRE_DTYPE must agree across all replicas"
        )
    body = buf[WIRE_HEADER_BYTES:]
    scale_bytes = n_blocks * 4
    scales = body[:scale_bytes].clone().view(torch.float32)
    cols = payload_cols(tag_wire, block)
    payload = (
        body[scale_bytes : scale_bytes + n_blocks * cols]
        .clone()
        .view(_WIRE_DTYPES[tag_wire])
        .reshape(n_blocks, cols)
    )
    return payload, scales


# ---------------------------------------------------------------------------
# Device codec
# ---------------------------------------------------------------------------


def quantize_blocks_device(
    x: torch.Tensor, block: int = BLOCK, wire: Optional[str] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantizes a tensor where it lives: pads to a block multiple and
    returns (payload (n_blocks, payload_cols(wire)), scales f32). fp8 and
    int8 go through kernel B1 (on the CPU its plain version); int4 is plain
    torch everywhere."""
    wire = _resolve_wire(wire)
    payload_cols(wire, block)
    blocks = _as_blocks(x, block)
    if wire == "int4":
        return quantize_blocks_reference(blocks, wire)
    return quantize_blocks_kernel(blocks, wire)


def dequantize_blocks_device(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Dequantizes where the payload lives, to a flat f32 tensor (padding
    kept): kernel B2 for fp8/int8 (on the CPU its plain version), plain
    torch for int4."""
    if payload.dtype == torch.uint8:
        return dequantize_blocks_reference(payload, scales).reshape(-1)
    return dequantize_blocks_kernel(payload, scales).reshape(-1)


def make_tree_fp8_codec(leaves: Sequence[torch.Tensor], wire: Optional[str] = None):
    """Builds a (quantize, dequantize) pair for a fixed list of float
    tensors: quantize concatenates the leaves (as f32) and emits (payload,
    scales); dequantize inverts back to per-leaf tensors with the original
    shapes and dtypes. ``wire`` picks the format (default
    ``TPUFT_WIRE_DTYPE``/fp8; the name keeps the historical "fp8")."""
    wire = _resolve_wire(wire)
    for leaf in leaves:
        if not leaf.dtype.is_floating_point:
            raise TypeError(
                f"quantized sync requires float leaves, got {leaf.dtype}; "
                "use the unquantized path for integer state"
            )
    shapes = [tuple(leaf.shape) for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    total = sum(sizes)

    def quantize(leaves_in: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves_in])
        return quantize_blocks_device(flat, wire=wire)

    def dequantize(payload: torch.Tensor, scales: torch.Tensor) -> List[torch.Tensor]:
        flat = dequantize_blocks_device(payload, scales)[:total]
        return [
            part.reshape(shape).to(dtype)
            for part, shape, dtype in zip(flat.split(sizes), shapes, dtypes)
        ]

    return quantize, dequantize
