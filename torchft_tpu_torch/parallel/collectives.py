"""Quantized collectives: 8-bit allreduce over any process group
(counterpart of torchft_tpu/parallel/collectives.py).

    allreduce_quantized:
      quantize -> alltoall of per-rank block chunks -> fused local
      dequantize-reduce-requantize -> allgather -> dequantize into outputs

The wire carries a quantized payload (fp8 e4m3 / int8, or packed int4 at
half the bytes; ``TPUFT_WIRE_DTYPE``) and f32 per-block scales, about 4x
fewer bytes than f32 both ways. SUM/AVG only. The codec math is in
:mod:`torchft_tpu_torch.ops.quantization`. ``reduce_scatter_quantized``
comes with a later slice.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import torch

from torchft_tpu_torch import metrics
from torchft_tpu_torch.ops import quantization as q
from torchft_tpu_torch.parallel.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.utils.transfer import prefetch_to_host
from torchft_tpu_torch.work import Work

__all__ = ["allreduce_quantized", "allreduce_quantized_wire"]

# Multi-stage pipelines (alltoall -> reduce -> allgather) must not block the
# process group's single op-worker thread waiting on ops they themselves
# enqueue, so they run on a pool of their own.
_PIPELINE_POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="tpuft-quant")


def _pad_blocks(
    payload: torch.Tensor, scales: torch.Tensor, world_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pads the block count to a multiple of world_size (zero payload, unit
    scales) so every rank owns an equal chunk."""
    pad = (-payload.shape[0]) % world_size
    if pad:
        payload = torch.cat([payload, payload.new_zeros((pad, payload.shape[1]))])
        scales = torch.cat([scales, scales.new_ones(pad)])
    return payload, scales


def _chunk_bytes(nb: int, wire: str) -> int:
    return q.WIRE_HEADER_BYTES + nb * 4 + nb * q.payload_cols(wire)


def _exchange(
    payloads: List[torch.Tensor], scales: List[torch.Tensor], reduce_op: ReduceOp,
    pg: ProcessGroup,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The wire half shared by both entry points: each array's blocks
    (already padded to a multiple of the world size) are split into one
    chunk per rank; rank r reduces chunk r of everyone's arrays
    (alltoall), and the reduced chunks are allgathered. Returns the
    reduced (payload, scales) of each array, padding kept."""
    world_size = pg.size()
    wires = [q.wire_of(p) for p in payloads]
    per_rank = [p.shape[0] // world_size for p in payloads]
    wire_bufs = [
        torch.cat([
            q.pack_arrays(p[r * nb : (r + 1) * nb], s[r * nb : (r + 1) * nb])
            for p, s, nb in zip(payloads, scales, per_rank)
        ])
        for r in range(world_size)
    ]
    metrics.inc(
        "tpuft_wire_bytes_total", sum(buf.numel() for buf in wire_bufs), path="quantized"
    )

    def split(buf: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        out, offset = [], 0
        for nb, wire in zip(per_rank, wires):
            length = _chunk_bytes(nb, wire)
            out.append(q.unpack_arrays(buf[offset : offset + length], nb, wire=wire))
            offset += length
        return out

    received = [split(buf) for buf in pg.alltoall(wire_bufs).wait()]
    reduce_start = time.perf_counter()
    reduced = []
    for idx in range(len(payloads)):
        out_payload, out_scales = q.reduce_quantized(
            [received[r][idx][0] for r in range(world_size)],
            [received[r][idx][1] for r in range(world_size)],
        )
        if reduce_op == ReduceOp.AVG:
            out_scales = out_scales / world_size
        reduced.append(q.pack_arrays(out_payload, out_scales))
    metrics.observe("tpuft_quantized_reduce_seconds", time.perf_counter() - reduce_start)
    gathered = [split(bufs[0]) for bufs in pg.allgather([torch.cat(reduced)]).wait()]
    return [
        (
            torch.cat([gathered[r][idx][0] for r in range(world_size)]),
            torch.cat([gathered[r][idx][1] for r in range(world_size)]),
        )
        for idx in range(len(payloads))
    ]


def allreduce_quantized(
    tensors: Sequence[torch.Tensor],
    reduce_op: ReduceOp,
    pg: ProcessGroup,
    wire_dtype: "str | None" = None,
) -> Work:
    """8-bit allreduce of CPU tensors (upstream torchft collectives.py:
    297-415). Resolves to the reduced tensors in their original dtypes and
    shapes. ``wire_dtype`` is "fp8"/"int8"/"int4" (default
    ``TPUFT_WIRE_DTYPE``/fp8; all replicas must agree)."""
    if reduce_op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"unsupported reduce op for quantized allreduce: {reduce_op}")
    wire_dtype = q._resolve_wire(wire_dtype)
    world_size = pg.size()
    if world_size == 1:
        return Work.completed([t.clone() for t in tensors])

    quantized = [
        _pad_blocks(*q.quantize_blocks(t, wire=wire_dtype), world_size) for t in tensors
    ]

    def pipeline() -> List[torch.Tensor]:
        start = time.perf_counter()
        reduced = _exchange([p for p, _ in quantized], [s for _, s in quantized], reduce_op, pg)
        outputs = []
        for t, (payload, scales) in zip(tensors, reduced):
            n_blocks = -(-t.numel() // q.BLOCK)
            outputs.append(
                q.dequantize_blocks(payload[:n_blocks], scales[:n_blocks], t.shape, t.dtype)
            )
        metrics.observe("tpuft_quantized_pipeline_seconds", time.perf_counter() - start)
        return outputs

    return Work(_PIPELINE_POOL.submit(pipeline))


def allreduce_quantized_wire(
    payload: torch.Tensor,
    scales: torch.Tensor,
    reduce_op: ReduceOp,
    pg: ProcessGroup,
) -> Work:
    """Allreduce of already-quantized data, staying quantized end to end.

    The caller quantized on the device and ships only the 8-bit payload
    (its format read from the payload's dtype) and the f32 block scales
    across the host boundary; this exchanges the chunks, does the fused
    dequantize-reduce-requantize per chunk, allgathers, and resolves to the
    reduced (payload, scales) pair, on the host, for dequantization on the
    device. AVG folds into the scales."""
    if reduce_op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"unsupported reduce op: {reduce_op}")
    world_size = pg.size()
    q.wire_of(payload)  # validates the payload format before any copy
    # Start the device-to-host copies now, without blocking: they land
    # while this call returns and the caller dispatches more work.
    copies = prefetch_to_host((payload, scales))

    def pipeline() -> Tuple[torch.Tensor, torch.Tensor]:
        payload_h, scales_h = (c.wait() for c in copies)
        n_blocks = payload_h.shape[0]
        if world_size == 1:
            out_scales = scales_h / world_size if reduce_op == ReduceOp.AVG else scales_h
            return payload_h.clone(), out_scales.clone()
        start = time.perf_counter()
        padded = _pad_blocks(payload_h, scales_h, world_size)
        ((payload_out, scales_out),) = _exchange([padded[0]], [padded[1]], reduce_op, pg)
        metrics.observe("tpuft_quantized_pipeline_seconds", time.perf_counter() - start)
        return payload_out[:n_blocks], scales_out[:n_blocks]

    return Work(_PIPELINE_POOL.submit(pipeline))
