"""The port's blockwise codec against the JAX package's, byte for byte.

Kernels B1/B2 run their plain versions here (CPU tensors), and the host
codec runs on torch CPU tensors. Each is held to three references where
they exist: the JAX package's host ``quantize_blocks`` (numpy/ml_dtypes),
its ``quantize_blocks_device`` (jnp on the CPU) and its Pallas kernels in
interpret mode. Payload bytes and scales must be equal, dequantized values
equal (NaN where NaN).

Two documented exceptions, both where the JAX package's own paths differ:

- A block that holds a NaN keeps scale 1.0, so its other values reach the
  int8/int4 cast unscaled. numpy's cast of a value beyond int8's range
  wraps (implementation-defined), XLA's saturates; the port saturates like
  XLA, so those blocks are held to the jnp and Pallas paths only. For fp8
  all three references agree (NaN past 464) and the port is held to all.
- Compiled by XLA (the Pallas body in interpret mode, and every jitted
  codec), ``maxabs / qmax`` becomes ``maxabs * (1 / qmax)``, which rounds
  differently in about half the blocks (one ulp of the scale). The port
  divides, as numpy and eager jnp do. Against those paths the test checks
  exactly that rewrite: their scales equal ``maxabs * f32(1/qmax)``, and
  their payload equals the port's cast of ``x / scale`` with those scales.
- XLA on the CPU flushes f32 subnormals to zero, numpy does not, nor does
  the card (no fast-math flags). Blocks of subnormals are held to the host
  codec only.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.ops import quantization as jq
from torchft_tpu_torch.ops import quantization as tq

torch.set_num_threads(1)

# numpy warns where the JAX package's host codec meets NaN and inf blocks.
pytestmark = pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")

BLOCK = 256


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "ragged":
        return rng.normal(0, 3.0, 5 * BLOCK - 37).astype(np.float32)
    if name == "zero_and_tiny_blocks":
        return np.concatenate([
            rng.normal(0, 1.0, BLOCK), np.zeros(BLOCK), rng.normal(0, 1e-4, BLOCK),
            np.full(BLOCK, -0.0), rng.normal(0, 1e6, 100),
        ]).astype(np.float32)
    if name == "subnormal":
        return np.concatenate([
            rng.normal(0, 1e-39, BLOCK), rng.normal(0, 1e-36, BLOCK),
        ]).astype(np.float32)
    if name == "ties":
        # maxabs 127 (int8 scale 1.0) and 7 (int4 scale 1.0) put x.5 ties on
        # the int grid; 448 puts them on fp8's.
        ties = np.arange(-64, 64, dtype=np.float32) + 0.5
        return np.concatenate([
            np.concatenate([[127.0], ties, ties[:127]]),
            np.concatenate([[7.0], np.tile(np.float32([-6.5, -0.5, 0.5, 2.5, 3.5]), 51)]),
            np.concatenate([[448.0], np.linspace(-447.0, 447.0, 255)]),
        ]).astype(np.float32)
    if name == "nonfinite_small":
        blocks = rng.normal(0, 10.0, (5, BLOCK)).astype(np.float32)
        blocks[0, 3] = np.nan
        blocks[1, 100] = -np.nan
        blocks[2, 7] = np.inf
        blocks[3, 255] = -np.inf
        blocks[4, [0, 9]] = [np.inf, -np.inf]
        return blocks.reshape(-1)
    if name == "nonfinite_large":
        blocks = rng.normal(0, 1000.0, (3, BLOCK)).astype(np.float32)
        blocks[0, 17] = np.nan
        blocks[1, 0] = np.nan
        blocks[1, 1] = np.inf
        return blocks.reshape(-1)
    raise KeyError(name)


CASES = [
    "ragged", "zero_and_tiny_blocks", "subnormal", "ties", "nonfinite_small",
    "nonfinite_large",
]
WIRES = ["fp8", "int8", "int4"]


def _bytes(payload) -> np.ndarray:
    if isinstance(payload, torch.Tensor):
        return payload.contiguous().view(torch.uint8).numpy()
    return np.asarray(payload).view(np.uint8)


def _host_defined(case: str, wire: str) -> bool:
    return not (case == "nonfinite_large" and wire != "fp8")


def _xla_defined(case: str) -> bool:
    return case != "subnormal"  # XLA on the CPU flushes f32 subnormals


def _references(host: np.ndarray, wire: str, case: str):
    """(name, payload, scales) of every JAX-package path that divides by
    qmax as written, for this input."""
    refs = []
    if _host_defined(case, wire):
        refs.append(("host", *jq.quantize_blocks(host, wire=wire)))
    if _xla_defined(case):
        refs.append(("device", *jq.quantize_blocks_device(jnp.asarray(host), wire=wire)))
    return refs


def _compiled_semantics(blocks: torch.Tensor, wire: str):
    """What XLA-compiled code computes: the port's codec with the scale
    taken as ``maxabs * f32(1/qmax)`` (the rewrite of ``maxabs / qmax``)."""
    maxabs = blocks.abs().amax(dim=1)
    recip = torch.tensor(1.0 / tq._WIRE_QMAX[wire], dtype=torch.float32)
    scales = torch.where(maxabs > 0, maxabs * recip, torch.ones(()))
    scaled = blocks / scales[:, None]
    if wire == "fp8":
        return tq._to_fp8(scaled, blocks), scales
    values = tq._to_int8(torch.round(scaled))
    return (tq._pack_int4(values) if wire == "int4" else values), scales


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("case", CASES)
def test_quantize_is_byte_equal_to_every_jax_path(case, wire):
    host = _case(case)
    x = torch.from_numpy(host)
    ported = {
        "host codec": tq.quantize_blocks(x, wire=wire),
        "device codec": tq.quantize_blocks_device(x, wire=wire),
    }
    if wire != "int4":
        ported["B1 plain"] = tq.quantize_blocks_kernel(tq._as_blocks(x), wire)
    for ref_name, ref_payload, ref_scales in _references(host, wire, case):
        for name, (payload, scales) in ported.items():
            np.testing.assert_array_equal(
                _bytes(payload), _bytes(ref_payload), err_msg=f"{name} vs {ref_name} payload"
            )
            np.testing.assert_array_equal(
                scales.numpy().view(np.uint32), np.asarray(ref_scales).view(np.uint32),
                err_msg=f"{name} vs {ref_name} scales",
            )


@pytest.mark.parametrize("case", ["nonfinite_small", "nonfinite_large"])
def test_fp8_nan_sign_does_not_depend_on_the_division(case):
    """The x86 host's division keeps a NaN input's sign and gives invalid
    divisions (inf/inf) a negative NaN; CUDA's gives a positive NaN in both
    cases. The fp8 cast takes the sign from the rule, so a quotient whose
    NaNs are all positive, as on the card, gives the JAX host's bytes."""
    host = _case(case)
    blocks = tq._as_blocks(torch.from_numpy(host))
    scales = tq._scales(blocks.abs().amax(dim=1), "fp8")
    scaled = blocks / scales[:, None]
    nan = torch.isnan(scaled)
    assert bool(nan.any())
    as_on_cuda = torch.where(nan, (scaled.view(torch.int32) & 0x7FFFFFFF).view(torch.float32), scaled)
    assert not bool(torch.signbit(as_on_cuda[nan]).any())
    ref_payload, _ = jq.quantize_blocks(host, wire="fp8")
    np.testing.assert_array_equal(_bytes(tq._to_fp8(as_on_cuda, blocks)), _bytes(ref_payload))
    np.testing.assert_array_equal(_bytes(tq._to_fp8(scaled, blocks)), _bytes(ref_payload))


@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("case", [c for c in CASES if _xla_defined(c)])
def test_pallas_kernel_differs_only_by_xla_reciprocal(case, wire):
    blocks = tq._as_blocks(torch.from_numpy(_case(case)))
    ref_payload, ref_scales = jq.quantize_blocks_pallas(
        jnp.asarray(blocks.numpy()), interpret=True, wire=wire
    )
    want_payload, want_scales = _compiled_semantics(blocks, wire)
    np.testing.assert_array_equal(_bytes(want_payload), _bytes(ref_payload))
    np.testing.assert_array_equal(want_scales.numpy(), np.asarray(ref_scales))
    # ... and the port's own scales are within one ulp of those.
    _, scales = tq.quantize_blocks_kernel(blocks, wire)
    ulps = scales.numpy().view(np.int32).astype(np.int64) - np.asarray(ref_scales).view(
        np.int32
    ).astype(np.int64)
    assert np.abs(ulps).max() <= 1


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("case", CASES)
def test_dequantize_matches_every_jax_path(case, wire):
    host = _case(case)
    if _xla_defined(case):
        ref_payload, ref_scales = jq.quantize_blocks_device(jnp.asarray(host), wire=wire)
    else:
        ref_payload, ref_scales = jq.quantize_blocks(host, wire=wire)
    payload = torch.from_numpy(_bytes(ref_payload).copy()).view(tq._WIRE_DTYPES[wire])
    scales = torch.from_numpy(np.asarray(ref_scales).copy())
    if _xla_defined(case):
        want = np.asarray(jq.dequantize_blocks_device(ref_payload, ref_scales))
        np.testing.assert_array_equal(tq.dequantize_blocks_device(payload, scales).numpy(), want)
    if wire != "int4" and _xla_defined(case):
        np.testing.assert_array_equal(
            tq.dequantize_blocks_kernel(payload, scales).numpy(),
            np.asarray(jq.dequantize_blocks_pallas(ref_payload, ref_scales, interpret=True)),
        )
    if _host_defined(case, wire):
        host_payload = np.asarray(ref_payload).view(jq._WIRE_NP_DTYPES[wire])
        np.testing.assert_array_equal(
            tq.dequantize_blocks(payload, scales, host.shape, torch.float32).numpy(),
            jq.dequantize_blocks(host_payload, np.asarray(ref_scales), host.shape, np.float32),
        )


@pytest.mark.parametrize("wire", WIRES)
def test_reduce_pack_and_unpack_are_byte_equal(wire):
    rng = np.random.default_rng(3)
    ranks = [rng.normal(0, s, 3 * BLOCK).astype(np.float32) for s in (1.0, 5.0, 0.01)]
    ref = [jq.quantize_blocks(r, wire=wire) for r in ranks]
    port = [tq.quantize_blocks(torch.from_numpy(r), wire=wire) for r in ranks]
    ref_payload, ref_scales = jq.reduce_quantized([p for p, _ in ref], [s for _, s in ref])
    payload, scales = tq.reduce_quantized([p for p, _ in port], [s for _, s in port])
    np.testing.assert_array_equal(_bytes(payload), _bytes(ref_payload))
    np.testing.assert_array_equal(scales.numpy(), ref_scales)

    buf = tq.pack_arrays(payload, scales)
    ref_buf = jq.pack_arrays(ref_payload, ref_scales)
    np.testing.assert_array_equal(buf.numpy(), ref_buf)
    back_payload, back_scales = tq.unpack_arrays(buf, 3, wire=wire)
    assert back_payload.dtype == payload.dtype
    np.testing.assert_array_equal(_bytes(back_payload), _bytes(payload))
    np.testing.assert_array_equal(back_scales.numpy(), scales.numpy())
    other = "int8" if wire == "fp8" else "fp8"
    with pytest.raises(ValueError, match="wire format mismatch"):
        tq.unpack_arrays(buf, 3, wire=other)


@pytest.mark.parametrize("wire", ["fp8", "int8"])
def test_tree_codec_matches_jax(wire):
    rng = np.random.default_rng(5)
    shapes = [(4, 64), (256,), (3, 100)]  # the last is ragged
    leaves = [rng.normal(0, 2.0, s).astype(np.float32) for s in shapes]
    jquant, jdequant = jq.make_tree_fp8_codec([jnp.asarray(x) for x in leaves], wire=wire)
    tquant, tdequant = tq.make_tree_fp8_codec([torch.from_numpy(x) for x in leaves], wire=wire)
    flat = torch.cat([torch.from_numpy(x).reshape(-1) for x in leaves])
    payload, scales = tquant([torch.from_numpy(x) for x in leaves])
    host_payload, host_scales = tq.quantize_blocks(flat, wire=wire)
    np.testing.assert_array_equal(_bytes(payload), _bytes(host_payload))
    np.testing.assert_array_equal(scales.numpy(), host_scales.numpy())
    # The JAX codec is jitted: its scales take the reciprocal rewrite.
    ref_payload, ref_scales = jquant([jnp.asarray(x) for x in leaves])
    want_payload, want_scales = _compiled_semantics(tq._as_blocks(flat), wire)
    np.testing.assert_array_equal(_bytes(want_payload), _bytes(ref_payload))
    np.testing.assert_array_equal(want_scales.numpy(), np.asarray(ref_scales))
    # Dequantizing the same wire bytes gives the same leaves.
    same_payload = torch.from_numpy(_bytes(ref_payload).copy()).view(tq._WIRE_DTYPES[wire])
    same_scales = torch.from_numpy(np.asarray(ref_scales).copy())
    for got, want in zip(tdequant(same_payload, same_scales), jdequant(ref_payload, ref_scales)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_wrappers_raise_on_what_they_do_not_take():
    blocks = torch.zeros(2, BLOCK)
    with pytest.raises(ValueError, match="fp8' or 'int8"):
        tq.quantize_blocks_kernel(blocks, "int4")
    with pytest.raises(ValueError, match="fp8 or int8"):
        tq.dequantize_blocks_kernel(torch.zeros(2, BLOCK // 2, dtype=torch.uint8), torch.ones(2))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tq._check_cuda(blocks, "quantize_blocks", torch.float32, (2, BLOCK))
    before = dict(tq.launches)
    tq.quantize_blocks_kernel(blocks, "fp8")
    tq.dequantize_blocks_kernel(*tq.quantize_blocks_kernel(blocks, "int8"))
    assert tq.launches == before  # the CPU path launches nothing
