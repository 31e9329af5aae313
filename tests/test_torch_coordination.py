"""The port's coordination plane: its protobuf-free messages, its servers
and clients beside the JAX package's, and its native process group.

The port builds ``native/src`` unchanged against message classes that
``torchft_tpu_torch._protogen`` generates from ``native/proto/tpuft.proto``.
Their bytes are held to ``google.protobuf``'s for every message type
(parse the Python bytes, serialize again, compare), and a mixed fleet (a
lighthouse of one package, manager servers and clients of both) must form
a quorum and commit.

Every thread join and RPC here has its own timeout, so a fault fails the
test instead of hanging the suite.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, List

import numpy as np
import pytest
import torch
from google.protobuf import descriptor as gdesc

from torchft_tpu import coordination as jcoord
from torchft_tpu.parallel import store as jstore
from torchft_tpu_torch import _native, _protogen
from torchft_tpu_torch import coordination as tcoord
from torchft_tpu_torch.parallel import store as tstore
from torchft_tpu_torch.parallel.native_pg import ProcessGroupNative
from torchft_tpu_torch.parallel.process_group import ReduceOp
from torchft_tpu_torch.proto import tpuft_pb2

torch.set_num_threads(1)

JOIN_TIMEOUT = 60.0
FD = gdesc.FieldDescriptor


def _value(rng: random.Random, fd):
    if fd.type == FD.TYPE_INT64:
        return rng.choice([1, -1, 2**63 - 1, -(2**63), rng.randint(-(2**40), 2**40)])
    if fd.type == FD.TYPE_UINT64:
        return rng.choice([1, 2**64 - 1, rng.randint(0, 2**40)])
    if fd.type == FD.TYPE_BOOL:
        return True
    if fd.type == FD.TYPE_DOUBLE:
        return rng.choice([-0.0, 1.5, -1e300, float("inf"), 5e-324])
    if fd.type == FD.TYPE_STRING:
        return rng.choice(["a", "héllo wörld" * rng.randint(1, 40)])
    if fd.type == FD.TYPE_BYTES:
        return bytes(rng.randrange(256) for _ in range(rng.randint(1, 300)))
    raise AssertionError(f"no generator for field type {fd.type}")


def _fill(message, rng: random.Random, depth: int = 0) -> None:
    """Random values in a random subset of fields (defaults included)."""
    for fd in message.DESCRIPTOR.fields:
        if rng.random() < 0.25:
            continue
        if fd.type == FD.TYPE_MESSAGE:
            if fd.is_repeated:
                for _ in range(rng.randint(0, 3)):
                    _fill(getattr(message, fd.name).add(), rng, depth + 1)
            else:
                getattr(message, fd.name).SetInParent()
                _fill(getattr(message, fd.name), rng, depth + 1)
        elif fd.is_repeated:
            getattr(message, fd.name).extend(_value(rng, fd) for _ in range(rng.randint(0, 4)))
        elif rng.random() < 0.2 and fd.type != FD.TYPE_MESSAGE:
            setattr(message, fd.name, type(_value(rng, fd))())  # a default value
        else:
            setattr(message, fd.name, _value(rng, fd))


MESSAGES = sorted(tpuft_pb2.DESCRIPTOR.message_types_by_name)


def test_generator_reads_the_schema_as_protobuf_does():
    schema = _protogen.parse_proto(_native.PROTO.read_text())
    assert sorted(m.name for m in schema.messages) == MESSAGES
    for message in schema.messages:
        desc = tpuft_pb2.DESCRIPTOR.message_types_by_name[message.name]
        got = [(f.name, f.number, f.label) for f in message.fields]
        want = [
            (fd.name, fd.number,
             "repeated" if fd.is_repeated
             else "optional" if fd.has_presence and fd.type != FD.TYPE_MESSAGE else "")
            for fd in sorted(desc.fields, key=lambda fd: fd.number)
        ]
        assert got == want, message.name
    for bad in ("enum E { A = 0; }",
                "message A { map<string, int64> m = 1; }",
                "message A { oneof x { int64 a = 1; } }",
                "message A { message B { int64 b = 1; } }",
                "message A { sint64 a = 1; }"):
        with pytest.raises(ValueError):
            _protogen.parse_proto('syntax = "proto3"; package p; ' + bad)


@pytest.mark.parametrize("name", MESSAGES)
def test_generated_messages_write_protobufs_bytes(name):
    rng = random.Random(name)
    cls = getattr(tpuft_pb2, name)
    for _ in range(25):
        message = cls()
        _fill(message, rng)
        data = message.SerializeToString()
        assert _native.reserialize(name, data) == data
    # Unknown fields are skipped; unpacked repeated numbers are accepted.
    extra = b"\xf8\x07\x05" + b"\xfa\x07\x03abc"  # fields 127 (varint) and 127 (bytes)
    assert _native.reserialize(name, extra + cls().SerializeToString()) == b""
    with pytest.raises(ValueError):
        _native.reserialize(name, b"\x0a\x05ab")  # a length past the end


def test_unpacked_repeated_numbers_parse():
    packed = tpuft_pb2.ManagerQuorumResponse(recover_dst_replica_ranks=[3, -1, 7])
    unpacked = b"".join(b"\x38" + _varint(v) for v in (3, -1, 7))
    assert _native.reserialize("ManagerQuorumResponse", unpacked) == packed.SerializeToString()


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte, value = value & 0x7F, value >> 7
        out.append(byte | (0x80 if value else 0))
        if not value:
            return bytes(out)


def _run_threads(fns: List[Callable[[], object]]) -> List[object]:
    results: Dict[int, object] = {}
    errors: Dict[int, BaseException] = {}

    def run(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive(), "a group thread did not finish in time"
    if errors:
        raise next(iter(errors.values()))
    return [results[i] for i in range(len(fns))]


@pytest.mark.parametrize("lighthouse_side", ["jax", "port"])
def test_mixed_fleet_forms_a_quorum_and_commits(lighthouse_side):
    """One manager server of each package; each is driven by the other
    package's client; the lighthouse is one package's."""
    servers_of = {"jax": jcoord, "port": tcoord}
    clients_of = {"jax": tcoord, "port": jcoord}
    lighthouse = servers_of[lighthouse_side].LighthouseServer(
        bind="[::]:0", min_replicas=2, join_timeout_ms=100
    )
    managers, clients = [], []
    try:
        for i, side in enumerate(("jax", "port")):
            managers.append(servers_of[side].ManagerServer(
                replica_id=f"{side}{i}", lighthouse_addr=lighthouse.address(),
                store_addr=f"localhost:{1000 + i}", world_size=1, exit_on_kill=False,
            ))
            clients.append(clients_of[side].ManagerClient(managers[-1].address()))

        def group(client):
            def run():
                result = client._quorum(
                    group_rank=0, step=0, checkpoint_metadata="", shrink_only=False,
                    init_sync=False, commit_failures=0, timeout=20.0,
                )
                committed = client.should_commit(0, 0, True, timeout=20.0)
                return result, committed
            return run

        (r0, c0), (r1, c1) = _run_threads([group(c) for c in clients])
        assert c0 and c1
        assert r0.quorum_id == r1.quorum_id and r0.replica_world_size == 2
        assert {r0.replica_rank, r1.replica_rank} == {0, 1}
        assert not r0.heal and not r1.heal and r0.max_world_size == 2
        assert {m.replica_id.split(":")[0] for m in r0.quorum.participants} == {"jax0", "port1"}
        status_client = clients_of[lighthouse_side].LighthouseClient(lighthouse.address())
        status = status_client.status(timeout=10.0)
        status_client.close()
        assert status.has_quorum and len(status.members) == 2
        assert all(m.heartbeat_age_ms >= 0 for m in status.members)
    finally:
        for client in clients:
            client.close()
        for manager in managers:
            manager.shutdown()
        lighthouse.shutdown()


def test_store_speaks_to_the_other_packages_client():
    server = tstore.StoreServer()
    client = jstore.create_store_client(f"{server.address()}/prefix")
    try:
        client.set("k", b"\x00\xffvalue")
        assert client.get("k", timeout=5.0) == b"\x00\xffvalue"
        assert client.add("n", 5) == 5 and client.add("n", -7) == -2
        assert client.get("missing", wait=False) is None
        assert tstore.create_store_client(f"{server.address()}/prefix").get("k") == b"\x00\xffvalue"
    finally:
        client.close()
        server.shutdown()


def test_native_process_group_collectives():
    server = tstore.StoreServer()
    pgs = [ProcessGroupNative(timeout=20.0) for _ in range(2)]
    try:
        _run_threads([
            lambda r=r: pgs[r].configure(f"{server.address()}/pg", f"r{r}", r, 2)
            for r in range(2)
        ])
        data = [torch.arange(5, dtype=torch.float32) * (r + 1) for r in range(2)]
        bf16 = [torch.tensor([1.5, -2.0, 3.0], dtype=torch.bfloat16) * (r + 1) for r in range(2)]

        def ops(r):
            def run():
                summed = pgs[r].allreduce([data[r], bf16[r]], ReduceOp.SUM).wait(20)
                gathered = pgs[r].allgather(
                    [torch.full((r + 1, 2), r, dtype=torch.int64),
                     torch.tensor([r], dtype=torch.uint8)]
                ).wait(20)
                swapped = pgs[r].alltoall(
                    [torch.tensor([10 * r + d], dtype=torch.uint8) for d in range(2)]
                ).wait(20)
                root_data = pgs[r].broadcast([torch.full((3,), float(r))], root=1).wait(20)
                pgs[r].barrier().wait(20)
                return summed, gathered, swapped, root_data
            return run

        out = _run_threads([ops(0), ops(1)])
        for r, (summed, gathered, swapped, root_data) in enumerate(out):
            assert root_data[0].tolist() == [1.0, 1.0, 1.0]
            torch.testing.assert_close(summed[0], data[0] + data[1], rtol=0, atol=0)
            assert summed[1].dtype == torch.bfloat16
            torch.testing.assert_close(summed[1], bf16[0] + bf16[1], rtol=0, atol=0)
            assert [g[0].shape for g in gathered] == [(1, 2), (2, 2)]
            assert [int(g[1]) for g in gathered] == [0, 1]
            assert [int(s) for s in swapped] == [r, 10 + r]
        assert np.array_equal(out[0][0][0].numpy(), out[1][0][0].numpy())
    finally:
        for pg in pgs:
            pg.shutdown()
        server.shutdown()


@pytest.mark.parametrize("wire", ["fp8", "int8", "int4"])
def test_quantized_allreduce_gives_the_jax_packages_bytes(wire):
    """Two ranks of each package average the same arrays through the
    quantized wire; results are equal to the bit (host codec on both)."""
    from torchft_tpu.ops import quantization as jq
    from torchft_tpu.parallel import collectives as jcol
    from torchft_tpu.parallel import native_pg as jpg
    from torchft_tpu.parallel.process_group import ReduceOp as JReduceOp
    from torchft_tpu_torch.parallel import collectives as tcol

    rng = np.random.default_rng(11)
    arrays = [[rng.normal(0, s, n).astype(np.float32) for s, n in ((1.0, 700), (30.0, 1024))]
              for _ in range(2)]
    payload_in = [jq.quantize_blocks(a[1], wire=wire) for a in arrays]

    def run(pg_cls, allreduce, wire_allreduce, to_input, op):
        server = tstore.StoreServer()
        pgs = [pg_cls(timeout=20.0) for _ in range(2)]
        try:
            _run_threads([lambda r=r: pgs[r].configure(f"{server.address()}/q", f"r{r}", r, 2)
                          for r in range(2)])
            return _run_threads([
                lambda r=r: (
                    allreduce([to_input(a) for a in arrays[r]], op, pgs[r], wire).wait(20),
                    wire_allreduce(*map(to_input, payload_in[r]), op, pgs[r]).wait(20),
                )
                for r in range(2)
            ])
        finally:
            for pg in pgs:
                pg.shutdown()
            server.shutdown()

    ref = run(jpg.ProcessGroupNative, jcol.allreduce_quantized, jcol.allreduce_quantized_wire,
              lambda a: a, JReduceOp.AVG)
    got = run(ProcessGroupNative, tcol.allreduce_quantized, tcol.allreduce_quantized_wire,
              _as_torch, ReduceOp.AVG)
    for (ref_out, ref_wire), (out, wire_out) in zip(ref, got):
        for want, have in zip(ref_out, out):
            np.testing.assert_array_equal(have.numpy(), want)
        np.testing.assert_array_equal(
            wire_out[0].contiguous().view(torch.uint8).numpy(), np.asarray(ref_wire[0]).view(np.uint8)
        )
        np.testing.assert_array_equal(wire_out[1].numpy(), ref_wire[1])


def _as_torch(array: np.ndarray) -> torch.Tensor:
    """numpy -> torch, fp8 (an ml_dtypes type torch cannot take) by its bytes."""
    if array.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(array.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(array))


def test_process_group_wrappers():
    from torchft_tpu_torch.parallel.process_group import (
        ErrorSwallowingProcessGroupWrapper,
        ManagedProcessGroup,
        ProcessGroupDummy,
    )
    from torchft_tpu_torch.work import Work

    dummy = ProcessGroupDummy()
    x = torch.arange(4.0)
    assert torch.equal(dummy.allreduce([x]).wait()[0], x)
    assert dummy.op_counts == {"allreduce": 1} and dummy.size() == 1

    class Failing(ProcessGroupDummy):
        def allreduce(self, tensors, op=ReduceOp.SUM):
            return Work.failed(RuntimeError("link down"))

    wrapped = ErrorSwallowingProcessGroupWrapper(Failing())
    assert torch.equal(wrapped.allreduce([x]).wait()[0], x)  # the input comes back
    assert "link down" in str(wrapped.errored())
    assert torch.equal(wrapped.allreduce([x + 1]).wait()[0], x + 1)  # skipped while errored
    wrapped.configure("addr/prefix", "r", 0, 1)
    assert wrapped.errored() is None

    class FakeManager:
        _pg = dummy

        def allreduce(self, tensor, reduce_op=ReduceOp.AVG):
            return Work.completed((reduce_op, tensor * 2))

        def num_participants(self):
            return 3

    managed = ManagedProcessGroup(FakeManager())
    (op, doubled), = managed.allreduce([x]).wait()
    assert op == ReduceOp.AVG and torch.equal(doubled, x * 2) and managed.size() == 3
    with pytest.raises(ValueError, match="SUM/AVG"):
        managed.allreduce([x], ReduceOp.MAX)
