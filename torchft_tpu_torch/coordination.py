"""Python surface of the tpuft coordination plane (counterpart of
torchft_tpu/coordination.py, copied and adapted).

Servers (``LighthouseServer``, ``ManagerServer``) are the native C++
implementations embedded via ctypes, built by :mod:`torchft_tpu_torch._native`
without protobuf's C++ side; upstream torchft embeds its Rust servers the
same way via pyo3 (src/lib.rs:80-144, :593-668). Clients
(``ManagerClient``, ``LighthouseClient``) are pure Python speaking the framed
protobuf-over-TCP protocol (native/src/rpc.h) — the "low level API" surface of
the reference (upstream torchft torchft/coordination.py, _torchft.pyi).

All timeouts are float seconds.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import time
from dataclasses import dataclass, field
from typing import List, Optional

from torchft_tpu_torch import _native
from torchft_tpu_torch.proto import tpuft_pb2

__all__ = [
    "LighthouseServer",
    "ManagerServer",
    "LighthouseClient",
    "ManagerClient",
    "QuorumResult",
    "Quorum",
    "QuorumMember",
]

# Wire method ids — must match native/src/rpc.h.
LIGHTHOUSE_QUORUM = 1
LIGHTHOUSE_HEARTBEAT = 2
LIGHTHOUSE_STATUS = 3
LIGHTHOUSE_KILL_REPLICA = 4
MANAGER_QUORUM = 16
MANAGER_CHECKPOINT_METADATA = 17
MANAGER_SHOULD_COMMIT = 18
MANAGER_KILL = 19

_STATUS_OK = 0
_STATUS_ERROR = 1
_STATUS_TIMEOUT = 2
_STATUS_BAD_METHOD = 3
_STATUS_NOT_FOUND = 4

_REQ_MAGIC = ord("T")
_RESP_MAGIC = ord("R")


class _FramedClient:
    """Persistent-connection framed-RPC client (one in-flight call)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0) -> None:
        self._addr = addr
        self._connect_timeout = connect_timeout
        self._sock: Optional[socket.socket] = None

    @property
    def addr(self) -> str:
        return self._addr

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        host, _, port = self._addr.rpartition(":")
        host = host.strip("[]")
        sock = socket.create_connection((host, int(port)), timeout=self._connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        return sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _recv_exact(self, sock: socket.socket, n: int, deadline: float) -> bytes:
        chunks = []
        remaining = n
        while remaining > 0:
            sock.settimeout(max(0.001, deadline - time.monotonic()))
            chunk = sock.recv(remaining)
            if not chunk:
                raise ConnectionError(f"connection closed by {self._addr}")
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def call(self, method: int, payload: bytes, timeout: float) -> bytes:
        """One RPC round trip; raises TimeoutError / RuntimeError on failure."""
        deadline = time.monotonic() + timeout
        try:
            sock = self._connect()
            frame = struct.pack("!BBI", _REQ_MAGIC, method, len(payload)) + payload
            sock.settimeout(max(0.001, deadline - time.monotonic()))
            sock.sendall(frame)
        except (OSError, ConnectionError) as e:
            # Stale connection (e.g. server restart): redial once.
            self.close()
            try:
                sock = self._connect()
                sock.settimeout(max(0.001, deadline - time.monotonic()))
                sock.sendall(
                    struct.pack("!BBI", _REQ_MAGIC, method, len(payload)) + payload
                )
            except socket.timeout as e2:
                self.close()
                raise TimeoutError(f"send to {self._addr} timed out") from e2
            except (OSError, ConnectionError) as e2:
                self.close()
                raise RuntimeError(f"connect to {self._addr} failed: {e2}") from e
        try:
            header = self._recv_exact(sock, 6, deadline)
            magic, status, length = struct.unpack("!BBI", header)
            if magic != _RESP_MAGIC:
                raise ConnectionError("bad response magic")
            body = self._recv_exact(sock, length, deadline) if length else b""
        except socket.timeout as e:
            self.close()
            raise TimeoutError(f"rpc to {self._addr} timed out after {timeout}s") from e
        except (OSError, ConnectionError) as e:
            self.close()
            raise RuntimeError(f"rpc to {self._addr} failed: {e}") from e

        if status == _STATUS_OK:
            return body
        message = body.decode(errors="replace")
        if status == _STATUS_TIMEOUT:
            raise TimeoutError(message)
        if status == _STATUS_NOT_FOUND:
            raise LookupError(message)
        raise RuntimeError(message)


# ---------------------------------------------------------------------------
# Data classes mirroring the reference's pyo3 data surface (lib.rs:283-424).
# ---------------------------------------------------------------------------


@dataclass
class QuorumMember:
    replica_id: str
    address: str = ""
    store_address: str = ""
    step: int = 0
    world_size: int = 1
    shrink_only: bool = False
    commit_failures: int = 0
    data: str = ""

    @classmethod
    def _from_proto(cls, proto: tpuft_pb2.QuorumMember) -> "QuorumMember":
        return cls(
            replica_id=proto.replica_id,
            address=proto.address,
            store_address=proto.store_address,
            step=proto.step,
            world_size=proto.world_size,
            shrink_only=proto.shrink_only,
            commit_failures=proto.commit_failures,
            data=proto.data,
        )

    def _to_proto(self) -> tpuft_pb2.QuorumMember:
        return tpuft_pb2.QuorumMember(
            replica_id=self.replica_id,
            address=self.address,
            store_address=self.store_address,
            step=self.step,
            world_size=self.world_size,
            shrink_only=self.shrink_only,
            commit_failures=self.commit_failures,
            data=self.data,
        )


@dataclass
class Quorum:
    quorum_id: int
    participants: List[QuorumMember]
    created_unix_nanos: int = 0

    @classmethod
    def _from_proto(cls, proto: tpuft_pb2.Quorum) -> "Quorum":
        return cls(
            quorum_id=proto.quorum_id,
            participants=[QuorumMember._from_proto(p) for p in proto.participants],
            created_unix_nanos=proto.created.unix_nanos,
        )


@dataclass
class QuorumResult:
    """Per-rank recovery plan (reference: lib.rs:283-316)."""

    quorum_id: int = 0
    replica_rank: int = 0
    replica_world_size: int = 1
    recover_src_manager_address: str = ""
    recover_src_replica_rank: Optional[int] = None
    recover_dst_replica_ranks: List[int] = field(default_factory=list)
    store_address: str = ""
    max_step: int = 0
    max_rank: Optional[int] = None
    max_world_size: int = 1
    heal: bool = False
    commit_failures: int = 0
    quorum: Optional[Quorum] = None

    @classmethod
    def _from_proto(cls, resp: tpuft_pb2.ManagerQuorumResponse) -> "QuorumResult":
        return cls(
            quorum_id=resp.quorum_id,
            replica_rank=resp.replica_rank,
            replica_world_size=resp.replica_world_size,
            recover_src_manager_address=(
                resp.recover_src_manager_address
                if resp.HasField("recover_src_manager_address")
                else ""
            ),
            recover_src_replica_rank=(
                resp.recover_src_replica_rank
                if resp.HasField("recover_src_replica_rank")
                else None
            ),
            recover_dst_replica_ranks=list(resp.recover_dst_replica_ranks),
            store_address=resp.store_address,
            max_step=resp.max_step,
            max_rank=(
                resp.max_replica_rank if resp.HasField("max_replica_rank") else None
            ),
            max_world_size=resp.max_world_size,
            heal=resp.heal,
            commit_failures=resp.commit_failures,
            quorum=Quorum._from_proto(resp.quorum) if resp.HasField("quorum") else None,
        )


# ---------------------------------------------------------------------------
# Servers (native, via ctypes)
# ---------------------------------------------------------------------------


class LighthouseServer:
    """Embedded native Lighthouse (reference: lib.rs:593-668).

    Defaults follow the reference's embedded test server: short join timeout so
    in-process clusters converge fast.
    """

    def __init__(
        self,
        bind: str = "[::]:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 100,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
    ) -> None:
        lib = _native.load()
        self._lib = lib
        self._handle = lib.tpuft_lighthouse_new(
            bind.encode(),
            min_replicas,
            join_timeout_ms,
            quorum_tick_ms,
            heartbeat_timeout_ms,
        )
        if not self._handle:
            raise RuntimeError(f"failed to start lighthouse: {_native.last_error()}")

    def address(self) -> str:
        buf = ctypes.create_string_buffer(512)
        self._lib.tpuft_lighthouse_address(self._handle, buf, len(buf))
        return buf.value.decode()

    def shutdown(self) -> None:
        if self._handle:
            self._lib.tpuft_lighthouse_shutdown(self._handle)
            self._lib.tpuft_lighthouse_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.shutdown()
        except Exception:
            pass


class ManagerServer:
    """Embedded native per-replica-group manager (reference: lib.rs:80-144)."""

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        address: str = "",
        bind: str = "[::]:0",
        store_addr: str = "",
        world_size: int = 1,
        heartbeat_interval: float = 0.1,
        connect_timeout: float = 10.0,
        quorum_retries: int = 0,
        exit_on_kill: bool = True,
    ) -> None:
        lib = _native.load()
        self._lib = lib
        self._handle = lib.tpuft_manager_new(
            replica_id.encode(),
            lighthouse_addr.encode(),
            address.encode(),
            bind.encode(),
            store_addr.encode(),
            world_size,
            int(heartbeat_interval * 1000),
            int(connect_timeout * 1000),
            quorum_retries,
            1 if exit_on_kill else 0,
        )
        if not self._handle:
            raise RuntimeError(f"failed to start manager server: {_native.last_error()}")

    def address(self) -> str:
        buf = ctypes.create_string_buffer(512)
        self._lib.tpuft_manager_address(self._handle, buf, len(buf))
        return buf.value.decode()

    def shutdown(self) -> None:
        if self._handle:
            self._lib.tpuft_manager_shutdown(self._handle)
            self._lib.tpuft_manager_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.shutdown()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Clients (pure Python)
# ---------------------------------------------------------------------------


class LighthouseClient:
    """Direct lighthouse access (reference: lib.rs:476-591)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0) -> None:
        self._client = _FramedClient(addr, connect_timeout)

    def quorum(self, requester: QuorumMember, timeout: float = 60.0) -> Quorum:
        req = tpuft_pb2.LighthouseQuorumRequest(
            requester=requester._to_proto(), timeout_ms=int(timeout * 1000)
        )
        body = self._client.call(
            LIGHTHOUSE_QUORUM, req.SerializeToString(), timeout + 5.0
        )
        resp = tpuft_pb2.LighthouseQuorumResponse()
        resp.ParseFromString(body)
        return Quorum._from_proto(resp.quorum)

    def heartbeat(self, replica_id: str, timeout: float = 5.0) -> None:
        req = tpuft_pb2.LighthouseHeartbeatRequest(replica_id=replica_id)
        self._client.call(LIGHTHOUSE_HEARTBEAT, req.SerializeToString(), timeout)

    def status(self, timeout: float = 5.0) -> tpuft_pb2.LighthouseStatusResponse:
        req = tpuft_pb2.LighthouseStatusRequest()
        body = self._client.call(LIGHTHOUSE_STATUS, req.SerializeToString(), timeout)
        resp = tpuft_pb2.LighthouseStatusResponse()
        resp.ParseFromString(body)
        return resp

    def kill(self, replica_id: str, timeout: float = 10.0, mode: str = "exit") -> None:
        """Injects a fault into ``replica_id``'s manager. Modes (reference
        failure menu, examples/monarch/utils/failure.py:25-100): "exit"
        (process death), "segfault" (crash with core), "deadlock"
        (coordination wedges while heartbeats continue), "partition"
        (heartbeats and RPC serving stop, as if the host dropped off the
        network)."""
        req = tpuft_pb2.KillRequest(replica_id=replica_id, mode=mode)
        self._client.call(LIGHTHOUSE_KILL_REPLICA, req.SerializeToString(), timeout)

    def close(self) -> None:
        self._client.close()


class ManagerClient:
    """Client of a (possibly remote) ManagerServer (reference: lib.rs:146-281)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0) -> None:
        self._client = _FramedClient(addr, connect_timeout)

    @property
    def addr(self) -> str:
        return self._client.addr

    def _quorum(
        self,
        group_rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool,
        init_sync: bool,
        commit_failures: int,
        timeout: float,
    ) -> QuorumResult:
        req = tpuft_pb2.ManagerQuorumRequest(
            group_rank=group_rank,
            step=step,
            checkpoint_metadata=checkpoint_metadata,
            shrink_only=shrink_only,
            init_sync=init_sync,
            commit_failures=commit_failures,
            timeout_ms=int(timeout * 1000),
        )
        body = self._client.call(MANAGER_QUORUM, req.SerializeToString(), timeout + 5.0)
        resp = tpuft_pb2.ManagerQuorumResponse()
        resp.ParseFromString(body)
        return QuorumResult._from_proto(resp)

    def _checkpoint_metadata(self, rank: int, timeout: float) -> str:
        req = tpuft_pb2.CheckpointMetadataRequest(
            group_rank=rank, timeout_ms=int(timeout * 1000)
        )
        body = self._client.call(
            MANAGER_CHECKPOINT_METADATA, req.SerializeToString(), timeout
        )
        resp = tpuft_pb2.CheckpointMetadataResponse()
        resp.ParseFromString(body)
        return resp.checkpoint_metadata

    def should_commit(
        self, group_rank: int, step: int, should_commit: bool, timeout: float
    ) -> bool:
        req = tpuft_pb2.ShouldCommitRequest(
            group_rank=group_rank,
            step=step,
            should_commit=should_commit,
            timeout_ms=int(timeout * 1000),
        )
        body = self._client.call(
            MANAGER_SHOULD_COMMIT, req.SerializeToString(), timeout + 5.0
        )
        resp = tpuft_pb2.ShouldCommitResponse()
        resp.ParseFromString(body)
        return resp.should_commit

    def close(self) -> None:
        self._client.close()
