"""Rendezvous store: the config/coordination KV plane.

Fills the role torch's TCPStore plays in the reference (one per replica
group, prefixed per quorum: upstream torchft torchft/process_group.py:111-130,
manager.py:319-325, :670-674). The server is native C++ (native/src/store.cc)
embedded via ctypes; clients speak the framed protocol.

Address convention (mirrors the reference's ``create_store_client``):
``"host:port/prefix"`` — the prefix namespaces keys so each quorum round gets
a fresh keyspace on the same server.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from torchft_tpu_torch import _native
from torchft_tpu_torch.coordination import _FramedClient
from torchft_tpu_torch.proto import tpuft_pb2

__all__ = ["StoreServer", "StoreClient", "create_store_client"]

_STORE_SET = 32
_STORE_GET = 33
_STORE_ADD = 34
_STORE_DELETE = 35


class StoreServer:
    """Embedded native KV store server."""

    def __init__(self, bind: str = "[::]:0") -> None:
        lib = _native.load()
        self._lib = lib
        self._handle = lib.tpuft_store_new(bind.encode())
        if not self._handle:
            raise RuntimeError(f"failed to start store: {_native.last_error()}")

    def address(self) -> str:
        buf = ctypes.create_string_buffer(512)
        self._lib.tpuft_store_address(self._handle, buf, len(buf))
        return buf.value.decode()

    def shutdown(self) -> None:
        if self._handle:
            self._lib.tpuft_store_shutdown(self._handle)
            self._lib.tpuft_store_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.shutdown()
        except Exception:
            pass


class StoreClient:
    """KV client with optional key prefix. Thread-compatible per instance."""

    def __init__(self, addr: str, prefix: str = "", connect_timeout: float = 10.0) -> None:
        self._client = _FramedClient(addr, connect_timeout)
        self._prefix = prefix.rstrip("/")

    def _key(self, key: str) -> str:
        return f"{self._prefix}/{key}" if self._prefix else key

    def set(self, key: str, value: bytes, timeout: float = 10.0) -> None:
        req = tpuft_pb2.StoreSetRequest(key=self._key(key), value=value)
        self._client.call(_STORE_SET, req.SerializeToString(), timeout)

    def get(self, key: str, timeout: float = 60.0, wait: bool = True) -> Optional[bytes]:
        """Returns the value; blocks until set when ``wait``. None if absent
        and not waiting; raises TimeoutError on wait timeout."""
        req = tpuft_pb2.StoreGetRequest(
            key=self._key(key), wait=wait, timeout_ms=int(timeout * 1000)
        )
        body = self._client.call(_STORE_GET, req.SerializeToString(), timeout + 5.0)
        resp = tpuft_pb2.StoreGetResponse()
        resp.ParseFromString(body)
        return resp.value if resp.found else None

    def add(self, key: str, delta: int = 1, timeout: float = 10.0) -> int:
        """Atomically adds ``delta`` to a counter; returns the new value."""
        req = tpuft_pb2.StoreAddRequest(key=self._key(key), delta=delta)
        body = self._client.call(_STORE_ADD, req.SerializeToString(), timeout)
        resp = tpuft_pb2.StoreAddResponse()
        resp.ParseFromString(body)
        return resp.value

    def delete(self, key: str, timeout: float = 10.0) -> bool:
        req = tpuft_pb2.StoreDeleteRequest(key=self._key(key))
        body = self._client.call(_STORE_DELETE, req.SerializeToString(), timeout)
        resp = tpuft_pb2.StoreDeleteResponse()
        resp.ParseFromString(body)
        return resp.deleted

    def sub_store(self, prefix: str) -> "StoreClient":
        """A new client sharing the server but nesting the key prefix."""
        sub = StoreClient.__new__(StoreClient)
        sub._client = _FramedClient(self._client.addr, self._client._connect_timeout)
        sub._prefix = self._key(prefix)
        return sub

    def close(self) -> None:
        self._client.close()


def create_store_client(store_addr: str, connect_timeout: float = 10.0) -> StoreClient:
    """Parses ``"host:port/prefix"`` into a prefixed client (reference:
    process_group.py:111-130)."""
    if "/" in store_addr:
        hostport, _, prefix = store_addr.partition("/")
    else:
        hostport, prefix = store_addr, ""
    return StoreClient(hostport, prefix, connect_timeout)
