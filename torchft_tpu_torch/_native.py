"""Builds and loads the native coordination plane without protobuf's C++ side.

The plane is the JAX package's C++ lighthouse, manager server, KV store and
collective engine (``native/src/*.cc``), compiled unchanged. Those sources
reach protobuf only through ``#include "tpuft.pb.h"``; here that header and
its ``.cc`` are generated from ``native/proto/tpuft.proto`` by
:mod:`torchft_tpu_torch._protogen`, over the wire helpers in
``csrc/native_pb/pb_wire.h``, so the build needs g++ and nothing else (no
protobuf library, headers, ``protoc`` or cmake).

The library lands in ``build/torch_native/`` under a name keyed by a hash
of every source and the flags. Several processes may ask for it at once
(pytest workers, the groups of a chip run): the build runs under a file
lock and appears under its final name by an atomic rename. Clients speak
the framed RPC from Python (:mod:`torchft_tpu_torch.coordination`); only
server lifecycles and the collective engine cross the C ABI.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

from torchft_tpu_torch import _protogen

__all__ = ["load", "ensure_built", "library_path", "last_error", "reserialize", "build_log"]

_PACKAGE = Path(__file__).resolve().parent
_REPO = _PACKAGE.parent
NATIVE_SRC = _REPO / "native" / "src"
PROTO = _REPO / "native" / "proto" / "tpuft.proto"
PB_DIR = _PACKAGE / "csrc" / "native_pb"
BUILD_DIR = _REPO / "build" / "torch_native"
# -Bsymbolic (a link flag, ignored by -c) binds the library's own C++
# symbols to itself, so it can share a process with the JAX package's build
# of the same sources.
CXX_FLAGS: List[str] = ["-std=c++17", "-O2", "-fPIC", "-pthread", "-Wl,-Bsymbolic"]

_lib = None
_lib_lock = threading.Lock()
# Seconds of the build made by this process, if it made one.
build_log: Dict[str, float] = {}


def _sources() -> List[Path]:
    return sorted(NATIVE_SRC.glob("*.cc")) + sorted(NATIVE_SRC.glob("*.h")) + [
        PROTO, PB_DIR / "pb_wire.h", Path(_protogen.__file__),
    ]


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in _sources():
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libtpuft-{digest.hexdigest()[:16]}.so"


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native coordination plane cannot be built")
    return gxx


def _build(target: Path) -> None:
    gxx = _gxx()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        work = Path(tmp)
        for name, text in _protogen.generate(_protogen.parse_proto(PROTO.read_text())).items():
            (work / name).write_text(text)
        sources = sorted(NATIVE_SRC.glob("*.cc")) + [work / "tpuft.pb.cc"]
        includes = [f"-I{work}", f"-I{PB_DIR}", f"-I{NATIVE_SRC}"]
        # One compiler per source, all at once, then one link.
        procs = [
            (src, subprocess.Popen(
                [gxx, *CXX_FLAGS, *includes, "-c", str(src), "-o", str(work / f"{src.name}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in sources
        ]
        failed = []
        for src, proc in procs:
            output, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"{src}:\n{output}")
        if failed:
            raise RuntimeError("g++ failed on the native plane:\n" + "\n".join(failed))
        linked = work / "libtpuft.so"
        proc = subprocess.run(
            [gxx, "-shared", *CXX_FLAGS, "-o", str(linked),
             *(str(work / f"{src.name}.o") for src in sources)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"linking the native plane failed:\n{proc.stdout}{proc.stderr}")
        linked.replace(target)
    build_log["seconds"] = time.perf_counter() - start


def ensure_built() -> Path:
    """The library for the current sources, built first if missing."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not target.exists():  # another process may have built it meanwhile
                _build(target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def load() -> ctypes.CDLL:
    """Loads (building if needed) and declares the library's C functions."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(ensure_built()))
        c_void_p, c_char_p, c_int, c_int64, c_uint64 = (
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64,
        )
        lib.tpuft_last_error.restype = c_char_p

        lib.tpuft_lighthouse_new.restype = c_void_p
        lib.tpuft_lighthouse_new.argtypes = [c_char_p, c_uint64, c_uint64, c_uint64, c_uint64]
        lib.tpuft_manager_new.restype = c_void_p
        lib.tpuft_manager_new.argtypes = [
            c_char_p,  # replica_id
            c_char_p,  # lighthouse_addr
            c_char_p,  # hostname
            c_char_p,  # bind
            c_char_p,  # store_addr
            c_uint64,  # world_size
            c_uint64,  # heartbeat_interval_ms
            c_uint64,  # connect_timeout_ms
            c_int64,  # quorum_retries
            c_int,  # exit_on_kill
        ]
        lib.tpuft_store_new.restype = c_void_p
        lib.tpuft_store_new.argtypes = [c_char_p]
        for kind in ("lighthouse", "manager", "store"):
            address = getattr(lib, f"tpuft_{kind}_address")
            address.restype = c_int
            address.argtypes = [c_void_p, c_char_p, c_int]
            getattr(lib, f"tpuft_{kind}_shutdown").argtypes = [c_void_p]
            getattr(lib, f"tpuft_{kind}_free").argtypes = [c_void_p]

        lib.tpuft_collective_new.restype = c_void_p
        lib.tpuft_collective_last_error.restype = c_char_p
        lib.tpuft_collective_last_error.argtypes = [c_void_p]
        lib.tpuft_collective_configure.argtypes = [
            c_void_p, c_char_p, c_char_p, c_int, c_int, c_int64,
        ]
        lib.tpuft_collective_shutdown.argtypes = [c_void_p]
        lib.tpuft_collective_free.argtypes = [c_void_p]
        lib.tpuft_collective_allreduce.argtypes = [
            c_void_p, c_void_p, c_uint64, c_int, c_int, c_int64,
        ]
        lib.tpuft_collective_allgather.argtypes = [
            c_void_p, c_void_p, c_void_p, c_uint64, c_int, c_int64,
        ]
        lib.tpuft_collective_broadcast.argtypes = [
            c_void_p, c_void_p, c_uint64, c_int, c_int, c_int64,
        ]
        lib.tpuft_collective_alltoall.argtypes = [
            c_void_p, c_void_p, c_void_p, c_uint64, c_int, c_int64,
        ]
        lib.tpuft_collective_barrier.argtypes = [c_void_p, c_int64]

        lib.tpuft_pb_reserialize.restype = c_int
        lib.tpuft_pb_reserialize.argtypes = [c_char_p, c_char_p, c_int, c_char_p, c_int]
        _lib = lib
        return _lib


def last_error() -> str:
    err = load().tpuft_last_error()
    return err.decode() if err else "unknown native error"


def reserialize(message_type: str, data: bytes) -> bytes:
    """Parses ``data`` as ``message_type`` with the generated classes and
    serializes it again (a test entry point for the generated code)."""
    out = ctypes.create_string_buffer(2 * len(data) + 64)
    n = load().tpuft_pb_reserialize(message_type.encode(), data, len(data), out, len(out))
    if n == -2:
        raise KeyError(f"no message type {message_type!r}")
    if n < 0:
        raise ValueError(f"{message_type}: the generated parser rejected the bytes ({n})")
    return out.raw[:n]
