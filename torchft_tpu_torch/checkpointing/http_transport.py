"""HTTP checkpoint transport (counterpart of
torchft_tpu/checkpointing/http_transport.py, cut to the single-donor heal).

A threaded HTTP server streams the staged state tree to healing peers; a
condition gate parks a fetch until the trainer has staged the step it
asks for, and :meth:`HTTPTransport.disallow_checkpoint` closes the window
at commit. Chunked mode splits the flattened leaves round-robin into N
independently fetchable chunks pulled in parallel.

Routes: ``/checkpoint/{step}/meta``, ``/checkpoint/{step}/full``,
``/checkpoint/{step}/{chunk_index}``. Every route accepts a
``?quorum_id=N`` era tag; a mismatch against the staged era answers 409,
a step other than the staged one 404.

Heal-path hardening, as in the reference:

- **Integrity**: the donor stages a per-chunk CRC32C (zlib crc32 where
  google_crc32c does not import) plus a whole-checkpoint digest, served in
  ``/meta`` (format 2); the joiner checksums every chunk as it arrives. A
  mismatched chunk is re-fetched within its bounded retry window; an
  exhausted window raises, and corrupt state is never adopted.
- **Resume**: verified chunks are cached per ``(step, digest)``, so a
  failed attempt's next try re-fetches only the missing chunks.
- **Gray-failure fencing**: every chunk stream runs under a
  minimum-progress watchdog (``$TPUFT_HEAL_MIN_BYTES_PER_SEC``, default
  1024).
- **Era fencing**: ``/meta`` carries the staged ``quorum_id``; a joiner
  healing in era E rejects a donor staged for another era.

Not in the port yet (ROADMAP queue A6): striping across several donors
(every chunk comes from the quorum's assigned donor, as in upstream
torchft), delta rejoin, the ingress pacer and egress fairness, the serving
child (``serve_mode="child"``), staged history (``keep_versions > 1``),
wire codecs and the format-3 ``/meta`` they stage. The constructor raises
for the last three; the others are hints that the ABC lets a transport
ignore, and none of them changes the healed state, only how its bytes
travel. A format-3 ``/meta`` is refused, as a codec-less reference peer
refuses it.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from torchft_tpu_torch import metrics
from torchft_tpu_torch._safe_pickle import safe_loads
from torchft_tpu_torch.checkpointing import _serialization
from torchft_tpu_torch.checkpointing.transport import HEAL_PART_PREFIX, CheckpointTransport

__all__ = [
    "HTTPTransport",
    "HealIntegrityError",
    "HealChecksumError",
    "HealEraMismatch",
    "HealStalledError",
]

ENV_HEAL_MIN_BPS = "TPUFT_HEAL_MIN_BYTES_PER_SEC"
ENV_SERVE_MODE = "TPUFT_HEAL_SERVE_MODE"
ENV_HEAL_CODEC = "TPUFT_HEAL_CODEC"
_NOT_PORTED = "is not ported to torchft_tpu_torch yet (ROADMAP.md, queue A6)"

# Sliding window the progress watchdog averages over; fencing decisions
# never fire before one full window has elapsed, so a legit slow start
# (first-byte latency) is not a stall.
_WATCHDOG_WINDOW_SEC = 2.0


class HealIntegrityError(RuntimeError):
    """Checkpoint integrity verification failed; the state was NOT adopted."""


class HealChecksumError(HealIntegrityError):
    """One chunk's checksum mismatched (retryable within the fetch window)."""


class HealEraMismatch(RuntimeError):
    """The donor's staged checkpoint belongs to a different quorum era."""


class HealStalledError(RuntimeError):
    """The heal stream fell below the minimum-progress floor (gray donor)."""


# ---------------------------------------------------------------------------
# Checksums: CRC32C when google_crc32c is importable, zlib crc32 otherwise.
# Donor and joiner agree via the /meta "crc_algo" field, so a mixed fleet
# verifies with the donor's algorithm or fails loudly (never silently).
# ---------------------------------------------------------------------------

# google_crc32c's C extension only takes `bytes`; feed it bounded slices so
# checksumming never materializes a payload-sized copy.
_CRC_SLICE = 1 << 20


def _crc32_update(crc: int, data: Any) -> int:
    return zlib.crc32(data, crc) & 0xFFFFFFFF


try:  # pragma: no cover - exercised via whichever algo the host has
    import google_crc32c as _google_crc32c

    def _crc32c_update(crc: int, data: Any) -> int:
        if isinstance(data, bytes):
            return _google_crc32c.extend(crc, data)
        mv = memoryview(data)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        for off in range(0, len(mv), _CRC_SLICE):
            crc = _google_crc32c.extend(crc, mv[off : off + _CRC_SLICE].tobytes())
        return crc

    _CRC_UPDATERS: Dict[str, Callable[[int, Any], int]] = {
        "crc32c": _crc32c_update,
        "crc32": _crc32_update,
    }
    _CRC_ALGO = "crc32c"
except ImportError:  # pragma: no cover
    _CRC_UPDATERS = {"crc32": _crc32_update}
    _CRC_ALGO = "crc32"


class _CRCWriter:
    """File-like sink that checksums everything written through it (used to
    stage per-chunk CRCs without a serialized copy)."""

    __slots__ = ("crc", "_update")

    def __init__(self, update: Callable[[int, Any], int]) -> None:
        self.crc = 0
        self._update = update

    def write(self, data: Any) -> None:
        self.crc = self._update(self.crc, data)


def _checkpoint_digest(
    step: int,
    algo: str,
    chunk_crcs: List[int],
    chunk_codecs: Optional[List[str]] = None,
) -> str:
    """Whole-checkpoint digest binding the per-chunk checksums to (step,
    algo) — and, for a codec-encoded stage, the per-chunk codec tags.
    Deliberately quorum-era independent: committed state at a step is
    bitwise identical across donors and eras, which is what makes resume
    valid. With ``chunk_codecs`` None or all "fp32" (the only stage the
    port makes) the binding is the format-2 one."""
    h = hashlib.sha256()
    binding = f"{step}:{algo}:{','.join(str(c) for c in chunk_crcs)}"
    if chunk_codecs and any(c != "fp32" for c in chunk_codecs):
        binding += f":codecs={','.join(chunk_codecs)}"
    h.update(binding.encode())
    return h.hexdigest()


def _heal_min_bps(default: float = 1024.0) -> float:
    """Minimum-progress floor (bytes/s) from ``$TPUFT_HEAL_MIN_BYTES_PER_SEC``
    (<= 0 disables the watchdog; malformed values fall back)."""
    try:
        return float(os.environ.get(ENV_HEAL_MIN_BPS, str(default)))
    except ValueError:
        return default


class _GuardedReader:
    """Wraps an HTTP response stream: checksums bytes on the fly and fences
    the fetch when progress falls below the bytes/s floor for a full
    watchdog window (the gray-failure case a per-recv socket timeout
    cannot see — a dripping donor resets that timeout with every byte)."""

    def __init__(
        self,
        raw: Any,
        crc_update: Optional[Callable[[int, Any], int]] = None,
        min_bps: float = 0.0,
        window: float = _WATCHDOG_WINDOW_SEC,
    ) -> None:
        self._raw = raw
        self._update = crc_update
        self.crc = 0
        self.total = 0
        self._min_bps = float(min_bps)
        self._window = float(window)
        self._start = time.monotonic()
        self._events: deque = deque()  # (t, nbytes) inside the window

    def _read1(self, n: int) -> bytes:
        # read1 returns whatever ONE underlying read yields; plain read(n)
        # on a BufferedReader loops until n bytes arrived, which would let
        # a dripping donor hide from the watchdog inside one giant read.
        read1 = getattr(self._raw, "read1", None)
        return read1(n) if read1 is not None else self._raw.read(n)

    def read(self, n: int = -1) -> bytes:
        parts: List[bytes] = []
        want = n
        while want != 0:
            data = self._read1(want if want > 0 else _CRC_SLICE)
            if not data:
                break
            if self._update is not None:
                self.crc = self._update(self.crc, data)
            self._account(len(data))
            parts.append(data)
            if want > 0:
                want -= len(data)
        return b"".join(parts)

    def readinto(self, buf: Any) -> int:
        # Single bounded-granularity read; callers (_serialization) loop.
        readinto1 = getattr(self._raw, "readinto1", None)
        n = readinto1(buf) if readinto1 is not None else self._raw.readinto(buf)
        if n:
            if self._update is not None:
                self.crc = self._update(self.crc, memoryview(buf)[:n])
            self._account(n)
        return n

    def _account(self, n: int) -> None:
        self.total += n
        if self._min_bps <= 0:
            return
        now = time.monotonic()
        self._events.append((now, n))
        cutoff = now - self._window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()
        if now - self._start >= self._window:
            rate = sum(nb for _, nb in self._events) / self._window
            if rate < self._min_bps:
                metrics.inc("tpuft_heal_stalled_fetches_total")
                raise HealStalledError(
                    f"heal stream below the progress floor: {rate:.0f} B/s < "
                    f"{self._min_bps:.0f} B/s over the last {self._window:.1f}s "
                    f"(floor from ${ENV_HEAL_MIN_BPS}); fencing the donor"
                )


# ---------------------------------------------------------------------------
# Donor-side fault writers, armed through HTTPTransport._fault_hook by the
# tests' chaos cases.
# ---------------------------------------------------------------------------


def _byte_view(data: Any) -> memoryview:
    mv = memoryview(data)
    return mv if mv.format == "B" and mv.ndim == 1 else mv.cast("B")


class _CorruptingWriter:
    """Flips one bit of the byte at ``flip_at`` — the injected fault the
    joiner's per-chunk checksum must catch."""

    def __init__(self, raw: Any, flip_at: int) -> None:
        self._raw = raw
        self._off = 0
        self._flip_at = flip_at
        self.flipped = False

    def write(self, data: Any) -> None:
        mv = _byte_view(data)
        n = len(mv)
        if not self.flipped and self._off <= self._flip_at < self._off + n:
            buf = bytearray(mv)
            buf[self._flip_at - self._off] ^= 0x01
            self.flipped = True
            self._raw.write(bytes(buf))
        else:
            self._raw.write(mv)
        self._off += n


class _DripWriter:
    """Serves at a trickle (default 256 B/s) — the gray donor the joiner's
    minimum-progress watchdog must fence."""

    def __init__(self, raw: Any, bps: float = 256.0, slice_bytes: int = 64) -> None:
        self._raw = raw
        self._delay = slice_bytes / float(bps)
        self._slice = slice_bytes

    def write(self, data: Any) -> None:
        mv = _byte_view(data)
        for off in range(0, len(mv), self._slice):
            self._raw.write(mv[off : off + self._slice])
            time.sleep(self._delay)


class _TruncatingWriter:
    """Writes only the first ``limit`` bytes then swallows the rest — with
    the connection closed after the handler returns, the joiner sees a
    truncated stream (EOF mid-chunk)."""

    def __init__(self, raw: Any, limit: int) -> None:
        self._raw = raw
        self._left = limit

    def write(self, data: Any) -> None:
        if self._left <= 0:
            return
        take = _byte_view(data)[: self._left]
        self._left -= len(take)
        self._raw.write(take)


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------


class _Staged:
    """Prepared (header + host leaves) per chunk — ONE host copy in all; the
    HTTP handlers stream straight from these buffers. Integrity sidecar:
    per-chunk checksums and sizes and the whole-checkpoint digest,
    computed once at stage time."""

    def __init__(
        self,
        step: int,
        chunks: List[_serialization.Prepared],
        treedef: _serialization.TreeSpec,
        quorum_id: Optional[int] = None,
        parts: Optional[Dict[str, int]] = None,
    ) -> None:
        self.step = step
        self.chunks = chunks
        self.treedef = treedef
        self.quorum_id = quorum_id
        self.crc_algo = _CRC_ALGO
        self.parts = {
            name: {"chunk": index, "nbytes": chunks[index].total_size}
            for name, index in (parts or {}).items()
        }
        self.chunk_sizes = [int(chunk.total_size) for chunk in chunks]
        self.chunk_crcs: List[int] = []
        for chunk in chunks:
            w = _CRCWriter(_CRC_UPDATERS[_CRC_ALGO])
            _serialization.write_prepared(chunk, w)
            self.chunk_crcs.append(w.crc)
        self.digest = _checkpoint_digest(step, self.crc_algo, self.chunk_crcs)

    def meta_bytes(self) -> bytes:
        return _meta_bytes(
            step=self.step,
            quorum_id=self.quorum_id,
            num_chunks=len(self.chunks),
            treedef=self.treedef,
            crc_algo=self.crc_algo,
            chunk_crcs=self.chunk_crcs,
            digest=self.digest,
            parts=self.parts,
            chunk_sizes=self.chunk_sizes,
        )


def _meta_bytes(
    step: int,
    quorum_id: Optional[int],
    num_chunks: int,
    treedef: Any,
    crc_algo: str,
    chunk_crcs: List[int],
    digest: str,
    parts: Optional[Dict[str, Dict[str, int]]] = None,
    chunk_sizes: Optional[List[int]] = None,
) -> bytes:
    """The exact ``/meta`` response body at format 2, with the reference's
    keys. ``parts`` maps heal-part name -> {"chunk", "nbytes"} so a joiner
    can address (or skip) exactly one part's payload."""
    meta: Dict[str, Any] = {
        "format": 2,
        "num_chunks": num_chunks,
        "treedef": treedef,
        "step": step,
        "quorum_id": quorum_id,
        "crc_algo": crc_algo,
        "chunk_crcs": chunk_crcs,
        "digest": digest,
        "parts": parts or {},
        "chunk_sizes": chunk_sizes,
    }
    return pickle.dumps(meta)


def _stage_manifest(staged: _Staged) -> Dict[str, Any]:
    """JSON-safe summary of one staged checkpoint (no spec; readers that
    need it fetch the pickled ``/meta``)."""
    return {
        "step": int(staged.step),
        "quorum_id": staged.quorum_id,
        "crc_algo": staged.crc_algo,
        "chunk_crcs": [int(c) for c in staged.chunk_crcs],
        "chunk_sizes": [int(s) for s in staged.chunk_sizes],
        "num_chunks": len(staged.chunk_crcs),
        "digest": staged.digest,
    }


def _plan_chunks(
    state_dict: Any, num_chunks: int
) -> Tuple[_serialization.TreeSpec, List[Dict[int, Any]], Dict[str, int]]:
    """Splits a state dict's leaves into servable chunks, part-aware.

    Leaves under a dict key starting with :data:`HEAL_PART_PREFIX` form a
    named *part* and get their own chunk (appended after the base chunks,
    in sorted part order), so a joiner can address — or skip — exactly that
    payload; every other leaf round-robins into ``num_chunks`` base chunks
    by leaf index. Returns ``(spec, chunk_dicts, parts)`` where ``parts``
    maps part name -> chunk index. Every tensor leaf is staged to host
    here, once, all device copies in flight together."""
    leaves_with_paths, spec = _serialization.tree_flatten_with_path(state_dict)

    def part_of(path: Tuple[Any, ...]) -> Optional[str]:
        for key in path:
            if isinstance(key, str) and key.startswith(HEAL_PART_PREFIX):
                return key
        return None

    rest: List[int] = []
    part_members: Dict[str, List[int]] = {}
    for index, (path, _leaf) in enumerate(leaves_with_paths):
        name = part_of(path)
        if name is None:
            rest.append(index)
        else:
            part_members.setdefault(name, []).append(index)
    leaves = _serialization._host_leaves([leaf for _path, leaf in leaves_with_paths])
    n = num_chunks if num_chunks > 0 else 1
    n = min(n, max(len(rest), 1))
    chunk_dicts: List[Dict[int, Any]] = [dict() for _ in range(n)]
    for slot, index in enumerate(rest):
        chunk_dicts[slot % n][index] = leaves[index]
    parts: Dict[str, int] = {}
    for name in sorted(part_members):
        parts[name] = len(chunk_dicts)
        chunk_dicts.append({i: leaves[i] for i in part_members[name]})
    return spec, chunk_dicts, parts


class _HealCacheEntry:
    """Joiner-side per-chunk resume state for one (step, digest): verified
    chunks (so a retry re-fetches only what is missing) and which chunk
    indices ever started transferring (so the re-fetch counter is exact)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.chunks: Dict[int, Tuple[Any, int]] = {}  # index -> (chunk, nbytes)
        self.attempted: Set[int] = set()


class HTTPTransport(CheckpointTransport[Any]):
    """Serves the staged checkpoint over HTTP, IPv6 dual-stack.

    ``serve_mode`` "inline" (the default), ``keep_versions`` 1 and ``codec``
    None or "fp32" are the reference's defaults and the only values the
    port takes."""

    def __init__(
        self,
        timeout: float = 60.0,
        num_chunks: int = 0,
        serve_mode: Optional[str] = None,
        keep_versions: int = 1,
        codec: Optional[str] = None,
    ) -> None:
        serve_mode = serve_mode or os.environ.get(ENV_SERVE_MODE, "inline")
        if serve_mode not in ("inline", "child"):
            raise ValueError(f"{ENV_SERVE_MODE} must be 'inline' or 'child', got {serve_mode!r}")
        if serve_mode == "child":
            raise NotImplementedError(f"serve_mode='child' (the serving child) {_NOT_PORTED}")
        if int(keep_versions) > 1:
            raise NotImplementedError(f"keep_versions > 1 (staged history) {_NOT_PORTED}")
        codec = codec if codec is not None else os.environ.get(ENV_HEAL_CODEC)
        if codec not in (None, "", "fp32"):
            raise NotImplementedError(
                f"heal wire codec {codec!r} (format-3 /meta) {_NOT_PORTED}"
            )
        self._timeout = timeout
        self._num_chunks = num_chunks
        # A GET for step S parks until the trainer stages S: without this
        # gate the joiner's fetch races the donor's staging inside the same
        # quorum round.
        self._cond = threading.Condition()
        self._staged: Optional[_Staged] = None
        # Joiner-side resume cache for the one (step, digest) heal in flight.
        self._heal_cache: Dict[Tuple[int, str], _HealCacheEntry] = {}
        # Chaos seam: tests set a callable (step, chunk_index) -> mode to
        # inject donor-side stream faults ("die", "corrupt_stream",
        # "stall_donor", "truncate").
        self._fault_hook: Optional[Callable[[int, int], Optional[str]]] = None

        transport = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: Any) -> None:  # silence
                pass

            def do_GET(self) -> None:
                split = urllib.parse.urlsplit(self.path)
                parts = split.path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "checkpoint":
                    self.send_error(404, "unknown route")
                    return
                try:
                    step = int(parts[1])
                except ValueError:
                    self.send_error(400, "bad step")
                    return
                stall_t0 = time.perf_counter()
                with transport._cond:
                    # Park only for a step that may still arrive: staged
                    # steps are monotone, so a request for an OLDER step
                    # than the current stage 404s at once.
                    transport._cond.wait_for(
                        lambda: transport._staged is not None and transport._staged.step >= step,
                        timeout=transport._timeout,
                    )
                    staged = transport._staged
                metrics.observe("tpuft_ckpt_donor_stall_seconds", time.perf_counter() - stall_t0)
                if staged is None or staged.step != step:
                    self.send_error(
                        404,
                        f"no checkpoint staged for step {step}"
                        + (f" (have {staged.step})" if staged else ""),
                    )
                    return
                # Era fence: serving a different staged era would hand the
                # joiner bytes its /meta checksums do not describe.
                want_era = urllib.parse.parse_qs(split.query).get("quorum_id")
                if want_era and staged.quorum_id is not None and str(staged.quorum_id) != want_era[0]:
                    self.send_error(
                        409,
                        f"stale quorum era: staged {staged.quorum_id}, joiner wants {want_era[0]}",
                    )
                    return
                if parts[2] == "meta":
                    body = staged.meta_bytes()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parts[2] == "full":
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header(
                        "Content-Length", str(sum(8 + c.total_size for c in staged.chunks))
                    )
                    self.end_headers()
                    try:
                        for chunk in staged.chunks:
                            self.wfile.write(chunk.total_size.to_bytes(8, "big"))
                            _serialization.write_prepared(chunk, self.wfile)
                    except (ConnectionError, TimeoutError, OSError):
                        # The joiner went away; serving is best-effort,
                        # never donor-fatal.
                        self.close_connection = True
                    return
                try:
                    index = int(parts[2])
                    chunk = staged.chunks[index]
                except (ValueError, IndexError):
                    self.send_error(400, "bad chunk index")
                    return
                fault = transport._fault_hook(step, index) if transport._fault_hook else None
                if fault == "die":
                    # A donor dying mid-heal: cut the connection instead of
                    # the body.
                    self.close_connection = True
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(chunk.total_size))
                self.end_headers()
                out: Any = self.wfile
                if fault == "corrupt_stream":
                    # Flip a bit of the last byte, which is raw tensor data
                    # whenever the chunk carries tensors.
                    out = _CorruptingWriter(out, chunk.total_size - 1)
                elif fault == "stall_donor":
                    out = _DripWriter(out)
                elif fault == "truncate":
                    out = _TruncatingWriter(out, chunk.total_size // 2)
                    self.close_connection = True
                try:
                    # Streams directly from the staged host tensors.
                    _serialization.write_prepared(chunk, out)
                except (ConnectionError, TimeoutError, OSError):
                    self.close_connection = True

        class DualStackServer(ThreadingHTTPServer):
            address_family = socket.AF_INET6
            daemon_threads = True

        self._server = DualStackServer(("::", 0), Handler)
        self._thread = threading.Thread(
            target=functools.partial(self._server.serve_forever, poll_interval=0.05),
            daemon=True,
            name="tpuft-http-ckpt",
        )
        self._thread.start()

    # -- CheckpointTransport -----------------------------------------------

    def metadata(self) -> str:
        return f"http://{socket.gethostname()}:{self._server.server_address[1]}"

    def send_checkpoint(
        self,
        dst_ranks: List[int],
        step: int,
        state_dict: Any,
        timeout: float,
        quorum_id: Optional[int] = None,
    ) -> Optional[Dict[str, Any]]:
        """Stages host copies of the state and serves them for ``step``
        (tagged with ``quorum_id`` when the manager provides the era) until
        :meth:`disallow_checkpoint`. Returns the staged integrity manifest."""
        with metrics.timer("tpuft_heal_serve_stage_seconds", mode="inline"):
            spec, chunk_dicts, parts = _plan_chunks(state_dict, self._num_chunks)
            # The leaves are host snapshots already: prepare() adds a small
            # header per chunk and no second copy of the payload.
            chunks = [_serialization.prepare(chunk, snapshot=False) for chunk in chunk_dicts]
            staged = _Staged(step, chunks, spec, quorum_id=quorum_id, parts=parts)
        metrics.inc("tpuft_heal_serve_stages_total", mode="inline")
        with self._cond:
            self._staged = staged
            self._cond.notify_all()
        return _stage_manifest(staged)

    def disallow_checkpoint(self) -> None:
        with self._cond:
            self._staged = None

    def recv_checkpoint(
        self,
        src_rank: int,
        metadata: str,
        step: int,
        timeout: float,
        quorum_id: Optional[int] = None,
        skip_parts: Optional[Set[str]] = None,
        donors: Optional[List[str]] = None,
        local_state: Optional[Any] = None,
        stripe_rotation: int = 0,
        donor_info: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> Any:
        """Fetches the state staged for ``step`` at ``metadata`` (the
        assigned donor's address). ``skip_parts``, ``donors``,
        ``local_state``, ``stripe_rotation`` and ``donor_info`` are the
        reference's part-skipping, striping and delta hints, which this
        transport ignores: every chunk comes from the assigned donor."""
        meta = self._fetch_meta(metadata, step, timeout, quorum_id)
        num_chunks: int = meta["num_chunks"]
        spec: _serialization.TreeSpec = meta["treedef"]
        chunk_crcs: Optional[List[int]] = meta.get("chunk_crcs")
        digest: Optional[str] = meta.get("digest")
        algo: str = meta.get("crc_algo", "crc32")
        crc_update = _CRC_UPDATERS.get(algo)
        if chunk_crcs is not None and crc_update is None:
            raise HealIntegrityError(f"donor checksums use {algo!r}, unavailable on this host")

        # Resume: reuse verified chunks from a previous failed attempt at
        # the same (step, digest) — valid across donors and eras because
        # committed state at a step is bitwise identical.
        key = (step, digest) if digest is not None else None
        entry = self._heal_cache.get(key) if key is not None else None
        if entry is None:
            entry = _HealCacheEntry()
        self._heal_cache = {key: entry} if key is not None else {}
        resumed = bool(entry.chunks)
        if resumed:
            for _chunk, nbytes in entry.chunks.values():
                metrics.inc("tpuft_heal_resumed_bytes_total", nbytes)
        missing = [i for i in range(num_chunks) if i not in entry.chunks]

        query: Dict[str, Any] = {}
        if quorum_id is not None:
            query["quorum_id"] = quorum_id
        era_tag = ("?" + urllib.parse.urlencode(query)) if query else ""
        min_bps = _heal_min_bps()

        def fetch_chunk(i: int) -> None:
            # Stream-decode straight off the socket into final buffers.
            expected = chunk_crcs[i] if chunk_crcs is not None else None
            attempts = [0]

            def consume(resp: Any) -> Tuple[Any, int]:
                attempts[0] += 1
                # A re-fetch is any transfer a first clean pass would not
                # have needed: a retry within this call, a chunk that
                # already streamed in a failed attempt, or any transfer of
                # a resumed heal.
                with entry.lock:
                    if resumed or i in entry.attempted or attempts[0] > 1:
                        metrics.inc("tpuft_heal_chunk_refetches_total")
                    entry.attempted.add(i)
                reader = _GuardedReader(
                    resp, crc_update=crc_update if expected is not None else None, min_bps=min_bps
                )
                try:
                    chunk = _serialization.load_state_dict(reader)
                except (HealStalledError, EOFError, ConnectionError):
                    raise
                except Exception as decode_err:
                    # The decoder crashed mid-stream (a bit flip inside the
                    # pickled header). Drain the body and let the checksum
                    # arbitrate: a mismatch is corruption (re-fetched), a
                    # match is a protocol bug that retrying cannot fix.
                    if expected is None:
                        raise
                    try:
                        while reader.read(1 << 16):
                            pass
                    except Exception:  # noqa: BLE001 — the CRC decides
                        pass
                    if reader.crc != expected:
                        metrics.inc("tpuft_heal_checksum_failures_total")
                        raise HealChecksumError(
                            f"chunk {i} stream corrupt (decode failed: {decode_err}; "
                            f"checksum {reader.crc:#010x} != {expected:#010x}); "
                            "discarding the chunk"
                        ) from decode_err
                    raise
                if expected is not None and reader.crc != expected:
                    metrics.inc("tpuft_heal_checksum_failures_total")
                    raise HealChecksumError(
                        f"chunk {i} checksum mismatch: got {reader.crc:#010x}, "
                        f"want {expected:#010x} ({algo}); discarding the chunk"
                    )
                metrics.inc("tpuft_heal_recv_bytes_total", reader.total)
                return chunk, reader.total

            verified = _fetch_retry(f"{metadata}/checkpoint/{step}/{i}{era_tag}", timeout, consume)
            with entry.lock:
                entry.chunks[i] = verified

        if len(missing) <= 1:
            for i in missing:
                fetch_chunk(i)
        else:
            with ThreadPoolExecutor(max_workers=min(len(missing), 8)) as pool:
                futs = [pool.submit(fetch_chunk, i) for i in missing]
                try:
                    for f in futs:
                        f.result()
                except BaseException:
                    # Fail fast: the pool's __exit__ would otherwise run every
                    # queued fetch, each burning its own retry window.
                    # Verified chunks stay in the resume cache.
                    pool.shutdown(wait=False, cancel_futures=True)
                    raise

        merged: Dict[int, Any] = {}
        for chunk, _nbytes in entry.chunks.values():
            merged.update(chunk)
        result = _serialization.tree_unflatten(spec, [merged[i] for i in range(len(merged))])
        if key is not None:
            self._heal_cache.pop(key, None)
        return result

    def _fetch_meta(
        self, url: str, step: int, timeout: float, quorum_id: Optional[int]
    ) -> Dict[str, Any]:
        """Fetches and validates ``/meta``: format 2, the quorum era, and the
        digest binding its own checksums, all before any transfer."""
        meta = safe_loads(_fetch_retry(f"{url}/checkpoint/{step}/meta", timeout))
        if not isinstance(meta, dict) or meta.get("format") != 2:
            raise HealIntegrityError(
                f"unrecognized checkpoint /meta format from {url}: "
                f"{meta.get('format') if isinstance(meta, dict) else type(meta).__name__} "
                "(this peer takes format 2; a codec-encoded format-3 stage "
                f"{_NOT_PORTED})"
            )
        donor_era = meta.get("quorum_id")
        if quorum_id is not None and donor_era is not None and donor_era != quorum_id:
            metrics.inc("tpuft_heal_era_rejects_total")
            raise HealEraMismatch(
                f"donor staged quorum era {donor_era}, joiner is healing in era "
                f"{quorum_id}: rejecting the stale-era heal"
            )
        digest = meta.get("digest")
        chunk_crcs = meta.get("chunk_crcs")
        if digest is not None and chunk_crcs is not None:
            algo = meta.get("crc_algo", "crc32")
            if _checkpoint_digest(step, algo, chunk_crcs) != digest:
                raise HealIntegrityError(
                    "whole-checkpoint digest does not match the per-chunk "
                    "checksums in /meta: refusing the heal"
                )
        return meta

    def shutdown(self, wait: bool = True) -> None:
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._thread.join(timeout=5)


def _is_retryable_fetch_error(e: BaseException) -> bool:
    """Failures worth re-trying against the same URL within the bounded
    window: not-yet-staged (404), a dying or restarting donor (refused,
    reset, truncated stream), and a checksum mismatch. A watchdog fence is
    NOT retryable, and neither are timeouts or other HTTP statuses (400 and
    409 are protocol-level rejections, e.g. a stale era)."""
    if isinstance(e, HealStalledError):
        return False
    if isinstance(e, urllib.error.HTTPError):
        return e.code == 404
    if isinstance(e, HealChecksumError):
        return True
    if isinstance(e, urllib.error.URLError):
        return isinstance(e.reason, ConnectionError)
    # RemoteDisconnected/IncompleteRead surface as ConnectionError
    # subclasses; EOFError is _serialization's truncated-stream signal.
    return isinstance(e, (ConnectionError, EOFError))


def _fetch_retry(
    url: str,
    timeout: float,
    consume: Optional[Callable[[Any], Any]] = None,
    retryable: Optional[Callable[[BaseException], bool]] = None,
) -> Any:
    """Fetch with bounded retry on transient failures; ``consume`` (default:
    read all bytes) processes the open response, so chunk fetches
    stream-decode off the socket through the same retry loop as the meta
    fetch. ``retryable`` overrides :func:`_is_retryable_fetch_error`.

    The retry window is PER FETCH and opens at this fetch's FIRST failure,
    so time spent transferring bytes never charges the retry budget; it
    lasts ``timeout``. The socket timeout stays ``timeout`` per attempt
    (urllib's is a per-recv inactivity bound, not a wall-time bound)."""
    delay = 0.05
    retry_deadline: Optional[float] = None
    is_retryable = retryable if retryable is not None else _is_retryable_fetch_error
    while True:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return consume(resp) if consume is not None else resp.read()
        except Exception as e:
            now = time.monotonic()
            if retry_deadline is None:
                retry_deadline = now + timeout
            if not is_retryable(e) or now + delay >= retry_deadline:
                raise
        time.sleep(delay)
        delay = min(delay * 1.5, 1.0)
