"""The port's checkpoint plane (torchft_tpu_torch.checkpointing, _safe_pickle)
against the JAX package's, and the reference's own transport cases.

Held against the JAX package on the same inputs (numpy, from a seed): the
order in which nested dicts, OrderedDicts, lists, tuples and None flatten;
the payload bytes after the header for f32, bf16 and int64 leaves; the
leaf-to-chunk plan for 0, 1 and 3 chunks with and without a heal part; the
checkpoint digest of the same checksums; the ``/meta`` keys at format 2.
The header itself differs by design: each package pickles its own tree
spec, which the other cannot rebuild.

Then the reference's cases (tests/test_checkpointing.py) on the port:
round trips, a truncated stream, in-place decode into a template, wrong
step 404, stale era 409, a bit-flipped chunk rejected and re-fetched, a
digest mismatch refused before any transfer, the bounds of ``_fetch_retry``,
and ``_safe_pickle`` refusing an ``os.system`` gadget. Every HTTP fetch runs
under a timeout of a few seconds and every thread is joined with one.
"""

from __future__ import annotations

import contextlib
import io
import pickle
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu._safe_pickle import safe_loads as jsafe_loads
from torchft_tpu.checkpointing import _serialization as jser
from torchft_tpu.checkpointing import http_transport as jht
from torchft_tpu_torch import _safe_pickle, metrics
from torchft_tpu_torch.checkpointing import (
    HealEraMismatch,
    HealIntegrityError,
    HTTPTransport,
    PGTransport,
    ServeChild,
    _serialization,
)
from torchft_tpu_torch.checkpointing import http_transport as ht
from torchft_tpu_torch.checkpointing._rwlock import RWLock

torch.set_num_threads(1)

JOIN_S = 10.0


def _tensors_and_arrays(seed: int = 0):
    """The same leaves twice: torch tensors for the port and numpy (with
    ml_dtypes' bfloat16) for the JAX package, bf16 built from one set of
    bit patterns."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf16_bits = rng.integers(0, 1 << 16, size=(4, 2), dtype=np.uint16)
    i64 = rng.integers(-(1 << 40), 1 << 40, size=(7,), dtype=np.int64)
    port = {
        "w": torch.from_numpy(f32.copy()),
        "b": torch.from_numpy(bf16_bits.view(np.int16).copy()).view(torch.bfloat16),
        "n": torch.from_numpy(i64.copy()),
        "lr": 0.25,
        "name": "sgd",
    }
    ref = {
        "w": f32.copy(),
        "b": bf16_bits.view(ml_dtypes.bfloat16).copy(),
        "n": i64.copy(),
        "lr": 0.25,
        "name": "sgd",
    }
    return port, ref


def _nested(leaf):
    """A state tree with int- and str-keyed dicts, an OrderedDict in
    insertion order, None, a list and a tuple: the shape of a model's and a
    torch optimizer's state_dict under the manager's keys."""
    ids = iter(range(100))
    return {
        "user": {
            "optimizer": {
                "model": OrderedDict(
                    [("layers.1.w", leaf(next(ids))), ("layers.0.w", leaf(next(ids))),
                     ("embed", leaf(next(ids)))]
                ),
                "optimizer": {
                    "state": {10: {"momentum_buffer": leaf(next(ids))},
                              2: {"momentum_buffer": leaf(next(ids))},
                              0: {"momentum_buffer": leaf(next(ids))}},
                    "param_groups": [{"lr": leaf(next(ids)), "params": [leaf(next(ids)),
                                      leaf(next(ids))], "foreach": None,
                                      "betas": (leaf(next(ids)), leaf(next(ids)))}],
                },
            },
        },
        "tpuft": {"step": leaf(next(ids)), "batches_committed": leaf(next(ids))},
    }


def test_leaves_flatten_in_the_jax_package_order():
    port_leaves, spec = _serialization.tree_flatten(_nested(lambda i: i))
    ref_leaves, treedef = jax.tree_util.tree_flatten(_nested(lambda i: i))
    assert port_leaves == ref_leaves
    assert spec.num_leaves == treedef.num_leaves
    rebuilt = _serialization.tree_unflatten(spec, port_leaves)
    assert rebuilt == _nested(lambda i: i)
    assert type(rebuilt["user"]["optimizer"]["model"]) is OrderedDict
    paths = [path for path, _ in _serialization.tree_flatten_with_path(_nested(lambda i: i))[0]]
    ref_paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(_nested(lambda i: i))[0]]
    assert paths == ref_paths


def _split_header(data: bytes):
    magic = len(jser._MAGIC)
    (header_len,) = jser._LEN.unpack(data[magic : magic + jser._LEN.size])
    start = magic + jser._LEN.size
    return data[:magic], data[start : start + header_len], data[start + header_len :]


def test_payload_bytes_match_the_jax_package():
    port, ref = _tensors_and_arrays()
    port_magic, port_header, port_payload = _split_header(_serialization.dumps(port))
    ref_magic, ref_header, ref_payload = _split_header(jser.dumps(ref))
    assert port_magic == ref_magic == b"TPFT1\n"
    assert port_payload == ref_payload
    assert len(port_payload) == 3 * 5 * 4 + 4 * 2 * 2 + 7 * 8
    _, port_metas, port_rest = _safe_pickle.safe_loads(port_header)
    _, ref_metas, ref_rest = jsafe_loads(ref_header)
    assert [(tuple(m.shape), m.dtype, m.nbytes) if m else None for m in port_metas] == [
        (tuple(m.shape), m.dtype, m.nbytes) if m else None for m in ref_metas
    ]
    assert port_rest == ref_rest == [0.25, "sgd"]


def test_serialization_roundtrip_keeps_dtypes_on_the_cpu():
    port, _ = _tensors_and_arrays(1)
    restored = _serialization.loads(_serialization.dumps(port))
    assert set(restored) == set(port)
    for key in ("w", "b", "n"):
        assert restored[key].dtype == port[key].dtype and restored[key].device.type == "cpu"
        assert torch.equal(restored[key], port[key])
    assert restored["lr"] == 0.25 and restored["name"] == "sgd"


def test_serialization_truncated_raises():
    data = _serialization.dumps(_tensors_and_arrays()[0])
    with pytest.raises(EOFError):
        _serialization.loads(data[:-10])


def test_load_state_dict_template_in_place_and_contiguity_guard():
    state = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": torch.full((2, 2), 7.0, dtype=torch.float64), "meta": "tag"}
    template = {"a": torch.zeros(3, 4), "b": torch.zeros(4, 2, dtype=torch.float64)[::2],
                "meta": None}
    out = _serialization.load_state_dict(io.BytesIO(_serialization.dumps(state)), template)
    assert out["a"].data_ptr() == template["a"].data_ptr()  # received in place
    assert torch.equal(template["a"], state["a"])
    assert out["b"].data_ptr() != template["b"].data_ptr()  # non-contiguous: fresh
    assert torch.equal(out["b"], state["b"]) and out["meta"] == "tag"


def _parted(leaf):
    return {"a": leaf(0), "b": leaf(1), "c": {"heal_part:z": {"x": leaf(2), "y": leaf(3)}},
            "d": [leaf(4), leaf(5)], "heal_part:k": leaf(6), "e": leaf(7)}


@pytest.mark.parametrize("parted", [False, True], ids=["no_part", "heal_part"])
@pytest.mark.parametrize("num_chunks", [0, 1, 3])
def test_chunk_plan_matches_the_jax_package(num_chunks, parted):
    if parted:
        port_state = _parted(lambda i: torch.full((2,), float(i)))
        ref_state = _parted(lambda i: np.full((2,), float(i), np.float32))
    else:
        port_state = _nested(lambda i: torch.full((i + 1,), float(i)))
        ref_state = _nested(lambda i: np.full((i + 1,), float(i), np.float32))
    _, port_chunks, port_parts = ht._plan_chunks(port_state, num_chunks)
    _, ref_chunks, ref_parts = jht._plan_chunks(ref_state, num_chunks)
    assert [sorted(c) for c in port_chunks] == [sorted(c) for c in ref_chunks]
    assert port_parts == ref_parts
    assert bool(port_parts) == parted


@pytest.mark.parametrize("crcs", [[], [0], [1, 2, 3], [0xFFFFFFFF, 12345, 7]])
def test_checkpoint_digest_matches_the_jax_package(crcs):
    for step, algo in ((0, "crc32c"), (17, "crc32")):
        assert ht._checkpoint_digest(step, algo, crcs) == jht._checkpoint_digest(step, algo, crcs)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.read()


def test_meta_keys_at_format_2_match_the_jax_package():
    port, ref = _tensors_and_arrays()
    donor, jdonor = HTTPTransport(num_chunks=2), jht.HTTPTransport(num_chunks=2)
    try:
        donor.send_checkpoint([1], step=5, state_dict=port, timeout=5, quorum_id=11)
        jdonor.send_checkpoint([1], step=5, state_dict=ref, timeout=5, quorum_id=11)
        meta = _safe_pickle.safe_loads(_get(donor.metadata() + "/checkpoint/5/meta"))
        jmeta = jsafe_loads(_get(jdonor.metadata() + "/checkpoint/5/meta"))
    finally:
        donor.shutdown()
        jdonor.shutdown()
    assert set(meta) == set(jmeta)
    for key in ("format", "step", "quorum_id", "num_chunks", "crc_algo", "parts"):
        assert meta[key] == jmeta[key], key
    assert meta["format"] == 2
    assert meta["digest"] == ht._checkpoint_digest(5, meta["crc_algo"], meta["chunk_crcs"])
    assert len(meta["chunk_sizes"]) == meta["num_chunks"] == len(meta["chunk_crcs"])


# -- the reference's transport cases, on the port ----------------------------


def _chunked_state():
    """Leaves of a few KiB each, so half of any chunk ends inside tensor
    bytes, after its header."""
    rng = np.random.default_rng(3)
    return {f"w{i}": torch.from_numpy(rng.standard_normal(1024 + i).astype(np.float32))
            for i in range(6)} | {"tag": "ok", "step": 5}


def _assert_state_equal(a, b):
    leaves_a, spec_a = _serialization.tree_flatten(a)
    leaves_b, spec_b = _serialization.tree_flatten(b)
    assert spec_a == spec_b
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


@contextlib.contextmanager
def _pair(**donor_kwargs):
    donor, joiner = HTTPTransport(**donor_kwargs), HTTPTransport()
    try:
        yield donor, joiner
    finally:
        donor.shutdown()
        joiner.shutdown()


def _counters():
    return {name: metrics.counter_total(f"tpuft_heal_{name}_total")
            for name in ("checksum_failures", "chunk_refetches", "era_rejects")}


@pytest.mark.parametrize("num_chunks", [0, 3])
def test_http_transport_roundtrip(num_chunks):
    with _pair(num_chunks=num_chunks) as (donor, joiner):
        state = _chunked_state()
        manifest = donor.send_checkpoint([1], step=3, state_dict=state, timeout=5)
        assert manifest["num_chunks"] == max(num_chunks, 1)
        _assert_state_equal(state, joiner.recv_checkpoint(0, donor.metadata(), step=3, timeout=5))
        # The staged bytes are a snapshot: an in-place update after staging
        # changes nothing a joiner receives.
        before = state["w0"].clone()
        state["w0"].add_(1.0)
        got = joiner.recv_checkpoint(0, donor.metadata(), step=3, timeout=5)
        assert torch.equal(got["w0"], before)


def test_full_route_streams_every_chunk():
    with _pair(num_chunks=2) as (donor, _):
        donor.send_checkpoint([1], step=3, state_dict=_chunked_state(), timeout=5)
        body = io.BytesIO(_get(donor.metadata() + "/checkpoint/3/full"))
        merged = {}
        for _ in range(2):
            size = int.from_bytes(body.read(8), "big")
            merged.update(_serialization.loads(body.read(size)))
        assert sorted(merged) == list(range(8))


def test_http_transport_wrong_step_404s():
    # The donor holds a request for a step it has not staged for 0.2 s, well
    # inside the joiner's 1 s socket timeout, then answers 404.
    donor = HTTPTransport(timeout=0.2)
    try:
        donor.send_checkpoint([1], step=3, state_dict={"x": torch.ones(1)}, timeout=5)
        with pytest.raises(urllib.error.HTTPError) as err:
            donor.recv_checkpoint(0, donor.metadata(), step=2, timeout=1)
        assert err.value.code == 404
        donor.disallow_checkpoint()  # disallow stops serving entirely
        with pytest.raises(urllib.error.HTTPError) as err:
            donor.recv_checkpoint(0, donor.metadata(), step=3, timeout=1)
        assert err.value.code == 404
    finally:
        donor.shutdown()


def test_stale_era_meta_rejected_and_same_era_heals():
    with _pair(num_chunks=2) as (donor, joiner):
        donor.send_checkpoint([1], step=5, state_dict=_chunked_state(), timeout=5, quorum_id=3)
        before = _counters()
        with pytest.raises(HealEraMismatch):
            joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=2, quorum_id=4)
        assert _counters()["era_rejects"] - before["era_rejects"] == 1
        out = joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=5, quorum_id=3)
        _assert_state_equal(_chunked_state(), out)


def test_stale_era_chunk_409_fails_heal_cleanly(monkeypatch):
    """The donor re-stages a newer era between the joiner's /meta and chunk
    GETs: the era-tagged chunk URL answers 409, and the heal fails."""
    with _pair(num_chunks=2) as (donor, joiner):
        donor.send_checkpoint([1], step=5, state_dict=_chunked_state(), timeout=5, quorum_id=3)
        orig = ht._fetch_retry
        restaged = []

        def restaging_fetch(url, timeout, consume=None, retryable=None):
            result = orig(url, timeout, consume=consume, retryable=retryable)
            if url.endswith("/meta") and not restaged:
                restaged.append(1)
                donor.send_checkpoint([1], step=5, state_dict=_chunked_state(), timeout=5,
                                      quorum_id=4)
            return result

        monkeypatch.setattr(ht, "_fetch_retry", restaging_fetch)
        with pytest.raises(urllib.error.HTTPError) as err:
            joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=2, quorum_id=3)
        assert err.value.code == 409


@pytest.mark.parametrize("target", ["payload", "header"])
def test_bit_flipped_chunk_rejected_and_refetched(target):
    """A flipped bit in a chunk's payload, or in a header-only chunk's
    pickled header (the decoder crashes before any checksum), is caught by
    the chunk's checksum and the chunk is fetched again."""
    if target == "payload":
        state, index = _chunked_state(), 0
    else:
        state = {"b": torch.ones(7, dtype=torch.float64), "tag": "header-only-chunk",
                 "w": torch.arange(12, dtype=torch.float32)}
        index = 1
    with _pair(num_chunks=3) as (donor, joiner):
        donor.send_checkpoint([1], step=5, state_dict=state, timeout=5, quorum_id=7)
        injected = []

        def corrupt_once(step, i):
            if i == index and not injected:
                injected.append(1)
                return "corrupt_stream"
            return None

        donor._fault_hook = corrupt_once
        before = _counters()
        out = joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=5, quorum_id=7)
        after = _counters()
    _assert_state_equal(state, out)
    assert injected == [1]
    assert after["checksum_failures"] - before["checksum_failures"] == 1
    assert after["chunk_refetches"] - before["chunk_refetches"] == 1


def test_truncated_stream_never_adopted():
    with _pair(num_chunks=2) as (donor, joiner):
        donor.send_checkpoint([1], step=5, state_dict=_chunked_state(), timeout=5, quorum_id=7)
        donor._fault_hook = lambda step, index: "truncate"
        t0 = time.monotonic()
        with pytest.raises(EOFError):
            joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=1, quorum_id=7)
        assert time.monotonic() - t0 < 15


def test_dripping_donor_is_fenced(monkeypatch):
    monkeypatch.setenv(ht.ENV_HEAL_MIN_BPS, "4096")
    with _pair() as (donor, joiner):
        donor.send_checkpoint([1], step=5, state_dict={"w": torch.zeros(4096)}, timeout=5)
        donor._fault_hook = lambda step, index: "stall_donor"
        t0 = time.monotonic()
        with pytest.raises(ht.HealStalledError):
            joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=5)
        assert time.monotonic() - t0 < 10


def test_digest_mismatch_refused_before_any_transfer(monkeypatch):
    monkeypatch.setattr(ht, "_checkpoint_digest", lambda *a, **k: "deadbeef" * 8)
    with _pair(num_chunks=2) as (donor, joiner):
        donor.send_checkpoint([1], step=5, state_dict=_chunked_state(), timeout=5, quorum_id=7)
        monkeypatch.undo()
        fetched = []
        donor._fault_hook = lambda step, index: fetched.append(index)
        with pytest.raises(HealIntegrityError, match="digest"):
            joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=2, quorum_id=7)
        assert fetched == []


def test_format_3_meta_is_refused(monkeypatch):
    real = ht._meta_bytes

    def format3(**kwargs):
        meta = pickle.loads(real(**kwargs))
        meta.update(format=3, chunk_codecs=["fp8"] * meta["num_chunks"], codec="fp8")
        return pickle.dumps(meta)

    monkeypatch.setattr(ht, "_meta_bytes", format3)
    with _pair() as (donor, joiner):
        donor.send_checkpoint([1], step=5, state_dict=_chunked_state(), timeout=5)
        with pytest.raises(HealIntegrityError, match="format"):
            joiner.recv_checkpoint(0, donor.metadata(), 5, timeout=2)


@pytest.mark.parametrize("kwargs", [{"serve_mode": "child"}, {"keep_versions": 2},
                                    {"codec": "fp8"}])
def test_unported_transport_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HTTPTransport(**kwargs)
    for cls in (PGTransport, ServeChild):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cls()


@contextlib.contextmanager
def _http_404_server(n_404s: int, body: bytes = b"staged"):
    """Serves 404 to the first ``n_404s`` GETs (all if negative), then
    ``body``; yields (url, hits)."""
    hits = []

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(1)
            if n_404s < 0 or len(hits) <= n_404s:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/x", hits
    finally:
        server.shutdown()
        server.server_close()
        thread.join(JOIN_S)


def test_fetch_retry_bounded_when_never_staged():
    with _http_404_server(n_404s=-1) as (url, hits):
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError):
            ht._fetch_retry(url, timeout=0.4)
        assert time.monotonic() - t0 < 10 and len(hits) > 1


def test_fetch_retry_retries_until_staged():
    with _http_404_server(n_404s=2) as (url, hits):
        assert ht._fetch_retry(url, timeout=5.0) == b"staged"
        assert len(hits) == 3


class _Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def test_fetch_retry_rides_out_connection_refused(monkeypatch):
    clock, calls = _Clock(), []

    def fake_urlopen(url, timeout=None):
        calls.append(clock.t)
        clock.t += 0.1
        if len(calls) == 1:
            raise urllib.error.URLError(ConnectionRefusedError(111, "refused"))
        if len(calls) == 2:
            raise ConnectionResetError(104, "reset mid-body")
        return io.BytesIO(b"served")

    monkeypatch.setattr(ht, "time", clock)
    monkeypatch.setattr(ht.urllib.request, "urlopen", fake_urlopen)
    assert ht._fetch_retry("http://fake/x", timeout=5.0) == b"served"
    assert len(calls) == 3


@pytest.mark.parametrize("error", [
    TimeoutError("timed out"),
    urllib.error.HTTPError("http://fake/x", 409, "stale era", None, None),
    ht.HealStalledError("drip"),
])
def test_fetch_retry_non_retryable_fails_on_the_first_attempt(monkeypatch, error):
    calls = []

    def fake_urlopen(url, timeout=None):
        calls.append(1)
        raise error

    monkeypatch.setattr(ht, "time", _Clock())
    monkeypatch.setattr(ht.urllib.request, "urlopen", fake_urlopen)
    with pytest.raises(type(error)):
        ht._fetch_retry("http://fake/x", timeout=5.0)
    assert len(calls) == 1


# -- the restricted unpickler --------------------------------------------------


class _Gadget:
    def __reduce__(self):
        import os

        return (os.system, ("echo pwned",))


def test_safe_pickle_refuses_an_os_system_gadget(monkeypatch):
    monkeypatch.delenv(_safe_pickle.UNSAFE_ENV, raising=False)
    payload = pickle.dumps(_Gadget())
    with pytest.raises(_safe_pickle.RestrictedUnpicklingError, match="posix.system|os.system"):
        _safe_pickle.safe_loads(payload)
    for gadget in (pickle.dumps(getattr), pickle.dumps(_safe_pickle.allow_module)):
        with pytest.raises(_safe_pickle.RestrictedUnpicklingError):
            _safe_pickle.safe_loads(gadget)


def test_safe_pickle_takes_the_ports_wire_types():
    header = pickle.dumps((_serialization.tree_flatten({"a": 1})[1],
                           [_serialization.ArrayMeta((2,), "bfloat16", 4)],
                           [0.5, None, "x", torch.Size([2, 3])]))
    spec, metas, rest = _safe_pickle.safe_loads(header)
    assert spec.num_leaves == 1 and metas[0].dtype == "bfloat16"
    assert rest == [0.5, None, "x", torch.Size([2, 3])]


# -- the readers-writer lock ------------------------------------------------------


def test_rwlock_readers_shared_writer_exclusive():
    lock = RWLock()
    with lock.r_lock():
        assert lock.r_acquire(timeout=0.1)
        lock.r_release()
        assert not lock.w_acquire(timeout=0.1)
    with lock.w_lock():
        assert not lock.r_acquire(timeout=0.1)
        assert not lock.w_acquire(timeout=0.1)


def test_rwlock_writer_blocks_new_readers():
    lock = RWLock()
    lock.r_acquire()
    got = threading.Event()

    def writer():
        lock.w_acquire()
        got.set()
        lock.w_release()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    deadline = time.monotonic() + JOIN_S
    while lock._writers_waiting == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not lock.r_acquire(timeout=0.1)  # a waiting writer blocks readers
    lock.r_release()
    t.join(JOIN_S)
    assert got.is_set() and not t.is_alive()
