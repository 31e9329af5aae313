"""Streaming (de)serialization of state trees (counterpart of
torchft_tpu/checkpointing/_serialization.py).

Wire format, byte for byte the reference's framing: ``_MAGIC``, the
header's length as ``!Q``, the pickled header ``(spec, metas, non_array)``,
then each tensor leaf's raw bytes in leaf order. Tensor leaves stream as
raw bytes (no pickle copy of the payload); non-tensor leaves (floats,
ints, strings, bools) ride in the header. Device tensors are staged to
host once (pinned, through ``utils/transfer.py``) and come back as CPU
tensors in their own dtype: the caller puts them on its device.

Leaf order is the reference's. ``jax.tree_util`` flattens a dict in
sorted key order, an ``OrderedDict`` (a module's ``state_dict()``) in
insertion order, lists and tuples in order, and ``None`` as an empty node
that holds no leaf; :func:`tree_flatten` does the same, so leaf indices,
chunk plans and payload order match the JAX package's. The spec is this
module's :class:`TreeSpec`: a JAX peer cannot rebuild it, nor can this
package rebuild a pickled jax treedef, so the header bytes are the one
part of the wire that differs between the packages.
"""

from __future__ import annotations

import io
import pickle
import struct
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, BinaryIO, List, Optional, Sequence, Tuple

import torch

from torchft_tpu_torch._safe_pickle import safe_loads
from torchft_tpu_torch.utils.transfer import HostCopy

__all__ = [
    "TreeSpec",
    "tree_flatten",
    "tree_flatten_with_path",
    "tree_unflatten",
    "save_state_dict",
    "load_state_dict",
    "state_dict_meta",
    "ArrayMeta",
    "Prepared",
    "prepare",
    "write_prepared",
    "dumps",
    "loads",
]

_LEN = struct.Struct("!Q")
_MAGIC = b"TPFT1\n"


# ---------------------------------------------------------------------------
# Trees, flattened in jax.tree_util's order
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreeSpec:
    """The structure of a flattened tree. ``kind`` is "leaf", "none",
    "dict" (children in sorted key order), "odict" (an ``OrderedDict``,
    children in insertion order), "list" or "tuple"."""

    kind: str
    keys: Tuple[Any, ...] = ()
    children: Tuple["TreeSpec", ...] = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(child.num_leaves for child in self.children)


_LEAF = TreeSpec("leaf")
_NONE = TreeSpec("none")


def _node(tree: Any) -> Optional[Tuple[str, Tuple[Any, ...], List[Any]]]:
    """(kind, keys, children) of a container node; None for a leaf. Only
    the exact container types are nodes, as in jax's default registry."""
    kind = type(tree)
    if kind is dict:
        keys = tuple(sorted(tree))
        return "dict", keys, [tree[k] for k in keys]
    if kind is OrderedDict:
        keys = tuple(tree)
        return "odict", keys, [tree[k] for k in keys]
    if kind is list:
        return "list", (), list(tree)
    if kind is tuple:
        return "tuple", (), list(tree)
    return None


def tree_flatten_with_path(
    tree: Any, none_is_leaf: bool = False
) -> Tuple[List[Tuple[Tuple[Any, ...], Any]], TreeSpec]:
    """((path, leaf) pairs, spec); a path is the tuple of keys and indices
    from the root. ``none_is_leaf`` counts ``None`` as a leaf (for
    templates, whose ``None`` stands where the wire has a header leaf)."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []

    def walk(node: Any, path: Tuple[Any, ...]) -> TreeSpec:
        if node is None and not none_is_leaf:
            return _NONE
        parts = _node(node)
        if parts is None:
            out.append((path, node))
            return _LEAF
        kind, keys, children = parts
        labels = keys if keys else range(len(children))
        specs = tuple(walk(child, path + (label,)) for label, child in zip(labels, children))
        return TreeSpec(kind, keys, specs)

    spec = walk(tree, ())
    return out, spec


def tree_flatten(tree: Any, none_is_leaf: bool = False) -> Tuple[List[Any], TreeSpec]:
    pairs, spec = tree_flatten_with_path(tree, none_is_leaf)
    return [leaf for _, leaf in pairs], spec


def tree_unflatten(spec: TreeSpec, leaves: Sequence[Any]) -> Any:
    if len(leaves) != spec.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a spec of {spec.num_leaves}")
    it = iter(leaves)

    def build(node: TreeSpec) -> Any:
        if node.kind == "leaf":
            return next(it)
        if node.kind == "none":
            return None
        children = [build(child) for child in node.children]
        if node.kind == "dict":
            return dict(zip(node.keys, children))
        if node.kind == "odict":
            return OrderedDict(zip(node.keys, children))
        if node.kind == "list":
            return children
        if node.kind == "tuple":
            return tuple(children)
        raise ValueError(f"unknown tree node kind {node.kind!r}")

    return build(spec)


# ---------------------------------------------------------------------------
# dtypes by the reference's names (numpy's, and ml_dtypes' for bfloat16)
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {
    torch.float64: "float64",
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.complex64: "complex64",
    torch.complex128: "complex128",
    torch.int64: "int64",
    torch.int32: "int32",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
    torch.float8_e4m3fn: "float8_e4m3fn",
    torch.float8_e5m2: "float8_e5m2",
}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no wire name for tensor dtype {dtype}") from None


def _resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported wire dtype {name!r}") from None


@dataclass
class ArrayMeta:
    shape: Tuple[int, ...]
    dtype: str  # the reference's dtype name ("float32", "bfloat16", ...)
    nbytes: int


def _host_leaves(leaves: List[Any]) -> List[Any]:
    """Host snapshots of every tensor leaf: device tensors are copied to
    pinned host memory, all copies started before the first wait; CPU
    tensors are copied too, since the optimizer updates them in place
    while a peer may still be reading the staged bytes. Other leaves pass
    through."""
    staged: List[Any] = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.device.type == "cuda":
                staged.append(HostCopy(leaf))
            else:
                staged.append(torch.empty(leaf.shape, dtype=leaf.dtype).copy_(leaf))
        else:
            staged.append(leaf)
    return [leaf.wait() if isinstance(leaf, HostCopy) else leaf for leaf in staged]


def state_dict_meta(
    state_dict: Any, snapshot: bool = True
) -> Tuple[TreeSpec, List[Optional[ArrayMeta]], List[Any]]:
    """(spec, per-leaf meta, host leaves). Metas are ArrayMeta for tensors
    and None for header-riding (pickled) leaves. ``snapshot=False`` takes
    the leaves as they are: contiguous CPU tensors that
    :func:`_host_leaves` already staged."""
    leaves, spec = tree_flatten(state_dict)
    if snapshot:
        leaves = _host_leaves(leaves)
    metas: List[Optional[ArrayMeta]] = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            metas.append(ArrayMeta(
                tuple(leaf.shape), dtype_name(leaf.dtype), leaf.numel() * leaf.element_size()
            ))
        else:
            metas.append(None)
    return spec, metas, leaves


@dataclass
class Prepared:
    """A staged-for-serving state dict: header bytes + host leaves, with the
    exact serialized size known up front. Holds ONE host copy of the data;
    serving writes straight from these buffers, so no second serialized
    copy ever exists."""

    header: bytes
    leaves: List[Any]
    metas: List[Optional[ArrayMeta]]
    total_size: int


def prepare(state_dict: Any, snapshot: bool = True) -> Prepared:
    spec, metas, leaves = state_dict_meta(state_dict, snapshot)
    non_array = [leaf for leaf, meta in zip(leaves, metas) if meta is None]
    header = pickle.dumps((spec, metas, non_array))
    payload = sum(meta.nbytes for meta in metas if meta is not None)
    total = len(_MAGIC) + _LEN.size + len(header) + payload
    return Prepared(header, leaves, metas, total)


def _bytes_view(tensor: torch.Tensor) -> memoryview:
    """Raw-byte memoryview of a contiguous CPU tensor, without a copy
    (bfloat16 included, which numpy cannot hold: the bytes go through a
    uint8 view)."""
    return memoryview(tensor.reshape(-1).view(torch.uint8).numpy())


def write_prepared(prepared: Prepared, stream: BinaryIO) -> None:
    """Streams a :class:`Prepared` state dict; writes are memoryviews of the
    staged host tensors (no payload-sized intermediate buffers)."""
    stream.write(_MAGIC)
    stream.write(_LEN.pack(len(prepared.header)))
    stream.write(prepared.header)
    for leaf, meta in zip(prepared.leaves, prepared.metas):
        if meta is not None:
            stream.write(_bytes_view(leaf))


def save_state_dict(state_dict: Any, stream: BinaryIO) -> None:
    write_prepared(prepare(state_dict), stream)


def _read_array(
    stream: BinaryIO, shape, dtype: torch.dtype, nbytes: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Reads ``nbytes`` straight into the final (or provided) buffer — no
    intermediate bytes object, so decode peak stays at one payload copy.
    ``out`` enables in-place receive when it is a matching contiguous CPU
    tensor; anything else gets a fresh tensor, never a silently stale one."""
    if out is not None and (
        tuple(out.shape) != tuple(shape)
        or out.dtype != dtype
        or out.device.type != "cpu"
        or not out.is_contiguous()
        or out.requires_grad
    ):
        out = None
    tensor = out if out is not None else torch.empty(tuple(shape), dtype=dtype)
    view = _bytes_view(tensor)
    if len(view) != nbytes:
        raise ValueError(f"buffer/wire size mismatch: {len(view)} != {nbytes}")
    got = 0
    readinto = getattr(stream, "readinto", None)
    while got < nbytes:
        if readinto is not None:
            n = readinto(view[got:])
        else:
            chunk = stream.read(nbytes - got)
            n = len(chunk)
            view[got : got + n] = chunk
        if not n:
            raise EOFError(f"truncated checkpoint stream: wanted {nbytes} bytes, got {got}")
        got += n
    return tensor


def load_state_dict(stream: BinaryIO, template: Any = None) -> Any:
    """Decodes a state tree from ``stream``. With ``template`` (a tree of the
    same structure), matching contiguous CPU tensor leaves are received
    **in place** into the template's storage."""
    magic = stream.read(len(_MAGIC))
    if magic != _MAGIC:
        raise ValueError("bad checkpoint stream magic")
    (header_len,) = _LEN.unpack(stream.read(_LEN.size))
    spec, metas, non_array = safe_loads(stream.read(header_len))
    template_leaves: List[Any] = []
    if template is not None:
        # None counts as a leaf here: the wire's header leaves may stand
        # where the template holds None.
        template_leaves = tree_flatten(template, none_is_leaf=True)[0]
        if len(template_leaves) != len(metas):
            template_leaves = []
    non_array_iter = iter(non_array)
    leaves = []
    for i, meta in enumerate(metas):
        if meta is None:
            leaves.append(next(non_array_iter))
            continue
        out = None
        if template_leaves and isinstance(template_leaves[i], torch.Tensor):
            out = template_leaves[i]
        leaves.append(_read_array(stream, meta.shape, _resolve_dtype(meta.dtype), meta.nbytes, out))
    return tree_unflatten(spec, leaves)


def dumps(state_dict: Any) -> bytes:
    buf = io.BytesIO()
    save_state_dict(state_dict, buf)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    return load_state_dict(io.BytesIO(data))
