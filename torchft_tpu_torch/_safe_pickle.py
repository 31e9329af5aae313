"""Restricted unpickling for bytes received from network peers
(counterpart of torchft_tpu/_safe_pickle.py).

The checkpoint wire carries pickled structure (the tree spec, per-leaf
metadata dataclasses, non-tensor leaves). Plain ``pickle.loads`` on bytes
from a peer is remote code execution, and the transport servers bind
``[::]``. The trust model stays the reference's (run the coordination and
transport planes on a private, trusted network), but network pickles are
decoded with an allowlisting Unpickler that only resolves classes from
the ML modules the wire uses, which blocks the classic
``os.system``/``subprocess``/``getattr`` reduce gadgets.

Where the reference allows jax, jaxlib, flax, optax and chex, this
allowlist names ``torch`` and this package. State dicts whose leaves are
instances of other modules' classes opt out with
``TPUFT_ALLOW_UNSAFE_PICKLE=1`` (trusted networks only) or extend the
allowlist with :func:`allow_module`.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Set

__all__ = ["safe_loads", "allow_module", "allow_function", "RestrictedUnpicklingError"]

UNSAFE_ENV = "TPUFT_ALLOW_UNSAFE_PICKLE"

# Top-level modules whose classes may be resolved during unpickling: what
# the port puts on the wire (its meta dataclasses, torch dtypes and sizes,
# numpy scalars) plus the stdlib containers they serialize through.
_ALLOWED_ROOTS: Set[str] = {
    "numpy",
    "torch",
    "torchft_tpu_torch",
    "collections",
    "functools",
}

# Safe builtins: literal constructors only. Notably absent: getattr, eval,
# exec, compile, open, __import__ — the standard pickle RCE gadgets.
_SAFE_BUILTINS: Set[str] = {
    "complex",
    "bytearray",
    "set",
    "frozenset",
    "slice",
    "range",
    "tuple",
    "list",
    "dict",
    "bool",
    "int",
    "float",
    "str",
    "bytes",
    "object",
}

# Non-class globals that legitimate payloads resolve during unpickling.
# Exact (module, name) pairs only — REDUCE can call any resolved callable,
# so arbitrary functions under allowed roots must NOT resolve.
_ALLOWED_FUNCTIONS: Set[tuple] = {
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),  # pre-2.0 pickles
    ("numpy.core.multiarray", "scalar"),
}

# Modules that must never resolve even though their root is allowed: this
# module itself (its allow_module is an allowlist-widening gadget).
_DENIED_MODULES = ("torchft_tpu_torch._safe_pickle",)


class RestrictedUnpicklingError(pickle.UnpicklingError):
    """A network pickle referenced a global outside the allowlist."""


def allow_module(root: str) -> None:
    """Extends the unpickling allowlist with a top-level module name (for
    user state dicts carrying custom leaf types). Only classes under the
    module resolve; module-level functions stay blocked."""
    _ALLOWED_ROOTS.add(root.split(".", 1)[0])


def allow_function(module: str, name: str) -> None:
    """Allows one exact module-level function to resolve (for user leaf
    types whose ``__reduce__`` goes through a reconstruction function)."""
    _ALLOWED_FUNCTIONS.add((module, name))


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file: Any) -> None:
        super().__init__(file)
        # Snapshot at construction: a payload that widens the process-global
        # allowlists mid-load gains nothing for this (or any concurrent) load.
        self._roots = frozenset(_ALLOWED_ROOTS)
        self._functions = frozenset(_ALLOWED_FUNCTIONS)

    def find_class(self, module: str, name: str) -> Any:
        if module == "builtins":
            if name in _SAFE_BUILTINS:
                return super().find_class(module, name)
            raise self._refuse(module, name, "builtin outside the safe set")
        if module.split(".", 1)[0] not in self._roots:
            raise self._refuse(module, name, "module root not allowlisted")
        if module in _DENIED_MODULES:
            raise self._refuse(module, name, "explicitly denied module")
        obj = super().find_class(module, name)
        if isinstance(obj, type):
            return obj
        if (module, name) in self._functions:
            return obj
        raise self._refuse(module, name, "non-class global (REDUCE gadget surface)")

    @staticmethod
    def _refuse(module: str, name: str, why: str) -> RestrictedUnpicklingError:
        return RestrictedUnpicklingError(
            f"refusing to unpickle {module}.{name} from the network ({why}). "
            f"If this type is part of your state dict, call torchft_tpu_torch."
            f"_safe_pickle.allow_module/allow_function, or set {UNSAFE_ENV}=1 "
            f"on a trusted network."
        )


def safe_loads(data: bytes) -> Any:
    """``pickle.loads`` for network-received bytes, allowlist-restricted
    unless ``TPUFT_ALLOW_UNSAFE_PICKLE=1``."""
    if os.environ.get(UNSAFE_ENV) == "1":
        return pickle.loads(data)
    return _RestrictedUnpickler(io.BytesIO(data)).load()
