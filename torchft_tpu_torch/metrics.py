"""Process-local metrics: dependency-free counters, gauges and histograms
(counterpart of torchft_tpu/metrics.py, cut to what the port's modules
call).

Every FT phase the port runs (quorum wait, wire allreduce, host reduce,
vote) lands in process-local metrics that :func:`histogram_stats` reads
back. The reference's exporters (the Prometheus text, the ``/metrics`` HTTP
server, store pushes and windowed series) wait for the slice that serves
them.

Metric identity is ``(name, sorted label items)``; get-or-create accessors
return the same live object for the same identity, and every mutation takes
the metric's own lock so concurrent increments from the op-worker, quorum,
and train-loop threads never lose updates.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Generator, List, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "inc",
    "set_gauge",
    "observe",
    "timer",
    "histogram_stats",
    "counter_total",
]

LabelItems = Tuple[Tuple[str, str], ...]


def _label_items(labels: Dict[str, Any]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing float; negative increments are rejected."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter increment must be >= 0, got {value}")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Sum and count of observations. The reference's bucket counts feed
    its Prometheus exporter, which the port does not have yet."""

    __slots__ = ("_lock", "_sum", "_count")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1

    def stats(self) -> Dict[str, Any]:
        """{"sum", "count", "mean"}."""
        with self._lock:
            return {
                "sum": self._sum,
                "count": self._count,
                "mean": (self._sum / self._count) if self._count else 0.0,
            }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Thread-safe get-or-create store of metrics keyed (name, labels)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelItems], Any] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any]) -> Any:
        key = (name, _label_items(labels))
        with self._lock:
            existing_kind = self._kinds.get(name)
            if existing_kind is not None and existing_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as a "
                    f"{existing_kind}, cannot reuse as a {kind}"
                )
            metric = self._metrics.get(key)
            if metric is None:
                metric = _KINDS[kind]()
                self._metrics[key] = metric
                self._kinds[name] = kind
            return metric

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get("histogram", name, labels)

    # -- reads -------------------------------------------------------------

    def _items(self) -> List[Tuple[str, LabelItems, str, Any]]:
        with self._lock:
            return [
                (name, items, self._kinds[name], metric)
                for (name, items), metric in sorted(self._metrics.items())
            ]

    def counter_total(self, name: str, **label_filter: Any) -> float:
        """Sum of counter ``name`` over the label sets that match."""
        want = dict(_label_items(label_filter))
        total = 0.0
        for metric_name, items, kind, metric in self._items():
            have = dict(items)
            if metric_name == name and kind == "counter" and all(
                have.get(k) == v for k, v in want.items()
            ):
                total += metric.value
        return total

    def histogram_stats(self, name: str, **label_filter: Any) -> Dict[str, Any]:
        """Aggregated {"sum","count","mean"} over matching label sets."""
        want = dict(_label_items(label_filter))
        total_sum, total_count = 0.0, 0
        for metric_name, items, kind, metric in self._items():
            if metric_name != name or kind != "histogram":
                continue
            have = dict(items)
            if all(have.get(k) == v for k, v in want.items()):
                stats = metric.stats()
                total_sum += stats["sum"]
                total_count += stats["count"]
        return {
            "sum": total_sum,
            "count": total_count,
            "mean": (total_sum / total_count) if total_count else 0.0,
        }


REGISTRY = Registry()


# -- module-level conveniences bound to the default registry ----------------


def inc(name: str, amount: float = 1.0, **labels: Any) -> None:
    REGISTRY.counter(name, **labels).inc(amount)


def set_gauge(name: str, value: float, **labels: Any) -> None:
    REGISTRY.gauge(name, **labels).set(value)


def observe(name: str, value: float, **labels: Any) -> None:
    REGISTRY.histogram(name, **labels).observe(value)


@contextmanager
def timer(name: str, **labels: Any) -> Generator[None, None, None]:
    """Times the with-body into histogram ``name`` (seconds)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        observe(name, time.perf_counter() - start, **labels)


def histogram_stats(name: str, **label_filter: Any) -> Dict[str, Any]:
    return REGISTRY.histogram_stats(name, **label_filter)


def counter_total(name: str, **label_filter: Any) -> float:
    return REGISTRY.counter_total(name, **label_filter)
