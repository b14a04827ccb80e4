"""Shared registry + stats-row hookup for the resilience modules.

Counterpart of ``mxnet_tpu/resilience/_stats.py``. Each module registers
named instances (policies, breakers, caches) and exports their counters as
``{row: (count, seconds)}`` rows through one provider registration. The
port has no profiler: :func:`aggregate_rows` merges every provider's rows,
as the reference's ``profiler.get_aggregate_stats()`` shows them.
"""
import threading
import weakref

__all__ = ["Registry", "export_rows", "aggregate_rows"]


class Registry:
    """Named-instance registry; latest instance wins per name, which keeps
    the exported stats table bounded under test churn. ``weak=True`` holds
    the instances by weak reference: an instance that owns device or host
    memory (an arena, prefix slabs, a scheduler and its engine) leaves the
    registry when its owner drops it, closed or not."""

    def __init__(self, weak=False):
        self._lock = threading.Lock()
        self._items = weakref.WeakValueDictionary() if weak else {}

    def add(self, obj):
        with self._lock:
            self._items[obj.name] = obj

    def discard(self, obj):
        """Remove ``obj`` if it is still the registered instance for its
        name (a newer same-name instance is left alone)."""
        with self._lock:
            if self._items.get(obj.name) is obj:
                del self._items[obj.name]

    def map(self, fn):
        """``{name: fn(instance)}`` over a consistent snapshot."""
        with self._lock:
            items = dict(self._items)
        return {name: fn(obj) for name, obj in items.items()}


_providers = []
_providers_lock = threading.Lock()


def export_rows(rows_fn):
    """Register ``rows_fn() -> {row_name: (count, seconds)}`` with
    :func:`aggregate_rows`."""
    with _providers_lock:
        _providers.append(rows_fn)


def aggregate_rows():
    """Every registered provider's rows, merged into one dict."""
    with _providers_lock:
        providers = list(_providers)
    rows = {}
    for fn in providers:
        rows.update(fn())
    return rows
