"""Device-memory residency manager: many segments under a byte budget.

Counterpart of ``trinity_tpu/exec/residency.py``. Every Executor keeps its
packed host forms, uploads its segment arrays (block metadata, padded
planes, positions stream) on first use through ``ensure``, and when
``config.hbm_budget_bytes`` (0 = unlimited) would be exceeded the
least-recently-used executors' arrays on the same device are dropped; an
evicted executor re-uploads on its next search. The budget is per device:
executors on the CPU (the tests' plain versions) and on a card never
evict each other. The hot-term and posmask caches are derived and stay
outside the budget, as in the reference.

Thread-safe: ``ensure`` RETURNS the device-array dict read under the
manager lock, and callers must read from it, not from the executor, since
a concurrent ``ensure`` on another executor may evict this one the moment
the lock is released. Uploads run outside the manager lock (serialised per
executor), so a concurrent pair can overshoot the budget until both
register: an LRU target, not a reservation.

Dropping a segment's tensors while kernels that read them are still queued
is safe on one stream: the caching allocator hands their memory only to
later work on the same stream, which runs after them. The executor issues
all its work on the current stream.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict


class ResidencyManager:
    """LRU over executors' device-resident segment arrays."""

    def __init__(self):
        self._lock = threading.RLock()
        # key -> (weakref(executor), device_bytes); insertion order = LRU
        self._lru: OrderedDict = OrderedDict()
        self.evictions = 0
        self.uploads = 0

    def _forget(self, key) -> None:
        with self._lock:
            self._lru.pop(key, None)

    def resident_bytes(self, device=None) -> int:
        """Bytes of the resident segment arrays (of executors on `device`,
        or on every device)."""
        with self._lock:
            total = 0
            for ref, b in self._lru.values():
                ex = ref()
                if (ex is not None and ex._dev is not None
                        and (device is None or ex.device == device)):
                    total += b
            return total

    def _touch(self, ex) -> None:
        key = id(ex)
        if key in self._lru:  # the executor's entry, until its weakref dies
            self._lru.move_to_end(key)
            return
        self._lru[key] = (
            weakref.ref(ex, lambda _r, k=key: self._forget(k)),
            ex.device_bytes,
        )

    def ensure(self, ex) -> dict:
        """Touch `ex` in the LRU and return its device-array dict,
        uploading first if evicted or new (evicting older executors on its
        device when a budget is configured). Callers must read arrays from
        the RETURNED dict."""
        from trinity_tpu_torch.config import get_config

        with self._lock:
            dev = ex._dev
            if dev is not None:
                self._touch(ex)
                return dev
            budget = get_config().hbm_budget_bytes
            if budget:
                resident = self.resident_bytes(ex.device)
                for ref, b in list(self._lru.values()):
                    if resident + ex.device_bytes <= budget:
                        break
                    other = ref()
                    if (other is None or other is ex or other._dev is None
                            or other.device != ex.device):
                        continue
                    other.evict()
                    resident -= b
                    self.evictions += 1
        # upload outside the manager lock (serialised per executor): a slow
        # host -> device copy must not block other segments
        with ex._upload_lock:
            dev = ex._dev
            if dev is None:
                ex._upload()
                dev = ex._dev
                with self._lock:
                    self.uploads += 1
        with self._lock:
            self._touch(ex)
        return dev


_MANAGER = ResidencyManager()


def get_residency() -> ResidencyManager:
    return _MANAGER
