"""The named locks the port's host modules take (``scheduler/metrics.py``,
the sidecar engine, the Scheduler's store, queue and cache) — the part of
the JAX package's ``analysis/lockcheck.py`` they use.  The JAX package's runtime lock-order
checker (KTPU_LOCK_CHECK) is not ported: nothing in the port reads it."""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A plain lock; `name` labels it at the call site, as in the JAX
    package, where the checker keys its order graph on it."""
    del name
    return threading.Lock()


def make_rlock(name: str) -> threading.RLock:
    """A plain re-entrant lock (the store's and the queue's: watchers run
    under the store lock and may read back)."""
    del name
    return threading.RLock()


__all__ = ["make_lock", "make_rlock"]
