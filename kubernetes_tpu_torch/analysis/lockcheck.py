"""The named lock the port's host modules take (``scheduler/metrics.py``,
the sidecar engine) — the part of the JAX package's
``analysis/lockcheck.py`` they use.  The JAX package's runtime lock-order
checker (KTPU_LOCK_CHECK) is not ported: nothing in the port reads it."""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A plain lock; `name` labels it at the call site, as in the JAX
    package, where the checker keys its order graph on it."""
    del name
    return threading.Lock()


__all__ = ["make_lock"]
