"""Mesh-request parsing -- stdlib only; the port's copy of the JAX package's
``meshreq.py``.

``KTPU_MESH`` / ``KTPU_MESH_PODS`` / ``KTPU_MESH_NODES`` parse here exactly
as in the JAX package: a 1-D node-axis count, or a (pods, nodes) pair for a
2-D grid, which ``parallel/mesh.py`` -- ``make_mesh`` / ``mesh_from_env``
builds.  Importing this module touches no backend.
"""

from __future__ import annotations

import os
from typing import Optional


def parse_mesh_request(
    raw: Optional[str] = None, source: str = "KTPU_MESH",
):
    """Parse the mesh-request knobs WITHOUT touching a jax backend (bench.py
    must size --xla_force_host_platform_device_count before first backend
    use).  Returns None (single device), an int (1-D node-axis count), or a
    (pods, nodes) tuple (2-D mesh).

    Accepted forms:
      KTPU_MESH=8          1-D, 8 node shards (the legacy form)
      KTPU_MESH=2x4        2-D, 2 pod shards x 4 node shards
      KTPU_MESH_PODS=2 KTPU_MESH_NODES=4   the explicit pair
      KTPU_MESH_PODS=2 KTPU_MESH=8         pods divides the total
    """
    pods_raw = os.environ.get("KTPU_MESH_PODS", "").strip() if raw is None else ""
    nodes_raw = os.environ.get("KTPU_MESH_NODES", "").strip() if raw is None else ""
    if raw is None:
        raw = os.environ.get("KTPU_MESH", "")
    raw = raw.strip()

    def _int(v: str, name: str) -> int:
        try:
            n = int(v)
        except ValueError:
            raise ValueError(
                f"{name}={v!r}: expected an integer (e.g. {name}=8), or "
                f"{source}=<pods>x<nodes> for a 2-D mesh"
            ) from None
        if n < 0:
            raise ValueError(f"{name}={n}: must be >= 0")
        return n

    if pods_raw:
        p = _int(pods_raw, "KTPU_MESH_PODS")
        if nodes_raw:
            n = _int(nodes_raw, "KTPU_MESH_NODES")
            if n == 0:
                raise ValueError("KTPU_MESH_NODES=0: node axis must be >= 1")
        elif raw and "x" not in raw.lower():
            total = _int(raw, source)
            if p == 0 or total % p:
                raise ValueError(
                    f"KTPU_MESH_PODS={p} does not divide {source}={total}"
                )
            n = total // p
        elif p <= 1:
            # KTPU_MESH_PODS<=1 with no nodes count carries no 2-D
            # request of its own — defer to the plain KTPU_MESH parse
            n = None
        else:
            # pods alone: a pod-only grid (p x 1) — one node shard per
            # pod row
            n = 1
        if n is not None:
            if p <= 1:
                return n if n > 1 else None
            return (p, max(1, n))
    if not raw:
        return None
    if "x" in raw.lower():
        parts = raw.lower().split("x")
        if len(parts) != 2:
            raise ValueError(
                f"{source}={raw!r}: a 2-D mesh is <pods>x<nodes> "
                f"(e.g. {source}=2x4)"
            )
        p = _int(parts[0], source)
        n = _int(parts[1], source)
        if n == 0:
            raise ValueError(
                f"{source}={raw!r}: the node axis must be >= 1"
            )
        if p <= 1:
            return n if n > 1 else None
        return (p, n)
    n = _int(raw, source)
    return n if n > 1 else None


def mesh_request_devices(req) -> int:
    """Total device count a parse_mesh_request result needs (1 for None)."""
    if req is None:
        return 1
    if isinstance(req, tuple):
        return int(req[0]) * int(req[1])
    return int(req)
