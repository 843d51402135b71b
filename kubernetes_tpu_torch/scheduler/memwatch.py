"""The live device-memory ledger — a port of the JAX package's
``scheduler/memwatch.py`` on ``torch.cuda``'s caching allocator.

Three cooperating pieces, as in the JAX package:

  * per-device LIVE stats — ``device_memory_stats()`` reads
    ``torch.cuda.memory_stats(dev)`` on every card: in use is
    ``allocated_bytes.all.current``, peak ``allocated_bytes.all.peak``,
    sampled at cycle boundaries, high-water kept across the run.
    ``live_device_bytes()`` is ``torch.cuda.memory_allocated(dev)`` summed
    over the cards (the JAX package's ``jax.live_arrays()`` sum).  Both
    count only the caching allocator's blocks: the port's kernels allocate
    nothing themselves (every output and scratch is a torch tensor), so
    that is every device byte the port holds.

  * a host-side CENSUS of every *resident* device buffer the port owns —
    the DeltaEncoder's resident table, the HoistCache's class planes,
    usage rows and memoized index vectors, any IncState in flight — each
    entry sized through ``parallel/partition_rules.py``'s FIELD_DIMS model
    (``field_bytes``) and ``matched`` against the tensor's own bytes
    (``numel * element_size``).

  * a LEAK SENTINEL over the per-cycle UNACCOUNTED live bytes (live minus
    baseline minus census): monotone growth past SENTINEL_SLACK_BYTES is a
    retained buffer.

Departures from the JAX code:

  * On the CPU there is no device allocator to read.  The JAX package's
    ``live_arrays()`` meters its CPU backend's arrays too; the port's CPU
    tensors are host memory, so there ``device_memory_stats()`` and
    ``live_device_bytes()`` say ``available: False`` (zero totals), the
    ledger's ``source`` is ``"unavailable"`` and the sentinel is not fed —
    recorded in every sample and summary, never passed off as a
    measurement.  Tests stub the two sources to drive the ledger here.
  * The port's shards are separate tensors, one device each, so every
    census entry is sized at its own shape (one shard); the JAX census
    sizes global arrays per shard.
  * The HoistCache's memoized class-row index (``hoist.r_u``, int64 [U1])
    is resident in the port alone and has its own FIELD_DIMS row.
  * Outside the census, and so in "unaccounted" (constant, not a leak):
    ``ops/kernels.py``'s kept buffers (K1's set-up words, K14's
    accumulator, one per card and stream), the pinned staging and each
    call's transient outputs.

``KTPU_MEMWATCH=0`` disables the plane (default on).  Wired into
PipelinedBatchLoop (``memwatch=``, cycle samples) and the Scheduler's batch
path on a card (gauges, the flight record's ``mem`` block).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

# sentinel slack: unaccounted growth below this many bytes across the
# observed window is allocator noise, not a leak
SENTINEL_SLACK_BYTES = 1 << 18  # 256 KiB

# the sentinel needs at least this many samples (>= 2 deltas) before it
# will call a monotone rise a leak — one noisy delta is not a trend
SENTINEL_MIN_SAMPLES = 3

# rolling-window bound on the sentinel's sample history
SENTINEL_WINDOW = 512


def memwatch_enabled() -> bool:
    """KTPU_MEMWATCH=0 disables the device-memory ledger (read per
    construction).  Default ON."""
    return os.environ.get("KTPU_MEMWATCH", "") != "0"


# --------------------------------------------------------------------------
# measured side: the caching allocator's stats
# --------------------------------------------------------------------------


def _devices() -> List[Any]:
    """The cards this process can see (torch devices), or [cpu]."""
    import torch

    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _memory_stats(d) -> Optional[Dict[str, Any]]:
    """torch.cuda.memory_stats of a card; None for the CPU (no device
    allocator)."""
    import torch

    if getattr(d, "type", None) != "cuda":
        return None
    return torch.cuda.memory_stats(d)


def device_metered(device) -> bool:
    """Whether the ledger has a measured source for `device`: a card.  The
    Scheduler arms its ledger only then."""
    return getattr(device, "type", None) == "cuda"


def device_memory_stats() -> Dict[str, Any]:
    """Per-device snapshot: ``{"available": bool, "devices": [{device,
    bytes_in_use, peak_bytes_in_use}, ...], "bytes_in_use": total,
    "peak_bytes_in_use": total}``; a device without stats (the CPU, a
    source that raises) says ``available: False`` and adds nothing."""
    devices = []
    in_use = peak = 0
    available = False
    for d in _devices():
        try:
            stats = _memory_stats(d)
        except Exception:
            stats = None
        if not stats:
            devices.append({"device": str(d), "available": False})
            continue
        b = int(stats.get("allocated_bytes.all.current", 0))
        p = int(stats.get("allocated_bytes.all.peak", b))
        devices.append({"device": str(d), "available": True, "bytes_in_use": b, "peak_bytes_in_use": p})
        in_use += b
        peak += p
        available = True
    return {"available": available, "devices": devices, "bytes_in_use": in_use, "peak_bytes_in_use": peak}


def live_device_bytes() -> Dict[str, Any]:
    """Bytes the caching allocator holds for live tensors, summed over the
    cards (``torch.cuda.memory_allocated``), and the count of live
    allocations; ``available`` False (zeros) on the CPU."""
    import torch

    total = n = 0
    available = False
    for d in _devices():
        if d.type != "cuda":
            continue
        total += int(torch.cuda.memory_allocated(d))
        n += int(torch.cuda.memory_stats(d).get("allocation.all.current", 0))
        available = True
    return {"bytes": total, "arrays": n, "available": available}


def _tensor_bytes(a) -> int:
    """A tensor's own bytes (metadata only: never reads values)."""
    try:
        return int(a.numel()) * int(a.element_size())
    except Exception:
        return int(getattr(a, "nbytes", 0))


# --------------------------------------------------------------------------
# the census: resident buffers sized through the FIELD_DIMS model
# --------------------------------------------------------------------------


def model_bytes_for(qualname: str, shape) -> Optional[int]:
    """Analytic bytes of one resident buffer via the FIELD_DIMS model: the
    dims symbols bound to the CONCRETE shape (a tensor is one shard's
    block), then ``partition_rules.field_bytes``.  None for a qualname
    outside the model, or a rank the model does not have."""
    from ..parallel.partition_rules import FIELD_DIMS, field_bytes

    ent = FIELD_DIMS.get(qualname)
    if ent is None:
        return None
    dims, bits = ent
    if len(dims) != len(shape):
        return None
    env = {sym: int(s) for sym, s in zip(dims, shape)}
    if bits < 8:
        # a bit-packed plane: the concrete last axis is already 32-bit words
        env[dims[-1]] = int(shape[-1]) * 32
    return field_bytes(qualname, env)


def _census_entry(qualname: str, a) -> Dict[str, Any]:
    shape = tuple(int(s) for s in a.shape)
    actual = _tensor_bytes(a)
    model = model_bytes_for(qualname, shape)
    matched = model is not None and (actual == 0 or model == actual)
    return {
        "qualname": qualname,
        "shape": shape,
        "nbytes": actual,
        "per_shard_bytes": actual,
        "model_bytes": model,
        "matched": bool(matched),
        "device": str(getattr(a, "device", "")),
    }


def census_buffers(arr=None, inc=None, encoder=None, hoist=None) -> Dict[str, Any]:
    """The census of every resident device buffer the port owns, deduped by
    tensor identity (an IncState's planes ARE the HoistCache's):

      * ``arr``      a placed ClusterArrays (qualnames ``arr.*``)
      * ``inc``      an IncState (``inc.*``; on a mesh its per-shard states)
      * ``encoder``  a DeltaEncoder: its resident table
      * ``hoist``    a HoistCache: class planes, usage rows, memos

    Returns ``{"entries": [...], "resident_bytes", "per_shard_bytes",
    "model_bytes", "matched", "n_buffers"}`` as the JAX census does."""
    import dataclasses as _dc

    import torch

    entries: List[Dict[str, Any]] = []
    seen: set = set()

    def add(qualname: str, a) -> None:
        if isinstance(a, (tuple, list)):
            for x in a:
                add(qualname, x)
            return
        if not isinstance(a, torch.Tensor) or id(a) in seen:
            return
        seen.add(id(a))
        entries.append(_census_entry(qualname, a))

    if arr is not None:
        for f in _dc.fields(type(arr)):
            add(f"arr.{f.name}", getattr(arr, f.name))
    if encoder is not None:
        for key, ent in getattr(encoder, "_dev", {}).items():
            add(f"arr.{key[0] if isinstance(key, tuple) else key}", ent[-1])
    if hoist is not None:
        planes = ("inc.stat_u", "inc.elig_u", "inc.traw_u", "inc.naraw_u", "inc.img_u")
        statics = getattr(hoist, "_statics", None)
        if statics is not None:
            for q, a in zip(planes, statics):
                add(q, a)
        usage = getattr(hoist, "_usage", None)
        if usage is not None:
            add("inc.base_u", usage[0])
            add("inc.fit_u", usage[1])
        blocks = getattr(hoist, "_blocks", None) or {}
        for st in blocks.get("static", ()):
            for q, a in zip(planes, st):
                add(q, a)
        for us in blocks.get("usage", ()):
            add("inc.base_u", us[0])
            add("inc.fit_u", us[1])
        for key, ent in getattr(hoist, "_memo", {}).items():
            name = key[0] if isinstance(key, tuple) else key
            add("inc.cls" if name == "cls" else f"hoist.{name}", ent[1])
    if inc is not None:
        for name in inc._fields:
            if name == "shards":
                for sh in inc.shards or ():
                    for n2 in sh._fields:
                        if n2 != "shards":
                            add(f"inc.{n2}", getattr(sh, n2))
            else:
                add(f"inc.{name}", getattr(inc, name))
    return {
        "entries": entries,
        "resident_bytes": sum(e["nbytes"] for e in entries),
        "per_shard_bytes": sum(e["per_shard_bytes"] for e in entries),
        "model_bytes": sum(e["model_bytes"] or 0 for e in entries),
        "matched": all(e["matched"] for e in entries),
        "n_buffers": len(entries),
    }


# --------------------------------------------------------------------------
# the leak sentinel
# --------------------------------------------------------------------------


class LeakSentinel:
    """Monotone-growth detector over the per-cycle UNACCOUNTED live bytes
    (live minus census): unaccounted bytes rising on EVERY observed delta
    beyond ``slack_bytes`` in total is a leak.  Single noisy deltas,
    shrinkage, or sub-slack drift all stay clean."""

    def __init__(self, slack_bytes: int = SENTINEL_SLACK_BYTES, min_samples: int = SENTINEL_MIN_SAMPLES,
                 window: int = SENTINEL_WINDOW):
        from collections import deque

        self.slack_bytes = int(slack_bytes)
        self.min_samples = max(2, int(min_samples))
        self.samples = deque(maxlen=max(self.min_samples, int(window)))

    def observe(self, unaccounted_bytes: int) -> None:
        self.samples.append(int(unaccounted_bytes))

    def verdict(self) -> Dict[str, Any]:
        samples = list(self.samples)
        deltas = [b - a for a, b in zip(samples, samples[1:])]
        growth = (samples[-1] - samples[0]) if samples else 0
        leaking = len(samples) >= self.min_samples and all(d > 0 for d in deltas) and growth > self.slack_bytes
        return {
            "leaking": bool(leaking),
            "samples": samples,
            "deltas": deltas,
            "growth_bytes": int(growth),
            "slack_bytes": self.slack_bytes,
        }


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------


class DeviceMemoryLedger:
    """The per-run device-memory ledger: cycle-boundary samples of the
    measured side, the resident-buffer census, high-water marks, gauges and
    the leak sentinel.  ``baseline()`` anchors the measured deltas (call it
    before the first placement)."""

    def __init__(self, mesh=None, metrics=None, slack_bytes: int = SENTINEL_SLACK_BYTES):
        n_shards = int(mesh.size) if mesh is not None else 1
        self.pod_shards = int(getattr(mesh, "pods", 1) or 1) if mesh is not None else 1
        self.node_shards = n_shards // self.pod_shards
        self.metrics = metrics
        self.sentinel = LeakSentinel(slack_bytes=slack_bytes)
        self._baseline_live = 0
        self._baselined = False
        self.peak_live_bytes = 0
        self.peak_stats_bytes = 0
        self.peak_resident_bytes = 0
        self.last_census: Optional[Dict[str, Any]] = None
        self.last_stats: Optional[Dict[str, Any]] = None
        self.memory_stats_available = False
        self.live_available = False
        self.samples = 0
        self.census_matched = True
        self.census_unmatched: Dict[str, Dict[str, Any]] = {}

    def baseline(self) -> None:
        """Anchor the measured side at the current live-byte level."""
        self._baseline_live = live_device_bytes()["bytes"]
        self._baselined = True

    def cycle_sample(self, arr=None, inc=None, encoder=None, hoist=None, label: str = "") -> Dict[str, Any]:
        """One cycle-boundary observation: census the resident buffers,
        sample the measured side, feed the sentinel (where the live source
        is available), raise the high-water marks, stamp the
        ``device_hbm_*`` gauges."""
        if not self._baselined:
            self.baseline()
        census = census_buffers(arr=arr, inc=inc, encoder=encoder, hoist=hoist)
        live = live_device_bytes()
        stats = device_memory_stats()
        live_delta = max(0, live["bytes"] - self._baseline_live)
        unaccounted = live["bytes"] - self._baseline_live - census["resident_bytes"]
        if live["available"]:
            self.live_available = True
            self.sentinel.observe(unaccounted)
            self.peak_live_bytes = max(self.peak_live_bytes, live_delta)
        self.peak_resident_bytes = max(self.peak_resident_bytes, census["resident_bytes"])
        if stats["available"]:
            self.memory_stats_available = True
            self.peak_stats_bytes = max(self.peak_stats_bytes, stats["peak_bytes_in_use"] or stats["bytes_in_use"])
        self.last_census = census
        self.last_stats = stats
        self.census_matched = self.census_matched and census["matched"]
        for e in census["entries"]:
            if not e["matched"]:
                self.census_unmatched.setdefault(e["qualname"], e)
        self.samples += 1
        if self.metrics is not None:
            in_use = stats["bytes_in_use"] if stats["available"] else live_delta
            self.metrics.set("device_hbm_in_use_bytes", in_use)
            self.metrics.set_max("device_hbm_peak_bytes", self.hbm_peak_bytes())
            self.metrics.set("device_hbm_resident_bytes", census["resident_bytes"])
            self.metrics.set("device_hbm_unaccounted_bytes", unaccounted if live["available"] else 0)
        return {
            "label": label,
            "live_bytes": live["bytes"],
            "live_delta_bytes": live_delta,
            "resident_bytes": census["resident_bytes"],
            "unaccounted_bytes": unaccounted if live["available"] else None,
            "census_matched": census["matched"],
            "memory_stats_available": stats["available"],
            "live_available": live["available"],
        }

    # -- read side --

    def source(self) -> str:
        if self.memory_stats_available:
            return "memory_stats"
        return "memory_allocated" if self.live_available else "unavailable"

    def in_use_bytes(self) -> int:
        if self.memory_stats_available and self.last_stats is not None:
            return int(self.last_stats["bytes_in_use"])
        return max(0, live_device_bytes()["bytes"] - self._baseline_live)

    def hbm_peak_bytes(self) -> int:
        """The measured high-water: the allocator's peak where the stats
        are available, else the live delta's peak (0 where neither is)."""
        if self.memory_stats_available:
            return int(self.peak_stats_bytes)
        return int(self.peak_live_bytes)

    def per_shard_hbm_estimate(self) -> Optional[int]:
        """``shard_hbm_estimate``'s total from the dims of the resident
        buffers the last census saw; None without a resident ClusterArrays."""
        c = self.last_census or {}
        shapes = {e["qualname"]: e["shape"] for e in c.get("entries", [])}
        pr = shapes.get("arr.pod_req")
        nu = shapes.get("arr.node_used")
        if not (pr and nu):
            return None
        u = shapes.get("inc.req_u") or shapes.get("inc.base_u")
        from ..parallel.mesh import shard_hbm_estimate

        return int(shard_hbm_estimate(pr[0], nu[0], self.node_shards, n_res=pr[1], u_classes=(u[0] if u else None),
                                      pod_shards=self.pod_shards)["total"])

    def summary(self) -> Dict[str, Any]:
        """The artifact block: ``hbm_peak_bytes`` / ``hbm_resident_bytes``
        plus source, availability, the census match flag and the sentinel
        verdict."""
        return {
            "hbm_peak_bytes": self.hbm_peak_bytes(),
            "hbm_resident_bytes": int(self.peak_resident_bytes),
            "memwatch": {
                "mesh_shape": [self.pod_shards, self.node_shards],
                "source": self.source(),
                "memory_stats_available": self.memory_stats_available,
                "samples": self.samples,
                "census_matched": self.census_matched,
                "n_buffers": (self.last_census or {}).get("n_buffers", 0),
                "sentinel": self.sentinel.verdict(),
            },
        }

    def memory_block(self) -> Dict[str, Any]:
        """The compact block a flight-recorder record carries: in-use,
        peak, resident census, unaccounted, source."""
        unacc = self.sentinel.samples[-1] if self.sentinel.samples else 0
        return {
            "in_use": self.in_use_bytes(),
            "peak": self.hbm_peak_bytes(),
            "resident": (self.last_census or {}).get("resident_bytes", 0),
            "unaccounted": unacc,
            "source": self.source(),
        }


__all__ = [
    "SENTINEL_MIN_SAMPLES", "SENTINEL_SLACK_BYTES", "SENTINEL_WINDOW", "DeviceMemoryLedger", "LeakSentinel",
    "census_buffers", "device_memory_stats", "device_metered", "live_device_bytes", "memwatch_enabled", "model_bytes_for",
]
