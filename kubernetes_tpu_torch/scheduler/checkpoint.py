"""Checkpoint manager — fsynced JSON + checksum files.

reference: pkg/kubelet/checkpointmanager (file-based, checksummed state that
survives restarts) as used by cm/devicemanager; here it checkpoints the
scheduler's crash-restart state so a restarted scheduler doesn't double-place
in-flight binds before its watch catches up (SURVEY.md §5 checkpoint note:
"device-allocation-style checkpoint only for the assumed-pod ledger").
Everything else is crash-only: caches rebuild from LIST+WATCH.

The scheduler's checkpoint (save_scheduler_state / load_scheduler_state,
wired through Scheduler._checkpoint_state) carries exactly the state the
watch CANNOT reconstruct:

  assumed    the assumed-pod ledger (uid -> node): reservations whose bind
             publication may not have landed — restore() reconciles each
             against the store (bound: retired; unbound: requeued)
  wal        write-ahead record of in-flight deferred commits
             [(uid, node), ...]: a verdict that was durably decided but
             whose store publication rides the next cycle's device window.
             Replay is idempotent by construction (an already-bound entry
             is skipped), which with the append-before-publish ordering
             gives exactly-once application across any kill point.
  arrivals   per-pod first-admission AGE (uid -> seconds since admission at
             save time): the arrival half of the arrival->bind SLI rides
             the checkpoint, so a failover inflates p99 honestly instead of
             restarting the clock for requeued pods
  saved_at   host perf_counter at save (provenance/debugging only — ages
             are relative so clock bases never need to match)

A corrupt or truncated checkpoint is QUARANTINED, not silently discarded:
load() renames the bad file to `<name>.json.corrupt`, klogs a warning and
bumps `checkpoint_corrupt_total`, then returns None so the caller rebuilds
crash-only — operators get evidence, the scheduler gets a clean slate.

The port's copy of the JAX package's ``scheduler/checkpoint.py``: the file
format is the same, field for field, so either package's scheduler reads
the other's checkpoint.  Cost: every save serialises and fsyncs the whole
ledger, WAL and arrival table, and the Scheduler saves at every assume,
forget and WAL append, so an armed cycle of P pods is O(P^2) on the host.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple


class CheckpointManager:
    def __init__(self, directory: str, metrics=None, logger=None):
        self.directory = directory
        # observability is optional: a bare CheckpointManager stays usable
        # (devicemanager-style callers), the scheduler threads its own
        self.metrics = metrics
        self.log = logger
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.json")

    def save(self, name: str, data: Dict) -> None:
        payload = json.dumps(data, sort_keys=True)
        doc = json.dumps(
            {"checksum": hashlib.sha256(payload.encode()).hexdigest(), "data": data},
            sort_keys=True,
        )
        fd, tmp = tempfile.mkstemp(dir=self.directory)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(doc)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(name))  # atomic
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _quarantine(self, name: str, reason: str) -> None:
        """A checkpoint that fails to parse or verify is EVIDENCE: move it
        aside as <name>.json.corrupt (overwriting an older quarantine —
        the newest corpse is the useful one), warn, and count it."""
        path = self._path(name)
        try:
            os.replace(path, path + ".corrupt")
            moved = True
        except OSError:
            moved = False  # raced away / unreadable dir: nothing to keep
        if self.metrics is not None:
            self.metrics.inc("checkpoint_corrupt_total")
        if self.log is not None:
            self.log.V(0).error(
                "Corrupt checkpoint quarantined; rebuilding crash-only",
                checkpoint=name, reason=reason,
                quarantine=(path + ".corrupt") if moved else "",
            )

    def load(self, name: str) -> Optional[Dict]:
        """None when absent or corrupt (the caller rebuilds from the watch —
        crash-only); a corrupt file is quarantined as <name>.json.corrupt
        with a klog warning + checkpoint_corrupt_total bump, never silently
        swallowed."""
        try:
            with open(self._path(name)) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None  # absent is the normal first boot, not corruption
        except OSError as e:
            # transient READ failure (EIO, EACCES, ...): the file may be a
            # perfectly valid checkpoint — leave it in place for a retry or
            # an operator, never destroy the WAL over an I/O hiccup
            if self.log is not None:
                self.log.V(0).error(
                    "Checkpoint unreadable, left in place; rebuilding "
                    "crash-only", checkpoint=name, reason=str(e),
                )
            return None
        except ValueError as e:  # json parse (UnicodeDecodeError included)
            self._quarantine(name, f"{type(e).__name__}: {e}")
            return None
        try:
            payload = json.dumps(doc["data"], sort_keys=True)
            if hashlib.sha256(payload.encode()).hexdigest() != doc["checksum"]:
                self._quarantine(name, "checksum mismatch")
                return None
            return doc["data"]
        except (ValueError, KeyError, TypeError) as e:
            self._quarantine(name, f"{type(e).__name__}: {e}")
            return None


def save_assumed(cm: CheckpointManager, assumed: Dict[str, str]) -> None:
    cm.save("assumed_pods", {"assumed": assumed})


def load_assumed(cm: CheckpointManager) -> Dict[str, str]:
    doc = cm.load("assumed_pods")
    return dict(doc["assumed"]) if doc else {}


# --- the scheduler's crash-restart checkpoint (one file, one fsync) ---
SCHEDULER_STATE = "scheduler_state"


def save_scheduler_state(
    cm: CheckpointManager,
    assumed: Dict[str, str],
    wal: List[Tuple[str, str]],
    arrivals: Dict[str, float],
    lineage: str = "",
    wave: Optional[Dict] = None,
    cursor: Optional[Dict] = None,
    popped: Optional[Dict[str, float]] = None,
) -> None:
    cm.save(
        SCHEDULER_STATE,
        {
            # cluster lineage (store.py — ClusterStore.lineage): uids are
            # deterministic, so restore() must refuse to replay this state
            # into a DIFFERENT cluster whose uids merely collide
            "lineage": str(lineage),
            "assumed": dict(assumed),
            "wal": [[uid, node] for uid, node in wal],
            "arrivals": dict(arrivals),
            # wave WAL (streaming crash-consistency): the in-flight commit
            # wave's membership + verdict crc ({"uids": [...],
            # "verdict_crc": str}), present only while a wave is between
            # verdict and full publication — restore() splits it into the
            # published prefix (store shows the bind), the durable suffix
            # (deferred-bind wal above) and the requeued remainder
            "wave": dict(wave) if wave else None,
            # open-loop replay cursor ({"v_now", "i", "trace_crc",
            # "scenario"}): the arrival trace's virtual clock + event offset
            # ride the checkpoint so a standby resumes the replay at the
            # exact trace position the leader died at (bench/loadgen.py)
            "cursor": dict(cursor) if cursor else None,
            # per-pod latest activeQ-pop AGE (uid -> seconds): the
            # queue_wait/wave_wait SLI boundary — restored so a pod popped
            # into a wave pre-kill keeps its original queue_wait and the
            # blackout lands in wave_wait, not queue_wait
            "popped": dict(popped) if popped else {},
            "saved_at": time.perf_counter(),
            # wall clock of the save: restore adds (now_wall - saved_wall)
            # to every arrival age so the BLACKOUT — the dead time between
            # the last checkpoint and the takeover — counts toward the SLI
            # (ages alone would silently forgive it)
            "saved_wall": time.time(),
        },
    )


def load_scheduler_state(cm: CheckpointManager) -> Optional[Dict]:
    """The checkpoint doc with every field defaulted, or None when absent/
    corrupt (corruption was quarantined + counted by load())."""
    doc = cm.load(SCHEDULER_STATE)
    if doc is None:
        return None
    wave = doc.get("wave") or None
    cursor = doc.get("cursor") or None
    return {
        "lineage": str(doc.get("lineage") or ""),
        "assumed": dict(doc.get("assumed") or {}),
        "wal": [(str(u), str(n)) for u, n in (doc.get("wal") or [])],
        "arrivals": {
            str(k): float(v) for k, v in (doc.get("arrivals") or {}).items()
        },
        "wave": {
            "uids": [str(u) for u in (wave.get("uids") or [])],
            "verdict_crc": str(wave.get("verdict_crc") or ""),
        } if isinstance(wave, dict) else None,
        "cursor": dict(cursor) if isinstance(cursor, dict) else None,
        "popped": {
            str(k): float(v) for k, v in (doc.get("popped") or {}).items()
        },
        "saved_at": float(doc.get("saved_at") or 0.0),
        "saved_wall": float(doc.get("saved_wall") or 0.0),
    }
