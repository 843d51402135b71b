"""Decision flight recorder — the scheduler's crash black box.

A bounded ring of the last K batch cycles' COMPACT decision records: wave
verdict fingerprints, the class-index fingerprint, dirty-column counts, the
diagnosis vectors (when KTPU_EXPLAIN ran), the per-wave SLI phase block and
trace ids — a few hundred bytes of host dict per cycle, no device work, no
O(P) state.  It piggybacks on the crash-restart checkpoint dir both ways:
armed by it (an unarmed scheduler skips recording entirely — nothing could
ever dump the ring) and dumped into it when the process dies on an
enumerated kill site or a device wave needs serial-replay recovery, so a
crash or a parity miss ships with the evidence (load_flight /
render_flight read a dump back).

Deviation from the kill discipline (a dying incarnation does NOTHING a
SIGKILL'd process couldn't): the dump bends it for diagnostics only —
flight records are never read by restore(), never fsync'd, and carry no
placement authority (the airline black box written on the way down; a
production deployment would stream records out-of-process).  The ring
itself lives in memory; ``capacity`` sizes it (default 64).

The port's copy of the JAX package's ``scheduler/flightrecorder.py``:
`fingerprint` gives the JAX one's crc on the same dicts and arrays, and a
dump is the same JSON document.  The JAX package's command line reader
(``analysis --flight``) is not ported; a record carries no device-memory
block (the port has no memory ledger).
"""

from __future__ import annotations

import json
import os
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

from ..analysis.lockcheck import make_lock

FLIGHT_FILENAME = "flight.json"


def fingerprint(obj) -> str:
    """Stable 8-hex-digit content fingerprint (crc32) — two incarnations
    (or a replay) producing identical decisions produce identical
    fingerprints, so a parity miss is visible at a glance.  Cheap enough
    for the always-on per-cycle record: ndarrays hash their raw bytes
    (O(P) memcpy), dicts hash items INCREMENTALLY in insertion order (the
    scheduler's verdict dict fills in deterministic pending-pod order) —
    no sort, no monolithic repr string at 50k-pod scale."""
    if hasattr(obj, "tobytes"):
        return f"{zlib.crc32(obj.tobytes()) & 0xFFFFFFFF:08x}"
    if isinstance(obj, dict):
        crc = 0
        for k, v in obj.items():
            crc = zlib.crc32(f"{k}\x00{v}\x1e".encode(), crc)
        return f"{crc & 0xFFFFFFFF:08x}"
    return f"{zlib.crc32(repr(obj).encode()) & 0xFFFFFFFF:08x}"


class FlightRecorder:
    def __init__(self, directory: Optional[str] = None, capacity: int = 64):
        self.capacity = max(1, capacity)
        self.directory = directory
        self._lock = make_lock("FlightRecorder._lock")
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._context: Dict = {}

    def annotate(self, **fields) -> None:
        """Run-level context merged into every later dump (not per-cycle —
        the ring holds those).  The open-loop replay driver stamps the
        arrival-trace fingerprint and its live cursor here each cycle, so
        a mid-stream kill's black box says WHERE in the trace it died."""
        with self._lock:
            self._context.update(fields)

    def record(self, **fields) -> None:
        """Append one cycle record (called once per profile batch — the
        record is a small host dict; the ring bounds total memory)."""
        with self._lock:
            self._seq += 1
            self._ring.append({"seq": self._seq, **fields})

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str = "") -> Optional[str]:
        """Write the ring to <directory>/flight.json (atomic rename; the
        last dump wins — the most recent death owns the black box).  None
        when no checkpoint directory is armed or the write fails: dumping
        evidence must never mask the fault it documents."""
        if not self.directory:
            return None
        with self._lock:
            context = dict(self._context)
        doc = {
            "version": 1,
            "reason": reason,
            "dumped_wall": time.time(),
            "capacity": self.capacity,
            "context": context,
            "records": self.records(),
        }
        path = os.path.join(self.directory, FLIGHT_FILENAME)
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            return None
        return path


def load_flight(path: str) -> Dict:
    """Parse a flight dump; raises ValueError on a missing/corrupt file
    (the --flight CLI maps that to exit 2 — unusable, never silently ok)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable flight dump {path}: {e}") from None
    if (not isinstance(doc, dict)
            or not isinstance(doc.get("records"), list)
            or not all(isinstance(r, dict) for r in doc["records"])):
        raise ValueError(f"not a flight dump: {path}")
    return doc


def render_flight(doc: Dict) -> str:
    """Human rendering for the post-mortem CLI: one line per cycle record,
    newest last, diagnosis summarized as its top reasons."""
    out = [
        f"flight recorder dump — reason: {doc.get('reason') or '<none>'}, "
        f"{len(doc['records'])} record(s) "
        f"(ring capacity {doc.get('capacity', '?')})"
    ]
    ctx = doc.get("context")
    if isinstance(ctx, dict) and ctx:
        # the run-level annotation block (annotate()): for an open-loop
        # kill this names the arrival trace and the offset it died at
        out.append("  context: " + " ".join(
            f"{k}={ctx[k]}" for k in sorted(ctx)
        ))
    for r in doc["records"]:
        line = (
            f"  #{r.get('seq', '?'):>4} {r.get('profile', '')} "
            f"pods={r.get('pods', '?')} scheduled={r.get('scheduled', '?')} "
            f"failed={r.get('failed', '?')} "
            f"verdicts={r.get('verdict_crc', '-')}"
        )
        if r.get("class_crc"):
            line += (f" classes={r.get('classes', '?')}@{r['class_crc']}"
                     f" dirty_cols={r.get('dirty_cols', -1)}")
        if r.get("trace_id"):
            line += f" trace={r['trace_id'][:8]}"
        mem = r.get("mem")
        if isinstance(mem, dict):
            # a memory block (the JAX package's device-memory ledger
            # writes one; the port's records carry none)
            line += (
                f" hbm[in_use={mem.get('in_use', '?')}"
                f" peak={mem.get('peak', '?')}"
                f" resident={mem.get('resident', '?')}"
                f" unaccounted={mem.get('unaccounted', '?')}"
                f" src={mem.get('source', '?')}]"
            )
        out.append(line)
        sli = r.get("sli_phases")
        if isinstance(sli, dict):
            # the per-wave SLI phase block (scheduler._sli_phase_block):
            # where did this cycle's bound pods spend their latency, and
            # which pod was slowest?
            mean = sli.get("mean_ms")
            mean = mean if isinstance(mean, dict) else {}
            dom = max(mean, key=lambda k: mean[k]) if mean else "?"
            worst = sli.get("worst")
            worst = worst if isinstance(worst, dict) else {}
            out.append(
                f"        sli x{sli.get('pods', '?')} pods:"
                f" dominant={dom}"
                f" mean_ms={{{', '.join(f'{k}={v}' for k, v in mean.items())}}}"
                f" worst={worst.get('pod', '?')}"
                f"@{worst.get('sli_ms', '?')}ms"
            )
        diagnosis = r.get("diagnosis")
        for d in diagnosis if isinstance(diagnosis, list) else []:
            if not isinstance(d, dict):
                continue  # structurally corrupt entry: skip, never crash
            counts = d.get("counts")
            top = sorted(counts.items() if isinstance(counts, dict) else [],
                         key=lambda kv: (-kv[1], kv[0]))[:3]
            out.append(
                f"        class@row{d.get('rep_row')} x{d.get('pods')} pods: "
                + (", ".join(f"{c} {lbl}" for lbl, c in top) or "<no counts>")
            )
    return "\n".join(out)
