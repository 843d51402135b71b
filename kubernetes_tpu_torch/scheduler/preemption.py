"""Host orchestration of batched preemption (ops/preempt.py) — the port of
the JAX package's ``scheduler/preemption.py``.

Mirrors the CPU evaluator's semantics exactly (the JAX package's
scheduler/plugins/cpu.py — DefaultPreemption, the oracle): per failed pod,
candidate victims are the lower-priority bound pods per node in the SAME
reprieve order the CPU path uses (PDB-violating first, then non-violating,
each by (-priority, uid), over the snapshot's bound order), the device scan
reprieves them against the preemptor's fit, and the host applies
pickOneNodeForPreemption's lexicographic key.

Scope gate (`applicable`): pods whose Filter outcome could depend on
pairwise state, host ports, or volume/claim topology belong to the CPU
evaluator (scheduler/plugins/cpu.py — DefaultPreemption), which the
Scheduler's failure loop runs for them.

State is incremental across one failure loop: an eviction updates the
victim node's row and usage in place; PDB-budget changes are fingerprinted
per call and invalidate the per-priority victim tables.  The host arrays
are numpy; each wave's inputs go to the encoded arrays' device and its
outputs come back in one read.  The class reads the store and the queue
duck-typed: ``store.pdbs`` (key -> PodDisruptionBudget) and
``queue.nominated`` (uid -> (pod, node name)).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import types as t
from ..api.snapshot import EncodingMeta, pod_effective_requests


def _split_pdb_violating(pods, pdbs):
    # the CPU evaluator's exact split (plugins/cpu.py — _split_pdb_violating)
    remaining = {pdb.key: pdb.disruptions_allowed for pdb in pdbs}
    violating, non_violating = [], []
    for q in pods:
        hit = [pdb for pdb in pdbs if pdb.matches(q)]
        if any(remaining[pdb.key] <= 0 for pdb in hit):
            violating.append(q)
        else:
            for pdb in hit:
                remaining[pdb.key] -= 1
            non_violating.append(q)
    return violating, non_violating


class BatchedPreemption:
    """One failure loop's resident state: per-node bound pods + usage, the
    encoded cycle arrays, and per-(priority, pdb-state) victim tables."""

    def __init__(self, arr, meta: EncodingMeta, snap, store, queue):
        self.arr = arr
        self.meta = meta
        self.store = store
        self.queue = queue
        self.scale = np.asarray(meta.resource_scale, dtype=np.int64)
        self.resources = list(meta.resources)
        self.node_idx: Dict[str, int] = {
            name: i for i, name in enumerate(meta.node_names)
        }
        self.pod_row: Dict[str, int] = {}
        for k in range(meta.n_pods):
            self.pod_row.setdefault(meta.pod_names[k], k)
        n = len(meta.node_names)
        self.node_pods: List[List[t.Pod]] = [[] for _ in range(n)]
        self.used_raw = np.zeros((n, len(self.resources)), dtype=np.int64)
        for q in snap.bound_pods:
            i = self.node_idx.get(q.node_name)
            if i is not None:
                self.node_pods[i].append(q)
                self.used_raw[i] += np.array(
                    pod_effective_requests(q, self.resources), dtype=np.int64
                )
        # pairwise anywhere in the cluster state? (existing pods' anti terms
        # can constrain ANY preemptor, so their mere presence gates).  Derived
        # from the FRESH post-bind snapshot, not the cycle's pre-bind arrays:
        # anti-affinity pods bound earlier in this very batch must gate too.
        self._has_anti = any(
            q.affinity is not None and q.affinity.required_pod_anti_affinity
            for q in snap.bound_pods
        )
        self._level_cache: Dict[Tuple, Tuple] = {}
        # wave state (evaluate-many batching): device stats for up to _WAVE
        # same-priority preemptors computed against one state snapshot, plus
        # the monotone log of node indices dirtied since — the sequential
        # commit pass repairs exactly those nodes on host (phases A-C for a
        # single node are O(V) numpy work)
        self._pending: List[str] = []  # uids awaiting wave membership
        self._pending_pods: Dict[str, t.Pod] = {}
        self._waves: Dict[int, dict] = {}  # priority -> live wave
        self._dirty_log: List[int] = []
        self.wave_hits = 0  # evaluations served from a wave (tests/bench)
        self.single_hits = 0
        self._alloc_np: Optional[np.ndarray] = None

    # --- gate ---
    def applicable(self, pod: t.Pod) -> bool:
        if pod.name not in self.pod_row:
            return False  # not in this cycle's encoding (shouldn't happen)
        if pod.host_ports or pod.pvcs or pod.resource_claims:
            return False
        if self._has_anti:
            return False
        if pod.topology_spread:
            return False
        a = pod.affinity
        if a is not None and (
            a.required_pod_affinity or a.required_pod_anti_affinity
        ):
            return False
        return True

    # --- victim tables ---
    def _pdb_fp(self):
        pdbs = list(getattr(self.store, "pdbs", {}).values())
        return tuple((p.key, p.disruptions_allowed) for p in pdbs), pdbs

    def _tables(self, priority: int):
        fp, pdbs = self._pdb_fp()
        key = (priority, fp)
        ent = self._level_cache.get(key)
        if ent is None:
            n = len(self.node_pods)
            ordered: List[List[Tuple[t.Pod, bool]]] = []
            vmax = 1
            for pods in self.node_pods:
                lower = [q for q in pods if q.priority < priority]
                violating, non_violating = _split_pdb_violating(lower, pdbs)
                row = [
                    (q, True)
                    for q in sorted(violating, key=lambda q: (-q.priority, q.uid))
                ] + [
                    (q, False)
                    for q in sorted(
                        non_violating, key=lambda q: (-q.priority, q.uid)
                    )
                ]
                ordered.append(row)
                vmax = max(vmax, len(row))
            V = 1 << (vmax - 1).bit_length() if vmax > 1 else 1
            N = self.arr.N
            R = len(self.resources)
            vict_req = np.zeros((N, V, R), dtype=np.int64)
            vict_prio = np.zeros((N, V), dtype=np.int32)
            vict_viol = np.zeros((N, V), dtype=bool)
            vict_valid = np.zeros((N, V), dtype=bool)
            for i, row in enumerate(ordered):
                for j, (q, viol) in enumerate(row):
                    vict_req[i, j] = pod_effective_requests(q, self.resources)
                    vict_prio[i, j] = q.priority
                    vict_viol[i, j] = viol
                    vict_valid[i, j] = True
            # scale exactly like the encoder (ceil division; gcd scales are
            # exact so sums commute with the encoded node_used)
            vict_req_s = -(-vict_req // self.scale)
            ent = (ordered, vict_req_s.astype(np.int32), vict_prio, vict_viol,
                   vict_valid)
            self._level_cache[key] = ent
        return ent

    # --- evaluate-many batching (the preemptor axis) ---
    # max preemptors per device evaluation; 0 disables waves entirely (every
    # evaluation single — the A/B baseline).  The EFFECTIVE K additionally
    # scales down with the victim-table size so the wave's outputs stay
    # under _WAVE_BYTES (see _wave_cap).  The JAX package's defaults; tests
    # may set the attributes.
    _WAVE = 64
    # byte budget for one wave's [K, N, V]-shaped outputs and stat rows
    _WAVE_BYTES = 256 * 1024 * 1024

    def _wave_cap(self, V: int) -> int:
        """Preemptors per wave so K·N·V stays under the byte budget:
        ~2 bytes per (K, N, V) cell (bool is_victim + scan slot flags) plus
        the [K, N] int32 stat rows."""
        per_k = 2 * self.arr.N * max(1, V) + 32 * self.arr.N
        return max(1, min(self._WAVE, self._WAVE_BYTES // per_k))

    def prefetch(self, pods: List[t.Pod]) -> None:
        """Register the failure loop's upcoming preemptors so evaluate()
        can serve them from batched waves.  Pods outside the gate, or
        currently nominated (their self-exclusion from the nominated
        reservation is per-preemptor — not wave-shareable), stay on the
        single-pod path."""
        if self._WAVE <= 0:
            return  # waves disabled (A/B baseline)
        for q in pods:
            if self.applicable(q) and q.uid not in self.queue.nominated:
                self._pending.append(q.uid)
                self._pending_pods[q.uid] = q

    def _nominated_raw(
        self, priority: int, N: int, R: int, exclude_uid: Optional[str] = None
    ):
        """RAW (unscaled) nominated reservations per node for a preemptor of
        this priority.  The ONE accumulation convention: sum raw int64
        requests, then ceil-scale the SUM once — every consumer (wave
        build, single eval, dirty-node repair) must scale identically or
        wave-served and single-served decisions drift at scaled-unit
        boundaries."""
        nom_raw = np.zeros((N, R), dtype=np.int64)
        has_nom = np.zeros(N, dtype=bool)
        for uid, (q, node) in self.queue.nominated.items():
            if uid == exclude_uid or q.priority < priority:
                continue
            i = self.node_idx.get(node)
            if i is not None:
                nom_raw[i] += np.array(
                    pod_effective_requests(q, self.resources), dtype=np.int64
                )
                has_nom[i] = True
        return nom_raw, has_nom

    def _nominated_arrays(self, priority: int, N: int, R: int):
        """Scaled nominated reservations for a wave of this priority (no
        per-preemptor exclusion: nominated pods never join waves)."""
        nom_raw, has_nom = self._nominated_raw(priority, N, R)
        return (-(-nom_raw // self.scale)).astype(np.int32), has_nom

    def _build_wave(self, first: t.Pod) -> None:
        """One device program for the next _WAVE pending preemptors sharing
        `first`'s priority, against the CURRENT state snapshot.  Keyed by
        priority: interleaved priorities in the failure loop each keep
        their own live wave instead of evicting each other's."""
        from ..ops.preempt import preempt_eval_wave, to_host

        prio = first.priority
        fp, _ = self._pdb_fp()
        ordered, vict_req, vict_prio, vict_viol, vict_valid = self._tables(
            prio
        )
        k_cap = self._wave_cap(vict_valid.shape[1])
        members: List[t.Pod] = []
        rest: List[str] = []
        for uid in self._pending:
            q = self._pending_pods.get(uid)
            if q is None:
                continue
            if q.priority == prio and len(members) < k_cap:
                members.append(q)
            else:
                rest.append(uid)
        self._pending = rest
        for q in members:
            self._pending_pods.pop(q.uid, None)
        N = self.arr.N
        R = len(self.resources)
        used_s = np.zeros((N, R), dtype=np.int32)
        n = len(self.node_pods)
        used_s[:n] = -(-self.used_raw // self.scale)
        nom_s, has_nom = self._nominated_arrays(prio, N, R)
        # pow2-bucket K (pad with row 0 repeats; padded outputs unread), as
        # the JAX package buckets its jit signature
        K = len(members)
        Kp = 1 << max(0, (K - 1).bit_length())
        rows = [self.pod_row[q.name] for q in members]
        idxs = np.array(rows + [rows[0]] * (Kp - K), dtype=np.int32)
        out = preempt_eval_wave(
            self.arr, idxs, used_s, nom_s, has_nom,
            vict_req, vict_prio, vict_viol, vict_valid,
        )
        cand, nvio, vmax, vsum, vcnt, is_victim, static = to_host(out)
        self._waves[prio] = {
            "uid_to_i": {q.uid: i for i, q in enumerate(members)},
            "fp": fp,
            "mark": len(self._dirty_log),  # dirt before this = already seen
            "cand": cand, "nvio": nvio, "vmax": vmax, "vsum": vsum,
            "vcnt": vcnt, "is_victim": is_victim, "static": static,
        }
        if self._alloc_np is None:
            self._alloc_np = self.arr.node_alloc.cpu().numpy()

    def _host_node_stats(self, pod: t.Pod, static_ok: bool, n: int):
        """Phases A-C for ONE node on host, against CURRENT state — the
        exact repair for nodes dirtied after a wave's device snapshot.
        Mirrors ops/preempt.py per slot: same reprieve order (the live
        table row), same fit form (req <= alloc - used, zero-request
        resources never block), same ok2 nominated re-check."""
        ordered, *_ = self._tables(pod.priority)
        row = ordered[n]
        alloc = self._alloc_np[n].astype(np.int64)
        used = -(-self.used_raw[n] // self.scale)
        req = np.array(
            pod_effective_requests(pod, self.resources), dtype=np.int64
        )
        req_s = -(-req // self.scale)
        # same raw-sum-then-ceil convention as _nominated_arrays /
        # _evaluate_single — per-pod ceils would over-reserve by up to one
        # scaled unit per nominated pod and flip boundary decisions
        nom_raw_row = np.zeros_like(used)
        has_nom = False
        for uid, (q, node) in self.queue.nominated.items():
            if uid == pod.uid or q.priority < pod.priority:
                continue
            if self.node_idx.get(node) == n:
                nom_raw_row += np.array(
                    pod_effective_requests(q, self.resources), dtype=np.int64
                )
                has_nom = True
        nom = -(-nom_raw_row // self.scale)

        def fit(u):
            return bool(np.all((req_s == 0) | (req_s <= alloc - u)))

        vreqs = [
            -(
                -np.array(
                    pod_effective_requests(q, self.resources), dtype=np.int64
                )
                // self.scale
            )
            for q, _ in row
        ]
        base = used + nom - (
            np.sum(vreqs, axis=0) if vreqs else np.zeros_like(used)
        )
        okA = bool(static_ok) and fit(base)
        used_cur = base
        victims: List[Tuple[t.Pod, bool]] = []
        for (q, viol), vr in zip(row, vreqs):
            trial = used_cur + vr
            if okA and fit(trial):
                used_cur = trial  # reprieved
            elif okA:
                victims.append((q, viol))
        vcnt = len(victims)
        ok2 = fit(used_cur - nom) if (has_nom and vcnt > 0) else True
        nvio = sum(1 for _, viol in victims if viol)
        vmax = max(
            (q.priority for q, _ in victims),
            default=np.iinfo(np.int32).min,
        )
        vsum = sum(q.priority for q, _ in victims)
        cand = okA and ok2 and vcnt > 0
        return cand, nvio, vmax, vsum, vcnt, [q for q, _ in victims]

    def note_nomination_cleared(self, pod: t.Pod) -> None:
        """The failure loop is about to clear this pod's nomination: the
        freed reservation changes later preemptors' view of that node."""
        ent = self.queue.nominated.get(pod.uid)
        if ent is not None:
            i = self.node_idx.get(ent[1])
            if i is not None:
                self._dirty_log.append(i)

    def _wave_decide(self, pod: t.Pod) -> Optional[Tuple[str, List[t.Pod]]]:
        w = self._waves[pod.priority]
        i = w["uid_to_i"][pod.uid]
        dirty = sorted(set(self._dirty_log[w["mark"]:]))
        over = {
            n: self._host_node_stats(pod, w["static"][i, n], n)
            for n in dirty
        }
        cand = w["cand"][i]
        nvio, vmax, vsum, vcnt = (
            w["nvio"][i], w["vmax"][i], w["vsum"][i], w["vcnt"][i]
        )
        if over:
            cand, nvio, vmax, vsum, vcnt = (
                a.copy() for a in (cand, nvio, vmax, vsum, vcnt)
            )
            for n, (c, nv, vm, vs, vc, _) in over.items():
                cand[n], nvio[n], vmax[n], vsum[n], vcnt[n] = (
                    c, nv, vm, vs, vc
                )
        if not cand.any():
            return None
        idx = np.flatnonzero(cand)
        order = np.lexsort((idx, vcnt[idx], vsum[idx], vmax[idx], nvio[idx]))
        best = int(idx[order[0]])
        if best in over:
            victims = over[best][5]
        else:
            ordered, *_ = self._tables(pod.priority)
            victims = [
                ordered[best][j][0]
                for j in np.flatnonzero(w["is_victim"][i, best])
            ]
        return self.meta.node_names[best], victims

    # --- the evaluation (one failed pod) ---
    def evaluate(self, pod: t.Pod) -> Optional[Tuple[str, List[t.Pod]]]:
        """Wave-served when the pod was prefetched (one device program per
        _WAVE same-priority preemptors + exact host repair of dirtied
        nodes); single device program otherwise.  Decisions identical
        either way (tests/test_preemption_batched.py — wave cases)."""
        w = self._waves.get(pod.priority)
        if w is not None and self._pdb_fp()[0] != w["fp"]:
            del self._waves[pod.priority]  # PDB moved: snapshot stale
            w = None
        if (
            w is None or pod.uid not in w["uid_to_i"]
        ) and pod.uid in self._pending_pods:
            self._build_wave(pod)
            w = self._waves.get(pod.priority)
        if w is not None and pod.uid in w["uid_to_i"]:
            self.wave_hits += 1
            return self._wave_decide(pod)
        self.single_hits += 1
        return self._evaluate_single(pod)

    def _evaluate_single(
        self, pod: t.Pod
    ) -> Optional[Tuple[str, List[t.Pod]]]:
        from ..ops.preempt import preempt_eval, to_host

        ordered, vict_req, vict_prio, vict_viol, vict_valid = self._tables(
            pod.priority
        )
        N = self.arr.N
        R = len(self.resources)
        used_s = np.zeros((N, R), dtype=np.int32)
        n = len(self.node_pods)
        used_s[:n] = -(-self.used_raw // self.scale)
        nom_raw, has_nom = self._nominated_raw(
            pod.priority, N, R, exclude_uid=pod.uid
        )
        nom_s = (-(-nom_raw // self.scale)).astype(np.int32)
        cand, nvio, vmax, vsum, vcnt, is_victim = to_host(preempt_eval(
            self.arr, self.pod_row[pod.name], used_s, nom_s, has_nom,
            vict_req, vict_prio, vict_viol, vict_valid,
        ))
        if not cand.any():
            return None
        # pickOneNodeForPreemption's lexicographic order, lowest node index
        # breaking ties (plugins/cpu.py key)
        idx = np.flatnonzero(cand)
        order = np.lexsort((idx, vcnt[idx], vsum[idx], vmax[idx], nvio[idx]))
        best = int(idx[order[0]])
        victims = [ordered[best][j][0] for j in np.flatnonzero(is_victim[best])]
        return self.meta.node_names[best], victims

    # --- incremental state update after an eviction ---
    def apply_eviction(self, node_name: str, victims: List[t.Pod]) -> None:
        i = self.node_idx[node_name]
        # waves built before this eviction repair this node from the log
        # (the nomination that follows a successful preemption lands on the
        # SAME node, so one entry covers both state changes)
        self._dirty_log.append(i)
        gone = {q.uid for q in victims}
        self.node_pods[i] = [q for q in self.node_pods[i] if q.uid not in gone]
        for q in victims:
            self.used_raw[i] -= np.array(
                pod_effective_requests(q, self.resources), dtype=np.int64
            )
        # victim tables reference the old row on this node only: RE-derive the
        # row (split + reprieve order) from scratch — an evicted non-violating
        # victim frees the PDB budget it consumed, which can flip later pods'
        # violating flag, exactly as the CPU evaluator would see on its next
        # PostFilter call.  (Arrays are private to this loop: in-place patch.)
        for (priority, fp), ent in self._level_cache.items():
            ordered, vict_req, vict_prio, vict_viol, vict_valid = ent
            _, pdbs = self._pdb_fp()
            lower = [q for q in self.node_pods[i] if q.priority < priority]
            violating, non_violating = _split_pdb_violating(lower, pdbs)
            row = [
                (q, True)
                for q in sorted(violating, key=lambda q: (-q.priority, q.uid))
            ] + [
                (q, False)
                for q in sorted(non_violating, key=lambda q: (-q.priority, q.uid))
            ]
            ordered[i] = row
            vict_req[i] = 0
            vict_prio[i] = 0
            vict_viol[i] = False
            vict_valid[i] = False
            for j, (q, viol) in enumerate(row[: vict_req.shape[1]]):
                vict_req[i, j] = -(
                    -np.array(
                        pod_effective_requests(q, self.resources), dtype=np.int64
                    )
                    // self.scale
                )
                vict_prio[i, j] = q.priority
                vict_viol[i, j] = viol
                vict_valid[i, j] = True
