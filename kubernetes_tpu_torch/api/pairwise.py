"""Encoding for the pairwise plugins (PodTopologySpread, InterPodAffinity,
NodePorts) — the port of the JAX package's ``api/pairwise.py``.

Every (pod-label selector, namespace set, topology key) triple that appears
in a spread constraint or an (anti-)affinity term is interned as a *term*.
The cluster-side state the plugins need then collapses to per-(term,
domain) counts (domain = an interned (key, value); column D = "the node
lacks the key"), which ops/pairwise.py carries per node through the scan.
Selector-vs-pod matching is one host-side 0/1 product over a pod-label
literal vocabulary (``_match_matrix``); ``match_inputs`` hands the same
masks to the ring matcher (parallel/ring.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import types as t
from . import vocab as v

# spread modes
HARD = 1  # DoNotSchedule -> Filter
SOFT = 0  # ScheduleAnyway -> Score only


@dataclass(frozen=True)
class TermKey:
    """Interned identity of a pairwise term."""

    topology_key: str
    namespaces: Tuple[str, ...]
    selector: Optional[t.LabelSelector]  # None matches nothing


@dataclass
class PairwiseVocab:
    topo_keys: v.Interner  # topology key -> k
    domains: v.Interner  # (key, value) -> d  (D == len == "absent" sentinel)
    terms: v.Interner  # TermKey -> t
    ports: v.Interner  # (protocol, port) -> id


def _term_of_affinity(term, pod_ns: str) -> TermKey:
    ns = tuple(sorted(term.namespaces)) if term.namespaces else (pod_ns,)
    return TermKey(term.topology_key, ns, term.label_selector)


def _term_of_spread(c, pod_ns: str) -> TermKey:
    # spread counts pods in the pod's own namespace (podtopologyspread/common.go)
    return TermKey(c.topology_key, (pod_ns,), c.label_selector)


def _matches(term: TermKey, pod) -> bool:
    if term.selector is None:
        return False
    return pod.namespace in term.namespaces and term.selector.matches(pod.labels)


_NS_KEY = "\x00ns"  # pseudo label key carrying the pod's namespace


def _lowered(terms: List[TermKey], pods: Sequence):
    """(mask [S, E, L], kind [S, E], labels f32[P, L], ids[T]): the distinct
    lowered selectors of `terms` (term t is row ids[t]) and the pods' label
    rows over one literal vocabulary.

    The AnyOf/NoneOf lowering of node terms (api/vocab.py) over a pod-label
    literal vocabulary, with the namespace test as one more AnyOf over
    pseudo-literals."""
    voc = v.LabelVocab()
    pod_lits = [voc.add_labels({**pod.labels, _NS_KEY: pod.namespace}) for pod in pods]
    L = max(1, len(voc))
    labels = np.zeros((len(pods), L), dtype=np.float32)
    for i, lits in enumerate(pod_lits):
        labels[i, lits] = 1.0

    table = v.TermTable()
    ids = []
    for term in terms:
        if term.selector is None:
            ids.append(table.intern(v.FALSE_TERM))
            continue
        lowered = v.lower_node_term(v.label_selector_to_requirements(term.selector), voc)
        if lowered is not v.FALSE_TERM:
            ns_lits = frozenset(lit for ns in term.namespaces if (lit := voc.lit(_NS_KEY, ns)) is not None)
            if not ns_lits:
                lowered = v.FALSE_TERM
            else:
                lowered = tuple(sorted([*lowered, (v.KIND_ANY, ns_lits)], key=lambda e: (e[0], sorted(e[1]))))
        ids.append(table.intern(lowered))
    mask, kind = table.encode(L)  # [S, E, L], [S, E]
    return mask, kind, labels, np.array(ids)


def match_inputs(terms: List[TermKey], pods: Sequence):
    """The selector x pod-label match of `terms` and `pods` as the ring
    matcher's inputs (parallel/ring.py ring_match): f32 0/1 masks [T, E, L]
    and kinds i32[T, E], one row per term, and f32 0/1 label rows [P, L].
    _match_matrix is their dense evaluation."""
    mask, kind, labels, ids = _lowered(terms, pods)
    return mask[ids].astype(np.float32), kind[ids].astype(np.int32), labels


def _match_matrix(terms: List[TermKey], pods: Sequence) -> np.ndarray:
    """f32[T, P] 0/1 selector + namespace matches, as _matches decides them:
    a few numpy products over the lowered selectors (_lowered) instead of
    T x P selector calls."""
    T, P = len(terms), len(pods)
    if T == 0 or P == 0:
        return np.zeros((max(1, T), max(1, P)), dtype=np.float32)
    mask, kind, labels, ids = _lowered(terms, pods)
    counts = np.einsum("sel,pl->sep", mask.astype(np.float32), labels)
    ok = np.where(
        kind[:, :, None] == v.KIND_ANY,
        counts > 0,
        np.where(kind[:, :, None] == v.KIND_NONE, counts == 0, kind[:, :, None] == v.KIND_PAD),
    ).all(axis=1)  # [S, P]
    return ok[ids].astype(np.float32)
