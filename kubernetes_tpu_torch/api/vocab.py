"""Interning: strings -> dense integer ids, selectors -> literal-set primitives.

The port's own copy of the JAX package's ``api/vocab.py``.  Every label
``key=value`` pair present on a node is interned to a literal id; node label
sets become 0/1 rows of an ``[N, L]`` matrix, and every selector operator is
lowered to one of two primitives over literal sets:

  AnyOf(S):  satisfied iff the entity carries >= 1 literal in S
  NoneOf(S): satisfied iff the entity carries 0 literals in S

Lowering table (exact, given the vocab holds every literal in the snapshot):

  In(k, vs)        -> AnyOf({k=v for v in vs})
  NotIn(k, vs)     -> NoneOf({k=v for v in vs})      # absent key matches
  Exists(k)        -> AnyOf(all literals with key k)
  DoesNotExist(k)  -> NoneOf(all literals with key k)
  Gt(k, x)/Lt(k,x) -> AnyOf({k=v : int(v) >< x})     # expanded against the vocab

A conjunction of lowered expressions is a term; pods referencing identical
terms share one interned term id, so the term-match matrix is [S, N].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

from . import types as t

# Expression kinds in the packed selector matrix (ops/filters.py consumes these).
KIND_PAD = 0  # padding row: always satisfied
KIND_ANY = 1  # AnyOf: count > 0
KIND_NONE = 2  # NoneOf: count == 0
KIND_FALSE = 3  # constant-false (e.g. In over values absent from the cluster)


class Interner:
    """Assigns dense ids to hashable items in first-seen order."""

    def __init__(self) -> None:
        self._ids: Dict[object, int] = {}
        self._items: List[object] = []

    def intern(self, item) -> int:
        i = self._ids.get(item)
        if i is None:
            i = len(self._items)
            self._ids[item] = i
            self._items.append(item)
        return i

    def get(self, item) -> Optional[int]:
        return self._ids.get(item)

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item) -> bool:
        return item in self._ids

    @property
    def items(self) -> List[object]:
        return self._items


class LabelVocab:
    """Literal (key=value) and key interning over one snapshot's label universe."""

    def __init__(self) -> None:
        self.literals = Interner()  # (key, value) -> lit id
        self.by_key: Dict[str, List[int]] = {}  # key -> lit ids carrying that key

    def add_labels(self, labels: Dict[str, str]) -> List[int]:
        out = []
        for k, v in labels.items():
            fresh = (k, v) not in self.literals
            lid = self.literals.intern((k, v))
            if fresh:
                self.by_key.setdefault(k, []).append(lid)
            out.append(lid)
        return out

    def lit(self, key: str, value: str) -> Optional[int]:
        return self.literals.get((key, value))

    def key_lits(self, key: str) -> List[int]:
        return self.by_key.get(key, [])

    def __len__(self) -> int:
        return len(self.literals)


# A lowered expression: (kind, frozenset of literal ids).
Expr = Tuple[int, FrozenSet[int]]
# A lowered term: sorted tuple of expressions (conjunction).  () = match-all.
Term = Tuple[Expr, ...]

FALSE_TERM: Term = ((KIND_FALSE, frozenset()),)


def lower_node_requirement(req: t.NodeSelectorRequirement, vocab: LabelVocab) -> Optional[Expr]:
    """Lower one NodeSelectorRequirement to a literal-set primitive.

    None when the expression is vacuously true; a KIND_FALSE expr when it is
    unsatisfiable against this vocab."""
    op = req.operator
    if op == t.OP_IN:
        lits = frozenset(l for v in req.values if (l := vocab.lit(req.key, v)) is not None)
        return (KIND_ANY, lits) if lits else (KIND_FALSE, frozenset())
    if op == t.OP_NOT_IN:
        lits = frozenset(l for v in req.values if (l := vocab.lit(req.key, v)) is not None)
        return (KIND_NONE, lits) if lits else None
    if op == t.OP_EXISTS:
        lits = frozenset(vocab.key_lits(req.key))
        return (KIND_ANY, lits) if lits else (KIND_FALSE, frozenset())
    if op == t.OP_DOES_NOT_EXIST:
        lits = frozenset(vocab.key_lits(req.key))
        return (KIND_NONE, lits) if lits else None
    if op in (t.OP_GT, t.OP_LT):
        try:
            bound = int(req.values[0])
        except (IndexError, ValueError):
            return (KIND_FALSE, frozenset())
        lits = set()
        for lid in vocab.key_lits(req.key):
            _, v = vocab.literals.items[lid]
            try:
                x = int(v)
            except ValueError:
                continue
            if (x > bound) if op == t.OP_GT else (x < bound):
                lits.add(lid)
        return (KIND_ANY, frozenset(lits)) if lits else (KIND_FALSE, frozenset())
    raise ValueError(f"bad node selector operator {op}")


def lower_node_term(exprs: Iterable[t.NodeSelectorRequirement], vocab: LabelVocab) -> Term:
    """Lower a conjunction of requirements; collapses to FALSE_TERM if any is false."""
    out: List[Expr] = []
    for req in exprs:
        e = lower_node_requirement(req, vocab)
        if e is None:
            continue
        if e[0] == KIND_FALSE:
            return FALSE_TERM
        out.append(e)
    return tuple(sorted(out, key=lambda e: (e[0], sorted(e[1]))))


def label_selector_to_requirements(sel: t.LabelSelector) -> List[t.NodeSelectorRequirement]:
    """metav1.LabelSelector -> requirement list (the node-term lowering
    serves pod selectors too: api/pairwise.py _match_matrix)."""
    reqs = [t.NodeSelectorRequirement(key=k, operator=t.OP_IN, values=(v,)) for k, v in sel.match_labels]
    for e in sel.match_expressions:
        reqs.append(t.NodeSelectorRequirement(key=e.key, operator=e.operator, values=e.values))
    return reqs


def pod_required_node_terms(pod: t.Pod, vocab: LabelVocab) -> Optional[List[Term]]:
    """The pod's hard node-selection constraint as an OR-of-conjunctions:
    spec.nodeSelector distributed into each required node-affinity term.
    None when the pod has no node-selection constraint at all."""
    sel_reqs = [
        t.NodeSelectorRequirement(key=k, operator=t.OP_IN, values=(v,))
        for k, v in pod.node_selector
    ]
    aff_terms = list(pod.affinity.required_node_terms) if pod.affinity else []
    if not sel_reqs and not aff_terms:
        return None
    if not aff_terms:
        return [lower_node_term(sel_reqs, vocab)]
    out = []
    for term in aff_terms:
        if not term.match_expressions:
            # an empty NodeSelectorTerm matches no objects
            out.append(FALSE_TERM)
        else:
            out.append(lower_node_term(list(term.match_expressions) + sel_reqs, vocab))
    return out


@dataclass
class TermTable:
    """Interned term set + its dense encoding, shared across pods: [S, E]
    expression slots, each with a kind and a 0/1 literal mask row."""

    terms: Interner = field(default_factory=Interner)

    def intern(self, term: Term) -> int:
        return self.terms.intern(term)

    def encode(self, n_lits: int):
        """-> (mask bool[S, E, L], kind i32[S, E]); S, E, L >= 1 (padded)."""
        S = max(1, len(self.terms))
        E = max(1, max((len(tm) for tm in self.terms.items), default=1))
        L = max(1, n_lits)
        mask = np.zeros((S, E, L), dtype=bool)
        kind = np.full((S, E), KIND_PAD, dtype=np.int32)
        for s, term in enumerate(self.terms.items):
            for e, (k, lits) in enumerate(term):
                kind[s, e] = k
                for lid in lits:
                    mask[s, e, lid] = True
        return mask, kind
