"""Kernels K1 static_feasible and K16 ring_match, the selector-term match, on
one card: back-to-back time, card time and host time a call at the shapes
the main path gives them, beside the term match's library call and the
bounds.

    python3 -m kubernetes_tpu_torch.bench.term_match [--parent DIR]

K1 at the pinned gang wave, gang_pinned('perpod-fit') through DeltaEncoder
(P = 8, N = 6144, L = 5000: a hostname In over a pool of BASELINE config
3's 5000 nodes; every fit-only cycle of 1-8 pods with hostname node
affinity has this shape), its gated call there (`done` set: card time,
nothing written), the north star (heterogeneous(20000, 50000, seed=0)
through encode_snapshot: [51200, 20480], L = 1) and the north star's node
shards on make_mesh(4) and make_mesh(5) (one call a shard with its `base`,
as parallel/sharded.py's per-pod route); K16 at one hop of config 3's ring
(chip_smoke.py config3_match_inputs: [20, 2, 41] x [2500, 41]) and of the
north star's ([1, 1, 1] x [5120, 1]).  Every call's output is bit-equal to
the plain version's (ops/filters.py static_feasible_plain,
parallel/ring.py match_block_plain).  Per cell: back-to-back ms (CUDA
events over calls in a row), card ms (calls queued behind a sleeping
kernel that outlasts their enqueue), host us a call (perf_counter over
that enqueue); the library call on the same inputs, its operands made
before the timing (K1: torch.einsum of the float masks against the float
label rows, the term match's share of its work; K16: torch.einsum of the
counts); the device operations one call runs and K1's device time by
kernel, set-up and row pass (torch.profiler); the bound
(bytes at 3.35 TB/s, operations at 67 TFLOP/s).  K7 (packed_static_rows,
unchanged here but built on the changed feasible.cuh) is timed too: with
the eligibility plane at gang_pinned('perpod-full'), as the full stage
set's per-pod route calls it (its set-up still walks each label row in a
thread), and alone at the north star's dense step.  K1's listed match
(every ANY / NONE expression of at most 32 literals, the masks scanned
whole by every set-up block) is timed against its packed match (the same
source built with -DKTT_LIST_SCAN_MAX=0) in turns (listed, packed, packed,
listed) at the pinned shape and at the scan's cap: the pinned term repeated
52 times, S * E * L = 260000 mask bytes of the 262144 allowed.

With --parent DIR (a directory holding an earlier csrc/, e.g. a `git
archive` of the parent commit under the git-ignored _parent/) the earlier
static_feasible.cu, ring_match.cu and class_hoist.cu are built too, K1 and
K16 called through copies of their earlier wrappers (K1's four launches
with scratch allocated per call), K7 through the current one, and every
timing runs in turns (old, new, new, old), each call's
output bit-equal to the current build's and the plain version's.  Ends
with one JSON line and the card's name and power limit as nvidia-smi
gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from .score_explain import device_ops, in_turns, timed
from .static_rows import bound_ms
from .wave_phases import build_variant, card_name

_P, _I = ctypes.c_void_p, ctypes.c_int
# K1's C entry before this design: the term-match bytes and both taint-word
# scratches (tm, taint_w, tol_w) passed in
PARENT_K1_ARGTYPES = [_P] * 15 + [_I] * 8 + [_P]


def k16_work(sel, kind, lab) -> tuple:
    """(bytes, operations) of one hop (chip_smoke.py's count)."""
    import chip_smoke

    Sl, E, L = sel.shape
    B = lab.shape[0]
    return 4 * (Sl * E * L + Sl * E + B * L) + Sl * B, chip_smoke.ring_hop_ops(sel, kind, lab)


def parent_static_feasible(fn, arr, done=None, out=None, base: int = 0):
    """The earlier K1 wrapper's call: its scratch allocated every call, under
    torch.cuda.device."""
    import torch

    from ..ops import kernels

    dev = arr.device
    P, N = arr.P, arr.N
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    TW = max(1, -(-T // 32))
    tm = torch.empty((S, N), dtype=torch.uint8, device=dev)
    taint_w = torch.empty((N, TW), dtype=torch.int32, device=dev)
    tol_w = torch.empty((P, TW), dtype=torch.int32, device=dev)
    sf = torch.empty((P, N), dtype=torch.bool, device=dev) if out is None else out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(arr.node_valid.data_ptr(), arr.node_taint_ns.data_ptr(), arr.node_labels.data_ptr(),
                 arr.pod_valid.data_ptr(), arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(),
                 arr.pod_terms.data_ptr(), arr.pod_has_sel.data_ptr(), arr.sel_mask.data_ptr(),
                 arr.sel_kind.data_ptr(), tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), sf.data_ptr(),
                 None if done is None else done.data_ptr(), P, N, T, TT, S, E, L, base, stream)
    kernels._raise_on(err, "static_feasible (parent)")
    return sf


def parent_ring_match(fn, sel, kind, lab):
    """The earlier K16 wrapper's call (under torch.cuda.device)."""
    import torch

    from ..ops import kernels

    Sl, E, L = sel.shape
    B = lab.shape[0]
    out = torch.empty((Sl, B), dtype=torch.bool, device=sel.device)
    with torch.cuda.device(sel.device):
        err = fn(sel.data_ptr(), kind.data_ptr(), lab.data_ptr(), out.data_ptr(), Sl, E, L, B, B, 0,
                 kernels._stream(sel.device))
    kernels._raise_on(err, "ring_match (parent)")
    return out


def device_split(fn, reps: int = 20) -> dict:
    """Device microseconds a call of fn() spends in each kernel, by
    torch.profiler (empty where it sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]: e.device_time_total / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def turn_calls(new, old):
    """old, new, new, old (new alone without a parent)."""
    calls = [("new", new)]
    return calls if old is None else [("old", old), calls[0], calls[0], ("old", old)]


def equal_to(kernel: str, cell: str, want):
    import torch

    def check(who, got):
        gs = got if isinstance(got, (list, tuple)) else [got]
        ws = want if isinstance(want, (list, tuple)) else [want]
        if len(gs) != len(ws) or not all(torch.equal(g, w) for g, w in zip(gs, ws)):
            raise RuntimeError(f"{kernel} {cell}: the {who} build's output differs from plain")
    return check


def k1_cells(old_fn, card: str) -> dict:
    import torch

    import chip_smoke
    from ..api.delta import DeltaEncoder
    from ..api.snapshot import encode_snapshot
    from ..ops import filters, kernels
    from ..parallel import mesh as tm
    from . import workloads

    res = {}
    pinned, _ = DeltaEncoder().encode_device(workloads.gang_pinned("perpod-fit"))
    north, _ = encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR))
    for cell, arr, reps in (("pinned P=8 N=6144 L=5000", pinned, 200), ("north star [51200, 20480]", north, 20)):
        want = filters.static_feasible_plain(arr)
        turns = in_turns(f"k1 {cell}", f"P={arr.P} N={arr.N} L={arr.sel_mask.shape[2]}",
                         turn_calls(lambda a=arr: kernels.static_feasible(a),
                                    None if old_fn is None else (lambda a=arr: parent_static_feasible(old_fn, a))),
                         equal_to("k1", cell, want), reps)
        sel_f, lab_f = arr.sel_mask.float(), arr.node_labels.float()
        lib = timed(lambda: torch.einsum("sel,nl->sen", sel_f, lab_f), reps)
        ops = dict(new=device_ops(lambda a=arr: kernels.static_feasible(a)))
        split = dict(new=device_split(lambda a=arr: kernels.static_feasible(a)))
        if old_fn is not None:
            ops["old"] = device_ops(lambda a=arr: parent_static_feasible(old_fn, a))
            split["old"] = device_split(lambda a=arr: parent_static_feasible(old_fn, a))
        b_ms, b_by = bound_ms(*chip_smoke.k1_work(arr))
        res[cell] = dict(turns=turns, library=lib, bound_ms=b_ms, bound_by=b_by, device_ops=ops, device_us=split)
        print(f"[k1 {cell}] {card} | == plain in every turn; torch.einsum of the float masks (the term match "
              f"alone) {lib['card_ms']:.4f} ms of card time ({lib['ms']:.4f} back to back); bound {b_ms:.6f} ms "
              f"({b_by}); device us a call by kernel {split}", flush=True)
        del want, sel_f, lab_f
        if arr is pinned:  # the gated call: done set, nothing written
            one = torch.ones((1,), dtype=torch.int32, device=arr.device)
            buf = torch.rand((arr.P, arr.N), generator=torch.Generator().manual_seed(0)).lt(0.5).to(arr.device)
            before = buf.clone()
            gated = in_turns(f"k1 {cell} gated", "done set",
                             turn_calls(lambda: kernels.static_feasible(pinned, done=one, out=buf),
                                        None if old_fn is None else
                                        (lambda: parent_static_feasible(old_fn, pinned, done=one, out=buf))),
                             equal_to("k1 gated", cell, before), reps)
            res[cell]["gated"] = gated
    for S in (4, 5):  # the node shards' calls, each with its base
        m = tm.make_mesh(S)
        sa = tm.shard_arrays(north, m)
        bases = [m.base(s, sa.N) for s in range(S)]
        want = [filters.static_feasible_plain(sh, base=b) for sh, b in zip(sa.shards, bases)]
        cell = f"north star base, {S} shards [51200, {sa.nl}] each"
        turns = in_turns(f"k1 {cell}", "the shards' calls",
                         turn_calls(lambda: [kernels.static_feasible(sh, base=b) for sh, b in zip(sa.shards, bases)],
                                    None if old_fn is None else
                                    (lambda: [parent_static_feasible(old_fn, sh, base=b)
                                              for sh, b in zip(sa.shards, bases)])),
                         equal_to("k1", cell, want), 10)
        libs = [(sh.sel_mask.float(), sh.node_labels.float()) for sh in sa.shards]
        lib = timed(lambda: [torch.einsum("sel,nl->sen", s_, l_) for s_, l_ in libs], 10)
        nb, no = zip(*(chip_smoke.k1_work(sh) for sh in sa.shards))
        b_ms, b_by = bound_ms(sum(nb), sum(no))
        split = device_split(lambda: [kernels.static_feasible(sh, base=b) for sh, b in zip(sa.shards, bases)], 5)
        res[cell] = dict(turns=turns, library=lib, bound_ms=b_ms, bound_by=b_by, device_us=split)
        print(f"[k1 {cell}] {card} | == plain per shard in every turn; the einsums {lib['card_ms']:.4f} ms of "
              f"card time; bound {b_ms:.6f} ms ({b_by}); device us the calls by kernel {split}", flush=True)
        del sa, want, libs
        torch.cuda.empty_cache()
    return res


class _Terms:
    """arr with its selector terms replaced (the pod rows keep theirs)."""

    def __init__(self, arr, sel_mask, sel_kind):
        self._arr, self.sel_mask, self.sel_kind = arr, sel_mask, sel_kind

    def __getattr__(self, name):
        return getattr(self._arr, name)


def k1_cap_cells(packed_fn, card: str) -> dict:
    """K1's listed match against its packed one (packed_fn: the source built
    with -DKTT_LIST_SCAN_MAX=0) in turns, at the pinned shape and with its
    term repeated up to the listed match's scan cap."""
    from ..api.delta import DeltaEncoder
    from ..ops import filters, kernels
    from . import workloads
    from .perpod_scan import as_parent

    pinned, _ = DeltaEncoder().encode_device(workloads.gang_pinned("perpod-fit"))
    res = {}
    for k in (1, 52):
        arr = _Terms(pinned, pinned.sel_mask.repeat(k, 1, 1).contiguous(), pinned.sel_kind.repeat(k, 1).contiguous())
        S, E, L = arr.sel_mask.shape
        cell = f"listed vs packed S={S} E={E} L={L} (S*E*L = {S * E * L})"

        def listed(a=arr):
            return kernels.static_feasible(a)

        def packed(a=arr):
            return as_parent("static_feasible", packed_fn, lambda: kernels.static_feasible(a))

        res[cell] = in_turns(f"k1 {cell}", "listed, packed, packed, listed",
                             [("listed", listed), ("packed", packed), ("packed", packed), ("listed", listed)],
                             equal_to("k1", cell, filters.static_feasible_plain(arr)), 100)
        print(f"[k1 {cell}] {card} | == plain in every turn", flush=True)
    return res


def k16_cells(old_fn, card: str) -> dict:
    import torch

    import chip_smoke
    from ..api.snapshot import encode_snapshot
    from ..ops import kernels
    from ..parallel.ring import match_block_plain
    from . import workloads

    sel, kind, labels, _ = chip_smoke.config3_match_inputs()
    north, _ = encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR))
    hops = {
        "config 3 hop [20, 2, 41] x [2500, 41]": (sel[:20].cuda(), kind[:20].cuda(), labels[:2500].cuda()),
        "north star hop [1, 1, 1] x [5120, 1]": (north.sel_mask.float()[:1].contiguous(),
                                                 north.sel_kind[:1].contiguous(),
                                                 north.node_labels.float()[:5120].contiguous()),
    }
    del north
    res = {}
    for cell, (hs, hk, hl) in hops.items():
        want = match_block_plain(hs, hk, hl)
        turns = in_turns(f"k16 {cell}", "one hop",
                         turn_calls(lambda: kernels.ring_match(hs, hk, hl),
                                    None if old_fn is None else (lambda: parent_ring_match(old_fn, hs, hk, hl))),
                         equal_to("k16", cell, want), 200)
        lib = timed(lambda: torch.einsum("sel,bl->seb", hs, hl), 200)
        ops = dict(new=device_ops(lambda: kernels.ring_match(hs, hk, hl)))
        if old_fn is not None:
            ops["old"] = device_ops(lambda: parent_ring_match(old_fn, hs, hk, hl))
        b_ms, b_by = bound_ms(*k16_work(hs, hk, hl))
        res[cell] = dict(turns=turns, library=lib, bound_ms=b_ms, bound_by=b_by, device_ops=ops)
        print(f"[k16 {cell}] {card} | == plain in every turn; torch.einsum of the counts {lib['card_ms']:.4f} ms of "
              f"card time ({lib['ms']:.4f} back to back); bound {b_ms:.6f} ms ({b_by}); device ops a call {ops}",
              flush=True)
    return res


def k7_cells(old_fn, card: str) -> dict:
    """K7 (unchanged here; its source includes feasible.cuh) in turns
    against the parent build through the current wrapper (the same C
    entry): with the eligibility plane at gang_pinned('perpod-full'), as
    its per-pod route calls it, whose set-up still walks each label row in
    a thread, and the static plane alone at the north star's dense step."""
    from ..api.delta import DeltaEncoder
    from ..ops import assign, kernels
    from . import workloads
    from .perpod_scan import as_parent
    from .static_rows import k7_work

    res = {}
    for cell, snap, elig, reps in (
            ("pinned perpod-full P=8 N=6144 L=5000", workloads.gang_pinned("perpod-full"), True, 200),
            ("north star [51200, 640] words", workloads.heterogeneous(**workloads.NORTH_STAR), False, 20)):
        arr, _ = DeltaEncoder().encode_device(snap)
        want = assign.packed_static_rows_plain(arr, with_elig=elig)

        def new(a=arr, e=elig):
            return kernels.packed_static_rows(a, with_elig=e)

        turns = in_turns(f"k7 {cell}", f"P={arr.P} N={arr.N} L={arr.sel_mask.shape[2]}",
                         turn_calls(new, None if old_fn is None else
                                    (lambda: as_parent("packed_static_rows", old_fn, new))),
                         equal_to("k7", cell, list(want) if elig else want), reps)
        b_ms, b_by = bound_ms(*k7_work(arr, elig))
        res[cell] = dict(turns=turns, bound_ms=b_ms, bound_by=b_by)
        print(f"[k7 {cell}] {card} | == plain in every turn; bound {b_ms:.6f} ms ({b_by})", flush=True)
        del arr, want
    return res


def main(argv=None) -> int:
    import torch

    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="an earlier kubernetes_tpu_torch (its csrc/) to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("term_match: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    old1 = old16 = old7 = None
    if args.parent:
        src = Path(args.parent) / "csrc"
        _, old1 = build_variant("static_feasible", src / "static_feasible.cu", tag="parent")
        old1.argtypes = PARENT_K1_ARGTYPES
        _, old16 = build_variant("ring_match", src / "ring_match.cu", tag="parent")
        _, old7 = build_variant("packed_static_rows", src / "class_hoist.cu", tag="parent")
    _, packed1 = build_variant("static_feasible", kernels.CSRC / "static_feasible.cu", "KTT_LIST_SCAN_MAX=0",
                               tag="packed")
    kernels.build(["static_feasible", "ring_match", "packed_static_rows"])
    result = dict(card=card, k1=k1_cells(old1, card), k1_cap=k1_cap_cells(packed1, card))
    torch.cuda.empty_cache()
    result["k16"] = k16_cells(old16, card)
    result["k7"] = k7_cells(old7, card)
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
