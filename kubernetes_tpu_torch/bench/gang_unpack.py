"""Kernels K13 gang_quorum and K9 unpack_planes on one card, at the shapes
the main path gives them: back-to-back time, card time and host time a
call, beside the library call and the bounds.

    python3 -m kubernetes_tpu_torch.bench.gang_unpack [--parent DIR]

K13 on the first device-fixpoint iteration's choices (K7 + K8 through the
encoded arrays, as chip_smoke.py's gang_run takes them) of BASELINE config
5, gang(1000, 64, 2000) (P = 65536, G = 1000), and of gang-small, gang(48,
64, 40) (P = 3072, G = 48): the first iteration's quorum (no group fails
at config 5, some at gang-small), the revocation path (the same choices with the pods of groups G/2 and G-1 at
-1: group G/2's first pod is revoked), and a gated call (`done` set,
nothing written).  Every call takes its own pod_valid copy and done word
from a pool made before the timing, so each call sees the same input; the
last call's outputs are held to gang_quorum_plain.  The new build is
called with its persistent `out` buffers, as the device fixpoint calls
it, and without (every buffer made per call).  The library call is
torch.zeros(G + 1).index_add_ of the quorum count (card time; its index
and ones made before the timing); torch.bincount's back-to-back time,
which reads the maximum back to the host, beside it.

The device fixpoint at config 5 and gang-small (fixpoint_cells): its wall,
its enqueue and each queued iteration's host time, with the new K13 and
(with --parent) the earlier one in turns.

K9 on the four packed fields of wide_taints(2000, 5000) (80 taints,
chip_smoke.py's [wide-planes]) and on a synthetic [65536, 1024] plane,
each == the plain unpack.

Per cell: back-to-back ms (CUDA events over calls in a row), card ms
(calls queued behind a sleeping kernel that outlasts their enqueue), host
us a call (perf_counter over that enqueue); the bound (chip_smoke.py's
count: bytes at 3.35 TB/s, operations at 67 TFLOP/s); at config 5 K13's
wrapper host time taken apart (k13_host_split) and its card time at
cluster caps of 1 to 16 blocks (k13_caps).

With --parent DIR (a directory holding an earlier csrc/, e.g. a `git
archive` of the parent commit under the git-ignored _parent/) the earlier
gang.cu and unpack_planes.cu are built too, K13 called through a copy of
its earlier wrapper (one block; its four outputs and, with no `done`, a
done word made every call, under torch.cuda.device), K9 through the
current wrapper (the same C entry), and every timing runs in turns (old,
new, new, old), each call's outputs bit-equal to the other build's and to
the plain version's.  Ends with one JSON line and the card's name and
power limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from .perpod_scan import as_parent
from .score_explain import card_host, timed
from .static_rows import bound_ms
from .wave_phases import build_variant, card_name

_P, _I = ctypes.c_void_p, ctypes.c_int
# K13's C entry before the cluster design: one block, no scratch, no cap
PARENT_K13_ARGTYPES = [_P] * 9 + [_I, _I, _P]


def k13_work(P: int, G: int) -> tuple:
    """(bytes, operations) as chip_smoke.py's [config5] counts them."""
    return 4 * P + 4 * P + 2 * P + 4 * G + 4 * G + 2 * G + 8, 4 * P + 2 * G


def k9_work(rows: int, n: int) -> tuple:
    return rows * (4 * (-(-n // 32)) + n), rows * n


def parent_gang_quorum(fn, choices, pod_group, pv, group_min, done=None):
    """The earlier K13 wrapper's call: its four outputs (and, with no done,
    a done word) made every call, under torch.cuda.device."""
    import torch

    from ..ops import kernels

    dev = choices.device
    P, G = choices.shape[0], group_min.shape[0]
    if done is None:
        done = torch.zeros((1,), dtype=torch.int32, device=dev)
    sched = torch.empty((G,), dtype=torch.int32, device=dev)
    present = torch.empty((G,), dtype=torch.bool, device=dev)
    bad = torch.empty((G,), dtype=torch.bool, device=dev)
    first = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(choices.data_ptr(), pod_group.data_ptr(), pv.data_ptr(), group_min.data_ptr(), sched.data_ptr(),
                 present.data_ptr(), bad.data_ptr(), first.data_ptr(), done.data_ptr(), P, G, kernels._stream(dev))
    kernels._raise_on(err, "gang_quorum (parent)")
    return sched, present, bad, first, done


def first_iteration(spec: dict):
    """(arrays, the first device-fixpoint iteration's choices) of gang(**spec)."""
    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from . import workloads

    arr, _ = DeltaEncoder().encode_device(workloads.gang(**spec))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sfs = kernels.packed_static_rows(arr)
    return arr, kernels.chunk_rounds_dense(arr, cfg, sfs)[0]


def revocation_choices(arr, c1):
    """c1 with the pods of groups G/2 and G-1 unplaced: two groups fail,
    group G/2's first pod is the earliest."""
    import torch

    G = arr.group_min.shape[0]
    hit = (arr.pod_group == G // 2) | (arr.pod_group == G - 1)
    return torch.where(hit, torch.full_like(c1, -1), c1)


class Pool:
    """pod_valid copies and done words made before the timing: call i
    takes state i, so every call sees the same input, a revoking one too."""

    def __init__(self, pv, n: int, done_value: int = 0):
        import torch

        self.pvs = [pv.clone() for _ in range(n)]
        self.dones = list(torch.full((n, 1), done_value, dtype=torch.int32, device=pv.device).unbind(0))
        self.i = 0

    def next(self):
        i = self.i
        self.i += 1
        return self.pvs[i], self.dones[i]


def pool_size(reps: int) -> int:
    return 4 * reps + 8  # timed(): 2 + reps back to back, 1 + 3 * reps by card_host


def k13_cells(old_fn, card: str, reps: int) -> dict:
    import torch

    from ..ops import gang, kernels
    from . import workloads

    res = {}
    for tag, spec in (("config 5", workloads.CONFIG5), ("gang-small", workloads.GANG_SMALL)):
        arr, c1 = first_iteration(spec)
        P, G = arr.P, arr.group_min.shape[0]
        pg, gm, pv0 = arr.pod_group, arr.group_min, arr.pod_valid
        out = kernels.gang_quorum_out(G, arr.device)
        b_ms, b_by = bound_ms(*k13_work(P, G))
        for mode, choices, done_value in (("first iteration", c1, 0),
                                          ("revocation", revocation_choices(arr, c1), 0),
                                          ("gated", c1, 1)):
            want = gang.gang_quorum_plain(choices, pg, pv0, gm)
            cell = f"{tag} {mode} P={P} G={G}"

            def with_out(pool, ch=choices):
                pv, done = pool.next()
                return kernels.gang_quorum(ch, pg, pv, gm, done=done, out=out)[:4]

            def fresh(pool, ch=choices):
                pv, done = pool.next()
                return kernels.gang_quorum(ch, pg, pv, gm, done=done)[:4]

            def parent(pool, ch=choices):
                pv, done = pool.next()
                return parent_gang_quorum(old_fn, ch, pg, pv, gm, done=done)[:4]

            calls = {"new out=": with_out, "new": fresh, "old": parent}
            order = ["new out=", "new"] if old_fn is None else ["old", "new out=", "new", "new", "new out=", "old"]
            turns = {}
            for who in order:
                pool = Pool(pv0, pool_size(reps), done_value)
                got = {}

                def run(pool=pool, who=who):
                    got["x"] = calls[who](pool)

                r = timed(run, reps)
                pv_last = pool.pvs[pool.i - 1]
                if mode == "gated":
                    ok = torch.equal(pv_last, pv0)
                else:
                    ok = (all(torch.equal(a, b) for a, b in zip(got["x"], want[:4])) and torch.equal(pv_last, want[4])
                          and bool(pool.dones[pool.i - 1].item()) == want[5])
                if not ok:
                    raise RuntimeError(f"k13 {cell}: the {who} build's outputs differ from plain")
                turns.setdefault(who, []).append(r)
            res[cell] = dict(turns=turns, bound_ms=b_ms, bound_by=b_by, cluster=kernels.LAST_CLUSTER["gang_quorum"])
            print(f"[k13 {cell}] {card} | == plain in every turn; cluster {kernels.LAST_CLUSTER['gang_quorum']}; "
                  + "; ".join(f"{who} " + " / ".join(f"{r['card_ms']:.4f} card, {r['ms']:.4f} b2b, "
                                                     f"{r['host_us']:.1f} us host" for r in v)
                              for who, v in turns.items()) + f"; bound {b_ms:.6f} ms ({b_by})", flush=True)
        if tag == "config 5":
            res[f"{tag} host split"] = k13_host_split(c1, pg, pv0, gm, out)
            res[f"{tag} cluster caps"] = k13_caps(arr, c1, reps)
        valid = (pg >= 0) & pv0 & (c1 >= 0)
        gidx = torch.where(valid, pg, G).to(torch.int64)
        ones = torch.ones((P,), dtype=torch.int32, device=arr.device)
        lib_card, lib_host = card_host(lambda: torch.zeros((G + 1,), dtype=torch.int32, device=arr.device)
                                       .index_add_(0, gidx, ones), reps)
        lib_b2b = timed(lambda: torch.bincount(gidx, minlength=G + 1), reps)["ms"]
        res[f"{tag} library"] = dict(index_add_card_ms=lib_card, index_add_host_us=lib_host, bincount_b2b_ms=lib_b2b)
        print(f"[k13 {tag} library] {card} | torch.zeros(G + 1).index_add_ of the quorum count {lib_card:.4f} ms "
              f"of card time ({lib_host:.1f} us host); torch.bincount {lib_b2b:.4f} ms back to back (reads the "
              f"maximum back)", flush=True)
        del arr, c1, out
        torch.cuda.empty_cache()
    return res


def k13_caps(arr, c1, reps: int) -> dict:
    """K13's card time at config 5 with the cluster capped at 1, 2, 4, 8
    and 16 blocks (fewer blocks: more units of 4 pods a thread), on the
    first iteration and the revocation, each == plain."""
    import torch

    from ..ops import gang, kernels

    pg, gm, pv0 = arr.pod_group, arr.group_min, arr.pod_valid
    out = kernels.gang_quorum_out(gm.shape[0], arr.device)
    res = {}
    for mode, choices in (("first iteration", c1), ("revocation", revocation_choices(arr, c1))):
        want = gang.gang_quorum_plain(choices, pg, pv0, gm)
        for cap in (1, 2, 4, 8, 16):
            pool = Pool(pv0, pool_size(reps))

            def call(pool=pool, ch=choices, cap=cap):
                pv, done = pool.next()
                return kernels.gang_quorum(ch, pg, pv, gm, done=done, out=out, cluster=cap)

            got = call()
            if not (all(torch.equal(a, b) for a, b in zip(got[:4], want[:4])) and torch.equal(pool.pvs[0], want[4])):
                raise RuntimeError(f"k13 caps {mode} {cap}: differs from plain")
            res[f"{mode} cap {cap}"] = dict(card_ms=card_host(call, reps)[0],
                                            cluster=kernels.LAST_CLUSTER["gang_quorum"])
    print(f"[k13 config 5 cluster caps] card ms: " + "; ".join(
        f"{k} (kc {v['cluster']}) {v['card_ms']:.4f}" for k, v in res.items()), flush=True)
    return res


def k13_host_split(choices, pod_group, pv, group_min, out) -> dict:
    """K13's wrapper host time a call (us) taken apart, a gated call: the
    ten checks a first call makes (four inputs, done, the four outputs and
    the scratch), the allocation of a fresh set of outputs, the
    device context, the stream lookup, the pointers, the ctypes call with
    its launch; and the whole call with `out=` bound (the same tensors
    again: no check), as the fixpoint's queued iterations make it."""
    import time

    import torch

    from ..ops import kernels
    from .score_explain import host_split

    dev = choices.device
    P, G = choices.shape[0], group_min.shape[0]
    done = torch.ones((1,), dtype=torch.int32, device=dev)
    fields = (("choices", choices, torch.int32, (P,)), ("pod_group", pod_group, torch.int32, (P,)),
              ("pv", pv, torch.bool, (P,)), ("group_min", group_min, torch.int32, (G,)),
              ("done", done, torch.int32, (1,)), ("sched", out.sched, torch.int32, (G,)),
              ("present", out.present, torch.bool, (G,)), ("bad", out.bad, torch.bool, (G,)),
              ("first", out.first, torch.int32, (1,)), ("scratch", out.scratch, torch.int32, (2, G)))

    def checks():
        for name, t, dt, shape in fields:
            kernels._check(t, name, dt, shape, dev)

    def ptrs():
        return (choices.data_ptr(), pod_group.data_ptr(), pv.data_ptr(), group_min.data_ptr(), out.sched.data_ptr(),
                out.present.data_ptr(), out.bad.data_ptr(), out.first.data_ptr(), done.data_ptr(),
                out.scratch.data_ptr(), P, G, kernels.QUORUM_CLUSTER, kernels._QUORUM_KC_REF)

    split = host_split(checks, lambda: kernels.gang_quorum_out(G, dev), ptrs, kernels._fn("gang_quorum"), dev)
    kernels.gang_quorum(choices, pod_group, pv, group_min, done=done, out=out)  # binds out
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(50):
        kernels.gang_quorum(choices, pod_group, pv, group_min, done=done, out=out)
    split["bound_call"] = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    print(f"[k13 config 5 host split] the wrapper's host time a gated call, taken apart (us): {split}", flush=True)
    return split


def fixpoint_turn(arr, cfg, route: str, quorum) -> tuple:
    """One device fixpoint, gang_dispatch's loop with a host timestamp after
    each queued iteration and `quorum` as kernels.gang_quorum -> (choices,
    used, times)."""
    import time

    import numpy as np
    import torch

    from ..ops import gang, kernels

    G = arr.group_min.shape[0]
    normal = kernels.gang_quorum
    kernels.gang_quorum = quorum
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterate, (choices, used), status, pv, _ = gang._card_loop(arr, cfg, route)
        ts = [time.perf_counter()]
        for _ in range(G + 1):
            iterate()
            ts.append(time.perf_counter())
        g = gang.GangDispatch(choices, used, status, route, gang._iterations(arr, pv))
        enqueue = time.perf_counter() - t0
        c, u = gang.gang_finish(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kernels.gang_quorum = normal
    gaps = np.diff(ts) * 1e6
    half = gaps[len(gaps) // 2:]
    return c, u, dict(wall_s=wall, enqueue_s=enqueue, setup_us=(ts[0] - t0) * 1e6, first_us=float(gaps[0]),
                      blocked_us=float(gaps[gaps > 500].sum()), blocked_n=int((gaps > 500).sum()),
                      steady_us=float(half.mean()), steady_min_us=float(half.min()))


def fixpoint_cells(old_fn, card: str) -> dict:
    """The device fixpoint's wall and enqueue at config 5 and gang-small
    with the new K13 (its `out` buffers made once) and, in turns (old,
    new, new, old), with the earlier build through its earlier wrapper;
    the per-iteration host gaps: the first (K7 + K8 + K13 queued), those
    over 0.5 ms (the host waiting on a full launch queue while K8 runs),
    the mean and least of the last half (the steady enqueue an
    iteration); the choices and usage the same in every turn."""
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, gang, infer_score_config, kernels
    from . import workloads

    def old(choices, pod_group, pv, group_min, done=None, out=None, cluster=None):
        kernels.LAUNCHES["gang_quorum"] += 1
        return parent_gang_quorum(old_fn, choices, pod_group, pv, group_min, done=done)

    res = {}
    for tag, spec in (("config 5", workloads.CONFIG5), ("gang-small", workloads.GANG_SMALL)):
        arr, _ = DeltaEncoder().encode_device(workloads.gang(**spec))
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        want = gang.gang_fixpoint_device(arr, cfg)
        order = ["new"] * 2 if old_fn is None else ["old", "new", "new", "old"]
        turns = {}
        for who in order:
            c, u, t = fixpoint_turn(arr, cfg, "dense", old if who == "old" else kernels.gang_quorum)
            if not (torch.equal(c, want[0]) and torch.equal(u, want[1])):
                raise RuntimeError(f"fixpoint {tag}: the {who} turn's choices or usage differ")
            turns.setdefault(who, []).append(t)
        res[tag] = turns
        print(f"[fixpoint {tag}] {card} | G + 1 = {arr.group_min.shape[0] + 1} queued, the same choices in every "
              f"turn; " + "; ".join(f"{who} " + " / ".join(
                  f"wall {t['wall_s']:.4f} s, enqueue {t['enqueue_s']:.4f} s (first {t['first_us']:.0f} us, "
                  f"{t['blocked_n']} blocked {t['blocked_us'] / 1e3:.1f} ms, steady {t['steady_us']:.1f} us an "
                  f"iteration, least {t['steady_min_us']:.1f})" for t in v) for who, v in turns.items()), flush=True)
        del arr
        torch.cuda.empty_cache()
    return res


def k9_cells(old_fn, card: str, reps: int) -> dict:
    import numpy as np
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import bitplane, kernels
    from . import workloads

    host, _ = DeltaEncoder().encode(workloads.wide_taints(**workloads.WIDE_TAINTS))
    planes = {f"wide-planes {name}": getattr(host, name)
              for name in ("node_taint_ns", "pod_tol_ns", "node_taint_pref", "pod_tol_pref")}
    planes["synthetic"] = np.random.default_rng(0).random((65536, 1024)) < 0.4
    res = {}
    for tag, dense in planes.items():
        rows, n = dense.shape
        words = torch.from_numpy(bitplane.np_pack_lastaxis(dense).view(np.int32)).cuda()
        want = torch.from_numpy(dense).cuda()
        if not torch.equal(bitplane.unpack(words, n), want):
            raise RuntimeError(f"k9 {tag}: the plain unpack differs from the host bools")
        cell = f"{tag} [{rows}, {n}]"

        def new():
            return kernels.unpack_planes(words, n)

        calls = [("new", new)] if old_fn is None else [
            ("old", lambda: as_parent("unpack_planes", old_fn, new)), ("new", new), ("new", new),
            ("old", lambda: as_parent("unpack_planes", old_fn, new))]
        turns = {}
        for who, call in calls:
            got = {}

            def run(call=call):
                got["x"] = call()

            r = timed(run, reps)
            if not torch.equal(got["x"], want):
                raise RuntimeError(f"k9 {cell}: the {who} build's output differs from plain")
            turns.setdefault(who, []).append(r)
        b_ms, b_by = bound_ms(*k9_work(rows, n))
        res[cell] = dict(turns=turns, bound_ms=b_ms, bound_by=b_by)
        print(f"[k9 {cell}] {card} | == plain in every turn; "
              + "; ".join(f"{who} " + " / ".join(f"{r['card_ms']:.4f} card, {r['ms']:.4f} b2b, "
                                                 f"{r['host_us']:.1f} us host" for r in v)
                          for who, v in turns.items()) + f"; bound {b_ms:.6f} ms ({b_by})", flush=True)
        del words, want
    return res


def main(argv=None) -> int:
    import torch

    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="an earlier kubernetes_tpu_torch (its csrc/) to time in turns")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gang_unpack: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    old13 = old9 = None
    if args.parent:
        src = Path(args.parent) / "csrc"
        _, old13 = build_variant("gang_quorum", src / "gang.cu", tag="parent")
        old13.argtypes = PARENT_K13_ARGTYPES
        _, old9 = build_variant("unpack_planes", src / "unpack_planes.cu", tag="parent")
    kernels.build(["gang_quorum", "unpack_planes", "packed_static_rows", "chunk_rounds_dense"])
    result = dict(card=card, k13=k13_cells(old13, card, args.reps), k9=k9_cells(old9, card, args.reps),
                  fixpoint=fixpoint_cells(old13, card))
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
