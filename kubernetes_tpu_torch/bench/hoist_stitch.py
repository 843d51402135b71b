"""Kernels K4 class_usage_hoist and K17 stitch_planes on one card, at the
shapes the main path gives them: back-to-back time, card time and host
time a call, beside the bounds.

    python3 -m kubernetes_tpu_torch.bench.hoist_stitch [--parent DIR] [--sass DIR]

K4, full mode, on the north star's class state (heterogeneous(20000,
50000, seed=0) encoded by DeltaEncoder, HoistCache.ensure: U1 = 101, N =
20480, R = 5) and on config 3's (spread_affinity(5000, 10000, seed=0): U1 =
2423, N = 6144, R = 4); K4's column mode on the north star's warm patch
(the usage after the first 2048 pods of the class-wave step, as
chip_smoke.py's [north-star-waves] builds it: the changed rows, ascending,
padded with the sentinel N to a power of two), each call writing a new
generation, so the copy of the resident pair that the route needs is
timed with it.  K17 on the node mesh's dense static rows on 3 shards
(K7's per-shard planes gathered tiled: [51200, 642] -> [51200, 641] words,
nl = 6827), on the same mesh's class planes ([101, 642], HoistCache(mesh=)),
and in the copy case (4 shards, nl = 5120: the dense rows [51200, 640]).

Per kernel and shape: back-to-back ms (CUDA events over calls in a row),
card ms (calls queued behind a sleeping kernel that outlasts their
enqueue: score_explain.card_host), host us a call (the enqueue), every
call's outputs bit-equal to the plain version's (K4: base_u as int32 bit
patterns, fit_u; K17 words) and, in column mode, the resident pair
unwritten; the bound (bytes at 3.35 TB/s, f32 operations at 67 TFLOP/s);
the device operations one call runs, by torch.profiler.

With --parent DIR (a directory holding an earlier csrc/, e.g. a `git
archive` of the parent commit under the git-ignored _parent/) the earlier
class_hoist.cu and stitch_planes.cu are built too, called through a copy
of the earlier K4 wrapper (its column mode patches a clone of the
resident pair) and K17's unchanged C entry, and every timing runs in
turns (old, new, new, old), each call's outputs bit-equal to the current
build's.  With --sass DIR the SASS of each built library (cuobjdump
-sass) is written there.  Ends with one JSON line and the card's name and
power limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from .score_explain import device_ops, in_turns
from .static_rows import bound_ms
from .wave_phases import build_variant, card_name

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry of K4 before the one-launch column mode: no resident pair
PARENT_K4_ARGTYPES = [_P] * 4 + [_I, _P, _P, _P, _P] + [_I] * 3 + [_P]


def f32_ops_a_pair(cfg) -> int:
    """f32 operations of one (class, node) score: the fit strategy and
    BalancedAllocation over K scored resources, then the weighted sum
    (conversions not counted; chip_smoke.py f32_ops_per_scored_node)."""
    k = len(cfg.score_resources)
    per_res = {"LeastAllocated": 4, "MostAllocated": 3,
               "RequestedToCapacityRatio": 3 + 6 * (len(cfg.rtcr_shape) - 1)}[cfg.fit_strategy]
    return k * per_res + k + (2 * k + (k - 1) + 1 + 2 * k + (k - 1) + 1 + 3) + 3


def k4_work(U1: int, N: int, R: int, cfg, D: int = 0) -> tuple:
    """(bytes, operations) K4's function needs.  Full mode (D == 0): the
    requests and the node rows read once, base_u and fit_u written once;
    column mode: the resident pair read once and the new generation
    written once, the D listed columns' node rows and the list read once,
    and only those columns scored."""
    W = -(-N // 32)
    plane = 4 * U1 * N + 4 * U1 * W
    if D == 0:
        return 4 * U1 * R + 2 * 4 * N * R + plane, U1 * N * f32_ops_a_pair(cfg)
    return 4 * U1 * R + 4 * D + 2 * 4 * D * R + 2 * plane, U1 * D * f32_ops_a_pair(cfg)


def k17_work(rows: int, w_in: int, w_out: int) -> tuple:
    """(bytes, operations): every input word read once, every output word
    written once; a shift and an OR per source word."""
    return 4 * rows * (w_in + w_out), 2 * rows * w_in


def parent_class_usage_hoist(fn, req_u, node_used, node_alloc, cfg, cols=None, base_u=None, fit_u=None):
    """The K4 wrapper before the one-launch column mode, around its C entry:
    column mode patches clones of the resident pair in place."""
    import torch

    from ..ops import kernels

    dev = node_used.device
    U1, R = req_u.shape
    N = node_used.shape[0]
    W = -(-N // 32)
    ip, fp = kernels._score_params(cfg, R)
    if cols is None:
        base = torch.empty((U1, N), dtype=torch.float32, device=dev)
        fit = torch.empty((U1, W), dtype=torch.int32, device=dev)
        D, cols_ptr = 0, None
    else:
        base, fit = base_u.clone(), fit_u.clone()
        D, cols_ptr = cols.shape[0], cols.data_ptr()
    err = fn(req_u.data_ptr(), node_used.data_ptr(), node_alloc.data_ptr(), cols_ptr, D, kernels._host(ip),
             kernels._host(fp), base.data_ptr(), fit.data_ptr(), U1, N, R, kernels._stream(dev))
    kernels._raise_on(err, "class_usage_hoist (parent)")
    return base, fit


def parent_stitch_planes(fn, words, nl: int):
    import torch

    from ..ops import kernels

    wl = -(-nl // 32)
    rows, S = words.shape[0], words.shape[1] // wl
    out = torch.empty((rows, -(-(S * nl) // 32)), dtype=torch.int32, device=words.device)
    kernels._raise_on(fn(words.data_ptr(), out.data_ptr(), rows, S, nl, kernels._stream(words.device)),
                      "stitch_planes (parent)")
    return out


def _bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def choices_used(arr, choices, k: int):
    """node_used after the first k pods' placements (chip_smoke.py's)."""
    import torch

    used = arr.node_used.clone()
    c = choices[:k].to(torch.int64)
    m = c >= 0
    used.index_add_(0, c[m], arr.pod_req[:k][m])
    return used


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def k4_cells(old_fn, card: str) -> dict:
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, assign, incremental, infer_score_config, kernels
    from ..ops.incremental import HoistCache
    from . import workloads

    res = {}
    cells = []
    arr, meta = DeltaEncoder().encode_device(workloads.heterogeneous(**workloads.NORTH_STAR))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    cells.append(("north-star full", cfg, inc.req_u, arr.node_used, arr.node_alloc, None, None, None, 50))
    choices, _ = assign.schedule_batch(arr, cfg, inc=inc)
    used2 = choices_used(arr, choices, 2048)
    dirty = torch.nonzero((used2 != arr.node_used).any(dim=1)).flatten().to(torch.int32)
    cols = torch.full((incremental._round_up_pow2(dirty.numel()),), arr.N, dtype=torch.int32, device=arr.device)
    cols[: dirty.numel()] = dirty
    cells.append((f"north-star patch D={dirty.numel()}", cfg, inc.req_u, used2, arr.node_alloc, cols, inc.base_u,
                  inc.fit_u, 50))
    arr3, meta3 = DeltaEncoder().encode_device(workloads.spread_affinity(**workloads.CONFIG3))
    cfg3 = infer_score_config(arr3, DEFAULT_SCORE_CONFIG)
    inc3 = HoistCache().ensure(arr3, meta3, cfg3)
    cells.append(("config-3 full", cfg3, inc3.req_u, arr3.node_used, arr3.node_alloc, None, None, None, 20))
    for cell, c, req_u, used, alloc, cl, base_u, fit_u, reps in cells:
        U1, R = req_u.shape
        N = used.shape[0]
        if cl is None:
            want = incremental._usage_hoist_plain(req_u, used, alloc, c)
        else:
            want = incremental._patch_hoist_plain(base_u, fit_u, req_u, used, alloc, cl, c)
            resident = (base_u.clone(), fit_u.clone())
        wbits = [_bits(x) for x in want]

        def check(who, got, cell=cell, wbits=wbits):
            if not all(torch.equal(_bits(x), y) for x, y in zip(got, wbits)):
                raise RuntimeError(f"k4 {cell}: the {who} build's planes differ from plain")

        def new(req_u=req_u, used=used, alloc=alloc, c=c, cl=cl, base_u=base_u, fit_u=fit_u):
            return kernels.class_usage_hoist(req_u, used, alloc, c, cols=cl, base_u=base_u, fit_u=fit_u)

        calls = [("new", new)]
        if old_fn is not None:
            def old(req_u=req_u, used=used, alloc=alloc, c=c, cl=cl, base_u=base_u, fit_u=fit_u):
                return parent_class_usage_hoist(old_fn, req_u, used, alloc, c, cols=cl, base_u=base_u, fit_u=fit_u)

            calls = [("old", old), ("new", new), ("new", new), ("old", old)]
        turns = in_turns(f"k4 {cell}", f"U1={U1} N={N} R={R}" + ("" if cl is None else f" D={cl.numel()}"),
                         calls, check, reps)
        if cl is not None and not (torch.equal(_bits(base_u), _bits(resident[0])) and torch.equal(fit_u, resident[1])):
            raise RuntimeError(f"k4 {cell}: the resident pair was written")
        D = 0 if cl is None else int((cl < N).sum())
        nbytes, nops = k4_work(U1, N, R, c, D)
        b_ms, b_by = bound_ms(nbytes, nops)
        ops = {who: device_ops(call) for who, call in dict(calls).items()}
        res[cell] = dict(U1=U1, N=N, R=R, D=D, turns=turns, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=nops,
                         device_ops=ops)
        print(f"[k4 {cell}] {card} | == plain in every turn; bound {b_ms:.6f} ms ({b_by}: {nbytes} B, {nops} f32 "
              f"ops); device ops a call {ops}", flush=True)
    return res


def k17_cells(old_fn, card: str) -> dict:
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, bitplane, infer_score_config, kernels
    from ..ops.incremental import HoistCache
    from ..parallel.collectives import all_gather_nodes
    from ..parallel.mesh import make_mesh
    from . import workloads

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    host, meta = DeltaEncoder().encode(snap)
    cfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
    res = {}
    for S in (3, 4):
        mesh = make_mesh(S)
        arr, _ = DeltaEncoder(mesh=mesh).to_device(host, meta)
        nl, N = arr.nl, arr.N
        blocks = [kernels.packed_static_rows(sh, base=mesh.base(j, N)) for j, sh in enumerate(arr.shards)]
        big = all_gather_nodes(blocks, 1, arr.device)
        del blocks
        cells = [(f"S={S} nl={nl} dense rows", big, 20)]
        if S == 3:
            inc = HoistCache(mesh=mesh).ensure(arr, meta, cfg, host=host)
            tiled = all_gather_nodes([x.stat_u for x in inc.shards], 1, arr.device)
            cells.append((f"S={S} nl={nl} class planes", tiled, 50))
            del inc
        for cell, words, reps in cells:
            rows = words.shape[0]
            want = torch.cat([bitplane.stitch_planes_plain(words[r0:r0 + 4096], nl) for r0 in range(0, rows, 4096)])

            def check(who, got, cell=cell, want=want):
                if not torch.equal(got, want):
                    raise RuntimeError(f"k17 {cell}: the {who} build's words differ from plain")

            def new(words=words):
                return kernels.stitch_planes(words, nl)

            calls = [("new", new)]
            if old_fn is not None:
                def old(words=words):
                    return parent_stitch_planes(old_fn, words, nl)

                calls = [("old", old), ("new", new), ("new", new), ("old", old)]
            turns = in_turns(f"k17 {cell}", f"[{rows}, {words.shape[1]}] -> {want.shape[1]}", calls, check, reps)
            nbytes, nops = k17_work(rows, words.shape[1], want.shape[1])
            b_ms, b_by = bound_ms(nbytes, nops)
            ops = {who: device_ops(call) for who, call in dict(calls).items()}
            res[cell] = dict(rows=rows, w_in=words.shape[1], w_out=want.shape[1], S=S, nl=nl, turns=turns,
                             bound_ms=b_ms, bound_by=b_by, bytes=nbytes, device_ops=ops)
            print(f"[k17 {cell}] {card} | == plain in every turn; bound {b_ms:.6f} ms ({b_by}: {nbytes} B); device "
                  f"ops a call {ops}", flush=True)
            del want
        del arr, big, cells
        torch.cuda.empty_cache()
    return res


def dump_sass(libs, out_dir: str) -> None:
    """cuobjdump -sass of each built library into out_dir."""
    from ..ops import kernels

    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    for tag, lib in libs:
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, timeout=300)
        (Path(out_dir) / f"sass-{tag}.txt").write_text(proc.stdout + proc.stderr)
        print(f"[sass] {tag}: {lib.name} -> {out_dir}/sass-{tag}.txt (exit {proc.returncode})", flush=True)


def main(argv=None) -> int:
    import torch

    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="a directory holding an earlier csrc/ to time in turns")
    ap.add_argument("--sass", default="", help="a directory for the built libraries' SASS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hoist_stitch: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    old4 = old17 = None
    if args.parent:
        csrc = Path(args.parent) / "csrc"
        _, old4 = build_variant("class_usage_hoist", csrc / "class_hoist.cu", tag="parent")
        _, old17 = build_variant("stitch_planes", csrc / "stitch_planes.cu", tag="parent")
        old4.argtypes = PARENT_K4_ARGTYPES
    kernels.build(["class_usage_hoist", "stitch_planes", "packed_static_rows"])
    if args.sass:
        libs = [(s, Path(kernels._LIBS[f"{s}.cu"]._name)) for s in ("class_hoist", "stitch_planes")]
        if args.parent:
            libs += [(f"{s}-parent", kernels.BUILD_DIR / f"lib{s}-parent.so") for s in ("class_hoist", "stitch_planes")]
        dump_sass(libs, args.sass)
    result = dict(card=card, k4=k4_cells(old4, card), k17=k17_cells(old17, card))
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
