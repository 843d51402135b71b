"""Where kernel K12 rounds' time goes on BASELINE config 3, phase by phase
and barrier by barrier, on one card.

    python3 -m kubernetes_tpu_torch.bench.rounds_phases [--parent DIR]

Builds csrc/rounds.cu a second time with -DKTT_ROUNDS_PHASES: thread 0 of
every block then adds the SM cycles (clock64) between the round loop's
phase boundaries into device counters (bench/wave_phases.py's method), and
logs each grid barrier's wait per block, tagged with the barrier's site.
Runs that build on config 3, spread_affinity(5000, 10000, seed=0), through
the usual wrapper in both of K12's single-device modes -- dense (after K7's
static and eligibility planes) and class-row (after HoistCache.ensure) --
checks its outputs equal the normal build's bit for bit, and prints per
cell:

- block 0's phase split (its cycles per phase, their share, that share of
  the instrumented launch's time, how often the phase ran);
- every block's own cycles per phase (mean and max over the blocks);
- per barrier site: how often it ran, its latency (the wait of the block
  that arrived last, which waited for nobody), the blocks' mean wait past
  that latency (waiting for the slowest block), and which blocks arrived
  last most often; then the barrier time of the mean block split into the
  latency and the work it waited for.

The normal build is timed before and after, so the counters' cost shows.
With --parent DIR (a directory holding an earlier csrc/, e.g. a git
archive of the parent commit under the git-ignored _parent/) the earlier
rounds.cu is built too, checked bit-equal, split by its own phase enum and
timed against the current one in turns (old, new, new, old).  Ends with
one JSON line and the card's name and power limit as nvidia-smi gives
them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys

import numpy as np

from .wave_phases import card_name, split_cell, variants

PHASES = (  # the order of the PH_* enum in csrc/rounds.cu
    ("chunk", "a chunk's start: its pod's slots, share row and the chunk state"),
    ("spread", "(A1) the waiver and the slice's spread minMatch partials; their combination"),
    ("feas", "(A2) the slice's feasibility and raws, the five normalisation maxima"),
    ("total", "(A3) their combination, the slice's masked total row"),
    ("topk", "(A3) the slice's top-kl by lax.top_k's key"),
    ("merge", "(A3) the leader's merge of the cluster's lists into the pod's top-Zr and argmax"),
    ("cluster", "(A) the waits at the re-hoist's three cluster barriers"),
    ("speculate", "(B) ranks and the dispersal speculation, alike in every block"),
    ("rescore", "(C) the leader rescoring the candidate columns (block 0's: candidate 0's warp)"),
    ("repair", "(C) the slice's best unpicked node; t and the hazards"),
    ("commit", "(D) the confirmed prefix, the commit entries, usage, ports, total_t"),
    ("apply", "(E) the block's share of the count-plane updates"),
    ("barrier", "the grid barriers that close the phases"),
)
# what the blocks wait for at each barrier site (the BS_* enum's names):
# the work of the phases that the barrier closes
SITE_WAITS = {
    "start": "the start state's copy",
    "rows": "the slowest pod's row pass and merge (A)",
    "repaired": "the slowest repair (B, C)",
    "round": "the slowest block's commit writes and count-plane updates (D, E)",
}
MAX_BLOCKS = 256  # csrc/rounds.cu PH_MAX_BLOCKS
SRC = "rounds.cu"


def site_names(text: str):
    """The BS_* names of a rounds.cu source's barrier-site enum, in order,
    lower-cased."""
    m = re.search(r"enum\s*\{\s*(BS_[^}]*)\}", text)
    names = [t.strip() for t in m.group(1).split(",")] if m else []
    return tuple(n[3:].lower() for n in names if n.startswith("BS_") and n != "BS_N")


def barrier_split(tag: str, run, phase_fn, lib, n_phases: int, phases, sites, cap: int) -> dict:
    """One launch of run() through the instrumented entry `phase_fn` with
    the barrier log set: every block's own cycles per phase and each
    barrier site's latency, waits and last arrivers."""
    import torch

    from ..ops import kernels

    blocks = lib.ktt_rounds_blocks
    blocks.argtypes = [ctypes.c_void_p]
    blocks.restype = ctypes.c_int
    set_log = lib.ktt_rounds_log
    set_log.argtypes = [ctypes.c_void_p, ctypes.c_int]
    set_log.restype = ctypes.c_int
    cyc = np.zeros((n_phases, MAX_BLOCKS), dtype=np.uint64)
    log = torch.zeros((MAX_BLOCKS, cap), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    if blocks(cyc.ctypes.data) or set_log(log.data_ptr(), cap):
        raise RuntimeError("setting the rounds barrier log failed")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    normal = kernels._fn("rounds")
    kernels._FNS["rounds"] = phase_fn
    try:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    finally:
        kernels._FNS["rounds"] = normal
    ms = start.elapsed_time(end)
    err = blocks(cyc.ctypes.data) or set_log(None, 0)
    if err:
        raise RuntimeError(f"reading the rounds barrier log failed: cudaError {err}")
    active = cyc.sum(axis=0) > 0
    nb = int(active.sum())
    cyc = cyc[:, :nb].astype(np.float64)
    per_ms = cyc[:, 0].sum() / ms  # block 0's cycles cover the launch past its first barrier
    ent = log[:nb].cpu().numpy().view(np.uint64)
    n_bar = int((ent[0] != 0).sum())
    if not all(int((ent[b] != 0).sum()) == n_bar for b in range(nb)):
        raise RuntimeError(f"{tag}: the blocks passed different numbers of grid barriers")
    ent = ent[:, :n_bar]
    site = (ent >> np.uint64(56)).astype(np.int64)
    wait = (ent & np.uint64((1 << 56) - 1)).astype(np.float64)
    if not (site == site[0]).all():
        raise RuntimeError(f"{tag}: the blocks' barrier sites differ")
    lat = wait.min(axis=0)
    last = wait.argmin(axis=0)
    over = wait - lat
    own = {name: dict(mean_ms=float(cyc[i].mean() / per_ms), max_ms=float(cyc[i].max() / per_ms),
                      max_block=int(cyc[i].argmax()))
           for i, (name, _) in enumerate(phases)}
    print(f"[{tag}] {nb} blocks, {n_bar} grid barriers in one launch of {ms:.3f} ms "
          f"({per_ms / 1e3:.0f} cycles a us); each block's own cycles per phase (mean / max over blocks):",
          flush=True)
    for name, r in own.items():
        print(f"[{tag}]   {name:10s} {r['mean_ms']:9.3f} / {r['max_ms']:9.3f} ms (max: block {r['max_block']})",
              flush=True)
    rows, groups = {}, {"latency": float(lat.sum() / per_ms)}
    for k, name in enumerate(sites):
        sel = site[0] == k
        n = int(sel.sum())
        if not n:
            continue
        counts = np.bincount(last[sel], minlength=nb)
        top = [(int(b), int(counts[b])) for b in np.argsort(-counts, kind="stable")[:3] if counts[b]]
        r = dict(runs=n, latency_ms=float(lat[sel].sum() / per_ms), latency_us=float(lat[sel].mean() / per_ms * 1e3),
                 wait_ms_mean_block=float(over[:, sel].sum(axis=1).mean() / per_ms),
                 wait_ms_block0=float(over[0, sel].sum() / per_ms), last=top, waits_for=SITE_WAITS.get(name, name))
        rows[name] = r
        groups[r["waits_for"]] = groups.get(r["waits_for"], 0.0) + r["wait_ms_mean_block"]
        print(f"[{tag}]   barrier {name:10s} x{n:5d}: latency {r['latency_us']:6.2f} us ({r['latency_ms']:8.3f} ms), "
              f"waits past it {r['wait_ms_mean_block']:8.3f} ms a block (block 0 {r['wait_ms_block0']:8.3f}); "
              f"last to arrive: {', '.join(f'block {b} x{c}' for b, c in top)} -- {r['waits_for']}", flush=True)
    total = sum(groups.values())
    print(f"[{tag}] the mean block's barrier time {total:.3f} ms: "
          + ", ".join(f"{k} {v:.3f} ms ({v / total * 100:.1f}%)" for k, v in groups.items()), flush=True)
    return dict(blocks=nb, barriers=n_bar, ms=ms, cycles_per_us=per_ms / 1e3, own=own, sites=rows, split=groups)


def main(argv=None) -> int:
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels
    from ..ops.incremental import HoistCache
    from . import workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="a directory holding an earlier csrc/ to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rounds_phases: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    phase, parent = variants("rounds", "KTT_ROUNDS_PHASES", "ktt_rounds_phases", args.parent, PHASES)
    lib = ctypes.CDLL(str(kernels.BUILD_DIR / "librounds-phases.so"))
    for ln in kernels.BUILD_LOG.get(SRC, "").splitlines():  # ptxas -v: registers, shared memory, spills
        if re.search(r"registers|spill", ln):
            print(f"[rounds-phases build] {ln.strip()}", flush=True)
    sites = site_names((kernels.CSRC / SRC).read_text())
    names = ("choices", "used", "ordinals", "scal")
    arr, meta = DeltaEncoder().encode_device(workloads.spread_affinity(**workloads.CONFIG3))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    inc = HoistCache().ensure(arr, meta, cfg)
    cells = {"dense": lambda: kernels.rounds(arr, cfg, sfs, eligs, (None, None)),
             "class-row": lambda: kernels.rounds(arr, cfg, inc=inc)}
    result = dict(card=card, cells={})
    for cell, run in cells.items():
        ref = run()
        sweeps = kernels.read_sweeps(ref[3])
        tag = f"rounds-phases {cell}"
        print(f"[{tag}] {card} | config 3 P={arr.P} N={arr.N} T={arr.term_counts0.shape[0]}: "
              f"{arr.P // assign.RCHUNK} chunks, {sweeps} rounds", flush=True)
        res = split_cell(tag, "rounds", run, names, phase, parent, dict(P=arr.P, N=arr.N, rounds=sweeps))
        cap = 8 * sweeps + 2 * (arr.P // assign.RCHUNK) + 8
        res["barriers"] = barrier_split(tag, run, phase[1], lib, len(PHASES), PHASES,
                                        sites, cap)
        result["cells"][cell] = res
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
