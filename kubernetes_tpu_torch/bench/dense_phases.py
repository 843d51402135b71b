"""Where chunk_rounds_dense's (K8's) time goes, phase by phase, on one card.

    python3 -m kubernetes_tpu_torch.bench.dense_phases [--parent DIR]

Builds csrc/chunk_rounds_dense.cu a second time with -DKTT_DENSE_PHASES:
thread 0 of block 0 then adds the SM cycles (clock64) between the phase
boundaries of the chunk loop and of block 0's round loop into device
counters (bench/wave_phases.py's method).  Runs that build through the
usual wrapper on the north star's dense step (heterogeneous(20000, 50000,
seed=0): 400 chunks) and on BASELINE config 5's real device-fixpoint
iteration (gang(1000, 64, 2000, seed=0): 512 chunks, every pod valid),
each after K7 packed_static_rows, checks its outputs equal the normal
build's bit for bit, and prints per phase: block 0's cycles per launch,
their share of its total, that share of the instrumented launch's time
(CUDA events), and how often the phase ran.  The normal build is timed
before and after in the same run, so the counters' cost shows.  With
--parent DIR (a directory holding an earlier csrc/) the earlier source is
built too, checked bit-equal, split by its own phase enum and timed
against the current one in turns (old, new, new, old).  Ends with one
JSON line and the card's name and power limit as nvidia-smi gives them.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys

from .wave_phases import card_name, split_cell, variants

PHASES = (  # the order of the PH_* enum in csrc/chunk_rounds_dense.cu
    ("setup", "the launch's and each chunk's state load, each round's done test"),
    ("hoist", "block 0's share of the first chunk's rows and lists (later chunks: the other blocks')"),
    ("patch", "the usage update and block 0's share of the next chunk's list patch"),
    ("rescore", "pass 1: the dirty columns the last round changed, rescored (M2)"),
    ("list", "pass 1: the usable list positions, the head table, first pointers and claims"),
    ("spec", "pass 1: the dispersal speculation"),
    ("pick", "pass 1: each pod's pick c, the pick table"),
    ("p2setup", "pass 2: next same-node picks, same-node usage uj, static bits at the picks"),
    ("p2eval", "pass 2: each pod's revalidated pick t, 32 pods at a time up to the first mismatch"),
    ("prefix", "the committed prefix, owners and new slots"),
    ("absorb", "the dirty slots' usage, the stale list entries"),
    ("usage", "the chunk's outputs and its dirty slots for the next chunk's patch"),
    ("barrier", "the grid barriers (block 0 waits for the next chunk's lists, then for the patch)"),
)


def main(argv=None) -> int:
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels
    from . import workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="a directory holding an earlier csrc/ to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_phases: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    phase, parent = variants("chunk_rounds_dense", "KTT_DENSE_PHASES", "ktt_dense_phases", args.parent,
                             PHASES)
    names = ("choices", "used", "ordinals", "scal")
    cells = {"north-star": lambda: workloads.heterogeneous(**workloads.NORTH_STAR),
             "config5": lambda: workloads.gang(**workloads.CONFIG5)}
    result = dict(card=card, cells={})
    for cell, make in cells.items():
        arr, meta = DeltaEncoder().encode_device(make())
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        sfs = kernels.packed_static_rows(arr)

        def run():
            return kernels.chunk_rounds_dense(arr, cfg, sfs)

        ref = run()
        sweeps = kernels.read_sweeps(ref[3])
        print(f"[dense-phases {cell}] {card} | P={arr.P} N={arr.N} R={arr.R}: {arr.P // assign.CHUNK} chunks, "
              f"{sweeps} rounds", flush=True)
        result["cells"][cell] = split_cell(f"dense-phases {cell}", "chunk_rounds_dense", run, names, phase, parent,
                                           dict(P=arr.P, N=arr.N, rounds=sweeps))
        del arr, sfs, ref
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
