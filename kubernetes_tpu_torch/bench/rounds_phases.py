"""Where kernel K12 rounds' time goes on BASELINE config 3, phase by phase.

    python3 -m kubernetes_tpu_torch.bench.rounds_phases

Builds csrc/rounds.cu a second time with -DKTT_ROUNDS_PHASES: thread 0 of
block 0 then adds the SM cycles (clock64) between the round loop's phase
boundaries into device counters (bench/wave_phases.py's method).  Runs that
build on config 3, spread_affinity(5000, 10000, seed=0), through the usual
wrapper, checks its outputs equal the normal build's bit for bit, and
prints per phase: block 0's cycles per launch, their share of its total,
that share of the instrumented launch's time (CUDA events), and how often
the phase ran.  The normal build is timed before and after in the same
run, so the counters' cost shows.  Ends with one JSON line and the card's
name and power limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import json
import sys

from .wave_phases import REPS, build_phase_lib, card_name, read_phases, report, timed

PHASES = (  # the order of the PH_* enum in csrc/rounds.cu
    ("chunk", "a chunk's start: its pods' slots, share rows and state"),
    ("rehoist", "(A) block 0's pod row: minMatch, feasibility, raws, scalars, total, top-32"),
    ("speculate", "(B) ranks and the dispersal speculation"),
    ("repair", "(C) block 0's pod: candidate columns and the best unpicked node"),
    ("commit", "(D) the confirmed prefix, usage, ports, commit entries"),
    ("apply", "(E) block 0's share of the count-plane updates"),
    ("barrier", "the grid barriers that close the phases"),
)


def main() -> int:
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from . import workloads

    if not torch.cuda.is_available():
        print("rounds_phases: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    read, phase_fn = build_phase_lib("rounds", "KTT_ROUNDS_PHASES", "ktt_rounds_phases")
    normal_fn = kernels._fn("rounds")
    arr, meta = DeltaEncoder().encode_device(workloads.spread_affinity(**workloads.CONFIG3))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)

    def run():
        return kernels.rounds(arr, cfg, sfs, eligs, (None, None))

    ref, ms_normal_a = timed("rounds", normal_fn, run)
    got, ms_phases = timed("rounds", phase_fn, run, read, len(PHASES))
    cycles, hits = read_phases(read, len(PHASES))
    _, ms_normal_b = timed("rounds", normal_fn, run)
    for name, a, b in zip(("choices", "used", "ordinals", "status"), ref, got):
        if not torch.equal(a, b):
            raise RuntimeError(f"the instrumented rounds kernel's {name} differs from the normal build's")
    sweeps = kernels.read_sweeps(ref[3])
    print(f"[rounds-phases] {card} | config 3 P={arr.P} N={arr.N} T={arr.term_counts0.shape[0]}: "
          f"{arr.P // 16} chunks, {sweeps} rounds; instrumented {ms_phases:.3f} ms, normal {ms_normal_a:.3f} / "
          f"{ms_normal_b:.3f} ms (before / after), block 0's cycles per launch "
          f"{float(cycles.sum()) / REPS:.0f}", flush=True)
    rows = report("rounds-phases", PHASES, cycles, hits, ms_phases)
    print(json.dumps(dict(card=card, rounds=sweeps, ms_instrumented=ms_phases,
                          ms_normal=[ms_normal_a, ms_normal_b], phases=rows)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
