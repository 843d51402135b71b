"""``python -m kubernetes_tpu_torch.analysis --flight [PATH]`` — the port of
the JAX package's post-mortem flight-recorder reader
(its ``analysis/__main__.py`` ``--flight``, ``_dump_flight``).

It renders the decision flight-recorder dump a dying Scheduler left in its
checkpoint dir (scheduler/flightrecorder.py: written on a kill.* site or a
wave recovery); PATH defaults to ``$KTPU_CHECKPOINT_DIR/flight.json``.  Exit
0 parseable, 2 missing or corrupt (the JAX contract).

Every other mode of the JAX command line — the AST rules and the baseline,
``--lock-graph``, the device, shard and memory passes — is the static
analyzer, which the port does not have (ROADMAP.md A13, part 2): asked for
one, the command says so and exits 2.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

_ANALYZER = "the static analyzer (ROADMAP.md A13, part 2)"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kubernetes_tpu_torch.analysis")
    ap.add_argument("--flight", nargs="?", const="", default=None, metavar="PATH",
                    help="read a decision flight-recorder dump post-mortem and exit; PATH defaults to "
                         "$KTPU_CHECKPOINT_DIR/flight.json.  Exit 0 parseable, 2 missing/corrupt")
    # the JAX command line's other modes, refused
    for flag in ("--device", "--shard", "--mem", "--write-baseline", "--lock-graph", "--no-baseline"):
        ap.add_argument(flag, action="store_true", help=f"not ported: {_ANALYZER}")
    for flag in ("--root", "--baseline", "--format", "--output", "--rules"):
        ap.add_argument(flag, default=None, help=f"not ported: {_ANALYZER}")
    args = ap.parse_args(argv)
    if args.flight is not None:
        return _dump_flight(args.flight)
    asked = [f"--{k.replace('_', '-')}" for k, v in vars(args).items() if k != "flight" and v not in (None, False)]
    print(f"kubernetes_tpu_torch.analysis: {' '.join(asked) or 'the rule run'} is {_ANALYZER}, which the port "
          "does not have; only --flight [PATH] runs", file=sys.stderr)
    return 2


def _dump_flight(path: str) -> int:
    """Post-mortem reader for the decision flight recorder: render the dump
    a dying scheduler left in its checkpoint dir.  A missing or corrupt
    dump is exit 2 (unusable evidence)."""
    from ..scheduler.flightrecorder import FLIGHT_FILENAME, load_flight, render_flight

    if not path:
        ckpt = os.environ.get("KTPU_CHECKPOINT_DIR", "")
        if not ckpt:
            print("ktpu-verify: --flight needs a path or KTPU_CHECKPOINT_DIR", file=sys.stderr)
            return 2
        path = os.path.join(ckpt, FLIGHT_FILENAME)
    try:
        doc = load_flight(path)
        text = render_flight(doc)
    except ValueError as e:
        print(f"ktpu-verify: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # noqa: BLE001 — malformed evidence is exit 2
        # a structurally-valid dump with wrong-typed fields must still be
        # "unusable" (2), never a traceback read as exit 1
        print(f"ktpu-verify: malformed flight dump {path}: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
