"""Print the JAX package's decisions at the north-star shape.

Runs the JAX package's schedule_batch on the CPU (its per-pod scan) at
heterogeneous(20000, 50000, seed=0) and prints the number of scheduled pods
and the sha256 of choices[:n_pods] as little-endian int32 — the reference
kubernetes_tpu_torch/bench/workloads.py keeps, and chip_smoke.py holds the
port's choices on the card against.  About 20 s and 1.5 GB on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_north_star_digest.py
"""

import hashlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import force_cpu_platform  # noqa: E402

force_cpu_platform(1)

from kubernetes_tpu.api.snapshot import encode_snapshot  # noqa: E402
from kubernetes_tpu.bench.workloads import heterogeneous  # noqa: E402
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch  # noqa: E402


def main() -> None:
    arr, meta = encode_snapshot(heterogeneous(20000, 50000, seed=0))
    choices, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    c = np.asarray(choices)[: meta.n_pods].astype("<i4")
    print("scheduled", int((c >= 0).sum()), "sha256", hashlib.sha256(c.tobytes()).hexdigest())


if __name__ == "__main__":
    main()
