"""The JAX package's side of the [control-plane] scenario
(kubernetes_tpu_torch/bench/control_plane.py run): the same scenario driven
through the JAX package's own modules (apiserver, controllers, Scheduler,
hollow kubelets, proxier), its digest printed as JSON.

    KTPU_FORCE_CHUNKED=1 KTPU_MEMWATCH=0 JAX_PLATFORMS=cpu \
        python tests/torch_control_plane_reference.py [NODES DEPLOYMENTS REPLICAS] [--mode tpu|native|cpu]

With no size it runs control_plane.FULL, the size chip_smoke.py's
[control-plane] phase holds to workloads.CONTROL_PLANE_DIGEST.  The JAX
Scheduler's decisions do not depend on its route, so KTPU_FORCE_CHUNKED=1
only makes the CPU run faster.
"""

import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def jax_modules() -> SimpleNamespace:
    from kubernetes_tpu import kubectl
    from kubernetes_tpu.api import serialize
    from kubernetes_tpu.scheduler import apiserver, auth, controllers, kubelet, leases, network, queue, tracing
    from kubernetes_tpu.scheduler.config import SchedulerConfiguration
    from kubernetes_tpu.scheduler.scheduler import Scheduler

    return SimpleNamespace(serialize=serialize, kubectl=kubectl, apiserver=apiserver, auth=auth,
                           controllers=controllers, kubelet=kubelet, leases=leases, network=network,
                           queue=queue, tracing=tracing, Scheduler=Scheduler,
                           SchedulerConfiguration=SchedulerConfiguration)


def main(argv) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from kubernetes_tpu_torch.bench import control_plane as cp

    mode = "tpu"
    if "--mode" in argv:
        i = argv.index("--mode")
        mode = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    size = dict(zip(("nodes", "deployments", "replicas"), map(int, argv))) if argv else cp.FULL
    r = cp.run(**size, mods=jax_modules(), mode=mode, log=lambda s: print(s, file=sys.stderr, flush=True))
    keep = ("nodes", "pods", "rounds", "rounds_up", "rounds_scale", "rounds_drain", "rounds_churn", "deleted",
            "drain_pods", "final_pods", "events", "digest", "wall_s")
    print(json.dumps({k: r[k] for k in keep}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
