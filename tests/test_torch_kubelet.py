"""The port's hollow kubelet (kubernetes_tpu_torch/scheduler/kubelet.py:
pod workers, PLEG, prober, volume manager; cri.py's FakeCRI; cm.py's CPU
and eviction managers; devicemanager.py) against the JAX package's, on the
CPU.

One parity case for every test of the JAX package's test_kubelet_workers.py,
test_cm.py and test_devicemanager.py: tests/torch_mirror.py runs the test
in both packages (the port's side re-pointed at kubernetes_tpu_torch,
tests/helpers.py's objects carried across by convert.from_jax_objects; each
side's checkpoints in a directory of its own) and holds the recordings
equal, exactly: every store's tables at the end (pod phases, IPs, restart
counts, readiness, node conditions and leases' holders) and every request
on the way.
"""

import pytest

from torch_mirror import cases, run_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("case", cases("test_kubelet_workers", "test_cm", "test_devicemanager"))
def test_port_matches_jax(case, tmp_path):
    want, got = run_both(case, tmp_path)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pods_on_node_is_the_filter_of_every_pod(seed):
    """ClusterStore.pods_on_node (the kubelet's pod-IP search reads it)
    holds, after every pod write, exactly the pods a scan of list_pods()
    finds on each node."""
    import random

    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.scheduler.store import ClusterStore

    rng = random.Random(seed)
    store = ClusterStore()
    nodes = ["", "n0", "n1", "n2"]
    names = [f"p{i}" for i in range(12)]
    for _ in range(400):
        name = rng.choice(names)
        uid = f"default/{name}"
        op = rng.choice(("add", "update", "status", "bind", "delete"))
        if op == "delete":
            store.delete_pod(uid)
        elif op == "bind":
            if uid in store.pods:
                store.bind(uid, rng.choice(nodes[1:]))
        else:
            pod = t.Pod(name=name, node_name=rng.choice(nodes), pod_ip=f"10.0.0.{rng.randrange(1, 9)}")
            {"add": store.add_pod, "update": store.update_pod, "status": store.update_pod_status}[op](pod)
        for n in nodes[1:]:
            want = sorted(p.uid for p in store.list_pods() if p.node_name == n)
            assert sorted(p.uid for p in store.pods_on_node(n)) == want
