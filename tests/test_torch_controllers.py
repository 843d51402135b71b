"""The port's controllers (kubernetes_tpu_torch/scheduler/controllers.py's
ControllerManager and its ~18 controllers, network.py's EndpointSlice
controller and proxier, disruption.py) against the JAX package's, on the
CPU.

One parity case for every test of the JAX package's test_controllers.py,
test_network_controllers.py and test_disruption.py: tests/torch_mirror.py
runs the test in both packages (the port's side re-pointed at
kubernetes_tpu_torch, tests/helpers.py's nodes and pods carried across by
convert.from_jax_objects, a Scheduler's batch cycle on the CPU) and holds
the recordings equal, exactly: every store's tables at the end (pods with
their nodes, phases, IPs, owners and readiness; ReplicaSets, Deployments,
Jobs, StatefulSets, DaemonSets, EndpointSlices, PDB status, ...) with its
resource version, and every apiserver request, admission and
authorization verdict on the way.
"""

import pytest

from torch_mirror import cases, run_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("case", cases("test_controllers", "test_network_controllers", "test_disruption"))
def test_port_matches_jax(case, tmp_path):
    want, got = run_both(case, tmp_path)
    assert got == want
