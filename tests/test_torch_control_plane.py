"""The control plane as a whole, the port's against the JAX package's, on
the CPU.

- test_round3_integration.py (seeds 42 and 7: churn through the Scheduler
  in mode="tpu" with two profiles, hollow kubelets, Jobs, deletes, the
  resident encoder against a fresh one) and test_round5_integration.py
  (storage, readiness probes, EndpointSlices and batched preemption): one
  parity case each, tests/torch_mirror.py running the test in both
  packages (the port's batch cycle on the CPU) and holding the recordings
  equal, exactly.  Where round 3 compares the resident encoder with a
  fresh one, the port's side calls DeltaEncoder.encode_device, the JAX
  encode's counterpart (the port's encode returns the host arrays).
- The slice: kubernetes_tpu_torch/bench/control_plane.py's scenario (the
  manifest applied through the apiserver, the controllers, the Scheduler,
  the hollow kubelets and the proxier in rounds on a FakeClock; kubectl
  scale and drain; 1% of the pods deleted) at control_plane.SMALL, 20
  nodes and 5 Deployments, in the port's three modes (mode="tpu" on the
  CPU, "native", "cpu") against the JAX package's modules driven by the
  same code in mode="tpu": the digests (every pod's node, phase, IP,
  restart count and readiness, every EndpointSlice, the Scheduler's
  events), the rounds and the events held equal.  The JAX side of the
  full-size digest in workloads.CONTROL_PLANE_DIGEST comes from
  tests/torch_control_plane_reference.py.
- test_soak.py's threaded soak on the port, in mode="cpu" and in
  mode="tpu" on the CPU: its convergence invariants (threads order the
  work differently on every run, so nothing is compared with the JAX run).
"""

import pytest

from torch_control_plane_reference import jax_modules
from torch_mirror import cases, run, run_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from kubernetes_tpu_torch.bench import control_plane as cp  # noqa: E402


@pytest.mark.parametrize("seed", [42, 7])
def test_round3_integration_matches_jax(seed, tmp_path):
    # the port's DeltaEncoder.encode returns host arrays; encode_device is
    # the JAX encode's counterpart (the arrays on the encoder's device)
    subst = (("_delta_enc.encode(snap)", "_delta_enc.encode_device(snap)"),
             ("DeltaEncoder().encode(snap)", "DeltaEncoder().encode_device(snap)"))
    want, got = run_both(("test_round3_integration", "test_round3_churn_soak_invariants"), tmp_path,
                         port_subst=subst, seed=seed)
    assert got == want


@pytest.mark.parametrize("case", cases("test_round5_integration"))
def test_round5_integration_matches_jax(case, tmp_path):
    want, got = run_both(case, tmp_path)
    assert got == want


@pytest.fixture(scope="module")
def jax_small():
    return cp.run(**cp.SMALL, mods=jax_modules(), mode="tpu")


@pytest.mark.parametrize("mode", ["tpu", "native", "cpu"])
def test_control_plane_scenario_matches_jax(jax_small, mode):
    got = cp.run(**cp.SMALL, mode=mode, device=None if mode == "cpu" else "cpu")
    keys = ("digest", "rounds", "rounds_up", "rounds_scale", "rounds_drain", "rounds_churn", "deleted",
            "drain_pods", "final_pods", "events", "objects", "pods")
    assert {k: got[k] for k in keys} == {k: jax_small[k] for k in keys}
    assert got["deleted"] >= 1 and got["drain_pods"] >= 1 and got["final_pods"] == got["pods"] + 4


@pytest.mark.parametrize("mode", ["cpu", "tpu"])
def test_soak_on_the_port(mode, tmp_path):
    """test_soak.py's soak, run in the port with its Scheduler in `mode`
    (the batch cycle on the CPU): the test's own invariants."""
    subst = (('SchedulerConfiguration(mode="cpu")', f'SchedulerConfiguration(mode="{mode}")'),)
    rec = run(("test_soak", "test_full_stack_soak_converges"), "port", tmp_path, subst=subst)
    assert rec["stores"]
