"""The port's apiserver (kubernetes_tpu_torch/scheduler/apiserver.py and
its handler chain: auth.py, flowcontrol.py, admission.py, crd.py) against
the JAX package's, on the CPU.

One parity case for every test of the JAX package's test_apiserver.py,
test_crd.py and test_webhooks_sa.py: tests/torch_mirror.py runs the test
in both packages (the port's side re-pointed at kubernetes_tpu_torch, the
helpers' objects carried across by convert.from_jax_objects) and holds the
two recordings equal, exactly: every request through APIServer.handle with
its outcome (the returned objects, or the error's class and message:
Unauthenticated, Forbidden, APF's RequestRejected, AdmissionDenied, CRD
validation), every admission and authorization verdict, every kubectl
output, and every store's tables and resource version at the end.  The
webhook cases run each package's apiserver against a webhook server on the
loopback.
"""

import pytest

from torch_mirror import cases, run_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("case", cases("test_apiserver", "test_crd", "test_webhooks_sa"))
def test_port_matches_jax(case, tmp_path):
    want, got = run_both(case, tmp_path)
    assert got == want
