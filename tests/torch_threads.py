"""One torch intra-op thread for the port's CPU tests.

The plain versions run many tiny tensor operations.  Under the suite's
parallel workers, torch's default intra-op pool (one thread per core, in
every worker) oversubscribes the cores, and its spinning threads slow each
worker by two orders of magnitude: the plain rounds scan on
spread_affinity(200, 512) took 2.2 s alone at 8 threads, 412 s in each of
six concurrent processes at 8 threads, and 3.7 s in each at one thread (on
an 8-core machine).  Results do not depend on the thread count: the plain
versions' float sums are integer-valued or taken in a fixed sequential
order.  Each test_torch_*.py module imports this module-scoped autouse
fixture, which runs before the module's other fixtures and restores the
count after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
