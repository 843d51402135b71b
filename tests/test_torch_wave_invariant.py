"""The class-row invariant that kernel K5's fallback reads, on the CPU.

K5 (csrc/wave_commit.cu) finds the fallback pod's node without an N-wide
rescore: it takes the lexmax of its class's row of t0u, with the block's
placed columns replaced by their s2 column.  That equals the rescore only
if (a) t0u stays the masked class rescore against the running usage,
t0u[u, n] == where(stat_u & fit(used), score(used + req_u[u]), -inf), at
every node, and (b) each pod's request equals its class's req_u, so that
the row scores the pod's own request.  Here, on ``wave_commit_plain``'s
output over small heterogeneous and gang clusters with many classes (the
default knobs, and short lists in small blocks, where fallbacks and epoch
refreshes are frequent):

- the returned t0u equals a fresh masked class rescore against the
  returned usage (the hoist ``_usage_hoist_plain`` + ``t0u_prologue``);
- every pod row's request equals its class's req_u, and for every valid
  pod the rescore of its own request against the returned usage equals
  its class's row of that t0u.

Tolerance: none (float32 compared as bits).  The ``cuda`` leg holds K5 to
``wave_commit_plain`` on the same inputs on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wave_invariant.py
"""

import pytest
import torch

from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, filters, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache, IncState, _usage_hoist_plain, score_flat
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CLUSTERS = {
    "heterogeneous": lambda: workloads.heterogeneous(64, 700, seed=1),
    "gang": lambda: workloads.gang(48, 12, 30, seed=2),  # 48 jobs, each its own class
}
KNOBS = {"default": {}, "short-lists": dict(wave_k=4, wave_block=16)}


def _state(name):
    arr, meta = encode_snapshot(CLUSTERS[name](), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    return arr, cfg, HoistCache().ensure(arr, meta, cfg)


def _bits(x):
    return x.view(torch.int32)


@pytest.fixture(scope="module", params=sorted(CLUSTERS))
def cluster(request):
    return (request.param,) + _state(request.param)


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_t0u_stays_the_masked_class_rescore(cluster, knobs):
    name, arr, cfg, inc = cluster
    N = arr.N
    U1 = inc.req_u.shape[0]
    assert U1 > (40 if name == "gang" else 20)
    t0u0 = assign.t0u_prologue(inc, N)
    com, out, _, used, t0u, blocks, epochs = assign.wave_commit_plain(
        inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u0, inc.stat_u, arr.node_alloc, inc.req_u, cfg,
        **KNOBS[knobs])
    assert int((out >= 0).sum()) > 0 and blocks > 1
    base_f, fit_f = _usage_hoist_plain(inc.req_u, used, arr.node_alloc, cfg)
    fresh = assign.t0u_prologue(IncState(cls=inc.cls, req_u=inc.req_u, stat_u=inc.stat_u, base_u=base_f,
                                         fit_u=fit_f), N)
    assert torch.equal(_bits(t0u), _bits(fresh))


def test_pod_requests_are_their_class_rows(cluster):
    name, arr, cfg, inc = cluster
    cls = inc.cls.to(torch.int64)
    assert torch.equal(arr.pod_req, inc.req_u[cls])
    # the fallback's own rescore of each valid pod == its class row, on the
    # cycle-start usage and on a usage the wave leaves
    _, _, _, used, t0u, _, _ = assign.wave_commit_plain(
        inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, assign.t0u_prologue(inc, arr.N), inc.stat_u,
        arr.node_alloc, inc.req_u, cfg)
    ninf = torch.tensor(float("-inf"))
    for u_used, rows in ((arr.node_used, assign.t0u_prologue(inc, arr.N)), (used, t0u)):
        for p in torch.nonzero(arr.pod_valid).flatten().tolist():
            req = arr.pod_req[p]
            stat = bitplane.unpack(inc.stat_u[cls[p]], arr.N)
            fit = filters.fit_ok(req, u_used, arr.node_alloc)
            own = torch.where(stat & fit, score_flat(u_used + req[None], arr.node_alloc, cfg), ninf)
            assert torch.equal(_bits(own), _bits(rows[cls[p]])), p


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_wave_invariant.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_wave_kernel_matches_plain(card, name, knobs):
    from kubernetes_tpu_torch.ops import kernels

    arr, cfg, inc = _state(name)
    want = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used,
                                    assign.t0u_prologue(inc, arr.N), inc.stat_u, arr.node_alloc, inc.req_u, cfg,
                                    **KNOBS[knobs])
    d = arr.to(card)
    dinc = IncState(*(x.to(card) if isinstance(x, torch.Tensor) else x for x in inc))
    got = kernels.wave_commit(d, dinc, cfg, **KNOBS[knobs])
    for g, w in zip(got[:5], want[:5]):
        g = g.cpu()
        if g.dtype == torch.float32:
            g, w = _bits(g), _bits(w)
        assert torch.equal(g, w)
    assert int(got[5]) == want[5] and int(got[6]) == want[6]
