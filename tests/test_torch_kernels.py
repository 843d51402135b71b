"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device; whether a
card is present is decided in a fixture, never at import.  The file imports
no JAX, so it runs on the card's machine without the JAX package's test
setup:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Tolerance: none.  The static-feasibility kernel must equal the plain mask
(torch.equal); the fit-scan kernel's choices and final usage must equal the
plain scan's, which needs every score bitwise equal wherever a tie or a
near-tie decides.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.snapshot import ClusterArrays, encode_snapshot
from kubernetes_tpu_torch.bench.workloads import heterogeneous, mixed
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, filters, infer_score_config, kernels
from kubernetes_tpu_torch.ops.assign import schedule_scan_plain
import torch_hoist_stitch_cases as hs
import torch_stage_b_cases as sb
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytestmark = pytest.mark.cuda

STRATEGIES = {
    "least": ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "most": ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "rtcr": ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_kernels.py")
    kernels.build()
    return torch.device("cuda")


def _random_arrays(seed: int, P: int, N: int, R: int = 5, T: int = 40, TT: int = 3,
                   S: int = 12, E: int = 3, L: int = 70) -> ClusterArrays:
    """Arrays no encoder would make but every kernel must take: wide taint
    and label vocabularies, several terms per pod, zero capacities, usage
    near int32 max, invalid pods and nodes, odd N."""
    rng = np.random.default_rng(seed)
    big = rng.random((N, R)) < 0.1
    alloc = np.where(big, rng.integers(2**30, 2**31 - 1, (N, R)), rng.integers(0, 5000, (N, R)))
    alloc[rng.random((N, R)) < 0.05] = 0
    used = (alloc * rng.random((N, R)) * 0.5).astype(np.int64)
    req = rng.integers(0, 400, (P, R))
    req[rng.random((P, R)) < 0.2] = 0
    terms = rng.integers(-1, S, (P, TT))
    kind = rng.integers(0, 4, (S, E))
    return ClusterArrays.from_numpy(dict(
        node_valid=rng.random(N) < 0.95, node_alloc=alloc.astype(np.int32),
        node_used=used.astype(np.int32), node_unsched=np.zeros(N, bool),
        node_labels=rng.random((N, L)) < 0.2, node_taint_ns=rng.random((N, T)) < 0.03,
        pod_valid=rng.random(P) < 0.97, pod_req=req.astype(np.int32),
        pod_prio=np.zeros(P, np.int32), pod_tol_ns=rng.random((P, T)) < 0.5,
        pod_nodename=np.where(rng.random(P) < 0.1, rng.integers(-2, N, P), -1).astype(np.int32),
        pod_terms=terms.astype(np.int32), pod_has_sel=rng.random(P) < 0.5,
        sel_mask=rng.random((S, E, L)) < 0.1, sel_kind=kind.astype(np.int32),
    ), "cuda")


def _check_static_feasible(arr):
    sf = kernels.static_feasible(arr)
    assert torch.equal(sf, filters.static_feasible_plain(arr))
    return sf


def _check_fit_scan(arr, sf, cfg):
    ck, uk, n_scored = kernels.fit_scan(sf, arr, cfg)
    cp, up = schedule_scan_plain(arr, cfg, sf=sf)
    assert torch.equal(ck, cp)
    assert torch.equal(uk, up)
    assert int(n_scored.item()) > 0


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_mixed_snapshot(card, strategy):
    name, shape = STRATEGIES[strategy]
    arr, _ = encode_snapshot(mixed(), device=card)
    cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape))
    _check_fit_scan(arr, _check_static_feasible(arr), cfg)


@pytest.mark.parametrize("seed,N,score_resources", [
    (0, 997, (0, 1, 3)), (1, 2048, (0, 1, 3)), (2, 3001, (0, 1, 3)),
    # fit_scan is a template on the number of scored resources (1..8)
    (3, 1024, (2,)), (4, 1024, (4, 0, 1, 3, 2)), (5, 1024, (0, 1, 2, 3, 4, 0, 1, 2)),
])
def test_random_arrays(card, seed, N, score_resources):
    arr = _random_arrays(seed, P=300, N=N)
    sf = _check_static_feasible(arr)
    for name, shape in STRATEGIES.values():
        _check_fit_scan(arr, sf, dataclasses.replace(
            DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape, enable_pairwise=False,
            enable_ports=False, enable_taint_score=False, enable_node_pref=False, enable_image=False,
            score_resources=score_resources, fit_weight=1.3, balanced_weight=0.7))


def test_heterogeneous_counts_launches(card):
    arr, _ = encode_snapshot(heterogeneous(500, 1500), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    kernels.reset_launches()
    from kubernetes_tpu_torch.ops import schedule_batch

    choices, used = schedule_batch(arr, cfg, chunked=False)  # the per-pod route
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), "static_feasible": 1, "fit_scan": 1}
    cp, up = schedule_scan_plain(arr, cfg)
    assert torch.equal(choices, cp) and torch.equal(used, up)


def test_wrappers_refuse_bad_inputs(card):
    arr, _ = encode_snapshot(mixed(), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sf = kernels.static_feasible(arr)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fit_scan(sf.t().contiguous().t(), arr, cfg)
    with pytest.raises(ValueError, match="dtype"):
        kernels.fit_scan(sf.to(torch.uint8), arr, cfg)
    with pytest.raises(ValueError, match="score_resources"):
        kernels.fit_scan(sf, arr, dataclasses.replace(cfg, score_resources=(0, 9)))


def _fit_cfg(strategy, score_resources):
    name, shape = STRATEGIES[strategy]
    return dataclasses.replace(
        DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape, enable_pairwise=False, enable_ports=False,
        enable_taint_score=False, enable_node_pref=False, enable_image=False, score_resources=score_resources,
        fit_weight=1.3, balanced_weight=0.7)


# K1's term match at the label widths around a 32-bit word and at a
# cluster-wide vocabulary; N % 16 != 0 and N % 32 != 0 (997) beside 1024;
# T = 40 > 32 taints (two taint words)
@pytest.mark.parametrize("L", [1, 31, 32, 33, 70, 5000])
@pytest.mark.parametrize("N", [997, 1024])
def test_static_feasible_label_widths(card, L, N):
    arr = _random_arrays(10 + L % 7, P=40, N=N, L=L)
    _check_static_feasible(arr)


def _pins(arr, seed: int, base: int):
    """arr with global nodeName pins around [base, base + N): unset, missing
    (-2), in range, and just outside it on either side."""
    rng = np.random.default_rng(seed)
    P, N = arr.P, arr.N
    pin = np.where(rng.random(P) < 0.5, rng.integers(base - 3, base + N + 3, P), -1)
    pin[rng.random(P) < 0.05] = -2
    pin[:4] = [base, base + N - 1, base - 1, base + N]
    return dataclasses.replace(arr, pod_nodename=torch.from_numpy(pin.astype(np.int32)).to(arr.pod_nodename.device))


@pytest.mark.parametrize("base", [0, 997, 5000])
def test_static_feasible_pins_with_base(card, base):
    """A node shard's launch (base > 0: its first global node id) == the
    plain version with the same base."""
    arr = _pins(_random_arrays(30, P=64, N=997, L=33), 31, base)
    sf = kernels.static_feasible(arr, base=base)
    assert torch.equal(sf, filters.static_feasible_plain(arr, base=base))
    assert sf.any() and not sf.all()


@pytest.mark.parametrize("N", [997, 6144])
def test_static_feasible_gated(card, N):
    """done clear: the plane == plain; done set: nothing written."""
    arr = _random_arrays(40, P=8, N=N, L=5000)
    zero = torch.zeros((1,), dtype=torch.int32, device=card)
    one = torch.ones((1,), dtype=torch.int32, device=card)
    out = torch.zeros((arr.P, arr.N), dtype=torch.bool, device=card)
    kernels.static_feasible(arr, done=zero, out=out)
    assert torch.equal(out, filters.static_feasible_plain(arr))
    before = torch.rand((arr.P, arr.N), generator=torch.Generator().manual_seed(0)).lt(0.5).to(card)
    out.copy_(before)
    kernels.static_feasible(arr, done=one, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, before)


@pytest.mark.parametrize("S,E,L,N", [
    (80, 4, 1000, 997),  # 10240 mask words: past the staged masks, each ballotted as needed
    (3, 2, 60000, 100),  # a row's words too many for 32 rows a block: tiles of fewer rows
    (1, 1, 5000, 6143),  # one sparse term over a wide vocabulary, N odd
])
def test_static_feasible_match_plans(card, S, E, L, N):
    arr = _random_arrays(50 + S, P=24, N=N, S=S, E=E, L=L)
    _check_static_feasible(arr)


def _literal_arrays(seed: int, counts, kinds, N: int = 997, L: int = 5000) -> ClusterArrays:
    """_random_arrays with S x E masks of exactly counts[s][e] set literals
    and the given kinds: K1 lists the literals when every ANY / NONE
    expression has at most 32, else it packs the label rows."""
    arr = _random_arrays(seed, P=48, N=N, S=len(counts), E=len(counts[0]), L=L)
    rng = np.random.default_rng(seed + 1)
    mask = np.zeros((len(counts), len(counts[0]), L), bool)
    for s, row in enumerate(counts):
        for e, c in enumerate(row):
            mask[s, e, rng.choice(L, size=c, replace=False)] = True
    dev = arr.sel_mask.device
    return dataclasses.replace(arr, sel_mask=torch.from_numpy(mask).to(dev),
                               sel_kind=torch.tensor(kinds, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("case", ["listed", "listed-32", "packed-33", "pad-and-false-dense"])
def test_static_feasible_listed_and_packed(card, case):
    """The listed-literal match (every ANY / NONE expression <= 32 literals)
    and the packed one (an ANY with 33) both == plain; a PAD or
    constant-false expression's literals never force the packed match."""
    counts, kinds = {
        "listed": ([[1, 5, 0], [20, 3, 9], [2, 2, 2], [7, 0, 1]], [[1, 2, 0], [1, 1, 2], [2, 1, 1], [1, 0, 3]]),
        "listed-32": ([[32, 32, 1], [32, 1, 32]], [[1, 1, 2], [1, 2, 1]]),
        "packed-33": ([[33, 4, 1], [3, 1, 8]], [[1, 2, 1], [2, 1, 1]]),
        "pad-and-false-dense": ([[4000, 3, 2], [5, 4000, 1]], [[0, 1, 2], [1, 3, 1]]),
    }[case]
    arr = _literal_arrays(60 + len(case), counts, kinds)
    sf = _check_static_feasible(arr)
    assert sf.any() and not sf.all()


def test_static_feasible_at_gang_pinned(card):
    """The pinned gang wave on BASELINE config 3's 5000 nodes (P = 8, N =
    6144, L = 5000, a hostname In over a pool): one wrapper call == plain."""
    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads

    arr, _ = DeltaEncoder().encode_device(workloads.gang_pinned("perpod-fit"))
    assert tuple(arr.node_labels.shape) == (6144, 5000)
    kernels.reset_launches()
    sf = _check_static_feasible(arr)
    assert kernels.LAUNCHES["static_feasible"] == 1 and 0 < int(sf.sum()) < arr.P * 5000


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_fit_scan_every_strategy_and_k(card, strategy, K):
    """One kernel a (strategy, K) pair: each == plain."""
    arr = _random_arrays(10 + K, P=64, N=700, R=8)
    _check_fit_scan(arr, _check_static_feasible(arr), _fit_cfg(strategy, tuple(range(K))))


@pytest.mark.parametrize("P", [1, 8, 512])
@pytest.mark.parametrize("N,cluster", [(997, 16), (997, 7), (4000, 16), (4000, 3), (40, 16), (1300, 1)])
def test_fit_scan_cluster_shapes(card, P, N, cluster):
    """Runs of whole 16-node units over N padded to 16 (997 -> 1008: no
    multiple of kc x 16), every cluster cap, P = 1, 8 and 512."""
    import torch_perpod_cases as pc

    arr = _random_arrays(P + N, P=P, N=N)
    sf = _check_static_feasible(arr)
    cfg = _fit_cfg("least", (0, 1, 3))
    ck, uk, _ = kernels.fit_scan(sf, arr, cfg, cluster=cluster)
    cp, up = schedule_scan_plain(arr, cfg, sf=sf)
    assert torch.equal(ck, cp) and torch.equal(uk, up)
    assert 1 <= kernels.LAST_CLUSTER["fit_scan"] <= pc.fit_width(cluster, -(-N // 16) * 16)


def test_fit_scan_runs_without_feasible_nodes_and_boundary_ties(card):
    """A block's run with no feasible node; equal top scores on the two sides
    of every run boundary (identical nodes: the lower id wins)."""
    import torch_perpod_cases as pc

    P, N = 48, 4096
    arr = _random_arrays(3, P=P, N=N)
    sf = _check_static_feasible(arr)
    cfg = _fit_cfg("most", (0, 1))
    kernels.fit_scan(sf, arr, cfg)
    kc = kernels.LAST_CLUSTER["fit_scan"]
    bounds = [pc.fit_run_lo(q, kc, N) for q in range(kc + 1)]
    dead = sf.clone()
    dead[:, bounds[0]:bounds[1]] = False  # the first block sees no feasible node
    if kc > 2:
        dead[:, bounds[2]:bounds[3]] = False
    ck, uk, _ = kernels.fit_scan(dead, arr, cfg)
    cp, up = schedule_scan_plain(arr, cfg, sf=dead)
    assert torch.equal(ck, cp) and torch.equal(uk, up)
    same = dataclasses.replace(arr, node_alloc=torch.full_like(arr.node_alloc, 4000),
                               node_used=torch.zeros_like(arr.node_used),
                               pod_req=torch.full_like(arr.pod_req, 10), pod_valid=torch.ones_like(arr.pod_valid))
    for b in bounds[1:-1]:
        edge = torch.zeros((P, N), dtype=torch.bool, device=card)
        edge[:, b - 1:b + 1] = True  # the last node of one run and the first of the next
        ck, uk, _ = kernels.fit_scan(edge, same, cfg)
        cp, up = schedule_scan_plain(same, cfg, sf=edge)
        assert torch.equal(ck, cp) and torch.equal(uk, up)
        assert int(ck[0]) == b - 1


@pytest.mark.parametrize("N,cluster", [(1008, 1), (20000, 16)])
def test_fit_scan_wide_r_off_the_shared_memory(card, N, cluster):
    """R = 32 over a run too long for its usage and allocatable to stay in
    shared memory (8 R bytes a node): the global columns."""
    arr = _random_arrays(7, P=40, N=N, R=32)
    sf = _check_static_feasible(arr)
    cfg = _fit_cfg("rtcr", (0, 5, 31))
    ck, uk, n = kernels.fit_scan(sf, arr, cfg, cluster=cluster)
    cp, up = schedule_scan_plain(arr, cfg, sf=sf)
    assert torch.equal(ck, cp) and torch.equal(uk, up) and int(n.item()) > 0


def test_fit_scan_refuses_a_cluster_cap_out_of_range(card):
    arr, _ = encode_snapshot(mixed(), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sf = kernels.static_feasible(arr)
    for cap in (0, kernels.MAX_CLUSTER + 1):
        with pytest.raises(ValueError, match="cluster"):
            kernels.fit_scan(sf, arr, cfg, cluster=cap)


# ---------------------------------------------------------------------------
# the class-wave kernels: class_static_hoist, class_usage_hoist (full and
# column list), wave_commit, chunk_rounds, each against its plain version
# ---------------------------------------------------------------------------

def _classed_arrays(seed: int, P: int, N: int, U1: int):
    """_random_arrays with an equivalence-class index: U1 - 1 classes of
    pods with identical rows, the rest of the rows padding (class U1 - 1,
    invalid), as the encoder lays them out."""
    import types

    from kubernetes_tpu_torch.api.snapshot import POD_FIELDS

    arr = _random_arrays(seed, P=P, N=N)
    rng = np.random.default_rng(seed + 1000)
    n_pods = P - 8
    cls = np.full(P, U1 - 1, dtype=np.int32)
    cls[:n_pods] = np.concatenate([np.arange(U1 - 1), rng.integers(0, U1 - 1, n_pods - (U1 - 1))])
    rng.shuffle(cls[:n_pods])
    first = np.array([int(np.flatnonzero(cls == u)[0]) for u in range(U1)], dtype=np.int64)
    src = torch.from_numpy(first[cls]).to(arr.device)
    fields = {f: getattr(arr, f)[src].contiguous() for f in POD_FIELDS}
    fields["pod_valid"][n_pods:] = False
    arr = dataclasses.replace(arr, **fields)
    meta = types.SimpleNamespace(pod_class=cls, class_first_pod=first, n_nodes=N)
    return arr, meta


def _cfg(strategy):
    name, shape = STRATEGIES[strategy]
    return dataclasses.replace(
        DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape, enable_pairwise=False, enable_ports=False,
        enable_taint_score=False, enable_node_pref=False, enable_image=False, score_resources=(0, 1, 3),
        fit_weight=1.3, balanced_weight=0.7)


def _bitwise(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("U1,N", [(2, 997), (33, 1001), (102, 77)])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_class_hoists(card, U1, N, strategy):
    from kubernetes_tpu_torch.ops import incremental
    from kubernetes_tpu_torch.ops.incremental import HoistCache, class_view

    arr, meta = _classed_arrays(U1 + N, P=256, N=N, U1=U1)
    cfg = _cfg(strategy)
    inc = HoistCache().ensure(arr, meta, cfg)
    r_u = torch.as_tensor(meta.class_first_pod, device=card)
    assert torch.equal(inc.stat_u, incremental._static_hoist_plain(class_view(arr, r_u))[0])
    base, fit = incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg)
    assert _bitwise(inc.base_u, base) and torch.equal(inc.fit_u, fit)
    dirty = torch.randperm(N, generator=torch.Generator().manual_seed(U1))[: N // 3].sort().values.to(card)
    used2 = arr.node_used.clone()
    used2[dirty] = (used2[dirty] * 2 + 7).clamp_max(2**31 - 1)
    cols = torch.full((incremental._round_up_pow2(len(dirty)),), N, dtype=torch.int32, device=card)
    cols[: len(dirty)] = dirty.to(torch.int32)
    bk, fk = kernels.class_usage_hoist(inc.req_u, used2, arr.node_alloc, cfg, cols=cols,
                                       base_u=inc.base_u, fit_u=inc.fit_u)
    bp, fp = incremental._patch_hoist_plain(inc.base_u, inc.fit_u, inc.req_u, used2, arr.node_alloc, cols, cfg)
    assert _bitwise(bk, bp) and torch.equal(fk, fp)
    assert _bitwise(inc.base_u, base)  # the resident buffers were not written


@pytest.mark.parametrize("U1,N", [(u, n) for n in (1, 31, 32, 33, 77, 997, 6144) for u in (1, 2, 102)] + [(2423, 6144)])
def test_class_usage_hoist_edges(card, U1, N):
    """K4's full mode and column mode == the plain hoist and patch bit for
    bit over R in {1, 5, 8, 12, 32} (every register width the kernel is
    built for), every strategy, K in {1, R} (at most 8); the patched
    generation == a full hoist at the new usage; the resident pair is never
    written; one launch a call."""
    from kubernetes_tpu_torch.ops import incremental

    rng = np.random.default_rng(U1 * 1000 + N)
    for R in (1, 5, 8, 12, 32):
        req, used, alloc = hs.usage_inputs(U1 + N + R, U1, N, R, card)
        used2 = used.clone()
        rows = torch.from_numpy(rng.choice(N, max(1, N // 2), replace=False)).to(card)
        used2[rows] = used2[rows] + 17
        lists = {k: torch.from_numpy(v).to(card) for k, v in hs.col_lists(N, rng).items()}
        for strategy in sorted(STRATEGIES):
            for K in sorted({1, min(R, 8)}):
                name, shape = STRATEGIES[strategy]
                cfg = dataclasses.replace(DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape,
                                          score_resources=tuple(range(K)), fit_weight=1.3, balanced_weight=0.7)
                what = f"R={R} {strategy} K={K}"
                kernels.reset_launches()
                base, fit = kernels.class_usage_hoist(req, used, alloc, cfg)
                assert kernels.LAUNCHES["class_usage_hoist"] == 1
                bp, fp = incremental._usage_hoist_plain(req, used, alloc, cfg)
                assert _bitwise(base, bp) and torch.equal(fit, fp), what
                keep = (base.clone(), fit.clone())
                full2 = incremental._usage_hoist_plain(req, used2, alloc, cfg)
                for lname, cols in lists.items():
                    kernels.reset_launches()
                    bk, fk = kernels.class_usage_hoist(req, used2, alloc, cfg, cols=cols, base_u=base, fit_u=fit)
                    assert kernels.LAUNCHES["class_usage_hoist"] == 1
                    want = incremental._patch_hoist_plain(base, fit, req, used2, alloc, cols, cfg)
                    assert _bitwise(bk, want[0]) and torch.equal(fk, want[1]), (what, lname)
                    assert _bitwise(base, keep[0]) and torch.equal(fit, keep[1]), (what, lname, "resident written")
                # every dirty column listed: the new generation is a full hoist at the new usage
                cols = torch.full((max(16, 1 << (rows.numel() - 1).bit_length()),), N, dtype=torch.int32, device=card)
                cols[: rows.numel()] = rows.sort().values.to(torch.int32)
                bk, fk = kernels.class_usage_hoist(req, used2, alloc, cfg, cols=cols, base_u=base, fit_u=fit)
                assert _bitwise(bk, full2[0]) and torch.equal(fk, full2[1]), (what, "== a full hoist")


@pytest.mark.parametrize("U1,N", [(2, 997), (33, 1001), (102, 77)])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_wave_commit_and_chunk_rounds(card, U1, N, strategy):
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = _classed_arrays(3 * U1 + N, P=256, N=N, U1=U1)
    cfg = _cfg(strategy)
    inc = HoistCache().ensure(arr, meta, cfg)
    t0u = assign.t0u_prologue(inc, N)
    for knobs in (dict(wave_k=256, wave_block=48), dict(wave_k=2, wave_block=64)):
        wk = kernels.wave_commit(arr, inc, cfg, **knobs)
        wp = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                      arr.node_alloc, inc.req_u, cfg, **knobs)
        for a, b in zip(wk[:5], wp[:5]):
            assert _bitwise(a, b)
        assert (int(wk[5]), int(wk[6])) == (wp[5], wp[6])
        wave_t = (wp[0], wp[1], wp[2], torch.tensor(wp[5], dtype=torch.int32, device=card))
        ck = kernels.chunk_rounds(arr, inc, cfg, wp[3], wp[4], wave_t)
        cp = assign.schedule_scan_chunked_plain(arr, cfg, inc, wp[3], wp[4], (wp[0], wp[1], wp[2], wp[5]))
        for a, b in zip(ck[:3], cp[:3]):
            assert torch.equal(a, b)
        assert kernels.read_sweeps(ck[3]) == cp[3]
    ck = kernels.chunk_rounds(arr, inc, cfg, arr.node_used, None, None)
    cp = assign.schedule_scan_chunked_plain(arr, cfg, inc, arr.node_used, t0u, None)
    for a, b in zip(ck[:3], cp[:3]):
        assert torch.equal(a, b)
    assert kernels.read_sweeps(ck[3]) == cp[3]
    # the route, both ways, against the per-pod route
    c1, u1 = assign.schedule_batch(arr, cfg)
    for waves in (True, False):
        c2, u2 = assign.schedule_batch(arr, cfg, inc=inc, class_waves=waves)
        assert torch.equal(c1, c2) and torch.equal(u1, u2)


def test_class_wave_route_counts_launches(card):
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = encode_snapshot(heterogeneous(500, 1500), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    kernels.reset_launches()
    inc = HoistCache().ensure(arr, meta, cfg)
    choices, used = assign.schedule_batch(arr, cfg, inc=inc)
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), "class_static_hoist": 1,
                                "class_usage_hoist": 1, "wave_commit": 1, "chunk_rounds": 1}
    cp, up = schedule_scan_plain(arr, cfg)
    assert torch.equal(choices, cp) and torch.equal(used, up)


@pytest.mark.parametrize("case", sb.CASES)
def test_chunk_rounds_on_stage_b_classes(card, case):
    """K6 == the plain stage B (and its walk's emulation) on each chunk
    class: the skip, a partial wave with pad pods in its last chunks, listed
    chunks with whole ones between them, and no wave."""
    from kubernetes_tpu_torch.ops import assign

    arr, cfg, inc, used0, t0u0, wave = sb.build_case(case, device=card)
    kwave = None if wave is None else (*wave[:3], torch.tensor(wave[3], dtype=torch.int32, device=card))
    ck = kernels.chunk_rounds(arr, inc, cfg, used0, None if wave is None else t0u0, kwave)
    cp = assign.schedule_scan_chunked_plain(arr, cfg, inc, used0, t0u0, wave)
    for a, b in zip(ck[:3], cp[:3]):
        assert torch.equal(a, b)
    assert kernels.read_sweeps(ck[3]) == cp[3]
    em = sb.emulate_walk(arr, cfg, inc, used0, t0u0, wave)
    for a, b in zip(ck[:3], em[:3]):
        np.testing.assert_array_equal(a.cpu().numpy(), b)


@pytest.mark.parametrize("case", ["skip", "reopened", "no-wave"])
def test_chunk_rounds_stage_b_at_the_north_star(card, case):
    """K6 == plain at the north star (P = 51200, 1600 chunks): after the
    wave, which commits every pod (the skip); with three chunks taken back
    out of it, far apart (one pod of chunk 500, all of chunks 7 and 1201);
    and with no wave over the first 64 chunks."""
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.ops.incremental import HoistCache, IncState

    arr, meta = encode_snapshot(heterogeneous(**workloads.NORTH_STAR), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    C = assign.INC_CHUNK
    if case == "no-wave":
        n = 64 * C
        pre = arr.pod_prefix(n)
        inc_pre = IncState(cls=inc.cls[:n].contiguous(), req_u=inc.req_u, stat_u=inc.stat_u, base_u=inc.base_u,
                           fit_u=inc.fit_u)
        ck = kernels.chunk_rounds(pre, inc_pre, cfg, arr.node_used, None, None)
        cp = assign.schedule_scan_chunked_plain(pre, cfg, inc_pre, arr.node_used,
                                                assign.t0u_prologue(inc, arr.N), None)
    else:
        wk = kernels.wave_commit(arr, inc, cfg)
        wcom, wout, wordn = wk[0].clone(), wk[1].clone(), wk[2].clone()
        assert bool(wcom.all())
        if case == "reopened":
            idx = torch.cat([torch.arange(7 * C, 8 * C), torch.tensor([500 * C + 5]),
                             torch.arange(1201 * C, 1202 * C)]).to(card)
            wcom[idx], wout[idx], wordn[idx] = False, -1, 0
        ck = kernels.chunk_rounds(arr, inc, cfg, wk[3], wk[4], (wcom, wout, wordn, wk[5]))
        cp = assign.schedule_scan_chunked_plain(arr, cfg, inc, wk[3], wk[4], (wcom, wout, wordn, int(wk[5])))
    for a, b in zip(ck[:3], cp[:3]):
        assert torch.equal(a, b)
    assert kernels.read_sweeps(ck[3]) == cp[3]


def test_chunk_rounds_raises_at_its_round_cap(card):
    """Every round commits a pod, so a chunk never needs more than INC_CHUNK
    rounds.  Class state that breaks this must raise on both entry points,
    never come back as unschedulable pods: a NaN score at the head of a
    class's list is skipped by the pass-1 speculation but taken by the
    pass-2 revalidation, so the chunk's first pod never certifies."""
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = encode_snapshot(heterogeneous(64, 300), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    c = int(inc.cls[0])
    feasible = torch.nonzero(assign.t0u_prologue(inc, arr.N)[c] > float("-inf")).flatten()
    assert len(feasible) >= 2  # one for the NaN, one for pass 1 to pick
    base = inc.base_u.clone()
    base[c, feasible[0]] = float("nan")
    bad = inc._replace(base_u=base)
    for entry in (assign.schedule_batch, assign.schedule_batch_ordinals):
        with pytest.raises(RuntimeError, match="round"):
            entry(arr, cfg, inc=bad, class_waves=False)


# ---------------------------------------------------------------------------
# the dense chunked route and the encoder's packed transfers: K7
# packed_static_rows, K8 chunk_rounds_dense, K9 unpack_planes, each against
# its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,P,N", [(0, 256, 997), (1, 128, 77), (2, 384, 2048), (3, 128, 5)])
def test_packed_static_rows(card, seed, P, N):
    from kubernetes_tpu_torch.ops import assign

    arr = _random_arrays(seed, P=P, N=N)
    assert torch.equal(kernels.packed_static_rows(arr), assign.packed_static_rows_plain(arr))
    arr, _ = encode_snapshot(mixed(), device=card)
    assert torch.equal(kernels.packed_static_rows(arr), assign.packed_static_rows_plain(arr))


def _dense_pair(arr, cfg):
    from kubernetes_tpu_torch.ops import assign

    sfs = kernels.packed_static_rows(arr)
    ck = kernels.chunk_rounds_dense(arr, cfg, sfs)
    cp = assign.schedule_scan_chunked_dense_plain(arr, cfg, sfs)
    for a, b in zip(ck[:3], cp[:3]):
        assert torch.equal(a, b)
    assert kernels.read_sweeps(ck[3]) == cp[3]
    return cp


@pytest.mark.parametrize("seed,P,N", [(4, 256, 997), (5, 128, 77), (6, 256, 3001), (7, 128, 9)])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_chunk_rounds_dense(card, seed, P, N, strategy):
    arr = _random_arrays(seed, P=P, N=N)
    _dense_pair(arr, _cfg(strategy))


def test_chunk_rounds_dense_partly_invalid_chunk(card):
    """A chunk whose pods are half invalid (gated or padding rows) and one
    that is wholly invalid: their lists are empty and they never commit a
    node, and the rounds of the others are unchanged."""
    arr = _random_arrays(8, P=384, N=500)
    valid = arr.pod_valid.clone()
    valid[64:192] = False  # the second half of chunk 0 and the first of chunk 1
    valid[256:] = False  # chunk 2
    arr = dataclasses.replace(arr, pod_valid=valid)
    choices = _dense_pair(arr, _cfg("least"))[0]
    assert (choices[~valid] == -1).all()


def test_dense_route_on_snapshots(card):
    """The card's default route without class state is the dense chunked
    one: K7 and K8 once each, the plain version's choices, usage, ordinals
    and sweeps, and the per-pod route's decisions."""
    from kubernetes_tpu_torch.ops import assign

    for snap in (mixed(), heterogeneous(500, 1500)):
        arr, _ = encode_snapshot(snap, device=card)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        kernels.reset_launches()
        c, u, o, s = assign.schedule_batch_ordinals(arr, cfg)
        assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), "packed_static_rows": 1,
                                    "chunk_rounds_dense": 1}
        cp, up, op, sp = assign.schedule_scan_chunked_dense_plain(arr, cfg)
        assert torch.equal(c, cp) and torch.equal(u, up) and torch.equal(o, op) and s == sp
        c1, u1 = assign.schedule_batch(arr, cfg, chunked=False)
        assert torch.equal(c, c1) and torch.equal(u, u1)


@pytest.mark.parametrize("shape", [(3, 64), (5, 65), (2, 7, 100), (1, 1000), (40, 2048),
                                   (0, 80), (1, 80), (1, 7), (6, 64), (6, 80), (6, 96), (6, 100), (4, 1000),
                                   (3, 2048), (2, 3, 80), (65, 7), (37, 33), (6144, 80), (65536, 1024)])
def test_unpack_planes(card, shape):
    """K9 == the plain unpack == the host bools: n in {7, 33, 64, 65, 80,
    96, 100, 1000, 2048} (16-byte stores where n % 16 == 0, narrower
    ones else), 0 and 1 rows, 3-D shapes, the [wide-planes] field and a
    large plane."""
    from kubernetes_tpu_torch.ops import bitplane

    rng = np.random.default_rng(sum(shape))
    dense = rng.random(shape) < 0.4
    words = torch.from_numpy(bitplane.np_pack_lastaxis(dense).view(np.int32)).to(card)
    got = kernels.unpack_planes(words, shape[-1])
    assert got.shape == shape
    assert torch.equal(got, bitplane.unpack(words, shape[-1]))
    assert torch.equal(got.cpu(), torch.from_numpy(dense))
