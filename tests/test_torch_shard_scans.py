"""The shard modes of the per-pod scans, K2 fit_scan and K11 full_scan
(csrc/fit_scan.cu ktt_fit_scan_shard, csrc/full_scan.cu
full_scan_kernel<true>): the one-device kernel, one thread-block cluster,
over the shard-major sequence of every shard's nodes, each node read
through its shard's pointers.

On the CPU:

- kernels.scan_runs, the run cut both kernels make (K2: each shard's nl
  nodes padded to whole 16-column units; K11: the S * nl global ids), ==
  a brute-force cut position by position from the kernels' run_lo
  (replayed in tests/torch_perpod_cases.py), for S in {1, 2, 3, 5, 8},
  shard widths from 1 to 5120 and every width the launch takes;
- the shard mode's choice replayed (torch_perpod_cases.shard_cluster_choice:
  the cluster over the axis positions, padding never feasible, the position
  written out as the global id) == the plain argmax over the global ids
  (the highest score, the lowest id), ties across run and shard boundaries
  included: the JAX package's _rmax then _rmin;
- the card legs' grid holds what the new cut creates (a run spanning
  shards, a shard holding several runs, nl no multiple of 16 or 32);
- 8-pod cycles on make_mesh(4) on the CPU (schedule_batch, the per-pod
  route: P = 8 takes no other) == the one-device cycles;
- the cluster cap is checked before anything runs.

The ``cuda`` legs import no JAX and skip without a card: both shard modes
== the plain sharded scans (parallel/sharded.py
sharded_schedule_scan_plain) == the one-device kernels, with the final
pairwise state (K11 with_state=True: count planes, total_t, ports as
bits), for S in {2, 3, 5, 8} on 201 nodes (nl 101, 67, 41, 26) at cluster
caps 1, 2, 8 and 16, and P = 8 batches through dispatch on the mesh:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_shard_scans.py

Tolerance: none (bit-identical).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_perpod_cases as pc
import torch_sharded_reference as ref
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels, schedule_batch
from kubernetes_tpu_torch.parallel import mesh as tm
from kubernetes_tpu_torch.parallel.partition_rules import NODE_AXIS_FIELDS
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

KERNELS = ("fit_scan", "full_scan")
CARD_S = (2, 3, 5, 8)
CARD_CAPS = (1, 2, 8, 16)
CARD_NODES = 201  # nl 101, 67, 41, 26 on CARD_S: none a multiple of 16
GENS = ("basic", "spread_affinity", "all_stages")


# ---------------------------------------------------------------------------
# the run cut
# ---------------------------------------------------------------------------

def _widths(kernel: str, N: int) -> list:
    """The cluster widths the launch tries first, over every cap."""
    w = pc.fit_width if kernel == "fit_scan" else pc.full_width
    return sorted({w(cap, N) for cap in range(1, pc.MAX_KC + 1)})


def _brute_cut(kernel: str, S: int, nl: int, kc: int) -> list:
    """Each position's owner (the block whose run_lo bounds hold it) and
    shard, grouped into runs of (shard, first, end) segments."""
    width = pc.shard_width(kernel, nl)
    N = S * width
    run_lo = pc.fit_run_lo if kernel == "fit_scan" else pc.full_run_lo
    bounds = [run_lo(q, kc, N) for q in range(kc + 1)]
    runs = [[] for _ in range(kc)]
    for g in range(N):
        q = max(i for i in range(kc) if bounds[i] <= g)
        s, j = divmod(g, width)
        seg = runs[q]
        if seg and seg[-1][0] == s and seg[-1][2] == j:
            seg[-1] = (s, seg[-1][1], j + 1)
        else:
            seg.append((s, j, j + 1))
    return runs


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_scan_runs_matches_a_brute_force_cut(kernel, S):
    for nl in (1, 5, 16, 26, 33, 41, 67, 101, 1229):
        width = pc.shard_width(kernel, nl)
        N = S * width
        for kc in _widths(kernel, N):
            runs = kernels.scan_runs(kernel, S, nl, kc)
            assert runs == _brute_cut(kernel, S, nl, kc), (nl, kc)
            sizes = [sum(e - b for _, b, e in r) for r in runs]
            assert sum(sizes) == N and min(sizes) > 0
            step = pc.UNIT if kernel == "fit_scan" else 1  # near-equal runs of whole units
            assert max(sizes) - min(sizes) <= step and all(x % step == 0 for x in sizes)
            for r in runs:  # a run crosses from the end of one shard to the start of the next
                for (s0, _, e0), (s1, b1, _) in zip(r, r[1:]):
                    assert s1 == s0 + 1 and e0 == width and b1 == 0
    # the north star on 4 shards: 16 runs of 1280 columns, four a shard
    assert kernels.scan_runs("fit_scan", 4, 5120, 16)[5] == [(1, 1280, 2560)]


@pytest.mark.parametrize("cap", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("kernel", KERNELS)
def test_shard_replay_matches_plain_argmax(kernel, cap):
    rng = np.random.default_rng(cap + 100 * (kernel == "full_scan"))
    for S in (2, 3, 5, 8):
        for nl in (1, 7, 26, 41):
            n = S * nl
            width = pc.shard_width(kernel, nl)
            N = S * width
            run_lo = pc.fit_run_lo if kernel == "fit_scan" else pc.full_run_lo
            kc = pc.fit_width(cap, N) if kernel == "fit_scan" else pc.full_width(cap, N)
            bounds = [run_lo(q, kc, N) for q in range(kc + 1)]
            for trial in range(3):
                levels = rng.integers(0, 4, n).astype(float)
                levels[rng.random(n) < 0.3] = -np.inf
                total = levels.tolist()
                if trial == 1:  # equal top scores on both sides of every shard boundary
                    for s in range(1, S):
                        total[s * nl - 1] = total[s * nl] = 9.0
                if trial == 2:  # and of every run boundary that falls on a node
                    for b in bounds[1:-1]:
                        s, j = divmod(b, width)
                        if j < nl:
                            total[s * nl + j] = 9.0
                            if s * nl + j > 0:
                                total[s * nl + j - 1] = 9.0
                want = pc.plain_argmax(total)
                for nt in (pc.NT, 3):
                    assert pc.shard_cluster_choice(kernel, total, S, nl, cap, nt) == want, (S, nl, trial, nt)


@pytest.mark.parametrize("kernel", KERNELS)
def test_card_grid_holds_the_new_layouts(kernel):
    """The card legs' shapes and caps make runs that span shards and shards
    that hold several runs, on shard widths no multiple of 16 or 32."""
    spans = several = 0
    for S in CARD_S:
        nl = -(-CARD_NODES // S)
        assert nl % 16 and nl % 32
        N = S * pc.shard_width(kernel, nl)
        for cap in CARD_CAPS:
            kc = pc.fit_width(cap, N) if kernel == "fit_scan" else pc.full_width(cap, N)
            runs = kernels.scan_runs(kernel, S, nl, kc)
            spans += sum(len(r) > 1 for r in runs)
            per_shard = [sum(any(s == t for t, _, _ in r) for r in runs) for s in range(S)]
            several += sum(k > 1 for k in per_shard)
    assert spans > 0 and several > 0


def _cpu_sharded(gen="basic"):
    arr, _ = encode_snapshot(ref.pinned(tw, gen, 25, 64), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    return tm.shard_arrays(arr, tm.make_mesh(2, devices="cpu")), cfg


@pytest.mark.parametrize("cluster", [0, 17])
@pytest.mark.parametrize("wrapper", ["fit_scan_shard", "full_scan_shard"])
def test_cluster_cap_is_checked(wrapper, cluster):
    sa, cfg = _cpu_sharded()
    with pytest.raises(ValueError, match="cluster of 1..16"):
        if wrapper == "fit_scan_shard":
            kernels.fit_scan_shard(None, sa, cfg, cluster=cluster)
        else:
            kernels.full_scan_shard(sa, cfg, None, None, None, cluster=cluster)


def _small(gen: str, k: int, device):
    """workloads.<gen>(n, k pods) (the encoder buckets P to 8), nodes 30."""
    snap = getattr(tw, gen)(30, k, seed=k)
    arr, _ = encode_snapshot(snap, device=device)
    return arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("gen", GENS)
def test_small_cycles_on_a_cpu_mesh_match_one_device(gen, k):
    arr, cfg = _small(gen, k, "cpu")
    assert arr.P == 8
    one = schedule_batch(arr, cfg, device="cpu")
    assign.reset_trace_counts()
    got = schedule_batch(arr, cfg, device="cpu", mesh=tm.make_mesh(4, devices="cpu"))
    assert assign.TRACE_COUNTS["sharded_plain"] == 1
    assert torch.equal(got[0], one[0]) and torch.equal(got[1][:arr.N], one[1]) and not got[1][arr.N:].any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_shard_scans.py")
    kernels.build(["static_feasible", "fit_scan", "full_scan", "packed_static_rows", "score_planes"])
    return torch.device("cuda")


def _node_prefix(arr, n: int):
    """The arrays cut to their first n nodes (the encoder's bucket padding
    is invalid nodes): a node count no power of two."""
    cut = {name: getattr(arr, name).narrow(axis, 0, n).contiguous() for name, (axis, _) in NODE_AXIS_FIELDS.items()}
    if arr.image_score.shape[1] == arr.N:
        cut["image_score"] = arr.image_score[:, :n].contiguous()
    return dataclasses.replace(arr, **cut)


def _card_arrays(gen: str, dev):
    arr, _ = encode_snapshot(ref.pinned(tw, gen, CARD_NODES, 64), device=dev)
    arr = _node_prefix(arr, CARD_NODES)
    return arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_state(a: dict, b: dict, n: int = None) -> bool:
    """Every state plane as bits; with n, a's node axis cut to b's n nodes."""
    for k in b:
        x = a[k]
        if n is not None and k in ("cnt", "anti", "pref"):
            x = x[:, :n]
        elif n is not None and k == "ports":
            x = x[:n]
        if not torch.equal(_bits(x.contiguous()), _bits(b[k].contiguous())):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CARD_CAPS)
@pytest.mark.parametrize("s", CARD_S)
@pytest.mark.parametrize("gen", GENS)
def test_shard_scans_match_plain_and_one_device(card, gen, s, cluster):
    from kubernetes_tpu_torch.parallel import sharded

    arr, cfg = _card_arrays(gen, card)
    N = arr.N
    sa = tm.shard_arrays(arr, tm.make_mesh(s))
    bases = [sa.mesh.base(j, sa.N) for j in range(s)]
    if assign.fit_only(cfg, arr):
        sfs = [kernels.static_feasible(sh, base=b) for sh, b in zip(sa.shards, bases)]
        kernels.reset_launches()
        ck, uk = kernels.fit_scan_shard(sfs, sa, cfg, cluster=cluster)
        assert kernels.LAUNCHES["fit_scan_shard"] == 1
        kc = kernels.LAST_CLUSTER["fit_scan_shard"]
        assert 1 <= kc <= pc.fit_width(cluster, s * pc.shard_width("fit_scan", sa.nl))
        cp, up = sharded.sharded_schedule_scan_plain(sa, cfg, sfs=sfs, planes=[(None, None)] * s)
        assert torch.equal(ck, cp) and torch.equal(uk, up)
        co, uo, _ = kernels.fit_scan(kernels.static_feasible(arr), arr, cfg, cluster=cluster)
        assert torch.equal(ck, co) and torch.equal(uk[:N], uo) and not uk[N:].any()
        return
    packed = [assign.packed_static_rows(sh, with_elig=True, base=b) for sh, b in zip(sa.shards, bases)]
    sfs, eligs = [p[0] for p in packed], [p[1] for p in packed]
    planes = [assign.score_planes(sh, cfg) for sh in sa.shards]
    kernels.reset_launches()
    ck, uk, sk = kernels.full_scan_shard(sa, cfg, sfs, eligs, planes, with_state=True, cluster=cluster)
    assert kernels.LAUNCHES["full_scan_shard"] == 1
    assert 1 <= kernels.LAST_CLUSTER["full_scan_shard"] <= pc.full_width(cluster, sa.N)
    from kubernetes_tpu_torch.ops import bitplane

    cp, up, sp = sharded.sharded_schedule_scan_plain(sa, cfg, sfs=[bitplane.unpack(x, sa.nl) for x in sfs],
                                                     planes=planes, with_state=True)
    assert torch.equal(ck, cp) and torch.equal(uk, up) and _same_state(sk, sp)
    s1, e1 = assign.packed_static_rows(arr, with_elig=True)
    co, uo, so = kernels.full_scan(arr, cfg, s1, e1, assign.score_planes(arr, cfg), with_state=True, cluster=cluster)
    assert torch.equal(ck, co) and torch.equal(uk[:N], uo) and not uk[N:].any()
    assert _same_state(sk, so, N)


@pytest.mark.cuda
@pytest.mark.parametrize("s", CARD_S)
@pytest.mark.parametrize("gen", GENS)
def test_small_batches_on_the_mesh(card, gen, s):
    """8-pod cycles through dispatch on the mesh: K1 x S + K2 in shard mode,
    or K7 x S (+ K10 x S) + K11 in shard mode == one device == the CPU."""
    arr, cfg = _small(gen, 6, card)
    m = tm.make_mesh(s)
    kernels.reset_launches()
    got = assign.finish(assign.dispatch(arr, cfg, mesh=m))
    key = "fit_scan_shard" if assign.fit_only(cfg, arr) else "full_scan_shard"
    assert kernels.LAUNCHES[key] == 1 and kernels.LAUNCHES["fit_scan"] == kernels.LAUNCHES["full_scan"] == 0
    one = assign.finish(assign.dispatch(arr, cfg))
    assert torch.equal(got.choices, one.choices) and torch.equal(got.used[:arr.N], one.used)
    cpu, ccfg = _small(gen, 6, "cpu")
    want = schedule_batch(cpu, ccfg, device="cpu")
    assert torch.equal(got.choices.cpu(), want[0]) and torch.equal(got.used[:arr.N].cpu(), want[1])
