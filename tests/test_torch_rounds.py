"""The port's full-stage scans on the CPU against the JAX package's, and
kernels K11 / K12 against their plain versions on the card.

On the CPU (every snapshot of tests/torch_rounds_reference.py: the random
pairwise clusters of tests/test_assign_parity.py and its rounds cases —
same-app spread, one pod per node by anti-affinity, the skew boundary with
capacity exhaustion, every stage on — and two fit-only batches of 32 and
64 pods, which the rounds route serves with every pairwise stage off; all
encoded by the port's encoder):

- ``schedule_scan_plain`` equals the JAX package's ``schedule_scan``
  (choices, final usage) and its decisions the serial oracle's;
- ``schedule_scan_rounds_plain`` equals the JAX package's
  ``schedule_scan_rounds`` in choices, final usage, commit ordinals and the
  sweep count (the JAX side in a fresh process with KTPU_RCHUNK=16 and
  KTPU_REPAIR_ITERS=1 pinned);
- ``schedule_scan_rounds_plain(inc=)`` on the port's HoistCache class
  state equals the JAX package's ``schedule_scan_rounds(inc=)`` (the JAX
  HoistCache, where its inc_applicable admits the state, which the port's
  gate matches) in choices, usage, ordinals and sweeps, and the port's
  dense rounds scan;
- ``dispatch`` routes a pairwise config to the rounds scan where the JAX
  package does (chunked=True on the CPU), to the per-pod scan otherwise,
  and class state on a pairwise config to the rounds scan's class mode.

The ``cuda`` legs import no JAX and skip without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rounds.py

Tolerance: none (f32 state planes compared as bit patterns).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_rounds_reference as ref
from kubernetes_tpu_torch.api.snapshot import decode_choices, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, infer_score_config, kernels
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
NAMES = sorted(ref.SNAPSHOTS)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("rounds") / "ref.npz"
    subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_rounds_reference.py"), str(out)],
        env={**os.environ, **ref.PINNED, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
        cwd=ROOT, check=True, timeout=900,
    )
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


_PORT = {}


def port(name: str):
    """(snapshot, arrays, meta, cfg) of the port's own encoder, once per
    snapshot."""
    if name not in _PORT:
        snap = ref.snapshot(name)
        arr, meta = encode_snapshot(snap, device="cpu")
        _PORT[name] = (snap, arr, meta, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    return _PORT[name]


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("name", NAMES)
def test_per_pod_scan_matches_jax_and_oracle(name, jax_ref):
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
    from kubernetes_tpu.oracle import oracle_schedule

    snap, arr, meta, cfg = port(name)
    assert assign.fit_only(cfg, arr) == (name in ref.FIT_ONLY), cfg
    choices, used = assign.schedule_scan_plain(arr, cfg)
    np.testing.assert_array_equal(choices.numpy(), jax_ref[f"{name}/choices"])
    np.testing.assert_array_equal(used.numpy(), jax_ref[f"{name}/used"])
    placed = decode_choices(choices, meta)
    assert [(n, placed[n]) for n in meta.pod_names] == oracle_schedule(snap, JAX_DEFAULT)


@pytest.mark.parametrize("name", NAMES)
def test_rounds_scan_on_class_state_matches_jax(name, jax_ref):
    """The port's own HoistCache class state through the rounds scan's class
    mode equals the JAX package's schedule_scan_rounds(inc=) on its own
    HoistCache state, and the dense rounds scan; where the JAX gate refuses
    the state (the all-pods-unique waves), the port's refuses it too."""
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    _, arr, meta, cfg = port(name)
    inc = assign.inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
    assert (inc is not None) == bool(jax_ref[f"{name}/inc_applied"])
    if inc is None:
        return
    choices, used, ords, sweeps = assign.schedule_scan_rounds_plain(arr, cfg, inc=inc)
    np.testing.assert_array_equal(choices.numpy(), jax_ref[f"{name}/inc_choices"])
    np.testing.assert_array_equal(used.numpy(), jax_ref[f"{name}/inc_used"])
    np.testing.assert_array_equal(ords.numpy(), jax_ref[f"{name}/inc_ordinals"])
    assert sweeps == int(jax_ref[f"{name}/inc_sweeps"])
    np.testing.assert_array_equal(ords.numpy(), jax_ref[f"{name}/ordinals"])
    np.testing.assert_array_equal(choices.numpy(), jax_ref[f"{name}/rounds_choices"])


@pytest.mark.parametrize("name", NAMES)
def test_rounds_scan_matches_jax(name, jax_ref):
    _, arr, _, cfg = port(name)
    assert assign._rounds_capable(arr, cfg) and not assign._chunkable(arr, cfg)
    choices, used, ords, sweeps = assign.schedule_scan_rounds_plain(arr, cfg)
    np.testing.assert_array_equal(choices.numpy(), jax_ref[f"{name}/rounds_choices"])
    np.testing.assert_array_equal(used.numpy(), jax_ref[f"{name}/rounds_used"])
    np.testing.assert_array_equal(ords.numpy(), jax_ref[f"{name}/ordinals"])
    assert sweeps == int(jax_ref[f"{name}/sweeps"])
    # the two routes decide alike
    np.testing.assert_array_equal(choices.numpy(), jax_ref[f"{name}/choices"])


def test_all_stages_snapshot_turns_every_stage_on():
    _, arr, _, cfg = port("all-stages")
    assert all((cfg.enable_pairwise, cfg.enable_ports, cfg.enable_taint_score, cfg.enable_node_pref,
                cfg.enable_image, cfg.enable_interpod_score)), cfg


def test_rounds_prefix_and_state_match_the_full_run():
    """A prefix of chunks is itself a rounds scan (chip_smoke.py holds K12 to
    the plain version on a prefix), and the state it returns is the per-pod
    scan's after the same pods."""
    _, arr, _, cfg = port("rounds-random-0")
    full = assign.schedule_scan_rounds_plain(arr, cfg)
    k = 4 * assign.RCHUNK
    pre = arr.pod_prefix(k)
    c, u, o, s, st = assign.schedule_scan_rounds_plain(pre, cfg, with_state=True)
    assert torch.equal(c, full[0][:k]) and torch.equal(o, full[2][:k])
    pc, pu, pst = assign.schedule_scan_plain(pre, cfg, with_state=True)
    assert torch.equal(c, pc) and torch.equal(u, pu)
    for key in ("cnt", "anti", "pref", "total", "ports"):
        assert torch.equal(bits(st[key]), bits(pst[key])), key


@pytest.mark.parametrize("chunked,route", [(True, "rounds"), (False, "plain"), (None, "plain")])
def test_dispatch_routes_a_pairwise_config(chunked, route):
    """On the CPU the rounds route runs only with chunked=True (the JAX
    package's KTPU_FORCE_CHUNKED=1); its ordinals are the rounds scan's, the
    per-pod route's the pod indices."""
    _, arr, _, cfg = port("rounds-random-1")
    assign.reset_trace_counts()
    step = assign.finish(assign.dispatch(arr, cfg, device="cpu", chunked=chunked))
    assert assign.TRACE_COUNTS[route] == 1 and sum(assign.TRACE_COUNTS.values()) == 1
    want = assign.schedule_scan_rounds_plain(arr, cfg)
    assert torch.equal(step.choices, want[0])
    if route == "rounds":
        assert torch.equal(step.ordinals, want[2]) and step.sweeps == want[3]
    else:
        assert torch.equal(step.ordinals, torch.arange(arr.P, dtype=torch.int32)) and step.sweeps == arr.P


def test_dispatch_ignores_class_state_on_a_pairwise_config():
    """Class state applies on a pairwise config once it carries the planes
    the config reads (the JAX package's inc_applicable): the rounds route
    takes it (`rounds_inc`), with the dense rounds scan's choices, usage,
    ordinals and sweeps; state hoisted for the fit-only stage set lacks the
    eligibility plane and does not apply, so the dense rounds route runs."""
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = encode_snapshot(tw.spread_affinity(60, 256, seed=2), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assert assign.inc_route_applies(arr, cfg)
    fit_only = HoistCache().ensure(arr, meta, dataclasses.replace(
        cfg, enable_pairwise=False, enable_ports=False, enable_taint_score=False, enable_node_pref=False,
        enable_image=False, enable_interpod_score=False))
    assert fit_only is not None and assign.inc_applicable(arr, cfg, fit_only) is None
    inc = HoistCache().ensure(arr, meta, cfg)
    assert assign.inc_applicable(arr, cfg, inc) is inc and inc.elig_u is not None
    want = assign.schedule_scan_rounds_plain(arr, cfg)
    for state, route in ((inc, "rounds_inc"), (fit_only, "rounds")):
        assign.reset_trace_counts()
        c, u, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", inc=state, chunked=True)
        assert assign.TRACE_COUNTS[route] == 1 and sum(assign.TRACE_COUNTS.values()) == 1
        assert torch.equal(c, want[0]) and torch.equal(u, want[1]) and torch.equal(o, want[2]) and s == want[3]


def test_a_batch_rounds_cannot_chunk_takes_the_per_pod_route():
    """P = 8 (the smallest bucket) is no multiple of the rounds chunk."""
    snap = tw.spread_affinity(6, 5, seed=3)
    arr, _ = encode_snapshot(snap, device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assert arr.P == 8 and not assign._rounds_capable(arr, cfg)
    assign.reset_trace_counts()
    choices, _ = assign.schedule_batch(arr, cfg, device="cpu", chunked=True)
    assert assign.TRACE_COUNTS["plain"] == 1 and assign.TRACE_COUNTS["rounds"] == 0
    assert torch.equal(choices, assign.schedule_scan_plain(arr, cfg)[0])


@pytest.mark.parametrize("rchunk,repair_iters", [(8, 1), (32, 1), (16, 2), (16, 3)])
def test_rounds_knobs_never_move_decisions(rchunk, repair_iters):
    """The chunk size and the repair iterations change the rounds, never
    the decisions (the JAX package's sweep over them)."""
    _, arr, _, cfg = port("all-stages")
    c, u, o, s = assign.schedule_scan_rounds_plain(arr, cfg, rchunk=rchunk, repair_iters=repair_iters)
    pc, pu = assign.schedule_scan_plain(arr, cfg)
    assert torch.equal(c, pc) and torch.equal(u, pu)
    assert int(o.max()) + 1 == s


# ---------------------------------------------------------------------------
# on the card: K11 full_scan and K12 rounds == their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_rounds.py")
    kernels.build(["packed_static_rows", "score_planes", "full_scan", "rounds"])
    return torch.device("cuda")


CARD_SNAPSHOTS = {
    "all-stages": lambda: tw.all_stages(),
    "config3-small": lambda: tw.spread_affinity(300, 1000, seed=1),
    "all-stages-tight": lambda: tw.all_stages(40, 512, seed=7),
    # fit-only batches below the dense chunk: the rounds route with pw = 0
    **{name: (lambda name=name: ref.snapshot(name)) for name in ref.FIT_ONLY},
}


def _state_equal(a, b):
    return all(torch.equal(bits(a[k]), bits(b[k])) for k in ("cnt", "anti", "pref", "total", "ports"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SNAPSHOTS))
def test_full_scan_kernel_matches_plain(card, name):
    arr, _ = encode_snapshot(CARD_SNAPSHOTS[name](), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    planes = assign.score_planes(arr, cfg)
    kc, ku, kst = kernels.full_scan(arr, cfg, sfs, eligs, planes, with_state=True)
    pc, pu, pst = assign.schedule_scan_plain(arr, cfg, sf=bitplane.unpack(sfs, arr.N), planes=planes,
                                             with_state=True)
    assert torch.equal(kc, pc) and torch.equal(ku, pu) and _state_equal(kst, pst)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SNAPSHOTS))
@pytest.mark.parametrize("rchunk,repair_iters", [(16, 1), (8, 2), (32, 1)])
def test_rounds_kernel_matches_plain(card, name, rchunk, repair_iters):
    arr, _ = encode_snapshot(CARD_SNAPSHOTS[name](), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    planes = assign.score_planes(arr, cfg)
    kc, ku, ko, ks, kst = kernels.rounds(arr, cfg, sfs, eligs, planes, rchunk=rchunk, repair_iters=repair_iters,
                                         with_state=True)
    pc, pu, po, ps, pst = assign.schedule_scan_rounds_plain(arr, cfg, sfs, eligs, planes, rchunk=rchunk,
                                                           repair_iters=repair_iters, with_state=True)
    assert torch.equal(kc, pc) and torch.equal(ku, pu) and torch.equal(ko, po)
    assert kernels.read_sweeps(ks) == ps and _state_equal(kst, pst)


def _full_case(arr, cfg, cluster=None, sfs=None):
    if sfs is None:
        sfs, _ = kernels.packed_static_rows(arr, with_elig=True)
    eligs = kernels.packed_static_rows(arr, with_elig=True)[1]
    planes = assign.score_planes(arr, cfg)
    kc, ku, kst = kernels.full_scan(arr, cfg, sfs, eligs, planes, with_state=True, cluster=cluster)
    pc, pu, pst = assign.schedule_scan_plain(arr, cfg, sf=bitplane.unpack(sfs, arr.N), planes=planes,
                                             with_state=True)
    assert torch.equal(kc, pc) and torch.equal(ku, pu) and _state_equal(kst, pst)
    return kc


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 8, 512])
@pytest.mark.parametrize("cluster", [16, 5, 1])
def test_full_scan_cluster_shapes(card, P, cluster):
    """Runs of near-equal node counts (N = 301: no multiple of kc), every
    cluster cap, P = 1, 8 and 512."""
    import torch_perpod_cases as pc

    arr, _ = encode_snapshot(tw.spread_affinity(301, 600, seed=4), device=card)
    arr = arr.pod_prefix(P)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    _full_case(arr, cfg, cluster)
    assert 1 <= kernels.LAST_CLUSTER["full_scan"] <= pc.full_width(cluster, arr.N)


@pytest.mark.cuda
def test_full_scan_runs_without_feasible_nodes_and_boundary_ties(card):
    """A block's run with no feasible node (its static bits cleared); equal
    top scores on the two sides of every run boundary (identical nodes, the
    fit stages alone: the lower id wins)."""
    import torch_perpod_cases as pc

    arr, _ = encode_snapshot(tw.spread_affinity(700, 256, seed=5), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    _full_case(arr, cfg)
    kc, N, P = kernels.LAST_CLUSTER["full_scan"], arr.N, arr.P
    bounds = [pc.full_run_lo(q, kc, N) for q in range(kc + 1)]
    sf = bitplane.unpack(kernels.packed_static_rows(arr), N)
    sf[:, bounds[0]:bounds[1]] = False
    _full_case(arr, cfg, sfs=bitplane.pack(sf))
    fit = dataclasses.replace(cfg, enable_pairwise=False, enable_ports=False, enable_taint_score=False,
                              enable_node_pref=False, enable_image=False, enable_interpod_score=False)
    same = dataclasses.replace(arr, node_alloc=torch.full_like(arr.node_alloc, 10**6),
                               node_used=torch.zeros_like(arr.node_used))
    for b in bounds[1:-1]:
        edge = torch.zeros((P, N), dtype=torch.bool, device=card)
        edge[:, b - 1:b + 1] = True
        kc_ = _full_case(same, fit, sfs=bitplane.pack(edge & arr.pod_valid[:, None]))
        assert int(kc_[0]) == b - 1


@pytest.mark.cuda
def test_routes_launch_their_kernels(card):
    arr, _ = encode_snapshot(tw.spread_affinity(300, 1000, seed=1), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    kernels.reset_launches()
    c, _, _, _ = assign.schedule_batch_ordinals(arr, cfg)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"packed_static_rows": 1, "rounds": 1}
    kernels.reset_launches()
    c2, _ = assign.schedule_batch(arr, cfg, chunked=False)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"packed_static_rows": 1, "full_scan": 1}
    assert torch.equal(c, c2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SNAPSHOTS))
def test_rounds_kernel_class_mode_matches_plain_and_dense(card, name):
    """K12 in class-row mode (the class planes through inc.cls, pod_valid
    folded per pod) == the plain class mode == K12 in dense mode."""
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = encode_snapshot(CARD_SNAPSHOTS[name](), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = assign.inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
    assert inc is not None
    kc, ku, ko, ks, kst = kernels.rounds(arr, cfg, with_state=True, inc=inc)
    pc, pu, po, ps, pst = assign.schedule_scan_rounds_plain(arr, cfg, inc=inc, with_state=True)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    dc, du, do, ds, dst = kernels.rounds(arr, cfg, sfs, eligs, assign.score_planes(arr, cfg), with_state=True)
    assert torch.equal(kc, pc) and torch.equal(ku, pu) and torch.equal(ko, po)
    assert kernels.read_sweeps(ks) == ps == kernels.read_sweeps(ds) and _state_equal(kst, pst)
    assert torch.equal(kc, dc) and torch.equal(ku, du) and torch.equal(ko, do) and _state_equal(kst, dst)


@pytest.mark.cuda
def test_class_state_route_launches_k12_alone(card):
    """With class state the rounds route launches K12 alone (the class planes
    are the HoistCache's: K3, and K10 where a score plane is read)."""
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = encode_snapshot(tw.all_stages(), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    kernels.reset_launches()
    inc = HoistCache().ensure(arr, meta, cfg)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "class_static_hoist": 1, "score_planes": 1, "class_usage_hoist": 1}
    kernels.reset_launches()
    assign.reset_trace_counts()
    c, _, _, _ = assign.schedule_batch_ordinals(arr, cfg, inc=inc)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"rounds": 1}
    assert assign.TRACE_COUNTS["rounds_inc"] == 1
    assert torch.equal(c, assign.schedule_batch(arr, cfg)[0])
