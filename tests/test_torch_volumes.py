"""Volumes and resource claims in the port (api/volumes.py, api/cluster.py
and the storage conditioning of api/delta.py) against the JAX package's.

Every case is built once with the JAX package's types and carried field
for field into the port's (``to_port``), so both packages see the same
inputs:

- resolution: ``resolve_snapshot`` gives the same pods and nodes, field for
  field and in order (requests, allocatable, required node terms), on
  heterogeneous_storage(500, 500) (SMOKE Config4S, each package's own
  generator), on every scheduler-free case of tests/test_volumes.py and
  tests/test_volumes_images.py, and on the port's dra_small snapshot;
- encoding: ``DeltaEncoder("cpu").encode`` equals the JAX encoder in every
  ClusterArrays field on the same snapshots;
- storage churn (after tests/test_delta_encoder.py
  test_delta_survives_volume_state): the encoder's stats equal the JAX
  encoder's at every step, both with debug_verify; stable storage stays on
  the delta path, a replaced PVC rebuilds once; bound claim pods re-absorb
  on the slow path;
- decisions: the port's per-pod, dense chunked and class-wave routes on
  heterogeneous_storage(500, 500) equal the JAX routes (choices, ordinals,
  sweeps; the JAX side in a fresh process with KTPU_FORCE_CHUNKED=1,
  ``tests/torch_north_star_digest.py --leg config4s 500 500``) and
  ``oracle_schedule``; dra_small's choices hash to the JAX digest kept in
  bench/workloads.py; Config4S's warm waves (StorageWaves: one PVC
  replaced at wave 5) through PipelinedBatchLoop at depth 1 and 0 equal the
  JAX loop's verdicts, HoistCache actions and encoder stats
  (``--leg config4s-warm 500 500``);
- the card legs (``encode_device`` of a storage snapshot, the routes on
  the card against the plain routes) are in tests/test_torch_volumes_card.py,
  which imports no JAX.

Tolerance: none.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import GI, mk_node, mk_pod
from kubernetes_tpu.api import cluster as jc
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.delta import DeltaEncoder as JaxDeltaEncoder
from kubernetes_tpu.api.snapshot import Snapshot as JaxSnapshot
from kubernetes_tpu.api.volumes import resolve_snapshot as jax_resolve
from kubernetes_tpu.bench import workloads as jw
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import Snapshot, decode_choices
from kubernetes_tpu_torch.api.volumes import resolve_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop
from test_torch_delta import assert_same_encoding
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent


def to_port(obj):
    """A JAX-typed object (Node, Pod, PV, PVC, StorageClass, ResourceSlice,
    DeviceClass, Snapshot, or a container of them) as the port's types: the
    same field values."""
    from kubernetes_tpu_torch.api import cluster as tc
    from kubernetes_tpu_torch.api import snapshot as tsnap
    from kubernetes_tpu_torch.api import types as tt

    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(x) for k, x in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = getattr(tt, name, None) or getattr(tc, name, None) or getattr(tsnap, name)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.name in names})
    return obj


class _Carry:
    """to_port with each object converted once (identity across cycles is
    kept on both sides: the encoders' delta paths key on it)."""

    def __init__(self):
        self.memo = {}

    def __call__(self, obj):
        if isinstance(obj, list):
            return [self(x) for x in obj]
        ent = self.memo.get(id(obj))
        if ent is None or ent[0] is not obj:
            ent = self.memo[id(obj)] = (obj, to_port(obj))
        return ent[1]


def plain(obj):
    """A type-free, order-keeping form of an object tree: a dataclass as its
    (field, value) pairs, a dict as its items in order."""
    if isinstance(obj, (list, tuple)):
        return tuple(plain(x) for x in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, plain(v)) for k, v in obj.items())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple((f.name, plain(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    return obj


# ---------------------------------------------------------------------------
# the cases (JAX types), after tests/test_volumes.py and
# tests/test_volumes_images.py
# ---------------------------------------------------------------------------

def _sc(name, provisioner="csi.example.com", mode="WaitForFirstConsumer", topo=()):
    return jc.StorageClass(name=name, provisioner=provisioner, volume_binding_mode=mode, allowed_topology=tuple(topo))


def _zoned(*zones):
    return [mk_node(f"n-{z}", labels={jt.LABEL_ZONE: z}) for z in zones]


def _claimer(name="p", claims=("data",), **kw):
    return mk_pod(name, pvcs=claims, **kw)


def _rwop():
    return jt.PersistentVolumeClaim(name="rwop", request=1, read_write_once_pod=True, wait_for_first_consumer=True)


def _case_rwop_pending():
    """ReadWriteOncePod: pending users serialize in arrival order."""
    pvc = _rwop()
    return JaxSnapshot(nodes=_zoned("a", "b"), pending_pods=[_claimer("a", ("rwop",)), _claimer("b", ("rwop",))],
                       pvcs={pvc.key: pvc})


def _case_rwop_holder(phase=""):
    """A live bound holder blocks every pending user; a finished one
    (Succeeded) releases the claim."""
    pvc = _rwop()
    holder = dataclasses.replace(_claimer("holder", ("rwop",)), node_name="n-a", uid="", phase=phase)
    return JaxSnapshot(nodes=_zoned("a", "b"), pending_pods=[_claimer("b", ("rwop",))], bound_pods=[holder],
                       pvcs={pvc.key: pvc})


def _case_shared_claim():
    plain_pvc = jt.PersistentVolumeClaim(name="shared", request=1, wait_for_first_consumer=True)
    return JaxSnapshot(nodes=_zoned("a", "b"), pending_pods=[_claimer("c", ("shared",)), _claimer("d", ("shared",))],
                       pvcs={plain_pvc.key: plain_pvc})


def _case_or_within_key():
    """Repeated keys in allowed_topology OR their values (one expression)."""
    sc = _sc("wffc", topo=((jt.LABEL_ZONE, "zone-0"), (jt.LABEL_ZONE, "zone-1")))
    nodes = [jt.Node(name=f"n{z}", allocatable={jt.CPU: 4000, jt.PODS: 10}, labels={jt.LABEL_ZONE: f"zone-{z}"})
             for z in range(3)]
    pvc = jt.PersistentVolumeClaim(name="c", request=1 << 30, storage_class="wffc", wait_for_first_consumer=True)
    return JaxSnapshot(nodes=nodes, pending_pods=[jt.Pod(name="p", requests={jt.CPU: 100}, pvcs=("c",))],
                       pvcs={"default/c": pvc}, storage_classes={"wffc": sc})


def _case_wffc_multi_zone():
    """A WFFC class provisioning in zones a or b, with an Immediate class
    pinned to c beside it: the claimer may land in a or b only."""
    wffc = _sc("wffc", topo=((jt.LABEL_ZONE, "a"), (jt.LABEL_ZONE, "b")))
    other = _sc("other", mode="Immediate", topo=((jt.LABEL_ZONE, "c"),))
    pvc = jt.PersistentVolumeClaim(name="data", request=GI, storage_class="wffc", wait_for_first_consumer=True)
    pvc2 = jt.PersistentVolumeClaim(name="logs", request=GI, storage_class="other")
    return JaxSnapshot(nodes=_zoned("a", "b", "c"), pending_pods=[_claimer("p"), _claimer("q", ("logs",))],
                       pvcs={pvc.key: pvc, pvc2.key: pvc2}, storage_classes={"wffc": wffc, "other": other})


def _case_bound_pvc_zone():
    pv = jt.PersistentVolume(name="pv-a", capacity=100 * GI, storage_class="std",
                             allowed_topology=((jt.LABEL_ZONE, "a"),), claim_ref="default/data")
    pvc = jt.PersistentVolumeClaim(name="data", request=50 * GI, storage_class="std", volume_name="pv-a")
    return JaxSnapshot(nodes=_zoned("b", "a"), pending_pods=[_claimer()], pvs=[pv], pvcs={pvc.key: pvc})


def _case_pv_absent():
    """A claim bound to a PV the snapshot does not hold: unsatisfiable."""
    pvc = jt.PersistentVolumeClaim(name="data", request=50 * GI, storage_class="std", volume_name="pv-gone")
    return JaxSnapshot(nodes=_zoned("a"), pending_pods=[_claimer()], pvcs={pvc.key: pvc})


def _case_immediate_no_pv():
    pvc = jt.PersistentVolumeClaim(name="data", request=50 * GI, storage_class="fast")
    return JaxSnapshot(nodes=[mk_node("n")], pending_pods=[_claimer()], pvcs={pvc.key: pvc})


def _case_unknown_class_wffc():
    """Delayed binding through a class the snapshot does not know: no
    constraint at filter time."""
    pvc = jt.PersistentVolumeClaim(name="data", request=50 * GI, storage_class="fast", wait_for_first_consumer=True)
    return JaxSnapshot(nodes=[mk_node("n")], pending_pods=[_claimer()], pvcs={pvc.key: pvc})


def _case_attach_limit():
    nodes = [mk_node("small"), mk_node("big"), mk_node("none")]
    nodes[0].volume_attach_limit = 1
    nodes[1].volume_attach_limit = 8
    pvcs, pods = {}, []
    for i in range(3):
        pvc = jt.PersistentVolumeClaim(name=f"d{i}", request=GI, storage_class="std", wait_for_first_consumer=True)
        pvcs[pvc.key] = pvc
        pods.append(_claimer(f"p{i}", (f"d{i}",)))
    return JaxSnapshot(nodes=nodes, pending_pods=pods, pvcs=pvcs)


def _case_hand_set_claims():
    nodes = [mk_node("accel"), mk_node("plain")]
    nodes[0].allocatable["claim/tpu-v5e"] = 2
    pods = [mk_pod(f"p{i}", resource_claims=(jt.ResourceClaimRef(device_class="tpu-v5e"),)) for i in range(3)]
    return JaxSnapshot(nodes=nodes, pending_pods=pods)


def _case_missing_pvc():
    return JaxSnapshot(nodes=[mk_node("n")], pending_pods=[_claimer(claims=("ghost",))])


def _case_wffc_provisioner_topology():
    sc = _sc("zonal", topo=((jt.LABEL_ZONE, "a"),))
    pvc = jt.PersistentVolumeClaim(name="data", request=10 * GI, storage_class="zonal", wait_for_first_consumer=True)
    return JaxSnapshot(nodes=_zoned("b", "a"), pending_pods=[_claimer()], pvcs={pvc.key: pvc},
                       storage_classes={"zonal": sc})


def _case_immediate_provisionable():
    sc = _sc("fast", mode="Immediate")
    pvc = jt.PersistentVolumeClaim(name="scratch", request=GI, storage_class="fast")
    return JaxSnapshot(nodes=[mk_node("a"), mk_node("b")], pending_pods=[_claimer(claims=("scratch",))],
                       pvcs={pvc.key: pvc}, storage_classes={"fast": sc})


def _case_class_without_provisioner():
    sc = _sc("static-only", provisioner="")
    pvc = jt.PersistentVolumeClaim(name="data", request=GI, storage_class="static-only", wait_for_first_consumer=True)
    return JaxSnapshot(nodes=[mk_node("a")], pending_pods=[_claimer()], pvcs={pvc.key: pvc},
                       storage_classes={"static-only": sc})


def _case_static_or_provisioner():
    sc = _sc("mixed", topo=((jt.LABEL_ZONE, "a"),))
    pv = jt.PersistentVolume(name="pv-b", capacity=100 * GI, storage_class="mixed",
                             allowed_topology=((jt.LABEL_ZONE, "b"),))
    pvc = jt.PersistentVolumeClaim(name="data", request=GI, storage_class="mixed", wait_for_first_consumer=True)
    return JaxSnapshot(nodes=_zoned("c", "b", "a"), pending_pods=[_claimer()], pvs=[pv], pvcs={pvc.key: pvc},
                       storage_classes={"mixed": sc})


def _tpu_slices_and_class():
    dc = jc.DeviceClass(name="tpu", selector=jc.DeviceSelector(terms=(("type", "v5e"),)))
    devs = tuple(jc.DraDevice(f"d{k}", attributes=(("type", "v5e"),)) for k in range(3))
    slices = [jc.ResourceSlice(name="n0-tpus", node_name="n0", driver="tpu.dev",
                               devices=devs + (jc.DraDevice("x0", attributes=(("type", "cpu"),)),))]
    return slices, {"tpu": dc}


def _case_slices(counts):
    slices, classes = _tpu_slices_and_class()
    pods = [mk_pod(f"p{i}", resource_claims=(jt.ResourceClaimRef("tpu", k),)) for i, k in enumerate(counts)]
    return JaxSnapshot(nodes=[mk_node("n1"), mk_node("n0")], pending_pods=pods, resource_slices=slices,
                       device_classes=classes)


def _case_multi_class_exclusive():
    both = jc.DraDevice("d0", attributes=(("type", "v5e"), ("fast", "yes")))
    slices = [jc.ResourceSlice(name="s", node_name="n0", driver="d", devices=(both,))]
    classes = {"tpu": jc.DeviceClass(name="tpu", selector=jc.DeviceSelector(terms=(("type", "v5e"),))),
               "accel": jc.DeviceClass(name="accel", selector=jc.DeviceSelector(terms=(("fast", "yes"),)))}
    pods = [mk_pod("p", resource_claims=(jt.ResourceClaimRef("tpu"),)),
            mk_pod("q", resource_claims=(jt.ResourceClaimRef("accel"),))]
    return JaxSnapshot(nodes=[mk_node("n0")], pending_pods=pods, resource_slices=slices, device_classes=classes)


def _case_bound_claims():
    """Bound pods with claims resolve too (attach usage, their topology),
    beside pending ones."""
    snap = _case_static_or_provisioner()
    snap.bound_pods = [dataclasses.replace(_claimer("b0"), node_name="n-a", uid=""),
                       dataclasses.replace(mk_pod("b1", resource_claims=(jt.ResourceClaimRef("tpu"),)),
                                           node_name="n-b", uid="")]
    snap.nodes[1].volume_attach_limit = 2
    return snap


CASES = {
    "rwop-pending": _case_rwop_pending,
    "rwop-live-holder": _case_rwop_holder,
    "rwop-finished-holder": lambda: _case_rwop_holder(jt.PHASE_SUCCEEDED),
    "shared-claim": _case_shared_claim,
    "or-within-key": _case_or_within_key,
    "wffc-multi-zone": _case_wffc_multi_zone,
    "bound-pvc-zone": _case_bound_pvc_zone,
    "pv-absent": _case_pv_absent,
    "immediate-no-pv": _case_immediate_no_pv,
    "unknown-class-wffc": _case_unknown_class_wffc,
    "attach-limit": _case_attach_limit,
    "hand-set-claims": _case_hand_set_claims,
    "missing-pvc": _case_missing_pvc,
    "wffc-provisioner-topology": _case_wffc_provisioner_topology,
    "immediate-provisionable": _case_immediate_provisionable,
    "class-without-provisioner": _case_class_without_provisioner,
    "static-or-provisioner": _case_static_or_provisioner,
    "slices-counts": lambda: _case_slices((2,)),
    "slices-deplete": lambda: _case_slices((2, 2)),
    "slices-oversized": lambda: _case_slices((5,)),
    "multi-class-exclusive": _case_multi_class_exclusive,
    "bound-claims": _case_bound_claims,
}
BUILT = {  # each package's own generator (or the port's dra_small, read by both)
    "config4s-smoke": (lambda: jw.heterogeneous_storage(500, 500), lambda: tw.heterogeneous_storage(500, 500)),
    "dra-small": (tw.dra_small, tw.dra_small),
}


def _pair(case):
    """(JAX snapshot, the port's) of a case."""
    if case in BUILT:
        return tuple(f() for f in BUILT[case])
    snap = CASES[case]()
    return snap, to_port(snap)


ALL = sorted(CASES) + sorted(BUILT)


@pytest.mark.parametrize("case", ALL)
def test_resolution_matches_jax(case):
    jsnap, tsnap = _pair(case)
    want, got = jax_resolve(jsnap), resolve_snapshot(tsnap)
    for field in ("nodes", "pending_pods", "bound_pods"):
        a, b = getattr(got, field), getattr(want, field)
        assert len(a) == len(b), field
        for x, y in zip(a, b):
            assert plain(x) == plain(to_port(y)), (field, x.name)  # the port's fields of each
            if field == "nodes":
                assert list(x.allocatable) == list(y.allocatable), x.name
            else:
                assert list(x.requests) == list(y.requests), x.name
    if got is tsnap:  # nothing to resolve: both hand the snapshot back
        assert want is jsnap


@pytest.mark.parametrize("case", ALL)
def test_encoding_matches_jax(case):
    jsnap, tsnap = _pair(case)
    assert_same_encoding(*DeltaEncoder("cpu").encode(tsnap), *JaxDeltaEncoder().encode(jsnap))


def test_resolution_leaves_the_snapshot_alone():
    """resolve_snapshot returns new objects: the input keeps its nodes,
    pods and their fields (the encoder's identity checks rest on it)."""
    snap = to_port(_case_bound_claims())
    nodes, alloc = list(snap.nodes), [dict(nd.allocatable) for nd in snap.nodes]
    pods = [(p, dict(p.requests), p.affinity) for p in snap.pending_pods + snap.bound_pods]
    out = resolve_snapshot(snap)
    assert out is not snap and all(a is not b for a, b in zip(out.nodes, nodes))
    assert snap.nodes == nodes and [dict(nd.allocatable) for nd in snap.nodes] == alloc
    assert [(p, dict(p.requests), p.affinity) for p in snap.pending_pods + snap.bound_pods] == pods


# ---------------------------------------------------------------------------
# storage churn (tests/test_delta_encoder.py test_delta_survives_volume_state)
# ---------------------------------------------------------------------------

def _template(name, kind):
    if kind == 0:
        return mk_pod(name, cpu=250, mem=256 * 1024**2, labels={"app": "web"})
    if kind == 1:
        return mk_pod(name, cpu=500, labels={"app": "db"}, node_selector={jt.LABEL_ZONE: "z1"})
    if kind == 2:
        return mk_pod(name, cpu=100, priority=50)
    return mk_pod(name, cpu=50, mem=64 * 1024**2, priority=100)


def test_delta_survives_volume_state():
    """A cluster with PV / PVC / DRA state keeps the delta path while the
    storage state is stable, rebuilds exactly when it changes, and encodes
    as the JAX encoder at every step (both with debug_verify: every delta
    cycle is checked against a fresh rebuild).  Bound pods with claims
    re-absorb on the slow path: no wave rep with claims enters the
    bind-absorb's rep table."""
    nodes = [mk_node(f"n{i}", labels={jt.LABEL_ZONE: f"z{i % 3}"}) for i in range(12)]
    nodes[5].volume_attach_limit = 4
    pv = jt.PersistentVolume(name="pv0", capacity=10 * GI, storage_class="std",
                             allowed_topology=((jt.LABEL_ZONE, "z1"),))
    pvc = jt.PersistentVolumeClaim(name="claim0", request=5 * GI, storage_class="std", volume_name="pv0")
    slices, classes = _tpu_slices_and_class()
    slices = [dataclasses.replace(slices[0], node_name="n3")]
    port, jax_enc = DeltaEncoder("cpu", debug_verify=True), JaxDeltaEncoder(debug_verify=True)
    carry = _Carry()
    bound, serial = [], 0

    def both(pending, pvcs):
        jsnap = JaxSnapshot(nodes=nodes, pending_pods=pending, bound_pods=list(bound), pvs=[pv], pvcs=pvcs,
                            resource_slices=slices, device_classes=classes)
        tsnap = Snapshot(nodes=carry(nodes), pending_pods=carry(pending), bound_pods=carry(list(bound)),
                         pvs=carry([pv]), pvcs={k: carry(v) for k, v in pvcs.items()}, resource_slices=carry(slices),
                         device_classes={k: carry(v) for k, v in classes.items()})
        assert_same_encoding(*port.encode(tsnap), *jax_enc.encode(jsnap))
        assert port.stats == jax_enc.stats, (port.stats, jax_enc.stats)

    for cycle in range(5):
        pending = [_template(f"p{serial + i}", i % 4) for i in range(6)]
        # one pod per wave uses the claim, one a device
        pending.append(dataclasses.replace(mk_pod(f"vol{cycle}", cpu=100), pvcs=("claim0",)))
        pending.append(dataclasses.replace(mk_pod(f"dev{cycle}", cpu=100),
                                           resource_claims=(jt.ResourceClaimRef("tpu"),)))
        serial += 6
        both(pending, {pvc.key: pvc})
        for i, pod in enumerate(pending[:4] + pending[6:]):
            bound.append(dataclasses.replace(pod, node_name=f"n{(cycle + i) % 12}"))
    assert port.stats["delta"] >= 3 and port.stats["full"] == 1, port.stats
    cs = port._cs
    assert not any(rep.pvcs or rep.resource_claims for rep, _ in cs.rep_bound_info.values())
    assert any(rec[-1].pvcs for rec in cs.records.values())  # claim pods were absorbed
    # a PVC state change (a new object) rebuilds once, then deltas again
    pvc2 = dataclasses.replace(pvc, volume_name="")
    for k in range(2):
        both([_template(f"q{k}", 0)], {pvc2.key: pvc2})
    assert port.stats["full"] == 2


# ---------------------------------------------------------------------------
# decisions on the routes
# ---------------------------------------------------------------------------

SMOKE = (500, 500)  # heterogeneous_storage(n_nodes, n_pods): SMOKE Config4S


@pytest.fixture(scope="module")
def jax_legs():
    """The JAX legs on SMOKE Config4S (config4s: the dense and class-wave
    routes; config4s-warm: the warm waves), each in a fresh process with
    KTPU_FORCE_CHUNKED=1, started together -> name -> its stdout."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "KTPU_FORCE_CHUNKED": "1", "KTPU_MEMWATCH": "0"}
    env.pop("KTPU_CLASS_WAVES", None)
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_north_star_digest.py"), "--leg",
                                     name, *map(str, SMOKE)], env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name in ("config4s", "config4s-warm")}
    out = {}

    def collect(name):
        if name not in out:
            stdout, stderr = procs[name].communicate(timeout=600)
            assert procs[name].returncode == 0, stderr[-4000:]
            out[name] = stdout
        return out[name]

    yield collect
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_routes(jax_legs):
    """The JAX dense and class-wave routes on SMOKE Config4S ->
    {"dense": {...}, "waves": {...}} of scheduled, sweeps and digests."""
    out = {}
    for ln in jax_legs("config4s").splitlines():
        for route in ("dense", "waves"):
            if ln.startswith(f"config4s {route}: "):
                w = ln.split()
                out[route] = dict(scheduled=int(w[w.index("scheduled") + 1]), sweeps=int(w[w.index("sweeps") + 1]),
                                  ordinals=w[w.index("ordinals") + 2], choices=w[w.index("choices") + 2])
    assert set(out) == {"dense", "waves"}, out
    return out


@pytest.fixture(scope="module")
def oracle(jax_legs):
    """oracle_schedule of SMOKE Config4S (while the JAX legs run)."""
    from kubernetes_tpu.oracle import oracle_schedule

    return oracle_schedule(jw.heterogeneous_storage(*SMOKE))


def _sha(x) -> str:
    return hashlib.sha256(np.asarray(x).astype("<i4").tobytes()).hexdigest()


@pytest.fixture(scope="module")
def smoke():
    snap = tw.heterogeneous_storage(*SMOKE)
    arr, meta = DeltaEncoder("cpu").encode_device(snap)
    return snap, arr, meta, infer_score_config(arr, DEFAULT_SCORE_CONFIG)


@pytest.mark.parametrize("route", ["perpod", "dense", "waves"])
def test_routes_match_jax_and_the_oracle(jax_routes, oracle, smoke, route):
    snap, arr, meta, cfg = smoke
    assert (arr.R, meta.resources[-1]) == (6, "attachable-volumes-csi")
    n = meta.n_pods
    assign.reset_trace_counts()
    if route == "perpod":
        c, _, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", chunked=False)
    elif route == "dense":
        c, _, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", chunked=True)
    else:
        inc = HoistCache().ensure(arr, meta, cfg)
        c, _, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", inc=inc)
    want = jax_routes["dense" if route == "perpod" else route]
    assert _sha(c[:n]) == want["choices"] and int((c[:n] >= 0).sum()) == want["scheduled"]
    if route != "perpod":
        assert assign.TRACE_COUNTS["chunked" if route == "dense" else "class_waves"] == 1
        assert s == want["sweeps"] and _sha(o[:n]) == want["ordinals"]
    placed = decode_choices(c, meta)
    assert [(p, placed[p]) for p in meta.pod_names] == oracle


def test_dra_small_matches_the_jax_digest():
    """dra_small's snapshot on the per-pod route hashes to the JAX
    package's choices (bench/workloads.py DRA_SMALL_*), and equals the
    oracle."""
    from kubernetes_tpu.oracle import oracle_schedule

    arr, meta = DeltaEncoder("cpu").encode_device(tw.dra_small())
    c, _ = assign.schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu")
    n = meta.n_pods
    assert list(meta.resources) == tw.DRA_SMALL_RESOURCES
    assert int((c[:n] >= 0).sum()) == tw.DRA_SMALL_SCHEDULED
    assert _sha(c[:n]) == tw.DRA_SMALL_CHOICES_SHA256
    placed = decode_choices(c, meta)
    assert [(p, placed[p]) for p in meta.pod_names] == oracle_schedule(tw.dra_small())


@pytest.fixture(scope="module")
def jax_warm(jax_legs):
    line = [ln for ln in jax_legs("config4s-warm").splitlines() if ln.startswith("config4s-warm-json: ")][0]
    return json.loads(line[len("config4s-warm-json: "):])


@pytest.mark.parametrize("depth", [1, 0])
def test_warm_waves_with_storage_match_jax(jax_warm, depth):
    """Config4S's warm waves 2..7 over the storage-carrying snapshots: the
    JAX loop's verdicts, HoistCache actions and encoder stats; the encoder
    rebuilds once, at the PVC change of wave 5."""
    snap = tw.heterogeneous_storage(*SMOKE)
    enc = DeltaEncoder("cpu")
    arr, meta = enc.encode_device(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    c, _ = assign.schedule_batch(arr, cfg, device="cpu", inc=HoistCache().ensure(arr, meta, cfg))
    loop = PipelinedBatchLoop(encoder=enc, depth=depth, device="cpu")
    waves, fetched, _, _ = tw.warm_waves(snap, tw.verdicts_of(c, meta), loop.submit, loop.drain,
                                         tw.StorageWaves(snap))
    assert {str(w): v for w, v in fetched.items() if w >= 2} == jax_warm["verdicts"]
    assert [h["action"] for h in loop.hoist.history] == jax_warm["actions"]
    assert enc.stats == jax_warm["stats"] and enc.stats["full"] == 2, enc.stats
    assert any(p.pvcs for p in waves[5])
