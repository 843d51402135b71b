"""The control plane end to end: a manifest applied through the apiserver,
the controllers, the Scheduler, the hollow kubelets and the proxier, in
synchronous rounds on a FakeClock, so a run is deterministic.

The cluster is sized by the documented limits of one Kubernetes cluster
(kubernetes.io, "Considerations for large clusters": at most 5000 nodes,
150000 pods, 110 pods a node): ``FULL`` is 5000 hollow nodes (8000m CPU,
32 GiB, 110 pods each), one Namespace, 50 Deployments and a Service for
each.  Requests rotate 100m / 128 MiB, 200m / 256 MiB, 300m / 512 MiB by
Deployment.  The replicas a Deployment are the one scale cut: 3000 (30 a
node, the perf-tests density default) would be the documented limit; the
controllers' per-tick scans are O(pods) per ReplicaSet (the JAX package's
own code, kept), and the JAX package's kubelets, which give the reference
digest, search every pod for a free pod IP at each start (O(pods²) a run;
the port's search reads only its node's pods), so ``FULL`` runs 600 a
Deployment, 30000 pods.

``run`` drives one scenario:

1. every manifest document (JSON, decoded by serialize.from_manifest) is
   created through ``APIServer.handle`` with an admin token, as kubectl's
   ``--manifests`` loop creates them;
2. rounds of ControllerManager.tick -> Scheduler.run_until_idle ->
   HollowCluster.tick -> Proxier.sync, the clock one second on a round,
   until every Deployment has all its replicas Running and Ready, every
   Service's EndpointSlices list them and the proxier routes to them;
3. through Kubectl.run, ``scale`` the first Deployment up by 10%, and
   converge; ``drain`` the node of its first pod (its pods come back as a
   trickle of a few, the Scheduler's per-pod route on the card), and
   converge; then 1% of the running pods, drawn by a seeded RNG, are
   deleted through the apiserver, and the run converges again.

It returns the walls (apply, to all Running, the churn, each
component's sum), the rounds, the Scheduler's event counts, and
``digest``: a sha256 over
every pod by name (node, phase, IP, restart count, ready), every
EndpointSlice's endpoints, and the Scheduler's events (reason and pod
name, in order).  The modules come from ``mods`` (``port_modules()`` by
default): the JAX package's digest of the same scenario comes from its own
modules, passed in by tests/torch_control_plane_reference.py.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from collections import Counter
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

GI = 1 << 30
MI = 1 << 20
NAMESPACE = "perf"
ADMIN_TOKEN = "admin-token"
REQUESTS = ((100, 128 * MI), (200, 256 * MI), (300, 512 * MI))
NODE_ALLOCATABLE = {"cpu": 8000, "memory": 32 * GI, "pods": 110}
FULL = dict(nodes=5000, deployments=50, replicas=600)
SMALL = dict(nodes=20, deployments=5, replicas=40)
MAX_ROUNDS = 20


def port_modules() -> SimpleNamespace:
    """The port's control-plane modules, as ``run`` reads them."""
    from .. import kubectl
    from ..api import serialize
    from ..scheduler import apiserver, auth, controllers, kubelet, leases, network, queue, tracing
    from ..scheduler.config import SchedulerConfiguration
    from ..scheduler.scheduler import Scheduler

    return SimpleNamespace(serialize=serialize, kubectl=kubectl, apiserver=apiserver, auth=auth,
                           controllers=controllers, kubelet=kubelet, leases=leases, network=network,
                           queue=queue, tracing=tracing, Scheduler=Scheduler,
                           SchedulerConfiguration=SchedulerConfiguration)


def node_name(i: int) -> str:
    return f"node-{i:05d}"


def app_name(d: int) -> str:
    return f"app-{d:02d}"


def manifest(nodes: int, deployments: int, replicas: int) -> str:
    """The cluster's manifest, one JSON list of documents: the Namespace,
    the nodes, then each Deployment with its Service."""
    docs: List[dict] = [{"kind": "Namespace", "name": NAMESPACE}]
    for i in range(nodes):
        docs.append({"kind": "Node", "name": node_name(i), "allocatable": dict(NODE_ALLOCATABLE),
                     "labels": {"kubernetes.io/hostname": node_name(i)}})
    for d in range(deployments):
        cpu, mem = REQUESTS[d % len(REQUESTS)]
        app = app_name(d)
        docs.append({"kind": "Deployment", "name": app, "namespace": NAMESPACE, "replicas": replicas,
                     "selector": {"match_labels": [["app", app]]},
                     "template": {"name": app, "namespace": NAMESPACE, "labels": {"app": app},
                                  "requests": {"cpu": cpu, "memory": mem}}})
        docs.append({"kind": "Service", "name": app, "namespace": NAMESPACE, "selector": [["app", app]],
                     "ports": [{"port": 80, "target_port": 8080}]})
    return json.dumps(docs)


class ControlPlane:
    """The components of one run, wired around one store and one clock."""

    def __init__(self, mods: SimpleNamespace, mode: str = "tpu", device=None, collector=None):
        self.mods = mods
        self.clock = mods.queue.FakeClock()
        authn = mods.auth.TokenAuthenticator()
        authn.add_token(ADMIN_TOKEN, "admin", groups=("system:masters",))
        self.store = mods.kubectl.ClusterStore()
        self.api = mods.apiserver.APIServer(self.store, authenticator=authn)
        self.kubectl = mods.kubectl.Kubectl(self.api, ADMIN_TOKEN)
        self.leases = mods.leases.LeaseStore(clock=self.clock)
        self.controllers = mods.controllers.ControllerManager(self.store, clock=self.clock, authenticator=authn)
        kw = {} if device is None else {"device": device}
        self.collector = collector if collector is not None else mods.tracing.TraceCollector(enabled=False)
        self.scheduler = mods.Scheduler(self.store, mods.SchedulerConfiguration(mode=mode), clock=self.clock,
                                        collector=self.collector, **kw)
        self.kubelets = mods.kubelet.HollowCluster(self.store, self.leases)
        self.proxier = mods.network.Proxier(self.store)
        self.walls: Dict[str, float] = dict.fromkeys(("controllers", "scheduler", "kubelets", "proxy"), 0.0)
        self.rounds = 0

    def apply(self, text: str) -> int:
        """Create every document of a JSON manifest through the apiserver."""
        ser = self.mods.serialize
        n = 0
        for doc in json.loads(text):
            obj = ser.from_manifest(doc)
            self.api.handle(ADMIN_TOKEN, "create", self.mods.kubectl._store_kind(obj), obj)
            n += 1
        return n

    def round(self) -> None:
        steps = (("controllers", self.controllers.tick), ("scheduler", self.scheduler.run_until_idle),
                 ("kubelets", self.kubelets.tick), ("proxy", self.proxier.sync))
        for name, step in steps:
            t0 = time.perf_counter()
            step()
            self.walls[name] += time.perf_counter() - t0
        self.clock.step(1.0)
        self.rounds += 1

    def converged(self, want: Dict[str, int]) -> bool:
        """Every Deployment's replicas Running and Ready, no other pod, each
        Service's slices and the proxier's rule listing exactly them."""
        running: Dict[str, int] = {}
        for p in self.store.list_pods():
            app = p.labels.get("app", "")
            if p.phase != "Running" or not p.ready or not p.pod_ip:
                return False
            running[app] = running.get(app, 0) + 1
        if running != want:
            return False
        eps: Dict[str, int] = {}
        for s in self.store.list_objects("EndpointSlice"):
            eps[s.service_name] = eps.get(s.service_name, 0) + sum(e.ready for e in s.endpoints)
        if eps != want:
            return False
        backends = {r.cluster_ip: len(r.backends) for r in self.proxier.rules.values()}
        return sorted(backends.values()) == sorted(want.values())

    def converge(self, want: Dict[str, int]) -> int:
        """Rounds until converged; the rounds taken.  Raises after MAX_ROUNDS."""
        for n in range(1, MAX_ROUNDS + 1):
            self.round()
            if self.converged(want):
                return n
        raise RuntimeError(f"the control plane did not converge in {MAX_ROUNDS} rounds")

    def digest(self) -> str:
        pods = sorted((p.name, p.node_name, p.phase, p.pod_ip, p.restart_count, p.ready)
                      for p in self.store.list_pods())
        slices = sorted((s.name, sorted((e.address, e.node_name, e.pod_uid.rsplit("/", 1)[-1], e.ready)
                                        for e in s.endpoints))
                        for s in self.store.list_objects("EndpointSlice"))
        events = [(e.reason, e.pod.rsplit("/", 1)[-1]) for e in self.scheduler.events.events]
        doc = json.dumps({"pods": pods, "slices": slices, "events": events}, separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()


def run(nodes: int, deployments: int, replicas: int, mods: Optional[SimpleNamespace] = None, mode: str = "tpu",
        device=None, seed: int = 0, collector=None, log: Callable[[str], None] = lambda s: None) -> dict:
    """The scenario of the module docstring; its walls, cycles and digest."""
    cp = ControlPlane(mods or port_modules(), mode=mode, device=device, collector=collector)
    want = {app_name(d): replicas for d in range(deployments)}
    out: dict = {"nodes": nodes, "pods": deployments * replicas}
    t0 = time.perf_counter()
    out["objects"] = cp.apply(manifest(nodes, deployments, replicas))
    out["apply_s"] = time.perf_counter() - t0
    out["rounds_up"] = cp.converge(want)
    out["up_s"] = time.perf_counter() - t0
    log(f"apply {out['objects']} objects {out['apply_s']:.3f} s; all {out['pods']} pods Running after "
        f"{out['rounds_up']} rounds, {out['up_s']:.3f} s")

    first = app_name(0)
    want[first] = replicas + replicas // 10
    t1 = time.perf_counter()
    out["scale"] = cp.kubectl.run(f"scale deployment/{first} --replicas={want[first]} -n {NAMESPACE}")
    out["rounds_scale"] = cp.converge(want)
    victim = min((p for p in cp.store.list_pods() if p.labels.get("app") == first), key=lambda p: p.name)
    drained = victim.node_name
    out["drain_pods"] = sum(p.node_name == drained for p in cp.store.list_pods())
    out["drain"] = cp.kubectl.run(f"drain {drained}")
    out["rounds_drain"] = cp.converge(want)
    running = sorted(p.name for p in cp.store.list_pods())
    doomed = random.Random(seed).sample(running, len(running) // 100)
    for name in doomed:
        cp.api.handle(ADMIN_TOKEN, "delete", "Pod", namespace=NAMESPACE, name=name)
    out["deleted"] = len(doomed)
    out["rounds_churn"] = cp.converge(want)
    out["churn_s"] = time.perf_counter() - t1
    out["wall_s"] = time.perf_counter() - t0
    out["rounds"] = cp.rounds
    out["walls"] = dict(cp.walls)
    out["final_pods"] = len(cp.store.pods)
    if any(p.node_name == drained for p in cp.store.list_pods()):
        raise RuntimeError(f"a pod landed on the drained node {drained}")
    out["events"] = dict(sorted(Counter(e.reason for e in cp.scheduler.events.events).items()))
    out["digest"] = cp.digest()
    log(f"scale {want[first] - replicas} + drain {out['drain_pods']} + delete {len(doomed)}: converged in "
        f"{out['rounds_scale']} + {out['rounds_drain']} + {out['rounds_churn']} rounds, {out['churn_s']:.3f} s")
    return out

