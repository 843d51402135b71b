"""The port's kubectl (kubernetes_tpu_torch/kubectl.py) and manifest codec
(api/serialize.py) against the JAX package's, on the CPU.

- One parity case for every test of the JAX package's test_kubectl.py:
  tests/torch_mirror.py runs the test in both packages (the port's side
  re-pointed at kubernetes_tpu_torch) and holds the recordings equal,
  exactly: the output text of every Kubectl.run (the version line names
  each package, the only difference the port's side is held to), every
  apiserver request with its outcome, and every store at the end.
- The codec's round trips, one case per registered kind: a JAX-built object
  of the kind (a few non-default fields) and the same object carried across
  by convert.from_jax_objects dump to the same YAML and the same JSON text,
  and the port loads either text back to the carried object (YAML through
  load_yaml, JSON through load_json and load_manifests, which need no YAML
  parser).
- `python -m kubernetes_tpu_torch.kubectl --manifests x.json get pods`
  prints what the JAX package's CLI prints for the same manifests as YAML.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from torch_mirror import cases, run_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from kubernetes_tpu.api import cluster as jc  # noqa: E402
from kubernetes_tpu.api import serialize as jser  # noqa: E402
from kubernetes_tpu.api import types as jt  # noqa: E402
from kubernetes_tpu_torch.api import serialize as pser  # noqa: E402
from kubernetes_tpu_torch.convert import from_jax_objects  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("case", cases("test_kubectl"))
def test_port_matches_jax(case, tmp_path):
    want, got = run_both(case, tmp_path)
    # `kubectl version` names its package
    got = json.loads(json.dumps(got).replace("kubernetes_tpu_torch kubectl", "kubernetes_tpu kubectl"))
    assert got == json.loads(json.dumps(want))


def _sample(kind: str):
    """A JAX-built object of `kind` with a few fields off their defaults."""
    sel = jt.LabelSelector.of(app="web")
    tmpl = jt.Pod(name="web", labels={"app": "web"}, requests={"cpu": 250, "memory": 1 << 28})
    special = {
        "Pod": lambda: jt.Pod(
            name="web-1", requests={"cpu": 1000, "memory": 1 << 30}, labels={"app": "web"},
            node_selector=(("disk", "ssd"),), priority_class_name="high",
            tolerations=(jt.Toleration(key="gpu", operator="Exists", effect="NoSchedule"),),
            owner_references=(jt.OwnerReference(kind="ReplicaSet", name="web-abc", uid="rs/default/web-abc"),),
            readiness_probe=jt.Probe(period_seconds=5.0, failure_threshold=2),
            liveness_probe=jt.Probe(fail_after_seconds=30.0), restart_policy="OnFailure",
            affinity=jt.Affinity(required_node_terms=(jt.NodeSelectorTerm(match_expressions=(
                jt.NodeSelectorRequirement("zone", "In", ("a", "b")),)),)),
            topology_spread=(jt.TopologySpreadConstraint(1, "zone", label_selector=sel),)),
        "Node": lambda: jt.Node(name="n1", allocatable={"cpu": 8000, "memory": 32 << 30, "pods": 110},
                                labels={"zone": "a"}, taints=(jt.Taint("gpu", "true", "NoSchedule"),)),
        "PodGroup": lambda: jt.PodGroup(name="gang", min_member=4),
        "ReplicaSet": lambda: jt.ReplicaSet(name="web-abc", replicas=3, selector=sel, template=tmpl),
        "Deployment": lambda: jt.Deployment(name="web", replicas=30, selector=sel, template=tmpl, max_surge=2),
        "Job": lambda: jt.Job(name="batch", completions=5, parallelism=2, template=tmpl,
                              ttl_seconds_after_finished=60),
        "Service": lambda: jc.Service(name="web", selector=(("app", "web"),),
                                      ports=(jc.ServicePort(80, target_port=8080),)),
        "PriorityClass": lambda: jc.PriorityClass(name="high", value=1000),
        "ResourceQuota": lambda: jc.ResourceQuota(name="q", hard={"pods": 10, "cpu": 4000}),
    }
    if kind in special:
        return special[kind]()
    return jser.KINDS[kind](name=f"x-{kind.lower()}")


@pytest.mark.parametrize("kind", sorted(jser.KINDS))
def test_serialize_roundtrip_matches_jax(kind):
    obj = _sample(kind)
    mine = from_jax_objects(obj)
    assert type(mine).__module__.startswith("kubernetes_tpu_torch.")
    ytext = jser.dump_yaml(obj)
    assert pser.dump_yaml(mine) == ytext
    jtext = jser.dump_json(obj)
    assert pser.dump_json(mine) == jtext
    assert pser.load_yaml(ytext) == [mine]
    assert pser.load_json(jtext) == [mine] == pser.load_manifests(jtext)
    assert pser.load_json(json.dumps([json.loads(jtext)] * 2)) == [mine, mine]
    assert from_jax_objects(jser.load_yaml(ytext)) == [mine]


def test_cli_manifests_json_matches_jax_yaml(tmp_path):
    objs = [_sample("Node"), jt.Pod(name="a", requests={"cpu": 100}), jt.Pod(name="b", node_name="n1")]
    (tmp_path / "c.yaml").write_text(jser.dump_yaml(objs))
    (tmp_path / "c.json").write_text(json.dumps([jser.to_manifest(o) for o in objs]))

    def cli(pkg, path, *verb):
        out = subprocess.run([sys.executable, "-m", f"{pkg}.kubectl", "--manifests", str(path), *verb],
                             cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout

    for verb in (("get", "pods"), ("get", "nodes", "-o", "wide")):
        want = cli("kubernetes_tpu", tmp_path / "c.yaml", *verb)
        assert cli("kubernetes_tpu_torch", tmp_path / "c.json", *verb) == want and "a" in want
