"""ComponentConfig: SchedulerConfiguration — the KubeSchedulerConfiguration
analog (pkg/scheduler/apis/config/types.go — KubeSchedulerConfiguration /
KubeSchedulerProfile) as dataclasses + YAML loading, with defaulting and
validation in the same spirit as apis/config/{v1,validation}.

The TPUScore section configures the batched offload path (the north star's
out-of-tree plugin's pluginConfig: sidecar address, batch window, fallback
deadline); mode="cpu" disables offload entirely — the mandated fallback.

The port's copy of the JAX package's ``scheduler/config.py``.  ``from_yaml``
imports PyYAML when it is called, never at import.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from ..ops.scores import ScoreConfig
from .extender import ExtenderConfig


@dataclass(frozen=True)
class PluginSpec:
    name: str
    weight: float = 1.0
    enabled: bool = True


@dataclass(frozen=True)
class TPUScoreArgs:
    """pluginConfig for the TPU offload (north star: sidecar address, batch
    window, deadline -> CPU fallback)."""

    sidecar_address: str = "local"  # "local" = in-process kernels, no gRPC hop
    batch_window_ms: float = 5.0
    deadline_ms: float = 1000.0
    mesh_devices: int = 1


@dataclass(frozen=True)
class Profile:
    scheduler_name: str = "default-scheduler"
    plugins: Tuple[PluginSpec, ...] = ()
    # percentageOfNodesToScore: honored by the CPU path's filter fan-out
    # (adaptive numFeasibleNodesToFind formula when 0, rotating cursor);
    # default 100 = full deterministic scoring; batch/TPU paths always score
    # everything (D3)
    percentage_of_nodes_to_score: int = 100
    tpu_score: Optional[TPUScoreArgs] = None
    # InterPodAffinityArgs.hardPodAffinityWeight (pluginConfig; default 1)
    hard_pod_affinity_weight: float = 1.0
    # NodeResourcesFitArgs.scoringStrategy (pluginConfig):
    # LeastAllocated | MostAllocated | RequestedToCapacityRatio
    fit_strategy: str = "LeastAllocated"
    # RequestedToCapacityRatio shape points (utilization%%, score 0..10)
    rtcr_shape: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (100.0, 10.0))


@dataclass(frozen=True)
class SchedulerConfiguration:
    profiles: Tuple[Profile, ...] = (Profile(),)
    # HTTP extenders (apis/config — KubeSchedulerConfiguration.Extenders);
    # honored on the CPU path for wire compatibility with existing extenders —
    # the batched paths use the gRPC sidecar instead (scheduler/extender.py)
    extenders: Tuple["ExtenderConfig", ...] = ()
    parallelism: int = 16  # reference default goroutine fan-out; informational here
    # >0: the CPU path's binding cycle (PreBind/Bind/PostBind) runs on this
    # many worker threads, overlapping the next pod's scheduling cycle — the
    # reference's async bindingCycle goroutine.  0 = synchronous binding.
    binding_workers: int = 0
    # unschedulable-retry backoff: initial step, the CAP (a fixed uncapped
    # doubling would park pods for minutes after a long outage), and a
    # multiplicative jitter fraction (each push matures at duration *
    # (1 + U[0, jitter))) — a sidecar outage parks whole waves at once, and
    # without jitter they all retry in one synchronized storm.  All three
    # are wired into the scheduler's PriorityQueue.
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    pod_backoff_jitter: float = 0.1
    feature_gates: Tuple[Tuple[str, bool], ...] = ()
    # "tpu" (batched XLA kernels) | "native" (batched C++ engine — the fast
    # CPU fallback) | "cpu" (per-pod plugin path — the reference's exact shape)
    mode: str = "tpu"
    # pipelined batch commits: defer the bind/events fan-out of cycle i−1
    # into cycle i's device-step window when provably serial-equivalent
    # (capacity reserves synchronously via cache.assume regardless; see
    # scheduler.py — _flush_deferred_binds).  KTPU_PIPELINE=0 also disables.
    pipeline_commit: bool = True

    def profile(self, name: str = "default-scheduler") -> Profile:
        for p in self.profiles:
            if p.scheduler_name == name:
                return p
        return self.profiles[0]

    def score_config(self, profile_name: str = "default-scheduler") -> ScoreConfig:
        """Lower a profile's plugin weights onto the kernel ScoreConfig."""
        prof = self.profile(profile_name)
        w = {s.name: s.weight for s in prof.plugins if s.enabled}
        disabled = {s.name for s in prof.plugins if not s.enabled}
        cfg = ScoreConfig(
            fit_weight=w.get("NodeResourcesFit", 1.0),
            balanced_weight=w.get("NodeResourcesBalancedAllocation", 1.0),
            taint_weight=w.get("TaintToleration", 3.0),
            node_affinity_weight=w.get("NodeAffinity", 2.0),
            spread_weight=w.get("PodTopologySpread", 2.0),
            interpod_weight=w.get("InterPodAffinity", 2.0),
            hard_pod_affinity_weight=prof.hard_pod_affinity_weight,
            fit_strategy=prof.fit_strategy,
            rtcr_shape=prof.rtcr_shape,
        )
        for name in disabled:
            key = {
                "NodeResourcesFit": "fit_weight",
                "NodeResourcesBalancedAllocation": "balanced_weight",
                "TaintToleration": "taint_weight",
                "NodeAffinity": "node_affinity_weight",
                "PodTopologySpread": "spread_weight",
                "InterPodAffinity": "interpod_weight",
            }.get(name)
            if key:
                cfg = replace(cfg, **{key: 0.0})
        return cfg


def validate(cfg: SchedulerConfiguration) -> List[str]:
    """apis/config/validation — ValidateKubeSchedulerConfiguration."""
    errs = []
    if not cfg.profiles:
        errs.append("at least one profile required")
    names = [p.scheduler_name for p in cfg.profiles]
    if len(set(names)) != len(names):
        errs.append("duplicate profile schedulerName")
    for p in cfg.profiles:
        if p.fit_strategy not in (
            "LeastAllocated", "MostAllocated", "RequestedToCapacityRatio"
        ):
            errs.append(f"{p.scheduler_name}: unknown fit scoringStrategy "
                        f"{p.fit_strategy!r}")
        if p.fit_strategy == "RequestedToCapacityRatio":
            xs = [q[0] for q in p.rtcr_shape]
            if len(xs) < 2 or len(xs) > 8 or any(
                b <= a for a, b in zip(xs, xs[1:])
            ):
                errs.append(f"{p.scheduler_name}: rtcr shape must be 2..8 "
                            "points with strictly increasing utilization")
        if not 0 <= p.percentage_of_nodes_to_score <= 100:
            errs.append(f"{p.scheduler_name}: percentageOfNodesToScore out of [0,100]")
        for s in p.plugins:
            if s.weight < 0:
                errs.append(f"{p.scheduler_name}/{s.name}: negative weight")
    if cfg.mode not in ("tpu", "native", "cpu"):
        errs.append(f"unknown mode {cfg.mode!r}")
    for e in cfg.extenders:
        if not e.url_prefix:
            errs.append("extender: urlPrefix required")
        if e.bind_verb and not e.filter_verb:
            errs.append(f"extender {e.url_prefix}: bindVerb requires filterVerb")
    if cfg.parallelism <= 0:
        errs.append("parallelism must be positive")
    if cfg.binding_workers < 0:
        errs.append("bindingWorkers must be >= 0")
    if cfg.pod_initial_backoff_seconds <= 0:
        errs.append("podInitialBackoffSeconds must be positive")
    if cfg.pod_max_backoff_seconds < cfg.pod_initial_backoff_seconds:
        errs.append("podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
    if cfg.pod_backoff_jitter < 0:
        errs.append("podBackoffJitter must be >= 0")
    return errs


def from_yaml(text: str) -> SchedulerConfiguration:
    """Load a KubeSchedulerConfiguration-shaped YAML document."""
    import yaml

    doc = yaml.safe_load(text) or {}
    profiles = []
    for prof in doc.get("profiles", [{}]):
        plugins = []
        for item in prof.get("plugins", []):
            plugins.append(
                PluginSpec(
                    name=item["name"],
                    weight=float(item.get("weight", 1.0)),
                    enabled=bool(item.get("enabled", True)),
                )
            )
        tpu = None
        if "tpuScore" in prof:
            a = prof["tpuScore"] or {}
            tpu = TPUScoreArgs(
                sidecar_address=a.get("sidecarAddress", "local"),
                batch_window_ms=float(a.get("batchWindowMs", 5.0)),
                deadline_ms=float(a.get("deadlineMs", 1000.0)),
                mesh_devices=int(a.get("meshDevices", 1)),
            )
        profiles.append(
            Profile(
                scheduler_name=prof.get("schedulerName", "default-scheduler"),
                plugins=tuple(plugins),
                percentage_of_nodes_to_score=int(prof.get("percentageOfNodesToScore", 100)),
                tpu_score=tpu,
            )
        )
    extenders = tuple(
        ExtenderConfig(
            url_prefix=e.get("urlPrefix", ""),
            filter_verb=e.get("filterVerb", ""),
            prioritize_verb=e.get("prioritizeVerb", ""),
            bind_verb=e.get("bindVerb", ""),
            preempt_verb=e.get("preemptVerb", ""),
            weight=float(e.get("weight", 1.0)),
            ignorable=bool(e.get("ignorable", False)),
            timeout_s=float(e.get("httpTimeout", 5.0)),
        )
        for e in doc.get("extenders") or []
    )
    cfg = SchedulerConfiguration(
        profiles=tuple(profiles) or (Profile(),),
        extenders=extenders,
        parallelism=int(doc.get("parallelism", 16)),
        pod_initial_backoff_seconds=float(doc.get("podInitialBackoffSeconds", 1.0)),
        pod_max_backoff_seconds=float(doc.get("podMaxBackoffSeconds", 10.0)),
        pod_backoff_jitter=float(doc.get("podBackoffJitter", 0.1)),
        feature_gates=tuple((k, bool(v)) for k, v in (doc.get("featureGates") or {}).items()),
        mode=doc.get("mode", "tpu"),
    )
    errs = validate(cfg)
    if errs:
        raise ValueError("; ".join(errs))
    return cfg
