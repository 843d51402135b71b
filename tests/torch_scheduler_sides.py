"""The two sides of the Scheduler parity tests (tests/test_torch_scheduler*.py).

A case is a function of a ``Side``: it builds a store and a Scheduler of
that side's package, feeds them the JAX package's objects (tests/helpers.py
mk_node / mk_pod, random_cluster), drives them, and returns what it saw.
``Side("jax")`` runs the JAX package's Scheduler as it is;
``Side("port")`` runs the port's, the objects carried across by
kubernetes_tpu_torch/convert.py from_jax_objects as they enter the store,
its batch cycle on the CPU (device="cpu").  The tests hold the two returns
equal, exactly.

``observe(store, sched)`` is what every case returns at its checkpoints:
the store's pods with their nodes and nominations; the event log (reason,
pod, node, message, in order); the queue's pools (the uids in the activeQ,
backoff and unschedulable pools, the nominations, the attempt counts); the
counters scheduling_attempts_scheduled / _unschedulable / _error,
preemption_victims, queue_incoming_pods_total and the labeled
pod_unschedulable_reasons_total{reason}, and the number of deferred-bind
flushes.  Time-valued metrics are not compared.
"""

COUNTERS = ("scheduling_attempts_scheduled", "scheduling_attempts_unschedulable", "scheduling_attempts_error",
            "preemption_victims", "queue_incoming_pods_total")


class Store:
    """A store that converts the objects it is given (add_* / update_*)."""

    def __init__(self, store, conv):
        self._store, self._conv = store, conv

    def __getattr__(self, name):
        attr = getattr(self._store, name)
        if callable(attr) and name.split("_")[0] in ("add", "update"):
            return lambda obj, *a, **k: attr(self._conv(obj), *a, **k)
        return attr


class Side:
    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            import kubernetes_tpu.scheduler as S
            from kubernetes_tpu import chaos
            from kubernetes_tpu.scheduler import config, events, features, metrics, preemption, queue

            self.conv = lambda x: x
            self.dev = {}
        else:
            import kubernetes_tpu_torch.scheduler as S
            from kubernetes_tpu_torch import chaos
            from kubernetes_tpu_torch.convert import from_jax_objects
            from kubernetes_tpu_torch.scheduler import config, events, features, metrics, preemption, queue

            self.conv = from_jax_objects
            self.dev = {"device": "cpu"}
        self.S, self.config, self.queue_mod, self.features = S, config, queue, features
        self.chaos = chaos
        self.events_mod, self.metrics_mod, self.preemption = events, metrics, preemption
        self.SchedulerConfiguration, self.Profile = config.SchedulerConfiguration, config.Profile
        self.PluginSpec, self.TPUScoreArgs = config.PluginSpec, config.TPUScoreArgs
        self.FakeClock = queue.FakeClock

    def cfg(self, mode: str = "tpu", **kw):
        return self.SchedulerConfiguration(mode=mode, **kw)

    def scheduler(self, store, config, **kw):
        """A Scheduler over the raw store `store` (the port's on the CPU)."""
        return self.S.Scheduler(store, config, **(self.dev if config.mode == "tpu" else {}), **kw)

    def cluster(self, mode: str = "tpu", nodes=(), clock=None, config=None, **kw):
        """(converting store, Scheduler) with `nodes` added first."""
        raw = self.S.ClusterStore()
        store = Store(raw, self.conv)
        for nd in nodes:
            store.add_node(nd)
        return store, self.scheduler(raw, config or self.cfg(mode), clock=clock, **kw)


def observe(store, sched) -> dict:
    q = sched.queue
    m = sched.metrics
    return {
        "pods": sorted((p.name, p.node_name, p.nominated_node_name) for p in store.pods.values()),
        "events": [(e.reason, e.pod, e.node, e.message) for e in sched.events.events],
        "active": sorted(q._active_uids),
        "backoff": sorted(p.uid for _, _, p in q._backoff),
        "unschedulable": sorted(q._unschedulable),
        "nominated": sorted((uid, node) for uid, (_, node) in q.nominated.items()),
        "attempts": dict(sorted(q._attempts.items())),
        "counters": {k: m.counters.get(k, 0) for k in COUNTERS},
        "reasons": sorted(m.labeled_counter_series("pod_unschedulable_reasons_total").items()),
        # how many deferred-bind flushes published something (the commit
        # overlap's count, not its time)
        "deferred_flushes": m.hists["pipeline_deferred_commit_seconds"].count
        if "pipeline_deferred_commit_seconds" in m.hists else 0,
    }


def both(case, *args, **kw):
    """(the JAX side's return, the port's) of case(side, *args, **kw)."""
    return case(Side("jax"), *args, **kw), case(Side("port"), *args, **kw)
