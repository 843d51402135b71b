"""The scheduler's host orchestration around the device kernels — the port
of the JAX package's ``scheduler/`` runtime.

``Scheduler`` (scheduler.py) runs the batch cycle (mode="tpu": the
activeQ drained into one batch, encoded onto the card, scheduled by the
routed kernels, bound, and its failures diagnosed and preempted) and the
per-pod cycle (mode="cpu": the plugin framework, plugins/cpu.py, with the
CPU PostFilter ``DefaultPreemption``) over a ``ClusterStore`` watch, a
``PriorityQueue`` and a ``SchedulerCache``:

    store = ClusterStore()
    sched = Scheduler(store, SchedulerConfiguration(mode="tpu"))  # the card
    sched = Scheduler(store, SchedulerConfiguration(mode="tpu"), device="cpu")
    store.add_node(node); store.add_pod(pod)
    sched.run_until_idle()

Also here: ``preemption.BatchedPreemption`` (the failure loop's batched
victim search), ``metrics.Metrics``, ``tracing``, and the crash restart:
``checkpoint`` (the fsync'd checkpoint a ``checkpoint_dir`` arms),
``flightrecorder`` (the decision black box), ``leases`` (leader election,
``HAReplica``'s standby takeover) and the drivers ``run_restartable``,
``run_ha_restartable``, ``restart_scheduler`` and ``reincarnate``; HTTP
extenders (``extender.HTTPExtender``) in the per-pod cycle.  mode="native"
runs the batch cycle on the host's C++ engine (native/).

The control plane around it: ``apiserver.APIServer`` (authn -> APF ->
RBAC -> admission -> registry, with ``auth``, ``flowcontrol``,
``admission`` and ``crd``), ``controllers.ControllerManager`` (the
workload controllers and the garbage collector), ``kubelet.HollowCluster``
(hollow kubelets behind ``cri``, with ``cm`` and ``devicemanager``),
``network`` (EndpointSlices and the proxier) and ``disruption``.
Observability: ``tracing`` (spans, the Chrome-trace and tree exporters,
``device_trace`` on torch.profiler), ``attribution`` (where a cycle's wall
goes), ``memwatch`` (the device-memory ledger) and ``flightrecorder``.
"""

from .cache import SchedulerCache  # noqa: F401
from .config import Profile, SchedulerConfiguration  # noqa: F401
from .framework import CycleState, Framework, Status  # noqa: F401
from .plugins.cpu import default_plugins, default_registry  # noqa: F401
from .scheduler import (  # noqa: F401
    Scheduler,
    reincarnate,
    restart_scheduler,
    run_ha_restartable,
    run_restartable,
)
from .store import ClusterStore  # noqa: F401
