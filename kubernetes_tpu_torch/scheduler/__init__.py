"""The scheduler's host orchestration around the device kernels.

Ported so far: ``preemption.BatchedPreemption``, the failure loop's batched
victim search; ``metrics.Metrics`` and ``tracing`` (the registry and the
span layer the sidecar server uses).  The ``Scheduler`` itself, the CPU
PostFilter and events are still to port (ROADMAP.md A11).
"""
