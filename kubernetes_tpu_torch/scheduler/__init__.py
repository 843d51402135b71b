"""The scheduler's host orchestration around the device kernels.

Ported so far: ``preemption.BatchedPreemption``, the failure loop's batched
victim search.  The ``Scheduler`` itself, the CPU PostFilter, events and
metrics are still to port (ROADMAP.md A11).
"""
