"""Deterministic fault injection and recovery accounting — the port's copy
of the JAX package's ``chaos/`` (see plan.py)."""

from .plan import (  # noqa: F401
    ALL_KILL_SITES,
    ALWAYS,
    ChaosInjector,
    Fault,
    FaultInjected,
    FaultPlan,
    KILL_SITES,
    STREAM_KILL_SITES,
    PoisonedWave,
    ProcessKilled,
    SITE_ACTIONS,
    active,
    chaos_plan,
    enabled,
    install,
    killed,
    maybe_install_from_env,
    poison,
    poisoned_verdicts,
    poke,
    record_recovery,
    revive,
    sites_matching,
    uninstall,
)
