"""HTTP scheduler extender configuration — the part of the JAX package's
``scheduler/extender.py`` that the port's configuration and CPU plugins
read: ``ExtenderConfig`` (the config shape of pkg/scheduler/apis/config/
types.go — type Extender) and ``ExtenderError``.

The HTTP client itself (``HTTPExtender``: Filter / Prioritize / Bind /
ProcessPreemption over JSON) needs the manifest serializer, which the port
does not have yet: a Scheduler given a configuration with extenders raises
NotImplementedError (ROADMAP A14).
"""

from __future__ import annotations

from dataclasses import dataclass


class ExtenderError(Exception):
    """Transport/protocol failure from a non-ignorable extender: the pod's
    scheduling attempt fails and it re-queues (extender.go — IsIgnorable)."""


@dataclass(frozen=True)
class ExtenderConfig:
    """apis/config — type Extender (the fields the client honors)."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    # supportsPreemption: when set, DefaultPreemption offers this extender
    # its candidate victim map (extender.go — ProcessPreemption)
    preempt_verb: str = ""
    weight: float = 1.0
    ignorable: bool = False
    timeout_s: float = 5.0
