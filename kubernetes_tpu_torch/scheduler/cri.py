"""CRI — the kubelet's container-runtime boundary.

The reference kubelet talks to containerd/CRI-O over gRPC through the
Container Runtime Interface (cri-api/pkg/apis/runtime/v1 — RuntimeService:
RunPodSandbox/CreateContainer/StartContainer/...; ImageService: PullImage/
ListImages), and kuberuntime (pkg/kubelet/kuberuntime) is the only layer
that speaks it.  kubemark's hollow node swaps the real runtime for a fake
behind the SAME interface (pkg/kubemark/hollow_kubelet.go).

This module is that boundary in-process: kubelet.py depends only on the
RuntimeService/ImageService protocols; FakeCRI is the kubemark-style
clock-driven implementation (containers run for their configured
run_seconds then exit 0, or crash_after_seconds then exit 1).  A real
remote runtime would implement the same two protocols over a socket —
nothing in the kubelet would change.

Shapes kept from cri-api: sandboxes and containers are separate objects
with runtime-assigned IDs; containers belong to a sandbox and carry an
`attempt` (restart ordinal — the reference's ContainerMetadata.Attempt);
the sandbox owns the pod IP (what the CNI plugin returns through the
runtime); images are pulled by name and listed with sizes.

The port's copy of the JAX package's ``scheduler/cri.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import itertools
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol

from .queue import Clock

# runtime_v1.PodSandboxState / ContainerState (reduced)
SANDBOX_READY = "SANDBOX_READY"
SANDBOX_NOTREADY = "SANDBOX_NOTREADY"
CONTAINER_CREATED = "CONTAINER_CREATED"
CONTAINER_RUNNING = "CONTAINER_RUNNING"
CONTAINER_EXITED = "CONTAINER_EXITED"


@dataclass(frozen=True)
class PodSandboxConfig:
    """runtime_v1.PodSandboxConfig (metadata only — the hollow trade)."""

    pod_uid: str
    pod_name: str = ""
    namespace: str = ""


@dataclass(frozen=True)
class ContainerConfig:
    """runtime_v1.ContainerConfig reduced to what drives the fake runtime:
    the image and the hollow workload's clock behavior."""

    name: str = "main"
    image: str = ""
    run_seconds: float = 0.0  # > 0: exit 0 after this long
    crash_after_seconds: float = 0.0  # > 0: exit 1 after this long


@dataclass
class SandboxStatus:
    id: str
    pod_uid: str
    state: str
    ip: str = ""


@dataclass
class ContainerStatus:
    id: str
    sandbox_id: str
    pod_uid: str
    name: str
    image: str
    state: str
    attempt: int = 0
    exit_code: int = 0
    started_at: float = 0.0


class RuntimeService(Protocol):
    """cri-api runtime_v1.RuntimeServiceClient (lifecycle subset)."""

    def run_pod_sandbox(self, config: PodSandboxConfig) -> str: ...
    def stop_pod_sandbox(self, sandbox_id: str) -> None: ...
    def remove_pod_sandbox(self, sandbox_id: str) -> None: ...
    def create_container(
        self, sandbox_id: str, config: ContainerConfig
    ) -> str: ...
    def start_container(self, container_id: str) -> None: ...
    def stop_container(self, container_id: str) -> None: ...
    def remove_container(self, container_id: str) -> None: ...
    def list_pod_sandboxes(self) -> List[SandboxStatus]: ...
    def list_containers(self) -> List[ContainerStatus]: ...
    def pod_sandbox_status(self, sandbox_id: str) -> SandboxStatus: ...
    def container_status(self, container_id: str) -> ContainerStatus: ...


class ImageService(Protocol):
    """cri-api runtime_v1.ImageServiceClient (pull/list/remove subset)."""

    def pull_image(self, name: str) -> str: ...
    def list_images(self) -> Dict[str, int]: ...
    def remove_image(self, name: str) -> None: ...


class CRIError(Exception):
    """A runtime call against a missing/invalid object (the gRPC NotFound /
    InvalidArgument class of failures)."""


@dataclass
class _Sandbox:
    status: SandboxStatus
    next_attempt: Dict[str, int]


class FakeCRI:
    """kubemark's fake runtime behind the real interface: containers
    advance by clock alone.  tick() is the runtime's own event loop (a real
    CRI daemon runs containers without being asked); PLEG observes the
    results purely through list_containers()."""

    DEFAULT_IMAGE_BYTES = 100 * 1024 * 1024

    def __init__(self, clock: Clock,
                 ip_alloc: Optional[Callable[[str], str]] = None):
        self.clock = clock
        self._ip_alloc = ip_alloc or (lambda pod_uid: "")
        self.sandboxes: Dict[str, _Sandbox] = {}
        self.containers: Dict[str, "_Ctr"] = {}
        self.images: Dict[str, int] = {}
        self._seq = itertools.count()

    # --- RuntimeService ---
    def run_pod_sandbox(self, config: PodSandboxConfig) -> str:
        sid = f"sb-{next(self._seq):06d}"
        self.sandboxes[sid] = _Sandbox(
            SandboxStatus(
                id=sid, pod_uid=config.pod_uid, state=SANDBOX_READY,
                ip=self._ip_alloc(config.pod_uid),
            ),
            next_attempt={},
        )
        return sid

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        sb = self.sandboxes.get(sandbox_id)
        if sb is None:
            raise CRIError(f"sandbox {sandbox_id} not found")
        sb.status.state = SANDBOX_NOTREADY
        for c in self.containers.values():
            if c.status.sandbox_id == sandbox_id:
                self._exit(c, 137)  # SIGKILLed with the sandbox

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        # the reference requires containers removed first; be strict so the
        # kubelet's teardown ordering stays honest
        for c in self.containers.values():
            if c.status.sandbox_id == sandbox_id:
                raise CRIError(f"sandbox {sandbox_id} still has containers")
        self.sandboxes.pop(sandbox_id, None)

    def create_container(self, sandbox_id: str, config: ContainerConfig) -> str:
        sb = self.sandboxes.get(sandbox_id)
        if sb is None or sb.status.state != SANDBOX_READY:
            raise CRIError(f"sandbox {sandbox_id} not ready")
        attempt = sb.next_attempt.get(config.name, 0)
        sb.next_attempt[config.name] = attempt + 1
        cid = f"ctr-{next(self._seq):06d}"
        self.containers[cid] = _Ctr(
            ContainerStatus(
                id=cid, sandbox_id=sandbox_id, pod_uid=sb.status.pod_uid,
                name=config.name, image=config.image,
                state=CONTAINER_CREATED, attempt=attempt,
            ),
            config,
        )
        return cid

    def start_container(self, container_id: str) -> None:
        c = self.containers.get(container_id)
        if c is None or c.status.state != CONTAINER_CREATED:
            raise CRIError(f"container {container_id} not startable")
        c.status.state = CONTAINER_RUNNING
        c.status.started_at = self.clock.now()

    def stop_container(self, container_id: str) -> None:
        c = self.containers.get(container_id)
        if c is None:
            raise CRIError(f"container {container_id} not found")
        if c.status.state == CONTAINER_RUNNING:
            self._exit(c, 137)

    def remove_container(self, container_id: str) -> None:
        c = self.containers.get(container_id)
        if c is not None and c.status.state == CONTAINER_RUNNING:
            raise CRIError(f"container {container_id} is running")
        self.containers.pop(container_id, None)

    def list_pod_sandboxes(self) -> List[SandboxStatus]:
        return [sb.status for sb in self.sandboxes.values()]

    def list_containers(self) -> List[ContainerStatus]:
        return [c.status for c in self.containers.values()]

    def pod_sandbox_status(self, sandbox_id: str) -> SandboxStatus:
        sb = self.sandboxes.get(sandbox_id)
        if sb is None:
            raise CRIError(f"sandbox {sandbox_id} not found")
        return sb.status

    def container_status(self, container_id: str) -> ContainerStatus:
        c = self.containers.get(container_id)
        if c is None:
            raise CRIError(f"container {container_id} not found")
        return c.status

    # --- ImageService ---
    def pull_image(self, name: str) -> str:
        if name not in self.images:
            # deterministic nominal size (the hollow registry) — crc32, not
            # hash(): Python string hashing is randomized per process and
            # would make NodeStatus.Images non-reproducible across runs
            self.images[name] = self.DEFAULT_IMAGE_BYTES + (
                zlib.crc32(name.encode()) & 0xFFFF
            )
        return name

    def list_images(self) -> Dict[str, int]:
        return dict(self.images)

    def remove_image(self, name: str) -> None:
        self.images.pop(name, None)

    # --- the runtime's own clock loop ---
    def tick(self) -> None:
        now = self.clock.now()
        for c in self.containers.values():
            st, cfg = c.status, c.config
            if st.state != CONTAINER_RUNNING:
                continue
            if cfg.crash_after_seconds > 0 and (
                now - st.started_at >= cfg.crash_after_seconds
            ):
                self._exit(c, 1)
            elif cfg.run_seconds > 0 and now - st.started_at >= cfg.run_seconds:
                self._exit(c, 0)

    @staticmethod
    def _exit(c: "_Ctr", code: int) -> None:
        c.status.state = CONTAINER_EXITED
        c.status.exit_code = code


@dataclass
class _Ctr:
    status: ContainerStatus
    config: ContainerConfig
