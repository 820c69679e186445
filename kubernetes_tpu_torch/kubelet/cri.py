"""Container Runtime Interface — the kubelet⇄runtime boundary.

Behavioral equivalent of the reference's CRI
(``staging/src/k8s.io/cri-api/pkg/apis/services.go``: RuntimeService /
ImageService over gRPC): pod sandboxes and containers with an explicit
state machine (CREATED → RUNNING → EXITED), plus an image store. The
in-process ``FakeRuntime`` is the moral twin of the hollow kubelet's fake
CRI (``pkg/kubemark/hollow_kubelet.go``) — full lifecycle bookkeeping, no
actual processes — which is exactly what scale testing needs; a real
runtime would implement the same ``RuntimeService`` surface.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# container states (CRI ContainerState enum)
CREATED, RUNNING, EXITED, UNKNOWN = "CREATED", "RUNNING", "EXITED", "UNKNOWN"
# sandbox states
SANDBOX_READY, SANDBOX_NOTREADY = "SANDBOX_READY", "SANDBOX_NOTREADY"

_id_counter = itertools.count(1)


@dataclass
class PodSandbox:
    id: str
    pod_uid: str
    name: str
    namespace: str
    state: str = SANDBOX_READY
    created_at: float = field(default_factory=time.time)
    ip: str = ""
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class ContainerStatus:
    id: str
    sandbox_id: str
    name: str
    image: str
    state: str = CREATED
    exit_code: Optional[int] = None
    started_at: float = 0.0
    finished_at: float = 0.0
    restarts: int = 0


class RuntimeService:
    """The CRI surface the kubelet drives (subset with the lifecycle verbs
    the sync loop needs)."""

    # sandboxes
    def run_pod_sandbox(self, pod_uid: str, name: str, namespace: str,
                        labels: Optional[Dict[str, str]] = None) -> str:
        raise NotImplementedError

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        raise NotImplementedError

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        raise NotImplementedError

    def list_pod_sandboxes(self) -> List[PodSandbox]:
        raise NotImplementedError

    # containers
    def create_container(self, sandbox_id: str, name: str, image: str) -> str:
        raise NotImplementedError

    def start_container(self, container_id: str) -> None:
        raise NotImplementedError

    def stop_container(self, container_id: str, timeout_s: float = 30.0) -> None:
        raise NotImplementedError

    def remove_container(self, container_id: str) -> None:
        raise NotImplementedError

    def list_containers(self, sandbox_id: Optional[str] = None) -> List[ContainerStatus]:
        raise NotImplementedError

    def container_status(self, container_id: str) -> Optional[ContainerStatus]:
        raise NotImplementedError

    def exec_sync(self, container_id: str, payload) -> int:
        """Run a lifecycle hook / probe command in the container
        (CRI ExecSync); returns the exit code."""
        raise NotImplementedError

    def container_logs(self, container_id: str) -> List[str]:
        """The container's log lines (the kubelet serves these through
        the pods/log subresource)."""
        raise NotImplementedError


class ImageService:
    def pull_image(self, image: str) -> None:
        raise NotImplementedError

    def list_images(self) -> List[str]:
        raise NotImplementedError


class FakeRuntime(RuntimeService, ImageService):
    """In-memory CRI with correct state-machine bookkeeping.

    ``exit_after``: image name → seconds until the container exits 0
    (models batch workloads); containers of other images run until
    stopped. ``fail_images``: images whose containers exit nonzero
    immediately after start (models crash loops).
    """

    def __init__(self, exit_after: Optional[Dict[str, float]] = None,
                 fail_images: Optional[set] = None,
                 pod_ip_prefix: str = "10.88.0."):
        self._lock = threading.RLock()
        self._sandboxes: Dict[str, PodSandbox] = {}
        self._containers: Dict[str, ContainerStatus] = {}
        self._images: set = set()
        self.exit_after = dict(exit_after or {})
        self.fail_images = set(fail_images or ())
        self._ip_prefix = pod_ip_prefix
        self._ip_counter = itertools.count(2)
        # ExecSync record: (container id, payload) per lifecycle
        # hook/probe invocation — the observable the hook tests assert
        self.exec_records: List[tuple] = []
        # synthetic per-container log streams (kubectl logs parity):
        # lifecycle transitions append lines like a real runtime's
        # stdout capture
        self._logs: Dict[str, List[str]] = {}

    # -- sandboxes -----------------------------------------------------
    def run_pod_sandbox(self, pod_uid, name, namespace, labels=None) -> str:
        with self._lock:
            sid = f"sb-{next(_id_counter)}"
            self._sandboxes[sid] = PodSandbox(
                id=sid, pod_uid=pod_uid, name=name, namespace=namespace,
                ip=f"{self._ip_prefix}{next(self._ip_counter)}",
                labels=dict(labels or {}),
            )
            return sid

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            if sb is None:
                return
            sb.state = SANDBOX_NOTREADY
            for c in self._containers.values():
                if c.sandbox_id == sandbox_id and c.state == RUNNING:
                    c.state = EXITED
                    c.exit_code = 137
                    c.finished_at = time.time()

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            if sb is not None and sb.state == SANDBOX_READY:
                raise RuntimeError(f"sandbox {sandbox_id} is still ready; stop first")
            self._sandboxes.pop(sandbox_id, None)
            self._containers = {
                cid: c for cid, c in self._containers.items()
                if c.sandbox_id != sandbox_id
            }

    def list_pod_sandboxes(self) -> List[PodSandbox]:
        with self._lock:
            return list(self._sandboxes.values())

    def sandbox_ip(self, sandbox_id: str) -> str:
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            return sb.ip if sb else ""

    # -- containers ----------------------------------------------------
    def create_container(self, sandbox_id: str, name: str, image: str) -> str:
        with self._lock:
            if sandbox_id not in self._sandboxes:
                raise KeyError(f"no sandbox {sandbox_id}")
            self.pull_image(image)
            cid = f"c-{next(_id_counter)}"
            self._containers[cid] = ContainerStatus(
                id=cid, sandbox_id=sandbox_id, name=name, image=image
            )
            return cid

    def _log(self, container_id: str, line: str) -> None:
        self._logs.setdefault(container_id, []).append(
            f"{time.strftime('%Y-%m-%dT%H:%M:%S')} {line}"
        )

    def start_container(self, container_id: str) -> None:
        with self._lock:
            c = self._require(container_id)
            if c.state not in (CREATED, EXITED):
                raise RuntimeError(f"container {container_id} is {c.state}")
            if c.state == EXITED:
                c.restarts += 1
            c.state = RUNNING
            c.started_at = time.time()
            c.exit_code = None
            self._log(container_id,
                      f"container started image={c.image} "
                      f"restarts={c.restarts}")
            if c.image in self.fail_images:
                c.state = EXITED
                c.exit_code = 1
                c.finished_at = time.time()
                self._log(container_id, "container exited code=1")

    def stop_container(self, container_id: str, timeout_s: float = 30.0) -> None:
        with self._lock:
            c = self._containers.get(container_id)
            if c is None or c.state != RUNNING:
                return
            c.state = EXITED
            c.exit_code = 137
            c.finished_at = time.time()
            self._log(container_id,
                      f"container stopped (grace {timeout_s:g}s) code=137")

    def remove_container(self, container_id: str) -> None:
        with self._lock:
            c = self._containers.get(container_id)
            if c is not None and c.state == RUNNING:
                raise RuntimeError(f"container {container_id} is running")
            self._containers.pop(container_id, None)

    def list_containers(self, sandbox_id=None) -> List[ContainerStatus]:
        with self._lock:
            self._tick()
            return [
                c for c in self._containers.values()
                if sandbox_id is None or c.sandbox_id == sandbox_id
            ]

    def container_status(self, container_id: str) -> Optional[ContainerStatus]:
        with self._lock:
            self._tick()
            return self._containers.get(container_id)

    def _require(self, container_id: str) -> ContainerStatus:
        c = self._containers.get(container_id)
        if c is None:
            raise KeyError(f"no container {container_id}")
        return c

    def _tick(self) -> None:
        """Advance modeled batch containers to EXITED(0) past their
        deadline."""
        now = time.time()
        for c in self._containers.values():
            if c.state != RUNNING:
                continue
            ttl = self.exit_after.get(c.image)
            if ttl is not None and now - c.started_at >= ttl:
                c.state = EXITED
                c.exit_code = 0
                c.finished_at = now

    def exec_sync(self, container_id: str, payload) -> int:
        with self._lock:
            c = self._containers.get(container_id)
            if c is None or c.state != RUNNING:
                return 1   # nothing to exec into
            self.exec_records.append((container_id, payload))
            self._log(container_id, f"exec: {payload!r}")
            return 0

    def container_logs(self, container_id: str) -> List[str]:
        with self._lock:
            return list(self._logs.get(container_id, ()))

    def serve_port(self, sandbox_id: str, port: int,
                   data: bytes) -> bytes:
        """Fake application endpoint for port-forward: a deterministic
        echo naming the sandbox and port (the reference forwards to the
        real container socket; the fake CRI answers for it)."""
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            if sb is None:
                raise LookupError(f"sandbox {sandbox_id!r} not found")
            name = sb.name
        return (f"pod {name} port {port} echo: ".encode() + data)

    # -- images --------------------------------------------------------
    def pull_image(self, image: str) -> None:
        with self._lock:
            self._images.add(image)

    def list_images(self) -> List[str]:
        with self._lock:
            return sorted(self._images)
