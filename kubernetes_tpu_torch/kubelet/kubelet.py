"""Kubelet: the node agent.

Behavioral equivalent of the reference's kubelet core
(``pkg/kubelet/kubelet.go:1837 syncLoop`` → ``:1911 syncLoopIteration``):
register the node, heartbeat its lease, watch pods bound to this node, and
reconcile each pod against the container runtime through CRI — sandbox up,
containers created/started, restarts per policy, probes driving readiness
and liveness restarts, status written back through the pod status
subresource. Subsystems mirrored: pod workers (``pod_workers.go``), status
manager (``status/status_manager.go``), prober manager, volume manager
(mount bookkeeping — ``volumemanager/volume_manager.go``), device manager
with checkpointed allocations, and a checkpoint manager for local state.

There are no real containers behind ``FakeRuntime`` — matching the hollow
kubelet used for scale tests (``pkg/kubemark/hollow_kubelet.go``); any real
runtime plugs in via the same ``RuntimeService``.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import (
    FAILED,
    RUNNING,
    SUCCEEDED,
    Node,
    Pod,
    PodCondition,
)
from kubernetes_tpu_torch.apiserver.store import ADDED, DELETED, MODIFIED, ClusterStore, Event
from kubernetes_tpu_torch.kubelet.cri import (
    EXITED,
    RUNNING as CRI_RUNNING,
    FakeRuntime,
    RuntimeService,
)
from kubernetes_tpu_torch.kubelet.devicemanager import DeviceManager, TPU_RESOURCE
from kubernetes_tpu_torch.kubelet.probes import LIVENESS, ProbeManager
from kubernetes_tpu_torch.testing.wrappers import MakeNode

_logger = logging.getLogger(__name__)


class Kubelet:
    sync_interval = 0.2  # housekeeping tick (reference 1s; scaled down)

    def __init__(
        self,
        store: ClusterStore,
        node_name: str,
        capacity: Optional[Dict[str, str]] = None,
        runtime: Optional[RuntimeService] = None,
        device_manager: Optional[DeviceManager] = None,
        labels: Optional[Dict[str, str]] = None,
        heartbeat_fn=None,
        static_pod_manifests: Optional[List[dict]] = None,
    ):
        self.store = store
        self.node_name = node_name
        self.capacity = dict(capacity or {"cpu": "8", "memory": "16Gi", "pods": "110"})
        self.labels = dict(labels or {})
        self.runtime = runtime if runtime is not None else FakeRuntime()
        self.devices = device_manager or DeviceManager()
        # volume manager: desired/actual-state-of-world reconciler
        # (reference volumemanager/volume_manager.go:247); container
        # start gates on its WaitForAttachAndMount analog
        from kubernetes_tpu_torch.kubelet.volumemanager import VolumeManager

        self.volumes = VolumeManager(store, node_name)
        self.probes = ProbeManager()
        self.heartbeat_fn = heartbeat_fn  # optional NodeLifecycle hookup
        # container manager: QoS tiers + pod cgroups + node-allocatable
        # admission (reference cm/container_manager_linux.go:210)
        from kubernetes_tpu_torch.api.resource import parse_quantity
        from kubernetes_tpu_torch.kubelet.cm import ContainerManager

        self.container_manager = ContainerManager(
            capacity_cpu_milli=int(parse_quantity(
                self.capacity.get("cpu", "0")).milli_value()),
            capacity_memory=int(parse_quantity(
                self.capacity.get("memory", "0")).value()),
        )
        # PLEG: runtime relist → lifecycle events → dirty pods
        # (reference pleg/generic.go:110; driven from the sync loop like
        # syncLoopIteration's plegCh branch)
        from kubernetes_tpu_torch.kubelet.pleg import PLEG

        self.pleg = PLEG(self.runtime, self._on_pleg_event)
        # optional node-pressure eviction (kubelet/eviction.py); attach
        # an EvictionManager and housekeeping drives synchronize()
        self.eviction_manager = None
        # optional image GC (kubelet/imagegc.py); housekeeping drives
        # maybe_garbage_collect()
        self.image_gc_manager = None
        # static pods (reference pkg/kubelet/config/file.go: the
        # /etc/kubernetes/manifests source): run directly from local
        # manifests, never scheduled; each gets a MIRROR pod in the API
        # so the control plane can observe it (pkg/kubelet/pod/
        # mirror_client.go). The manifest set is fixed for this
        # kubelet's lifetime.
        self._static_manifests = list(static_pod_manifests or [])
        self._static_pods: Dict[str, Pod] = {}   # uid -> local truth
        # init-phase tracking: uid -> index of the RUNNING init
        # container (absent = init phase done or no init containers),
        # and the created init container ids for teardown
        self._init_progress: Dict[str, int] = {}
        self._init_cids: Dict[str, List[str]] = {}
        # graceful termination (reference pod_workers terminating state
        # + kuberuntime_container killContainer): per pod, the grace
        # period and preStop hooks captured at start; uid -> force-kill
        # deadline while draining
        self._graceful: Dict[str, tuple] = {}
        self._terminating: Dict[str, float] = {}
        self._sandbox_of: Dict[str, str] = {}  # pod uid -> sandbox id
        self._containers_of: Dict[str, Dict[str, str]] = {}  # uid -> {name: cid}
        self._terminal: set = set()  # uids already reported Succeeded/Failed
        self._key_of: Dict[str, tuple] = {}  # uid -> (namespace, name)
        self._work = threading.Event()
        self._stop = threading.Event()
        self._dirty: set = set()  # pod uids needing sync
        self._dirty_lock = threading.Lock()
        self._watch_handle = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    def register_node(self) -> Node:
        """Create/refresh this node's API object, folding device-plugin
        capacity into extended resources (reference
        ``kubelet_node_status.go`` setNodeStatus)."""
        capacity = dict(self.capacity)
        for res, count in self.devices.capacity().items():
            capacity[res] = str(count)
        builder = MakeNode().name(self.node_name).capacity(capacity)
        for k, v in self.labels.items():
            builder = builder.label(k, v)
        node = builder.obj()
        existing = self.store.get_node(self.node_name)
        if existing is not None:
            node.metadata.uid = existing.metadata.uid
        self.store.add_node(node)
        return node

    def start(self) -> "Kubelet":
        self.register_node()
        self.heartbeat()
        self._adopt_runtime_state()
        self._load_static_pods()
        # watch pod events for this node; initial list picks up existing
        for pod in self.store.list_pods():
            if pod.spec.node_name == self.node_name:
                self._key_of[pod.uid] = (pod.namespace, pod.name)
                self._mark_dirty(pod.uid)
        self._watch_handle = self.store.watch(self._on_events)
        # pods/log provider (the apiserver proxies log requests to the
        # node's kubelet; this registry is that connection in-process).
        # A REST-backed store (kubemark hollow nodes over the fabric)
        # has no in-process registration surface — the proxy dial the
        # registry stands in for doesn't exist over plain HTTP — so the
        # providers are simply not offered there.
        if hasattr(self.store, "register_log_source"):
            self.store.register_log_source(self.node_name,
                                           self.container_logs)
            self.store.register_exec_source(self.node_name,
                                            self.container_exec)
            self.store.register_portforward_source(self.node_name,
                                                   self.forward_port)
        self._thread = threading.Thread(
            target=self._sync_loop, daemon=True, name=f"kubelet-{self.node_name}"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if hasattr(self.store, "unregister_log_source"):
            self.store.unregister_log_source(self.node_name)
            self.store.unregister_exec_source(self.node_name)
            self.store.unregister_portforward_source(self.node_name)
        if self._watch_handle is not None:
            self._watch_handle.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def container_logs(self, namespace: str, name: str,
                       container: str = "") -> str:
        """Log text for a pod on this node (kubectl logs; reference
        kubelet server's /containerLogs endpoint → CRI log files).
        Multi-container pods require ``container`` like real kubectl;
        init container logs resolve by name too. Raises LookupError for
        an unknown pod/container — the REST layer turns it into a
        client error, never silent-empty success. Called from apiserver
        handler threads: every kubelet map is read through a C-level
        dict/list copy (atomic under the GIL) so the sync loop's
        concurrent mutations cannot blow up the iteration."""
        key_of = dict(self._key_of)
        uid = next(
            (u for u, key in key_of.items()
             if key == (namespace, name)), None,
        )
        if uid is None:
            raise LookupError(
                f"pod {namespace}/{name} is not running on this node"
            )
        cids = dict(self._containers_of.get(uid, {}))
        init_cids = list(self._init_cids.get(uid, ()))
        if init_cids:
            pod = self._static_pods.get(uid) or self._find_pod(uid)
            if pod is not None:
                for i, cid in enumerate(init_cids):
                    if i < len(pod.spec.init_containers):
                        cids.setdefault(
                            pod.spec.init_containers[i].name, cid)
        if container:
            if container not in cids:
                raise LookupError(
                    f"container {container!r} is not valid for pod "
                    f"{name} (containers: {sorted(cids) or 'none'})"
                )
            chosen = {container: cids[container]}
        elif len(cids) == 1:
            chosen = cids
        else:
            raise LookupError(
                "a container name must be specified for pod "
                f"{name} (choose one of {sorted(cids)})"
            )
        lines: List[str] = []
        for cname, cid in sorted(chosen.items()):
            try:
                lines.extend(self.runtime.container_logs(cid))
            except Exception:  # noqa: BLE001 — runtime without logs
                pass
        return "\n".join(lines) + ("\n" if lines else "")

    def forward_port(self, namespace: str, name: str, port: int,
                     data: bytes) -> bytes:
        """Exchange one payload with a pod's port (kubectl
        port-forward; reference kubelet server /portForward → CRI).
        Raises LookupError for an unknown pod — the REST layer's 400."""
        key_of = dict(self._key_of)
        uid = next(
            (u for u, key in key_of.items()
             if key == (namespace, name)), None,
        )
        if uid is None or uid not in self._sandbox_of:
            raise LookupError(
                f"pod {namespace}/{name} is not running on this node"
            )
        return self.runtime.serve_port(self._sandbox_of[uid], port, data)

    def container_exec(self, namespace: str, name: str, container: str,
                       command: List[str]) -> tuple:
        """Run a command in a pod's container (kubectl exec; reference
        kubelet server /exec → CRI ExecSync). Returns (exit code,
        output text). Resolution mirrors ``container_logs``: unknown
        pod/container raises LookupError for the REST layer's 400."""
        key_of = dict(self._key_of)
        uid = next(
            (u for u, key in key_of.items()
             if key == (namespace, name)), None,
        )
        if uid is None:
            raise LookupError(
                f"pod {namespace}/{name} is not running on this node"
            )
        cids = dict(self._containers_of.get(uid, {}))
        if container:
            if container not in cids:
                raise LookupError(
                    f"container {container!r} is not valid for pod "
                    f"{name} (containers: {sorted(cids) or 'none'})"
                )
            cid = cids[container]
        elif len(cids) == 1:
            cid = next(iter(cids.values()))
        else:
            raise LookupError(
                "a container name must be specified for pod "
                f"{name} (choose one of {sorted(cids)})"
            )
        before = []
        try:
            before = list(self.runtime.container_logs(cid))
        except Exception:  # noqa: BLE001
            pass
        rc = self.runtime.exec_sync(cid, list(command))
        # the fake CRI records exec output on the container's log
        # stream; the delta is this exec's "stdout"
        after = []
        try:
            after = list(self.runtime.container_logs(cid))
        except Exception:  # noqa: BLE001
            pass
        out = "\n".join(after[len(before):])
        return rc, out + ("\n" if out else "")

    # -- event plumbing ------------------------------------------------
    def _on_events(self, events: List[Event]) -> None:
        for event in events:
            self._on_event(event)

    def _on_event(self, event: Event) -> None:
        if event.kind != "Pod":
            return
        pod: Pod = event.obj
        mine = pod.spec.node_name == self.node_name
        was_mine = (
            event.old_obj is not None
            and getattr(event.old_obj.spec, "node_name", "") == self.node_name
        )
        if mine or was_mine or event.type == DELETED and pod.uid in self._sandbox_of:
            if event.type != DELETED:
                self._key_of[pod.uid] = (pod.namespace, pod.name)
            self._mark_dirty(pod.uid)

    def _mark_dirty(self, uid: str) -> None:
        with self._dirty_lock:
            self._dirty.add(uid)
        self._work.set()

    def _on_pleg_event(self, event) -> None:
        """PLEG sink: a container state delta re-syncs its pod (the
        reference's syncLoopIteration plegCh → HandlePodSyncs)."""
        self._mark_dirty(event.pod_uid)

    def _sync_loop(self) -> None:
        while not self._stop.is_set():
            self._work.wait(timeout=self.sync_interval)
            self._work.clear()
            with self._dirty_lock:
                dirty, self._dirty = self._dirty, set()
            known = set(self._sandbox_of)
            for uid in dirty | known:
                try:
                    self.sync_pod(uid)
                except Exception:
                    _logger.exception("sync_pod %s", uid)
            try:
                # runtime-truth pass: container crashes/exits surface
                # here even when no API event fired
                self.pleg.relist()
            except Exception:
                _logger.exception("pleg relist")
            try:
                # volume reconciler pass (reference reconciler.go:77
                # runs every 100ms): an attach landing re-syncs the
                # pods it unblocks so their containers start
                for uid in self.volumes.reconcile():
                    self._mark_dirty(uid)
            except Exception:
                _logger.exception("volume reconcile")
            self.probes.tick()
            if self.eviction_manager is not None:
                try:
                    self.eviction_manager.synchronize()
                except Exception:
                    _logger.exception("eviction synchronize")
            if self.image_gc_manager is not None:
                try:
                    self.image_gc_manager.maybe_garbage_collect()
                except Exception:
                    _logger.exception("image gc")
            self.heartbeat()

    def heartbeat(self) -> None:
        if self.heartbeat_fn is not None:
            self.heartbeat_fn(self.node_name)
        else:
            from kubernetes_tpu_torch.utils.clock import RealClock

            self.store.try_acquire_or_renew(
                f"node-{self.node_name}", self.node_name, RealClock().now(), 40.0
            )

    def _adopt_runtime_state(self) -> None:
        """Rebuild the sandbox/container maps from the runtime's live
        truth before any sync runs — a restarted kubelet over a
        persistent runtime must ADOPT running workloads, never start a
        second copy (the reference's startup reconciliation against the
        CRI: kubelet.go HandlePodCleanups / pod-worker resurrection
        from the runtime cache)."""
        from kubernetes_tpu_torch.kubelet.cri import SANDBOX_READY

        try:
            sandboxes = self.runtime.list_pod_sandboxes()
            containers = self.runtime.list_containers()
        except Exception:
            _logger.exception("runtime-state adoption failed")
            return
        by_sandbox: Dict[str, list] = {}
        for c in containers:
            by_sandbox.setdefault(c.sandbox_id, []).append(c)
        for sb in sandboxes:
            if sb.state != SANDBOX_READY:
                continue
            self._sandbox_of[sb.pod_uid] = sb.id
            self._containers_of[sb.pod_uid] = {
                c.name: c.id for c in by_sandbox.get(sb.id, ())
            }
            self._key_of.setdefault(sb.pod_uid, (sb.namespace, sb.name))
            self._mark_dirty(sb.pod_uid)

    # -- static / mirror pods ------------------------------------------
    MIRROR_ANNOTATION = "kubernetes.io/config.mirror"

    def _load_static_pods(self) -> None:
        for manifest in self._static_manifests:
            try:
                pod = Pod.from_dict(manifest)
            except Exception:
                _logger.exception("bad static pod manifest; skipped")
                continue
            if not pod.metadata.namespace:
                pod.metadata.namespace = "kube-system"
            # per-node name suffix (reference kubelet config/common.go
            # applyDefaults): two kubelets loading the same manifest
            # must not fight over one (namespace, name) mirror slot
            pod.metadata.name = f"{pod.metadata.name}-{self.node_name}"
            pod.spec.node_name = self.node_name
            # STABLE identity across kubelet restarts (the reference
            # hashes the manifest source): a fresh random uid per start
            # would make a surviving mirror look like a different pod
            # and double-start the workload
            pod.metadata.uid = (
                f"static-{self.node_name}-{pod.namespace}-"
                f"{pod.metadata.name}"
            )
            # the mirror annotation (kubernetes.io/config.mirror) is the
            # reference's config hash; the uid stands in for it — and it
            # is what NodeRestriction admission keys its mirror-pod
            # carve-out on
            pod.metadata.annotations.setdefault(
                self.MIRROR_ANNOTATION, pod.uid)
            self._static_pods[pod.uid] = pod
            self._key_of[pod.uid] = (pod.namespace, pod.name)
            self._mark_dirty(pod.uid)

    def _ensure_mirror(self, pod: Pod) -> bool:
        """Create (or recreate) the API mirror of a static pod — the
        control plane's read-only view; deleting it never stops the
        static pod, the kubelet just republishes (mirror_client.go
        CreateMirrorPod semantics). A DIFFERENT pod's mirror squatting
        the name (stale incarnation) is deleted and replaced, like the
        reference's hash-mismatch path; an unrelated NON-mirror pod
        blocks publication — returns False so the caller suppresses
        API status writes that would clobber the impostor by name."""
        existing = self.store.get_pod(pod.namespace, pod.name)
        if existing is not None:
            if existing.uid == pod.uid:
                return True
            if self.MIRROR_ANNOTATION in existing.metadata.annotations:
                self.store.delete_pod(pod.namespace, pod.name)
            else:
                _logger.warning(
                    "pod %s exists and is not this kubelet's mirror; "
                    "static pod runs unpublished", pod.full_name(),
                )
                return False
        from kubernetes_tpu_torch.api.types import shallow_copy

        mirror = shallow_copy(pod)
        mirror.metadata = shallow_copy(pod.metadata)
        mirror.metadata.resource_version = ""
        mirror.status = shallow_copy(pod.status)
        if pod.uid in self._sandbox_of:
            # a republished mirror of an already-running static pod
            # must not read as Pending
            mirror.status.phase = RUNNING
        try:
            self.store.create_pod(mirror)
        except Exception:
            _logger.exception("mirror pod create failed: %s",
                              pod.full_name())
        return True

    # -- pod reconciliation --------------------------------------------
    def _find_pod(self, uid: str) -> Optional[Pod]:
        key = self._key_of.get(uid)
        if key is None:
            return None
        pod = self.store.get_pod(*key)
        # names are reusable; make sure this is still the same pod
        return pod if pod is not None and pod.uid == uid else None

    def sync_pod(self, uid: str) -> None:
        static = self._static_pods.get(uid)
        if static is not None:
            # local manifests are the source of truth: republish the
            # mirror if it was deleted, and keep the containers running
            # (even unpublished — the reference kubelet runs static
            # pods with the API entirely down)
            publish = self._ensure_mirror(static)
            if uid in self._terminal:
                return
            if self._sandbox_of.get(uid) is None:
                self._admit_and_start(static, publish=publish)
            else:
                self._reconcile_containers(static, publish=publish)
            return
        pod = self._find_pod(uid)
        if pod is None or pod.spec.node_name != self.node_name:
            self._teardown(uid)
            return
        if uid in self._terminal:
            return
        sandbox = self._sandbox_of.get(uid)
        if sandbox is None:
            self._admit_and_start(pod)
            return
        self._reconcile_containers(pod)

    def _admit_and_start(self, pod: Pod, publish: bool = True) -> None:
        # publish=False (an impostor pod owns the static pod's name):
        # run the containers, write nothing to the API by name
        # node-allocatable admission (cm enforcement): a pod the
        # scheduler raced past this node's allocatable fails here with
        # an OutOf* reason, like the reference kubelet's admit handlers
        reason = self.container_manager.admit(pod)
        if reason is not None:
            if publish:
                self.store.set_pod_phase(pod.namespace, pod.name, FAILED)
            self._terminal.add(pod.uid)
            _logger.warning("pod %s rejected: %s", pod.full_name(), reason)
            return
        # device admission next: unsatisfiable extended resources fail the
        # pod rather than half-starting it. A checkpointed assignment from
        # a previous kubelet incarnation satisfies admission as-is — that
        # is the whole point of the device checkpoint.
        try:
            if not self.devices.devices_of(pod.uid):
                for c in pod.spec.containers:
                    for res, qty in c.resources.requests.items():
                        if res == TPU_RESOURCE:
                            self.devices.allocate(pod.uid, c.name, res, qty.value())
        except Exception as e:
            # roll back devices granted to earlier containers of this pod
            self.devices.free(pod.uid)
            if publish:
                self.store.set_pod_phase(pod.namespace, pod.name, FAILED)
            self._terminal.add(pod.uid)
            _logger.warning("pod %s admission failed: %s", pod.full_name(), e)
            return
        # volume gate (reference WaitForAttachAndMount,
        # volume_manager.go:387): containers must not start before every
        # volume is mounted — claim-backed ones wait for the attachdetach
        # controller's volumesAttached handshake. The reconciler re-syncs
        # this pod when its volumes land; until then it stays Pending.
        self.volumes.add_pod(pod)
        # reconcile returns ONE-SHOT newly-ready notifications; any pod
        # they name (not just this one) must be re-synced or it strands
        # Pending — this call may consume the notification the sync
        # loop's own reconcile would otherwise have delivered
        for uid in self.volumes.reconcile():
            if uid != pod.uid:
                self._mark_dirty(uid)
        if not self.volumes.volumes_ready(pod):
            return
        # pod cgroup under its QoS tier (podContainerManager
        # EnsureExists before the sandbox starts)
        self.container_manager.create_pod_cgroup(pod)
        sid = self.runtime.run_pod_sandbox(pod.uid, pod.name, pod.namespace)
        self._sandbox_of[pod.uid] = sid
        if pod.spec.init_containers:
            # init phase (reference kuberuntime_manager.go
            # computePodActions: init containers run ONE at a time, each
            # to successful completion, before any app container starts)
            self._containers_of[pod.uid] = {}
            self._init_progress[pod.uid] = 0
            self._init_cids[pod.uid] = []
            if publish:
                self.store.patch_pod_condition(
                    pod.namespace, pod.name,
                    PodCondition("Initialized", "False",
                                 "ContainersNotInitialized", ""),
                )
            self._start_next_init(pod)
            return
        self._start_main_containers(pod, publish)

    def _start_next_init(self, pod: Pod) -> None:
        idx = self._init_progress[pod.uid]
        ic = pod.spec.init_containers[idx]
        sid = self._sandbox_of[pod.uid]
        cid = self.runtime.create_container(sid, ic.name, ic.image)
        self.runtime.start_container(cid)
        self._init_cids[pod.uid].append(cid)

    def _drive_init(self, pod: Pod, publish: bool) -> None:
        """One init-phase step: advance past completed init containers,
        restart failed ones per policy (the reference restarts a failed
        init container unless restartPolicy is Never, in which case the
        pod fails: kuberuntime_manager.go + pod_workers)."""
        uid = pod.uid
        cid = self._init_cids[uid][-1]
        st = self.runtime.container_status(cid)
        if st is None or st.state != EXITED:
            return                       # still running
        if st.exit_code == 0:
            nxt = self._init_progress[uid] + 1
            if nxt < len(pod.spec.init_containers):
                self._init_progress[uid] = nxt
                self._start_next_init(pod)
                return
            # init phase complete: app containers start now
            del self._init_progress[uid]
            if publish:
                self.store.patch_pod_condition(
                    pod.namespace, pod.name,
                    PodCondition("Initialized", "True", "", ""),
                )
            self._start_main_containers(pod, publish)
            return
        policy = getattr(pod.spec, "restart_policy", "Always")
        if policy == "Never":
            self._finish(pod, FAILED, publish=publish)
        else:
            self.runtime.start_container(cid)   # retry the failed init

    def _rebuild_init_state(self, pod: Pod) -> None:
        """Reconstruct _init_progress/_init_cids for a pod adopted from
        a persistent runtime mid-init (the reference re-derives pod
        actions from the runtime status every sync, so a restart cannot
        confuse init and app containers)."""
        uid = pod.uid
        cids = self._containers_of.get(uid, {})
        init_cids: List[str] = []
        pending_idx: Optional[int] = None
        for i, ic in enumerate(pod.spec.init_containers):
            cid = cids.get(ic.name)
            if cid is None:
                pending_idx = i       # this init was never created
                break
            init_cids.append(cid)
            st = self.runtime.container_status(cid)
            if st is None or st.state != EXITED or st.exit_code != 0:
                pending_idx = i       # running or failed: drive it
                break
        # app containers keep only their OWN entries
        self._containers_of[uid] = {
            c.name: cids[c.name]
            for c in pod.spec.containers if c.name in cids
        }
        if pending_idx is None:
            # init phase completed pre-restart; mains the crash window
            # swallowed (restart between init-done and app-start) are
            # created now, existing ones adopted as-is
            sid = self._sandbox_of[uid]
            for c in pod.spec.containers:
                if c.name not in self._containers_of[uid]:
                    cid = self.runtime.create_container(sid, c.name,
                                                        c.image)
                    self.runtime.start_container(cid)
                    self._run_post_start(c, cid)
                    self._containers_of[uid][c.name] = cid
            return
        self._init_progress[uid] = pending_idx
        self._init_cids[uid] = init_cids
        if len(init_cids) <= pending_idx:
            self._start_next_init(pod)

    def _capture_graceful(self, pod: Pod) -> None:
        """Record the pod's termination contract (grace period + preStop
        hooks): the pod object may be GONE from the store by the time
        teardown needs it. Also called for ADOPTED pods (restart over a
        persistent runtime) — their contract must survive the restart."""
        grace = pod.spec.termination_grace_period_seconds
        self._graceful[pod.uid] = (
            30.0 if grace is None else float(grace),
            [(c.name, c.lifecycle["preStop"])
             for c in pod.spec.containers
             if c.lifecycle and c.lifecycle.get("preStop")],
        )

    def _run_post_start(self, c, cid: str) -> None:
        """postStart runs immediately after the container starts
        (lifecycle.go:52 — failures kill the container in the
        reference; here best-effort, recorded by the runtime)."""
        if c.lifecycle and c.lifecycle.get("postStart"):
            try:
                self.runtime.exec_sync(cid, c.lifecycle["postStart"])
            except Exception:  # noqa: BLE001
                _logger.exception("postStart hook failed: %s", c.name)

    def _start_main_containers(self, pod: Pod, publish: bool) -> None:
        sid = self._sandbox_of[pod.uid]
        cids = {}
        self._capture_graceful(pod)
        for c in pod.spec.containers:
            cid = self.runtime.create_container(sid, c.name, c.image)
            self.runtime.start_container(cid)
            cids[c.name] = cid
            self._run_post_start(c, cid)
            # image sighting feeds the GC manager's LRU order
            if self.image_gc_manager is not None and c.image:
                self.image_gc_manager.note_image_used(c.image)
        self._containers_of[pod.uid] = cids
        ip = getattr(self.runtime, "sandbox_ip", lambda s: "")(sid)
        if publish:
            self.store.set_pod_phase(pod.namespace, pod.name, RUNNING,
                                     pod_ip=ip, host_ip=self.node_name)
            self._set_ready_condition(pod, True)

    def _reconcile_containers(self, pod: Pod, publish: bool = True) -> None:
        if pod.uid not in self._graceful:
            # adopted pod (kubelet restart): re-derive the termination
            # contract the old incarnation captured at start
            self._capture_graceful(pod)
        if pod.spec.init_containers and \
                pod.uid not in self._init_progress and any(
                    ic.name in self._containers_of.get(pod.uid, {})
                    for ic in pod.spec.init_containers):
            # adopted pod (restart over a persistent runtime): the
            # normal flow never maps init containers into
            # _containers_of, so their presence means the init-phase
            # bookkeeping must be re-derived from runtime truth
            self._rebuild_init_state(pod)
        if pod.uid in self._init_progress:
            self._drive_init(pod, publish)
            return
        cids = self._containers_of.get(pod.uid, {})
        statuses = {
            name: self.runtime.container_status(cid) for name, cid in cids.items()
        }
        # liveness restarts
        for cname, failing in self.probes.liveness_failed(pod.uid).items():
            if failing and cname in cids:
                st = statuses.get(cname)
                if st is not None and st.state == CRI_RUNNING:
                    self.runtime.stop_container(cids[cname])
                    statuses[cname] = self.runtime.container_status(cids[cname])
        states = [s.state for s in statuses.values() if s is not None]
        exit_codes = [
            s.exit_code for s in statuses.values() if s is not None and s.state == EXITED
        ]
        policy = getattr(pod.spec, "restart_policy", "Always")
        if states and all(s == EXITED for s in states):
            if all(code == 0 for code in exit_codes):
                if policy in ("Never", "OnFailure"):
                    self._finish(pod, SUCCEEDED, publish=publish)
                    return
            elif policy == "Never":
                self._finish(pod, FAILED, publish=publish)
                return
        # restart what policy says should run
        for name, st in statuses.items():
            if st is None or st.state != EXITED:
                continue
            if policy == "Always" or (policy == "OnFailure" and st.exit_code != 0):
                self.runtime.start_container(cids[name])
        if publish:
            self._set_ready_condition(pod, self.probes.pod_ready(pod.uid))

    def _finish(self, pod: Pod, phase: str, publish: bool = True) -> None:
        if publish:
            self.store.set_pod_phase(pod.namespace, pod.name, phase)
        self._terminal.add(pod.uid)
        self._release(pod.uid)

    def _teardown(self, uid: str) -> None:
        """Pod deleted or moved away: GRACEFUL termination (reference
        pod_workers terminating state): preStop hooks run, containers
        get a stop with the pod's grace period to drain, and only when
        every container exited — or the force-kill deadline passed —
        does the sandbox release. _release is idempotent and must run
        even without a sandbox — admission-failed pods can still hold
        device/volume state."""
        import time as _time

        cids = self._containers_of.get(uid, {})
        if uid in self._sandbox_of and uid not in self._terminating \
                and cids:
            grace, hooks = self._graceful.get(uid, (0.0, []))
            for cname, payload in hooks:
                cid = cids.get(cname)
                if cid is not None:
                    try:
                        self.runtime.exec_sync(cid, payload)
                    except Exception:  # noqa: BLE001 — hooks are best-effort
                        _logger.exception("preStop hook failed: %s", cname)
            for cid in cids.values():
                st = self.runtime.container_status(cid)
                if st is not None and st.state == CRI_RUNNING:
                    try:
                        self.runtime.stop_container(cid, timeout_s=grace)
                    except TypeError:
                        self.runtime.stop_container(cid)
                    except RuntimeError:
                        pass       # exited between status and stop
            self._terminating[uid] = _time.monotonic() + grace
            self._work.set()
        if uid in self._terminating:
            statuses = [self.runtime.container_status(c)
                        for c in cids.values()]
            drained = all(s is None or s.state == EXITED
                          for s in statuses)
            if not drained and _time.monotonic() < self._terminating[uid]:
                return             # grace window: containers draining
            del self._terminating[uid]
        self._release(uid)
        self._graceful.pop(uid, None)
        self._terminal.discard(uid)
        self._key_of.pop(uid, None)

    def _release(self, uid: str) -> None:
        sid = self._sandbox_of.pop(uid, None)
        if sid is not None:
            self.runtime.stop_pod_sandbox(sid)
            self.runtime.remove_pod_sandbox(sid)
        self._containers_of.pop(uid, None)
        self._init_progress.pop(uid, None)
        self._init_cids.pop(uid, None)
        self.devices.free(uid)
        # teardown ordering: the sandbox is stopped ABOVE, then the pod
        # leaves the volume manager's desired state; the reconcile
        # unmounts and shrinks volumesInUse, which is what finally lets
        # the attachdetach controller detach (never detach under a
        # running container)
        self.volumes.remove_pod(uid)
        for ready_uid in self.volumes.reconcile():
            self._mark_dirty(ready_uid)
        self.probes.remove_pod(uid)
        self.container_manager.delete_pod_cgroup(uid)

    def _set_ready_condition(self, pod: Pod, ready: bool) -> None:
        self.store.patch_pod_condition(
            pod.namespace,
            pod.name,
            PodCondition("Ready", "True" if ready else "False",
                         "ContainersReady" if ready else "ProbeFailure", ""),
        )

    # -- introspection --------------------------------------------------
    def running_pods(self) -> List[str]:
        return list(self._sandbox_of)
