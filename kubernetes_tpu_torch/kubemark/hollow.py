"""Kubemark: hollow nodes for cluster-scale testing without machines.

Behavioral equivalent of the reference's kubemark
(``pkg/kubemark/hollow_kubelet.go`` — a REAL kubelet against a fake CRI;
``hollow_proxy.go`` — a real proxier against a no-op dataplane;
``cmd/kubemark``): each hollow node runs the genuine node-agent code path
(sync loop, status manager, device manager) with the in-memory runtime, so
control-plane components — scheduler, controllers, node-lifecycle health
monitoring — see a full-size cluster that behaves like real nodes, at the
cost of one thread per node instead of one machine.

Two tiers, matching the reference's own split between hollow *kubelets*
and raw scale rigs:

- ``HollowNode``/``HollowCluster`` — full Kubelet per node. The
  ``store`` seam accepts either the in-process ``ClusterStore`` (the
  fast default for unit tests) or a ``RestClusterClient`` — hollow
  traffic then exercises authn, API Priority & Fairness, and the watch
  fabric exactly like real kubelets (node registration POSTs, lease
  renewals through the lease verb, status writes through
  pods/{name}/status).
- ``HollowFleet`` — the 10×-tier shape: N Node *objects* bulk-registered
  through the client plus ONE shared heartbeat thread renewing every
  node's lease, no per-node sync loops. 50k hollow kubelets as 50k
  Python threads would measure the GIL, not the control plane; the
  fleet keeps the API-visible behavior (registration, heartbeats,
  capacity) at O(1) threads. ``scheduler_perf`` semantics make this
  sound: a bound pod is a finished pod, so nothing needs to *run* it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.kubelet import DeviceManager, DevicePlugin, FakeRuntime, Kubelet
from kubernetes_tpu_torch.kubelet.devicemanager import TPU_RESOURCE
from kubernetes_tpu_torch.proxy import Proxier


def _store_is_local(store) -> bool:
    """In-process stores (bare or partitioned) list Endpoints; REST
    clients don't (and a proxier's rule table is meaningless over the
    wire)."""
    return hasattr(store, "list_endpoints")


class HollowNode:
    """A real Kubelet + real Proxier over fake infrastructure. ``store``
    may be a ClusterStore (in-process) or a RestClusterClient (the
    kubemark-over-REST deployment; the proxier is skipped there)."""

    def __init__(
        self,
        store: ClusterStore,
        name: str,
        capacity: Optional[Dict[str, str]] = None,
        tpu_chips: int = 0,
        labels: Optional[Dict[str, str]] = None,
        heartbeat_fn=None,
        pod_subnet: Optional[str] = None,
    ):
        dm = DeviceManager()
        if tpu_chips:
            dm.register(
                DevicePlugin(
                    TPU_RESOURCE,
                    [f"{name}-tpu{i}" for i in range(tpu_chips)],
                    topology={
                        f"{name}-tpu{i}": (i % 4, i // 4) for i in range(tpu_chips)
                    },
                )
            )
        # each node owns a distinct pod subnet (the node-ipam podCIDR
        # model) — without it pod IPs collide across nodes and Endpoints
        # silently dedupe
        self.kubelet = Kubelet(
            store,
            name,
            capacity=capacity,
            runtime=FakeRuntime(pod_ip_prefix=pod_subnet or "10.88.0."),
            device_manager=dm,
            labels=labels,
            heartbeat_fn=heartbeat_fn,
        )
        self.proxier = Proxier(store, node_name=name) \
            if _store_is_local(store) else None

    def start(self) -> "HollowNode":
        self.kubelet.start()
        if self.proxier is not None:
            self.proxier.start()
        return self

    def stop(self) -> None:
        self.kubelet.stop()
        if self.proxier is not None:
            self.proxier.stop()

    @property
    def name(self) -> str:
        return self.kubelet.node_name


class HollowCluster:
    """N hollow nodes against one store — the single-box analog of the
    reference's 5k-node kubemark rigs (``test/kubemark/``)."""

    def __init__(self, store: ClusterStore, heartbeat_fn=None):
        self.store = store
        self.nodes: List[HollowNode] = []
        self._heartbeat_fn = heartbeat_fn

    def start_nodes(
        self,
        count: int,
        capacity: Optional[Dict[str, str]] = None,
        tpu_chips: int = 0,
        zone_count: int = 3,
        name_prefix: str = "hollow",
        share_proxier: bool = True,
    ) -> List[HollowNode]:
        """Spin up count hollow nodes spread over zone_count zones.
        share_proxier: at scale, one rule table per node is redundant in a
        single process — only node 0 runs a proxier."""
        started = []
        base = len(self.nodes)
        for i in range(count):
            # global index: a second start_nodes call must not re-register
            # the first batch's node names or reuse their pod subnets
            idx = base + i
            node = HollowNode(
                self.store,
                f"{name_prefix}-{idx}",
                capacity=capacity,
                tpu_chips=tpu_chips,
                labels={
                    "topology.kubernetes.io/zone": f"zone-{idx % zone_count}",
                    "kubernetes.io/hostname": f"{name_prefix}-{idx}",
                },
                heartbeat_fn=self._heartbeat_fn,
                pod_subnet=f"10.{88 + idx // 256}.{idx % 256}.",
            )
            node.kubelet.start()
            if node.proxier is not None and (not share_proxier or idx == 0):
                node.proxier.start()
            started.append(node)
        self.nodes.extend(started)
        return started

    def stop(self) -> None:
        for node in self.nodes:
            node.stop()  # Proxier.stop is already a no-op if never started
        self.nodes.clear()


class HollowFleet:
    """The 10×-tier kubemark shape: N hollow Node objects registered in
    bulk through a (usually partition-aware REST) client, kept alive by
    ONE shared heartbeat thread renewing ``node-<name>`` leases in
    round-robin slices — the ``HeartbeatPump`` idea carried over the
    fabric. No kubelet sync loops: at 50k nodes those threads would
    measure the GIL, not the control plane."""

    def __init__(self, client, interval: float = 30.0,
                 lease_duration: float = 120.0,
                 beats_per_tick: Optional[int] = None):
        self.client = client
        self.interval = float(interval)
        self.lease_duration = float(lease_duration)
        # lease writes per tick. None (the default) auto-sizes so a
        # full rotation completes within HALF the lease duration — the
        # rotating slice de-synchronizes the herd, but a slice too
        # small to lap the fleet before leases expire would leave most
        # of a 50k-node tier perpetually NotReady (renewal rate must be
        # >= fleet_size / (lease_duration/2), not a fixed trickle)
        self.beats_per_tick = int(beats_per_tick) \
            if beats_per_tick is not None else None
        self.node_names: List[str] = []
        self._cursor = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, count: int, cpu: str = "32", memory: str = "128Gi",
                 pods: str = "256", name_prefix: str = "hollow",
                 zone_count: int = 8, chunk: int = 2000,
                 progress=None) -> List[str]:
        """Bulk-create ``count`` Node objects (NodeList POSTs of
        ``chunk``, fanned out per partition by the client) and adopt
        them into the heartbeat rotation."""
        from kubernetes_tpu_torch.testing.wrappers import MakeNode

        base = len(self.node_names)
        nodes = []
        names = []
        for i in range(count):
            idx = base + i
            name = f"{name_prefix}-{idx}"
            builder = MakeNode().name(name).capacity(
                {"cpu": cpu, "memory": memory, "pods": pods})
            builder = builder.label("topology.kubernetes.io/zone",
                                    f"zone-{idx % zone_count}")
            builder = builder.label("kubernetes.io/hostname", name)
            nodes.append(builder.obj())
            names.append(name)
            if len(nodes) >= chunk:
                self.client.create_objects_bulk("Node", nodes)
                nodes = []
                if progress:
                    progress(f"hollow fleet: {idx + 1}/{count} registered")
        if nodes:
            self.client.create_objects_bulk("Node", nodes)
        self.node_names.extend(names)
        return names

    def start(self) -> "HollowFleet":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hollow-fleet-heartbeats")
        self._thread.start()
        return self

    def _slice_size(self, fleet: int) -> int:
        if self.beats_per_tick is not None:
            return min(self.beats_per_tick, fleet)
        # cover the whole fleet at least twice per lease lifetime
        import math

        need = math.ceil(fleet * self.interval
                         / max(self.lease_duration / 2.0, self.interval))
        return min(max(need, 1), fleet)

    def beat_slice(self) -> int:
        """Renew the next slice of node leases; returns how many."""
        names = self.node_names
        if not names:
            return 0
        n = self._slice_size(len(names))
        renew = getattr(self.client, "try_acquire_or_renew", None)
        if renew is None:
            return 0
        beaten = 0
        for _ in range(n):
            name = names[self._cursor % len(names)]
            self._cursor += 1
            try:
                renew(f"node-{name}", name, time.time(),
                      self.lease_duration)
                beaten += 1
            except Exception:  # noqa: BLE001 — a failed beat is a
                # missed heartbeat, exactly what it would be for a real
                # kubelet; the next rotation retries
                if self._stop.is_set():
                    break
        return beaten

    def _loop(self) -> None:
        # first beat immediately (HeartbeatPump.start does the same):
        # a fleet that waits a full interval before its first renewal
        # starts life with every lease expired
        self.beat_slice()
        while not self._stop.wait(self.interval):
            self.beat_slice()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
