"""Host-side encoding: a snapshot and a pod batch become dense arrays.

- node capacity and usage ``[N, R]`` (int32: milli-CPU, KiB memory, KiB
  ephemeral storage, whole units of scalar resources);
- topology value codes ``[N, K]`` per tracked topology key (a missing
  label is the sentinel code V);
- per *static profile* node masks ``[U, N]``: a profile is the tuple of a
  pod's node-static predicates (nodeName, nodeSelector, required node
  affinity, tolerations, images), evaluated once per (profile, node);
- tracked topology-spread constraints: counts ``[SC, V+1]``, eligible
  domains per profile, and per-pod membership;
- tracked (anti-)affinity terms: counts and owners ``[T, V+1]`` and
  per-pod flags and preferred weights.

Volumes, given the store as ``client``: a claim's PV node affinity and
zone fold into its profile's static mask (computed by the VolumeBinding
and VolumeZone plugins themselves); each CSI driver with a CSINode
attach limit gets a resource column after the others (allocatable = the
limit, requested = the distinct volumes in use, clamped to the limit), so
a pod's distinct new volumes of that driver are a request like cpu; and
each shared (RWX or ROX) CSI volume gets a slot, whose row of
``sv_attached [SV, N]`` marks the nodes it is attached to: a pod of that
volume costs one attachment only where it is not attached yet
(``pod_sv``: slot, attach column; the sentinel slot SV for other pods).
An unbound WaitForFirstConsumer claim over a pool of PVs without node
affinity is no constraint at all: the batch loop binds a PV at commit.

Extra nodes (``extra_nodes``: the cluster autoscaler's hypothetical
template nodes) are appended as the last columns, after the snapshot's
``num_snapshot_nodes``, and encoded as if they existed.

Node columns are padded to a multiple of 128 (of 512 above 1024 nodes);
SC and T are at least 1. A full ``encode`` keeps its *encoding space*
(resource columns, value codes, tracked constraints, terms, profiles,
attach columns and volume slots) so later batches that fit it are
encoded pod-side only (``encode_pods_only``) against the state the
device carries.

``is_host_only`` tells the pods the serial path takes (host ports,
inline cloud disks, claims other than bound or node-independent
WaitForFirstConsumer ones, more than one shared CSI volume); the batch
loop routes them there, and the encoder raises
``InexpressiblePodError`` if it is handed one, unless it was built with
``host_only_rows=True`` (the autoscaler's what-if): then such a pod is a
row flagged ``inexpressible``, which the scan never places, as the
reference's encoder marks it. A mesh-block pod's
closeness to its block's anchor (MeshLocality) is a static score, and
its block is part of its static profile key. A pod whose non-shared
volume is already attached somewhere is flagged ``inexpressible`` in its
batch and declined, so it takes the serial path for the exact set
count.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api import labels as labelslib
from kubernetes_tpu_torch.api.types import CPU, EPHEMERAL_STORAGE, MEMORY, PODS, Pod
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.framework.plugins import mesh_locality
from kubernetes_tpu_torch.scheduler.framework.plugins.node_volume_limits import (
    pod_csi_volumes,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.volume_binding import (
    VolumeBinding,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.volume_zone import (
    TOPOLOGY_LABELS,
    VolumeZone,
)
from kubernetes_tpu_torch.scheduler.predicates import (
    node_selector_term_matches,
    passes_unschedulable,
    pod_matches_node_selector_and_affinity,
    tolerates_node_taints,
)
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Resource

BASE_RESOURCES = 3  # cpu (milli), memory (KiB), ephemeral (KiB)
PAD_NODES = 128
# attach-limit columns are named in a namespace no extended resource uses
ATTACH_COL_PREFIX = "attachable#csi#"
# the attach budget of a node or driver without a limit; it survives a
# full batch of additions in int32
NO_LIMIT = 1_000_000_000
# access modes that let several pods share one volume
SHARED_ACCESS_MODES = ("ReadWriteMany", "ReadOnlyMany")


class InexpressiblePodError(ValueError):
    """A pod needs host-side machinery this batch path does not have."""


def check_expressible(pod: Pod, client=None, cache=None) -> None:
    if is_host_only(pod, client, cache):
        raise InexpressiblePodError(
            f"pod {pod.full_name()} needs the serial path (host ports or "
            "volumes the batch path cannot express)")


def wfc_class_batchable(client, sc_name: str, cache=None) -> bool:
    """True when an unbound claim of class ``sc_name`` needs no per-node
    check: the class binds WaitForFirstConsumer, its provisioner has no
    CSINode attach limit anywhere, and no Available unclaimed PV of the
    class has node affinity (a match is then the same on every node, and
    the PV can be picked at commit). ``cache`` (a dict) keeps the verdict
    per class for one drain."""
    if not sc_name:
        return False
    if cache is not None and ("wfc", sc_name) in cache:
        return cache[("wfc", sc_name)]
    verdict = False
    sc = client.get_storage_class(sc_name)
    if sc is not None and sc.volume_binding_mode == "WaitForFirstConsumer":
        limited = any(
            d.name == sc.provisioner and d.allocatable_count is not None
            for cn in client.list_csi_nodes() for d in cn.drivers)
        if not limited:
            verdict = all(
                pv.node_affinity is None for pv in client.list_pvs()
                if pv.phase == "Available" and pv.claim_ref is None
                and pv.storage_class_name == sc_name)
    if cache is not None:
        cache[("wfc", sc_name)] = verdict
    return verdict


def pv_is_shared(client, pv) -> bool:
    """A PV is shared when it, or the claim its ``claim_ref`` names, has
    a ReadWriteMany or ReadOnlyMany access mode. The one rule for
    ``is_host_only``, the slot enumeration and the pod-side encoder."""
    if any(m in SHARED_ACCESS_MODES for m in pv.access_modes):
        return True
    if pv.claim_ref:
        ns, _, nm = pv.claim_ref.partition("/")
        pvc = client.get_pvc(ns, nm)
        return pvc is not None and any(
            m in SHARED_ACCESS_MODES for m in pvc.access_modes)
    return False


def is_host_only(pod: Pod, client=None, cache=None) -> bool:
    """True for a pod the serial path takes and the batch path cannot
    express: an inline cloud disk (VolumeRestrictions and the in-tree
    limits scan the node's pods), a host port (NodePorts), a claim that
    is missing, unbound (but for a node-independent WaitForFirstConsumer
    class, ``wfc_class_batchable``) or bound to a missing PV, or more
    than one shared CSI volume (a pod carries one attach-plane slot).
    Without a ``client`` every claim is host-only. ``cache`` is a dict
    kept for one drain."""
    for v in pod.spec.volumes:
        if (v.gce_persistent_disk or v.aws_elastic_block_store
                or v.azure_disk or v.rbd or v.iscsi):
            return True
    if any(p.host_port > 0 for c in pod.spec.containers for p in c.ports):
        return True
    shared_csi = 0
    for v in pod.spec.volumes:
        if not v.persistent_volume_claim:
            continue
        if client is None:
            return True
        pvc = client.get_pvc(pod.namespace, v.persistent_volume_claim)
        if pvc is None:
            return True
        if not pvc.volume_name:
            if not wfc_class_batchable(client, pvc.storage_class_name,
                                       cache):
                return True
            continue
        pv = client.get_pv(pvc.volume_name)
        if pv is None:
            return True
        if pv.csi_driver and pv_is_shared(client, pv):
            shared_csi += 1
            if shared_csi > 1:
                return True
    return False


class _ClientHandle:
    """The framework handle the volume plugins need inside the encoder:
    only ``client``."""

    __slots__ = ("client",)

    def __init__(self, client):
        self.client = client


def _kib(b: int) -> int:
    return -((-b) // 1024)


def _resource_row(r: Resource, names: List[str]) -> List[int]:
    row = [r.milli_cpu, _kib(r.memory), _kib(r.ephemeral_storage)]
    for name in names[BASE_RESOURCES:]:
        row.append(r.scalar_resources.get(name, 0))
    return row


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _constraint_key(pod: Pod, c, sel: labelslib.Selector) -> tuple:
    """Dedup identity of a topology-spread constraint, shared by the full
    and the pod-side encoders."""
    return (c.topology_key, c.max_skew,
            c.when_unsatisfiable == "DoNotSchedule", pod.namespace,
            repr(sel))


def _term_key(t) -> tuple:
    """Dedup identity of an (anti-)affinity term."""
    return (t.topology_key, repr(t.selector), tuple(sorted(t.namespaces)))


def _simple_label_eq(selector: labelslib.Selector):
    """(key, value) for a single ``key In (value)`` selector, else None."""
    reqs = selector.requirements
    if (not selector._nothing and len(reqs) == 1
            and reqs[0].operator == labelslib.IN
            and len(reqs[0].values) == 1):
        return (reqs[0].key, reqs[0].values[0])
    return None


def _build_match_index(items):
    """Split tracked items into an inverted index of single-label
    selectors ((key, value) -> [(idx, item)]) and the rest, so a pod's
    membership is found in O(its labels)."""
    simple: Dict[tuple, list] = {}
    complex_items = []
    for idx, item in enumerate(items):
        kv = _simple_label_eq(item.selector)
        if kv is None:
            complex_items.append((idx, item))
        else:
            simple.setdefault(kv, []).append((idx, item))
    return simple, complex_items


@dataclass
class _TrackedConstraint:
    key_idx: int
    max_skew: int
    selector: labelslib.Selector
    namespace: str
    hard: bool  # DoNotSchedule vs ScheduleAnyway

    def matches(self, pod: Pod) -> bool:
        return pod.namespace == self.namespace and self.selector.matches(
            pod.metadata.labels)


@dataclass
class _TrackedTerm:
    key_idx: int
    selector: labelslib.Selector
    namespaces: frozenset

    def matches(self, pod: Pod) -> bool:
        return pod.namespace in self.namespaces and self.selector.matches(
            pod.metadata.labels)


@dataclass
class EncodedCluster:
    """Node-side arrays (numpy)."""

    node_names: List[str]
    num_real_nodes: int
    resource_names: List[str]
    allocatable: np.ndarray        # [N, R] int32
    requested: np.ndarray          # [N, R] int32
    nonzero_requested: np.ndarray  # [N, 2] int32 (cpu milli, mem KiB)
    pod_count: np.ndarray          # [N] int32
    max_pods: np.ndarray           # [N] int32
    topo_keys: List[str] = field(default_factory=list)
    topo_codes: Optional[np.ndarray] = None       # [N, K] int32, V = missing
    topo_num_values: Optional[np.ndarray] = None  # [K] int32
    # shared CSI volumes: row s is 1 on the nodes slot s's volume is
    # attached to; None without shared CSI volumes
    sv_attached: Optional[np.ndarray] = None      # [SV, N] int32
    sv_keys: Optional[np.ndarray] = None          # [SV] int64 slot hashes


@dataclass
class EncodedPodBatch:
    """Pod-side arrays of one batch against an existing encoding space."""

    pods: List[Pod]
    num_real_pods: int
    requests: np.ndarray           # [B, R] int32
    nonzero_requests: np.ndarray   # [B, 2] int32
    profile_idx: np.ndarray        # [B] int32 into the static masks
    inexpressible: np.ndarray      # [B] bool: the row is never placed
    pod_sc: np.ndarray             # [B, SC] bool: constraint is the pod's
    pod_sc_match: np.ndarray       # [B, SC] bool: pod counts toward it
    match_by: np.ndarray           # [B, T] bool: pod matched by term
    own_aff: np.ndarray            # [B, T] bool: pod requires term
    own_anti: np.ndarray           # [B, T] bool: pod forbids term
    pref_weight: np.ndarray        # [B, T] float32: preferred weights
    # (slot, attach column) of the pod's shared CSI volume, the slot SV
    # for none; None when the epoch has no slots
    pod_sv: Optional[np.ndarray] = None  # [B, 2] int32


@dataclass
class EncodedBatch(EncodedPodBatch):
    """Pod-side arrays plus the batch's static and tracked state."""

    static_masks: np.ndarray = None    # [U, N] bool: node-static predicates
    affinity_masks: np.ndarray = None  # [U, N] bool: selector/affinity only
    static_scores: np.ndarray = None   # [U, N] float32
    sc_key_idx: np.ndarray = None      # [SC] int32
    sc_max_skew: np.ndarray = None     # [SC] int32
    sc_hard: np.ndarray = None         # [SC] bool
    sc_counts: np.ndarray = None       # [SC, V+1] int32
    sc_domain: np.ndarray = None       # [U, SC, V+1] bool
    term_key_idx: np.ndarray = None    # [T] int32
    term_counts: np.ndarray = None     # [T, V+1] int32
    term_owners: np.ndarray = None     # [T, V+1] int32
    num_values: int = 1                # V (shared topology-value space)


class BatchEncoder:
    """Encodes (snapshot, pod batch) pairs; keeps the encoding space of
    its last full ``encode`` for ``encode_pods_only``. ``client`` (the
    store) serves the storage objects; without it no pod may have a
    claim. ``extra_nodes`` are appended after the snapshot's
    ``num_snapshot_nodes`` columns, with no pods. ``host_only_rows``
    encodes a host-only pod as an ``inexpressible`` row instead of
    raising. ``node_shards`` is the sharded tier's mesh width, taken as the
    reference's encoder takes it; the node-column fill runs in this
    thread whatever it is (its plugin loops hold the interpreter lock,
    and a column's values do not depend on the split)."""

    def __init__(self, snapshot: Snapshot, client=None,
                 extra_nodes: Optional[List] = None,
                 host_only_rows: bool = False, node_shards: int = 1):
        self.snapshot = snapshot
        self.node_shards = max(1, int(node_shards))
        self._host_only_rows = host_only_rows
        self.node_infos = [ni for ni in snapshot.list() if ni.node is not None]
        self.num_snapshot_nodes = len(self.node_infos)
        for node in extra_nodes or ():
            ni = NodeInfo()
            ni.set_node(node)
            self.node_infos.append(ni)
        self._client = client
        # attach-limit columns, by driver, fixed for the epoch (a CSINode
        # event rebuilds the session)
        self._attach_col: Dict[str, int] = {}
        # pod uid -> its (driver, volume) attach set
        self._pod_attach_cache: Dict[str, frozenset] = {}
        # one drain's wfc_class_batchable verdicts
        self._wfc_cache: Dict = {}
        # non-shared (driver, volume) pairs attached somewhere, by an
        # existing pod or an earlier pod of this epoch: a pod reusing one
        # takes the serial path, which counts the set exactly
        self._attached_volumes: set = set()
        # shared CSI volumes: (driver, volume) -> slot, and the slot pad
        self._sv_slots: Dict[tuple, int] = {}
        self._sv_keys: List[tuple] = []
        self._sv_pad = 0
        self._vol_shared_cache: Dict[str, bool] = {}
        self._resource_names: Optional[List[str]] = None
        self._con_index: Dict[tuple, int] = {}
        self._constraints: List[_TrackedConstraint] = []
        self._term_index: Dict[tuple, int] = {}
        self._terms: List[_TrackedTerm] = []
        self._profiles: Dict[tuple, int] = {}
        self._con_match_idx = ({}, [])
        self._term_match_idx = ({}, [])

    def encode(self, pods: List[Pod], pad_pods: int = 64
               ) -> Tuple[EncodedCluster, EncodedBatch]:
        nis = self.node_infos
        n_real = len(nis)
        # coarse node buckets: multiples of 128, of 512 above 1024 nodes
        gran = PAD_NODES if n_real <= 1024 else 512
        n_pad = max(_round_up(max(n_real, 1), gran), PAD_NODES)

        pod_infos = [PodInfo.of(p) for p in pods]
        resource_names = self._collect_resource_names(pod_infos)
        r = len(resource_names)
        allocatable = np.zeros((n_pad, r), dtype=np.int32)
        requested = np.zeros((n_pad, r), dtype=np.int32)
        nonzero_req = np.zeros((n_pad, 2), dtype=np.int32)
        pod_count = np.zeros(n_pad, dtype=np.int32)
        max_pods = np.zeros(n_pad, dtype=np.int32)
        for i, ni in enumerate(nis):
            allocatable[i] = _resource_row(ni.allocatable, resource_names)
            requested[i] = _resource_row(ni.requested, resource_names)
            nonzero_req[i] = (ni.non_zero_requested.milli_cpu,
                              _kib(ni.non_zero_requested.memory))
            pod_count[i] = len(ni.pods)
            max_pods[i] = ni.allocatable.allowed_pod_number or 1_000_000
        sv_attached = sv_keys = None
        if self._attach_col:
            self._collect_shared_volume_slots()
            if self._sv_slots:
                # a power of two, at least 8
                self._sv_pad = max(
                    8, 1 << (len(self._sv_slots) - 1).bit_length())
                sv_attached = np.zeros((self._sv_pad, n_pad), dtype=np.int32)
            self._fill_attach_node_columns(allocatable, requested,
                                           sv_attached)
            if sv_attached is not None:
                sv_keys = np.zeros(self._sv_pad, dtype=np.int64)
                for i, (d, v) in enumerate(self._sv_keys):
                    sv_keys[i] = zlib.crc32(f"{d}\x00{v}".encode())
        cluster = EncodedCluster(
            node_names=[ni.node.name for ni in nis],
            num_real_nodes=n_real,
            resource_names=resource_names,
            allocatable=allocatable,
            requested=requested,
            nonzero_requested=nonzero_req,
            pod_count=pod_count,
            max_pods=max_pods,
            sv_attached=sv_attached,
            sv_keys=sv_keys,
        )
        batch = self._encode_pods(cluster, pods, pod_infos, n_pad, pad_pods)
        return cluster, batch

    def _collect_resource_names(self, pod_infos: List[PodInfo]) -> List[str]:
        names = [CPU, MEMORY, EPHEMERAL_STORAGE]
        seen = set(names) | {PODS}
        scalars = [ni.allocatable.scalar_resources for ni in self.node_infos]
        scalars += [pi.resource_request.scalar_resources for pi in pod_infos]
        for res in scalars:
            for name in res:
                if name not in seen:
                    seen.add(name)
                    names.append(name)
        # every limited driver gets a column, last, so that a later batch
        # of any of them fits the space
        self._attach_col = {}
        self._attached_volumes = set()  # refilled by the node fill
        for d in self._attach_limit_drivers():
            self._attach_col[d] = len(names)
            names.append(ATTACH_COL_PREFIX + d)
        return names

    def _attach_limit_drivers(self) -> List[str]:
        """The CSI drivers with an attach limit on some CSINode."""
        if self._client is None:
            return []
        return sorted({d.name for cn in self._client.list_csi_nodes()
                       for d in cn.drivers if d.allocatable_count is not None})

    def _pod_attach(self, pod: Pod) -> frozenset:
        """The pod's (driver, volume) attach set, kept per pod."""
        if not pod.spec.volumes:
            return frozenset()
        key = pod.uid or pod.full_name()
        got = self._pod_attach_cache.get(key)
        if got is None:
            got = self._pod_attach_cache[key] = frozenset(
                pod_csi_volumes(self._client, pod))
        return got

    def _volume_is_shared(self, driver: str, vol_key: str) -> bool:
        """``pv_is_shared`` of the PV named ``vol_key``, kept per epoch."""
        got = self._vol_shared_cache.get(vol_key)
        if got is None:
            pv = self._client.get_pv(vol_key)
            got = self._vol_shared_cache[vol_key] = (
                pv is not None and pv_is_shared(self._client, pv))
        return got

    def _collect_shared_volume_slots(self) -> None:
        """A slot for every shared PV of a limited CSI driver, in PV
        order, fixed for the epoch."""
        self._sv_slots = {}
        self._sv_keys = []
        self._vol_shared_cache = {}
        for pv in self._client.list_pvs():
            driver = pv.csi_driver
            if not driver or driver not in self._attach_col:
                continue
            if pv_is_shared(self._client, pv):
                key = (driver, pv.name)
                if key not in self._sv_slots:
                    self._sv_slots[key] = len(self._sv_keys)
                    self._sv_keys.append(key)

    def _fill_attach_node_columns(self, allocatable: np.ndarray,
                                  requested: np.ndarray,
                                  sv_attached: Optional[np.ndarray]) -> None:
        """Each node's attach budgets: allocatable is the CSINode limit
        (``NO_LIMIT`` without one), requested the distinct volumes in use,
        clamped to the limit, so a node already over it refuses a pod that
        attaches and takes one that does not. A node over a driver's limit
        keeps its attached bits clear: a shared pod's demand there is 1,
        and the clamped column refuses it, as the filter refuses any
        attaching pod there."""
        for i, ni in enumerate(self.node_infos):
            in_use: Dict[str, set] = {}
            for pi in ni.pods:
                for d, v in self._pod_attach(pi.pod):
                    in_use.setdefault(d, set()).add(v)
                    if d in self._attach_col:
                        self._attached_volumes.add((d, v))
            cn = self._client.get_csi_node(ni.node.name)
            limits: Dict[str, int] = {}
            if cn is not None:
                for drv in cn.drivers:
                    if drv.allocatable_count is not None:
                        limits[drv.name] = drv.allocatable_count
            for dname, col in self._attach_col.items():
                limit = limits.get(dname, NO_LIMIT)
                allocatable[i, col] = limit
                requested[i, col] = min(len(in_use.get(dname, ())), limit)
            if sv_attached is not None:
                for d, vols in in_use.items():
                    if len(vols) > limits.get(d, NO_LIMIT):
                        continue
                    for v in vols:
                        slot = self._sv_slots.get((d, v))
                        if slot is not None:
                            sv_attached[slot, i] = 1

    # ------------------------------------------------------------------
    def _encode_pods(self, cluster: EncodedCluster, pods: List[Pod],
                     pod_infos: List[PodInfo], n_pad: int,
                     pad_pods: int) -> EncodedBatch:
        topo_keys: List[str] = []
        key_index: Dict[str, int] = {}

        def key_idx(key: str) -> int:
            if key not in key_index:
                key_index[key] = len(topo_keys)
                topo_keys.append(key)
            return key_index[key]

        constraints: List[_TrackedConstraint] = []
        con_index: Dict[tuple, int] = {}
        for pod in pods:
            for c in pod.spec.topology_spread_constraints:
                if not c.topology_key:
                    continue
                sel = labelslib.selector_from_label_selector(c.label_selector)
                key = _constraint_key(pod, c, sel)
                if key not in con_index:
                    con_index[key] = len(constraints)
                    constraints.append(_TrackedConstraint(
                        key_idx(c.topology_key), c.max_skew, sel,
                        pod.namespace, c.when_unsatisfiable == "DoNotSchedule"))

        # tracked terms: the batch pods' required and preferred terms plus
        # the required anti-affinity of pods already placed (owners)
        terms: List[_TrackedTerm] = []
        term_index: Dict[tuple, int] = {}

        def term_for(t) -> int:
            key = _term_key(t)
            if key not in term_index:
                term_index[key] = len(terms)
                terms.append(_TrackedTerm(key_idx(t.topology_key),
                                          t.selector, t.namespaces))
            return term_index[key]

        for pi in pod_infos:
            for t in pi.required_affinity_terms:
                term_for(t)
            for t in pi.required_anti_affinity_terms:
                term_for(t)
            for wt in pi.preferred_affinity_terms:
                term_for(wt.term)
            for wt in pi.preferred_anti_affinity_terms:
                term_for(wt.term)
        existing_anti_terms: List[Tuple[int, str]] = []  # (term, owner node)
        for ni in self.snapshot.have_pods_with_required_anti_affinity_list():
            if ni.node is None:
                continue
            for existing in ni.pods_with_required_anti_affinity:
                for t in existing.required_anti_affinity_terms:
                    existing_anti_terms.append((term_for(t), ni.node.name))

        # topology value coding: one value space shared by every key
        k = len(topo_keys)
        value_codes: List[Dict[str, int]] = [dict() for _ in range(k)]
        topo_codes = np.full((n_pad, max(k, 1)), -1, dtype=np.int32)
        for i, ni in enumerate(self.node_infos):
            labels = ni.node.metadata.labels
            for ki, key in enumerate(topo_keys):
                if key in labels:
                    vc = value_codes[ki]
                    v = labels[key]
                    if v not in vc:
                        vc[v] = len(vc)
                    topo_codes[i, ki] = vc[v]
        num_values = max(max((len(vc) for vc in value_codes), default=0), 1)
        cluster.topo_keys = topo_keys
        cluster.topo_codes = topo_codes
        cluster.topo_num_values = np.array(
            [len(vc) for vc in value_codes] or [0], dtype=np.int32)
        topo_codes[topo_codes < 0] = num_values   # missing key -> sentinel

        # static profiles
        profiles: Dict[tuple, int] = {}
        profile_pods: List[Pod] = []
        for pod in pods:
            key = self._static_profile_key(pod)
            if key not in profiles:
                profiles[key] = len(profile_pods)
                profile_pods.append(pod)
        u = max(len(profile_pods), 1)
        static_masks = np.zeros((u, n_pad), dtype=bool)
        affinity_masks = np.zeros((u, n_pad), dtype=bool)
        static_scores = np.zeros((u, n_pad), dtype=np.float32)
        for ui, pod in enumerate(profile_pods):
            self._compute_static(pod, static_masks[ui], affinity_masks[ui],
                                 static_scores[ui])

        # keep the encoding space, then fill the pod-side arrays with the
        # same code the pod-side-only path uses
        self._resource_names = cluster.resource_names
        self._con_index = con_index
        self._constraints = constraints
        self._term_index = term_index
        self._terms = terms
        self._profiles = profiles
        self._con_match_idx = _build_match_index(constraints)
        self._term_match_idx = _build_match_index(terms)
        pb = self.encode_pods_only(pods, pad_pods)

        sc = max(len(constraints), 1)
        sc_key_idx = np.zeros(sc, dtype=np.int32)
        sc_max_skew = np.ones(sc, dtype=np.int32)
        sc_hard = np.zeros(sc, dtype=bool)
        sc_counts = np.zeros((sc, num_values + 1), dtype=np.int32)
        sc_domain = np.zeros((u, sc, num_values + 1), dtype=bool)
        for ci, con in enumerate(constraints):
            sc_key_idx[ci] = con.key_idx
            sc_max_skew[ci] = con.max_skew
            sc_hard[ci] = con.hard
            for i, ni in enumerate(self.node_infos):
                code = topo_codes[i, con.key_idx]
                if code >= num_values:
                    continue
                sc_counts[ci, code] += sum(
                    1 for pi in ni.pods
                    if pi.pod.metadata.deletion_timestamp is None
                    and con.matches(pi.pod))
            for ui in range(len(profile_pods)):
                for i in range(len(self.node_infos)):
                    if affinity_masks[ui, i]:
                        code = topo_codes[i, con.key_idx]
                        if code < num_values:
                            sc_domain[ui, ci, code] = True

        t_n = max(len(terms), 1)
        term_key_idx = np.zeros(t_n, dtype=np.int32)
        term_counts = np.zeros((t_n, num_values + 1), dtype=np.int32)
        term_owners = np.zeros((t_n, num_values + 1), dtype=np.int32)
        for ti, term in enumerate(terms):
            term_key_idx[ti] = term.key_idx
            for i, ni in enumerate(self.node_infos):
                code = topo_codes[i, term.key_idx]
                if code >= num_values:
                    continue
                term_counts[ti, code] += sum(
                    1 for pi in ni.pods if term.matches(pi.pod))
        node_idx = {ni.node.name: i for i, ni in enumerate(self.node_infos)}
        for ti, owner in existing_anti_terms:
            code = topo_codes[node_idx[owner], terms[ti].key_idx]
            if code < num_values:
                term_owners[ti, code] += 1

        return EncodedBatch(
            **pb.__dict__,
            static_masks=static_masks,
            affinity_masks=affinity_masks,
            static_scores=static_scores,
            sc_key_idx=sc_key_idx,
            sc_max_skew=sc_max_skew,
            sc_hard=sc_hard,
            sc_counts=sc_counts,
            sc_domain=sc_domain,
            term_key_idx=term_key_idx,
            term_counts=term_counts,
            term_owners=term_owners,
            num_values=num_values,
        )

    # ------------------------------------------------------------------
    def encode_pods_only(self, pods: List[Pod],
                         pad_pods: int) -> Optional[EncodedPodBatch]:
        """Pod-side arrays of ``pods`` against the space of the last full
        ``encode``. None when a pod does not fit that space (a new scalar
        resource, an untracked constraint or term, an unseen static
        profile): the caller then re-encodes in full. Rows are padded to
        ``pad_pods`` (to the next power of two above it), a multiple of
        8."""
        if self._resource_names is None:
            return None
        if not self._host_only_rows:
            for pod in pods:
                check_expressible(pod, self._client, self._wfc_cache)
        b_real = len(pods)
        b_pad = _round_up(
            pad_pods if b_real <= pad_pods
            else 1 << (b_real - 1).bit_length(), 8)
        resource_names = self._resource_names
        known_resources = set(resource_names)
        r = len(resource_names)
        sc = max(len(self._constraints), 1)
        t_n = max(len(self._terms), 1)

        requests = np.zeros((b_pad, r), dtype=np.int32)
        nonzero_requests = np.zeros((b_pad, 2), dtype=np.int32)
        profile_idx = np.zeros(b_pad, dtype=np.int32)
        pod_sc = np.zeros((b_pad, sc), dtype=bool)
        pod_sc_match = np.zeros((b_pad, sc), dtype=bool)
        match_by = np.zeros((b_pad, t_n), dtype=bool)
        own_aff = np.zeros((b_pad, t_n), dtype=bool)
        own_anti = np.zeros((b_pad, t_n), dtype=bool)
        pref_weight = np.zeros((b_pad, t_n), dtype=np.float32)
        inexpressible = np.zeros(b_pad, dtype=bool)
        pod_sv = None
        if self._sv_pad:
            pod_sv = np.zeros((b_pad, 2), dtype=np.int32)
            pod_sv[:, 0] = self._sv_pad   # the sentinel slot
        simple_cons, complex_cons = self._con_match_idx
        simple_terms, complex_terms = self._term_match_idx

        for bi, pod in enumerate(pods):
            pi = PodInfo.of(pod)
            if any(name not in known_resources
                   for name in pi.resource_request.scalar_resources):
                return None
            ui = self._profiles.get(self._static_profile_key(pod))
            if ui is None:
                return None
            profile_idx[bi] = ui
            requests[bi] = _resource_row(pi.resource_request, resource_names)
            nonzero_requests[bi] = (pi.non_zero_request.milli_cpu,
                                    _kib(pi.non_zero_request.memory))
            if self._host_only_rows:
                inexpressible[bi] = is_host_only(pod, self._client,
                                                 self._wfc_cache)
            if self._attach_col and not inexpressible[bi] \
                    and pod.spec.volumes:
                relevant = {(d, v) for d, v in self._pod_attach(pod)
                            if d in self._attach_col}
                shared = {p for p in relevant if p in self._sv_slots}
                if any(self._volume_is_shared(d, v)
                       for d, v in relevant - shared):
                    # a shared volume created after this epoch's slots
                    # were enumerated: re-encode in full
                    return None
                relevant -= shared
                if len(shared) > 1:
                    inexpressible[bi] = True
                else:
                    if shared:
                        d, v = next(iter(shared))
                        pod_sv[bi] = (self._sv_slots[(d, v)],
                                      self._attach_col[d])
                    if relevant & self._attached_volumes:
                        # a non-shared volume attached elsewhere
                        inexpressible[bi] = True
                    else:
                        self._attached_volumes |= relevant
                        for d, _v in relevant:
                            requests[bi, self._attach_col[d]] += 1

            for c in pod.spec.topology_spread_constraints:
                if not c.topology_key:
                    continue
                sel = labelslib.selector_from_label_selector(c.label_selector)
                ci = self._con_index.get(_constraint_key(pod, c, sel))
                if ci is None:
                    return None
                pod_sc[bi, ci] = True
            labels = pod.metadata.labels or {}
            for kv in labels.items():
                for ci, con in simple_cons.get(kv, ()):
                    if pod.namespace == con.namespace:
                        pod_sc_match[bi, ci] = True
            for ci, con in complex_cons:
                pod_sc_match[bi, ci] = con.matches(pod)

            for terms, flags in ((pi.required_affinity_terms, own_aff),
                                 (pi.required_anti_affinity_terms, own_anti)):
                for t in terms:
                    ti = self._term_index.get(_term_key(t))
                    if ti is None:
                        return None
                    flags[bi, ti] = True
            for wterms, sign in ((pi.preferred_affinity_terms, 1.0),
                                 (pi.preferred_anti_affinity_terms, -1.0)):
                for wt in wterms:
                    ti = self._term_index.get(_term_key(wt.term))
                    if ti is None:
                        return None
                    pref_weight[bi, ti] += sign * float(wt.weight)
            for kv in labels.items():
                for ti, term in simple_terms.get(kv, ()):
                    if pod.namespace in term.namespaces:
                        match_by[bi, ti] = True
            for ti, term in complex_terms:
                match_by[bi, ti] = term.matches(pod)

        return EncodedPodBatch(
            pods=pods,
            num_real_pods=b_real,
            requests=requests,
            nonzero_requests=nonzero_requests,
            profile_idx=profile_idx,
            inexpressible=inexpressible,
            pod_sc=pod_sc,
            pod_sc_match=pod_sc_match,
            match_by=match_by,
            own_aff=own_aff,
            own_anti=own_anti,
            pref_weight=pref_weight,
            pod_sv=pod_sv,
        )

    # ------------------------------------------------------------------
    def _static_profile_key(self, pod: Pod) -> tuple:
        return _static_profile_key(pod) + (
            self._volume_profile_identity(pod),
            mesh_locality.profile_component(pod))

    def _volume_profile_identity(self, pod: Pod) -> tuple:
        """The volume part of the profile key: pods share a profile when
        their claims impose the same node feasibility (the multiset of
        their PVs' node affinity and zone labels). A node-independent
        WaitForFirstConsumer claim counts by its class."""
        if self._client is None:
            return ()
        ident = []
        for v in pod.spec.volumes:
            if not v.persistent_volume_claim:
                continue
            pvc = self._client.get_pvc(pod.namespace,
                                       v.persistent_volume_claim)
            if pvc is None:
                ident.append(("missing", v.persistent_volume_claim))
                continue
            if not pvc.volume_name:
                if wfc_class_batchable(self._client, pvc.storage_class_name,
                                       self._wfc_cache):
                    ident.append(("wfc", pvc.storage_class_name))
                else:
                    ident.append(("unbound", v.persistent_volume_claim))
                continue
            pv = self._client.get_pv(pvc.volume_name)
            if pv is None:
                ident.append(("missing-pv", pvc.volume_name))
                continue
            zones = tuple((lb, pv.metadata.labels[lb])
                          for lb in TOPOLOGY_LABELS
                          if lb in pv.metadata.labels)
            ident.append(("pv", repr(pv.node_affinity), zones))
        return tuple(sorted(ident))

    def _compute_static(self, pod: Pod, mask: np.ndarray,
                        affinity_mask: np.ndarray,
                        scores: np.ndarray) -> None:
        """Node-static predicates and scores of one profile, per node; a
        pod with claims also passes VolumeBinding's and VolumeZone's
        filters (its claims are bound or node-independent, so they are
        static). A mesh-block pod adds its closeness to its anchor
        (``mesh_locality.profile_scorer`` over every column's node)."""
        mesh_fn = None
        if mesh_locality.enabled() and mesh_locality.mesh_block(pod):
            mesh_fn = mesh_locality.profile_scorer(
                pod, [ni.node for ni in self.node_infos])
        for i, ni in enumerate(self.node_infos):
            node = ni.node
            ok = pod_matches_node_selector_and_affinity(pod, node)
            affinity_mask[i] = ok
            ok = (ok and (not pod.spec.node_name
                          or pod.spec.node_name == node.name)
                  and passes_unschedulable(pod, node)
                  and tolerates_node_taints(pod, node))
            mask[i] = ok
            if ok:
                scores[i] = _static_score(pod, ni)
                if mesh_fn is not None:
                    scores[i] += mesh_fn(node)
        if self._client is None or not any(
                v.persistent_volume_claim for v in pod.spec.volumes):
            return
        handle = _ClientHandle(self._client)
        vb, vz = VolumeBinding(handle), VolumeZone(handle)
        state = CycleState()
        if vb.pre_filter(state, pod) is not None:
            mask[:] = False
            return
        for i, ni in enumerate(self.node_infos):
            if mask[i] and (vb.filter(state, pod, ni) is not None
                            or vz.filter(state, pod, ni) is not None):
                mask[i] = False


def _static_profile_key(pod: Pod) -> tuple:
    spec = pod.spec
    aff_repr = ""
    if spec.affinity is not None and spec.affinity.node_affinity is not None:
        na = spec.affinity.node_affinity
        req = na.required_during_scheduling_ignored_during_execution
        aff_repr = repr([
            [(e.key, e.operator, tuple(e.values)) for e in t.match_expressions]
            + [("f:" + e.key, e.operator, tuple(e.values))
               for e in t.match_fields]
            for t in (req.node_selector_terms if req else [])
        ]) + repr([
            (p.weight, [(e.key, e.operator, tuple(e.values))
                        for e in p.preference.match_expressions])
            for p in na.preferred_during_scheduling_ignored_during_execution
        ])
    return (
        spec.node_name,
        tuple(sorted(spec.node_selector.items())),
        aff_repr,
        tuple((t.key, t.operator, t.value, t.effect)
              for t in spec.tolerations),
        tuple(sorted(c.image for c in spec.containers)),
    )


def _static_score(pod: Pod, ni) -> float:
    """Preferred node-affinity weights plus image locality (at most one
    point per GiB of an image the node already holds)."""
    score = 0.0
    aff = pod.spec.affinity
    if aff is not None and aff.node_affinity is not None:
        for term in aff.node_affinity.preferred_during_scheduling_ignored_during_execution:
            if term.weight and node_selector_term_matches(term.preference,
                                                          ni.node):
                score += term.weight
    for c in pod.spec.containers:
        state = ni.image_states.get(c.image)
        if state is not None:
            score += min(state.size / (1024 * 1024 * 1024), 1.0)
    return score
