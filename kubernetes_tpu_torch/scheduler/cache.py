"""Assume-aware cluster cache with incremental snapshots.

A committed pod is *assumed* onto its node before its bind is visible;
the bind event later confirms it, and an assumed pod whose bind never
shows up expires ``ASSUME_TTL`` seconds after its bind was sent.
``mutation_seq`` counts every change to what the solver mirrors (node
capacity, pods, labels) and ``node_set_seq`` counts only nodes appearing
or vanishing, so the solver session can tell whether the device state it
carries still matches the cache. With a delta journal attached, every
``mutation_seq`` bump is also noted as one record (under the cache lock,
so record order is seq order), which lets the session scatter the
changes into its device planes instead of rebuilding them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from kubernetes_tpu_torch.api.types import TAINT_NODE_UNREACHABLE, Node, Pod
from kubernetes_tpu_torch.scheduler.snapshot import NodeTree, Snapshot
from kubernetes_tpu_torch.scheduler.types import (
    ImageStateSummary,
    NodeInfo,
    compute_pod_resource_request,
    get_pod_key,
)

ASSUME_TTL = 30.0


def _pod_mirror_changed(old: Pod, new: Pod) -> bool:
    """Whether a pod update changes anything the solver mirrors
    (requests, affinity, node, labels, deletion); status-only updates do
    not."""
    return (old.spec != new.spec
            or old.metadata.labels != new.metadata.labels
            or old.metadata.deletion_timestamp
            != new.metadata.deletion_timestamp)


def _node_mirror_changed(old: Optional[Node], new: Node) -> bool:
    """Whether a node update changes anything the solver mirrors
    (allocatable, images, taints, unschedulable, labels)."""
    return (old is None
            or old.status.allocatable != new.status.allocatable
            or old.status.images != new.status.images
            or old.spec != new.spec
            or old.metadata.labels != new.metadata.labels)


class _PodState:
    __slots__ = ("pod", "deadline", "binding_finished")

    def __init__(self, pod: Pod):
        self.pod = pod
        self.deadline: Optional[float] = None
        self.binding_finished = False


class SchedulerCache:
    def __init__(self):
        self._lock = threading.RLock()
        self._mutation_seq = 0
        self._node_set_seq = 0
        self._nodes: Dict[str, NodeInfo] = {}
        self._node_tree = NodeTree()
        self._assumed_pods: Set[str] = set()
        self._pod_states: Dict[str, _PodState] = {}
        # image name -> (size, names of the nodes holding it)
        self._image_nodes: Dict[str, Set[str]] = {}
        self._image_size: Dict[str, int] = {}
        self._journal = None
        # wall clock of the newest watch batch the handlers applied: the
        # snapshot-staleness SLI's anchor (a bare float, no lock)
        self.last_event_ts = 0.0

    @property
    def mutation_seq(self) -> int:
        with self._lock:
            return self._mutation_seq

    @property
    def node_set_seq(self) -> int:
        with self._lock:
            return self._node_set_seq

    def attach_delta_journal(self, journal) -> None:
        """Note every later ``mutation_seq`` bump in ``journal``
        (``ops.mirror.DeltaJournal``). Attaching another replaces it."""
        with self._lock:
            self._journal = journal

    def _bump(self, kind: str, a=None, b=None) -> None:
        """One mutation: advance the seq and journal it (lock held)."""
        self._mutation_seq += 1
        if self._journal is not None:
            self._journal.note(self._mutation_seq, kind, a, b)

    def note_event_ts(self, ts: float) -> None:
        """The handlers applied a watch batch committed at ``ts``."""
        if ts > self.last_event_ts:
            self.last_event_ts = ts

    def note_external_mutation(self) -> None:
        """A change of state the cache does not hold (a PV, PVC,
        StorageClass or CSINode): the encoder reads volume masks and
        attach budgets from those objects, so the bump makes the batch
        path's device state stale, and the journal's record of it makes
        the mirror rebuild."""
        with self._lock:
            self._bump("external")

    def _info(self, name: str) -> NodeInfo:
        info = self._nodes.get(name)
        if info is None:
            info = self._nodes[name] = NodeInfo()
        return info

    def commit_target_flags(self, names) -> Dict[str, Optional[Node]]:
        """The suspect entries among a batch's bind targets, under one
        lock: ``name -> None`` for a node the cache no longer holds,
        ``name -> Node`` for one that is cordoned or unreachable. Names
        left out may be bound to."""
        flagged: Dict[str, Optional[Node]] = {}
        with self._lock:
            for name in names:
                info = self._nodes.get(name)
                node = info.node if info is not None else None
                if node is None:
                    flagged[name] = None
                elif node.spec.unschedulable or any(
                        t.key == TAINT_NODE_UNREACHABLE
                        for t in node.spec.taints):
                    flagged[name] = node
        return flagged

    def commit_fits(self, items) -> List[Optional[str]]:
        """The capacity probe of a batch of (pod, node name) bind targets
        against the live cache, which holds what sibling replicas bound
        since the batch was solved: per target "capacity" when the pod no
        longer fits the node's allocatable cpu, memory or pod count, else
        None. Cumulative within the batch (two pods on one node charge it
        twice); a node the cache does not hold passes (that is
        ``commit_target_flags``' verdict)."""
        out: List[Optional[str]] = [None] * len(items)
        with self._lock:
            extra: Dict[str, List[int]] = {}
            for i, (pod, node_name) in enumerate(items):
                info = self._nodes.get(node_name)
                if info is None or info.node is None:
                    continue
                req = compute_pod_resource_request(pod)
                add = extra.setdefault(node_name, [0, 0, 0])
                alloc = info.allocatable
                if (alloc.milli_cpu and info.requested.milli_cpu + add[0]
                        + req.milli_cpu > alloc.milli_cpu) or \
                   (alloc.memory and info.requested.memory + add[1]
                        + req.memory > alloc.memory) or \
                   (alloc.allowed_pod_number and len(info.pods) + add[2]
                        + 1 > alloc.allowed_pod_number):
                    out[i] = "capacity"
                    continue
                add[0] += req.milli_cpu
                add[1] += req.memory
                add[2] += 1
        return out

    def dump(self) -> dict:
        """Copies of every NodeInfo (node-less ones, holding pods of nodes
        the cache lacks, included) and the assumed pods' keys."""
        with self._lock:
            return {"nodes": {n: info.clone()
                              for n, info in self._nodes.items()},
                    "assumed_pods": set(self._assumed_pods)}

    # ------------------------------------------------------------------
    # pods
    def _add_pod_locked(self, pod: Pod) -> None:
        self._info(pod.spec.node_name).add_pod(pod)

    def _remove_pod_locked(self, pod: Pod) -> None:
        info = self._nodes.get(pod.spec.node_name)
        if info is not None:
            info.remove_pod(pod)
            if info.node is None and not info.pods:
                del self._nodes[pod.spec.node_name]

    def assume_pod(self, pod: Pod) -> None:
        """Assume one pod the device solve did not place (journaled as
        ``assume``: the mirror scatters it)."""
        key = get_pod_key(pod)
        with self._lock:
            if key in self._pod_states:
                raise ValueError(f"pod {key} is in the cache, so can't be "
                                 "assumed")
            self._bump("assume", pod)
            self._add_pod_locked(pod)
            self._pod_states[key] = _PodState(pod)
            self._assumed_pods.add(key)

    def assume_pods(self, pods: List[Pod], solved: bool = True
                    ) -> List[Optional[str]]:
        """Assume a committed batch under one lock; one mutation per
        assumed pod, journaled as ``assume_bulk`` when the device solve
        placed them (its state already counts them), else as ``assume``
        (the mirror scatters them). Returns a positional error (or None)
        per pod."""
        errors: List[Optional[str]] = [None] * len(pods)
        kind = "assume_bulk" if solved else "assume"
        with self._lock:
            for i, pod in enumerate(pods):
                key = get_pod_key(pod)
                if key in self._pod_states:
                    errors[i] = f"pod {key} is in the cache, so can't be assumed"
                    continue
                self._bump(kind, pod)
                self._add_pod_locked(pod)
                self._pod_states[key] = _PodState(pod)
                self._assumed_pods.add(key)
        return errors

    def finish_binding(self, pod: Pod, now: Optional[float] = None) -> None:
        """Start the assumed pod's expiry clock: its bind was sent."""
        deadline = (time.monotonic() if now is None else now) + ASSUME_TTL
        with self._lock:
            key = get_pod_key(pod)
            state = self._pod_states.get(key)
            if state is not None and key in self._assumed_pods:
                state.binding_finished = True
                state.deadline = deadline

    def forget_pod(self, pod: Pod) -> None:
        """Undo an assume whose bind failed."""
        key = get_pod_key(pod)
        with self._lock:
            if key not in self._assumed_pods:
                raise ValueError(f"pod {key} wasn't assumed")
            state = self._pod_states.pop(key)
            self._bump("pod_del", state.pod)
            self._remove_pod_locked(state.pod)
            self._assumed_pods.discard(key)

    def add_pods(self, pods: List[Pod]) -> None:
        """Informer-confirmed assigned pods, under one lock. Confirming an
        assumed pod on the node it was assumed onto changes nothing the
        solver mirrors and is no mutation."""
        with self._lock:
            for pod in pods:
                key = get_pod_key(pod)
                state = self._pod_states.get(key)
                if key in self._assumed_pods:
                    if state.pod.spec.node_name != pod.spec.node_name:
                        self._bump("pod_move", state.pod, pod)
                        self._remove_pod_locked(state.pod)
                        self._add_pod_locked(pod)
                    self._assumed_pods.discard(key)
                elif state is not None:
                    self._bump("pod_update", state.pod, pod)
                    self._remove_pod_locked(state.pod)
                    self._add_pod_locked(pod)
                else:
                    self._bump("pod_add", pod)
                    self._add_pod_locked(pod)
                self._pod_states[key] = _PodState(pod)

    def add_pod(self, pod: Pod) -> None:
        self.add_pods([pod])

    def update_pod(self, old: Pod, new: Pod) -> None:
        """An update of an assigned, confirmed pod."""
        key = get_pod_key(old)
        with self._lock:
            if key in self._assumed_pods:
                raise ValueError(f"assumed pod {key} shouldn't be updated")
            if _pod_mirror_changed(old, new):
                self._bump("pod_update", old, new)
            self._remove_pod_locked(old)
            self._add_pod_locked(new)
            self._pod_states[key] = _PodState(new)

    def remove_pod(self, pod: Pod) -> None:
        key = get_pod_key(pod)
        with self._lock:
            state = self._pod_states.pop(key, None)
            if state is None:
                return
            self._bump("pod_del", state.pod)
            self._remove_pod_locked(state.pod)
            self._assumed_pods.discard(key)

    def is_assumed_pod(self, pod: Pod) -> bool:
        with self._lock:
            return get_pod_key(pod) in self._assumed_pods

    def cleanup_expired_assumed_pods(self, now: Optional[float] = None
                                     ) -> None:
        """Drop assumed pods whose bind was sent over ``ASSUME_TTL`` ago
        and never confirmed."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for key in list(self._assumed_pods):
                state = self._pod_states.get(key)
                if state is None:
                    self._assumed_pods.discard(key)
                    continue
                if (state.binding_finished and state.deadline is not None
                        and now >= state.deadline):
                    self._bump("pod_del", state.pod)
                    self._remove_pod_locked(state.pod)
                    del self._pod_states[key]
                    self._assumed_pods.discard(key)

    # ------------------------------------------------------------------
    # nodes
    def _add_images(self, node: Node) -> None:
        for img in node.status.images:
            for name in img.names:
                self._image_nodes.setdefault(name, set()).add(node.name)
                self._image_size[name] = img.size_bytes

    def _remove_images(self, node: Optional[Node]) -> None:
        if node is None:
            return
        for img in node.status.images:
            for name in img.names:
                holders = self._image_nodes.get(name)
                if holders is not None:
                    holders.discard(node.name)
                    if not holders:
                        del self._image_nodes[name]
                        del self._image_size[name]

    def add_node(self, node: Node) -> None:
        with self._lock:
            info = self._info(node.name)
            if info.node is None:
                self._node_set_seq += 1
                self._bump("node_add", node)
            else:
                # a known node added again is an update in mirror terms
                self._bump("node_update", info.node, node)
            self._remove_images(info.node)
            info.set_node(node)
            self._add_images(node)
            self._node_tree.add_node(node)

    def update_node(self, old: Node, new: Node) -> None:
        with self._lock:
            if _node_mirror_changed(old, new):
                self._bump("node_update", old, new)
            info = self._info(new.name)
            self._remove_images(info.node)
            info.set_node(new)
            self._add_images(new)
            self._node_tree.update_node(old, new)

    def remove_node(self, node: Node) -> None:
        """The node leaves the node set (``node_set_seq`` advances); its
        pods stay cached until their own deletions arrive."""
        with self._lock:
            info = self._nodes.get(node.name)
            if info is None:
                return
            self._bump("node_del", node)
            if info.node is not None:
                self._node_set_seq += 1
            self._remove_images(info.node)
            info.remove_node()
            if not info.pods:
                del self._nodes[node.name]
            self._node_tree.remove_node(node)

    def node_count(self) -> int:
        """Nodes in the node set."""
        with self._lock:
            return self._node_tree.num_nodes

    # ------------------------------------------------------------------
    def update_snapshot(self, snapshot: Snapshot) -> None:
        """Copy every NodeInfo newer than the snapshot into it, drop nodes
        that left, and rebuild the ordered lists (zone-interleaved
        node-tree order) when anything changed."""
        with self._lock:
            changed = False
            newest = snapshot.generation
            for name, info in self._nodes.items():
                if info.node is None or info.generation <= snapshot.generation:
                    continue
                changed = True
                newest = max(newest, info.generation)
                existing = snapshot.node_info_map.get(name)
                if existing is None:
                    existing = snapshot.node_info_map[name] = NodeInfo()
                existing.copy_from(info)
                existing.image_states = {
                    img: ImageStateSummary(self._image_size[img],
                                           len(self._image_nodes[img]))
                    for i in info.node.status.images for img in i.names
                }
            snapshot.generation = newest
            if len(snapshot.node_info_map) > self._node_tree.num_nodes:
                for name in [n for n in snapshot.node_info_map
                             if n not in self._nodes
                             or self._nodes[n].node is None]:
                    del snapshot.node_info_map[name]
                changed = True
            if changed or len(snapshot.node_info_list) != len(
                    snapshot.node_info_map):
                snapshot.node_info_list = [
                    snapshot.node_info_map[n] for n in self._node_tree.list()]
                snapshot.have_pods_with_affinity_node_info_list = [
                    ni for ni in snapshot.node_info_list
                    if ni.pods_with_affinity]
                snapshot.have_pods_with_required_anti_affinity_node_info_list = [
                    ni for ni in snapshot.node_info_list
                    if ni.pods_with_required_anti_affinity]
