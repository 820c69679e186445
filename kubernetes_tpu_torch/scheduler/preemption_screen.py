"""Vectorized preemption candidate screening and victim planning for the
batch path, in numpy on the host.

Under mass decline (thousands of unschedulable pods per solved batch),
running the reference's preemption dry-run over its sampled ~max(10% of
nodes, 100) candidates PER POD is quadratic — the dry-run clones node
state and re-runs the full filter chain per candidate
(``default_preemption.go:328 dryRunPreemption``). This module prunes
the candidates of the whole batch at once: one columnar screen per batch
computes, for every declined pod at once,

    fits_after_removal[p, n] =
        request[p] <= allocatable[n] - requested[n] + freeable[prio(p), n]

where ``freeable[t, n]`` sums the requests of node ``n``'s pods with
priority `` < t`` (victims a preemptor at priority ``t`` may evict), and
ranks each pod's feasible nodes by fewest victims, then most free margin.
The ranked top-K go to ``DefaultPreemption`` as CANDIDATE HINTS — the
dry-run still validates every hinted node with the full filter chain (and
PDB split) before victims are selected, so the screen only prunes, never
decides. Pods whose screen comes up empty fall back to the unpruned scan.

The screen is advisory and deliberately coarse: cpu + memory only
(extended resources, ports, and topology effects are the dry-run's job),
and it is built once per commit batch — preemptions landing mid-batch
may invalidate a hint, which the dry-run then rejects.

``VictimPlanner`` goes one step further for runs of equally shaped
preemptors: it picks each one's node and minimal victim set from
per-node prefix sums, and the batch loop validates every plan with the
real filter chain after the evictions.
"""

from __future__ import annotations

import bisect
import heapq
from typing import List, Optional

import numpy as np

from kubernetes_tpu_torch.scheduler.framework.plugins.default_preemption import (  # noqa: E501
    pdb_covers,
)
from kubernetes_tpu_torch.scheduler.types import compute_pod_resource_request


class PreemptionScreen:
    """One batch's columnar screen over the live snapshot."""

    def __init__(self, node_infos):
        node_infos = [ni for ni in node_infos if ni.node is not None]
        self.node_names = [ni.node.name for ni in node_infos]
        n = len(node_infos)
        self.alloc = np.zeros((n, 2), dtype=np.int64)
        self.requested = np.zeros((n, 2), dtype=np.int64)
        # distinct victim priorities present, ascending; freeable/victims
        # are cumulative-exclusive per threshold: threshold index t
        # covers preemptors whose priority is > prios[t]
        prio_set = set()
        for ni in node_infos:
            for pi in ni.pods:
                prio_set.add(pi.pod.priority())
        self.prios = sorted(prio_set)
        p = len(self.prios)
        self.freeable = np.zeros((p, n, 2), dtype=np.int64)
        self.victims = np.zeros((p, n), dtype=np.int32)
        prio_index = {v: i for i, v in enumerate(self.prios)}
        for j, ni in enumerate(node_infos):
            self.alloc[j, 0] = ni.allocatable.milli_cpu
            self.alloc[j, 1] = ni.allocatable.memory
            self.requested[j, 0] = ni.requested.milli_cpu
            self.requested[j, 1] = ni.requested.memory
            for pi in ni.pods:
                req = compute_pod_resource_request(pi.pod)
                i = prio_index[pi.pod.priority()]
                self.freeable[i, j, 0] += req.milli_cpu
                self.freeable[i, j, 1] += req.memory
                self.victims[i, j] += 1
        # prefix-sum over ascending priority: row t now holds totals for
        # pods with priority <= prios[t]
        np.cumsum(self.freeable, axis=0, out=self.freeable)
        np.cumsum(self.victims, axis=0, out=self.victims)
        self.free = self.alloc - self.requested  # [N, 2]

    def _threshold_row(self, preemptor_priority: int) -> Optional[int]:
        """Largest index t with prios[t] < preemptor_priority, or None
        when no pod anywhere has lower priority."""
        t = bisect.bisect_left(self.prios, preemptor_priority) - 1
        return t if t >= 0 else None

    def candidates_for(self, pod, k: int = 16, static_mask=None,
                       rotation: int = 0) -> List[str]:
        """Ranked candidate node names for ``pod`` (top-``k``): nodes
        where the pod fits once every lower-priority pod is removed,
        fewest victims first, then most free margin. ``static_mask``
        (bool [N], True = node passes the pod's node-static predicates)
        prunes nodes the dry-run could never accept.

        ``rotation`` spreads a BATCH of equally-shaped preemptors over
        distinct candidates (the analog of upstream's random dry-run
        offset, ``default_preemption.go:195``): without it every
        declined pod of a uniform batch receives the identical ranked
        list, they all chase the same few nodes' victims, and everyone
        after the first finds stale hints and falls back to the full
        candidate scan."""
        t = self._threshold_row(pod.priority())
        if t is None:
            return []
        req = compute_pod_resource_request(pod)
        need = np.array([req.milli_cpu, req.memory], dtype=np.int64)
        headroom = self.free + self.freeable[t]          # [N, 2]
        fits = np.all(headroom >= need[None, :], axis=1)
        fits &= self.victims[t] > 0  # a candidate must have victims
        if static_mask is not None:
            m = np.asarray(static_mask, dtype=bool)
            if m.shape[0] >= fits.shape[0]:
                fits &= m[: fits.shape[0]]
        idx = np.nonzero(fits)[0]
        if idx.size == 0:
            return []
        vic = self.victims[t][idx].astype(np.int64)
        margin = np.min(headroom[idx] - need[None, :], axis=1)
        # fewest victims, then largest margin (stable, deterministic)
        order = np.lexsort((-margin, vic))
        if rotation and idx.size > k:
            order = np.roll(order, -(rotation % idx.size))
        return [self.node_names[i] for i in idx[order[:k]]]


def build_screen(snapshot) -> Optional[PreemptionScreen]:
    """Build a screen from the live snapshot; None on empty clusters."""
    node_infos = snapshot.list()
    if not node_infos:
        return None
    return PreemptionScreen(node_infos)


_HUGE_PRIO = np.int64(2**62)


class VictimPlanner:
    """Batch preemption planning from per-(node, priority) SORTED victim
    prefix sums: the victim-selection half moves off the per-candidate
    clone+refilter dry-run.

    Per node, pods are ordered by ascending priority with cumulative
    cpu/memory sums; a preemptor at priority ``P`` needing ``need``
    takes the MINIMAL victim prefix ``k`` with

        free[n] + cum[n, o+k-1] - cum[n, o-1] >= need,   prios < P

    which is exactly the victim set the reference's reprieve loop
    converges to under resource constraints (remove everything, re-add
    by DESCENDING priority while filters pass → the lowest-priority
    prefix remains evicted, ``default_preemption.go:600,650``).
    Topology/affinity effects are NOT modeled: the caller validates
    every plan with the real filter chain post-deletion and falls back
    to the standard PostFilter flow when validation fails.

    Planning is stateful across one batch: consumed victims advance the
    node's offset and ``free`` tracks both evictions and planned
    placements, so a batch of preemptors never double-claims a victim.
    Any pod COVERED by a PodDisruptionBudget — regardless of remaining
    budget — is excluded at build time: one planned batch could
    otherwise burn through a budget the serial path (which re-reads
    budgets per cycle) would respect after the first disruption.
    PDB-covered victims belong to the standard dry-run flow, whose
    reprieve logic owns violation counting and ordering.
    """

    def __init__(self, node_infos, pdbs=()):
        node_infos = [ni for ni in node_infos if ni.node is not None]
        self.node_names = [ni.node.name for ni in node_infos]
        n = len(node_infos)
        self.alloc = np.zeros((n, 2), dtype=np.int64)
        requested = np.zeros((n, 2), dtype=np.int64)
        self.pod_room = np.zeros(n, dtype=np.int64)  # max_pods - count
        per_node: List[List] = []
        vmax = 1
        for j, ni in enumerate(node_infos):
            self.alloc[j, 0] = ni.allocatable.milli_cpu
            self.alloc[j, 1] = ni.allocatable.memory
            requested[j, 0] = ni.requested.milli_cpu
            requested[j, 1] = ni.requested.memory
            self.pod_room[j] = (
                (ni.allocatable.allowed_pod_number or 1_000_000)
                - len(ni.pods)
            )
            victims = [
                pi.pod for pi in ni.pods
                if pi.pod.metadata.deletion_timestamp is None
                and not _covered_by_pdb(pi.pod, pdbs)
            ]
            victims.sort(key=lambda p: p.priority())
            per_node.append(victims)
            vmax = max(vmax, len(victims))
        self.free = self.alloc - requested                   # [N, 2]
        self.v_pods = per_node
        self.v_prio = np.full((n, vmax), _HUGE_PRIO, dtype=np.int64)
        res = np.zeros((n, vmax, 2), dtype=np.int64)
        for j, victims in enumerate(per_node):
            for i, pod in enumerate(victims):
                self.v_prio[j, i] = pod.priority()
                req = compute_pod_resource_request(pod)
                res[j, i, 0] = req.milli_cpu
                res[j, i, 1] = req.memory
        self.cum = np.cumsum(res, axis=1)                    # [N, V, 2]
        self.consumed = np.zeros(n, dtype=np.int64)          # offset o
        # bumped per placement; stales lazy heap entries in plan_group
        self._version = np.zeros(n, dtype=np.int64)

    def _node_proposal(self, n: int, p: int, need) -> Optional[tuple]:
        """(k, margin) for placing one preemptor at priority ``p`` on
        node ``n``, or None when infeasible. O(V) — the incremental
        half of the heap allocator."""
        o = int(self.consumed[n])
        free = self.free[n]
        vmax = self.cum.shape[1]
        if free[0] >= need[0] and free[1] >= need[1]:
            k = 0
            freed0 = freed1 = 0
        else:
            base0 = self.cum[n, o - 1, 0] if o > 0 else 0
            base1 = self.cum[n, o - 1, 1] if o > 0 else 0
            j0 = int(np.searchsorted(self.cum[n, :, 0],
                                     need[0] - free[0] + base0))
            j1 = int(np.searchsorted(self.cum[n, :, 1],
                                     need[1] - free[1] + base1))
            j = max(j0, j1)
            if j >= vmax or self.v_prio[n, j] >= p:
                return None
            k = j - o + 1
            if k < 1:
                return None
            freed0 = int(self.cum[n, j, 0]) - base0
            freed1 = int(self.cum[n, j, 1]) - base1
        if self.pod_room[n] + k < 1:
            return None
        margin = min(int(free[0]) + freed0 - int(need[0]),
                     int(free[1]) + freed1 - int(need[1]))
        return k, margin

    def plan_group(self, pod, count: int, static_mask=None):
        """Plan up to ``count`` preemptors SHAPED LIKE ``pod`` (same
        priority/requests/static profile — mass-decline batches are
        dominated by such runs) in one pass: one vectorized feasibility
        sweep builds a (victims, -margin) heap over nodes; each
        placement then re-scores only its node in O(V). Returns a list
        of (node_name, victims) with length <= count; the caller maps
        them onto its pods in batch order. Mutates planner state."""
        n = len(self.node_names)
        if n == 0 or count <= 0:
            return []
        p = pod.priority()
        req = compute_pod_resource_request(pod)
        need = np.array([req.milli_cpu, req.memory], dtype=np.int64)
        o = self.consumed
        idx = np.arange(n)
        base = np.where(
            (o > 0)[:, None],
            self.cum[idx, np.maximum(o - 1, 0)], 0,
        )                                                    # [N, 2]
        elig_total = np.sum(self.v_prio < p, axis=1)         # [N]
        target = need[None, :] - self.free + base            # [N, 2]
        j_dim = np.empty((n, 2), dtype=np.int64)
        for d in (0, 1):
            j_dim[:, d] = (self.cum[:, :, d] < target[:, d:d + 1]).sum(1)
        j = np.max(j_dim, axis=1)                            # [N]
        k = j - o + 1
        fits_now = np.all(self.free >= need[None, :], axis=1)
        k = np.where(fits_now, 0, k)
        feasible = fits_now | (
            (k >= 1) & (j < elig_total) & (j < self.cum.shape[1])
        )
        feasible &= (self.pod_room + k) >= 1
        if static_mask is not None:
            m = np.asarray(static_mask, dtype=bool)
            if m.shape[0] >= n:
                feasible &= m[:n]
        cand = np.nonzero(feasible)[0]
        if cand.size == 0:
            return []
        jj = np.minimum(j[cand], self.cum.shape[1] - 1)
        freed = np.where(
            (k[cand] > 0)[:, None],
            self.cum[cand, jj] - base[cand], 0,
        )
        margin = np.min(self.free[cand] + freed - need[None, :], axis=1)
        # lazy-invalidation heap: entries carry the node's version at
        # push time; placements bump the version, staling old entries
        heap = [
            (int(k[c]), -int(margin[i]), int(c), int(self._version[c]))
            for i, c in enumerate(cand)
        ]
        heapq.heapify(heap)
        plans = []
        while heap and len(plans) < count:
            kk, neg_margin, node, ver = heapq.heappop(heap)
            if ver != self._version[node]:
                prop = self._node_proposal(node, p, need)
                if prop is not None:
                    heapq.heappush(heap, (
                        prop[0], -prop[1], node,
                        int(self._version[node]),
                    ))
                continue
            oo = int(self.consumed[node])
            victims = self.v_pods[node][oo: oo + kk]
            if kk > 0:
                b0 = self.cum[node, oo - 1] if oo > 0 else 0
                self.free[node] += self.cum[node, oo + kk - 1] - b0
            self.consumed[node] += kk
            self.free[node] -= need
            self.pod_room[node] += kk - 1
            self._version[node] += 1
            plans.append((self.node_names[node], victims))
            prop = self._node_proposal(node, p, need)
            if prop is not None:
                heapq.heappush(heap, (
                    prop[0], -prop[1], node, int(self._version[node]),
                ))
        return plans


def _covered_by_pdb(pod, pdbs) -> bool:
    return any(pdb_covers(pod, pdb) for pdb in pdbs)


def build_victim_planner(snapshot, pdbs=()) -> Optional[VictimPlanner]:
    node_infos = snapshot.list()
    if not node_infos:
        return None
    return VictimPlanner(node_infos, pdbs=pdbs)
