"""Scale-up and scale-down what-ifs over virtual node columns.

The reference cluster-autoscaler asks "would a new node help, and how
many?" by running the scheduler's predicates one pending pod at a time
against a hypothetical node. Here the hypothetical capacity is K extra
template nodes appended as columns of the encoded node planes
(``BatchEncoder(extra_nodes=...)``), their static score pushed down so
that the scan (``ops.solver.solve_whatif``, on the card unless
``device="cpu"``) spills pods onto them only where no real node fits:
one solve places the whole pending set, and the virtual columns that
received pods are the nodes to buy.

Three tiers order the capacity a pod takes: real nodes (no penalty),
still-booting "upcoming" nodes (``UPCOMING_NODE_PENALTY``), new nodes
(``VIRTUAL_NODE_PENALTY``); within a tier, column k is pushed down by a
further k * ``VIRTUAL_COLUMN_STEP``, so the scan fills column 0 before
column 1 (first-fit packing; without it least-allocated scoring would
give every pod a node of its own). ``serial=True`` answers the same
question with the per-pod numpy oracle ``_serial_whatif``."""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Node, Pod, shallow_copy
from kubernetes_tpu_torch.autoscaler.nodegroups import NodeGroup
from kubernetes_tpu_torch.ops.encode import (
    BatchEncoder,
    EncodedBatch,
    EncodedCluster,
    is_host_only,
)
from kubernetes_tpu_torch.ops.solver import (
    BIG,
    NEG_INF,
    VIRTUAL_NODE_PENALTY,
    SolverParams,
    solve_whatif,
)
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot

UPCOMING_NODE_PENALTY = float(VIRTUAL_NODE_PENALTY) / 2.0
# the step within a tier: above the real scores' range (a few hundred),
# far below the tiers' separation
VIRTUAL_COLUMN_STEP = 1000.0
WHATIF_PREFIX = "whatif"


@dataclass
class WhatIfResult:
    assignments: np.ndarray      # [num_real_pods] node column or -1
    counts: np.ndarray           # [N] pods assigned per column
    cluster: EncodedCluster
    batch: EncodedBatch
    virtual_cols: List[int]      # columns of the hypothetical new nodes
    upcoming_cols: List[int]     # columns of still-booting nodes


@dataclass
class ScaleUpOption:
    """One group's what-if outcome (cloudprovider expansion.Option)."""

    group: str
    nodes_needed: int    # virtual columns that received a pod
    pods_placed: int     # pending pods placed anywhere
    pods_on_new: int     # of those, pods on a new node
    waste: float         # mean unused capacity share of the new nodes


@dataclass
class ScaleUpPlan:
    chosen: Optional[ScaleUpOption]
    options: List[ScaleUpOption]
    solves: int          # what-if solves issued (one per candidate group)


def run_whatif(
    nodes: Sequence[Node],
    bound_pods: Sequence[Pod],
    batch_pods: Sequence[Pod],
    *,
    new_nodes: Sequence[Node] = (),
    upcoming_nodes: Sequence[Node] = (),
    disabled_names: Sequence[str] = (),
    serial: bool = False,
    params: SolverParams = SolverParams(),
    pad_pods: int = 64,
    device=None,
) -> WhatIfResult:
    """Encode the cluster with the extra columns (``encode_whatif``) and
    solve on ``device``."""
    cluster, batch, penalties, disabled, upcoming_cols, virtual_cols = \
        encode_whatif(nodes, bound_pods, batch_pods, new_nodes=new_nodes,
                      upcoming_nodes=upcoming_nodes,
                      disabled_names=disabled_names, pad_pods=pad_pods)
    if serial:
        assignments, counts = _serial_whatif(
            cluster, batch, params, deprioritized_cols=penalties,
            disabled_cols=disabled)
    else:
        assignments, counts = solve_whatif(
            cluster, batch, params, deprioritized_cols=penalties,
            disabled_cols=disabled, device=device)
    return WhatIfResult(assignments=assignments, counts=counts,
                        cluster=cluster, batch=batch,
                        virtual_cols=virtual_cols,
                        upcoming_cols=upcoming_cols)


def encode_whatif(
    nodes: Sequence[Node],
    bound_pods: Sequence[Pod],
    batch_pods: Sequence[Pod],
    *,
    new_nodes: Sequence[Node] = (),
    upcoming_nodes: Sequence[Node] = (),
    disabled_names: Sequence[str] = (),
    pad_pods: int = 64,
):
    """A what-if's solve inputs: (cluster, batch, penalties, disabled
    columns, upcoming columns, virtual columns). ``upcoming_nodes`` take
    the upcoming tier, ``new_nodes`` the virtual one, ``disabled_names``
    are removed from the solve. Every pod keeps its row, in the caller's
    order: a host-only pod (``is_host_only``) is a row flagged
    ``inexpressible``, which the scan never places, as the reference's
    encoder marks it."""
    snapshot = new_snapshot(bound_pods, list(nodes))
    extras = list(upcoming_nodes) + list(new_nodes)
    enc = BatchEncoder(snapshot, extra_nodes=extras, host_only_rows=True)
    cluster, batch = enc.encode(list(batch_pods), pad_pods=pad_pods)
    base = enc.num_snapshot_nodes
    upcoming_cols = list(range(base, base + len(upcoming_nodes)))
    virtual_cols = list(range(base + len(upcoming_nodes),
                              base + len(extras)))
    # the upcoming ramp stays below the virtual tier however many
    # columns boot (past ~500 it would cross it)
    upcoming_cap = float(VIRTUAL_NODE_PENALTY) - VIRTUAL_COLUMN_STEP
    penalties: Dict[int, float] = {
        c: min(UPCOMING_NODE_PENALTY + j * VIRTUAL_COLUMN_STEP, upcoming_cap)
        for j, c in enumerate(upcoming_cols)
    }
    penalties.update({
        c: float(VIRTUAL_NODE_PENALTY) + j * VIRTUAL_COLUMN_STEP
        for j, c in enumerate(virtual_cols)
    })
    col_of = {name: i for i, name in enumerate(cluster.node_names)}
    disabled = [col_of[n] for n in disabled_names if n in col_of]
    return cluster, batch, penalties, disabled, upcoming_cols, virtual_cols


def _pending_order(pods: Sequence[Pod]) -> List[Pod]:
    """The queue's order (PrioritySort): priority down, then age."""
    return sorted(pods, key=lambda p: (-p.priority(),
                                       p.metadata.creation_timestamp or 0.0,
                                       p.metadata.name))


def scale_up_option(
    nodes: Sequence[Node],
    bound_pods: Sequence[Pod],
    pending: Sequence[Pod],
    group: NodeGroup,
    headroom: int,
    *,
    upcoming_nodes: Sequence[Node] = (),
    serial: bool = False,
    max_virtual: int = 64,
    params: SolverParams = SolverParams(),
    pad_pods: int = 64,
    device=None,
) -> Optional[ScaleUpOption]:
    """One group's what-if: K = min(headroom, |pending|, max_virtual)
    virtual columns of the group's template; the columns that received
    pods are the nodes needed."""
    k = max(0, min(int(headroom), len(pending), int(max_virtual)))
    if k == 0:
        return None
    virt = [group.node_template(f"{WHATIF_PREFIX}-{i}") for i in range(k)]
    res = run_whatif(nodes, bound_pods, pending, new_nodes=virt,
                     upcoming_nodes=upcoming_nodes, serial=serial,
                     params=params, pad_pods=pad_pods, device=device)
    placed = int((res.assignments >= 0).sum())
    pods_on_new = int(sum(int(res.counts[c]) for c in res.virtual_cols))
    nodes_needed = int(sum(1 for c in res.virtual_cols if res.counts[c] > 0))
    return ScaleUpOption(group=group.name, nodes_needed=nodes_needed,
                         pods_placed=placed, pods_on_new=pods_on_new,
                         waste=_waste(res, set(res.virtual_cols)))


def _waste(res: WhatIfResult, vset: set) -> float:
    """The mean unused cpu and memory share over the virtual columns that
    were used (the least-waste expander's criterion)."""
    used: Dict[int, Tuple[int, int]] = {}
    for bi, col in enumerate(res.assignments):
        col = int(col)
        if col in vset:
            uc, um = used.get(col, (0, 0))
            used[col] = (uc + int(res.batch.requests[bi, 0]),
                         um + int(res.batch.requests[bi, 1]))
    fracs = []
    for col, (uc, um) in used.items():
        ac = max(int(res.cluster.allocatable[col, 0]), 1)
        am = max(int(res.cluster.allocatable[col, 1]), 1)
        fracs.append(((ac - uc) / ac + (am - um) / am) / 2.0)
    return sum(fracs) / len(fracs) if fracs else 0.0


def _expand_least_waste(options: List[ScaleUpOption], groups
                        ) -> ScaleUpOption:
    """Most pods helped, then least waste, fewest nodes, name."""
    return min(options, key=lambda o: (-o.pods_placed, o.waste,
                                       o.nodes_needed, o.group))


def _expand_priority(options: List[ScaleUpOption], groups) -> ScaleUpOption:
    """The highest group priority; then pods helped, fewest nodes,
    name."""
    def prio(o: ScaleUpOption) -> int:
        g = groups.get(o.group)
        return g.priority if g is not None else 0

    return min(options, key=lambda o: (-prio(o), -o.pods_placed,
                                       o.nodes_needed, o.group))


EXPANDERS = {
    "least-waste": _expand_least_waste,
    "priority": _expand_priority,
}


def plan_scale_up(
    nodes: Sequence[Node],
    bound_pods: Sequence[Pod],
    pending: Sequence[Pod],
    groups: Sequence[Tuple[NodeGroup, int]],
    expander: str = "least-waste",
    *,
    upcoming: Sequence[Node] = (),
    serial: bool = False,
    max_virtual: int = 64,
    max_pods: int = 2048,
    params: SolverParams = SolverParams(),
    pad_pods: int = 64,
    device=None,
) -> ScaleUpPlan:
    """One what-if per candidate group (``groups`` pairs each with its
    headroom) over the first ``max_pods`` pending pods in queue order,
    then the expander's choice among the groups whose new nodes took
    pods."""
    pending = _pending_order(pending)[: max_pods]
    options: List[ScaleUpOption] = []
    solves = 0
    for group, headroom in groups:
        opt = scale_up_option(
            nodes, bound_pods, pending, group, headroom,
            upcoming_nodes=upcoming, serial=serial, max_virtual=max_virtual,
            params=params, pad_pods=pad_pods, device=device)
        if opt is None:
            continue
        solves += 1
        if opt.pods_on_new > 0 and opt.nodes_needed > 0:
            options.append(opt)
    chosen = None
    if options:
        by_name = {g.name: g for g, _ in groups}
        chosen = EXPANDERS[expander](options, by_name)
    return ScaleUpPlan(chosen=chosen, options=options, solves=solves)


def _unbound_copy(pod: Pod) -> Pod:
    p = shallow_copy(pod)
    p.spec = copy.copy(pod.spec)
    p.spec.node_name = ""
    return p


def pods_fit_elsewhere(
    nodes: Sequence[Node],
    bound_pods: Sequence[Pod],
    node_name: str,
    its_pods: Sequence[Pod],
    *,
    serial: bool = False,
    params: SolverParams = SolverParams(),
    pad_pods: int = 64,
    device=None,
) -> bool:
    """Scale-down: with ``node_name``'s column disabled, does each of its
    pods find a node? Conservative: its pods stay in the usage and the
    topology counts, where they only make a placement harder. A host-only
    pod never fits: the scan never places its row, so the answer is
    False without a solve."""
    if not its_pods:
        return True
    if any(is_host_only(p) for p in its_pods):
        return False
    unbound = [_unbound_copy(p) for p in its_pods]
    res = run_whatif(nodes, bound_pods, unbound, disabled_names=[node_name],
                     serial=serial, params=params, pad_pods=pad_pods,
                     device=device)
    return bool(np.all(res.assignments[: len(unbound)] >= 0))


def _serial_whatif(
    cluster: EncodedCluster, batch: EncodedBatch,
    params: SolverParams = SolverParams(),
    deprioritized_cols=(),
    disabled_cols=(),
):
    """The host oracle: one Python iteration a pod, numpy over the nodes
    (the shape of the reference's serial simulation), over the same
    encoded planes and with ``solve_whatif``'s contract. All float
    arithmetic is float32, as the scan's."""
    f32 = np.float32
    n = cluster.allocatable.shape[0]
    v = batch.num_values
    allocatable = cluster.allocatable.astype(np.int32)
    requested = cluster.requested.astype(np.int32).copy()
    nonzero_requested = cluster.nonzero_requested.astype(np.int32).copy()
    pod_count = cluster.pod_count.astype(np.int32).copy()
    sc_counts = batch.sc_counts.astype(np.int32).copy()
    term_counts = batch.term_counts.astype(np.int32).copy()
    term_owners = batch.term_owners.astype(np.int32).copy()
    sc_codes = np.minimum(
        cluster.topo_codes[:, batch.sc_key_idx].T, v).astype(np.int32)
    term_codes = np.minimum(
        cluster.topo_codes[:, batch.term_key_idx].T, v).astype(np.int32)
    node_valid = np.zeros(n, dtype=bool)
    node_valid[: cluster.num_real_nodes] = True
    if len(disabled_cols):
        node_valid[np.asarray(list(disabled_cols), dtype=np.int64)] = False
    static_scores = np.array(batch.static_scores, dtype=f32, copy=True)
    if len(deprioritized_cols):
        if hasattr(deprioritized_cols, "items"):
            for col, penalty in deprioritized_cols.items():
                static_scores[:, int(col)] -= f32(penalty)
        else:
            cols = np.asarray(list(deprioritized_cols), dtype=np.int64)
            static_scores[:, cols] -= VIRTUAL_NODE_PENALTY
    alloc_cpu = np.maximum(allocatable[:, 0], 1).astype(f32)
    alloc_mem = np.maximum(allocatable[:, 1], 1).astype(f32)
    arange_sc = np.arange(sc_counts.shape[0])
    arange_t = np.arange(term_counts.shape[0])
    b = batch.num_real_pods
    assignments = np.full(b, -1, dtype=np.int32)
    for bi in range(b):
        if batch.inexpressible[bi]:
            continue
        req = batch.requests[bi].astype(np.int32)
        nz = batch.nonzero_requests[bi].astype(np.int32)
        profile = int(batch.profile_idx[bi])
        pod_sc = batch.pod_sc[bi]
        pod_sc_match = batch.pod_sc_match[bi]
        match_by = batch.match_by[bi]
        own_aff = batch.own_aff[bi]
        own_anti = batch.own_anti[bi]
        pref_weight = batch.pref_weight[bi].astype(f32)

        fit = np.all(requested + req[None, :] <= allocatable, axis=1)
        fit &= pod_count < cluster.max_pods
        counts_at = np.take_along_axis(sc_counts, sc_codes, axis=1)
        domain = batch.sc_domain[profile]
        min_c = np.min(np.where(domain[:, :v], sc_counts[:, :v], BIG),
                       axis=1)
        min_c = np.where(np.any(domain[:, :v], axis=1), min_c, 0)
        skew = counts_at + pod_sc_match[:, None].astype(np.int32) \
            - min_c[:, None]
        active_hard = pod_sc & batch.sc_hard
        spread_violation = np.any(
            active_hard[:, None]
            & ((skew > batch.sc_max_skew[:, None]) | (sc_codes >= v)),
            axis=0)
        tcounts_at = np.take_along_axis(term_counts, term_codes, axis=1)
        towners_at = np.take_along_axis(term_owners, term_codes, axis=1)
        existing_anti = np.any(match_by[:, None] & (towners_at > 0), axis=0)
        own_anti_block = np.any(own_anti[:, None] & (tcounts_at > 0), axis=0)
        aff_here = (tcounts_at > 0) & (term_codes < v)
        aff_sat = np.all(~own_aff[:, None] | aff_here, axis=0)
        totals = np.sum(term_counts[:, :v], axis=1)
        no_any = bool(np.all(~own_aff | (totals == 0)))
        self_all = bool(np.all(~own_aff | match_by))
        aff_ok = aff_sat | (no_any and self_all) if np.any(own_aff) \
            else np.ones(n, dtype=bool)
        feasible = (node_valid & batch.static_masks[profile] & fit
                    & ~spread_violation & ~existing_anti & ~own_anti_block
                    & aff_ok)
        if not np.any(feasible):
            continue

        cpu_frac = (nonzero_requested[:, 0] + nz[0]).astype(f32) / alloc_cpu
        mem_frac = (nonzero_requested[:, 1] + nz[1]).astype(f32) / alloc_mem
        over = (cpu_frac >= 1.0) | (mem_frac >= 1.0)
        balanced = np.where(
            over, f32(0.0),
            (f32(1.0) - np.abs(cpu_frac - mem_frac)) * f32(100.0))
        least = (np.clip(f32(1.0) - cpu_frac, 0.0, 1.0)
                 + np.clip(f32(1.0) - mem_frac, 0.0, 1.0)) * f32(50.0)
        active_soft = pod_sc & ~batch.sc_hard
        soft_counts = np.sum(np.where(active_soft[:, None], counts_at, 0),
                             axis=0).astype(f32)
        spread_score = f32(100.0) / (f32(1.0) + soft_counts) \
            if np.any(active_soft) else np.zeros(n, dtype=f32)
        pref_score = np.sum(pref_weight[:, None] * tcounts_at.astype(f32),
                            axis=0)
        score = (f32(params.balanced_weight) * balanced
                 + f32(params.least_weight) * least
                 + f32(params.spread_weight) * spread_score
                 + f32(params.affinity_weight) * pref_score
                 + f32(params.static_weight) * static_scores[profile])
        score = np.where(feasible, score, f32(NEG_INF))
        chosen = int(np.argmax(score))
        assignments[bi] = chosen
        requested[chosen] += req
        nonzero_requested[chosen] += nz
        pod_count[chosen] += 1
        np.add.at(sc_counts, (arange_sc, sc_codes[:, chosen]),
                  pod_sc_match.astype(np.int32))
        np.add.at(term_counts, (arange_t, term_codes[:, chosen]),
                  match_by.astype(np.int32))
        np.add.at(term_owners, (arange_t, term_codes[:, chosen]),
                  own_anti.astype(np.int32))
    counts = np.bincount(assignments[assignments >= 0], minlength=n)
    return assignments, counts
