"""The generic scheduling algorithm of the serial path: snapshot ->
PreFilter -> Filter over the nodes from a round-robin start index,
stopping once enough feasible nodes are found (the adaptive percentage
of nodes to score) -> PreScore and Score -> the host with the highest
score, a tie broken by reservoir sampling from the scheduler's
``random.Random``.

Filter runs over the nodes in order, one at a time: the feasible set and
the next start index are the ones the JAX package's scheduler gives with
``parallelism=1``. Extenders are not part of this port.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework import interface as fw
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.framework.runtime import Framework
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.types import NodeInfo
from kubernetes_tpu_torch.utils.trace import Trace

MIN_FEASIBLE_NODES_TO_FIND = 100
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5


@dataclass
class ScheduleResult:
    suggested_host: str
    evaluated_nodes: int
    feasible_nodes: int


class GenericScheduler:
    def __init__(self, cache, snapshot: Snapshot, rng: random.Random,
                 percentage_of_nodes_to_score: int = 0):
        self.cache = cache
        self.snapshot = snapshot
        self.rng = rng
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.next_start_node_index = 0

    def update_snapshot(self) -> None:
        self.cache.update_snapshot(self.snapshot)

    def schedule(self, state: CycleState, fwk: Framework, pod: Pod
                 ) -> ScheduleResult:
        """The host for ``pod``; raises ``FitError`` when no node fits.
        Each attempt, a failed one too, is a step trace (``Scheduling``)."""
        trace = Trace("Scheduling", pod=pod.full_name(), uid=pod.uid)
        try:
            self.update_snapshot()
            trace.step("Snapshotting scheduler cache and node infos done")
            if self.snapshot.num_nodes() == 0:
                raise fw.FitError(pod=pod, num_all_nodes=0)
            feasible, statuses = self.find_nodes_that_fit_pod(state, fwk,
                                                              pod)
            trace.step("Computing predicates done")
            if not feasible:
                raise fw.FitError(pod=pod,
                                  num_all_nodes=self.snapshot.num_nodes(),
                                  filtered_nodes_statuses=statuses)
            if len(feasible) == 1:
                return ScheduleResult(feasible[0].node.name,
                                      self.snapshot.num_nodes(), 1)
            priority_list = self.prioritize_nodes(state, fwk, pod, feasible)
            trace.step("Prioritizing done")
            host = self.select_host(priority_list)
            trace.step("Selecting host done")
            return ScheduleResult(host, self.snapshot.num_nodes(),
                                  len(feasible))
        finally:
            trace.log_if_long(0.1)

    def num_feasible_nodes_to_find(self, num_all_nodes: int) -> int:
        """All nodes below 100 or at 100%; else the configured percentage,
        or by default 50% less one point per 125 nodes, at least 5%, and
        never under 100 nodes."""
        if (num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND
                or self.percentage_of_nodes_to_score >= 100):
            return num_all_nodes
        adaptive = self.percentage_of_nodes_to_score
        if adaptive <= 0:
            adaptive = max(50 - num_all_nodes // 125,
                           MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND)
        return max(num_all_nodes * adaptive // 100,
                   MIN_FEASIBLE_NODES_TO_FIND)

    def find_nodes_that_fit_pod(self, state: CycleState, fwk: Framework,
                                pod: Pod
                                ) -> Tuple[List[NodeInfo],
                                           fw.NodeToStatusMap]:
        statuses: fw.NodeToStatusMap = {}
        status = fwk.run_pre_filter_plugins(state, pod)
        if not fw.Status.is_ok(status):
            if status.is_unschedulable():
                for ni in self.snapshot.list():
                    if ni.node is not None:
                        statuses[ni.node.name] = status
                return [], statuses
            raise status.as_error()
        return self._find_nodes_that_pass_filters(state, fwk, pod,
                                                  statuses), statuses

    def _find_nodes_that_pass_filters(self, state: CycleState,
                                      fwk: Framework, pod: Pod,
                                      statuses: fw.NodeToStatusMap
                                      ) -> List[NodeInfo]:
        all_nodes = self.snapshot.list()
        num_all = len(all_nodes)
        num_to_find = self.num_feasible_nodes_to_find(num_all)
        start = self.next_start_node_index
        if not fwk.has_filter_plugins():
            self.next_start_node_index = (start + num_to_find) % num_all
            return [all_nodes[(start + i) % num_all]
                    for i in range(num_to_find)]
        feasible: List[NodeInfo] = []
        processed = 0
        for i in range(num_all):
            if len(feasible) >= num_to_find:
                break
            ni = all_nodes[(start + i) % num_all]
            status = fwk.run_filter_plugins_with_nominated_pods(state, pod, ni)
            processed += 1
            if fw.Status.is_ok(status):
                feasible.append(ni)
            elif ni.node is not None:
                statuses[ni.node.name] = status
        self.next_start_node_index = (start + processed) % num_all
        return feasible

    def prioritize_nodes(self, state: CycleState, fwk: Framework, pod: Pod,
                         nodes: List[NodeInfo]) -> List[fw.NodeScore]:
        node_names = [ni.node.name for ni in nodes]
        if not fwk.has_score_plugins():
            return [fw.NodeScore(n, 1) for n in node_names]
        status = fwk.run_pre_score_plugins(state, pod, nodes)
        if not fw.Status.is_ok(status):
            raise status.as_error()
        plugin_scores, status = fwk.run_score_plugins(state, pod, node_names)
        if not fw.Status.is_ok(status):
            raise status.as_error()
        totals: Dict[str, int] = {n: 0 for n in node_names}
        for per_node in plugin_scores.values():
            for ns in per_node:
                totals[ns.name] += ns.score
        return [fw.NodeScore(n, totals[n]) for n in node_names]

    def select_host(self, priority_list: List[fw.NodeScore]) -> str:
        """The highest score; among equal scores, each is kept with
        probability 1/count as they come (reservoir sampling)."""
        if not priority_list:
            raise ValueError("empty priority list")
        max_score = priority_list[0].score
        selected = priority_list[0].name
        count = 1
        for ns in priority_list[1:]:
            if ns.score > max_score:
                max_score, selected, count = ns.score, ns.name, 1
            elif ns.score == max_score:
                count += 1
                if self.rng.randrange(count) == 0:
                    selected = ns.name
        return selected
