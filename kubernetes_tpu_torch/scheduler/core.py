"""The generic scheduling algorithm of the serial path: snapshot ->
PreFilter -> Filter over the nodes from a round-robin start index,
stopping once enough feasible nodes are found (the adaptive percentage
of nodes to score) -> the extenders' filters -> PreScore and Score, plus
the extenders' weighted priorities -> the host with the highest score,
a tie broken by reservoir sampling from the scheduler's
``random.Random``.

Filter fans out over the nodes through the framework's parallelizer
(``utils.parallelize``). With ``parallelism=1`` it runs over them in
order on the calling thread, so the feasible list and the next start
index are the ones of a plain loop; with more workers the feasible list
follows the order the workers finish in, as in the JAX package. The
extenders run one after another, each on the list the last left; a
failed call is skipped for an ignorable extender and fails the attempt
otherwise. With the ``PreferNominatedNode`` gate on, a pod with a
nominated node that passes Filter and the extenders goes there without
a search.
"""

from __future__ import annotations

import random
import threading
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
                 percentage_of_nodes_to_score: int = 0, extenders=(),
                 feature_gates=None):
        self.cache = cache
        self.snapshot = snapshot
        self.rng = rng
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.extenders = list(extenders)
        self.feature_gates = feature_gates
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
        if (self.feature_gates is not None
                and self.feature_gates.enabled("PreferNominatedNode")
                and pod.status.nominated_node_name):
            ni = self.snapshot.get(pod.status.nominated_node_name)
            if ni is not None and ni.node is not None and fw.Status.is_ok(
                    fwk.run_filter_plugins_with_nominated_pods(state, pod,
                                                               ni)):
                feasible = self._extender_filter(pod, [ni], statuses)
                if feasible:
                    return feasible, statuses
        feasible = self._find_nodes_that_pass_filters(state, fwk, pod,
                                                      statuses)
        return self._extender_filter(pod, feasible, statuses), statuses

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
        lock = threading.Lock()
        done = [False]
        processed = [0]

        def check(i: int) -> None:
            ni = all_nodes[(start + i) % num_all]
            status = fwk.run_filter_plugins_with_nominated_pods(state, pod, ni)
            with lock:
                processed[0] += 1
                if fw.Status.is_ok(status):
                    if len(feasible) < num_to_find:
                        feasible.append(ni)
                    if len(feasible) >= num_to_find:
                        done[0] = True
                elif ni.node is not None:
                    statuses[ni.node.name] = status

        fwk.parallelizer.until(num_all, check, stop_check=lambda: done[0])
        self.next_start_node_index = (start + processed[0]) % num_all
        return feasible

    def _extender_filter(self, pod: Pod, feasible: List[NodeInfo],
                         statuses: fw.NodeToStatusMap) -> List[NodeInfo]:
        """Each interested extender's filter in turn, on the list the last
        left; the nodes it fails get its reason as their status."""
        for ext in self.extenders:
            if not feasible:
                break
            if not ext.is_interested(pod):
                continue
            try:
                feasible, failed = ext.filter(pod, feasible)
            except Exception:
                if ext.is_ignorable():
                    continue
                raise
            for name, reason in failed.items():
                statuses[name] = fw.Status(fw.UNSCHEDULABLE, reason)
        return feasible

    def prioritize_nodes(self, state: CycleState, fwk: Framework, pod: Pod,
                         nodes: List[NodeInfo]) -> List[fw.NodeScore]:
        node_names = [ni.node.name for ni in nodes]
        if not fwk.has_score_plugins() and not self.extenders:
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
        for ext in self.extenders:
            if not ext.is_interested(pod):
                continue
            try:
                contributions = ext.prioritize(pod, nodes)
            except Exception:
                if ext.is_ignorable():
                    continue
                raise
            for name, score in contributions.items():
                if name in totals:
                    totals[name] += int(score)
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
