"""DefaultPreemption PostFilter (reference
``plugins/defaultpreemption/default_preemption.go``):

preempt → eligibility check → FindCandidates (dry-run victim selection per
candidate node, PDB-aware) → SelectCandidate (pickOneNodeForPreemption's
criteria chain) → PrepareCandidate (delete victims, clear stale lower-
priority nominations) → return the nominated node name.

The dry run clones NodeInfo+CycleState, removes lower-priority pods via the
PreFilterExtensions RemovePod path, re-runs filters, then re-adds victims
in priority order to minimize evictions (selectVictimsOnNode :600).
"""

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    NodeToStatusMap,
    PostFilterPlugin,
    PostFilterResult,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo


class _Candidate:
    __slots__ = ("node_name", "victims", "num_pdb_violations")

    def __init__(self, node_name: str, victims: List[Pod], num_pdb_violations: int):
        self.node_name = node_name
        self.victims = victims
        self.num_pdb_violations = num_pdb_violations


class DefaultPreemption(PostFilterPlugin):
    NAME = "DefaultPreemption"

    @staticmethod
    def factory(args, handle):
        return DefaultPreemption(handle, args or {})

    def __init__(self, handle=None, args=None):
        args = args or {}
        self.handle = handle
        self.min_candidate_nodes_percentage = int(
            args.get("minCandidateNodesPercentage", 10)
        )
        self.min_candidate_nodes_absolute = int(
            args.get("minCandidateNodesAbsolute", 100)
        )

    # ------------------------------------------------------------------
    def post_filter(self, state, pod: Pod, statuses: NodeToStatusMap):
        client = self.handle.client
        # re-fetch: the pod object may be stale (default_preemption.go:128)
        fresh = client.get_pod(pod.namespace, pod.name)
        if fresh is not None:
            pod = fresh
        if not self._eligible_to_preempt_others(pod):
            return None, Status(
                UNSCHEDULABLE, "preemption is not helpful for scheduling"
            )
        candidates = self._find_candidates(state, pod, statuses)
        if not candidates:
            return None, Status(UNSCHEDULABLE, "no preemption victims found")
        best = self._select_candidate(candidates)
        status = self._prepare_candidate(best, pod)
        if status is not None:
            return None, status
        return PostFilterResult(nominated_node_name=best.node_name), None

    # ------------------------------------------------------------------
    def _eligible_to_preempt_others(self, pod: Pod) -> bool:
        """default_preemption.go:246 PodEligibleToPreemptOthers."""
        return pod_eligible_to_preempt_others(pod, self.handle.snapshot())

    # CycleState key for the candidate hints the batch path's preemption
    # screen ranks (scheduler/preemption_screen.py)
    HINTS_KEY = "DefaultPreemption/candidate-hints"
    # with trusted hints, a handful of validated candidates suffices —
    # the screen already ranked the whole cluster
    HINTED_DRY_RUNS = 4

    def _find_candidates(
        self, state, pod: Pod, statuses: NodeToStatusMap
    ) -> List[_Candidate]:
        snapshot = self.handle.snapshot()
        try:
            hints = state.read(self.HINTS_KEY)
        except KeyError:
            hints = None
        if hints:
            candidates = self._dry_run_hints(state, pod, statuses,
                                             snapshot, hints)
            if candidates:
                return candidates
            # stale/empty hints: fall through to the unpruned scan
        # nodes where preemption might help: everything not marked
        # UnschedulableAndUnresolvable (:274 nodesWherePreemptionMightHelp)
        potential = [
            ni
            for ni in snapshot.list()
            if ni.node is not None
            and (
                statuses.get(ni.node.name) is None
                or statuses[ni.node.name].code != UNSCHEDULABLE_AND_UNRESOLVABLE
            )
        ]
        pdbs = self.handle.client.list_pdbs()
        # getOffsetAndNumCandidates (default_preemption.go:195): dry-run
        # from a random offset, stopping once enough candidates are found
        # (>= max(n * MinCandidateNodesPercentage%, ...Absolute)) — the
        # adaptive-sampling analog for preemption; evaluating all nodes
        # is both off-spec and quadratic under mass preemption
        n = len(potential)
        if n == 0:
            return []
        num_candidates = min(
            max(
                n * self.min_candidate_nodes_percentage // 100,
                self.min_candidate_nodes_absolute,
            ),
            n,
        )
        offset = self.handle.rng.randrange(n)
        candidates = []
        non_violating_found = False
        for k in range(n):
            ni = potential[(offset + k) % n]
            result = self._select_victims_on_node(state, pod, ni, pdbs)
            if result is not None:
                victims, violations = result
                candidates.append(
                    _Candidate(ni.node.name, victims, violations)
                )
                if violations == 0:
                    non_violating_found = True
                # upstream only cancels the dry-run once a PDB-NON-
                # violating candidate exists (dryRunPreemption keeps
                # scanning otherwise), so a run of violating-only nodes
                # after the offset cannot force a needless PDB break
                if len(candidates) >= num_candidates and non_violating_found:
                    break
        return candidates

    def _dry_run_hints(self, state, pod: Pod, statuses: NodeToStatusMap,
                       snapshot, hints) -> List[_Candidate]:
        """Dry-run the batch screen's ranked candidates (full filter
        fidelity — the screen only pruned). Stops once a few validated
        candidates exist with at least one PDB-non-violating choice."""
        pdbs = self.handle.client.list_pdbs()
        candidates: List[_Candidate] = []
        non_violating_found = False
        for name in hints:
            st = statuses.get(name)
            if st is not None and st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue
            ni = snapshot.get(name)
            if ni is None or ni.node is None:
                continue
            result = self._select_victims_on_node(state, pod, ni, pdbs)
            if result is None:
                continue
            victims, violations = result
            candidates.append(_Candidate(name, victims, violations))
            if violations == 0:
                non_violating_found = True
            if len(candidates) >= self.HINTED_DRY_RUNS and \
                    non_violating_found:
                break
        return candidates

    def _select_victims_on_node(
        self, state, pod: Pod, node_info: NodeInfo, pdbs
    ) -> Optional[Tuple[List[Pod], int]]:
        """default_preemption.go:600 selectVictimsOnNode."""
        fwk = self.handle
        node_copy = node_info.clone()
        state_copy = state.clone()

        potential_victims = [
            pi.pod for pi in node_copy.pods if pi.pod.priority() < pod.priority()
        ]
        if not potential_victims:
            return None

        for victim in potential_victims:
            node_copy.remove_pod(victim)
            fwk.run_pre_filter_extension_remove_pod(state_copy, pod, victim, node_copy)

        status = fwk.run_filter_plugins_with_nominated_pods(state_copy, pod, node_copy)
        if not Status.is_ok(status):
            return None

        violating, non_violating = _split_pods_by_pdb_violation(potential_victims, pdbs)
        victims: List[Pod] = []
        num_violations = 0

        def reprieve(victim: Pod) -> bool:
            """Try to keep this pod; re-add it and check filters still pass."""
            node_copy.add_pod(victim)
            fwk.run_pre_filter_extension_add_pod(state_copy, pod, victim, node_copy)
            s = fwk.run_filter_plugins_with_nominated_pods(state_copy, pod, node_copy)
            if Status.is_ok(s):
                return True
            node_copy.remove_pod(victim)
            fwk.run_pre_filter_extension_remove_pod(state_copy, pod, victim, node_copy)
            return False

        # re-add by descending priority; PDB-violating candidates first so
        # they're the most likely to be reprieved
        for victim in sorted(violating, key=lambda p: -p.priority()):
            if not reprieve(victim):
                victims.append(victim)
                num_violations += 1
        for victim in sorted(non_violating, key=lambda p: -p.priority()):
            if not reprieve(victim):
                victims.append(victim)
        if not victims:
            return None
        return victims, num_violations

    # ------------------------------------------------------------------
    @staticmethod
    def _select_candidate(candidates: List[_Candidate]) -> _Candidate:
        """default_preemption.go:465 pickOneNodeForPreemption criteria
        chain: fewest PDB violations → lowest max victim priority → smallest
        priority sum → fewest victims → stable order."""

        def key(c: _Candidate):
            priorities = [v.priority() for v in c.victims]
            return (
                c.num_pdb_violations,
                max(priorities, default=0),
                sum(priorities),
                len(c.victims),
            )

        return min(candidates, key=key)

    def _prepare_candidate(self, candidate: _Candidate, pod: Pod) -> Optional[Status]:
        """default_preemption.go:698 PrepareCandidate: evict victims, clear
        stale nominations of lower-priority pods on the chosen node."""
        client = self.handle.client
        recorder = getattr(self.handle, "event_recorder", None)
        for victim in candidate.victims:
            # a waiting (Permit-parked) victim is rejected instead of deleted
            if not self.handle.reject_waiting_pod(victim.uid):
                try:
                    client.delete_pod(victim.namespace, victim.name)
                except Exception as e:
                    return Status(1, f"deleting victim {victim.full_name()}: {e}")
            if recorder is not None:
                recorder.event(
                    victim, "Normal", "Preempted",
                    f"Preempted by {pod.namespace}/{pod.metadata.name} on "
                    f"node {candidate.node_name}")
        nominator = self.handle.pod_nominator
        if nominator is not None:
            for pi in list(nominator.nominated_pods_for_node(candidate.node_name)):
                if pi.pod.priority() < pod.priority():
                    nominator.delete_nominated_pod_if_exists(pi.pod)
                    client.clear_nominated_node_name(pi.pod.namespace, pi.pod.name)
        return None


def pdb_covers(pod: Pod, pdb) -> bool:
    """Does this PDB select this pod? The single matching predicate
    shared by the dry-run's violation split and the batch planner's
    conservative victim exclusion."""
    return pdb.namespace == pod.namespace and \
        pdb.selector.matches(pod.metadata.labels)


def pod_eligible_to_preempt_others(pod: Pod, snapshot=None) -> bool:
    """default_preemption.go:246 PodEligibleToPreemptOthers — shared by
    the serial PostFilter and the batch victim planner (the two must
    gate identically or the batch path evicts for pods the reference
    would refuse, e.g. preemptionPolicy Never)."""
    if pod.spec.preemption_policy == "Never":
        return False
    nominated = pod.status.nominated_node_name
    if nominated and snapshot is not None:
        ni = snapshot.get(nominated)
        if ni is not None:
            # a previous preemption is still playing out: wait for it
            if any(
                pi.pod.metadata.deletion_timestamp is not None
                and pi.pod.priority() < pod.priority()
                for pi in ni.pods
            ):
                return False
    return True


def _split_pods_by_pdb_violation(pods: List[Pod], pdbs) -> Tuple[List[Pod], List[Pod]]:
    """Pods whose eviction would violate a PodDisruptionBudget (reference
    filterPodsWithPDBViolation)."""
    violating, non_violating = [], []
    for pod in pods:
        violates = any(
            pdb_covers(pod, pdb) and pdb.disruptions_allowed <= 0
            for pdb in pdbs
        )
        if violates:
            violating.append(pod)
        else:
            non_violating.append(pod)
    return violating, non_violating
