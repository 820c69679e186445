"""ClusterRole aggregation controller (the reference's
``pkg/controller/clusterroleaggregation``): a ClusterRole with an
aggregation rule has its ``rules`` replaced by the union of the rules of
every ClusterRole that one of its label selectors matches, as the
``admin``, ``edit`` and ``view`` roles take in the roles of new kinds.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import ClusterRole, PolicyRule
from kubernetes_tpu_torch.controllers.base import Controller


def _rule_key(r: PolicyRule) -> tuple:
    return (tuple(sorted(r.verbs)), tuple(sorted(r.resources)),
            tuple(sorted(r.resource_names)),
            tuple(sorted(r.non_resource_urls)))


class ClusterRoleAggregationController(Controller):
    name = "clusterrole-aggregation"

    def register(self) -> None:
        self.factory.informer_for("ClusterRole").add_event_handler(
            on_add=lambda r: self._enqueue_aggregates(),
            on_update=lambda o, n: self._enqueue_aggregates(),
            on_delete=lambda r: self._enqueue_aggregates(),
        )

    def _enqueue_aggregates(self) -> None:
        for role in self.store.list_cluster_roles():
            if role.aggregation_label_selectors:
                self.enqueue_key(role.name)

    def sync(self, key: str) -> None:
        role = self.store.get_cluster_role(key)
        if role is None or not role.aggregation_label_selectors:
            return
        union: dict = {}
        for candidate in sorted(self.store.list_cluster_roles(),
                                key=lambda r: r.name):
            labels = candidate.metadata.labels
            if candidate.name == key or not any(
                    all(labels.get(k) == v for k, v in sel.items())
                    for sel in role.aggregation_label_selectors):
                continue
            for rule in candidate.rules:
                union.setdefault(_rule_key(rule), rule)
        want = list(union.values())
        if [_rule_key(r) for r in role.rules] == [_rule_key(r) for r in want]:
            return

        def mutate(r: ClusterRole) -> bool:
            r.rules = want
            return True

        self.store.mutate_object("ClusterRole", "", key, mutate)
