"""RBAC authorization (reference ``plugin/pkg/auth/authorizer/rbac/
rbac.go:159 New`` + the bootstrap policy in ``plugin/pkg/auth/authorizer/
rbac/bootstrappolicy/policy.go``).

The authorizer is a plain callable matching the API server's
``Authorizer`` seam (``apiserver/rest.py``): ``(user, verb, kind,
namespace) -> bool``. Evaluation order mirrors the reference's
VisitRulesFor: cluster-role bindings grant cluster-wide; role bindings
grant within their namespace, resolving either a namespaced Role or a
referenced ClusterRole (scoped down to the binding's namespace).

Group model: the reference's authenticator attaches groups to every
request; this server's bearer-token authn yields a bare username, so the
authorizer derives groups — every non-anonymous user is
``system:authenticated``, plus any static groups registered via
``add_user_to_group`` (bootstrap puts ``admin`` in ``system:masters``,
which short-circuits to allow, mirroring the superuser escape hatch).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

from kubernetes_tpu_torch.api.types import (
    ClusterRole,
    ClusterRoleBinding,
    ObjectMeta,
    PolicyRule,
    RBACSubject,
    RoleRef,
)

AUTHENTICATED = "system:authenticated"
MASTERS = "system:masters"
ANONYMOUS = "system:anonymous"


def _verb_matches(rule: PolicyRule, verb: str) -> bool:
    return "*" in rule.verbs or verb in rule.verbs


def _resource_matches(rule: PolicyRule, resource: str) -> bool:
    return "*" in rule.resources or resource in rule.resources


def rule_allows(rule: PolicyRule, verb: str, resource: str,
                name: str = "") -> bool:
    """reference rbac.RuleAllows: verb AND resource must match; a rule
    with resourceNames further restricts to those objects."""
    if not _verb_matches(rule, verb) or not _resource_matches(rule, resource):
        return False
    if rule.resource_names:
        # a names-scoped rule only matches requests naming one of them
        # (list/watch carry no name and are NOT granted by named rules)
        return bool(name) and name in rule.resource_names
    return True


class RBACAuthorizer:
    """Store-backed RBAC authorizer, usable directly as the APIServer's
    ``authorizer=`` callable and by ``kubectl auth can-i``."""

    def __init__(self, store):
        self.store = store
        self._groups: Dict[str, Set[str]] = {}
        # bumped on static-group edits so the REST layer's decision
        # cache (rest.py authorize_cached) can observe policy changes
        # that don't flow through store events
        self.policy_gen = 0

    # -- group registry ------------------------------------------------
    def add_user_to_group(self, user: str, group: str) -> None:
        self._groups.setdefault(user, set()).add(group)
        self.policy_gen += 1

    def groups_for(self, user: str) -> Set[str]:
        groups = set(self._groups.get(user, ()))
        if user and user != ANONYMOUS:
            groups.add(AUTHENTICATED)
        # identity-derived groups, as the reference authenticators
        # attach them: node users join system:nodes (pkg/auth x509/
        # bootstrap authenticators), service accounts join
        # system:serviceaccounts and their namespace group
        # (pkg/serviceaccount/util.go MakeGroupNames)
        if user.startswith("system:node:"):
            groups.add("system:nodes")
        elif user.startswith("system:bootstrap:"):
            # bootstrap-token identities (kubeadm TLS bootstrap;
            # reference bootstrap token authenticator attaches
            # system:bootstrappers)
            groups.add("system:bootstrappers")
        elif user.startswith("system:serviceaccount:"):
            parts = user.split(":")
            if len(parts) == 4:
                groups.add("system:serviceaccounts")
                groups.add(f"system:serviceaccounts:{parts[2]}")
        return groups

    # -- evaluation ----------------------------------------------------
    def _subject_matches(self, subj: RBACSubject, user: str,
                         groups: Set[str]) -> bool:
        if subj.kind == "User":
            return subj.name == user or subj.name == "*"
        if subj.kind == "Group":
            return subj.name in groups
        if subj.kind == "ServiceAccount":
            # the token authn maps SA tokens to
            # system:serviceaccount:<ns>:<name> (reference style)
            return user == f"system:serviceaccount:{subj.namespace}:{subj.name}"
        return False

    def _binding_rules(self, ref: RoleRef,
                       namespace: str) -> List[PolicyRule]:
        if ref.kind == "ClusterRole":
            role = self.store.get_cluster_role(ref.name)
        else:
            role = self.store.get_role(namespace, ref.name)
        return role.rules if role is not None else []

    def authorize(self, user: str, verb: str, resource: str,
                  namespace: str = "", name: str = "") -> bool:
        """``resource`` accepts either the lowercase plural ("pods") or
        a kind name ("Pod" — the REST handler passes kinds); both are
        normalized to the plural the rules use."""
        resource = _normalize_resource(resource, self.store)
        groups = self.groups_for(user)
        if MASTERS in groups:
            return True
        for crb in self.store.list_cluster_role_bindings():
            if any(self._subject_matches(s, user, groups)
                   for s in crb.subjects):
                for rule in self._binding_rules(crb.role_ref, ""):
                    if rule_allows(rule, verb, resource, name):
                        return True
        if namespace:
            for rb in self.store.list_role_bindings(namespace):
                if any(self._subject_matches(s, user, groups)
                       for s in rb.subjects):
                    for rule in self._binding_rules(rb.role_ref, namespace):
                        if rule_allows(rule, verb, resource, name):
                            return True
        return False

    def __call__(self, user: str, verb: str, kind: str,
                 namespace: str) -> bool:
        return self.authorize(user, verb, kind, namespace)


def _normalize_resource(resource: str, store=None) -> str:
    from kubernetes_tpu_torch.apiserver.rest import KIND_TO_PLURAL

    got = KIND_TO_PLURAL.get(resource)
    if got is not None:
        return got
    if resource[:1].isupper():
        # remaining uppercase names are the virtual built-ins with no
        # storage table (exactly "Binding" today), whose regular
        # pluralization is the rule vocabulary ("bindings")
        return resource.lower() + "s"
    return resource


# ---------------------------------------------------------------------------
# bootstrap policy (reference bootstrappolicy/policy.go ClusterRoles() +
# ClusterRoleBindings(): the control-plane components' standing grants)


def _rule(verbs: Iterable[str], resources: Iterable[str]) -> PolicyRule:
    return PolicyRule(verbs=list(verbs), resources=list(resources))


READ = ("get", "list", "watch")


def bootstrap_cluster_roles() -> List[ClusterRole]:
    return [
        ClusterRole(
            metadata=ObjectMeta(name="cluster-admin"),
            rules=[_rule(["*"], ["*"])],
        ),
        # reference policy.go "system:kube-scheduler"
        ClusterRole(
            metadata=ObjectMeta(name="system:kube-scheduler"),
            rules=[
                _rule(["create", "patch", "update"], ["events"]),
                _rule(READ + ("delete",), ["pods"]),
                _rule(["create"], ["bindings", "pods/binding"]),
                _rule(["patch", "update"], ["pods/status"]),
                _rule(READ, [
                    "nodes", "namespaces",
                    "persistentvolumes", "persistentvolumeclaims",
                    "services", "replicasets", "replicationcontrollers",
                    "statefulsets", "storageclasses", "csinodes",
                    "poddisruptionbudgets",
                ]),
                _rule(["update"], ["persistentvolumeclaims",
                                   "persistentvolumes"]),
                # leader-election lease (endpoints/lease model)
                _rule(["get", "create", "update"], ["leases", "endpoints"]),
            ],
        ),
        # reference policy.go "system:kube-controller-manager" (broad:
        # the controllers mutate most kinds; kept narrower than admin)
        ClusterRole(
            metadata=ObjectMeta(name="system:kube-controller-manager"),
            rules=[
                _rule(["*"], [
                    "pods", "nodes", "nodes/status", "services",
                    "endpoints", "endpointslices", "replicasets",
                    "replicationcontrollers", "statefulsets",
                    "deployments", "daemonsets", "jobs", "cronjobs",
                    "namespaces", "serviceaccounts", "resourcequotas",
                    "persistentvolumes", "persistentvolumeclaims",
                    "poddisruptionbudgets", "horizontalpodautoscalers",
                    "events", "leases",
                ]),
                _rule(READ, ["*"]),
            ],
        ),
        # reference policy.go "system:node-bootstrapper": a bootstrap
        # token may submit and watch its own CSR — nothing else
        ClusterRole(
            metadata=ObjectMeta(name="system:node-bootstrapper"),
            rules=[
                _rule(["create"] + list(READ),
                      ["certificatesigningrequests"]),
            ],
        ),
        # reference policy.go "system:node" (kubelet)
        ClusterRole(
            metadata=ObjectMeta(name="system:node"),
            rules=[
                _rule(READ, ["pods", "services", "endpoints",
                             "persistentvolumes",
                             "persistentvolumeclaims", "configmaps",
                             "secrets"]),
                _rule(["get", "patch", "update"],
                      ["nodes", "nodes/status"]),
                _rule(["create"], ["nodes"]),
                _rule(["patch", "update"], ["pods/status"]),
                _rule(["create", "patch", "update"], ["events"]),
                _rule(["delete"], ["pods"]),  # eviction
            ],
        ),
    ]


def bootstrap_cluster_role_bindings() -> List[ClusterRoleBinding]:
    def bind(name: str, role: str, subject: RBACSubject) -> ClusterRoleBinding:
        return ClusterRoleBinding(
            metadata=ObjectMeta(name=name),
            subjects=[subject],
            role_ref=RoleRef(kind="ClusterRole", name=role),
        )

    return [
        bind("system:kube-scheduler", "system:kube-scheduler",
             RBACSubject(kind="User", name="system:kube-scheduler")),
        bind("system:kube-controller-manager",
             "system:kube-controller-manager",
             RBACSubject(kind="User",
                         name="system:kube-controller-manager")),
        bind("system:nodes", "system:node",
             RBACSubject(kind="Group", name="system:nodes")),
        bind("kubeadm:node-bootstrappers", "system:node-bootstrapper",
             RBACSubject(kind="Group", name="system:bootstrappers")),
    ]


def provision_bootstrap_policy(store, authorizer: Optional[RBACAuthorizer]
                               = None) -> RBACAuthorizer:
    """Install the bootstrap roles/bindings and return a ready
    authorizer (admin lands in system:masters — the superuser group the
    reference's authorizer honors before RBAC evaluation)."""
    for role in bootstrap_cluster_roles():
        if store.get_cluster_role(role.name) is None:
            store.add_cluster_role(role)
    existing = {b.name for b in store.list_cluster_role_bindings()}
    for crb in bootstrap_cluster_role_bindings():
        if crb.name not in existing:
            store.add_cluster_role_binding(crb)
    authorizer = authorizer or RBACAuthorizer(store)
    authorizer.add_user_to_group("admin", MASTERS)
    return authorizer
