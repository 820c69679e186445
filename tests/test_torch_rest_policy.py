"""The port's API Priority and Fairness and RBAC against the JAX
package's.

- ``FlowController`` (the default tiering over the legacy lane budgets,
  and a small config whose levels fill): a seeded stream of requests
  from control-plane, master, tenant and anonymous identities gets the
  same flow schema, priority level, flow key, shuffle-sharded queue and
  width in both packages, and admitted without releases (a zero queue
  wait) the same tickets and the same rejections, in order.
- ``RBACAuthorizer`` over the bootstrap policy plus a namespaced Role
  and RoleBinding and a ClusterRoleBinding: the same verdict on every
  point of a user x verb x resource x namespace grid.
Exact equality: these are names, numbers and booleans.
"""

import random

import pytest

from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.apiserver import flowcontrol as jax_fc
from kubernetes_tpu.apiserver.faults import resource_of as jax_resource_of
from kubernetes_tpu.apiserver import rbac as jax_rbac
from kubernetes_tpu.apiserver import store as jax_store
from kubernetes_tpu.metrics import apf_metrics as jax_apfm
from kubernetes_tpu.metrics import registry as jax_registry
from kubernetes_tpu_torch.api import types
from kubernetes_tpu_torch.apiserver import flowcontrol as fc
from kubernetes_tpu_torch.apiserver.faults import resource_of
from kubernetes_tpu_torch.apiserver import rbac
from kubernetes_tpu_torch.apiserver import store
from kubernetes_tpu_torch.metrics import apf_metrics
from kubernetes_tpu_torch.metrics import registry

USERS = ("system:kube-scheduler", "system:node:n1", "admin", "alice",
         "bob", "token:deadbeef", "system:anonymous",
         "system:serviceaccount:team-a:deployer")
VERBS = ("GET", "POST", "PUT", "PATCH", "DELETE")
PATHS = ("/api/v1/pods", "/api/v1/namespaces/team-a/pods",
         "/api/v1/namespaces/default/pods/p1", "/api/v1/nodes",
         "/api/v1/bindings", "/api/v1/namespaces/team-b/services",
         "/api/v1/events", "/api/v1/statuses")


RESOURCE_OF = {fc: resource_of, jax_fc: jax_resource_of}


def _stream(seed, n=300):
    rng = random.Random(seed)
    for _ in range(n):
        yield (rng.choice(USERS), rng.choice(VERBS), rng.choice(PATHS),
               rng.choice(("", "", "tenant-x")), rng.choice((0, 0, 50, 800)),
               rng.choice((0, 120, 40_000)), rng.random() < 0.1)


def _config(mod, small):
    if not small:
        return mod.default_config(400, 200)
    return mod.default_config(4, 2, queue_wait_s=0.0)


def _groups(user):
    return ("system:masters",) if user == "admin" else ()


def _classify(mod, ctl, req):
    user, verb, path, flow_id, items, clen, watch = req
    resource = RESOURCE_OF[mod](path)
    ns = mod.namespace_of(path)
    schema, level = ctl.classify(user, _groups(user), verb, resource, ns)
    key = schema.flow_key(user, ns, flow_id)
    queue = None
    if level is not None:
        with level._lock:
            queue = level._queues.index(level._pick_queue_locked(key))
    is_coll = mod.is_collection_path(path)
    width = ctl.width.estimate(
        verb, resource, is_coll and verb == "GET" and not watch, watch,
        items, clen,
        is_collection_mutation=is_coll and verb in ("POST", "PUT", "PATCH"))
    return (schema.name, level.name if level else "exempt", key, queue,
            width)


def _controllers(small):
    ref = jax_fc.FlowController(
        _config(jax_fc, small),
        metrics=jax_apfm.ApfMetrics(jax_registry.MetricsRegistry()))
    port = fc.FlowController(
        _config(fc, small),
        metrics=apf_metrics.ApfMetrics(registry.MetricsRegistry()))
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_classification_equals_reference(seed):
    ref, port = _controllers(small=False)
    for req in _stream(seed):
        assert _classify(fc, port, req) == _classify(jax_fc, ref, req), req


@pytest.mark.parametrize("seed", [3, 4])
def test_flow_admission_equals_reference(seed):
    ref, port = _controllers(small=True)
    outcomes = {"ref": [], "port": []}
    for side, mod, ctl in (("ref", jax_fc, ref), ("port", fc, port)):
        for user, verb, path, flow_id, items, clen, watch in _stream(
                seed, 120):
            try:
                t = ctl.admit(user=user, groups=_groups(user), verb=verb,
                              resource=RESOURCE_OF[mod](path),
                              namespace=mod.namespace_of(path),
                              flow_id=flow_id, items_hint=items,
                              content_length=clen, is_watch=watch, path=path)
                outcomes[side].append(("ok", t.level_name, t.width,
                                       t.schema))
            except mod.Rejected as rej:
                outcomes[side].append(("429", rej.level, rej.schema,
                                       rej.reason))
    assert outcomes["port"] == outcomes["ref"]
    assert any(o[0] == "429" for o in outcomes["port"])
    assert any(o[0] == "ok" for o in outcomes["port"])
    strip = ("avg_exec_s", "queue_wait_p99_s")
    for name in port.levels:
        if port.levels[name] is None:
            continue
        a = {k: v for k, v in port.levels[name].snapshot().items()
             if k not in strip}
        b = {k: v for k, v in ref.levels[name].snapshot().items()
             if k not in strip}
        assert a == b


def _policy(t, st, rb_mod):
    authz = rb_mod.provision_bootstrap_policy(st)
    authz.add_user_to_group("alice", "devs")
    st.add_role(t.Role(
        metadata=t.ObjectMeta(name="pod-reader", namespace="team-a"),
        rules=[t.PolicyRule(verbs=["get", "list", "watch"],
                            resources=["pods"]),
               t.PolicyRule(verbs=["update"], resources=["pods/status"],
                            resource_names=["p1"])]))
    st.add_role_binding(t.RoleBinding(
        metadata=t.ObjectMeta(name="devs-read", namespace="team-a"),
        subjects=[t.RBACSubject(kind="Group", name="devs")],
        role_ref=t.RoleRef(kind="Role", name="pod-reader")))
    st.add_cluster_role(t.ClusterRole(
        metadata=t.ObjectMeta(name="svc-admin"),
        rules=[t.PolicyRule(verbs=["*"], resources=["services",
                                                     "endpoints"])]))
    st.add_cluster_role_binding(t.ClusterRoleBinding(
        metadata=t.ObjectMeta(name="bob-svc"),
        subjects=[t.RBACSubject(kind="User", name="bob"),
                  t.RBACSubject(kind="ServiceAccount", name="deployer",
                                namespace="team-a")],
        role_ref=t.RoleRef(kind="ClusterRole", name="svc-admin")))
    return authz


def test_rbac_verdicts_equal_reference():
    ref = _policy(jax_types, jax_store.ClusterStore(), jax_rbac)
    port = _policy(types, store.ClusterStore(), rbac)
    verbs = ("get", "list", "watch", "create", "update", "patch", "delete")
    resources = ("pods", "Pod", "nodes", "Node", "services", "Service",
                 "Binding", "bindings", "pods/status", "events", "Event",
                 "leases", "Lease", "configmaps", "PriorityClass")
    allowed = 0
    for user in USERS:
        for verb in verbs:
            for resource in resources:
                for ns in ("", "default", "team-a", "kube-system"):
                    want = ref(user, verb, resource, ns)
                    assert port(user, verb, resource, ns) == want, (
                        user, verb, resource, ns)
                    allowed += want
                for name in ("p1", "p2"):
                    assert port.authorize(user, verb, resource, "team-a",
                                          name) == ref.authorize(
                        user, verb, resource, "team-a", name)
        assert port.groups_for(user) == ref.groups_for(user)
    assert 0 < allowed
