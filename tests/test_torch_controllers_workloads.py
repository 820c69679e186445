"""The workload controllers (ReplicaSet, ReplicationController,
StatefulSet, Endpoints, ephemeral volumes) and the namespace, service
account, token and quota controllers against the JAX package's: the same
store events drive both packages' controllers (their own stores,
informers and worker threads, as ``tests/test_controllers.py`` runs the
JAX ones), and the stores must end alike.

Generated parts are random or counted per process in both packages, so
they are compared modulo the generated part: a ReplicaSet's pod names
(``<owner>-<uid>``), every uid, and a token Secret's name suffix and
token value. Where a scenario needs pods bound, the test binds them
itself, the same way on both sides, in place of a scheduler."""

import copy
import importlib
import time

import pytest

ROOTS = {"jax": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}
MODULES = ("api.types", "api.labels", "api.resource", "apiserver.store",
           "apiserver.admission", "client.informers", "testing",
           "controllers.replicaset", "controllers.statefulset",
           "controllers.endpoints", "controllers.ephemeralvolume",
           "controllers.namespace", "controllers.serviceaccount",
           "controllers.serviceaccounttoken", "controllers.resourcequota")
MOD = {pkg: {m: importlib.import_module(f"{root}.{m}") for m in MODULES}
       for pkg, root in ROOTS.items()}


class Side:
    """One package's store, informer factory and running controllers
    (``(module, class)`` pairs under ``controllers``)."""

    def __init__(self, pkg, *controllers):
        self.m = MOD[pkg]
        self.t = self.m["api.types"]
        self.store = self.m["apiserver.store"].ClusterStore()
        self.factory = self.m["client.informers"].SharedInformerFactory(
            self.store)
        self.ctrls = {cls: getattr(self.m[f"controllers.{mod}"], cls)(
            self.store, self.factory) for mod, cls in controllers}
        self.factory.start()
        assert self.factory.wait_for_cache_sync()
        for c in self.ctrls.values():
            c.run()

    def make_pod(self):
        return self.m["testing"].MakePod()

    def make_node(self):
        return self.m["testing"].MakeNode()

    def wait(self, cond, what, timeout=10.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.01)

    def settle(self, quiet=0.25, timeout=10.0):
        """Wait until the store's resourceVersion holds for ``quiet``
        seconds: the controllers have nothing left to write."""
        deadline = time.monotonic() + timeout
        last, since = self.store._rv, time.monotonic()
        while time.monotonic() - since < quiet:
            if time.monotonic() > deadline:
                raise AssertionError("the controllers did not settle")
            time.sleep(0.02)
            if self.store._rv != last:
                last, since = self.store._rv, time.monotonic()

    def bind_pending(self, node="n1"):
        """Bind every unbound pod to ``node`` (the test's scheduler)."""
        for p in self.store.list_pods():
            if not p.spec.node_name:
                self.store.bind(p.namespace, p.name, p.metadata.uid, node)

    def stop(self):
        for c in self.ctrls.values():
            c.stop()
        self.factory.stop()


def _both(run):
    """``run(pkg)`` for each package; the port's result must equal the
    reference's. Returns it."""
    got = {pkg: run(pkg) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    return got["port"]


def _edited(obj, **changes):
    """A copy of a stored object (its metadata copied too) with
    ``changes``: an update the store and the informers see as a new
    object, as a client's would be."""
    new = copy.copy(obj)
    new.metadata = copy.copy(obj.metadata)
    for k, v in changes.items():
        setattr(new, k, v)
    return new


def _template(t, labels, cpu="100m"):
    return {"metadata": {"labels": dict(labels)},
            "spec": {"containers": [
                {"name": "c", "resources": {"requests": {"cpu": cpu}}}]}}


def _rs(side, name, replicas, labels=None):
    labels = labels or {"app": "web"}
    rs = side.t.ReplicaSet(
        selector=side.m["api.labels"].LabelSelector(match_labels=dict(labels)),
        replicas=replicas, template=_template(side.t, labels))
    rs.metadata.name = name
    return rs


def _pods(side, ns=None):
    """The pods, a ReplicaSet's generated name cut to ``<owner>-*``, with
    their node, labels, phase and owners (kind, name)."""
    out = []
    for p in side.store.list_pods(ns):
        owners = sorted((r.get("kind"), r.get("name"), bool(r.get("controller")))
                        for r in p.metadata.owner_references)
        name = p.name
        for kind, owner, _ in owners:
            if kind in ("ReplicaSet", "ReplicationController") and \
                    name.startswith(f"{owner}-") and name != "stray":
                name = f"{owner}-*"
        out.append((p.namespace, name, p.spec.node_name,
                    sorted(p.metadata.labels.items()), p.status.phase, owners))
    return sorted(out)


def _status(obj):
    return (obj.status.replicas, obj.status.ready_replicas)


# ----------------------------------------------------------------------
def test_replicaset_scales_up_down_and_replaces():
    def run(pkg):
        side = Side(pkg, ("replicaset", "ReplicaSetController"))
        trail = []
        try:
            side.store.add_replica_set(_rs(side, "web", 3))
            side.wait(lambda: len(side.store.list_pods()) == 3, "3 pods")
            side.settle()
            trail.append((_pods(side), _status(
                side.store.get_replica_set("default", "web"))))
            side.store.update_replica_set(_edited(
                side.store.get_replica_set("default", "web"), replicas=1))
            side.wait(lambda: len(side.store.list_pods()) == 1, "1 pod")
            side.settle()
            trail.append((_pods(side), _status(
                side.store.get_replica_set("default", "web"))))
            gone = side.store.list_pods()[0].name
            side.store.delete_pod("default", gone)
            side.wait(lambda: [p.name for p in side.store.list_pods()]
                      not in ([], [gone]), "a replacement")
            side.settle()
            trail.append((_pods(side), _status(
                side.store.get_replica_set("default", "web"))))
        finally:
            side.stop()
        return trail

    trail = _both(run)
    assert [len(pods) for pods, _ in trail] == [3, 1, 1]
    assert [status for _, status in trail] == [(3, 0), (1, 0), (1, 0)]
    assert trail[0][0][0][1] == "web-*"


def test_replicaset_adopts_a_matching_orphan():
    def run(pkg):
        side = Side(pkg, ("replicaset", "ReplicaSetController"))
        try:
            side.store.create_pod(side.make_pod().name("stray")
                                  .uid("stray-u").label("app", "web").obj())
            side.store.create_pod(side.make_pod().name("other")
                                  .uid("other-u").label("app", "db").obj())
            side.store.add_replica_set(_rs(side, "web", 2))
            side.wait(lambda: len(side.store.list_pods()) == 3, "2 + 1 pods")
            side.settle()
            first = _pods(side)
            # the adopted pod's deletion routes back to its new owner
            side.store.delete_pod("default", "stray")
            side.wait(lambda: len(side.store.list_pods()) == 3
                      and side.store.get_pod("default", "stray") is None,
                      "the replacement")
            side.settle()
            return first, _pods(side)
        finally:
            side.stop()

    first, then = _both(run)
    stray = [p for p in first if p[1] == "stray"][0]
    assert stray[5] == [("ReplicaSet", "web", True)]
    assert [p for p in first if p[1] == "other"][0][5] == []
    assert sum(p[1] == "web-*" for p in then) == 2


def test_replication_controller_scales_its_selector():
    def run(pkg):
        side = Side(pkg, ("replicaset", "ReplicationController"))
        try:
            rc = side.t.ReplicationController(
                selector={"app": "db"}, replicas=2,
                template=_template(side.t, {"app": "db"}))
            rc.metadata.name = "db"
            side.store.add_replication_controller(rc)
            side.wait(lambda: len(side.store.list_pods()) == 2, "2 pods")
            side.settle()
            first = _pods(side)
            side.store.add_replication_controller(_edited(
                side.store.list_all_replication_controllers()[0],
                replicas=0))
            side.wait(lambda: not side.store.list_pods(), "no pods")
            side.settle()
            return first, _pods(side), _status(
                side.store.list_all_replication_controllers()[0])
        finally:
            side.stop()

    first, then, status = _both(run)
    assert [p[1] for p in first] == ["db-*", "db-*"] and then == []
    assert status == (0, 0)


def test_statefulset_creates_in_ordinal_order_and_scales_down():
    def run(pkg):
        side = Side(pkg, ("statefulset", "StatefulSetController"))
        order = []
        try:
            side.store.add_node(side.make_node().name("n1").capacity(
                {"cpu": "8", "memory": "16Gi"}).obj())
            ss = side.t.StatefulSet(
                selector=side.m["api.labels"].LabelSelector(
                    match_labels={"app": "db"}),
                replicas=3, template=_template(side.t, {"app": "db"}))
            ss.metadata.name = "db"
            side.store.add_stateful_set(ss)
            for i in range(3):
                side.wait(lambda: side.store.get_pod("default", f"db-{i}")
                          is not None, f"db-{i}")
                side.settle()
                # the next ordinal waits for this one to be ready
                order.append(sorted(p.name for p in side.store.list_pods()))
                side.bind_pending()
            side.settle()
            order.append(_pods(side))
            side.store.add_stateful_set(_edited(
                side.store.list_all_stateful_sets()[0], replicas=1))
            side.wait(lambda: len(side.store.list_pods()) == 1, "1 pod")
            side.settle()
            order.append(_pods(side))
            order.append(_status(side.store.list_all_stateful_sets()[0]))
        finally:
            side.stop()
        return order

    order = _both(run)
    assert order[:3] == [["db-0"], ["db-0", "db-1"], ["db-0", "db-1", "db-2"]]
    assert [p[1] for p in order[4]] == ["db-0"]


def test_endpoints_follow_the_selector_and_the_bindings():
    def run(pkg):
        side = Side(pkg, ("endpoints", "EndpointsController"),
                    ("replicaset", "ReplicaSetController"))
        out = []

        def addresses():
            ep = side.store.get_endpoints("default", "web")
            if ep is None:
                return None
            names = {p.full_name(): f"{p.namespace}/web-*"
                     for p in side.store.list_pods()}
            return [(a.node_name, names.get(a.target_pod, a.target_pod),
                     a.ip == a.target_pod) for a in ep.addresses]

        try:
            svc = side.t.Service(selector={"app": "web"})
            svc.metadata.name = "web"
            side.store.add_service(svc)
            side.store.add_replica_set(_rs(side, "web", 2))
            side.wait(lambda: len(side.store.list_pods()) == 2, "2 pods")
            side.settle()
            out.append(addresses())      # none bound: no address
            side.bind_pending()
            side.wait(lambda: len(addresses() or ()) == 2, "2 addresses")
            side.settle()
            out.append(addresses())
            side.store.update_replica_set(_edited(
                side.store.get_replica_set("default", "web"), replicas=1))
            side.wait(lambda: len(addresses() or ()) == 1, "1 address")
            side.settle()
            out.append(addresses())
            side.store.delete_object("Service", "default", "web")
            side.wait(lambda: side.store.get_endpoints("default", "web")
                      is None, "the endpoints deleted")
            out.append(addresses())
        finally:
            side.stop()
        return out

    out = _both(run)
    assert out[0] == []
    assert out[1] == [("n1", "default/web-*", True)] * 2
    assert out[2] == [("n1", "default/web-*", True)] and out[3] is None


def test_idle_controllers_do_not_spin():
    """A status write only where it changed: an unconditional one would
    make each controller its own trigger."""
    def run(pkg):
        side = Side(pkg, ("replicaset", "ReplicaSetController"),
                    ("statefulset", "StatefulSetController"),
                    ("endpoints", "EndpointsController"))
        try:
            side.store.add_replica_set(_rs(side, "web", 2))
            svc = side.t.Service(selector={"app": "web"})
            svc.metadata.name = "web"
            side.store.add_service(svc)
            ss = side.t.StatefulSet(replicas=1,
                                    template=_template(side.t, {"app": "db"}))
            ss.metadata.name = "db"
            side.store.add_stateful_set(ss)
            side.wait(lambda: len(side.store.list_pods()) == 3, "3 pods")
            side.settle()
            before = side.store._rv
            time.sleep(1.0)
            # the reference's own bar: at most 2 writes in an idle second
            return side.store._rv - before <= 2, _pods(side)
        finally:
            side.stop()

    idle, pods = _both(run)
    assert idle and len(pods) == 3


def test_ephemeral_volume_makes_an_owned_claim():
    def run(pkg):
        side = Side(pkg, ("ephemeralvolume", "EphemeralVolumeController"))
        try:
            pod = side.make_pod().name("p1").uid("pu1").req({"cpu": "1"}).obj()
            pod.spec.volumes.append(side.t.Volume(name="scratch",
                                                  ephemeral=True))
            pod.spec.volumes.append(side.t.Volume(name="data",
                                                  persistent_volume_claim="c"))
            side.store.create_pod(pod)
            side.wait(lambda: side.store.get_pvc("default", "p1-scratch")
                      is not None, "the claim")
            side.settle()
            return sorted(
                (c.namespace, c.name, c.phase,
                 {k: v.nano for k, v in c.requests.items()},
                 c.metadata.owner_references)
                for c in side.store.list_all_pvcs())
        finally:
            side.stop()

    claims = _both(run)
    assert claims == [("default", "p1-scratch", "Pending",
                       {"storage": 2 ** 30 * 10 ** 9},
                       [{"kind": "Pod", "name": "p1", "uid": "pu1",
                         "controller": True}])]


# ----------------------------------------------------------------------
def test_namespace_sweep_deletes_the_contents_then_the_namespace():
    def run(pkg):
        side = Side(pkg, ("namespace", "NamespaceController"))
        t = side.t
        try:
            for name in ("doomed", "kept"):
                side.store.add_namespace(t.Namespace(
                    metadata=t.ObjectMeta(name=name)))
                pod = side.make_pod().name("p1").uid(f"u-{name}").obj()
                pod.metadata.namespace = name
                side.store.create_pod(pod)
                side.store.create_object("ConfigMap", t.ConfigMap(
                    metadata=t.ObjectMeta(name="cm", namespace=name),
                    data={"k": "v"}))
            side.settle()
            side.store.update_object("Namespace", _edited(
                side.store.get_namespace("doomed"), phase="Terminating"))
            side.wait(lambda: side.store.get_namespace("doomed") is None,
                      "the namespace removed")
            side.settle()
            return (sorted(n.name for n in side.store.list_namespaces()),
                    _pods(side),
                    sorted((c.namespace, c.name)
                           for c in side.store.list_objects("ConfigMap")))
        finally:
            side.stop()

    namespaces, pods, maps = _both(run)
    assert namespaces == ["kept"] and maps == [("kept", "cm")]
    assert [(p[0], p[1]) for p in pods] == [("kept", "p1")]


def test_serviceaccount_default_is_made_and_made_again():
    def run(pkg):
        side = Side(pkg, ("serviceaccount", "ServiceAccountController"))
        t = side.t
        try:
            side.store.add_namespace(t.Namespace(
                metadata=t.ObjectMeta(name="team-a")))
            side.store.add_namespace(t.Namespace(
                metadata=t.ObjectMeta(name="leaving"), phase="Terminating"))
            side.wait(lambda: side.store.get_service_account(
                "team-a", "default") is not None, "the default account")
            side.store.delete_object("ServiceAccount", "team-a", "default")
            side.wait(lambda: side.store.get_service_account(
                "team-a", "default") is not None, "the account again")
            side.settle()
            return sorted((a.namespace, a.name) for a in
                          side.store.list_objects("ServiceAccount"))
        finally:
            side.stop()

    assert _both(run) == [("team-a", "default")]


def test_token_controller_mints_rotates_and_revokes():
    def run(pkg):
        side = Side(pkg, ("serviceaccounttoken", "TokensController"))
        t = side.t
        tok = side.m["controllers.serviceaccounttoken"]
        out = []

        def state():
            accounts = {a.name: a for a in
                        side.store.list_objects("ServiceAccount")}
            secrets = []
            for s in side.store.list_objects("Secret"):
                owner = accounts.get(
                    s.metadata.annotations.get(tok.SA_NAME_ANNOTATION))
                secrets.append((
                    s.name.rsplit("-", 1)[0], s.type, sorted(s.data),
                    s.data.get("namespace"), len(s.data.get("token", "")) > 0,
                    owner is not None and s.metadata.annotations.get(
                        tok.SA_UID_ANNOTATION) == owner.metadata.uid))
            return (sorted(secrets),
                    sorted((a.name, [x.rsplit("-", 1)[0] for x in a.secrets],
                            all(side.store.get_object("Secret", "default", x)
                                is not None for x in a.secrets))
                           for a in accounts.values()))

        try:
            side.store.add_service_account(t.ServiceAccount(
                metadata=t.ObjectMeta(name="ci-bot", namespace="default")))
            side.wait(lambda: any(a.secrets for a in side.store.list_objects(
                "ServiceAccount")), "a token")
            side.settle()
            out.append(state())
            first = side.store.list_objects("Secret")[0].name
            # a deleted token is minted again
            side.store.delete_object("Secret", "default", first)
            side.wait(lambda: any(
                s.name != first for s in side.store.list_objects("Secret")),
                "a new token")
            side.settle()
            out.append(state())
            # the account made again under its name: the old token goes
            side.store.delete_object("ServiceAccount", "default", "ci-bot")
            side.wait(lambda: not side.store.list_objects("Secret"),
                      "the token revoked")
            side.store.add_service_account(t.ServiceAccount(
                metadata=t.ObjectMeta(name="ci-bot", namespace="default")))
            side.wait(lambda: any(a.secrets for a in side.store.list_objects(
                "ServiceAccount")), "a token for the new account")
            side.settle()
            out.append(state())
            out.append(tok.sa_username("default", "ci-bot"))
        finally:
            side.stop()
        return out

    out = _both(run)
    assert out[0] == out[1] == out[2]
    assert out[0][0] == [("ci-bot-token", "kubernetes.io/service-account-"
                          "token", ["namespace", "token"], "default", True,
                          True)]
    assert out[3] == "system:serviceaccount:default:ci-bot"


def test_resourcequota_controller_and_admission():
    def run(pkg):
        side = Side(pkg, ("resourcequota", "ResourceQuotaController"))
        t, adm = side.t, side.m["apiserver.admission"]
        q = side.m["api.resource"].parse_quantity
        out = []

        def used():
            quota = side.store.get_resource_quota("default", "q")
            return sorted((k, v.nano) for k, v in quota.used.items())

        def verdict(plugin, name, cpu):
            req = adm.AdmissionRequest(
                operation="CREATE", kind="Pod", namespace="default",
                obj=side.make_pod().name(name).uid(f"u-{name}")
                .req({"cpu": cpu}).obj())
            try:
                plugin.validate(req)
                return "admitted", req
            except adm.AdmissionError:
                return "rejected", req

        try:
            side.store.add_resource_quota(t.ResourceQuota(
                metadata=t.ObjectMeta(name="q", namespace="default"),
                hard={"pods": q("2"), "requests.cpu": q("1"),
                      "memory": q("1Gi")}))
            side.store.create_pod(side.make_pod().name("q1").uid("qu1")
                                  .req({"cpu": "500m", "memory": "64Mi"})
                                  .obj())
            side.wait(lambda: dict(used()).get("pods") == 10 ** 9,
                      "usage of one pod")
            side.settle()
            out.append(used())
            plugin = adm.ResourceQuotaAdmission(side.store)
            out.append(verdict(plugin, "big", "600m")[0])
            small, req_small = verdict(plugin, "small", "400m")
            out.append(small)
            # the charge in flight holds 400m: a second 400m goes past 1
            out.append(verdict(plugin, "small2", "400m")[0])
            plugin.rollback(req_small)
            out.append(verdict(plugin, "small2", "400m")[0])
            # a terminal pod stops counting
            side.store.create_pod(side.make_pod().name("done").uid("ud")
                                  .phase("Succeeded").req({"cpu": "100m"})
                                  .obj())
            side.store.delete_pod("default", "q1")
            side.wait(lambda: dict(used()).get("pods") == 0, "no usage")
            side.settle()
            out.append(used())
        finally:
            side.stop()
        return out

    out = _both(run)
    assert out[0] == [("memory", 64 * 2 ** 20 * 10 ** 9),
                      ("pods", 10 ** 9), ("requests.cpu", 500 * 10 ** 6)]
    assert out[1:5] == ["rejected", "admitted", "rejected", "admitted"]
    assert out[5] == [("memory", 0), ("pods", 0), ("requests.cpu", 0)]


def test_quota_admission_burst_cannot_overshoot():
    """Admission charges at once: a burst admitted before the controller
    recounts still stops at the hard cap."""
    def run(pkg):
        m = MOD[pkg]
        t, adm = m["api.types"], m["apiserver.admission"]
        store = m["apiserver.store"].ClusterStore()
        store.add_resource_quota(t.ResourceQuota(
            metadata=t.ObjectMeta(name="q", namespace="default"),
            hard={"pods": m["api.resource"].parse_quantity("3")}))
        plugin = adm.ResourceQuotaAdmission(store)
        verdicts = []
        for i in range(10):
            try:
                plugin.validate(adm.AdmissionRequest(
                    operation="CREATE", kind="Pod", namespace="default",
                    obj=m["testing"].MakePod().name(f"burst{i}")
                    .uid(f"bu{i}").obj()))
                verdicts.append(True)
            except adm.AdmissionError:
                verdicts.append(False)
        return verdicts

    assert _both(run) == [True] * 3 + [False] * 7


@pytest.mark.parametrize("count", [5, 1, 0])
def test_compute_usage_matches_the_reference(count):
    """The usage of ``count`` pods (the third, where there is one,
    Failed and so not counted)."""
    def run(pkg):
        make = MOD[pkg]["testing"].MakePod
        pods = [make().name(f"p{i}").uid(f"u{i}").req(
            {"cpu": f"{100 * i + 1}m", "memory": f"{i}Mi"}).obj()
            for i in range(count)]
        if count > 2:
            pods[2].status.phase = "Failed"
        usage = MOD[pkg]["controllers.resourcequota"].compute_usage(pods)
        return sorted((k, v.nano) for k, v in usage.items())

    usage = _both(run)
    assert dict(usage)["pods"] == {5: 4, 1: 1, 0: 0}[count] * 10 ** 9
