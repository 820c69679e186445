"""The node, volume, bootstrap-token and RBAC-aggregation controllers
against the JAX package's, and the store accessors they brought into the
port against the JAX store's: the same store events drive both packages'
controllers (their own stores, informers and worker threads, as
``tests/test_controllers.py`` runs the JAX ones), and the stores must end
alike. Uids are counted per process in each package, so none is compared
across them."""

import copy
import importlib
import time

import pytest

ROOTS = {"jax": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}
MODULES = ("api.types", "api.labels", "api.resource", "apiserver.store",
           "client.informers", "testing", "controllers.nodeipam",
           "controllers.nodettl", "controllers.volume",
           "controllers.volumeexpand", "controllers.attachdetach",
           "controllers.bootstraptoken", "controllers.clusterroleaggregation")
MOD = {pkg: {m: importlib.import_module(f"{root}.{m}") for m in MODULES}
       for pkg, root in ROOTS.items()}


class Side:
    """One package's store, informer factory and running controllers
    (``(module, class)`` pairs under ``controllers``)."""

    def __init__(self, pkg, *controllers):
        self.m = MOD[pkg]
        self.t = self.m["api.types"]
        self.q = self.m["api.resource"].parse_quantity
        self.store = self.m["apiserver.store"].ClusterStore()
        self.factory = self.m["client.informers"].SharedInformerFactory(
            self.store)
        self.ctrls = {cls: getattr(self.m[f"controllers.{mod}"], cls)(
            self.store, self.factory) for mod, cls in controllers}
        self.factory.start()
        assert self.factory.wait_for_cache_sync()
        for c in self.ctrls.values():
            c.run()

    def node(self, name):
        self.store.add_node(self.m["testing"].MakeNode().name(name)
                            .capacity({"cpu": "4"}).obj())

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
    ``changes``, as a client's update would be."""
    new = copy.copy(obj)
    new.metadata = copy.copy(obj.metadata)
    for k, v in changes.items():
        setattr(new, k, v)
    return new


# ----------------------------------------------------------------------
def test_nodeipam_allocates_and_recycles_cidrs():
    def run(pkg):
        side = Side(pkg, ("nodeipam", "NodeIpamController"))

        def cidrs():
            return {n.name: n.spec.pod_cidr for n in side.store.list_nodes()}

        try:
            for i in range(3):
                side.node(f"ip{i}")
            side.wait(lambda: all(cidrs().values()) and len(cidrs()) == 3,
                      "3 CIDRs")
            side.settle()
            first = cidrs()
            side.store.delete_node("ip0")
            side.settle()
            side.node("ip3")
            side.wait(lambda: cidrs().get("ip3"), "a CIDR for ip3")
            side.settle()
            return first, cidrs()
        finally:
            side.stop()

    first, then = _both(run)
    assert first == {f"ip{i}": f"10.244.{i}.0/24" for i in range(3)}
    assert then == {"ip1": "10.244.1.0/24", "ip2": "10.244.2.0/24",
                    "ip3": "10.244.0.0/24"}


def test_ttl_controller_annotates_by_cluster_size():
    def run(pkg):
        side = Side(pkg, ("nodettl", "TTLController"))
        ttl = side.m["controllers.nodettl"]

        def annotations():
            return sorted({n.metadata.annotations.get(ttl.TTL_ANNOTATION)
                           for n in side.store.list_nodes()}, key=str)

        try:
            for i in range(3):
                side.node(f"t{i}")
            side.wait(lambda: annotations() == ["0"], "ttl 0")
            side.settle()
            out = [annotations()]
            # past 100 nodes every node moves to the next tier
            for i in range(3, 101):
                side.node(f"t{i}")
            side.wait(lambda: annotations() == ["15"], "ttl 15")
            side.settle()
            out.append(annotations())
            side.store.delete_node("t0")
            side.wait(lambda: annotations() == ["0"], "ttl 0 again")
            side.settle()
            out.append(annotations())
            out.append([ttl.ttl_for_cluster_size(n)
                        for n in (0, 100, 101, 500, 1000, 2000, 2001)])
            return out
        finally:
            side.stop()

    out = _both(run)
    assert out[:3] == [["0"], ["15"], ["0"]]
    assert out[3] == [0, 0, 15, 15, 30, 60, 300]


def test_pv_binder_binds_immediate_claims_only():
    def run(pkg):
        side = Side(pkg, ("volume", "PersistentVolumeController"))
        t, q = side.t, side.q

        def state():
            return (sorted((v.name, v.phase, v.claim_ref)
                           for v in side.store.list_pvs()),
                    sorted((c.name, c.phase, c.volume_name)
                           for c in side.store.list_all_pvcs()))

        try:
            for name, mode in (("standard", "Immediate"),
                               ("wffc", "WaitForFirstConsumer")):
                sc = t.StorageClass(provisioner="x", volume_binding_mode=mode)
                sc.metadata.name = name
                side.store.add_storage_class(sc)
            for name, cls, size in (("pv-small", "standard", "1Gi"),
                                    ("pv-big", "standard", "10Gi"),
                                    ("pv-w", "wffc", "10Gi")):
                pv = t.PersistentVolume(storage_class_name=cls,
                                        access_modes=["ReadWriteOnce"],
                                        capacity={"storage": q(size)})
                pv.metadata.name = name
                side.store.add_pv(pv)
            for name, cls, size in (("claim-1", "standard", "5Gi"),
                                    ("claim-2", "wffc", "1Gi"),
                                    ("claim-3", "standard", "50Gi")):
                pvc = t.PersistentVolumeClaim(
                    storage_class_name=cls, access_modes=["ReadWriteOnce"],
                    requests={"storage": q(size)})
                pvc.metadata.name = name
                side.store.add_pvc(pvc)
            side.wait(lambda: side.store.get_pvc("default", "claim-1").phase
                      == "Bound", "claim-1 bound")
            side.settle()
            first = state()
            # a PV that fits arrives: the pending Immediate claim binds
            pv = t.PersistentVolume(storage_class_name="standard",
                                    access_modes=["ReadWriteOnce"],
                                    capacity={"storage": q("64Gi")})
            pv.metadata.name = "pv-huge"
            side.store.add_pv(pv)
            side.wait(lambda: side.store.get_pvc("default", "claim-3").phase
                      == "Bound", "claim-3 bound")
            side.settle()
            return first, state()
        finally:
            side.stop()

    first, then = _both(run)
    assert ("claim-1", "Bound", "pv-big") in first[1]
    assert ("claim-2", "Pending", "") in first[1]
    assert ("claim-3", "Pending", "") in first[1]
    assert ("pv-huge", "Bound", "default/claim-3") in then[0]


def _claimed_pod(side, name, node, claim):
    return side.m["testing"].MakePod().name(name).uid(f"u-{name}") \
        .node(node).pvc(claim).obj()


def _volume(side, pv, claim):
    t = side.t
    side.store.add_pv(t.PersistentVolume(
        metadata=t.ObjectMeta(name=pv),
        capacity={"storage": side.q("1Gi")}))
    side.store.add_pvc(t.PersistentVolumeClaim(
        metadata=t.ObjectMeta(name=claim, namespace="default"),
        volume_name=pv, phase="Bound"))


def test_attachdetach_follows_consumers():
    def run(pkg):
        side = Side(pkg, ("attachdetach", "AttachDetachController"))

        def attached():
            return {n.name: list(n.status.volumes_attached)
                    for n in side.store.list_nodes()}

        out = []
        try:
            side.node("n1")
            side.node("n2")
            _volume(side, "pv-a", "data")
            _volume(side, "pv-b", "logs")
            side.store.create_pod(_claimed_pod(side, "u", "n1", "data"))
            side.store.create_pod(_claimed_pod(side, "v", "n1", "data"))
            side.store.create_pod(_claimed_pod(side, "w", "n2", "logs"))
            side.wait(lambda: attached() == {"n1": ["pv-a"], "n2": ["pv-b"]},
                      "attached")
            side.settle()
            out.append(attached())
            side.store.delete_pod("default", "u")   # v still uses pv-a
            side.settle()
            out.append(attached())
            side.store.delete_pod("default", "v")
            side.wait(lambda: attached()["n1"] == [], "pv-a detached")
            side.settle()
            out.append(attached())
            # a consumer of an unbound claim attaches nothing
            side.store.add_pvc(side.t.PersistentVolumeClaim(
                metadata=side.t.ObjectMeta(name="free", namespace="default")))
            side.store.create_pod(_claimed_pod(side, "x", "n1", "free"))
            side.settle()
            out.append(attached())
        finally:
            side.stop()
        return out

    out = _both(run)
    assert out == [{"n1": ["pv-a"], "n2": ["pv-b"]}] * 2 + [
        {"n1": [], "n2": ["pv-b"]}] * 2


def test_attachdetach_honors_the_kubelet_in_use_report():
    def run(pkg):
        side = Side(pkg, ("attachdetach", "AttachDetachController"))

        def attached():
            return list(side.store.get_node("n1").status.volumes_attached)

        def in_use(volumes):
            def mutate(n):
                n.status.volumes_in_use = list(volumes)
                return True
            side.store.mutate_object("Node", "", "n1", mutate)

        out = []
        try:
            side.node("n1")
            _volume(side, "pv-b", "data")
            side.store.create_pod(_claimed_pod(side, "u", "n1", "data"))
            side.wait(lambda: attached() == ["pv-b"], "attached")
            in_use(["pv-b"])
            side.store.delete_pod("default", "u")
            side.settle(quiet=0.5)
            out.append(attached())          # still mounted: stays
            in_use([])
            side.wait(lambda: attached() == [], "detached after unmount")
            side.settle()
            out.append(attached())
        finally:
            side.stop()
        return out

    assert _both(run) == [["pv-b"], []]


def test_volume_expand_grows_and_never_shrinks():
    def run(pkg):
        side = Side(pkg, ("volumeexpand", "VolumeExpandController"))
        t, q = side.t, side.q

        def capacity():
            return side.store.get_pv("pv1").capacity["storage"].nano

        out = []
        try:
            side.store.add_pv(t.PersistentVolume(
                metadata=t.ObjectMeta(name="pv1"),
                capacity={"storage": q("1Gi")}, claim_ref="default/c1",
                phase="Bound"))
            side.store.add_pvc(t.PersistentVolumeClaim(
                metadata=t.ObjectMeta(name="c1", namespace="default"),
                requests={"storage": q("1Gi")}, volume_name="pv1",
                phase="Bound"))
            side.settle()
            out.append(capacity())
            for size in ("2Gi", "1Gi"):
                side.store.update_object("PersistentVolumeClaim", _edited(
                    side.store.get_pvc("default", "c1"),
                    requests={"storage": q(size)}))
                side.settle()
                out.append(capacity())
        finally:
            side.stop()
        return out

    gi = 2 ** 30 * 10 ** 9
    assert _both(run) == [gi, 2 * gi, 2 * gi]


def test_bootstrap_signer_and_token_cleaner():
    def run(pkg):
        side = Side(pkg, ("bootstraptoken", "BootstrapSignerController"),
                    ("bootstraptoken", "TokenCleanerController"))
        t, bt = side.t, side.m["controllers.bootstraptoken"]

        def info():
            return dict(side.store.get_object("ConfigMap", "kube-public",
                                              "cluster-info").data)

        def token(tid, secret, **extra):
            side.store.create_object("Secret", t.Secret(
                metadata=t.ObjectMeta(name=f"bootstrap-token-{tid}",
                                      namespace="kube-system"),
                type=bt.BOOTSTRAP_TOKEN_SECRET_TYPE,
                data={"token-id": tid, "token-secret": secret,
                      "usage-bootstrap-signing": "true", **extra}))

        out = []
        try:
            side.store.create_object("ConfigMap", t.ConfigMap(
                metadata=t.ObjectMeta(name="cluster-info",
                                      namespace="kube-public"),
                data={"kubeconfig": "apiVersion: v1\nclusters: []\n"}))
            token("abc123", "s3cr3t")
            token("nosign", "x", **{"usage-bootstrap-signing": "false"})
            side.wait(lambda: "jws-kubeconfig-abc123" in info(), "signed")
            side.settle()
            out.append(info())
            token("old999", "x", expiration=str(time.time() - 10))
            side.wait(lambda: "jws-kubeconfig-old999" in info(),
                      "the old token signed")
            side.ctrls["TokenCleanerController"].enqueue_key("sweep")
            side.wait(lambda: "jws-kubeconfig-old999" not in info()
                      and side.store.get_object(
                          "Secret", "kube-system", "bootstrap-token-old999")
                      is None, "the expired token cleaned, its signature "
                               "dropped")
            side.settle()
            out.append(info())
            out.append(sorted(s.name for s in
                              side.store.list_objects("Secret")))
        finally:
            side.stop()
        return out

    out = _both(run)
    sign = MOD["port"]["controllers.bootstraptoken"].sign_payload
    assert out[0] == out[1] == {
        "kubeconfig": "apiVersion: v1\nclusters: []\n",
        "jws-kubeconfig-abc123": sign("apiVersion: v1\nclusters: []\n",
                                      "abc123", "s3cr3t")}
    assert out[2] == ["bootstrap-token-abc123", "bootstrap-token-nosign"]


def test_clusterrole_aggregation_unions_rules():
    def run(pkg):
        side = Side(pkg, ("clusterroleaggregation",
                          "ClusterRoleAggregationController"))
        t = side.t
        label = {"rbac.example.com/aggregate-to-admin": "true"}

        def rules():
            return [(sorted(r.verbs), sorted(r.resources))
                    for r in side.store.get_cluster_role(
                        "aggregate-admin").rules]

        def role(name, labels, *rules):
            side.store.add_cluster_role(t.ClusterRole(
                metadata=t.ObjectMeta(name=name, labels=dict(labels)),
                rules=[t.PolicyRule(verbs=v, resources=r) for v, r in rules]))

        out = []
        try:
            side.store.add_cluster_role(t.ClusterRole(
                metadata=t.ObjectMeta(name="aggregate-admin"),
                aggregation_label_selectors=[dict(label)]))
            role("widgets-admin", label, (["*"], ["widgets"]))
            role("secrets-reader", {}, (["get"], ["secrets"]))
            side.wait(lambda: rules() == [(["*"], ["widgets"])], "widgets")
            side.settle()
            out.append(rules())
            role("gadgets-admin", label, (["get"], ["gadgets"]),
                 (["*"], ["widgets"]))
            side.wait(lambda: len(rules()) == 2, "gadgets")
            side.settle()
            out.append(rules())
            side.store.delete_object("ClusterRole", "", "widgets-admin")
            side.settle()
            out.append(rules())
        finally:
            side.stop()
        return out

    out = _both(run)
    assert out[0] == [(["*"], ["widgets"])]
    # the union in role-name order, a rule once
    assert out[1] == [(["get"], ["gadgets"]), (["*"], ["widgets"])]
    assert out[2] == out[1]


# ----------------------------------------------------------------------
# the store accessors these controllers call, against the JAX store's
def _recorder(store):
    """Watch ``store``: a list of (type, kind, namespace, name, rv) of
    every later event."""
    events = []

    def one(e):
        events.append((e.type, e.kind, e.obj.metadata.namespace,
                       e.obj.metadata.name,
                       int(e.obj.metadata.resource_version)))

    try:
        store.watch(one, batch_fn=lambda batch: [one(e) for e in batch])
    except TypeError:   # the port's watch takes the batch callback alone
        store.watch(lambda batch: [one(e) for e in batch])
    return events


def _accessor_run(pkg, accessor):
    m = MOD[pkg]
    t, store = m["api.types"], m["apiserver.store"].ClusterStore()
    events = _recorder(store)
    sel = m["api.labels"].LabelSelector(match_labels={"app": "web"})
    out = []
    if accessor in ("get_replica_set", "update_replica_set"):
        for ns in ("default", "other"):
            rs = t.ReplicaSet(selector=sel, replicas=2)
            rs.metadata.name, rs.metadata.namespace = "web", ns
            store.add_replica_set(rs)
        got = store.get_replica_set("other", "web")
        out += [(got.namespace, got.name, got.replicas),
                store.get_replica_set("default", "nope"),
                store.get_replica_set("nope", "web")]
        if accessor == "update_replica_set":
            store.update_replica_set(_edited(got, replicas=5))
            again = store.get_replica_set("other", "web")
            out += [again.replicas,
                    store.get_replica_set("default", "web").replicas]
    elif accessor == "list_all_replication_controllers":
        out.append(store.list_all_replication_controllers())
        for ns, name in (("default", "a"), ("other", "b"), ("default", "c")):
            rc = t.ReplicationController(selector={"app": name})
            rc.metadata.name, rc.metadata.namespace = name, ns
            store.add_replication_controller(rc)
        out.append(sorted((r.namespace, r.name) for r in
                          store.list_all_replication_controllers()))
    elif accessor == "list_all_stateful_sets":
        out.append(store.list_all_stateful_sets())
        for ns, name in (("default", "db"), ("other", "db")):
            ss = t.StatefulSet(replicas=1)
            ss.metadata.name, ss.metadata.namespace = name, ns
            store.add_stateful_set(ss)
        out.append(sorted((s.namespace, s.name) for s in
                          store.list_all_stateful_sets()))
    elif accessor == "get_resource_quota":
        q = m["api.resource"].parse_quantity
        store.add_resource_quota(t.ResourceQuota(
            metadata=t.ObjectMeta(name="q", namespace="team"),
            hard={"pods": q("3")}))
        got = store.get_resource_quota("team", "q")
        out += [(got.namespace, got.name, got.hard["pods"].nano),
                store.get_resource_quota("default", "q")]
    elif accessor == "delete_namespace":
        store.add_namespace(t.Namespace(metadata=t.ObjectMeta(name="gone")))
        store.add_namespace(t.Namespace(metadata=t.ObjectMeta(name="kept")))
        store.delete_namespace("gone")
        store.delete_namespace("never-was")
        out += [store.get_namespace("gone"),
                sorted(n.name for n in store.list_namespaces())]
    return out, events


@pytest.mark.parametrize("accessor", [
    "get_replica_set", "update_replica_set",
    "list_all_replication_controllers", "list_all_stateful_sets",
    "get_resource_quota", "delete_namespace"])
def test_store_accessor_matches_the_reference(accessor):
    """Each accessor's results and the watch events around it (type,
    kind, key and resourceVersion) equal the JAX store's."""
    out, events = _both(lambda pkg: _accessor_run(pkg, accessor))
    assert events and all(e[4] > 0 for e in events)
    if accessor == "delete_namespace":
        assert out == [None, ["kept"]]
        assert [e[0] for e in events] == ["ADDED", "ADDED", "DELETED"]
    if accessor == "update_replica_set":
        assert out[3:] == [5, 2] and events[-1][0] == "MODIFIED"
