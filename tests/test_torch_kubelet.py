"""The port's node agent (``kubernetes_tpu_torch/kubelet/``) against the JAX
package's: each case of the JAX ``tests/test_kubelet.py`` runs as one
scenario over either package's store, kubelet, runtime, device manager,
probes, eviction, image GC, container manager, PLEG and volume manager,
and reports what it saw (phases, conditions, container states, device
ids, cgroup values, events, verdicts). The two reports must be equal,
and the port's must show what the JAX test asserts.

Tolerance: exact equality."""

import time
from importlib import import_module

import pytest


class Pkg:
    """One package's modules under one set of names."""

    def __init__(self, root: str):
        self.root = root
        self.types = import_module(f"{root}.api.types")
        self.resource = import_module(f"{root}.api.resource")
        self.Store = import_module(f"{root}.apiserver.store").ClusterStore
        self.kubelet = import_module(f"{root}.kubelet")
        self.cri = import_module(f"{root}.kubelet.cri")
        self.eviction = import_module(f"{root}.kubelet.eviction")
        self.imagegc = import_module(f"{root}.kubelet.imagegc")
        self.cm = import_module(f"{root}.kubelet.cm")
        self.pleg = import_module(f"{root}.kubelet.pleg")
        testing = import_module(f"{root}.testing")
        self.MakePod, self.MakeNode = testing.MakePod, testing.MakeNode

    def kubelet_of(self, store, name="n1", **kw):
        kl = self.kubelet.Kubelet(store, name, **kw)
        kl.sync_interval = 0.05
        return kl


PKGS = {"jax": Pkg("kubernetes_tpu"), "port": Pkg("kubernetes_tpu_torch")}


def wait_for(cond, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return bool(cond())


def _phase(store, name, ns="default"):
    pod = store.get_pod(ns, name)
    return pod.status.phase if pod is not None else None


def _bound_pod(k, store, name, node="n1", image="app", uid=None, **kw):
    pod = k.MakePod().name(name).uid(uid or f"u-{name}") \
        .container(image=image).obj()
    for key, v in kw.items():
        setattr(pod.spec, key, v)
    store.create_pod(pod)
    store.bind("default", name, pod.uid, node)
    return pod


# ---------------------------------------------------------------------------
# scenarios: each returns its report


def sc_runtime(k, tmp):
    rt = k.cri.FakeRuntime()
    sid = rt.run_pod_sandbox("u1", "p", "default")
    cid = rt.create_container(sid, "main", "busybox")
    rt.start_container(cid)
    out = [rt.container_status(cid).state]
    for fn in (lambda: rt.remove_container(cid),
               lambda: rt.remove_pod_sandbox(sid)):
        try:
            fn()
            out.append("ok")
        except RuntimeError:
            out.append("refused")
        rt.stop_container(cid)
        st = rt.container_status(cid)
        out.append((st.state, st.exit_code))
    rt.stop_pod_sandbox(sid)
    rt.remove_pod_sandbox(sid)
    out += [rt.list_pod_sandboxes(), rt.list_containers()]
    rt = k.cri.FakeRuntime(exit_after={"job-image": 0.0})
    sid = rt.run_pod_sandbox("u1", "p", "default")
    cid = rt.create_container(sid, "main", "job-image")
    rt.start_container(cid)
    st = rt.container_status(cid)
    out.append((st.state, st.exit_code))
    rt.start_container(cid)
    out.append(rt.container_status(cid).restarts)
    return out


def sc_checkpoint(k, tmp):
    cm = k.kubelet.CheckpointManager(tmp)
    cm.create("state", {"a": [1, 2, 3]})
    out = [cm.get("state"), cm.list()]
    path = f"{tmp}/state.ckpt"
    raw = open(path).read().replace("[1, 2, 3]", "[1, 2, 9]")
    open(path, "w").write(raw)
    try:
        cm.get("state")
        out.append("read")
    except k.kubelet.CorruptCheckpointError:
        out.append("corrupt")
    cm.remove("state")
    out.append(cm.get("state"))
    return out


def sc_device_manager(k, tmp):
    res = k.kubelet.TPU_RESOURCE
    cm = k.kubelet.CheckpointManager(tmp)
    dm = k.kubelet.DeviceManager(cm)
    dm.register(k.kubelet.DevicePlugin(res, [f"tpu{i}" for i in range(8)]))
    ids = dm.allocate("u1", "main", res, 4)
    out = [sorted(ids), dm.allocatable()[res]]
    try:
        dm.allocate("u2", "main", res, 5)
    except k.kubelet.DeviceAllocationError:
        out.append("refused")
    dm2 = k.kubelet.DeviceManager(cm)
    dm2.register(k.kubelet.DevicePlugin(res, [f"tpu{i}" for i in range(8)]))
    out += [dm2.allocatable()[res], dm2.devices_of("u1")[res]]
    dm2.free("u1")
    out.append(dm2.allocatable()[res])
    dm = k.kubelet.DeviceManager()
    topo = {f"t{x}{y}": (x, y) for x in range(4) for y in range(4)}
    dm.register(k.kubelet.DevicePlugin(res, sorted(topo), topology=topo))
    ids = dm.allocate("u1", "c", res, 4)
    coords = [topo[d] for d in ids]
    out.append(sorted(ids))
    out.append(all(any(abs(c[0] - o[0]) + abs(c[1] - o[1]) == 1
                       for o in coords if o != c) for c in coords))
    return out


def sc_probes(k, tmp):
    pm = k.kubelet.ProbeManager()
    flaky = {"ok": True}
    pm.add("u1", "main", k.kubelet.READINESS, k.kubelet.ProbeSpec(
        lambda: flaky["ok"], period=0.0, failure_threshold=2))
    out = []
    for ok in (True, False, False, True):
        flaky["ok"] = ok
        pm.tick()
        out.append("ready" if pm.pod_ready("u1") else "unready")
    assert out == ["ready", "ready", "unready", "ready"]
    return out


def sc_runs_and_tears_down(k, tmp):
    store = k.Store()
    kl = k.kubelet_of(store, capacity={"cpu": "8", "memory": "16Gi"})
    kl.start()
    try:
        node = store.get_node("n1")
        out = [int(node.status.allocatable["cpu"].value())]
        p = _bound_pod(k, store, "web")
        out.append(wait_for(lambda: _phase(store, "web") == "Running"))
        pod = store.get_pod("default", "web")
        out += [pod.status.pod_ip.startswith("10.88.0."),
                pod.status.host_ip, len(kl.running_pods())]
        store.delete_pod("default", "web")
        out.append(wait_for(lambda: not kl.running_pods()))
        out += [kl.runtime.list_pod_sandboxes(), kl.volumes.mounted(p.uid)]
        return out
    finally:
        kl.stop()


def sc_job_and_crash(k, tmp):
    store = k.Store()
    kl = k.kubelet_of(store, runtime=k.cri.FakeRuntime(
        exit_after={"job": 0.0}, fail_images={"bad"}))
    kl.start()
    try:
        _bound_pod(k, store, "batch", image="job", restart_policy="Never")
        _bound_pod(k, store, "crash", image="bad", restart_policy="Never")
        return [wait_for(lambda: _phase(store, "batch") == "Succeeded"),
                wait_for(lambda: _phase(store, "crash") == "Failed"),
                wait_for(lambda: not kl.running_pods())]
    finally:
        kl.stop()


def sc_tpu_admission(k, tmp):
    res = k.kubelet.TPU_RESOURCE
    store = k.Store()
    dm = k.kubelet.DeviceManager()
    dm.register(k.kubelet.DevicePlugin(res, ["tpu0", "tpu1"]))
    kl = k.kubelet_of(store, device_manager=dm)
    kl.start()
    try:
        out = [int(store.get_node("n1").status.capacity[res].value())]
        store.create_pod(k.MakePod().name("train").uid("u-train").req(
            {"cpu": "1", res: "2"}).obj())
        store.bind("default", "train", "u-train", "n1")
        out.append(wait_for(lambda: _phase(store, "train") == "Running"))
        out.append(dm.devices_of("u-train")[res])
        store.create_pod(k.MakePod().name("train2").uid("u-t2").req(
            {res: "1"}).obj())
        store.bind("default", "train2", "u-t2", "n1")
        out.append(wait_for(lambda: _phase(store, "train2") == "Failed"))
        store.delete_pod("default", "train")
        out.append(wait_for(lambda: dm.allocatable()[res] == 2))
        return out
    finally:
        kl.stop()


def sc_liveness_restart(k, tmp):
    store = k.Store()
    kl = k.kubelet_of(store)
    kl.start()
    try:
        p = _bound_pod(k, store, "web")
        out = [wait_for(lambda: _phase(store, "web") == "Running")]
        kl.probes.add(p.uid, "c0", k.kubelet.LIVENESS, k.kubelet.ProbeSpec(
            lambda: False, period=0.0, failure_threshold=1))
        cid = kl._containers_of[p.uid]["c0"]
        out.append(wait_for(
            lambda: kl.runtime.container_status(cid).restarts >= 1))
        out.append(_phase(store, "web"))
        return out
    finally:
        kl.stop()


def sc_restart_keeps_devices(k, tmp):
    res = k.kubelet.TPU_RESOURCE
    store = k.Store()
    dm = k.kubelet.DeviceManager(k.kubelet.CheckpointManager(tmp))
    dm.register(k.kubelet.DevicePlugin(res, ["tpu0", "tpu1"]))
    kl = k.kubelet_of(store, device_manager=dm)
    kl.start()
    store.create_pod(k.MakePod().name("train").uid("u-train").req(
        {res: "2"}).obj())
    store.bind("default", "train", "u-train", "n1")
    out = [wait_for(lambda: _phase(store, "train") == "Running")]
    kl.stop()
    dm2 = k.kubelet.DeviceManager(k.kubelet.CheckpointManager(tmp))
    dm2.register(k.kubelet.DevicePlugin(res, ["tpu0", "tpu1"]))
    out.append(dm2.allocatable()[res])
    kl2 = k.kubelet_of(store, device_manager=dm2)
    kl2.start()
    try:
        time.sleep(0.3)
        out += [_phase(store, "train"), dm2.devices_of("u-train")[res]]
        return out
    finally:
        kl2.stop()


def sc_eviction(k, tmp):
    ev = k.eviction
    store = k.Store()
    store.add_node(k.MakeNode().name("n1")
                   .capacity({"cpu": "8", "memory": "1Gi"}).obj())
    store.create_pod(k.MakePod().name("bulk").uid("bu").node("n1")
                     .priority(0).req({"memory": "600Mi"}).obj())
    store.create_pod(k.MakePod().name("vip").uid("vu").node("n1")
                     .priority(1000).req({"memory": "300Mi"}).obj())
    mgr = ev.EvictionManager(
        store, "n1", thresholds={"memory.available": "200Mi"},
        stats=ev.CgroupStatsStub(store, "n1", 1024 * 1024 * 1024))
    out = [mgr.synchronize()]
    victim = store.get_pod("default", "bulk")
    out += [victim.status.phase, victim.status.reason,
            _phase(store, "vip")]

    def node_view():
        node = store.get_node("n1")
        return ([(c.type, c.status) for c in node.status.conditions],
                [t.key for t in node.spec.taints])

    out.append(node_view())
    out.append(mgr.synchronize())
    out.append(node_view())
    out.append((ev.MEMORY_PRESSURE, ev.MEMORY_PRESSURE_TAINT))

    store = k.Store()
    store.add_node(k.MakeNode().name("n1")
                   .capacity({"cpu": "8", "memory": "1Gi"}).obj())
    store.create_pod(k.MakePod().name("over").uid("o").node("n1")
                     .priority(1000).req({"memory": "100Mi"}).obj())
    store.create_pod(k.MakePod().name("within").uid("w").node("n1")
                     .priority(0).req({"memory": "600Mi"}).obj())

    class Stats:
        def memory_available(self):
            return 0

        def pod_memory_usage(self, pod):
            return {"over": 500 * 2**20, "within": 400 * 2**20}[
                pod.metadata.name]

    mgr = ev.EvictionManager(store, "n1",
                             thresholds={"memory.available": "100Mi"},
                             stats=Stats())
    out.append([p.metadata.name for p in mgr._rank_pods()])
    return out


def sc_housekeeping(k, tmp):
    """The sync loop drives eviction and image GC."""
    store = k.Store()
    kl = k.kubelet_of(store, "kn1", capacity={"cpu": "4", "memory": "512Mi",
                                              "pods": "10"})
    kl.start()
    try:
        kl.eviction_manager = k.eviction.EvictionManager(
            store, "kn1", thresholds={"memory.available": "100Mi"},
            stats=k.eviction.CgroupStatsStub(store, "kn1", 512 * 1024**2))
        node = store.get_node("kn1")
        up = k.types.shallow_copy(node)
        up.status = k.types.shallow_copy(node.status)
        up.status.images = [k.types.ContainerImage([f"i{j}"], 50)
                            for j in range(4)]
        store.update_node(up)
        mgr = k.imagegc.ImageGCManager(store, "kn1", capacity_bytes=100,
                                       low_threshold_percent=50)
        mgr.GC_INTERVAL_SECONDS = 0.0
        kl.image_gc_manager = mgr
        store.create_pod(k.MakePod().name("fat").uid("fu").node("kn1")
                         .req({"memory": "500Mi"}).obj())
        out = [wait_for(lambda: _phase(store, "fat") == "Failed"),
               store.get_pod("default", "fat").status.reason,
               kl.eviction_manager.evicted]
        out.append(wait_for(lambda: bool(mgr.freed)))
        out.append(sum(i.size_bytes
                       for i in store.get_node("kn1").status.images) <= 50)
        return out
    finally:
        kl.stop()


def sc_image_gc(k, tmp):
    store = k.Store()
    store.add_node(k.MakeNode().name("n1").capacity({"cpu": "8"}).obj())
    node = store.get_node("n1")
    up = k.types.shallow_copy(node)
    up.status = k.types.shallow_copy(node.status)
    up.status.images = [k.types.ContainerImage([f"img{i}"], 30)
                        for i in range(4)]
    store.update_node(up)
    store.create_pod(k.MakePod().name("p").uid("pu").node("n1")
                     .container(image="img3").obj())
    mgr = k.imagegc.ImageGCManager(store, "n1", capacity_bytes=100,
                                   high_threshold_percent=85,
                                   low_threshold_percent=60)
    for img in ("img0", "img1", "img2"):
        mgr.note_image_used(img)
    out = [mgr.garbage_collect()]
    out.append(sorted(i.names[0]
                      for i in store.get_node("n1").status.images))
    out.append(mgr.garbage_collect())
    return out


def sc_container_manager(k, tmp):
    cm, pq = k.cm, k.resource.parse_quantity
    out = [cm.pod_qos(k.MakePod().name("be").obj()),
           cm.pod_qos(k.MakePod().name("bu").req({"cpu": "100m"}).obj())]
    g = k.MakePod().name("g").req({"cpu": "500m", "memory": "1Gi"}).obj()
    c = g.spec.containers[0]
    c.resources.limits = dict(c.resources.requests)
    out.append(cm.pod_qos(g))
    mixed = k.MakePod().name("m").req({"cpu": "500m", "memory": "1Gi"}).obj()
    mixed.spec.containers[0].resources.limits = {
        "cpu": pq("1"), "memory": pq("1Gi")}
    out.append(cm.pod_qos(mixed))
    mgr = cm.ContainerManager(capacity_cpu_milli=8000,
                              capacity_memory=16 * 2**30)
    mgr.create_pod_cgroup(k.MakePod().name("bu").uid("bu1")
                          .req({"cpu": "500m"}).obj())
    g = k.MakePod().name("g").uid("g1").req(
        {"cpu": "1", "memory": "1Gi"}).obj()
    g.spec.containers[0].resources.limits = dict(
        g.spec.containers[0].resources.requests)
    mgr.create_pod_cgroup(g)

    def tree_view():
        return sorted((path, n.cpu_shares, n.cpu_quota, n.memory_limit)
                      for path, n in mgr.tree().items())

    out.append(tree_view())
    mgr.delete_pod_cgroup("bu1")
    out.append(tree_view())
    mgr = cm.ContainerManager(capacity_cpu_milli=1000,
                              capacity_memory=2**30)
    ok = k.MakePod().name("a").uid("a1").req({"cpu": "800m"}).obj()
    out.append(mgr.admit(ok))
    mgr.create_pod_cgroup(ok)
    out.append(mgr.admit(k.MakePod().name("b").uid("b1")
                         .req({"cpu": "500m"}).obj()))
    return out


def sc_over_allocatable(k, tmp):
    store = k.Store()
    kl = k.kubelet_of(store, "cmn1", capacity={"cpu": "1", "memory": "1Gi",
                                               "pods": "10"})
    kl.start()
    try:
        store.create_pod(k.MakePod().name("fits").uid("f1").node("cmn1")
                         .req({"cpu": "800m"}).obj())
        out = [wait_for(lambda: _phase(store, "fits") == "Running"),
               kl.container_manager.qos_of("f1")]
        store.create_pod(k.MakePod().name("over").uid("o1").node("cmn1")
                         .req({"cpu": "500m"}).obj())
        out.append(wait_for(lambda: _phase(store, "over") == "Failed"))
        return out
    finally:
        kl.stop()


def sc_pleg(k, tmp):
    rt = k.cri.FakeRuntime()
    got = []
    pleg = k.pleg.PLEG(rt, lambda ev: got.append((ev.type, ev.pod_uid)))
    sid = rt.run_pod_sandbox("u1", "p1", "default")
    cid = rt.create_container(sid, "c", "img")
    out = [[(e.type, e.pod_uid) for e in pleg.relist()]]
    rt.start_container(cid)
    out.append([(e.type, e.pod_uid) for e in pleg.relist()])
    rt.stop_container(cid)
    out.append([(e.type, e.pod_uid) for e in pleg.relist()])
    rt.remove_container(cid)
    out.append([(e.type, e.pod_uid) for e in pleg.relist()])
    out += [pleg.events_emitted, pleg.healthy()]
    sid2 = rt.run_pod_sandbox("u2", "p2", "default")
    cid2 = rt.create_container(sid2, "c", "img")
    rt.start_container(cid2)
    rt.stop_container(cid2)
    out.append([(e.type, e.pod_uid) for e in pleg.relist()])
    out.append(got)
    # a container killed behind the kubelet's back restarts (Always)
    store = k.Store()
    rt = k.cri.FakeRuntime()
    kl = k.kubelet_of(store, "plegn1", runtime=rt,
                      capacity={"cpu": "4", "memory": "8Gi", "pods": "10"})
    kl.start()
    try:
        store.create_pod(k.MakePod().name("p").uid("pu").node("plegn1")
                         .req({"cpu": "100m"}).obj())
        out.append(wait_for(lambda: bool(kl._containers_of.get("pu"))))
        cid = list(kl._containers_of["pu"].values())[0]
        rt.stop_container(cid)
        out.append(wait_for(lambda: rt.container_status(cid).state
                            == "RUNNING"
                            and rt.container_status(cid).restarts >= 1))
        return out
    finally:
        kl.stop()


def sc_volumes(k, tmp):
    T = k.types
    store = k.Store()
    kl = k.kubelet_of(store, capacity={"cpu": "8", "memory": "16Gi"})
    kl.start()
    try:
        store.add_pv(T.PersistentVolume(
            metadata=T.ObjectMeta(name="pv-1"),
            capacity={"storage": k.resource.parse_quantity("1Gi")}))
        store.add_pvc(T.PersistentVolumeClaim(
            metadata=T.ObjectMeta(name="data", namespace="default"),
            volume_name="pv-1", phase="Bound"))
        pod = k.MakePod().name("db").uid("u-db").pvc("data").obj()
        store.create_pod(pod)
        store.bind("default", "db", pod.uid, "n1")
        out = [wait_for(lambda: store.get_node("n1").status.volumes_in_use
                        == ["pv-1"])]
        time.sleep(0.3)
        out += [_phase(store, "db"), kl.running_pods(),
                kl.volumes.mounted(pod.uid)]
        store.mutate_object(
            "Node", "", "n1",
            lambda n: n.status.__setattr__("volumes_attached",
                                           ["pv-1"]) or True)
        out.append(wait_for(lambda: _phase(store, "db") == "Running"))
        out.append(kl.volumes.mounted(pod.uid))
        store.delete_pod("default", "db")
        out.append(wait_for(lambda: not kl.running_pods()))
        out.append(wait_for(lambda: store.get_node("n1").status
                            .volumes_in_use == []))
        out += [kl.volumes.mounted(pod.uid), kl.runtime.list_pod_sandboxes()]
        scratch = k.MakePod().name("scratch").uid("u-scratch").obj()
        scratch.spec.volumes.append(T.Volume(name="tmp", ephemeral=True))
        store.create_pod(scratch)
        store.bind("default", "scratch", scratch.uid, "n1")
        out.append(wait_for(lambda: _phase(store, "scratch") == "Running"))
        out.append(kl.volumes.mounted(scratch.uid))
        return out
    finally:
        kl.stop()


STATIC = {"metadata": {"name": "etcd", "namespace": "kube-system"},
          "spec": {"containers": [{"name": "etcd", "image": "etcd:3"}]}}


def sc_static_pods(k, tmp):
    store = k.Store()
    rt = k.cri.FakeRuntime()
    kl = k.kubelet_of(store, "cp-1", runtime=rt,
                      static_pod_manifests=[STATIC])
    kl.start()
    try:
        out = [wait_for(lambda: _phase(store, "etcd-cp-1", "kube-system")
                        == "Running")]
        mirror = store.get_pod("kube-system", "etcd-cp-1")
        out += [mirror.spec.node_name, mirror.uid,
                sorted(mirror.metadata.annotations)]
        sandboxes = kl.runtime.list_pod_sandboxes()
        store.delete_pod("kube-system", "etcd-cp-1")
        out.append(wait_for(lambda: _phase(store, "etcd-cp-1",
                                           "kube-system") == "Running"))
        out.append(kl.runtime.list_pod_sandboxes() == sandboxes)
    finally:
        kl.stop()
    kl2 = k.kubelet_of(store, "cp-1", runtime=rt,
                       static_pod_manifests=[STATIC])
    kl2.start()
    other = k.kubelet_of(store, "cp-2", static_pod_manifests=[STATIC])
    other.start()
    try:
        out.append(wait_for(lambda: store.get_pod(
            "kube-system", "etcd-cp-2") is not None))
        time.sleep(0.3)
        out.append(store.get_pod("kube-system", "etcd-cp-1").uid)
        out.append(len(rt.list_pod_sandboxes()))
        out.append(sorted(p.metadata.name for p in store.list_pods()))
        out.append(store.get_pod("kube-system", "etcd-cp-2").spec.node_name)
        return out
    finally:
        kl2.stop()
        other.stop()


def _pod_with_inits(k, store, name, inits, restart_policy="Always"):
    pod = k.MakePod().name(name).uid(f"u-{name}").container(
        image="app").obj()
    pod.spec.init_containers = [k.types.Container(name=f"init-{i}",
                                                  image=img)
                                for i, img in enumerate(inits)]
    pod.spec.restart_policy = restart_policy
    store.create_pod(pod)
    store.bind("default", name, pod.uid, "n1")
    return pod


def sc_init_containers(k, tmp):
    store = k.Store()
    rt = k.cri.FakeRuntime(exit_after={"init-a": 0.1, "init-b": 0.1},
                           fail_images={"bad-init"})
    kl = k.kubelet_of(store, runtime=rt)
    kl.start()
    try:
        _pod_with_inits(k, store, "web", ["init-a", "init-b"])
        _pod_with_inits(k, store, "doomed", ["bad-init"],
                        restart_policy="Never")
        out = [wait_for(lambda: any(
            c.type == "Initialized" and c.status == "False"
            for c in store.get_pod("default", "web").status.conditions))]
        out.append(_phase(store, "web"))
        out.append(wait_for(lambda: _phase(store, "web") == "Running"))
        out.append(sorted((c.type, c.status) for c in
                          store.get_pod("default", "web").status.conditions))
        inits = sorted((c for c in rt.list_containers()
                        if c.image.startswith("init-")),
                       key=lambda c: c.image)
        out.append([(c.image, c.state, c.exit_code) for c in inits])
        out.append(inits[0].finished_at <= inits[1].started_at)
        out.append(wait_for(lambda: _phase(store, "doomed") == "Failed"))
        out.append(sorted(c.image for c in rt.list_containers()))
        return out
    finally:
        kl.stop()


def sc_graceful_stop(k, tmp):
    store = k.Store()
    kl = k.kubelet_of(store)
    kl.start()
    try:
        pod = k.MakePod().name("web").uid("u-grace").container(
            image="app").obj()
        pod.spec.containers[0].lifecycle = {
            "preStop": {"exec": {"command": ["/bin/drain"]}},
            "postStart": {"exec": {"command": ["/bin/warm"]}}}
        store.create_pod(pod)
        store.bind("default", "web", pod.uid, "n1")
        out = [wait_for(lambda: _phase(store, "web") == "Running")]
        cid = list(kl._containers_of[pod.uid].values())[0]
        store.delete_pod("default", "web")
        out.append(wait_for(lambda: not kl.running_pods()))
        out.append([(c == cid, p) for c, p in kl.runtime.exec_records])
        fast = k.MakePod().name("fast").uid("u-fast").container(
            image="app").obj()
        fast.spec.termination_grace_period_seconds = 0
        store.create_pod(fast)
        store.bind("default", "fast", fast.uid, "n1")
        out.append(wait_for(lambda: bool(kl.running_pods())))
        store.delete_pod("default", "fast")
        out.append(wait_for(lambda: not kl.running_pods(), timeout=3))
        return out
    finally:
        kl.stop()


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_kubelet_scenario_equals_the_reference(scenario, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    run = SCENARIOS[scenario]
    got = run(PKGS["port"], str(tmp_path / "port"))
    want = run(PKGS["jax"], str(tmp_path / "jax"))
    assert got == want
    # what the JAX test asserts, on the port's report
    flat = [x for x in got if isinstance(x, bool)]
    assert all(flat), got


def test_kubelet_over_a_partitioned_store():
    """A kubelet whose store is the partitioned router: its node routes
    by name, its pods by namespace, and its watch merges the
    partitions' batches."""
    from kubernetes_tpu_torch.apiserver.partition import PartitionedStore

    k = PKGS["port"]
    store = PartitionedStore(3, async_dispatch=True)
    kl = k.kubelet_of(store, "pn1")
    kl.start()
    try:
        assert store.get_node("pn1") is not None
        for ns in ("a", "b", "c", "d"):
            pod = k.MakePod().name("w").uid(f"u-{ns}").container(
                image="app").obj()
            pod.metadata.namespace = ns
            store.create_pod(pod)
            store.bind(ns, "w", pod.uid, "pn1")
        assert wait_for(lambda: all(_phase(store, "w", ns) == "Running"
                                    for ns in ("a", "b", "c", "d")))
        assert len(kl.running_pods()) == 4
    finally:
        kl.stop()
        store.stop()
