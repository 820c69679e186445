"""The port's hollow nodes (``kubernetes_tpu_torch/kubemark/``) against the
JAX package's:

- ``HollowCluster`` under a scheduler: the same node objects, and every
  pod bound and Running with a pod IP in both packages (the scheduler's
  placements are compared as invariants: its loop races the kubelets'
  status writes);
- hollow nodes with TPU chips: the same capacity, and a four-chip pod
  that gets four devices;
- a ``HollowNode`` over the REST fabric (a ``RestClusterClient``):
  registration, the lease renewed through the lease verb, a pod driven
  to Running, no proxier; with the watch streams starting late (a
  loaded host), a kubelet and an informer factory over REST still see
  what was written between their list and the streams';
- ``HollowFleet``: the same node objects, the same rotation of lease
  renewals and the same lease holders as the JAX fleet; over the
  partitioned store and over a partition-aware client the nodes land in
  the partitions the routing function names.

The JAX case that needs the node lifecycle controller is not here: the
controllers are not ported.

Tolerance: exact equality."""

import time

import pytest

from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.kubemark import HollowCluster as JaxHollowCluster
from kubernetes_tpu.kubemark import HollowFleet as JaxHollowFleet
from kubernetes_tpu_torch.api.serialization import to_wire
from kubernetes_tpu_torch.apiserver.partition import (
    PartitionedStore,
    partition_for,
)
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.kubelet.devicemanager import TPU_RESOURCE
from kubernetes_tpu_torch.kubemark import HollowCluster, HollowFleet, HollowNode
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.testing import MakePod


def wait_for(cond, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return bool(cond())


def _node_view(store):
    """Each node's wire form without the fields a run stamps (uid,
    version, creation time)."""
    from kubernetes_tpu.api.serialization import to_wire as jax_to_wire

    out = {}
    for n in store.list_nodes():
        w = (to_wire if isinstance(store, ClusterStore) else jax_to_wire)(n)
        meta = {k: v for k, v in w["metadata"].items()
                if k not in ("uid", "resourceVersion", "creationTimestamp")}
        out[n.name] = {**w, "metadata": meta}
    return out


def test_hollow_cluster_nodes_equal_the_reference_and_run_pods():
    store, ref = ClusterStore(), JaxStore()
    cluster = HollowCluster(store)
    cluster.start_nodes(5, capacity={"cpu": "8", "memory": "16Gi"})
    ref_cluster = JaxHollowCluster(ref)
    ref_cluster.start_nodes(5, capacity={"cpu": "8", "memory": "16Gi"})
    sched = Scheduler.create(store)
    sched.run()
    try:
        assert _node_view(store) == _node_view(ref)
        # one proxier for the lot, on node 0
        assert [n.proxier._watch is not None for n in cluster.nodes] == \
            [True, False, False, False, False]
        for i in range(20):
            store.create_pod(MakePod().name(f"p{i}").uid(f"u{i}")
                             .req({"cpu": "500m"}).obj())
        assert wait_for(lambda: all(
            p.status.phase == "Running" and p.spec.node_name
            for p in store.list_pods()))
        assert len({p.spec.node_name for p in store.list_pods()}) >= 3
        assert all(p.status.pod_ip for p in store.list_pods())
        # each pod's IP is from its node's own subnet
        subnet = {n.name: f"10.88.{i}." for i, n in enumerate(cluster.nodes)}
        assert all(p.status.pod_ip.startswith(subnet[p.spec.node_name])
                   for p in store.list_pods())
    finally:
        sched.stop()
        cluster.stop()
        ref_cluster.stop()


def test_hollow_tpu_nodes_run_a_four_chip_pod():
    store, ref = ClusterStore(), JaxStore()
    cluster = HollowCluster(store)
    cluster.start_nodes(2, tpu_chips=4)
    ref_cluster = JaxHollowCluster(ref)
    ref_cluster.start_nodes(2, tpu_chips=4)
    sched = Scheduler.create(store)
    sched.run()
    try:
        assert _node_view(store) == _node_view(ref)
        assert store.get_node("hollow-0").status.capacity[
            TPU_RESOURCE].value() == 4
        store.create_pod(MakePod().name("train").uid("ut").req(
            {"cpu": "1", TPU_RESOURCE: "4"}).obj())
        assert wait_for(lambda: store.get_pod("default", "train")
                        .status.phase == "Running")
        pod = store.get_pod("default", "train")
        hollow = next(n for n in cluster.nodes if n.name == pod.spec.node_name)
        assert hollow.kubelet.devices.devices_of(pod.uid)[TPU_RESOURCE] == \
            [f"{hollow.name}-tpu{i}" for i in range(4)]
    finally:
        sched.stop()
        cluster.stop()
        ref_cluster.stop()


def test_hollow_node_over_the_rest_fabric_runs_a_pod():
    from kubernetes_tpu_torch.apiserver.rbac import provision_bootstrap_policy
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    store = ClusterStore()
    authz = provision_bootstrap_policy(store)
    authz.add_user_to_group("kubemark", "system:masters")
    server = APIServer(store=store, authorizer=authz,
                       tokens={"hollow-tok": "kubemark"}).start()
    client = RestClusterClient(server.url, token="hollow-tok",
                               watch_kinds=("Pod",))
    hollow = HollowNode(client, "hollow-rest-0",
                        capacity={"cpu": "8", "memory": "16Gi"})
    sched = Scheduler.create(store)
    sched.run()
    hollow.start()
    try:
        assert hollow.proxier is None
        assert wait_for(lambda: store.get_node("hollow-rest-0") is not None)
        assert wait_for(lambda: store.lease_holder("node-hollow-rest-0")
                        == "hollow-rest-0")
        store.create_pod(MakePod().name("hp").uid("hu")
                         .req({"cpu": "200m"}).obj())
        assert wait_for(lambda: (
            (p := store.get_pod("default", "hp")) is not None
            and p.spec.node_name == "hollow-rest-0"
            and p.status.phase == "Running" and p.status.pod_ip
            and p.status.host_ip == "hollow-rest-0"))
    finally:
        sched.stop()
        hollow.stop()
        client.close()
        server.shutdown_server()


@pytest.fixture
def late_streams(monkeypatch):
    """REST watch streams whose threads start 1.5 s late, as on a loaded
    host: a consumer that lists on its own and then watches bare misses
    what is written between its list and the stream's."""
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    real = RestClusterClient._watch_loop

    def late(self, *args, **kwargs):
        time.sleep(1.5)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(RestClusterClient, "_watch_loop", late)


def _rest_fabric():
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    store = ClusterStore()
    server = APIServer(store=store).start()
    client = RestClusterClient(server.url, watch_kinds=("Pod",))
    return store, server, client


def test_kubelet_over_rest_runs_a_pod_bound_before_its_stream_lists(
        late_streams):
    """The cause of the REST hollow node's failure under load: the
    kubelet lists, then streams on from that list's version."""
    store, server, client = _rest_fabric()
    hollow = HollowNode(client, "late-0", capacity={"cpu": "8"})
    hollow.start()
    try:
        store.create_pod(MakePod().name("early").uid("ue")
                         .req({"cpu": "100m"}).obj())
        store.bind("default", "early", "ue", "late-0")
        assert wait_for(lambda: store.get_pod("default", "early")
                        .status.phase == "Running")
    finally:
        hollow.stop()
        client.close()
        server.shutdown_server()


def test_informer_over_rest_holds_an_object_written_before_its_stream_lists(
        late_streams):
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory

    store, server, client = _rest_fabric()
    factory = SharedInformerFactory(client)
    lister = factory.lister_for("Pod")
    factory.start()
    try:
        assert factory.wait_for_cache_sync()
        store.create_pod(MakePod().name("early").uid("ue").obj())
        assert wait_for(lambda: [p.metadata.name for p in lister.list()]
                        == ["early"])
    finally:
        factory.stop()
        client.close()
        server.shutdown_server()


@pytest.mark.parametrize("beats_per_tick", [5, None])
def test_fleet_registration_and_heartbeats_equal_the_reference(
        beats_per_tick):
    store, ref = ClusterStore(), JaxStore()
    fleet = HollowFleet(store, interval=30.0, beats_per_tick=beats_per_tick)
    ref_fleet = JaxHollowFleet(ref, interval=30.0,
                               beats_per_tick=beats_per_tick)
    names = fleet.register(12, cpu="16", name_prefix="fl", chunk=5)
    assert names == ref_fleet.register(12, cpu="16", name_prefix="fl",
                                       chunk=5)
    assert _node_view(store) == _node_view(ref)
    beats = [fleet.beat_slice() for _ in range(3)]
    assert beats == [ref_fleet.beat_slice() for _ in range(3)]
    holders = [store.lease_holder(f"node-{n}") for n in names]
    assert holders == [ref.lease_holder(f"node-{n}") for n in names]
    if beats_per_tick == 5:
        assert beats == [5, 5, 5] and all(h == n for h, n in
                                          zip(holders, names))
    fleet.start()
    fleet.stop()


def test_fleet_over_the_partitioned_store_and_client():
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    ps = PartitionedStore(3, async_dispatch=True)
    fleet = HollowFleet(ps, interval=30.0)
    names = fleet.register(30, chunk=7)
    assert sorted(n.name for n in ps.list_nodes()) == sorted(names)
    for i, part in enumerate(ps.parts):
        assert all(partition_for("Node", None, n.name, 3) == i
                   for n in part.list_nodes())
    # half the fleet a tick: the rotation laps it twice a lease
    assert [fleet.beat_slice(), fleet.beat_slice()] == [15, 15]
    assert ps.lease_holder(f"node-{names[7]}") == names[7]
    fleet.stop()
    ps.stop()

    servers = [APIServer(store=ClusterStore(), partition=(i, 2)).start()
               for i in range(2)]
    client = RestClusterClient(servers[0].url,
                               partition_urls=[s.url for s in servers])
    try:
        fleet = HollowFleet(client, interval=30.0)
        names = fleet.register(20, chunk=6)
        for i, s in enumerate(servers):
            got = [n.name for n in s.store.list_nodes()]
            assert got and all(partition_for("Node", None, n, 2) == i
                               for n in got)
        assert len(client.list_nodes()) == 20
        assert [fleet.beat_slice(), fleet.beat_slice()] == [10, 10]
        # leases live on partition 0 with the long tail
        assert servers[0].store.lease_holder(f"node-{names[3]}") == names[3]
    finally:
        client.close()
        for s in servers:
            s.shutdown_server()
