"""The volume path of the port against the JAX package: the storage types
and the store (its binder and its events), the four volume plugins'
Filter statuses and VolumeBinding's Reserve and PreBind, ``is_host_only``,
the encoder's attach columns, shared-volume slots and per-pod references,
and, through each package's harness or batch loop on the CPU, the five PV
rows and the shared-CSI fixture at a small size: the same pod -> node
maps, the same victims and the same PV for every claim. Tolerance: exact
equality throughout.

Both sides are built from one description: ``Twin`` makes the same
storage objects from either package's types."""

import copy
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.resource import parse_quantity as jax_quantity
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config.types import KubeSchedulerConfiguration
from kubernetes_tpu.harness import perf as jax_perf
from kubernetes_tpu.harness import workloads as jax_workloads
from kubernetes_tpu.ops.encode import (
    BatchEncoder as JaxEncoder,
    is_host_only as jax_is_host_only,
)
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu.scheduler.framework.cycle_state import (
    CycleState as JaxCycleState,
)
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.scheduler.snapshot import new_snapshot as jax_snapshot
from kubernetes_tpu_torch.api import types as pt
from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.ops.encode import BatchEncoder, is_host_only
from kubernetes_tpu_torch.ops.planes import from_reference, prepare
from kubernetes_tpu_torch.ops.solver import pack_podin
from kubernetes_tpu_torch.scheduler import queue as q
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulerConfiguration,
)
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from test_torch_pipeline import pump
from test_torch_serial import batch_arm, outcome

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
VOLUME_PLUGINS = ("VolumeRestrictions", "EBSLimits", "GCEPDLimits",
                  "NodeVolumeLimits", "AzureDiskLimits", "VolumeBinding",
                  "VolumeZone")


class Twin:
    """One package's store and types: the same calls make the same
    storage objects on either side."""

    def __init__(self, ref: bool, store=None):
        self.ref = ref
        self.t = jt if ref else pt
        self.q = jax_quantity if ref else parse_quantity
        self.store = store if store is not None else (
            JaxStore() if ref else ClusterStore())

    def meta(self, name, **labels):
        return self.t.ObjectMeta(name=name, namespace="default",
                                 labels=dict(labels))

    def sc(self, name, mode="Immediate", provisioner="kubernetes.io/fake"):
        self.store.add_storage_class(self.t.StorageClass(
            metadata=self.meta(name), provisioner=provisioner,
            volume_binding_mode=mode))

    def pv(self, name, sc="sc", claim=None, driver="", modes=(), cap="1Gi",
           affinity=None, labels=None):
        self.store.add_pv(self.t.PersistentVolume(
            metadata=self.meta(name, **(labels or {})),
            capacity={"storage": self.q(cap)}, access_modes=list(modes),
            storage_class_name=sc,
            node_affinity=(self.t.NodeSelector.from_dict(affinity)
                           if affinity else None),
            claim_ref=f"default/{claim}" if claim else None,
            phase="Bound" if claim else "Available", csi_driver=driver))

    def pvc(self, name, pv="", sc="sc", modes=(), size="1Gi"):
        self.store.add_pvc(self.t.PersistentVolumeClaim(
            metadata=self.meta(name), storage_class_name=sc,
            access_modes=list(modes), requests={"storage": self.q(size)},
            volume_name=pv, phase="Bound" if pv else "Pending"))

    def pair(self, name, sc="sc", driver="", modes=(), **pv_kw):
        self.pv(f"pv-{name}", sc=sc, claim=name, driver=driver, modes=modes,
                **pv_kw)
        self.pvc(name, pv=f"pv-{name}", sc=sc, modes=modes)

    def csi_node(self, node, driver, limit):
        self.store.add_csi_node(self.t.CSINode(
            metadata=self.meta(node),
            drivers=[self.t.CSINodeDriver(name=driver, node_id=node,
                                          allocatable_count=limit)]))

    def pod(self, d):
        return (jt.Pod if self.ref else pt.Pod).from_dict(copy.deepcopy(d))

    def node(self, d):
        return (jt.Node if self.ref else pt.Node).from_dict(copy.deepcopy(d))


def node_dict(i, zone=None, extra_alloc=None):
    cap = {"cpu": "8", "memory": "16Gi", "pods": "110",
           **(extra_alloc or {})}
    return {"metadata": {"name": f"n{i}", "labels": {
        HOST: f"n{i}", ZONE: zone or f"z{i % 3}"}},
        "status": {"capacity": cap}}


def pod_dict(name, *volumes, node="", cpu="100m"):
    spec = {"containers": [{"name": "c", "resources": {"requests": {
        "cpu": cpu, "memory": "100Mi"}}}],
        "volumes": [dict(v, name=f"v{i}") for i, v in enumerate(volumes)]}
    if node:
        spec["nodeName"] = node
    return {"metadata": {"name": name, "uid": f"u-{name}"}, "spec": spec}


def claim(name):
    return {"persistentVolumeClaim": {"claimName": name}}


NODES = [node_dict(i) for i in range(5)] + [node_dict(
    5, extra_alloc={"attachable-volumes-aws-ebs": "1"})]


def storage(tw: Twin) -> None:
    """Every volume shape the plugins and the encoder tell apart."""
    tw.sc("sc")
    tw.sc("wfc", mode="WaitForFirstConsumer")
    tw.sc("wfc-zonal", mode="WaitForFirstConsumer")
    tw.sc("wfc-dry", mode="WaitForFirstConsumer", provisioner="")
    tw.sc("csi", provisioner="csi.x")
    tw.pair("c-bound")
    tw.pair("c-zone", labels={ZONE: "z1"})
    tw.pair("c-multizone", labels={ZONE: "z0__z2"})
    tw.pair("c-aff", affinity={"nodeSelectorTerms": [{"matchExpressions": [
        {"key": HOST, "operator": "In", "values": ["n2", "n3"]}]}]})
    for i in range(4):
        tw.pair(f"c-csi-{i}", sc="csi", driver="csi.x")
    tw.pair("c-rwx", sc="csi", driver="csi.x", modes=["ReadWriteMany"])
    tw.pair("c-rwx2", sc="csi", driver="csi.x", modes=["ReadWriteMany"])
    tw.pair("c-rwx-plain", modes=["ReadWriteMany"])
    tw.pv("pv-w-big", sc="wfc", cap="2Gi")
    tw.pv("pv-w-small", sc="wfc", cap="1Gi")
    tw.pvc("c-wfc", sc="wfc")
    tw.pvc("c-wfc2", sc="wfc")
    tw.pv("pv-z", sc="wfc-zonal", affinity={"nodeSelectorTerms": [{
        "matchExpressions": [{"key": ZONE, "operator": "In",
                              "values": ["z1"]}]}]})
    tw.pvc("c-wfc-zonal", sc="wfc-zonal")
    tw.pvc("c-wfc-dry", sc="wfc-dry")
    tw.pvc("c-immediate", sc="sc")
    tw.pvc("c-csi-pending", sc="csi")
    for i in range(6):
        tw.csi_node(f"n{i}", "csi.x", 1 if i == 4 else 2)


EXISTING = [
    pod_dict("e0", claim("c-csi-0"), claim("c-csi-1"), node="n0"),
    pod_dict("e1", {"gcePersistentDisk": {"pdName": "d1"}},
             {"awsElasticBlockStore": {"volumeID": "vol-1"}}, node="n1"),
    pod_dict("e4", claim("c-rwx"), node="n4"),
    pod_dict("e5", {"awsElasticBlockStore": {"volumeID": "vol-5"}},
             {"azureDisk": {"diskName": "a5"}}, node="n5"),
    pod_dict("e3", {"rbd": {"pool": "p", "image": "i3"}}, node="n3"),
]

PENDING = {
    "bound": [claim("c-bound")],
    "zone": [claim("c-zone")],
    "multizone": [claim("c-multizone")],
    "affinity": [claim("c-aff")],
    "csi": [claim("c-csi-2")],
    "csi-two": [claim("c-csi-2"), claim("c-csi-3")],
    "csi-attached": [claim("c-csi-1")],
    "rwx": [claim("c-rwx")],
    "rwx-two": [claim("c-rwx"), claim("c-rwx2")],
    "rwx-plain": [claim("c-rwx-plain")],
    "wfc": [claim("c-wfc")],
    "wfc-zonal": [claim("c-wfc-zonal")],
    "wfc-dry": [claim("c-wfc-dry")],
    "immediate": [claim("c-immediate")],
    "csi-pending": [claim("c-csi-pending")],
    "missing": [claim("no-such-claim")],
    "gce-conflict": [{"gcePersistentDisk": {"pdName": "d1"}}],
    "gce": [{"gcePersistentDisk": {"pdName": "d2"}}],
    "aws": [{"awsElasticBlockStore": {"volumeID": "vol-2"}}],
    "azure": [{"azureDisk": {"diskName": "a6"}}],
    "rbd": [{"rbd": {"pool": "p", "image": "i3"}}],
    "iscsi": [{"iscsi": {"targetPortal": "t", "iqn": "q", "lun": 1}}],
    "host-path": [{"hostPath": {"path": "/data"}}],
    "none": [],
}


def schedulers():
    """Both packages' schedulers over NODES, EXISTING and ``storage``."""
    out = []
    for ref in (True, False):
        tw = Twin(ref)
        storage(tw)
        for d in NODES:
            tw.store.add_node(tw.node(d))
        tw.store.create_pods([tw.pod(d) for d in EXISTING])
        if ref:
            sched = JaxScheduler.create(
                tw.store, config=KubeSchedulerConfiguration(parallelism=1))
            sched.start()
            sched.algorithm.update_snapshot()
        else:
            sched = Scheduler(tw.store, config=SchedulerConfiguration(),
                              rng=random.Random(0))
            sched.start()
            sched.update_snapshot()
        out.append(sched)
    return out


def _status(s):
    return (0, []) if s is None else (s.code, list(s.reasons))


def test_types_read_what_the_reference_reads():
    d = pod_dict("all", *[v for vs in PENDING.values() for v in vs])
    d["spec"]["volumes"].append({"name": "eph", "ephemeral": {}})
    d["spec"]["volumes"].append({"name": "eph2", "ephemeral": {"x": 1}})
    got, want = pt.Pod.from_dict(d), jt.Pod.from_dict(d)
    assert len(got.spec.volumes) == len(want.spec.volumes) == len(
        d["spec"]["volumes"])
    for a, b in zip(got.spec.volumes, want.spec.volumes):
        assert a.__dict__ == b.__dict__
    assert pt.Pod.from_dict(pod_dict("none")).spec.volumes == []


def test_store_serves_storage_and_binds_like_the_reference():
    sides = [Twin(ref) for ref in (True, False)]
    for tw in sides:
        storage(tw)

    def view(tw):
        s = tw.store
        return (sorted((p.name, p.claim_ref, p.phase, p.csi_driver)
                       for p in s.list_pvs()),
                sorted((c.namespace, c.name, c.volume_name, c.phase)
                       for c in s.list_all_pvcs()),
                sorted(c.name for c in s.list_storage_classes()),
                sorted((c.metadata.name, [(d.name, d.allocatable_count)
                                          for d in c.drivers])
                       for c in s.list_csi_nodes()),
                s.get_pvc("default", "c-wfc").volume_name,
                s.get_pv("pv-w-big").claim_ref,
                s.get_storage_class("wfc").volume_binding_mode,
                s.get_csi_node("n4").drivers[0].allocatable_count)

    assert view(sides[0]) == view(sides[1])
    for tw in sides:
        s = tw.store
        s.assume_pv_bound("pv-w-big", "default/c-wfc")
        s.revert_assumed_pv("pv-w-big")
        assert s.bind_pv("pv-w-big", "default", "c-wfc")
        assert not s.bind_pv("pv-nope", "default", "c-wfc")
        assert not s.unbind_pv("pv-w-small", "default", "c-wfc")
    assert view(sides[0]) == view(sides[1])
    assert sides[1].store.get_pvc("default", "c-wfc").phase == "Bound"
    for tw in sides:
        assert tw.store.unbind_pv("pv-w-big", "default", "c-wfc")
    assert view(sides[0]) == view(sides[1])
    assert sides[1].store.get_pv("pv-w-big").phase == "Available"


def test_storage_events_invalidate_the_state_and_wake_parked_pods():
    """Every PV, claim, class or CSINode event bumps the cache's mutation
    sequence; adds and updates move parked pods with the reference's
    event names."""
    ref, port = schedulers()
    moves = []
    port.queue.move_all_to_active_or_backoff_queue = moves.append
    tw = Twin(False, port.client)
    seq = port.cache.mutation_seq
    tw.sc("late")
    tw.pair("c-late")
    tw.csi_node("n0", "csi.x", 3)
    tw.csi_node("n0", "csi.x", 4)
    assert port.client.bind_pv("pv-w-small", "default", "c-wfc2")
    assert port.cache.mutation_seq == seq + 7
    assert moves == [q.STORAGE_CLASS_ADD, q.PV_ADD, q.PVC_ADD,
                     q.CSI_NODE_UPDATE, q.CSI_NODE_UPDATE, q.PV_UPDATE,
                     q.PVC_UPDATE]
    jax_events = __import__("kubernetes_tpu.scheduler.events",
                            fromlist=["x"])
    for name in ("PV_ADD", "PV_UPDATE", "PVC_ADD", "PVC_UPDATE",
                 "STORAGE_CLASS_ADD", "CSI_NODE_ADD", "CSI_NODE_UPDATE"):
        assert getattr(q, name) == getattr(jax_events, name)
    ref.stop()
    port.stop()


def test_volume_filters_equal_the_reference():
    ref, port = schedulers()
    rfw = ref.profiles["default-scheduler"]
    rnis, pnis = ref.algorithm.snapshot.list(), port.snapshot.list()
    assert [n.node.name for n in rnis] == [n.node.name for n in pnis]
    checked = 0
    for name, vols in PENDING.items():
        d = pod_dict(name, *vols)
        rpod, ppod = jt.Pod.from_dict(copy.deepcopy(d)), pt.Pod.from_dict(d)
        rstate, pstate = JaxCycleState(), CycleState()
        assert _status(rfw.run_pre_filter_plugins(rstate, rpod)) == \
            _status(port.framework.run_pre_filter_plugins(pstate, ppod)), name
        for plugin in VOLUME_PLUGINS:
            rp, pp = rfw.get_plugin(plugin), port.framework.get_plugin(plugin)
            for rni, pni in zip(rnis, pnis):
                assert _status(pp.filter(pstate, ppod, pni)) == _status(
                    rp.filter(rstate, rpod, rni)), (name, plugin,
                                                    pni.node.name)
                checked += 1
    assert checked == len(PENDING) * len(VOLUME_PLUGINS) * len(NODES)
    ref.stop()
    port.stop()


def test_volume_binding_reserve_and_pre_bind_like_the_reference():
    """A WaitForFirstConsumer claim: Filter matches the smallest fitting
    PV in PV order, Reserve assumes it, Unreserve lets it go, PreBind binds
    it; both stores end alike."""
    ref, port = schedulers()
    rvb = ref.profiles["default-scheduler"].get_plugin("VolumeBinding")
    pvb = port.framework.get_plugin("VolumeBinding")
    d = pod_dict("w", claim("c-wfc"), claim("c-wfc2"))
    rpod, ppod = jt.Pod.from_dict(copy.deepcopy(d)), pt.Pod.from_dict(d)
    ends = []
    for vb, sched, pod, state in ((rvb, ref, rpod, JaxCycleState()),
                                  (pvb, port, ppod, CycleState())):
        nis = (sched.algorithm.snapshot.list() if sched is ref
               else sched.snapshot.list())
        assert vb.pre_filter(state, pod) is None
        assert vb.filter(state, pod, nis[2]) is None
        assert vb.reserve(state, pod, "n2") is None
        vb.unreserve(state, pod, "n2")
        assert vb.reserve(state, pod, "n2") is None
        assert vb.pre_bind(state, pod, "n2") is None
        ends.append(sorted((c.name, c.volume_name)
                           for c in sched.client.list_all_pvcs()))
        sched.stop()
    assert ends[0] == ends[1]
    assert ("c-wfc", "pv-w-big") in ends[1] and ("c-wfc2", "pv-w-small") \
        in ends[1]


@pytest.mark.parametrize("name", sorted(PENDING))
def test_is_host_only_agrees_with_the_reference(name):
    tws = [Twin(ref) for ref in (True, False)]
    for tw in tws:
        storage(tw)
    d = pod_dict(name, *PENDING[name])
    want = jax_is_host_only(jt.Pod.from_dict(copy.deepcopy(d)),
                            tws[0].store, {})
    got = is_host_only(pt.Pod.from_dict(d), tws[1].store, {})
    assert got == want
    # without a store every claim is host-only, on both sides
    assert is_host_only(pt.Pod.from_dict(d)) == jax_is_host_only(
        jt.Pod.from_dict(copy.deepcopy(d)))


# ----------------------------------------------------------------------
# the encoder on the shared-volume fixture
def _shared_fixture(tw, n_nodes=4, limit=2):
    for i in range(n_nodes):
        tw.store.add_node(tw.node(node_dict(i)))
        tw.csi_node(f"n{i}", "csi.x", limit)
    tw.sc("csi", provisioner="csi.x")
    for c in range(4):
        tw.pair(f"claim{c}", sc="csi", driver="csi.x",
                modes=["ReadWriteMany"])
    for c in range(3):
        tw.pair(f"own{c}", sc="csi", driver="csi.x")
    tw.pair("plain")


REF_BATCH_FIELDS = (
    "requests", "nonzero_requests", "profile_idx", "inexpressible", "pod_sc",
    "pod_sc_match", "match_by", "own_aff", "own_anti", "pref_weight",
    "static_masks", "affinity_masks", "static_scores", "sc_key_idx",
    "sc_max_skew", "sc_hard", "sc_counts", "sc_domain", "term_key_idx",
    "term_counts", "term_owners", "pod_sv", "num_real_pods", "num_values")
CLUSTER_FIELDS = ("node_names", "num_real_nodes", "resource_names",
                  "allocatable", "requested", "nonzero_requested",
                  "pod_count", "max_pods", "sv_attached", "sv_keys")
POD_FIELDS = ("requests", "nonzero_requests", "profile_idx",
              "inexpressible", "pod_sv")


def _equal_fields(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def test_encoder_attach_columns_and_slots_equal_the_reference():
    """Existing pods: n0 holds claim0 and claim1 (full), n1 claim2 and own0;
    n3 holds three volumes over a limit of 2 (its bits stay clear). The
    batch: shared pods of every claim, pods of the private volumes own1
    and own0 (attached on n3 and n1: flagged inexpressible) and own2 (one
    attachment requested), one of a plain claim, one with no volume."""
    existing = [pod_dict("e0", claim("claim0"), claim("claim1"), node="n0"),
                pod_dict("e1", claim("claim2"), claim("own0"), node="n1"),
                pod_dict("e3", claim("claim0"), claim("claim3"),
                         claim("own1"), node="n3")]
    pods = [pod_dict(f"s{i}", claim(f"claim{i % 4}")) for i in range(8)]
    pods += [pod_dict("o1", claim("own1")), pod_dict("o0", claim("own0")),
             pod_dict("o2", claim("own2")), pod_dict("pl", claim("plain")),
             pod_dict("no")]
    encoded = []
    for ref in (True, False):
        tw = Twin(ref)
        _shared_fixture(tw)
        nodes = [n for n in tw.store.list_nodes()]
        have = [tw.pod(d) for d in existing]
        if ref:
            enc = JaxEncoder(jax_snapshot(have, nodes), pad_nodes=128,
                             client=tw.store)
        else:
            enc = BatchEncoder(new_snapshot(have, nodes), tw.store)
        cluster, batch = enc.encode([tw.pod(d) for d in pods], pad_pods=16)
        # the JAX encoder reuses its pod-side arrays for the next batch
        first = copy.copy(batch)
        for f in REF_BATCH_FIELDS:
            setattr(first, f, copy.copy(getattr(batch, f)))
        later = enc.encode_pods_only([tw.pod(d) for d in pods[::-1]], 16)
        encoded.append((cluster, first, later))
    (rc, rb, rl), (pc, pb, pl) = encoded
    rb_full, pb_full = rb, pb
    _equal_fields(pc, rc, CLUSTER_FIELDS)
    _equal_fields(pb, rb, POD_FIELDS + ("static_masks",))
    _equal_fields(pl, rl, POD_FIELDS)
    assert pc.resource_names[-1] == "attachable#csi#csi.x"
    assert pc.sv_attached.shape == (8, 128)       # 4 slots, padded to 8
    assert pc.sv_attached[:, 3].sum() == 0         # over its limit
    assert pb.pod_sv[0].tolist() == [0, 3] and pb.pod_sv[12].tolist() == [8, 0]
    assert pb.inexpressible[8] and pb.inexpressible[9]
    assert not pb.inexpressible[10] and pb.requests[10, 3] == 1
    # the JAX encoding carried over as fields packs to the port's planes
    ref = {f: getattr(rc, f) for f in ("allocatable", "requested",
                                       "nonzero_requested", "pod_count",
                                       "max_pods", "topo_codes",
                                       "sv_attached", "num_real_nodes")}
    ref.update({f: getattr(rb_full, f) for f in REF_BATCH_FIELDS})
    got = from_reference(ref, "cpu")
    want = prepare(pc, pb_full, "cpu")
    assert got[0].sv == want[0].sv == 8
    assert torch.equal(got[0].ints, want[0].ints)
    assert torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), pack_podin(pb_full)[0])


def test_encoder_rebuilds_for_a_shared_volume_after_the_epoch():
    """A shared PV made after the full encode has no slot: the pod-side
    encode returns None on both sides."""
    got = []
    for ref in (True, False):
        tw = Twin(ref)
        _shared_fixture(tw)
        nodes = tw.store.list_nodes()
        enc = (JaxEncoder(jax_snapshot([], nodes), pad_nodes=128,
                          client=tw.store) if ref
               else BatchEncoder(new_snapshot([], nodes), tw.store))
        enc.encode([tw.pod(pod_dict("a", claim("claim0")))], pad_pods=8)
        tw.pair("late", sc="csi", driver="csi.x", modes=["ReadOnlyMany"])
        got.append(enc.encode_pods_only(
            [tw.pod(pod_dict("b", claim("late")))], 8))
    assert got == [None, None]


# ----------------------------------------------------------------------
# whole paths
def _jax_row(name, ops, max_batch):
    out = {}

    def hook(sched, _bs):
        out["placements"] = {p.metadata.name: p.spec.node_name
                             for p in sched.client.list_pods()}
        out["claims"] = {c.name: c.volume_name
                         for c in sched.client.list_all_pvcs()}

    jax_perf.run_workload(name, ops, use_batch=True,
                          backend_factory=XlaPlanesBackend,
                          adaptive_chunk=False, max_batch=max_batch,
                          result_hook=hook)
    return out


@pytest.mark.parametrize("name,nodes,init,pods", [
    ("SchedulingInTreePVs", 30, 10, 90),
    ("SchedulingMigratedInTreePVs", 30, 10, 90),
    ("SchedulingCSIPVs", 12, 20, 300),
    ("SchedulingSharedPVs", 30, 0, 200),
])
def test_pv_rows_match_the_reference(name, nodes, init, pods):
    """Every pod bound to the JAX harness's node, every claim to its PV;
    at 12 nodes of 39 attachments, SchedulingCSIPVs fills nodes to the
    limit."""
    res = perf.run_workload(name, workloads.make_workload(name, nodes, init,
                                                          pods),
                            device="cpu", max_batch=64)
    want = _jax_row(name, jax_workloads.make_workload(name, nodes, init,
                                                      pods), 64)
    assert len(res.placements) == init + pods
    assert all(res.placements.values())
    assert res.placements == want["placements"]
    assert res.claims == want["claims"] and all(res.claims.values())
    if name == "SchedulingCSIPVs":
        assert max(len(v) for v in res.node_volumes.values()) == 25
    if name == "SchedulingSharedPVs":
        wfc = [pv for c, pv in res.claims.items() if c.startswith("claim-")]
        assert len(wfc) == len(set(wfc)) == res.volumes_bound == 90


@pytest.mark.parametrize("pipeline", (True, False))
def test_preemption_pvs_row_like_the_reference(pipeline):
    """PreemptionPVs at 20 nodes / 20 / 20: every preemptor bound with
    exactly one victim, the same victims and nodes as the JAX batch loop,
    every claim still bound to its PV."""
    ops = workloads.preemption_pvs(20, 20, 20)
    nodes = [ops[0]["nodeTemplate"](i) for i in range(20)]
    low = [ops[2]["podTemplate"](i) for i in range(20)]
    high = [ops[4]["podTemplate"](20 + i) for i in range(20)]
    got = {}
    for ref in (True, False):
        arm = batch_arm(nodes, ref, pipeline, True, 0, max_batch=64)
        mod = jax_workloads if ref else workloads
        mod._volumes_setup(20, "preempt-sc", "Immediate",
                           offset=20)["fn"](arm.store)
        try:
            for wave in (low, high):
                arm.store.create_pods([arm.pod(copy.deepcopy(d))
                                       for d in wave])
                pump(arm)
            names = [d["metadata"]["name"] for d in low + high]
            got[ref] = (outcome(arm.store, names),
                        {c.name: c.volume_name
                         for c in arm.store.list_all_pvcs()})
        finally:
            arm.sched.stop()
    assert got[False] == got[True]
    placed, claims = got[False]
    assert sum(1 for o in placed.values() if o == "deleted") == 20
    assert all(placed[d["metadata"]["name"]][0] for d in high)
    assert claims == {f"claim-{20 + i}": f"pv-{20 + i}" for i in range(20)}


@pytest.mark.parametrize("pipeline,mirror", [(True, True), (False, False)])
def test_shared_csi_fixture_like_the_reference(pipeline, mirror):
    """Forty pods over four shared RWX CSI claims on eight nodes with an
    attach limit of 2, after pods that fill one node: the same nodes as
    the JAX batch loop (its planes scan carries the same ``sv`` planes),
    no node over 2 volumes."""
    nodes = [node_dict(i) for i in range(8)]
    pods = [pod_dict(f"p{i}", claim(f"claim{i % 4}")) for i in range(40)]
    seed = [pod_dict("e0", claim("claim0"), claim("claim1"), node="n0")]
    got = {}
    for ref in (True, False):
        arm = batch_arm(nodes, ref, pipeline, mirror, 0, max_batch=16)
        tw = Twin(ref, arm.store)
        for i in range(8):
            tw.csi_node(f"n{i}", "csi.x", 2)
        tw.sc("csi", provisioner="csi.x")
        for c in range(4):
            tw.pair(f"claim{c}", sc="csi", driver="csi.x",
                    modes=["ReadWriteMany"])
        try:
            for wave in (seed, pods):
                arm.store.create_pods([arm.pod(copy.deepcopy(d))
                                       for d in wave])
                pump(arm)
            got[ref] = {p.metadata.name: p.spec.node_name
                        for p in arm.store.list_pods()}
            if not ref:
                assert arm.bs.session._static.sv == 8
        finally:
            arm.sched.stop()
    assert got[False] == got[True]
    assert all(got[False].values())
    per_node = {}
    for name, node in got[False].items():
        i = int(name[1:]) if name.startswith("p") else None
        vols = {"claim0", "claim1"} if i is None else {f"claim{i % 4}"}
        per_node.setdefault(node, set()).update(vols)
    assert max(len(v) for v in per_node.values()) <= 2
