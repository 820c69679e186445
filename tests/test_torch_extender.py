"""The port's HTTP extenders against the JAX package's, over a real
``http.server`` on 127.0.0.1 at an ephemeral port
(``harness.extender.LoopbackExtender``) and in process
(``Extender.implementation``): the same request payloads for each verb,
the same results, an ignorable extender that fails skipped and a
non-ignorable one failing the pod, a binder extender binding in place of
DefaultBinder, and seeded serial runs that put every pod on the same
node as the JAX serial path with the same extender. The batch path sends
the pods an extender is interested in to the serial path and batches the
rest, as the JAX batch path does. Tolerance: exact equality."""

import copy
import random
from types import SimpleNamespace

import pytest

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config.types import Extender as JaxExtenderConfig
from kubernetes_tpu.config.types import (
    KubeSchedulerConfiguration as JaxConfig,
)
from kubernetes_tpu.scheduler.extender import HTTPExtender as JaxHTTPExtender
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config.types import Extender as ExtenderConfig
from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
from kubernetes_tpu_torch.harness.extender import LoopbackExtender, crc_keeps
from kubernetes_tpu_torch.scheduler.extender import HTTPExtender
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import BatchScheduler
from test_torch_framework import both, cluster_dicts, pending_dicts
from test_torch_pipeline import bound_set, jax_arm, pump
from test_torch_serial import outcome, serial_pass

GPU = "example.com/gpu"


@pytest.fixture
def server():
    ext = LoopbackExtender(record=True).start()
    yield ext
    ext.stop()


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_payloads_and_results_equal_the_reference(server, seed):
    ref, port = both(seed)
    try:
        rnis, pnis = ref.algorithm.snapshot.list(), port.snapshot.list()
        fields = dict(url_prefix=server.url, filter_verb="filter",
                      prioritize_verb="prioritize", bind_verb="bind",
                      preempt_verb="preempt", weight=3)
        pext = HTTPExtender(ExtenderConfig(**fields))
        rext = JaxHTTPExtender(JaxExtenderConfig(**fields))
        for d in pending_dicts(seed, 6):
            rpod, ppod = JaxPod.from_dict(copy.deepcopy(d)), Pod.from_dict(d)
            server.payloads.clear()
            pkept, pfailed = pext.filter(ppod, pnis)
            rkept, rfailed = rext.filter(rpod, rnis)
            assert [n.node.name for n in pkept] == \
                [n.node.name for n in rkept]
            assert pfailed == rfailed
            assert pext.prioritize(ppod, pnis) == rext.prioritize(rpod, rnis)
            pext.bind(ppod, "n1")
            rext.bind(rpod, "n1")
            # port first, then the reference, verb by verb
            sent = server.payloads
            assert [v for v, _ in sent] == [
                "filter", "filter", "prioritize", "prioritize", "bind",
                "bind"]
            for i in range(0, len(sent), 2):
                assert sent[i] == sent[i + 1]
            # ProcessPreemption: the reference builds the payload but
            # cannot send it over HTTP (it looks up a
            # ``process_preemption_verb`` field; the field is
            # ``preempt_verb``), so its payload is read in process
            server.payloads.clear()
            victims = {"n0": [ppod], "n2": [ppod]}
            assert pext.process_preemption(ppod, victims) == victims
            with pytest.raises(AttributeError, match="process_preemption"):
                rext.process_preemption(rpod, {"n0": [rpod]})
            seen = []
            rin = JaxHTTPExtender(JaxExtenderConfig(implementation=type(
                "Impl", (), {"process_preemption": lambda self, body: (
                    seen.append(body) or {"nodeNames": ["n0", "n2"]})})()))
            rin.process_preemption(rpod, {"n0": [rpod], "n2": [rpod]})
            assert server.payloads == [("preempt", seen[0])]
    finally:
        ref.stop()
        port.stop()


class _InProcess:
    """The verbs in process: the same answers as the loopback server's
    defaults, and binds into ``store``."""

    def __init__(self):
        self.calls = {"filter": 0, "prioritize": 0, "bind": 0}

    def filter(self, payload):
        self.calls["filter"] += 1
        names = payload["nodenames"]
        return {"nodenames": [n for n in names if crc_keeps(n)],
                "failedNodes": {n: "refused" for n in names
                                if not crc_keeps(n)}}

    def prioritize(self, payload):
        self.calls["prioritize"] += 1
        pod = payload["pod"]["metadata"]["name"]
        return {n: (len(pod) + int(n[1:])) % 7 for n in payload["nodenames"]}



class _Binder(_InProcess):
    """``_InProcess`` that binds too, into ``store``: a binder extender."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def bind(self, payload):
        self.calls["bind"] += 1
        self.store.bind(payload["podNamespace"], payload["podName"],
                        payload["podUID"], payload["node"])
        return {}


def _scheduler(seed, ref, extenders, n_nodes=30, n_existing=20):
    """One package's scheduler (one worker) over a seeded cluster, with
    the extender entries ``extenders(ref, store)`` gives; the JAX side's
    module-level ``random`` and the port's ``rng`` seeded alike."""
    nodes, existing = cluster_dicts(seed, n_nodes=n_nodes,
                                    n_existing=n_existing)
    if ref:
        store = JaxStore()
        for d in nodes:
            store.add_node(JaxNode.from_dict(copy.deepcopy(d)))
        for d in existing:
            store.create_pod(JaxPod.from_dict(copy.deepcopy(d)))
        sched = JaxScheduler.create(store, config=JaxConfig(
            parallelism=1, extenders=extenders(ref, store)))
        random.seed(seed)
    else:
        store = ClusterStore()
        for d in nodes:
            store.add_node(Node.from_dict(copy.deepcopy(d)))
        store.create_pods([Pod.from_dict(copy.deepcopy(d))
                           for d in existing])
        sched = Scheduler.create(store, config=KubeSchedulerConfiguration(
            parallelism=1, extenders=extenders(ref, store)),
            rng=random.Random(seed))
    sched.start()
    return sched


def _serial_with(seed, extenders, ref, n_pods=24):
    """Each of ``n_pods`` seeded pending pods attempted once: their
    outcomes."""
    sched = _scheduler(seed, ref, extenders)
    pending = pending_dicts(seed, n_pods)
    pod_cls = JaxPod if ref else Pod
    sched.client.create_pods([pod_cls.from_dict(copy.deepcopy(d))
                              for d in pending])
    try:
        serial_pass(sched, ref)
        return outcome(sched.client,
                       [d["metadata"]["name"] for d in pending]), sched
    finally:
        sched.stop()


def _config_entries(ref, **fields):
    cls = JaxExtenderConfig if ref else ExtenderConfig
    return [cls(**fields)]


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_serial_run_with_http_extender_equals_the_reference(server, seed):
    def extenders(ref, store):
        return _config_entries(ref, url_prefix=server.url,
                               filter_verb="filter",
                               prioritize_verb="prioritize", weight=2)
    got, sched = _serial_with(seed, extenders, ref=False)
    # the frameworks' handles carry the scheduler's extenders
    assert len(sched.extenders) == 1
    assert all(f.extenders is sched.extenders
               for f in sched.profiles.values())
    calls = dict(server.calls)
    want, _ = _serial_with(seed, extenders, ref=True)
    assert got == want
    assert calls["filter"] > 0 and calls["prioritize"] > 0
    assert all(crc_keeps(node) for node, _, _ in got.values() if node)


@pytest.mark.parametrize("seed", (0, 1))
def test_serial_run_with_in_process_extender_equals_the_reference(seed):
    impls = {}

    def extenders(ref, store):
        impls[ref] = _InProcess()
        return _config_entries(ref, implementation=impls[ref], weight=5)
    got, _ = _serial_with(seed, extenders, ref=False)
    want, _ = _serial_with(seed, extenders, ref=True)
    assert got == want
    assert impls[False].calls == impls[True].calls
    assert impls[False].calls["filter"] > 0


@pytest.mark.parametrize("ignorable", (True, False))
def test_failing_extender_ignorable_or_not(ignorable):
    """An extender whose verbs answer HTTP 500: ignorable, it is skipped
    and the pods place as without it; not, every pod it is interested in
    fails its attempt with the error, as in the JAX package."""
    ext = LoopbackExtender(fail=("filter", "prioritize")).start()
    try:
        def extenders(ref, store):
            return _config_entries(ref, url_prefix=ext.url,
                                   filter_verb="filter",
                                   prioritize_verb="prioritize",
                                   ignorable=ignorable)
        got, _ = _serial_with(5, extenders, ref=False, n_pods=12)
        want, _ = _serial_with(5, extenders, ref=True, n_pods=12)
        plain, _ = _serial_with(5, lambda ref, store: [], ref=False,
                                n_pods=12)
    finally:
        ext.stop()
    assert got == want
    if ignorable:
        assert got == plain
    else:
        assert all(not node for node, _, _ in got.values())
        assert all(c and c[0][1] == "SchedulerError" and "500" in c[0][2]
                   for _, c, _ in got.values())


def test_binder_extender_binds_in_place_of_the_bind_plugin():
    impls = {}

    def extenders(ref, store):
        impls[ref] = _Binder(store)
        return _config_entries(ref, implementation=impls[ref],
                               bind_verb="bind")

    got, _ = _serial_with(3, extenders, ref=False, n_pods=10)
    want, _ = _serial_with(3, extenders, ref=True, n_pods=10)
    assert got == want
    bound = sum(1 for node, _, _ in got.values() if node)
    assert bound > 0
    assert impls[False].calls["bind"] == bound == impls[True].calls["bind"]


def _port_arm(nodes, ext, pipeline):
    """``test_torch_pipeline.port_arm`` with the extender configured."""
    store = ClusterStore()
    for d in nodes:
        store.add_node(Node.from_dict(d))
    sched = Scheduler.create(store, config={
        "parallelism": 1, "extenders": [ext.config(
            filterVerb="filter", prioritizeVerb="prioritize",
            managedResources=[{"name": GPU}])]}, rng=random.Random(1))
    bs = BatchScheduler(sched, max_batch=32, device="cpu",
                        pipeline=pipeline)
    sched.start()
    return SimpleNamespace(store=store, sched=sched, bs=bs,
                           pod=Pod.from_dict)


def _gpu_pod(name, gpu):
    d = {"metadata": {"name": name, "uid": f"u-{name}"},
         "spec": {"containers": [{"name": "c", "resources": {
             "requests": {"cpu": "500m"}}}]}}
    if gpu:
        d["spec"]["containers"][0]["resources"]["requests"][GPU] = "1"
    return d


def test_batch_path_sends_interested_pods_serial():
    """With an extender managing ``example.com/gpu``, the batch loop puts
    the gpu pods through the extender on the serial path and batches the
    rest: in each arm the same pods on the same nodes as the JAX loop's
    same arm, and every gpu pod on a node the extender passed."""
    nodes = [{"metadata": {"name": f"n{i}"},
              "status": {"capacity": {"cpu": "8", "memory": "16Gi",
                                      "pods": "110", GPU: "4"}}}
             for i in range(24)]
    pods = [_gpu_pod(f"p{i}", i % 3 == 0) for i in range(60)]
    ext = LoopbackExtender().start()
    results = {}
    try:
        for name in ("port-pipelined", "port-serialized", "jax-pipelined",
                     "jax-serialized"):
            before = dict(ext.calls)
            pipelined = name.endswith("pipelined")
            if name.startswith("jax"):
                # the serial binds make the pipelined arm discard its held
                # batch, which the JAX mirror-on arm then counts twice
                # (ROADMAP.md, section C): the mirror-off arm is the one
                # to hold to, as in test_torch_serial
                arm = jax_arm(nodes, pipeline=pipelined, mirror=False,
                              seed=1)
                arm.sched.algorithm.extenders.append(JaxHTTPExtender(
                    JaxExtenderConfig(url_prefix=ext.url,
                                      filter_verb="filter",
                                      prioritize_verb="prioritize",
                                      managed_resources=[GPU])))
            else:
                arm = _port_arm(nodes, ext, pipelined)
            arm.store.create_pods([arm.pod(copy.deepcopy(d)) for d in pods])
            try:
                pump(arm)
                results[name] = bound_set(arm)
            finally:
                arm.sched.stop()
            assert ext.calls["filter"] - before.get("filter", 0) == 20
    finally:
        ext.stop()
    assert results["port-pipelined"] == results["jax-pipelined"]
    assert results["port-serialized"] == results["jax-serialized"]
    placed = dict(results["port-pipelined"])
    assert all(placed[f"p{i}"] for i in range(60))
    assert all(crc_keeps(placed[f"p{i}"]) for i in range(0, 60, 3))
