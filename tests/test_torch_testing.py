"""The port's test builders (``testing/wrappers.py``) and fake plugins
(``testing/fake_plugins.py``) against the JAX package's: each builder
chain gives an object whose wire dict equals the JAX builder's, and the
fake plugins give the same verdicts. Tolerance: exact equality, a uid
generated from a per-package counter aside."""

import pytest

from kubernetes_tpu import testing as jax_testing
from kubernetes_tpu.api.serialization import to_wire as jax_to_wire
from kubernetes_tpu.scheduler.framework import interface as jax_fw
from kubernetes_tpu.testing import fake_plugins as jax_fakes
from kubernetes_tpu_torch import testing
from kubernetes_tpu_torch.api.serialization import to_wire
from kubernetes_tpu_torch.scheduler.framework import interface as fw
from kubernetes_tpu_torch.testing import fake_plugins as fakes

POD_CHAINS = {
    "bare": lambda w: w,
    "identity": lambda w: w.name("p").namespace("ns").uid("u1")
    .label("a", "b").labels({"c": "d"}),
    "resources": lambda w: w.name("r").container("img")
    .req({"cpu": "500m", "memory": "1Gi"}).init_req({"cpu": "1"})
    .overhead({"cpu": "10m"}).host_port(8080, host_ip="10.0.0.1"),
    "placement": lambda w: w.name("n").node("n1")
    .node_selector({"x": "y"}).priority(7).scheduler_name("s")
    .phase("Running").nominated_node_name("n2").terminating(2.0)
    .toleration("k", "v", "NoSchedule", operator="Equal"),
    "affinity": lambda w: w.name("a").node_affinity_in("zone", ["a", "b"])
    .node_affinity_in("rack", ["r1"]).preferred_node_affinity(3, "z", ["q"])
    .pod_affinity("app", ["w"], "h").pod_anti_affinity("app", ["x"], "h")
    .preferred_pod_affinity(2, "app", ["y"], "z")
    .preferred_pod_anti_affinity(4, "app", ["z"], "z"),
    "spread-volumes-owner": lambda w: w.name("s")
    .spread_constraint(1, "zone", "DoNotSchedule", {"app": "w"})
    .spread_constraint(2, "host", "ScheduleAnyway")
    .pvc("claim").pvc("other").owner_reference("ReplicaSet", "rs")
    .owner_reference("Job", "j", uid="x", controller=False),
}

NODE_CHAINS = {
    "bare": lambda w: w,
    "named": lambda w: w.name("n").label("a", "b")
    .capacity({"cpu": "4", "memory": "8Gi"}),
    "allocatable": lambda w: w.name("m")
    .capacity({"cpu": "4", "memory": "8Gi", "pods": "10"})
    .allocatable({"cpu": "3"}),
    "taints-images": lambda w: w.name("t").taint("k", "v")
    .taint("dedicated", effect="NoExecute").unschedulable()
    .image("img:1", 1000).image("img:2", 5),
}


def _wire(encode, obj):
    """The wire dict, a generated uid (a per-package counter, which other
    tests advance) replaced by a marker."""
    d = encode(obj)
    uid = d["metadata"].get("uid", "")
    if uid.startswith("uid-") and uid[4:].isdigit():
        d["metadata"]["uid"] = "<generated>"
    return d


@pytest.mark.parametrize("chain", sorted(POD_CHAINS))
def test_make_pod_matches_reference(chain):
    got = POD_CHAINS[chain](testing.MakePod()).obj()
    want = POD_CHAINS[chain](jax_testing.MakePod()).obj()
    assert _wire(to_wire, got) == _wire(jax_to_wire, want)


@pytest.mark.parametrize("chain", sorted(NODE_CHAINS))
def test_make_node_matches_reference(chain):
    got = NODE_CHAINS[chain](testing.MakeNode()).obj()
    want = NODE_CHAINS[chain](jax_testing.MakeNode()).obj()
    assert _wire(to_wire, got) == _wire(jax_to_wire, want)


def _verdicts(mod, fake_mod, framework):
    from types import SimpleNamespace

    pod = mod.MakePod().name("n1").obj()
    out = []
    for node in ("n1", "n2"):
        info = SimpleNamespace(node=mod.MakeNode().name(node).obj())
        for plugin in (fake_mod.TrueFilter.factory(None, None),
                       fake_mod.FalseFilter.factory(None, None),
                       fake_mod.MatchFilter.factory(None, None)):
            s = plugin.filter(None, pod, info)
            out.append((plugin.NAME, node,
                        None if s is None else (s.code, list(s.reasons))))
    score = fake_mod.FakeScore(lambda p, n: len(n) * 10)
    out.append(score.score(None, pod, "node-7"))
    reserve = fake_mod.RecordingReserve()
    out.append(reserve.reserve(None, pod, "n1"))
    reserve.unreserve(None, pod, "n1")
    out.append((reserve.reserved, reserve.unreserved))
    s = fake_mod.RecordingReserve(fail=True).reserve(None, pod, "n1")
    out.append((s.code, list(s.reasons)))
    out.append(fake_mod.FakePermit().permit(None, pod, "n1"))
    s, timeout = fake_mod.FakePermit(framework.WAIT, 2.5).permit(
        None, pod, "n1")
    out.append((s.code, list(s.reasons), timeout))
    return out


def test_fake_plugins_match_reference():
    assert _verdicts(testing, fakes, fw) \
        == _verdicts(jax_testing, jax_fakes, jax_fw)
