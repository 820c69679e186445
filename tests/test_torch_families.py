"""The four ``bench.py`` families ported last (SchedulingSecrets,
SchedulingNodeAffinity, PreferredTopologySpreading,
MixedSchedulingBasePod) at 200 nodes through both harnesses: the same
op lists, and every pod on the node the JAX harness picks."""

import pytest

from kubernetes_tpu.harness import perf as jax_perf
from kubernetes_tpu.harness import workloads as jax_workloads
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu_torch.harness import perf, workloads

FAMILIES = ("SchedulingSecrets", "SchedulingNodeAffinity",
            "PreferredTopologySpreading", "MixedSchedulingBasePod")


def _pods(ops):
    """(op, pod dict) of every createPods op's pods, in order."""
    return [(op["opcode"], op["podTemplate"](op.get("offset", 0) + i))
            for op in ops if op["opcode"] == "createPods"
            for i in range(op["count"])]


@pytest.mark.parametrize("name", FAMILIES)
def test_op_lists_equal_the_reference(name):
    ops = workloads.make_workload(name, 20, 12, 16)
    ref = jax_workloads.make_workload(name, 20, 12, 16)
    assert [o["opcode"] for o in ops] == [o["opcode"] for o in ref]
    assert _pods(ops) == _pods(ref)


@pytest.mark.parametrize("name,init,pods", [
    ("SchedulingSecrets", 100, 400),
    ("SchedulingNodeAffinity", 100, 400),
    ("PreferredTopologySpreading", 100, 400),
    ("MixedSchedulingBasePod", 200, 400),
])
def test_every_pod_on_the_reference_s_node(name, init, pods):
    placed = {}

    def hook(sched, _bs):
        placed.update({p.metadata.name: p.spec.node_name
                       for p in sched.client.list_pods()})

    jax_perf.run_workload(
        name, jax_workloads.make_workload(name, 200, init, pods),
        use_batch=True, backend_factory=XlaPlanesBackend,
        adaptive_chunk=False, max_batch=128, result_hook=hook)
    res = perf.run_workload(name, workloads.make_workload(name, 200, init,
                                                          pods),
                            device="cpu", max_batch=128)
    assert len(res.placements) == init + pods
    assert all(res.placements.values())
    assert res.placements == placed
    assert res.telemetry["cycles"] > 0
