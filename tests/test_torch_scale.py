"""The port's scale row (``harness/scale.py``) against the JAX package's:

- ``scale_namespaces`` and the namespace spread of ``make_burst_pods``
  give the JAX package's names and pods;
- the ``shards[...]`` diag segment the row prints is the JAX row's;
- the whole row at a small size on the CPU: two REST arms (two
  partitions and one) with their spawned partition apiservers and
  kubemark child, two replicas with batch paths, and the conflict cell,
  every invariant holding (the placements race, so the invariants are
  what is compared with the JAX row's own checks);
- the children import no torch (a subprocess imports what each child
  imports);
- with no card, the default device raises before any child starts.

Tolerance: exact equality."""

import json
import subprocess
import sys

import pytest
import torch

from kubernetes_tpu.api.serialization import to_wire as jax_to_wire
from kubernetes_tpu.harness import diagfmt as jax_diagfmt
from kubernetes_tpu.harness.burst import make_burst_pods as jax_burst
from kubernetes_tpu.harness.scale import scale_namespaces as jax_namespaces
from kubernetes_tpu_torch.api.serialization import to_wire
from kubernetes_tpu_torch.harness import diagfmt, scale
from kubernetes_tpu_torch.harness.burst import make_burst_pods


@pytest.mark.parametrize("partitions", [1, 2, 3, 4, 8])
def test_namespaces_and_burst_equal_the_reference(partitions):
    namespaces = scale.scale_namespaces(partitions)
    assert namespaces == jax_namespaces(partitions)
    got = make_burst_pods(17, cpu_milli=scale.POD_CPU_MILLI,
                          memory=scale.POD_MEMORY, name_prefix="scale-",
                          uid_prefix="sc-", offset=40,
                          namespaces=namespaces)
    want = jax_burst(17, cpu_milli=500, memory="500Mi", name_prefix="scale-",
                     uid_prefix="sc-", offset=40, namespaces=namespaces)
    assert [to_wire(p) for p in got] == [jax_to_wire(p) for p in want]


@pytest.mark.parametrize("info", [
    {"partitions": 4, "replicas": 2, "conflicts": 3, "capacity_rejects": 1,
     "balance": 0.87654, "watch_streams": 36},
    {"partitions": 2, "replicas": 2, "conflicts": 0, "capacity_rejects": 0,
     "balance": None, "watch_streams": None},
    {}])
def test_shards_diag_segment_equals_the_reference(info):
    seg = diagfmt.format_shards(info)
    assert seg == jax_diagfmt.format_shards(info)
    assert diagfmt.format_diag([seg]) == jax_diagfmt.format_diag([seg])


def test_children_import_no_torch():
    """What each spawned child of the row imports, in a fresh
    interpreter: the partition apiserver's modules and the kubemark
    child's (kubemark, whose kubelet reaches ``scheduler.types``)."""
    code = (
        "import sys\n"
        "import kubernetes_tpu_torch.harness.scale\n"
        "from kubernetes_tpu_torch.apiserver.rbac import "
        "provision_bootstrap_policy\n"
        "from kubernetes_tpu_torch.apiserver.rest import APIServer\n"
        "from kubernetes_tpu_torch.client.restcluster import "
        "RestClusterClient\n"
        "from kubernetes_tpu_torch.kubemark import HollowFleet\n"
        "import kubernetes_tpu_torch.kubelet.cm\n"
        "from kubernetes_tpu_torch.utils.gctune import tune_for_throughput\n"
        "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale.run_scale_arm_rest(nodes=10, pods=10, partitions=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale.run_scale_arm_inproc(nodes=10, pods=10, partitions=2,
                                   use_batch=True)


def test_scale_row_at_a_small_size(capsys):
    row = scale.run_scale10x_row(nodes=100, pods=400, partitions=2,
                                 replicas=2, max_batch=128, device="cpu",
                                 wait_timeout=120.0)
    assert row["invariants"] == {"lost_pods": 0, "double_binds": 0}
    assert row["conflict_cell"]["ok"]
    assert row["conflict_cell"]["conflicts_total"] > 0
    assert not row["children_import_torch"]
    arm, single = row["arms"]["partitioned"], row["arms"]["single"]
    for a in (arm, single):
        assert a["server_pods_bound"] == a["server_pods_total"] == 400
        assert a["created"] == 400
        assert a["oversubscribed_nodes"] == 0 and a["duplicated_pods"] == 0
        assert a["rv_regressions"] == 0
        assert sum(a["replica_pools"]) == 100
        assert all(n > 0 for n in a["solves"])
        assert a["device"] == "cpu"
        assert a["e2e_ms"]["p99"] >= a["e2e_ms"]["p50"] > 0
    assert arm["partition_pods"] == [200, 200]
    assert single["partition_pods"] == [400]
    # Pod and Node on each partition, the five other kinds on
    # partition 0, for each replica
    assert arm["watch_streams"] == 2 * (2 * 2 + 5)
    assert single["watch_streams"] == 2 * 7
    fed = arm["federation_instances"]
    assert {"apiserver-p0", "apiserver-p1", "scheduler-0",
            "scheduler-1"} <= set(fed)
    assert "apiserver-p1" not in single["federation_instances"]
    assert row["ab"]["speedup"] == \
        arm["pods_per_sec"] / single["pods_per_sec"]
    assert row["ab"]["sharding_pays"] == (row["ab"]["speedup"] >= 1.0)
    json.dumps(row, default=str)
    err = capsys.readouterr().err
    assert "shards[partitions=2 replicas=2" in err
