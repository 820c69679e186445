"""The port's hotspot harness (``harness/hotspot.py``) against the JAX
package's:

- ``run_reshard_mini_cell``, the live 2 -> 3 partition split at 200
  hollow nodes under a writer and an informer (the JAX
  ``tests/test_reshard.py::TestReshardMiniCell``): both packages hold
  every invariant, informer equal to server truth, zero lost, no relist
  of an unmoved slice, one epoch;
- the rebalanced arm of the hotspot row over spawned partition
  apiservers and creator children: zero lost pods and watch events, no
  duplicate, no relist of an unmoved slice, and an action, when the
  rebalancer takes one, that splits the hot tenant;
- the row's diag segment is the JAX package's;
- no spawned child of the reshard, hotspot or upgrade rows imports
  torch, and the hotspot row and the reshard cells take no ``device``
  (they run no scheduler).

Tolerance: exact equality of invariants and diag text; the cells race
writers against migrations, so no placement is compared."""

import inspect
import subprocess
import sys

import pytest

INVARIANT_KEYS = ("errors", "confirmed", "server_pods", "duplicates",
                  "nodes", "informer_nodes", "informer_pods", "missing",
                  "extra", "stale", "lost_watches", "unmoved_relists",
                  "rv_regressions")


@pytest.fixture(scope="module")
def mini_cells():
    from kubernetes_tpu.harness.hotspot import (
        run_reshard_mini_cell as jax_cell,
    )
    from kubernetes_tpu_torch.harness.hotspot import run_reshard_mini_cell

    return jax_cell(), run_reshard_mini_cell()


def test_reshard_mini_cell_holds_every_invariant_as_the_reference(
        mini_cells):
    jax, port = mini_cells
    for r in (jax, port):
        assert r["errors"] == []
        assert r["lost_watches"] == 0, (r["missing"], r["extra"],
                                        r["stale"])
        assert r["informer_pods"] == r["server_pods"] == r["confirmed"] > 0
        assert r["duplicates"] == 0
        assert r["informer_nodes"] == r["nodes"] == 200
        assert r["unmoved_relists"] == 0
        assert r["rv_regressions"] == []
        assert r["moved_objects"] > 0
        assert 0 < r["frozen_ms"] < 5000
        assert r["epoch"] >= 3
        assert r["handoff_fetches"] >= 1
    # the confirmed count depends on the writer's pace; the rest does not
    keys = [k for k in INVARIANT_KEYS if k not in
            ("confirmed", "server_pods", "informer_pods")]
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["epoch"] == jax["epoch"]


def test_rebalanced_arm_over_spawned_partitions():
    from kubernetes_tpu_torch.harness.hotspot import HOT_NS, run_hotspot_arm

    arm = run_hotspot_arm(pods=6000, partitions=3, hot_share=0.8,
                          rebalance=True, rebalance_interval_s=0.3,
                          cooldown_s=1.0, wait_timeout=120.0)
    assert arm["confirmed"] == arm["server_pods_total"] == 6000
    assert sum(arm["per_partition_pods"]) == 6000
    assert arm["lost_pods"] == arm["duplicated_pods"] == 0
    assert arm["informer_pods"] == 6000 and arm["lost_watches"] == 0
    assert arm["unmoved_relists"] == 0 and arm["rv_regressions"] == 0
    assert arm["rebalancer_actions"] in (
        [], [{"op": "split", "namespace": HOT_NS}])
    assert arm["epoch"] == 1 + len(arm["migrations"])


def test_reshard_diag_is_the_reference_text(capsys):
    from kubernetes_tpu.harness import hotspot as jax_hotspot
    from kubernetes_tpu_torch.harness import hotspot

    arm = {"migrations": [{"frozen_ms": 12.5}], "epoch": 2}
    inv = {"lost_watches": 0}
    jax_hotspot._reshard_diag(arm, 12.5, inv)
    jax_err = capsys.readouterr().err
    hotspot._reshard_diag(arm, 12.5, inv)
    assert capsys.readouterr().err == jax_err
    assert "reshard[moves=1 frozen_ms=12.5 epoch=2 lost_watches=0]" in jax_err


def test_the_rows_without_a_scheduler_take_no_device():
    from kubernetes_tpu_torch.harness import chaos_reshard, hotspot

    for fn in (hotspot.run_hotspot_arm, hotspot.run_hotspot_row,
               hotspot.run_reshard_mini_cell,
               chaos_reshard.run_chaos_reshard):
        assert "device" not in inspect.signature(fn).parameters


def test_children_import_no_torch():
    """What each spawned child of the elastic rows imports, in a fresh
    interpreter: the modules a spawn re-imports (the child's own module)
    and those its main imports."""
    code = (
        "import sys\n"
        "import kubernetes_tpu_torch.harness.chaos_reshard\n"
        "import kubernetes_tpu_torch.harness.hotspot\n"
        "import kubernetes_tpu_torch.harness.upgrade\n"
        "from kubernetes_tpu_torch.apiserver import codec\n"
        "from kubernetes_tpu_torch.apiserver.rbac import "
        "provision_bootstrap_policy\n"
        "from kubernetes_tpu_torch.apiserver.rest import APIServer\n"
        "from kubernetes_tpu_torch.apiserver.store import ClusterStore\n"
        "from kubernetes_tpu_torch.apiserver.wal import attach_wal, "
        "restore_store\n"
        "from kubernetes_tpu_torch.client.restcluster import "
        "RestClusterClient\n"
        "from kubernetes_tpu_torch.utils.gctune import tune_for_throughput\n"
        "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]
