"""The elastic row on the CPU: ``run_autoscale_bench(device="cpu")``
starts the cluster at a fifth of the nodes a 200-pod burst needs, and
the cluster autoscaler's what-ifs (the plain scan) buy the rest while
the batch loop binds: every pod bound within ``needed + 2`` nodes, as
the JAX package's row on the same sizes."""

from kubernetes_tpu.harness.elastic import (
    run_autoscale_bench as jax_run_autoscale_bench,
)
from kubernetes_tpu_torch.harness.elastic import (
    run_autoscale_bench,
    run_scale_cell,
)


def test_autoscale_row_binds_every_pod_within_the_cap():
    row = run_autoscale_bench(burst=200, node_cpu=8, boot_latency=0.0,
                              max_batch=128, wait_timeout=120, device="cpu")
    assert row["bound"] == 200 and "error" not in row
    assert row["nodes_start"] == 3 and row["needed"] == 13
    assert row["nodes_start"] < row["nodes_end"] <= row["needed"] + 2
    assert row["whatif_solves"] >= 1 and row["scaleup_decisions"] >= 1
    assert row["nodes_provisioned"] == row["nodes_end"] - row["nodes_start"]
    assert row["batch_solves"] >= 2 and row["device"] == "cpu"
    ref = jax_run_autoscale_bench(burst=200, node_cpu=8, boot_latency=0.0,
                                  max_batch=128, wait_timeout=120)
    assert ref["bound"] == 200
    assert (ref["nodes_start"], ref["nodes_end"]) == (
        row["nodes_start"], row["nodes_end"])


def test_scale_cell_with_a_boot_latency():
    cell = run_scale_cell(burst=120, boot_latency=0.2, repeats=1,
                          wait_timeout=60, node_cpu=8, max_batch=64,
                          device="cpu")
    assert cell["ok"] and cell["stats"]["scaleup_decisions"] >= 1
    assert cell["stats"]["time_to_capacity_p99_s"] >= 0.2
