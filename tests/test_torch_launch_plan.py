"""The solve kernels' launch plan (``ops/solve.py::plan_launch``): which
kernel runs, on what cluster, and that the plan always covers every node
column inside one block's shared memory. Pure Python; no card needed."""

import pytest

from kubernetes_tpu_torch.ops.solve import (
    CLUSTER_THREADS,
    SMEM_LIMIT,
    block_plan,
    cluster_smem_bytes,
    plan_launch,
)

SHAPES = [  # (n, r, sc, t, u)
    (5120, 3, 1, 1, 1),       # SchedulingBasic / TopologySpreading, 5k nodes
    (5120, 3, 16, 16, 16),    # the wide constraint space at 5k nodes
    (128, 3, 1, 1, 1),
    (1024, 3, 1, 1, 1),
    (1408, 3, 2, 3, 2),       # a ragged last slice
    (5248, 3, 1, 1, 1),
    (20480, 4, 4, 4, 4),      # more columns than threads in a block
    (5120, 3, 40, 40, 40),    # past the shared-memory budget
    (65536, 3, 1, 1, 1),
]


def test_scheduling_basic_runs_the_cluster_kernel():
    plan = plan_launch(5120, 3, 1, 1, 1)
    assert plan.kernel == "cluster"
    assert (plan.cluster, plan.threads, plan.cols_per_block) == (16, 320, 320)
    assert plan.smem_bytes < SMEM_LIMIT
    # 19 rows of 320 columns held (9 state, 9 static, a score row), plus
    # the pod staging and the reduction slots
    assert 19 * 320 * 4 <= plan.smem_bytes < 48 * 1024


def test_wide_space_at_5k_nodes_runs_the_cluster_kernel():
    plan = plan_launch(5120, 3, 16, 16, 16)
    assert plan.kernel == "cluster"
    assert plan.cluster == 16 and plan.cols_per_block == 320
    assert plan.smem_bytes <= SMEM_LIMIT


def test_small_plane_is_covered():
    plan = plan_launch(128, 3, 1, 1, 1)
    assert plan.kernel == "cluster"
    assert plan.cluster * plan.cols_per_block >= 128
    assert (plan.cluster - 1) * plan.cols_per_block < 128   # no empty block
    assert plan.threads % 32 == 0 and plan.threads >= 32


@pytest.mark.parametrize("shape", [(5120, 3, 40, 40, 40),
                                   (65536, 3, 1, 1, 1)])
def test_past_the_budget_runs_the_one_block_kernel(shape):
    n, r, sc, t, u = shape
    cols = -(-n // 16 // 32) * 32
    assert cluster_smem_bytes(r, sc, t, u, -(-n // cols), CLUSTER_THREADS,
                              cols, 32) > SMEM_LIMIT
    plan = plan_launch(*shape)
    assert plan == block_plan(n, sc, t)
    assert plan.kernel == "block" and plan.cluster == 1
    assert plan.cols_per_block == n and plan.threads == 1024


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_plan_covers_every_column(shape, max_cluster):
    n, r, sc, t, u = shape
    plan = plan_launch(*shape, max_cluster=max_cluster)
    assert plan.cluster * plan.cols_per_block >= n
    assert plan.smem_bytes <= SMEM_LIMIT
    if plan.kernel == "cluster":
        assert 1 <= plan.cluster <= max_cluster
        assert plan.cols_per_block % 32 == 0
        assert (plan.cluster - 1) * plan.cols_per_block < n
        assert plan.threads == min(plan.cols_per_block, CLUSTER_THREADS)
        assert plan.smem_bytes == cluster_smem_bytes(
            r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block,
            plan.chunk)


def test_ragged_last_slice():
    plan = plan_launch(1408, 3, 1, 1, 1)
    assert plan.kernel == "cluster"
    last = 1408 - (plan.cluster - 1) * plan.cols_per_block
    assert 0 < last < plan.cols_per_block


def test_portable_cluster_halves_the_blocks_and_doubles_the_slice():
    wide = plan_launch(5120, 3, 1, 1, 1, max_cluster=16)
    portable = plan_launch(5120, 3, 1, 1, 1, max_cluster=8)
    assert portable.cluster == 8
    assert portable.cols_per_block == 2 * wide.cols_per_block
    assert portable.threads == CLUSTER_THREADS   # two columns for some threads
