"""The solve kernels' launch plan (``ops/solve.py::plan_launch``): which
kernel runs, on what cluster, and that the plan always covers every node
column inside one block's shared memory. Pure Python; no card needed."""

import numpy as np
import pytest

from kubernetes_tpu_torch.ops.slots import SPARSE_K, slot_stream
from kubernetes_tpu_torch.ops.solve import (
    CLUSTER_THREADS,
    SMEM_LIMIT,
    block_plan,
    cluster_candidate,
    cluster_smem_bytes,
    plan_launch,
    slots_smem_bytes,
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


@pytest.mark.parametrize("t", [50, 100])
def test_wide_terms_at_5k_nodes_run_the_slot_kernel(t):
    """SchedulingPodAffinity and SchedulingPreferredPodAffinity (T = 50),
    SchedulingPodAntiAffinity and SchedulingPreferredPodAntiAffinity
    (T = 100) at 5,000 nodes: past the dense cluster layout, so a batch
    that packs runs the slot kernel on the same cut of the node axis."""
    dense = cluster_candidate(5120, 3, 1, t, 1)
    assert dense.smem_bytes > SMEM_LIMIT
    plan = plan_launch(5120, 3, 1, t, 1, packs=True)
    assert plan.kernel == "slots"
    assert (plan.cluster, plan.threads, plan.cols_per_block, plan.chunk) \
        == (dense.cluster, dense.threads, dense.cols_per_block, dense.chunk)
    assert plan.smem_bytes == slots_smem_bytes(3, 1, t, 1, 16, 320, 320, 32)
    assert plan.smem_bytes <= SMEM_LIMIT
    # 16 rows of 320 columns held (7 state, 8 static, a score row) and
    # slot-sized pod chunks: about 35 KB, one word a term more for the
    # totals
    assert 16 * 320 * 4 < plan.smem_bytes < 36 * 1024
    assert plan.smem_bytes - slots_smem_bytes(3, 1, 0, 1, 16, 320, 320,
                                              32) == 4 * t


def test_a_pod_of_nine_references_runs_the_one_block_kernel():
    r, sc, t = 3, 1, 100
    ints = np.zeros((4, r + 4 + 2 * sc + 3 * t), dtype=np.int32)
    floats = np.zeros((4, t), dtype=np.float32)
    ints[0, r + 4 + 2 * sc:r + 4 + 2 * sc + SPARSE_K] = 1
    assert slot_stream(ints, floats, r, sc, t) is not None
    floats[0, 50] = 2.0           # a ninth reference
    assert slot_stream(ints, floats, r, sc, t) is None
    plan = plan_launch(5120, r, sc, t, 1, packs=False)
    assert plan == block_plan(5120, sc, t)


@pytest.mark.parametrize("shape", [(5120, 3, 1, 12, 1), (5120, 3, 1, 38, 1),
                                   (256, 3, 1, 100, 1)])
def test_the_cluster_kernel_wins_when_its_dense_layout_fits(shape):
    plan = plan_launch(*shape, packs=True)
    assert plan.kernel == "cluster"
    assert plan == plan_launch(*shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_packed_plan_covers_every_column(shape):
    n, r, sc, t, u = shape
    plan = plan_launch(*shape, packs=True)
    assert plan.cluster * plan.cols_per_block >= n
    assert plan.smem_bytes <= SMEM_LIMIT
    if plan.kernel == "slots":
        assert plan.smem_bytes == slots_smem_bytes(
            r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block,
            plan.chunk)
        assert plan_launch(*shape).kernel == "block"
