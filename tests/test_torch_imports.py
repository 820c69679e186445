"""The PyTorch port stands alone: no module of kubernetes_tpu_torch, nor
chip_smoke.py or tools/torch_ab.py, imports JAX or the kubernetes_tpu package, and its entry
points refuse to run without a CUDA card unless asked for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.harness import perf, workloads

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")


def _port_sources():
    files = sorted((REPO / "kubernetes_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "tools" / "torch_ab.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_requires_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_run_workload_without_device_raises(no_cuda):
    ops = workloads.scheduling_basic(2, 0, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf.run_workload("SchedulingBasic", ops)


def test_run_workload_on_cpu_binds_everything():
    res = perf.run_workload("SchedulingBasic",
                            workloads.scheduling_basic(3, 2, 10),
                            device="cpu", max_batch=8)
    assert res.device == "cpu"
    assert res.total_pods == 12
    assert all(res.placements.values())
    assert res.solves > 0


SLICE_8_MODULES = (
    "utils/trace.py", "metrics/__init__.py", "metrics/registry.py",
    "metrics/scheduler_metrics.py", "metrics/solver_metrics.py",
    "metrics/freshness_metrics.py", "observability/__init__.py",
    "observability/tracer.py", "observability/devprof.py",
    "observability/slo.py", "observability/fleettrace.py",
    "client/__init__.py", "client/events.py")


@pytest.mark.parametrize("rel", SLICE_8_MODULES)
def test_observability_modules_are_checked_and_import(rel):
    """The observability, metrics and event modules are among the sources
    the import rule checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module.removesuffix(".__init__"))


SLICE_9_MODULES = (
    "ops/build.py", "ops/solver.py", "client/workqueue.py",
    "client/informers.py", "controllers/__init__.py", "controllers/base.py",
    "metrics/autoscaler_metrics.py", "autoscaler/__init__.py",
    "autoscaler/nodegroups.py", "autoscaler/simulator.py",
    "autoscaler/controller.py", "harness/burst.py", "harness/elastic.py",
    "scheduler/framework/plugins/mesh_locality.py")


@pytest.mark.parametrize("rel", SLICE_9_MODULES)
def test_autoscaler_modules_are_checked_and_import(rel):
    """The what-if path's modules are among the sources the import rule
    checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module.removesuffix(".__init__"))


def _whatif_entry_points():
    """Each what-if entry point, called without a device."""
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.autoscaler.controller import ClusterAutoscaler
    from kubernetes_tpu_torch.autoscaler.nodegroups import NodeGroup
    from kubernetes_tpu_torch.autoscaler.simulator import (
        plan_scale_up,
        run_whatif,
    )
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory
    from kubernetes_tpu_torch.harness.burst import make_burst_pods
    from kubernetes_tpu_torch.harness.elastic import run_autoscale_bench
    from kubernetes_tpu_torch.harness.problems import whatif_problem
    from kubernetes_tpu_torch.ops import solver

    group = NodeGroup("ng", cpu="4")
    nodes = [group.node_template(0)]
    pods = make_burst_pods(3)
    cluster, batch, pen, dis = whatif_problem(0, n_nodes=4, n_bound=2,
                                              n_pods=4, n_upcoming=1,
                                              n_virtual=1, n_disabled=1,
                                              pad=8)
    store = ClusterStore()
    return {
        "solve_scan": lambda: solver.solve_scan(cluster, batch),
        "solve_whatif": lambda: solver.solve_whatif(
            cluster, batch, deprioritized_cols=pen, disabled_cols=dis),
        "run_whatif": lambda: run_whatif(nodes, [], pods),
        "plan_scale_up": lambda: plan_scale_up(nodes, [], pods,
                                               [(group, 2)]),
        "ClusterAutoscaler": lambda: ClusterAutoscaler(
            store, SharedInformerFactory(store)),
        "run_autoscale_bench": lambda: run_autoscale_bench(burst=4),
    }


@pytest.mark.parametrize("name", ("solve_scan", "solve_whatif",
                                  "run_whatif", "plan_scale_up",
                                  "ClusterAutoscaler", "run_autoscale_bench"))
def test_whatif_entry_points_without_device_raise(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _whatif_entry_points()[name]()


SLICE_11_MODULES = (
    "federation/__init__.py", "federation/ledger.py",
    "federation/scheduler.py", "federation/client.py",
    "federation/rebalancer.py", "autoscaler/partitions.py",
    "harness/federation.py", "workloads/trace.py", "workloads/replay.py")


@pytest.mark.parametrize("rel", SLICE_11_MODULES)
def test_federation_modules_are_checked_and_import(rel):
    """The federation tier's modules are among the sources the import rule
    checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module.removesuffix(".__init__"))


def _federation_entry_points():
    """Each federation entry point, called without a device."""
    from kubernetes_tpu_torch.federation import (
        CapacityLedger,
        FederationScheduler,
    )
    from kubernetes_tpu_torch.harness.federation import (
        run_degradation_differential,
        run_federation_mini_cell,
    )

    return {
        "FederationScheduler": lambda: FederationScheduler(CapacityLedger()),
        "run_federation_mini_cell": lambda: run_federation_mini_cell(
            pods=8),
        "run_degradation_differential": lambda: run_degradation_differential(
            pods=8),
    }


@pytest.mark.parametrize("name", ("FederationScheduler",
                                  "run_federation_mini_cell",
                                  "run_degradation_differential"))
def test_federation_entry_points_without_device_raise(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _federation_entry_points()[name]()


SLICE_15_MODULES = (
    "api/serialization.py", "api/scheme.py", "apiserver/codec.py",
    "apiserver/faults.py", "apiserver/flowcontrol.py",
    "apiserver/admission.py", "apiserver/rbac.py", "apiserver/wal.py",
    "apiserver/watchcache.py", "apiserver/rest.py", "client/backoff.py",
    "client/restcluster.py", "metrics/apf_metrics.py",
    "metrics/fabric_metrics.py", "metrics/federation.py",
    "harness/rest_perf.py", "harness/__init__.py")

# what the REST harness's spawned apiserver and creator children import
CHILD_MODULES = (
    "kubernetes_tpu_torch.harness.rest_perf",
    "kubernetes_tpu_torch.apiserver.rbac",
    "kubernetes_tpu_torch.apiserver.rest",
    "kubernetes_tpu_torch.apiserver.store",
    "kubernetes_tpu_torch.apiserver.wal",
    "kubernetes_tpu_torch.api.types",
    "kubernetes_tpu_torch.client.restcluster",
    "kubernetes_tpu_torch.harness.burst",
    "kubernetes_tpu_torch.scheduler.types",
    "kubernetes_tpu_torch.utils.gctune")


@pytest.mark.parametrize("rel", SLICE_15_MODULES)
def test_fabric_modules_are_checked_and_import(rel):
    """The REST fabric's modules are among the sources the import rule
    checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module.removesuffix(".__init__"))


def test_rest_children_import_no_torch():
    """The REST harness's spawned children (``rest_perf._apiserver_main``,
    ``_creator_main``) import nothing that imports torch or numpy."""
    import subprocess
    import sys

    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in CHILD_MODULES)
            + "from kubernetes_tpu_torch.harness import make_workload\n"
            "make_workload('SchedulingBasic', 2, 0, 4)\n"
            "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_run_workload_rest_without_device_raises(no_cuda):
    from kubernetes_tpu_torch.harness import run_workload_rest

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_workload_rest("SchedulingBasic", nodes=2, measure_pods=4)


SLICE_16_MODULES = (
    "harness/qos.py", "harness/chaos_overload.py", "harness/diagfmt.py",
    "testing/__init__.py", "testing/wrappers.py", "testing/fake_plugins.py",
    "workloads/__init__.py", "workloads/scenarios.py",
    "workloads/replay_bench.py", "observability/slo.py")

# what the noisy-tenant aggressors and the replay apiserver child import
SLICE_16_CHILD_MODULES = (
    "kubernetes_tpu_torch.harness.qos",
    "kubernetes_tpu_torch.workloads.replay_bench",
    "kubernetes_tpu_torch.workloads.scenarios",
    "kubernetes_tpu_torch.apiserver.rbac",
    "kubernetes_tpu_torch.apiserver.rest",
    "kubernetes_tpu_torch.apiserver.store",
    "kubernetes_tpu_torch.apiserver.wal",
    "kubernetes_tpu_torch.harness.rest_perf",
    "kubernetes_tpu_torch.utils.gctune")


@pytest.mark.parametrize("rel", SLICE_16_MODULES)
def test_qos_and_replay_modules_are_checked_and_import(rel):
    """The qos and replay rows' modules are among the sources the import
    rule checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module.removesuffix(".__init__"))


def test_qos_and_replay_children_import_no_torch():
    """The aggressor processes (``qos._aggressor_main``) and the replay
    apiserver child (``replay_bench._apiserver_main``) import nothing
    that imports torch or numpy."""
    import subprocess
    import sys

    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_16_CHILD_MODULES)
            + "from kubernetes_tpu_torch.workloads import build_family\n"
            "build_family('tenancy', 11, 0.15)\n"
            "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def _qos_and_replay_entry_points():
    """Each qos and replay entry point, called without a device."""
    from kubernetes_tpu_torch.harness.qos import run_noisy_tenant_qos
    from kubernetes_tpu_torch.workloads import (
        run_replay_cell,
        run_replay_once,
        run_replay_row,
    )

    return {
        "run_noisy_tenant_qos": lambda: run_noisy_tenant_qos(2, 4),
        "run_replay_once": lambda: run_replay_once("storm", scale=0.05),
        "run_replay_row": lambda: run_replay_row("gangs", scale=0.05),
        "run_replay_cell": lambda: run_replay_cell(11, pods=10),
    }


@pytest.mark.parametrize("name", ("run_noisy_tenant_qos", "run_replay_once",
                                  "run_replay_row", "run_replay_cell"))
def test_qos_and_replay_entry_points_without_device_raise(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _qos_and_replay_entry_points()[name]()


SLICE_19_MODULES = (
    "apiserver/readtier.py", "harness/watchherd.py", "harness/federation.py",
    "metrics/freshness_metrics.py")

# what the watch herd's spawned owner, replica and herd children import
SLICE_19_CHILD_MODULES = (
    "kubernetes_tpu_torch.harness.watchherd",
    "kubernetes_tpu_torch.apiserver.readtier",
    "kubernetes_tpu_torch.apiserver.rest",
    "kubernetes_tpu_torch.apiserver.store",
    "kubernetes_tpu_torch.apiserver.wal",
    "kubernetes_tpu_torch.apiserver.partition",
    "kubernetes_tpu_torch.metrics.freshness_metrics",
    "kubernetes_tpu_torch.utils.gctune")


@pytest.mark.parametrize("rel", SLICE_19_MODULES)
def test_read_tier_and_storm_modules_are_checked_and_import(rel):
    """The read tier's and the REST federation storm's modules are among
    the sources the import rule checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module)


def test_watch_herd_children_import_no_torch():
    """The watch herd's spawned children (``watchherd._owner_main``,
    ``_replica_main``, ``_herd_main``) import nothing that imports torch
    or numpy."""
    import subprocess
    import sys

    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_19_CHILD_MODULES)
            + "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


@pytest.mark.parametrize("name", ("run_federation_storm",
                                  "run_federation_row",
                                  "run_chaos_federation"))
def test_federation_storm_entry_points_without_device_raise(no_cuda, name):
    """The storm resolves its device before it spawns a cell."""
    from kubernetes_tpu_torch.harness import federation

    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(federation, name)(**({"seed": 18}
                                     if name == "run_chaos_federation"
                                     else {}))


SLICE_20_MODULES = (
    "harness/chaos_rest.py", "harness/chaos_mirror.py",
    "harness/chaos_nodes.py", "controllers/nodelifecycle.py",
    "controllers/podgc.py")

# what the chaos apiserver child (``chaos_rest._apiserver_main``) imports
SLICE_20_CHILD_MODULES = (
    "kubernetes_tpu_torch.harness.chaos_rest",
    "kubernetes_tpu_torch.harness.rest_perf",
    "kubernetes_tpu_torch.apiserver.rest",
    "kubernetes_tpu_torch.apiserver.store",
    "kubernetes_tpu_torch.apiserver.wal")


@pytest.mark.parametrize("rel", SLICE_20_MODULES)
def test_chaos_ring_modules_are_checked_and_import(rel):
    """The chaos ring's harnesses and the two controllers are among the
    sources the import rule checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module)


SLICE_22_MODULES = tuple(f"controllers/{name}.py" for name in (
    "replicaset", "statefulset", "endpoints", "namespace", "serviceaccount",
    "serviceaccounttoken", "bootstraptoken", "clusterroleaggregation",
    "resourcequota", "nodeipam", "nodettl", "volume", "volumeexpand",
    "attachdetach", "ephemeralvolume"))


@pytest.mark.parametrize("rel", SLICE_22_MODULES)
def test_stored_kind_controllers_are_checked_and_import(rel):
    """The controllers of the kinds the port's store holds are among the
    sources the import rule checks, and import on their own."""
    import importlib

    path = REPO / "kubernetes_tpu_torch" / rel
    assert path in _port_sources()
    module = "kubernetes_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module)


def test_chaos_apiserver_child_imports_no_torch():
    """The chaos apiserver child imports nothing that imports torch or
    numpy."""
    import subprocess
    import sys

    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_20_CHILD_MODULES)
            + "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


@pytest.mark.parametrize("name", ("run_chaos_mirror", "run_mirror_ab",
                                  "run_chaos_nodes"))
def test_chaos_ring_entry_points_without_device_raise(no_cuda, name):
    """The entry points that run a batch path resolve their device before
    they build anything."""
    from kubernetes_tpu_torch.harness import chaos_mirror, chaos_nodes

    calls = {
        "run_chaos_mirror": lambda: chaos_mirror.run_chaos_mirror(
            11, scenario="node_kill"),
        "run_mirror_ab": lambda: chaos_mirror.run_mirror_ab(),
        "run_chaos_nodes": lambda: chaos_nodes.run_chaos_nodes(3),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()


def test_chaos_rest_touches_no_device(no_cuda):
    """``run_chaos_rest``'s scheduler is serial: the cell runs whole with
    no card to be had."""
    from kubernetes_tpu_torch.harness import chaos_rest

    res = chaos_rest.run_chaos_rest(23, nodes=2, pods=8, waves=2,
                                    kill_at_wave=0, wait_timeout=60.0)
    assert res["ok"], res
