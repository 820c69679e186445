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
