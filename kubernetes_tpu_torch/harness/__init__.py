"""Benchmark harness package.

Lazy exports (PEP 562): ``perf`` and the rows built on it import torch;
the REST harness's apiserver and creator children (``rest_perf``)
import only ``workloads`` and the fabric's modules, and must stay
torch-free: a child that imported torch would pay seconds of import,
and one that initialized CUDA would contend with the scheduler process
for the card.
"""

from kubernetes_tpu_torch.harness.workloads import WORKLOADS, make_workload

__all__ = ["WORKLOADS", "make_workload", "BenchmarkResult", "run_workload",
           "ThroughputCollector", "run_workload_rest"]


def __getattr__(name):
    if name in ("BenchmarkResult", "run_workload", "ThroughputCollector"):
        from kubernetes_tpu_torch.harness import perf

        return getattr(perf, name)
    if name == "run_workload_rest":
        from kubernetes_tpu_torch.harness.rest_perf import run_workload_rest

        return run_workload_rest
    raise AttributeError(name)
