"""The overload chaos cell in the port (``harness/chaos_overload.py``)
against the JAX package's: the seeded fault spec and profiles equal,
and the bulk-abuse cell at the reference test's size holds every
invariant with the same invariant keys and request stats' shape as the
JAX cell. Tolerance: exact equality of the spec, the profiles and the
invariant verdicts; the request counts are timing-dependent and are
held only as present and positive."""

import pytest

from kubernetes_tpu.apiserver.faults import FaultRule as JaxFaultRule
from kubernetes_tpu.harness import chaos_overload as jax_overload
from kubernetes_tpu_torch.apiserver.faults import FaultRule
from kubernetes_tpu_torch.harness import chaos_overload


@pytest.mark.parametrize("seed", [11, 23])
def test_fault_spec_matches_reference(seed):
    spec = chaos_overload.overload_fault_spec(seed)
    assert spec == jax_overload.overload_fault_spec(seed)
    for rule in spec["rules"]:
        FaultRule.from_dict(rule)      # both packages parse it
        JaxFaultRule.from_dict(rule)


def test_profiles_match_reference():
    assert chaos_overload.OVERLOAD_PROFILES == jax_overload.OVERLOAD_PROFILES


@pytest.mark.chaos
def test_bulkabuse_cell_matches_reference():
    kw = dict(seed=11, nodes=6, pods=24, tenants=2, waves=2,
              overload_profile="bulkabuse", wait_timeout=60.0)
    got = chaos_overload.run_chaos_overload(**kw)
    want = jax_overload.run_chaos_overload(**kw)
    assert want["ok"], want
    assert got["ok"], (got["invariants"], got["failure"], got["stats"])
    assert got["invariants"] == want["invariants"]
    assert got["invariants"]["bulk_width_proportional"]
    assert set(got["stats"]) == set(want["stats"])
    assert got["stats"]["aggressor_requests"] > 0
    assert got["stats"]["faults_injected"] > 0
    assert got["stats"]["exempt_probes"] > 0
    assert got["stats"]["workload_capacity"] \
        == want["stats"]["workload_capacity"]
