"""The port's component configuration against the JAX package's: feature
gates, the providers' wiring, ``KubeSchedulerConfiguration.from_dict``
and ``validate``, the legacy Policy translation (``policy_to_config``,
``load_policy``) and the frameworks ``Scheduler.create`` builds from
them. The inputs are the JAX package's own cases (``tests/
test_config.py``) and seeded random Policies and v1beta1 dicts (numpy
draws): the same profiles, plugin lists, weights, plugin args and error
messages. Tolerance: exact equality."""

import dataclasses
import json

import numpy as np
import pytest

from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config import policy as jax_policy
from kubernetes_tpu.config.feature_gates import FeatureGates as JaxGates
from kubernetes_tpu.config.types import (
    KubeSchedulerConfiguration as JaxConfig,
)
from kubernetes_tpu.scheduler import provider as jax_provider
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config import policy
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
from kubernetes_tpu_torch.scheduler import provider
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

# the JAX package's own cases (tests/test_config.py), as inputs
REFERENCE_POLICIES = (
    {"kind": "Policy", "apiVersion": "v1",
     "predicates": [{"name": "PodFitsResources"},
                    {"name": "PodFitsHostPorts"},
                    {"name": "MatchNodeSelector"}],
     "priorities": [{"name": "LeastRequestedPriority", "weight": 2},
                    {"name": "BalancedResourceAllocation", "weight": 1}]},
    {"predicates": [{"name": "PodFitsResources"}],
     "priorities": [{"name": "LeastRequestedPriority", "weight": 5}]},
    {},
    {"predicates": [{"name": "PodFitsResources"}],
     "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]},
    {"predicates": [{"name": "NoSuchPredicate"}]},
    {"hardPodAffinitySymmetricWeight": 1000},
    {"priorities": [{"name": "SelectorSpreadPriority", "weight": 2},
                    {"name": "ServiceSpreadingPriority", "weight": 3}]},
    {"priorities": [{"name": "LeastRequestedPriority", "weight": 0}]},
)
REFERENCE_DICTS = (
    {"profiles": [{"schedulerName": "default-scheduler",
                   "plugins": {"score": {"enabled": [
                       {"name": "NodeResourcesLeastAllocated",
                        "weight": 500}]}}}]},
    {"extenders": [{"urlPrefix": "http://a", "bindVerb": "bind"},
                   {"urlPrefix": "http://b", "bindVerb": "bind"}]},
    {"extenders": [{"bindVerb": "bind"}]},
)


def as_dict(obj):
    """A configuration of either package as plain data."""
    return json.loads(json.dumps(dataclasses.asdict(obj), default=str))


def translate(mod, doc):
    """(the configuration as data, None) or (None, the error message)."""
    try:
        return as_dict(mod.policy_to_config(doc)), None
    except mod.PolicyError as err:
        return None, str(err)


def random_policy(rng):
    """A seeded Policy: known and unknown names, nil lists, weights in and
    out of range, the symmetric weight, an extender."""
    doc = {}
    if rng.random() < 0.1:
        doc["kind"] = str(rng.choice(["Policy", "Config"]))
    preds = list(jax_policy.PREDICATE_MAP) + ["NoSuchPredicate"]
    prios = list(jax_policy.PRIORITY_MAP) + ["NoSuchPriority"]
    if rng.random() < 0.85:
        k = int(rng.integers(0, 6))
        names = rng.choice(preds[:-1] if rng.random() < 0.9 else preds,
                           size=k)
        doc["predicates"] = [{"name": str(n)} for n in names]
    if rng.random() < 0.85:
        entries = []
        for _ in range(int(rng.integers(0, 6))):
            e = {"name": str(rng.choice(prios[:-1] if rng.random() < 0.95
                                        else prios))}
            r = rng.random()
            if r < 0.7:
                e["weight"] = int(rng.integers(1, 20))
            elif r < 0.8:
                e["weight"] = int(rng.choice([0, -3]))
            entries.append(e)
        doc["priorities"] = entries
    if rng.random() < 0.3:
        doc["hardPodAffinitySymmetricWeight"] = int(rng.choice(
            [0, 1, 50, 100, 101, -1]))
    if rng.random() < 0.2:
        doc["extenders"] = [{"urlPrefix": "http://127.0.0.1:1",
                             "filterVerb": "filter", "weight": 2,
                             "managedResources": [{"name": "ex.com/r"}]}]
    return doc


def random_component_dict(rng):
    """A seeded v1beta1 dict: profiles with enabled and disabled sets,
    weights in and out of [0, 100], plugin args, extenders, and scalar
    fields in and out of range."""
    d = {}
    if rng.random() < 0.7:
        d["parallelism"] = int(rng.choice([1, 4, 16, 0, -2]))
    if rng.random() < 0.5:
        d["percentageOfNodesToScore"] = int(rng.choice([0, 30, 100, 101]))
    if rng.random() < 0.4:
        d["podInitialBackoffSeconds"] = float(rng.choice([0.5, 1, 0]))
        d["podMaxBackoffSeconds"] = float(rng.choice([0.2, 5, 10]))
    if rng.random() < 0.3:
        d["featureGates"] = {"TPUBatchScheduler": bool(rng.random() < 0.5)}
    profiles = []
    for i in range(int(rng.integers(0, 3))):
        p = {"schedulerName": str(rng.choice(
            ["default-scheduler", f"p{i}", ""]))}
        if rng.random() < 0.7:
            score = {"enabled": [{"name": str(rng.choice(
                ["NodeResourcesMostAllocated", "ImageLocality", ""])),
                "weight": int(rng.choice([1, 3, 100, 101, 0]))}]}
            if rng.random() < 0.5:
                score["disabled"] = [{"name": str(rng.choice(
                    ["NodeResourcesLeastAllocated", "*"]))}]
            p["plugins"] = {"score": score}
            if rng.random() < 0.3:
                p["plugins"]["filter"] = {"disabled": [{"name": "*"}],
                                          "enabled": [{"name": "NodeName"}]}
        if rng.random() < 0.4:
            p["pluginConfig"] = [{"name": "NodeLabel", "args": {
                "presentLabels": ["a"], "absentLabelsPreference": ["b"]}}]
        profiles.append(p)
    if profiles:
        d["profiles"] = profiles
    if rng.random() < 0.4:
        d["extenders"] = [
            {"urlPrefix": str(rng.choice(["http://a", ""])),
             "filterVerb": "filter",
             "bindVerb": str(rng.choice(["", "bind"])),
             "weight": int(rng.choice([1, 2, 0])),
             "httpTimeout": float(rng.choice([0.5, 30])),
             "ignorable": bool(rng.random() < 0.5),
             "managedResources": [{"name": "ex.com/r"}]}
            for _ in range(int(rng.integers(1, 3)))]
    return d


@pytest.mark.parametrize("i", range(len(REFERENCE_POLICIES)))
def test_reference_policy_cases_translate_alike(i):
    doc = REFERENCE_POLICIES[i]
    assert translate(policy, doc) == translate(jax_policy, doc)


@pytest.mark.parametrize("seed", range(8))
def test_random_policies_translate_alike(seed):
    rng = np.random.default_rng(seed)
    errors = 0
    for _ in range(60):
        doc = random_policy(rng)
        got, want = translate(policy, doc), translate(jax_policy, doc)
        assert got == want, doc
        errors += want[0] is None
    assert 0 < errors < 60


def test_load_policy_errors_and_text_alike():
    for text in ("{not json", json.dumps(REFERENCE_POLICIES[0]), "[]x"):
        got = want = None
        try:
            got = as_dict(policy.load_policy(text))
        except policy.PolicyError as err:
            got = str(err)
        try:
            want = as_dict(jax_policy.load_policy(text))
        except jax_policy.PolicyError as err:
            want = str(err)
        assert got == want


def test_policy_maps_equal_the_reference():
    assert policy.PREDICATE_MAP == jax_policy.PREDICATE_MAP
    assert policy.PRIORITY_MAP == jax_policy.PRIORITY_MAP
    assert policy._DEFAULT_PREDICATES == jax_policy._DEFAULT_PREDICATES
    assert policy._DEFAULT_PRIORITIES == jax_policy._DEFAULT_PRIORITIES


@pytest.mark.parametrize("i", range(len(REFERENCE_DICTS)))
def test_reference_component_dicts_alike(i):
    d = REFERENCE_DICTS[i]
    got, want = KubeSchedulerConfiguration.from_dict(d), JaxConfig.from_dict(d)
    assert as_dict(got) == as_dict(want)
    assert got.validate() == want.validate() != []


@pytest.mark.parametrize("seed", range(8))
def test_random_component_dicts_alike(seed):
    rng = np.random.default_rng(100 + seed)
    invalid = 0
    for _ in range(60):
        d = random_component_dict(rng)
        got = KubeSchedulerConfiguration.from_dict(d)
        want = JaxConfig.from_dict(d)
        assert as_dict(got) == as_dict(want), d
        assert got.validate() == want.validate(), d
        invalid += bool(want.validate())
    assert 0 < invalid < 60


def test_feature_gates_alike():
    for s in ("", "TPUBatchScheduler", "PreferNominatedNode=true,"
              "DefaultPodTopologySpread=1,PodOverhead=false", " A = x , B"):
        got, want = FeatureGates.from_string(s), JaxGates.from_string(s)
        assert got._gates == want._gates
    assert FeatureGates()._gates == JaxGates()._gates


@pytest.mark.parametrize("gates", ({}, {"DefaultPodTopologySpread": True}))
@pytest.mark.parametrize("name", sorted(jax_provider.PROVIDERS))
def test_providers_alike(name, gates):
    got = provider.PROVIDERS[name](FeatureGates(gates))
    want = jax_provider.PROVIDERS[name](JaxGates(gates))
    assert as_dict(got) == as_dict(want)
    assert as_dict(provider.PROVIDERS[name]()) == \
        as_dict(jax_provider.PROVIDERS[name]())


def _frameworks(sched):
    return {name: (f.list_plugins(), sorted(f.score_plugin_weight.items()))
            for name, f in sched.profiles.items()}


def _create_both(doc, provider_name="DefaultProvider"):
    """Both packages' ``Scheduler.create`` on one configuration (a Policy
    dict, or a v1beta1 dict): their frameworks, or their messages."""
    out = []
    for mod, cfg_cls, sched_cls, store_cls, pol in (
            ("port", KubeSchedulerConfiguration, Scheduler, ClusterStore,
             policy),
            ("jax", JaxConfig, JaxScheduler, JaxStore, jax_policy)):
        cfg = (pol.policy_to_config(doc["policy"]) if "policy" in doc
               else cfg_cls.from_dict(doc))
        try:
            sched = sched_cls.create(store_cls(), config=cfg,
                                     provider=provider_name)
        except ValueError as err:
            out.append(str(err))
            continue
        out.append(_frameworks(sched))
    return out


@pytest.mark.parametrize("i", [
    i for i, doc in enumerate(REFERENCE_POLICIES)
    if translate(jax_policy, doc)[0] is not None])
def test_create_from_reference_policies_alike(i):
    doc = REFERENCE_POLICIES[i]
    got, want = _create_both({"policy": doc})
    assert got == want


def test_create_from_legacy_plugin_policy_alike():
    doc = {"predicates": [{"name": "CheckNodeLabelPresence"},
                          {"name": "TestServiceAffinity"},
                          {"name": "PodFitsResources"}],
           "priorities": [{"name": "RequestedToCapacityRatioPriority",
                           "weight": 3},
                          {"name": "MostRequestedPriority", "weight": 2}],
           "hardPodAffinitySymmetricWeight": 10}
    got, want = _create_both({"policy": doc})
    assert got == want
    assert "NodeLabel" in got["default-scheduler"][0]["filter"]


@pytest.mark.parametrize("provider_name", sorted(jax_provider.PROVIDERS))
def test_create_from_profiles_alike(provider_name):
    doc = {"parallelism": 4, "profiles": [
        {"schedulerName": "default-scheduler"},
        {"schedulerName": "packing", "plugins": {"score": {
            "disabled": [{"name": "NodeResourcesLeastAllocated"}],
            "enabled": [{"name": "NodeResourcesMostAllocated",
                         "weight": 1}]}}},
        {"schedulerName": "bare", "plugins": {
            "filter": {"disabled": [{"name": "*"}],
                       "enabled": [{"name": "NodeResourcesFit"}]},
            "score": {"disabled": [{"name": "*"}]}}}]}
    got, want = _create_both(doc, provider_name)
    assert got == want
    assert set(got) == {"default-scheduler", "packing", "bare"}


def test_create_errors_alike():
    for doc in ({"parallelism": 0},
                {"profiles": [{"schedulerName": "a"},
                              {"schedulerName": "a"}]},
                {"profiles": [
                    {"schedulerName": "a"},
                    {"schedulerName": "b", "plugins": {"queueSort": {
                        "disabled": [{"name": "*"}],
                        "enabled": [{"name": "CoschedulingSort"}]}}}]},
                {"profiles": [{"schedulerName": "a", "plugins": {
                    "filter": {"enabled": [{"name": "NoSuchPlugin"}]}}}]}):
        got, want = _create_both(doc)
        assert isinstance(want, str) and got == want, doc


def test_short_configuration_is_one_worker_one_profile():
    """``Scheduler(store)``: the one-profile shorthand stays what it was."""
    sched = Scheduler(ClusterStore())
    assert list(sched.profiles) == ["default-scheduler"]
    assert sched.parallelizer.parallelism == 1
    assert sched.extenders == []
    assert not sched.feature_gates.enabled("TPUBatchScheduler")
    assert sched.framework is sched.profiles["default-scheduler"]
    assert Scheduler.create(ClusterStore()).parallelizer.parallelism == 16
