"""The port's wire codec and WAL against the JAX package's.

- Every kind of the port's ``SCHEME``: objects decoded from the same
  seeded wire dicts (every field filled, nested kinds, quantities and
  label requirements included) encode to the same ``to_wire`` dict in
  both packages, and ``from_wire`` round-trips in the port.
- A WAL the JAX package wrote (a snapshot, then creates, binds, updates
  and deletes in the log) is restored by the port's ``restore_store`` to
  the same objects, resource versions and revision counter, and the
  other way round. Exact equality throughout: these are dicts.
"""

import dataclasses
import random
import typing

import pytest

from kubernetes_tpu.api import serialization as jax_wire
from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.apiserver import store as jax_store
from kubernetes_tpu.apiserver import wal as jax_wal
from kubernetes_tpu_torch.api import serialization as wire
from kubernetes_tpu_torch.api import types
from kubernetes_tpu_torch.api.labels import Requirement
from kubernetes_tpu_torch.api.resource import Quantity
from kubernetes_tpu_torch.apiserver import store
from kubernetes_tpu_torch.apiserver import wal

QUANTITIES = ("100m", "2", "1500m", "64Gi", "512Mi", "3")


def _value(hint, rng: random.Random, depth: int = 0):
    """A seeded value of the type ``hint``, as a port object."""
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return _value(args[0], rng, depth)
    if hint is Quantity:
        from kubernetes_tpu_torch.api.resource import parse_quantity

        return parse_quantity(rng.choice(QUANTITIES))
    if hint is Requirement:
        return Requirement(f"k{rng.randrange(3)}", rng.choice(
            ("In", "NotIn", "Exists")), (f"v{rng.randrange(3)}",))
    if dataclasses.is_dataclass(hint):
        hints = typing.get_type_hints(hint)
        kwargs = {}
        for f in dataclasses.fields(hint):
            kwargs[f.name] = _value(hints[f.name], rng, depth + 1)
        return hint(**kwargs)
    if origin in (list, typing.List):
        (eh,) = typing.get_args(hint) or (str,)
        return [_value(eh, rng, depth + 1) for _ in range(rng.randrange(1, 3))]
    if origin in (tuple, typing.Tuple):
        eh = (typing.get_args(hint) or (str,))[0]
        return tuple(_value(eh, rng, depth + 1) for _ in range(2))
    if origin in (dict, typing.Dict):
        _, vh = (typing.get_args(hint) + (str, str))[:2]
        return {f"key{i}": _value(vh, rng, depth + 1)
                for i in range(rng.randrange(1, 3))}
    if hint is dict:
        return {"a": f"b{rng.randrange(9)}"}
    if hint is bool:
        return True
    if hint is int:
        return rng.randrange(1, 1000)
    if hint is float:
        return float(rng.randrange(1, 1000)) / 4
    return f"s{rng.randrange(1000)}"   # str and Any


@pytest.mark.parametrize("kind", sorted(wire.SCHEME))
def test_to_wire_equals_reference_for_every_kind(kind):
    assert kind in jax_wire.SCHEME
    for seed in range(3):
        d = wire.to_wire(_value(wire.SCHEME[kind], random.Random(seed)))
        assert d["kind"] == kind
        port = wire.from_wire(d)
        ref = jax_wire.from_wire(d)
        assert type(ref).__name__ == kind
        assert wire.to_wire(port) == jax_wire.to_wire(ref) == d
        assert wire.to_wire(wire.from_wire(wire.to_wire(port))) == d


def test_scheme_is_namespaced_like_reference():
    for kind in wire.SCHEME:
        assert wire.is_namespaced(kind) == jax_wire.is_namespaced(kind)
    assert wire.CLUSTER_SCOPED <= jax_wire.CLUSTER_SCOPED


def _node(t, i):
    return t.Node.from_dict({
        "metadata": {"name": f"n{i}", "labels": {"zone": f"z{i % 2}"}},
        "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                   "pods": "20"}}})


def _pod(t, i, node=""):
    return t.Pod.from_dict({
        "metadata": {"name": f"p{i}", "uid": f"pod-uid-{i}",
                     "labels": {"app": f"a{i % 3}"}},
        "spec": {"nodeName": node, "priorityClassName": "",
                 "containers": [{"name": "c", "resources": {
                     "requests": {"cpu": "250m", "memory": "100Mi"}}}]}})


def _write(t, s, w, d, snapshot_every=10_000):
    """Initial objects, a WAL attached (its snapshot), then a log: pod
    creates, binds, a node update, a pod and a node delete, a Service.
    A small ``snapshot_every`` compacts the log while it is written."""
    for i in range(3):
        s.add_node(_node(t, i))
    s.create_pods([_pod(t, i) for i in range(4)])
    s.add_service(t.Service(metadata=t.ObjectMeta(name="svc"),
                            selector={"app": "a0"}))
    handle = w.attach_wal(s, d, snapshot_every=snapshot_every)
    s.create_pods([_pod(t, i) for i in range(4, 9)])
    s.bind_many([("default", f"p{i}", f"pod-uid-{i}", f"n{i % 3}")
                 for i in range(0, 9, 2)])
    node = _node(t, 1)
    node.metadata.labels["extra"] = "yes"
    s.update_node(node)
    s.delete_pods([("default", "p3")])
    s.delete_node("n2")
    s.create_object("Namespace", t.Namespace(
        metadata=t.ObjectMeta(name="team-a", namespace="")))
    if hasattr(handle, "drain"):
        assert handle.drain()
    handle.close()


KINDS = ("Pod", "Node", "Service", "Namespace")


def _canon(s):
    to = wire.to_wire if isinstance(s, store.ClusterStore) \
        else jax_wire.to_wire
    out = {k: sorted((to(o) for o in s.list_objects(k)),
                     key=lambda d: d["metadata"]["name"]) for k in KINDS}
    out["rv"] = s.current_rv()
    return out


@pytest.mark.parametrize("snapshot_every", [10_000, 3])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_restores_across_packages(writer, snapshot_every, tmp_path):
    d = str(tmp_path / "wal")
    if writer == "jax":
        src = jax_store.ClusterStore()
        _write(jax_types, src, jax_wal, d, snapshot_every)
        got = wal.restore_store(d)
        back = jax_wal.restore_store(d)
    else:
        src = store.ClusterStore()
        _write(types, src, wal, d, snapshot_every)
        got = jax_wal.restore_store(d)
        back = wal.restore_store(d)
    want = _canon(src)
    assert _canon(got) == want == _canon(back)
    assert len(want["Pod"]) == 8 and len(want["Node"]) == 2
    bound = {p["metadata"]["name"] for p in want["Pod"]
             if p["spec"].get("nodeName")}
    assert bound == {"p0", "p2", "p4", "p6", "p8"}
    port = got if writer == "jax" else back
    assert port.count_bound() == 5


def test_wal_resume_window_equals_reference(tmp_path):
    """``wal_events_since``: the log lines past a cursor, and whether the
    log still covers it, read alike from either package's log."""
    for t, s, w in ((jax_types, jax_store.ClusterStore(), jax_wal),
                    (types, store.ClusterStore(), wal)):
        d = str(tmp_path / t.__name__)
        _write(t, s, w, d)
        snap_rv = 18
        for cursor in (0, snap_rv, snap_rv + 3, s.current_rv()):
            assert wal.wal_events_since(d, cursor) == \
                jax_wal.wal_events_since(d, cursor)
        covered, entries = wal.wal_events_since(d, snap_rv + 3)
        assert covered and entries and all(
            e["rv"] > snap_rv + 3 for e in entries)
