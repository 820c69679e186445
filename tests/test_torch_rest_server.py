"""The port's apiserver against the JAX package's, request by request.

Both servers run on loopback over their own store, with the RBAC
bootstrap policy, the same bearer tokens and the legacy max-in-flight
lanes (so a lane can be flooded on purpose). One scripted transcript of
JSON requests goes to each: bulk creates with a 409 in the middle, a
BindingList with a missing pod, a PodStatusList, lists with label and
field selectors (and an unsupported field), a watch resumed from a
resourceVersion, a 403 for the scheduler's identity, an admission
rejection, a 429 from a flooded lane, status PUTs, merge PATCHes,
DELETEs and Events. Every response's status code and JSON body must be
equal, after uids, timestamps and resourceVersions are normalised.
"""

import http.client
import json
import socket

import pytest

from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.apiserver import rbac as jax_rbac
from kubernetes_tpu.apiserver import rest as jax_rest
from kubernetes_tpu.apiserver import store as jax_store
from kubernetes_tpu_torch.api import types
from kubernetes_tpu_torch.apiserver import rbac, rest, store

TOKENS = {"sched-token": "system:kube-scheduler", "admin-token": "creator",
          "tenant-token": "alice"}
VOLATILE = {"uid", "creationTimestamp", "resourceVersion", "commitTs",
            "firstTimestamp", "lastTimestamp"}


def _normalise(doc):
    if isinstance(doc, dict):
        return {k: ("<v>" if k in VOLATILE else _normalise(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_normalise(v) for v in doc]
    return doc


class Side:
    def __init__(self, t, st_mod, rest_mod, rbac_mod):
        self.store = st_mod.ClusterStore()
        authz = rbac_mod.provision_bootstrap_policy(self.store)
        authz.add_user_to_group("creator", "system:masters")
        self.server = rest_mod.APIServer(
            store=self.store, authorizer=authz, tokens=TOKENS,
            flow_control=None, max_mutating_inflight=2).start()
        self.port = self.server.port

    def call(self, method, path, body=None, token="admin-token",
             ctype="application/json"):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=10)
        headers = {"Authorization": f"Bearer {token}",
                   "Accept": "application/json"}
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = ctype
        try:
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            payload = json.loads(raw) if raw else None
        except ValueError:
            payload = raw.decode()
        return resp.status, _normalise(payload)

    def watch(self, path, events, token="sched-token"):
        """Open a JSON watch and read ``events`` lines."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=10)
        conn.request("GET", path, headers={
            "Authorization": f"Bearer {token}"})
        resp = conn.getresponse()
        out = [resp.status]
        if resp.status == 200:
            for _ in range(events):
                out.append(_normalise(json.loads(resp.readline())))
        else:
            out.append(_normalise(json.loads(resp.read())))
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        conn.close()
        return out

    def close(self):
        self.server.shutdown_server()


def _pod(name, labels=None, priority_class="", node=""):
    spec = {"containers": [{"name": "c", "resources": {
        "requests": {"cpu": "100m", "memory": "64Mi"}}}]}
    if priority_class:
        spec["priorityClassName"] = priority_class
    if node:
        spec["nodeName"] = node
    return {"kind": "Pod", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": "default",
                         "labels": labels or {}}, "spec": spec}


def _node(name, zone):
    return {"kind": "Node", "apiVersion": "v1",
            "metadata": {"name": name, "labels": {"zone": zone}},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                       "pods": "10"}}}


def _transcript(side):
    out = []
    call = side.call
    out.append(call("POST", "/api/v1/nodes", {"kind": "NodeList", "items": [
        _node("n1", "a"), _node("n2", "b"), _node("n3", "a")]}))
    # bulk create: a duplicate in the middle is a positional 409
    out.append(call("POST", "/api/v1/namespaces/default/pods", {
        "kind": "PodList", "items": [
            _pod("p1", {"app": "web"}), _pod("p2", {"app": "db"}),
            _pod("p1", {"app": "web"}), _pod("p3", {"app": "web"})]}))
    code, listed = call("GET", "/api/v1/pods")
    out.append((code, listed))
    rv = side.store.current_rv()
    # BindingList with a missing pod
    out.append(call("POST", "/api/v1/bindings", {
        "kind": "BindingList", "items": [
            {"namespace": "default", "name": "p1", "target": {"name": "n1"}},
            {"namespace": "default", "name": "ghost",
             "target": {"name": "n1"}},
            {"namespace": "default", "name": "p2",
             "target": {"name": "n2"}}]}, token="sched-token"))
    # PodStatusList: a condition, a nomination, a missing pod
    out.append(call("POST", "/api/v1/statuses", {
        "kind": "PodStatusList", "items": [
            {"namespace": "default", "name": "p3", "status": {
                "conditions": [{"type": "PodScheduled", "status": "False",
                                "reason": "Unschedulable",
                                "message": "0/3 nodes"}]}},
            {"namespace": "default", "name": "p3",
             "status": {"nominatedNodeName": "n3"}},
            {"namespace": "default", "name": "ghost",
             "status": {"phase": "Running"}}]}, token="sched-token"))
    # selectors
    out.append(call("GET", "/api/v1/pods?labelSelector=app%3Dweb"))
    out.append(call("GET", "/api/v1/pods?labelSelector=app+in+%28web%2Cdb"
                           "%29%2Capp%21%3Ddb"))
    out.append(call("GET", "/api/v1/pods?fieldSelector=spec.nodeName%3Dn1"))
    out.append(call("GET", "/api/v1/namespaces/default/pods?fieldSelector="
                           "spec.nodeName%21%3D%2Cmetadata.name%3Dp2"))
    out.append(call("GET", "/api/v1/nodes?labelSelector=zone%3Da"))
    out.append(call("GET", "/api/v1/pods?fieldSelector=spec.bogus%3D1"))
    out.append(call("GET", "/api/v1/pods/nope"))
    out.append(call("GET", "/api/v1/namespaces/default/pods/p3"))
    # the watch from the resourceVersion before the binds: the two
    # binds, replayed in order
    out.append(side.watch(f"/api/v1/pods?watch=true&resourceVersion={rv}",
                          2))
    out.append(side.watch("/api/v1/pods?watch=true&resourceVersion=x", 0))
    # the scheduler may read nodes, not create or delete them
    out.append(call("GET", "/api/v1/nodes", token="sched-token"))
    out.append(call("POST", "/api/v1/nodes", _node("n9", "c"),
                    token="sched-token"))
    out.append(call("DELETE", "/api/v1/nodes/n3", token="sched-token"))
    out.append(call("GET", "/api/v1/pods", token="tenant-token"))
    # admission: an unknown PriorityClass
    out.append(call("POST", "/api/v1/namespaces/default/pods",
                    _pod("p4", priority_class="nope")))
    out.append(call("POST", "/api/v1/priorityclasses", {
        "kind": "PriorityClass", "metadata": {"name": "high"},
        "value": 1000}))
    out.append(call("POST", "/api/v1/namespaces/default/pods",
                    _pod("p4", priority_class="high")))
    # a flooded mutating lane: 429 with the lane's message (the handler
    # of the previous request may release its slot after its response)
    lane = side.server.mutating_lane
    assert lane.acquire(timeout=5) and lane.acquire(timeout=5)
    try:
        out.append(call("POST", "/api/v1/namespaces/default/pods",
                        _pod("p5")))
        out.append(call("GET", "/api/v1/pods/p4"))
    finally:
        lane.release()
        lane.release()
    out.append(call("POST", "/api/v1/namespaces/default/pods", _pod("p5")))
    out.append(call("POST", "/api/v1/namespaces/default/pods", _pod("p5")))
    # status PUT, merge PATCH, DELETE
    out.append(call("PUT", "/api/v1/namespaces/default/pods/p1/status",
                    {"status": {"phase": "Running", "podIP": "10.0.0.7",
                                "hostIP": "192.168.0.1"}},
                    token="sched-token"))
    out.append(call("PATCH", "/api/v1/nodes/n2",
                    {"metadata": {"labels": {"zone": "c", "gpu": "yes"}}},
                    ctype="application/merge-patch+json"))
    out.append(call("PATCH", "/api/v1/nodes/n9", {"metadata": {}}))
    out.append(call("DELETE", "/api/v1/namespaces/default/pods/p2"))
    out.append(call("DELETE", "/api/v1/namespaces/default/pods/p2"))
    # Events, as the scheduler's recorder writes them
    out.append(call("POST", "/api/v1/namespaces/default/events", {
        "kind": "EventList", "items": [
            {"kind": "Event", "metadata": {"name": "p1.1",
                                           "namespace": "default"},
             "involvedObject": {"kind": "Pod", "name": "p1",
                                "namespace": "default"},
             "reason": "Scheduled", "message": "assigned", "type": "Normal",
             "sourceComponent": "default-scheduler"}]},
        token="sched-token"))
    out.append(call("GET", "/api/v1/namespaces/default/events"))
    out.append(call("GET", "/api/v1/pods"))
    out.append(call("GET", "/api/v1/nodes"))
    out.append(call("GET", "/healthz"))
    out.append(call("GET", "/api"))
    out.append(call("GET", "/apis/example.com/v1"))
    out.append(call("GET", "/apis/example.com/v1/widgets"))
    return out


@pytest.fixture
def sides():
    made = [Side(jax_types, jax_store, jax_rest, jax_rbac),
            Side(types, store, rest, rbac)]
    yield made
    for side in made:
        side.close()


def test_transcript_equals_reference(sides):
    ref, port = sides
    want = _transcript(ref)
    got = _transcript(port)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i}"
    codes = [r[0] for r in want]
    for code in (200, 201, 400, 403, 404, 409, 422, 429):
        assert code in codes, code


def test_discovery_serves_the_port_s_kinds(sides):
    ref, port = sides
    code, doc = port.call("GET", "/api/v1")
    assert code == 200
    served = {(r["name"], r["kind"], r["namespaced"])
              for r in doc["resources"]}
    _, ref_doc = ref.call("GET", "/api/v1")
    assert served <= {(r["name"], r["kind"], r["namespaced"])
                      for r in ref_doc["resources"]}
    assert {k for _, k, _ in served} == set(rest.PLURALS.values())


def _fault_transcript(side):
    """Arm the fault gate over /debug/faults (an error burst on pod
    creates, a seeded half of node reads), then read its counters."""
    out = [side.call("POST", "/debug/faults", {"seed": 7, "rules": [
        {"fault": "error", "verb": "POST", "resource": "pods",
         "code": 503, "count": 2, "retry_after": 0.5},
        {"fault": "error", "verb": "GET", "resource": "nodes",
         "code": 429, "probability": 0.5}]})]
    for i in range(3):
        out.append(side.call("POST", "/api/v1/namespaces/default/pods",
                             _pod(f"f{i}")))
    for _ in range(8):
        out.append(side.call("GET", "/api/v1/nodes"))
    out.append(side.call("GET", "/debug/faults"))
    out.append(side.call("GET", "/healthz"))
    out.append(side.call("DELETE", "/debug/faults"))
    out.append(side.call("GET", "/api/v1/nodes"))
    out.append(side.call("POST", "/debug/faults", {"rules": [
        {"fault": "bogus"}]}))
    out.append(side.call("GET", "/debug/faults", token="tenant-token"))
    return out


def test_fault_gate_equals_reference(sides):
    ref, port = sides
    got, want = _fault_transcript(port), _fault_transcript(ref)
    assert got == want
    codes = [r[0] for r in got]
    assert codes.count(503) == 2 and 429 in codes and 403 in codes


def _rest_client_calls(t, mod, url):
    """The small typed client's verbs, as their wire dicts."""
    to = mod.to_wire
    c = mod.RestClient(url, token="admin-token")
    out = []
    node = t.Node.from_dict(_node("n1", "a"))
    out.append(to(c.create(node)))
    pod = t.Pod.from_dict(_pod("p1", {"app": "web"}))
    out.append(to(c.create(pod)))
    out.append(to(c.get("Pod", "p1")))
    out.append(c.get("Pod", "nope"))
    objs, _ = c.list("Pod", "default", label_selector="app=web")
    out.append([to(o) for o in objs])
    c.bind("default", "p1", "", "n1")
    c.update_pod_status("default", "p1", "Running", "10.0.0.1")
    out.append(to(c.patch("Node", "n1", {"metadata": {"labels": {
        "x": "y"}}}, namespace=None)))
    node = c.get("Node", "n1", None)
    node.spec.unschedulable = True
    out.append(to(c.update(node)))
    out.append(c.can_i("create", "pods", "default"))
    out.append(c.healthz())
    out.append(c.delete("Pod", "p1"))
    out.append(c.delete("Pod", "p1"))
    return [_normalise(o) for o in out]


def test_rest_client_equals_reference(sides):
    from kubernetes_tpu.api import serialization as jax_wire
    from kubernetes_tpu_torch.api import serialization as wire

    ref, port = sides

    class Ref:
        to_wire = staticmethod(jax_wire.to_wire)
        RestClient = jax_rest.RestClient

    class Port:
        to_wire = staticmethod(wire.to_wire)
        RestClient = rest.RestClient

    want = _rest_client_calls(jax_types, Ref, ref.server.url)
    got = _rest_client_calls(types, Port, port.server.url)
    assert got == want
    assert want[3] is None and want[-2:] == [True, False]


def test_leases_over_rest():
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    side = Side(types, store, rest, rbac)
    try:
        a = RestClusterClient(side.server.url, token="sched-token")
        b = RestClusterClient(side.server.url, token="sched-token")
        assert a.try_acquire_or_renew("kube-scheduler", "a", 0.0, 15.0)
        assert not b.try_acquire_or_renew("kube-scheduler", "b", 0.0, 15.0)
        assert a.try_acquire_or_renew("kube-scheduler", "a", 0.0, 15.0)
        assert b.lease_holder("kube-scheduler") == "a"
        assert b.lease_holder("nobody") is None
        a.close()
        b.close()
    finally:
        side.close()
