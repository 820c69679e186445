"""The port's service dataplane (``kubernetes_tpu_torch/proxy/``) against
the JAX package's: the IP allocator, the proxier's rule table, routing,
round robin and ClientIP affinity over the store's Services and
Endpoints, the rendered iptables-restore text byte for byte, the virtual
dataplane that executes it (seeded), and the ipvs proxier (rr, lc,
persistence, graceful drain). Each case runs as one scenario over either
package and reports what it saw; the reports must be equal. The JAX
cases that need the endpoints controller or the REST server's Service
IP allocation are not here: neither is ported.

Tolerance: exact equality."""

import random
import re
from importlib import import_module

import pytest


class Pkg:
    def __init__(self, root: str):
        self.types = import_module(f"{root}.api.types")
        self.Store = import_module(f"{root}.apiserver.store").ClusterStore
        self.proxy = import_module(f"{root}.proxy")
        self.proxier = import_module(f"{root}.proxy.proxier")
        self.dataplane = import_module(f"{root}.proxy.dataplane")

    def svc(self, name, port=80, target=8080, ip="10.96.0.10",
            affinity="None", ns="default"):
        T = self.types
        s = T.Service(selector={"app": name},
                      ports=[T.ServicePort(name="http", port=port,
                                           target_port=target)],
                      cluster_ip=ip, session_affinity=affinity)
        s.metadata.name, s.metadata.namespace = name, ns
        return s

    def ep(self, name, ips, port=8080, ns="default"):
        T = self.types
        e = T.Endpoints(addresses=[T.EndpointAddress(ip=ip,
                                                     target_pod=f"{ns}/p{i}")
                                   for i, ip in enumerate(ips)],
                        ports=[T.ServicePort(name="http", port=port)])
        e.metadata.name, e.metadata.namespace = name, ns
        return e

    def rules(self):
        Rule = self.proxier.Rule
        return [
            Rule(service="default/web", cluster_ip="10.96.0.10", port=80,
                 protocol="TCP", backends=["10.244.0.5:8080",
                                           "10.244.0.6:8080",
                                           "10.244.0.7:8080"]),
            Rule(service="default/empty", cluster_ip="10.96.0.20",
                 port=443, protocol="TCP", backends=[]),
            Rule(service="default/sticky", cluster_ip="10.96.0.30",
                 port=5432, protocol="TCP",
                 backends=["10.244.1.1:5432", "10.244.1.2:5432"],
                 session_affinity="ClientIP"),
        ]


PKGS = {"jax": Pkg("kubernetes_tpu"), "port": Pkg("kubernetes_tpu_torch")}


def sc_ip_allocator(k):
    alloc = k.proxy.IPAllocator("10.96.0.0/29")
    ips = sorted(alloc.allocate() for _ in range(5))
    out = [ips]
    try:
        alloc.allocate()
        out.append("allocated")
    except k.proxy.IPAllocatorFull:
        out.append("full")
    ip = ips[2]
    alloc.release(ip)
    out += [alloc.allocate(), alloc.reserve(ip)]
    alloc.release(ip)
    out.append(alloc.reserve(ip))
    return out


def sc_proxier(k):
    store = k.Store()
    store.add_service(k.svc("web"))
    store.upsert_endpoints(k.ep("web", ["10.88.0.2", "10.88.0.3"]))
    store.add_service(k.svc("lonely", ip="10.96.0.11"))
    p = k.proxy.Proxier(store).start()
    out = [sorted((r.service, r.cluster_ip, r.port, r.backends)
                  for r in p.rules())]
    out.append([p.route("10.96.0.10", 80) for _ in range(4)])
    out.append(p.route("10.96.0.11", 80))
    before = p.syncs
    store.upsert_endpoints(k.ep("web", ["10.88.0.9"]))
    out += [p.route("10.96.0.10", 80), p.syncs - before]
    store.delete_service("default", "web")
    out.append(p.route("10.96.0.10", 80))
    p.stop()
    store = k.Store()
    store.add_service(k.svc("web", affinity="ClientIP"))
    store.upsert_endpoints(k.ep("web", ["10.88.0.2", "10.88.0.3"]))
    p = k.proxy.Proxier(store).start()
    out.append([p.route("10.96.0.10", 80, client_ip=c)
                for c in ("1.2.3.4", "1.2.3.4", "5.6.7.8", "1.2.3.4",
                          "5.6.7.8")])
    p.stop()
    return out


def sc_render_iptables(k):
    Rule, render = k.proxier.Rule, k.proxier.render_iptables
    rules = [
        Rule(service="default/web", cluster_ip="10.0.0.10", port=80,
             protocol="TCP", backends=["10.244.0.5:8080", "10.244.1.7:8080",
                                       "10.244.2.9:8080"]),
        Rule(service="default/db", cluster_ip="10.0.0.11", port=5432,
             protocol="TCP", backends=[], session_affinity="ClientIP"),
        Rule(service="default/sticky", cluster_ip="10.0.0.12", port=443,
             protocol="TCP", backends=["10.244.0.2:8443"],
             session_affinity="ClientIP"),
    ]
    text = render(rules)
    assert text.startswith("*nat\n") and text.rstrip().endswith("COMMIT")
    assert "REJECT" not in text.split("*filter")[0]
    assert "--probability 0.33333" in text
    assert re.search(r"--rcheck --seconds \d+ --reap -j (KUBE-SEP-\w+)",
                     text)
    return [text, render(rules) == text]


def sc_dataplane(k):
    def plane(seed=7, clock=None):
        kw = {"rng": random.Random(seed)}
        if clock is not None:
            kw["clock"] = clock
        vd = k.dataplane.VirtualDataplane(**kw)
        vd.load(k.proxier.render_iptables(k.rules()))
        return vd

    vd = plane()
    hits = [vd.route("10.96.0.10", 80, src_ip=f"10.0.0.{i}")
            for i in range(300)]
    out = [hits, vd.route("8.8.8.8", 53), vd.route("10.96.0.10", 8080),
           vd.route("10.96.0.20", 443, src_ip="10.0.0.1")]
    now = [0.0]
    vd = plane(clock=lambda: now[0])
    out.append([vd.route("10.96.0.30", 5432, src_ip="10.0.0.9")
                for _ in range(10)])
    now[0] += 10801.0
    out.append([vd.route("10.96.0.30", 5432, src_ip="10.0.0.9")
                for _ in range(10)])
    vd.load(k.proxier.render_iptables([k.proxier.Rule(
        service="default/web", cluster_ip="10.96.0.10", port=80,
        protocol="TCP", backends=["10.244.9.9:9999"])]))
    out += [vd.route("10.96.0.10", 80, src_ip="a"),
            vd.route("10.96.0.30", 5432, src_ip="a")]
    assert len(set(hits)) == 3 and out[1:4] == [None, None, None]
    assert len(set(out[4])) == 1 and len(set(out[5][1:])) == 1
    assert out[6:] == ["10.244.9.9:9999", None]
    return out


def sc_ipvs(k):
    def cluster(scheduler="rr", affinity="None"):
        store = k.Store()
        store.add_service(k.svc("web", affinity=affinity))
        store.upsert_endpoints(k.ep("web", ["10.1.0.1", "10.1.0.2",
                                            "10.1.0.3"]))
        return store, k.proxy.IpvsProxier(store, scheduler=scheduler).start()

    store, p = cluster()
    out = [[p.route("10.96.0.10", 80) for _ in range(6)]]
    vs = p.virtual_servers()[0]
    out.append((vs.scheduler, sorted(vs.reals)))
    conns = [p.connect("10.96.0.10", 80) for _ in range(3)]
    held = next(c for c in conns if c.backend == "10.1.0.3:8080")
    store.upsert_endpoints(k.ep("web", ["10.1.0.1", "10.1.0.2"]))
    p.sync()
    out.append(p.virtual_servers()[0].reals["10.1.0.3:8080"].weight)
    out.append([p.route("10.96.0.10", 80) for _ in range(6)])
    held.close()
    out.append(sorted(p.virtual_servers()[0].reals))
    p.stop()
    store, p = cluster(scheduler="lc")
    c1, c2 = p.connect("10.96.0.10", 80), p.connect("10.96.0.10", 80)
    c3 = p.connect("10.96.0.10", 80)
    out.append([c1.backend, c2.backend, c3.backend])
    c3.close()
    c1.close()
    out.append(p.connect("10.96.0.10", 80).backend)
    p.stop()
    store, p = cluster(affinity="ClientIP")
    out.append([p.route("10.96.0.10", 80, client_ip=c)
                for c in ("172.16.0.9",) * 4 + ("172.16.0.10",)])
    p.stop()
    store = k.Store()
    store.add_service(k.svc("lonely", ip="10.96.0.77"))
    p = k.proxy.IpvsProxier(store).start()
    out += [p.route("10.96.0.77", 80), p.connect("10.96.0.77", 80)]
    p.stop()
    return out


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_proxy_scenario_equals_the_reference(scenario):
    got = SCENARIOS[scenario](PKGS["port"])
    assert got == SCENARIOS[scenario](PKGS["jax"])


def test_endpoints_ride_the_wire():
    """Endpoints are a served kind: the port's wire form is the JAX
    package's, and the store's WAL restores them."""
    import tempfile

    from kubernetes_tpu.api.serialization import to_wire as jax_to_wire
    from kubernetes_tpu_torch.api.serialization import from_wire, to_wire
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store

    k, j = PKGS["port"], PKGS["jax"]
    ep = k.ep("web", ["10.0.0.1", "10.0.0.2"])
    ref = j.ep("web", ["10.0.0.1", "10.0.0.2"])
    ep.metadata.uid = ref.metadata.uid = "u-web"
    assert to_wire(ep) == jax_to_wire(ref)
    assert from_wire(to_wire(ep)) == ep
    with tempfile.TemporaryDirectory() as d:
        store = k.Store()
        wal = attach_wal(store, d)
        store.upsert_endpoints(ep)
        wal.close()
        back = restore_store(d)
        assert back.get_endpoints("default", "web").addresses == ep.addresses
