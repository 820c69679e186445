"""Service VIP dataplane: the proxier.

Behavioral equivalent of the reference's kube-proxy iptables/ipvs modes
(``pkg/proxy/iptables/proxier.go:257``, ``pkg/proxy/ipvs/proxier.go:342``):
watch Services and Endpoints, accumulate deltas in change trackers
(``pkg/proxy/service.go`` ServiceChangeTracker / ``endpoints.go``
EndpointsChangeTracker), and on each sync pass rebuild the kernel ruleset
atomically (``syncProxyRules``). Here "the kernel" is an in-memory rule
table: VIP:port → backend list, with round-robin (iptables random mode's
deterministic recast) and ClientIP session affinity. ``route()`` is the
dataplane lookup a connection would take.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Endpoints, Service
from kubernetes_tpu_torch.apiserver.store import ADDED, DELETED, MODIFIED, ClusterStore, Event


@dataclass
class Rule:
    """One VIP:port → backends chain (an iptables KUBE-SVC-* chain)."""

    service: str                     # "ns/name"
    cluster_ip: str
    port: int
    protocol: str
    backends: List[str] = field(default_factory=list)  # "ip:port"
    session_affinity: str = "None"   # or "ClientIP"


class Proxier:
    """One per node. ``sync()`` is cheap and idempotent: it rebuilds the
    table from tracked state only when something changed."""

    def __init__(self, store: ClusterStore, node_name: str = ""):
        self.store = store
        self.node_name = node_name
        self._lock = threading.Lock()
        self._services: Dict[str, Service] = {}
        self._endpoints: Dict[str, Endpoints] = {}
        self._rules: Dict[Tuple[str, int], Rule] = {}
        self._rr_state: Dict[Tuple[str, int], int] = {}
        self._affinity: Dict[Tuple[str, int, str], str] = {}
        self._dirty = True
        self._watch = None
        self.syncs = 0  # observability: how many rule rebuilds ran

    # -- wiring --------------------------------------------------------
    def start(self) -> "Proxier":
        with self._lock:
            for svc in self.store.list_all_services():
                self._services[f"{svc.metadata.namespace}/{svc.name}"] = svc
            for ep in self.store.list_endpoints():
                self._endpoints[f"{ep.namespace}/{ep.name}"] = ep
            self._dirty = True
        self._watch = self.store.watch(self._on_events)
        self.sync()
        return self

    def stop(self) -> None:
        if self._watch is not None:
            self._watch.stop()

    def _on_events(self, events: List[Event]) -> None:
        for event in events:
            self._on_event(event)

    def _on_event(self, event: Event) -> None:
        if event.kind == "Service":
            key = f"{event.obj.metadata.namespace}/{event.obj.metadata.name}"
            with self._lock:
                if event.type == DELETED:
                    self._services.pop(key, None)
                else:
                    self._services[key] = event.obj
                self._dirty = True
        elif event.kind == "Endpoints":
            key = f"{event.obj.namespace}/{event.obj.name}"
            with self._lock:
                if event.type == DELETED:
                    self._endpoints.pop(key, None)
                else:
                    self._endpoints[key] = event.obj
                self._dirty = True

    # -- rule build (syncProxyRules) -----------------------------------
    def sync(self) -> None:
        with self._lock:
            if not self._dirty:
                return
            rules: Dict[Tuple[str, int], Rule] = {}
            for key, svc in self._services.items():
                if not svc.cluster_ip:
                    continue
                ep = self._endpoints.get(key)
                for sp in svc.ports:
                    target = sp.target_port or sp.port
                    backends = []
                    if ep is not None:
                        for addr in ep.addresses:
                            backends.append(f"{addr.ip}:{target}")
                    rules[(svc.cluster_ip, sp.port)] = Rule(
                        service=key,
                        cluster_ip=svc.cluster_ip,
                        port=sp.port,
                        protocol=sp.protocol,
                        backends=backends,
                        session_affinity=getattr(svc, "session_affinity", "None"),
                    )
            self._rules = rules
            # drop affinity entries for vanished VIPs/backends
            self._affinity = {
                k: b for k, b in self._affinity.items()
                if (k[0], k[1]) in rules and b in rules[(k[0], k[1])].backends
            }
            self._dirty = False
            self.syncs += 1

    # -- dataplane -----------------------------------------------------
    def route(self, cluster_ip: str, port: int,
              client_ip: str = "") -> Optional[str]:
        """Resolve a VIP connection to a backend ("ip:port"), honoring
        session affinity; None when no endpoints (iptables REJECT)."""
        self.sync()
        with self._lock:
            rule = self._rules.get((cluster_ip, port))
            if rule is None or not rule.backends:
                return None
            if rule.session_affinity == "ClientIP" and client_ip:
                akey = (cluster_ip, port, client_ip)
                backend = self._affinity.get(akey)
                if backend in rule.backends:
                    return backend
            idx = self._rr_state.get((cluster_ip, port), 0)
            backend = rule.backends[idx % len(rule.backends)]
            self._rr_state[(cluster_ip, port)] = idx + 1
            if rule.session_affinity == "ClientIP" and client_ip:
                self._affinity[(cluster_ip, port, client_ip)] = backend
            return backend

    def rules(self) -> List[Rule]:
        self.sync()
        with self._lock:
            return list(self._rules.values())


# ----------------------------------------------------------------------
def render_iptables(rules: List[Rule]) -> str:
    """Render the rule table as an iptables-restore ruleset — the exact
    artifact the reference's ``syncProxyRules`` writes through
    ``utiliptables.RestoreAll`` (``pkg/proxy/iptables/proxier.go:257``
    onward, writeLine buffers): a KUBE-SERVICES entry chain, one
    KUBE-SVC-* chain per VIP:port fanning out with
    ``statistic --mode random --probability 1/k`` matches, and one
    KUBE-SEP-* DNAT chain per backend. On a real Linux node this text
    pipes straight into ``iptables-restore --noflush``; in this harness
    it is the dataplane's canonical serialized form (tested, diffable,
    and byte-stable for a given rule table).
    """
    import hashlib

    def chain_hash(*parts: str) -> str:
        # KUBE-SVC-XXXXXXXXXXXXXXXX: 16-char base32-ish hash like
        # servicePortChainName (pkg/proxy/iptables/proxier.go:658)
        digest = hashlib.sha256("/".join(parts).encode()).hexdigest()
        return digest[:16].upper()

    nat_lines = ["*nat", ":KUBE-SERVICES - [0:0]"]
    # no-endpoints REJECTs live in the FILTER table — REJECT is invalid
    # in nat and would abort the whole iptables-restore COMMIT
    # (reference: proxier.go writes them into filterRules)
    filter_lines = ["*filter", ":KUBE-SERVICES - [0:0]"]
    svc_chains = []
    sep_chains = []
    svc_rules = []
    sep_rules = []
    reject_rules = []
    for rule in sorted(rules, key=lambda r: (r.service, r.port)):
        svc_chain = f"KUBE-SVC-{chain_hash(rule.service, str(rule.port))}"
        proto = rule.protocol.lower() or "tcp"
        n = len(rule.backends)
        if n == 0:
            reject_rules.append(
                f'-A KUBE-SERVICES -d {rule.cluster_ip}/32 -p {proto} '
                f'-m {proto} --dport {rule.port} '
                f'-m comment --comment "{rule.service} has no endpoints" '
                f"-j REJECT"
            )
            continue
        svc_chains.append(f":{svc_chain} - [0:0]")
        svc_rules.append(
            f'-A KUBE-SERVICES -d {rule.cluster_ip}/32 -p {proto} '
            f'-m {proto} --dport {rule.port} '
            f'-m comment --comment "{rule.service} cluster IP" '
            f"-j {svc_chain}"
        )
        sep_names = [
            f"KUBE-SEP-{chain_hash(rule.service, str(rule.port), backend)}"
            for backend in rule.backends
        ]
        if rule.session_affinity == "ClientIP":
            # returning sticky clients jump straight to THEIR endpoint
            # chain (per-SEP recent list, proxier.go writeSessionAffinity)
            for sep_chain in sep_names:
                svc_rules.append(
                    f"-A {svc_chain} -m recent --name {sep_chain} "
                    f"--rcheck --seconds 10800 --reap -j {sep_chain}"
                )
        for i, (backend, sep_chain) in enumerate(
            zip(rule.backends, sep_names)
        ):
            sep_chains.append(f":{sep_chain} - [0:0]")
            remaining = n - i
            if remaining > 1:
                svc_rules.append(
                    f"-A {svc_chain} -m statistic --mode random "
                    f"--probability {1.0 / remaining:.5f} -j {sep_chain}"
                )
            else:
                svc_rules.append(f"-A {svc_chain} -j {sep_chain}")
            if rule.session_affinity == "ClientIP":
                sep_rules.append(
                    f"-A {sep_chain} -m recent --name {sep_chain} --set "
                    f"-p {proto} -m {proto} -j DNAT "
                    f"--to-destination {backend}"
                )
            else:
                sep_rules.append(
                    f"-A {sep_chain} -p {proto} -m {proto} -j DNAT "
                    f"--to-destination {backend}"
                )
    nat_lines += svc_chains + sep_chains + svc_rules + sep_rules
    nat_lines.append("COMMIT")
    filter_lines += reject_rules
    filter_lines.append("COMMIT")
    return "\n".join(nat_lines + filter_lines) + "\n"
