"""ipvs-mode kube-proxy: the virtual IPVS table.

Behavioral equivalent of the reference's ipvs proxier
(``pkg/proxy/ipvs/proxier.go:342 NewProxier`` + ``graceful_termination
.go``): the SAME Service/Endpoints change trackers as the iptables mode
(the reference shares ``pkg/proxy/{service,endpoints}.go`` between
modes — here the inner ``Proxier`` plays that role), but the dataplane
is an in-memory IPVS state machine instead of an iptables ruleset:

- one **virtual server** per VIP:port:protocol, each holding weighted
  **real servers** (the endpoints);
- **scheduling algorithms**: ``rr`` (round robin) and ``lc`` (least
  connection — picks the real server with the fewest active
  connections per weight), selectable like ``--ipvs-scheduler``;
- **session persistence** for ClientIP affinity (IPVS persistence
  timeout rather than iptables ``recent`` matches);
- **graceful termination**: a real server whose endpoint vanished gets
  weight 0 — new connections skip it, existing connections drain, and
  the entry is deleted only when its active-connection count reaches
  zero (``graceful_termination.go`` gracefulDeleteRS).

``connect()`` models a connection (incrementing the active count the
``lc`` scheduler and the drain logic consume); ``route()`` is the
stateless lookup. Both resolve exactly like a kernel IPVS director
would on a real node.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.proxy.proxier import Proxier

# reference default for ClientIP affinity (v1.DefaultClientIPServiceAffinitySeconds)
DEFAULT_PERSISTENCE_SECONDS = 10800.0


@dataclass
class RealServer:
    address: str                 # "ip:port"
    weight: int = 1              # 0 = draining (graceful termination)
    active_conns: int = 0


@dataclass
class VirtualServer:
    vip: str
    port: int
    protocol: str = "TCP"
    scheduler: str = "rr"
    persistence_timeout: float = 0.0
    reals: Dict[str, RealServer] = field(default_factory=dict)
    rr_idx: int = 0


class Connection:
    """One routed connection; ``close()`` releases it (drives both the
    lc scheduler's counts and graceful-termination deletion)."""

    def __init__(self, proxier: "IpvsProxier", key: Tuple[str, int],
                 backend: str):
        self._proxier = proxier
        self._key = key
        self.backend = backend
        self._open = True

    def close(self) -> None:
        if self._open:
            self._open = False
            self._proxier._release(self._key, self.backend)


class IpvsProxier:
    """One per node, like the iptables-mode ``Proxier`` it wraps."""

    def __init__(self, store: ClusterStore, node_name: str = "",
                 scheduler: str = "rr"):
        if scheduler not in ("rr", "lc"):
            raise ValueError(f"unsupported ipvs scheduler {scheduler!r}")
        self._inner = Proxier(store, node_name)
        self.scheduler = scheduler
        self._lock = threading.Lock()
        self._servers: Dict[Tuple[str, int], VirtualServer] = {}
        # (vip, port, client) -> (backend, stamp)
        self._persist: Dict[Tuple[str, int, str], Tuple[str, float]] = {}
        self.syncs = 0
        # rebuild only when the inner trackers actually rebuilt: every
        # route()/connect() calls sync(), which must be O(1) when the
        # service/endpoints world is unchanged
        self._last_inner_syncs = -1

    # -- wiring --------------------------------------------------------
    def start(self) -> "IpvsProxier":
        self._inner.start()
        self.sync()
        return self

    def stop(self) -> None:
        self._inner.stop()

    # -- sync (syncProxyRules, ipvs flavor) ----------------------------
    def sync(self) -> None:
        rules = self._inner.rules()   # tracker-driven, cheap when clean
        with self._lock:
            if self._inner.syncs == self._last_inner_syncs:
                return                # table already current
            self._last_inner_syncs = self._inner.syncs
            seen = set()
            for rule in rules:
                key = (rule.cluster_ip, rule.port)
                seen.add(key)
                vs = self._servers.get(key)
                if vs is None:
                    vs = VirtualServer(
                        vip=rule.cluster_ip, port=rule.port,
                        protocol=rule.protocol,
                        scheduler=self.scheduler,
                    )
                    self._servers[key] = vs
                vs.persistence_timeout = (
                    DEFAULT_PERSISTENCE_SECONDS
                    if rule.session_affinity == "ClientIP" else 0.0
                )
                wanted = set(rule.backends)
                for addr in wanted:
                    rs = vs.reals.get(addr)
                    if rs is None:
                        vs.reals[addr] = RealServer(address=addr)
                    else:
                        rs.weight = 1       # endpoint came back mid-drain
                for addr, rs in list(vs.reals.items()):
                    if addr not in wanted:
                        # graceful termination: weight 0, delete only
                        # once drained
                        rs.weight = 0
                        if rs.active_conns == 0:
                            del vs.reals[addr]
            for key in list(self._servers):
                if key not in seen:
                    # whole service gone: its sessions die with it (the
                    # kernel flushes the virtual server)
                    del self._servers[key]
            now = time.monotonic()
            self._persist = {
                k: (backend, stamp)
                for k, (backend, stamp) in self._persist.items()
                if (k[0], k[1]) in self._servers
                # expired sessions must not accumulate for the
                # service's lifetime
                and now - stamp < self._servers[
                    (k[0], k[1])].persistence_timeout
            }
            self.syncs += 1

    # -- scheduling ----------------------------------------------------
    def _pick(self, vs: VirtualServer, client_ip: str,
              now: float) -> Optional[str]:
        if vs.persistence_timeout > 0 and client_ip:
            got = self._persist.get((vs.vip, vs.port, client_ip))
            if got is not None:
                backend, stamp = got
                # a draining (weight-0) real server keeps its persistent
                # sessions until the timeout — that IS the drain
                if backend in vs.reals and \
                        now - stamp < vs.persistence_timeout:
                    self._persist[(vs.vip, vs.port, client_ip)] = (
                        backend, now)
                    return backend
        candidates = sorted(
            (rs for rs in vs.reals.values() if rs.weight > 0),
            key=lambda rs: rs.address,
        )
        if not candidates:
            return None
        if vs.scheduler == "lc":
            backend = min(
                candidates,
                key=lambda rs: (rs.active_conns / rs.weight, rs.address),
            ).address
        else:                       # rr
            backend = candidates[vs.rr_idx % len(candidates)].address
            vs.rr_idx += 1
        if vs.persistence_timeout > 0 and client_ip:
            self._persist[(vs.vip, vs.port, client_ip)] = (backend, now)
        return backend

    # -- dataplane -----------------------------------------------------
    def route(self, vip: str, port: int,
              client_ip: str = "") -> Optional[str]:
        """Stateless lookup: backend "ip:port" or None (no virtual
        server / no live real server — the kernel would REJECT)."""
        self.sync()
        with self._lock:
            vs = self._servers.get((vip, port))
            if vs is None:
                return None
            return self._pick(vs, client_ip, time.monotonic())

    def connect(self, vip: str, port: int,
                client_ip: str = "") -> Optional[Connection]:
        """Routed connection holding an active-conn slot until
        ``close()``."""
        self.sync()
        with self._lock:
            vs = self._servers.get((vip, port))
            if vs is None:
                return None
            backend = self._pick(vs, client_ip, time.monotonic())
            if backend is None:
                return None
            vs.reals[backend].active_conns += 1
            return Connection(self, (vip, port), backend)

    def _release(self, key: Tuple[str, int], backend: str) -> None:
        with self._lock:
            vs = self._servers.get(key)
            if vs is None:
                return
            rs = vs.reals.get(backend)
            if rs is None:
                return
            rs.active_conns = max(0, rs.active_conns - 1)
            if rs.weight == 0 and rs.active_conns == 0:
                del vs.reals[backend]     # drain complete

    # -- introspection (ipvsadm -L -n analog) --------------------------
    def virtual_servers(self) -> List[VirtualServer]:
        self.sync()
        with self._lock:
            return [
                VirtualServer(
                    vip=vs.vip, port=vs.port, protocol=vs.protocol,
                    scheduler=vs.scheduler,
                    persistence_timeout=vs.persistence_timeout,
                    reals={
                        a: RealServer(r.address, r.weight, r.active_conns)
                        for a, r in vs.reals.items()
                    },
                    rr_idx=vs.rr_idx,
                )
                for vs in self._servers.values()
            ]
