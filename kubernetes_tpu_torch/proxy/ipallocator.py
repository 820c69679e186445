"""Service cluster-IP allocation.

Behavioral equivalent of the reference's service IP allocator
(``pkg/registry/core/service/ipallocator/allocator.go``): a bitmap over a
CIDR-sized range handing out VIPs, with explicit reserve (for a
user-specified clusterIP) and release on service deletion.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Optional


class IPAllocatorFull(Exception):
    pass


class IPAllocator:
    def __init__(self, cidr: str = "10.96.0.0/16"):
        self._net = ipaddress.ip_network(cidr)
        # skip network + first (apiserver VIP) + broadcast, like upstream
        self._base = int(self._net.network_address) + 2
        self._size = self._net.num_addresses - 3
        self._used: set = set()
        self._next = 0
        self._lock = threading.Lock()

    def allocate(self) -> str:
        with self._lock:
            if len(self._used) >= self._size:
                raise IPAllocatorFull(f"range {self._net} exhausted")
            for probe in range(self._size):
                off = (self._next + probe) % self._size
                if off not in self._used:
                    self._used.add(off)
                    self._next = off + 1
                    return str(ipaddress.ip_address(self._base + off))
            raise IPAllocatorFull(f"range {self._net} exhausted")

    def reserve(self, ip: str) -> bool:
        with self._lock:
            off = int(ipaddress.ip_address(ip)) - self._base
            if off < 0 or off >= self._size or off in self._used:
                return False
            self._used.add(off)
            return True

    def release(self, ip: str) -> None:
        with self._lock:
            off = int(ipaddress.ip_address(ip)) - self._base
            self._used.discard(off)

    def in_use(self) -> int:
        with self._lock:
            return len(self._used)
