"""The device mirror: watch deltas scattered into the resident planes.

The session carries the solve's planes on the device from batch to
batch. Without the mirror, any cache mutation the batch path did not
make itself (a pod deleted, a node's capacity changed) makes the next
solve rebuild every plane on the host. With it:

- ``DeltaJournal``: the cache notes one ``DeltaRecord`` per
  ``mutation_seq`` bump, under its lock. The journal is a bounded ring;
  a window it no longer covers contiguously reads as a gap and forces a
  rebuild, so safety never rests on the journal being complete.
- ``DeviceClusterMirror.catch_up(lo, hi)`` translates the journaled
  window into exact int32 entries against the resident encoding (the
  one the last full encode kept) and applies them on the device: adds
  into the state planes, sets into the static planes. Translation is
  all-or-nothing: any record the encoding cannot express bit for bit
  makes it return None, and the caller rebuilds, which is what the
  mirror-off path does anyway.
- A pod delta is scattered only when the result equals a rebuild's: its
  node is a column of the encoding, it matches no tracked spread
  constraint or (anti-)affinity term and owns none, and its memory and
  ephemeral requests are whole KiB (the encoder rounds sums up to KiB,
  so per-pod deltas are exact only on aligned values). A node update is
  scattered only when old and new differ in nothing but
  ``status.allocatable``. While the encoding has CSI attach-limit
  columns, neither is scattered: a pod with volumes counts in them and in
  the shared-volume planes as sets, and the columns' allocatable comes
  from CSINodes, not from the node.

``MIRROR_ENV`` turns the mirror off (``off``, ``0`` or ``false``).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.ops.encode import _kib, _resource_row
from kubernetes_tpu_torch.ops.planes import state_planes, static_planes
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

MIRROR_ENV = "KTPU_MIRROR"
# mutations of headroom between two solves; a storm that overflows the
# ring reads as a gap and costs one rebuild
JOURNAL_CAP = 8192


def mirror_enabled() -> bool:
    """The ``KTPU_MIRROR`` switch, on unless set to off, 0 or false."""
    return os.environ.get(MIRROR_ENV, "on").strip().lower() not in (
        "off", "0", "false")


class DeltaRecord(NamedTuple):
    """One cache mutation, journaled at its ``mutation_seq``."""

    seq: int
    kind: str
    a: object = None
    b: object = None


class DeltaJournal:
    """Bounded ring of cache mutations, written under the cache lock."""

    def __init__(self, cap: int = JOURNAL_CAP):
        self._recs: deque = deque(maxlen=cap)
        self._lock = threading.Lock()

    def note(self, seq: int, kind: str, a=None, b=None) -> None:
        with self._lock:
            self._recs.append(DeltaRecord(seq, kind, a, b))

    def window(self, lo: int, hi: int) -> Optional[List[DeltaRecord]]:
        """Records with lo < seq <= hi, or None when the ring does not
        cover that range contiguously (evicted, or bumped before the
        journal was attached): that must read as "diverged", never as
        "nothing happened"."""
        if hi <= lo:
            return []
        with self._lock:
            recs = [r for r in self._recs if lo < r.seq <= hi]
        if len(recs) != hi - lo or recs[0].seq != lo + 1:
            return None
        return recs


def _pad_pow2(m: int) -> int:
    """Entries are padded to a power of two, at least 8."""
    p = 8
    while p < m:
        p *= 2
    return p


class DeviceClusterMirror:
    """The catch-up path of one ``SolverSession``: journal window ->
    exact entries -> in-place update of the resident planes."""

    def __init__(self, session, journal: DeltaJournal):
        self._session = session
        self._journal = journal
        self.events_applied = 0
        self.catch_ups = 0
        self.scatter_bytes_total = 0
        self.reseeds = 0   # full rebuilds after the first seed
        self.seeds = 0
        self._node_map: Optional[Dict[str, int]] = None

    def note_seeded(self, cold: bool) -> None:
        """The session just rebuilt the planes from a host encode: the
        node index is stale, and unless this was the first seed the
        rebuild counts as a reseed."""
        self._node_map = None
        if cold:
            self.seeds += 1
        else:
            self.reseeds += 1

    def info(self) -> dict:
        return {
            "events": self.events_applied,
            "catch_ups": self.catch_ups,
            "scatter_bytes": self.scatter_bytes_total,
            "reseeds": self.reseeds,
        }

    def catch_up(self, from_seq: int, to_seq: int) -> Optional[int]:
        """Apply the journaled (from_seq, to_seq] window to the resident
        planes. Returns the bytes the entries took to the device (0 when
        the window nets out to nothing), or None when the window has a
        gap or a record the encoding cannot express: the caller then
        rebuilds. A failure of the device update itself propagates, with
        the session invalidated first."""
        sess = self._session
        if sess._state is None or sess._encoder is None:
            return None
        recs = self._journal.window(from_seq, to_seq)
        if recs is None:
            return None
        plan = self._translate(recs)
        if plan is None:
            return None
        try:
            nbytes = self._dispatch(*plan)
        except BaseException:
            sess.invalidate()
            raise
        self.catch_ups += 1
        self.events_applied += len(recs)
        self.scatter_bytes_total += nbytes
        return nbytes

    def _node_index(self) -> Dict[str, int]:
        """Node name -> plane column of the resident encoding."""
        if self._node_map is None:
            self._node_map = {name: i for i, name in
                              enumerate(self._session._cluster.node_names)}
        return self._node_map

    def _translate(self, recs: List[DeltaRecord]
                   ) -> Optional[Tuple[list, dict]]:
        """Journal window -> (state add-entries, static set-entries), or
        None when a record cannot be expressed bit for bit."""
        static = self._session._static
        do, _ = state_planes(static.r, static.sc, static.t, static.sv)
        so, _ = static_planes(static.r, static.sc, static.t, static.u)
        names = self._session._encoder._resource_names
        nmap = self._node_index()
        adds: list = []
        sets: dict = {}
        for rec in recs:
            k = rec.kind
            if k == "assume_bulk":
                # the solve already counted these pods in the state
                continue
            if k in ("assume", "pod_add"):
                ok = self._pod_delta(adds, rec.a, +1, do, names, nmap)
            elif k == "pod_del":
                ok = self._pod_delta(adds, rec.a, -1, do, names, nmap)
            elif k in ("pod_update", "pod_move"):
                ok = (self._pod_delta(adds, rec.a, -1, do, names, nmap)
                      and self._pod_delta(adds, rec.b, +1, do, names, nmap))
            elif k == "node_update":
                ok = self._node_set(sets, rec.a, rec.b, so, names, nmap)
            else:
                # node_add, node_del: the node set changed
                ok = False
            if not ok:
                return None
        return adds, sets

    def _pod_delta(self, out: list, pod, sign: int, do, names,
                   nmap) -> bool:
        """Append (plane row, node column, value) add-entries for one
        pod's share of the state planes; False means rebuild."""
        node_name = pod.spec.node_name or ""
        if not node_name:
            return True   # unbound: no share of any node
        col = nmap.get(node_name)
        if col is None:
            return False
        enc = self._session._encoder
        # a pod's volumes count in the attach columns and shared-volume
        # planes as sets, which an addition cannot replay
        if enc._attach_col and pod.spec.volumes:
            return False
        # pods owning spread constraints or (anti-)affinity terms add to
        # tracked terms and owner counts
        if pod.spec.topology_spread_constraints:
            return False
        aff = pod.spec.affinity
        if aff is not None and (aff.pod_affinity is not None
                                or aff.pod_anti_affinity is not None):
            return False
        # pods matched by a tracked constraint or term are counted in
        # the topology planes
        if any(con.matches(pod) for con in enc._constraints) or any(
                term.matches(pod) for term in enc._terms):
            return False
        pi = PodInfo.of(pod)
        req, nz = pi.resource_request, pi.non_zero_request
        if req.memory % 1024 or req.ephemeral_storage % 1024 \
                or nz.memory % 1024:
            return False
        # scalar resources outside the encoded columns count nowhere, as
        # in a rebuild
        for j, val in enumerate(_resource_row(req, names)):
            if val:
                out.append((do["requested"] + j, col, sign * val))
        if nz.milli_cpu:
            out.append((do["nonzero"], col, sign * nz.milli_cpu))
        if nz.memory:
            out.append((do["nonzero"] + 1, col, sign * _kib(nz.memory)))
        out.append((do["pod_count"], col, sign))
        return True

    def _node_set(self, sets: dict, old, new, so, names, nmap) -> bool:
        """Set-entries for a node whose change is confined to
        ``status.allocatable``; anything touching masks, scores or
        topology codes means rebuild."""
        if old is None or new is None or old.name != new.name:
            return False
        col = nmap.get(new.name)
        if col is None:
            return False
        # the attach columns' allocatable comes from the CSINodes, which a
        # capacity scatter would overwrite
        if self._session._encoder._attach_col:
            return False
        if (old.metadata.labels != new.metadata.labels
                or old.spec.unschedulable != new.spec.unschedulable
                or not _seq_equal(old.spec.taints, new.spec.taints)
                or not _seq_equal(old.status.images, new.status.images)):
            return False
        ni = NodeInfo()
        ni.set_node(new)
        for j, val in enumerate(_resource_row(ni.allocatable, names)):
            sets[(so["alloc"] + j, col)] = val
        sets[(so["max_pods"], col)] = \
            ni.allocatable.allowed_pod_number or 1_000_000
        return True

    def _dispatch(self, adds: list, sets: dict) -> int:
        """Apply the entries through the backend's scatters; returns the
        bytes they took to the device."""
        sess = self._session
        total = 0
        if adds:
            # one entry per (row, column)
            acc: Dict[tuple, int] = {}
            for row, col, val in adds:
                acc[(row, col)] = acc.get((row, col), 0) + val
            items = [(rc[0], rc[1], v) for rc, v in acc.items() if v]
            if items:
                total += sess.backend.scatter_state_add(
                    sess._state, *_pack_entries(items, pad_with_zero=True))
        if sets:
            # the dict kept the last write per (row, column)
            items = [(rc[0], rc[1], v) for rc, v in sets.items()]
            total += sess.backend.scatter_static_set(
                sess._static, *_pack_entries(items, pad_with_zero=False))
            sess.static_scattered()
        return total


def _seq_equal(a, b) -> bool:
    """Value equality of two lists of API objects (taints, images)."""
    a, b = list(a or []), list(b or [])
    return len(a) == len(b) and a == b


def _pack_entries(items: list, pad_with_zero: bool):
    """(row, column, value) triples -> three padded int32 arrays. Adds
    pad with (0, 0, 0), which adds nothing; sets repeat the last entry,
    a duplicate set of the same value."""
    m = len(items)
    fill = (0, 0, 0) if pad_with_zero else items[-1]
    arr = np.asarray(items + [fill] * (_pad_pow2(m) - m), dtype=np.int32)
    return (np.ascontiguousarray(arr[:, 0]),
            np.ascontiguousarray(arr[:, 1]),
            np.ascontiguousarray(arr[:, 2]))
