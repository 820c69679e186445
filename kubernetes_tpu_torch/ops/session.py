"""Device-resident solver session.

The session uploads the static planes once per cluster epoch and carries
the state planes on the device from batch to batch: the solve updates
the state in place, so it is the next batch's initial state, and a later
batch is encoded pod-side only. The carried state stays valid while the
only cache mutations are the ones the batch path made itself (one assume
per committed pod). Other mutations (a deleted pod, a node's new
capacity) are scattered into the planes by the device mirror
(``ops.mirror``) when it can express them exactly; anything else (a new
node, a refused bind, a batch discarded after its solve, any change of a
PV, claim, StorageClass or CSINode) makes the next solve rebuild from a
fresh snapshot. Correctness never depends on the incremental path. The
shared-volume planes (``sv_attached``) are state planes: the solve marks
the volumes it attaches, and the carried state keeps them.

A solve is dispatched lazily: ``solve(..., lazy=True)`` returns a handle
whose assignments ``last_materializer`` fetches later, so host work
overlaps the device's. Each solve also leaves, for its caller to capture
at once, the batch's per-pod profile index and inexpressible flags and
its epoch's node-static masks (``last_profile_idx``,
``last_inexpressible``, ``static_masks_host``): the batch loop builds the
statuses of declined pods from them, and by the time a held batch
commits the session may describe the next one.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.ops.encode import BatchEncoder, EncodedCluster
from kubernetes_tpu_torch.ops.mirror import (
    DeltaJournal,
    DeviceClusterMirror,
    mirror_enabled,
)
from kubernetes_tpu_torch.ops.solve import CudaPlanesBackend
from kubernetes_tpu_torch.ops.solver import SolverParams, pack_podin
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot


class SolverSession:
    """Owns the device planes of one scheduler's batch path. ``mirror``
    defaults to the ``KTPU_MIRROR`` switch (on)."""

    def __init__(self, scheduler, params: SolverParams = SolverParams(),
                 device=None, mirror: Optional[bool] = None):
        self.sched = scheduler
        self.params = params
        self.backend = CudaPlanesBackend(resolve_device(device))
        self._encoder: Optional[BatchEncoder] = None
        self._cluster: Optional[EncodedCluster] = None
        self._static = None   # static planes on the device
        self._state = None    # state planes on the device, carried
        self._last_seq = -1   # cache mutation_seq the state matches
        self._node_epoch = -1  # cache node_set_seq the encoding was built on
        self._poisoned = False
        self.incremental_hits = 0
        self.rebuilds = 0
        # lazy solves dispatched while the previous one was still
        # unmaterialized: the card ran them back to back
        self.carry_chained = 0
        self._dispatch_seq = 0      # lazy handles handed out
        self._materialize_seq = 0   # lazy handles consumed
        self.last_materializer = None
        # host seconds per phase: encode (incl. packing), device (upload,
        # dispatch; an eager solve's wait too), scatter (mirror catch-up)
        self.seconds = {"encode": 0.0, "device": 0.0, "scatter": 0.0}
        # per lazy solve: (host seconds from dispatch to materialize,
        # seconds materialize waited for the card)
        self.handoffs: List[Tuple[float, float]] = []
        self.static_masks_host: Optional[np.ndarray] = None  # [U, N] bool
        self.last_profile_idx: Optional[np.ndarray] = None   # [B] int32
        self.last_inexpressible: Optional[np.ndarray] = None  # [B] bool
        self._mirror: Optional[DeviceClusterMirror] = None
        if mirror_enabled() if mirror is None else mirror:
            journal = DeltaJournal()
            scheduler.cache.attach_delta_journal(journal)
            self._mirror = DeviceClusterMirror(self, journal)

    @property
    def mirror(self) -> Optional[DeviceClusterMirror]:
        return self._mirror

    def invalidate(self) -> None:
        """Mark the device state diverged until the next rebuild (sticky:
        a later ``note_committed`` does not revalidate it)."""
        self._last_seq = -1
        self._poisoned = True

    def note_drift(self) -> None:
        """A commit refused assignments to nodes that died or were
        cordoned after this encoding was built: the node planes drifted,
        so the next solve re-encodes."""
        self.invalidate()

    def mirror_current(self) -> bool:
        """True while the device state still matches the cache."""
        return (not self._poisoned
                and self._last_seq == self.sched.cache.mutation_seq
                and self._node_epoch == self.sched.cache.node_set_seq)

    def note_committed(self, expected_mutations: int, seq_before: int) -> None:
        """After a batch commit: the state stays valid only if it was valid
        going into the batch and the cache saw exactly the commit's own
        mutations since ``seq_before``. With the mirror, other mutations
        keep the anchor where the state is known good, and the next
        solve's catch-up scatters the journal window on top."""
        seq_now = self.sched.cache.mutation_seq
        if (not self._poisoned and self._last_seq == seq_before
                and seq_now == seq_before + expected_mutations):
            self._last_seq = seq_now
        elif not (self._mirror is not None and not self._poisoned
                  and self._last_seq >= 0):
            self._last_seq = -1

    def solve(self, pods: List, pad: int, lazy: bool = False,
              incremental_only: bool = False):
        """Solve one batch, its pod rows padded to ``pad``. Returns
        (assignments, cluster, seq_before): assignment i indexes
        ``cluster.node_names`` (-1 = no node). With ``lazy`` an
        incremental solve returns a handle instead, for
        ``last_materializer`` to turn into assignments later (a rebuild
        always solves eagerly, and ``last_materializer`` is then None).
        With ``incremental_only`` the call returns None instead of
        rebuilding."""
        cache = self.sched.cache
        seq_before = cache.mutation_seq
        if (self._mirror is not None and self._state is not None
                and not self._poisoned
                and 0 <= self._last_seq != seq_before
                and self._node_epoch == cache.node_set_seq):
            t0 = time.monotonic()
            if self._mirror.catch_up(self._last_seq, seq_before) is not None:
                self._last_seq = seq_before
            self.seconds["scatter"] += time.monotonic() - t0
        if (self._state is not None and seq_before == self._last_seq
                and self._node_epoch == cache.node_set_seq):
            t0 = time.monotonic()
            pb = self._encoder.encode_pods_only(pods, pad)
            if pb is not None:
                self.last_profile_idx = pb.profile_idx
                self.last_inexpressible = pb.inexpressible
                ints, floats = pack_podin(pb)
                t1 = time.monotonic()
                chained = self._dispatch_seq > self._materialize_seq
                handle = self.backend.solve_lazy(
                    self.params, self._static, self._state, ints, floats)
                if lazy:
                    self.carry_chained += chained
                    self.last_materializer = self._materializer()
                else:
                    handle = self.backend.materialize(handle)
                    self.last_materializer = None
                self.seconds["encode"] += t1 - t0
                self.seconds["device"] += time.monotonic() - t1
                self.incremental_hits += 1
                return handle, self._cluster, seq_before
        if incremental_only:
            return None
        return self._rebuild_and_solve(pods, seq_before, pad)

    def _materializer(self):
        """The backend's materialize for the handle just dispatched,
        timed, advancing the dispatch/materialize sequence
        ``carry_chained`` reads."""
        self._dispatch_seq += 1
        token = self._dispatch_seq

        def materialize(handle):
            t0 = time.monotonic()
            out = self.backend.materialize(handle)
            waited = time.monotonic() - t0
            self.handoffs.append((t0 - handle.dispatched_at, waited))
            self.seconds["device"] += waited
            self._materialize_seq = max(self._materialize_seq, token)
            return out

        return materialize

    def warm(self, pods: List, pad: int) -> None:
        """Solve ``pods`` once (building and loading the kernel) and, with
        the mirror, run each scatter once on the planes it built (loading
        the card's indexing kernels), then drop the state: the pods were
        never committed."""
        self.solve(pods, pad)
        if self._mirror is not None:
            pad_entries = np.zeros(8, dtype=np.int32)
            self.backend.scatter_state_add(self._state, *[pad_entries] * 3)
            self.backend.scatter_static_set(self._static, *[pad_entries] * 3)
        self.invalidate()

    def fresh_planes(self, pods: List, pad: int):
        """(static planes, state) built from scratch: a new snapshot of
        the cache, encoded with ``pods``, on the session's device. The
        session is left as it is; after a catch-up its planes equal
        these when ``pods`` span the same encoding space."""
        snapshot = Snapshot()
        self.sched.cache.update_snapshot(snapshot)
        cluster, batch = BatchEncoder(snapshot, self.sched.client).encode(
            pods, pad_pods=pad)
        return self.backend.prepare(cluster, batch)

    def _rebuild_and_solve(self, pods: List, seq_before: int, pad: int):
        self.rebuilds += 1
        self._poisoned = False
        cold = self._state is None
        # a handle discarded unmaterialized must not make later
        # dispatches read as chained
        self._materialize_seq = self._dispatch_seq
        t0 = time.monotonic()
        # read before the snapshot: a node added meanwhile bumps the
        # mutation seq too, so the next solve revalidates either way
        self._node_epoch = self.sched.cache.node_set_seq
        self._encoder = BatchEncoder(self.sched.update_snapshot(),
                                     self.sched.client)
        cluster, batch = self._encoder.encode(pods, pad_pods=pad)
        self.static_masks_host = batch.static_masks
        self.last_profile_idx = batch.profile_idx
        self.last_inexpressible = batch.inexpressible
        ints, floats = pack_podin(batch)
        t1 = time.monotonic()
        self._static, self._state = self.backend.prepare(cluster, batch)
        out = self.backend.solve(self.params, self._static, self._state,
                                 ints, floats)
        self.seconds["encode"] += t1 - t0
        self.seconds["device"] += time.monotonic() - t1
        self._cluster = cluster
        self._last_seq = seq_before
        self.last_materializer = None
        if self._mirror is not None:
            self._mirror.note_seeded(cold)
        return out, cluster, seq_before
