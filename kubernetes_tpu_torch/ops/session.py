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

A rebuild whose static inputs equal the resident epoch's (the static
fingerprint: allocatable, pod caps, topology codes, the batch's profile
masks and scores, spread and term keys, shared-volume slot keys) is a
state-only rebuild: only the state planes are uploaded, and the static
planes stay on the device. A failure there propagates, as every solve
failure does. The mirror's writes into the resident static planes (a
node's new allocatable) and a drift drop the fingerprint, so the next
rebuild uploads everything.

A solve is dispatched lazily: ``solve(..., lazy=True)`` returns a handle
whose assignments ``last_materializer`` fetches later, so host work
overlaps the device's. Each solve also leaves, for its caller to capture
at once, the batch's per-pod profile index and inexpressible flags and
its epoch's node-static masks (``last_profile_idx``,
``last_inexpressible``, ``static_masks_host``): the batch loop builds the
statuses of declined pods from them, and by the time a held batch
commits the session may describe the next one.

Each solve is one cycle of the device profiler (``observability.devprof``:
the pod rows' encode, a rebuild's cluster encode, the dispatch, the wait
at materialization, the launch's timing-event seconds, the ring's bytes,
the snapshot's staleness), and its phases are spans (``solve.encode``,
``solve.pack``, ``solve.device``, ``solve.block``, ``solve.scatter``) and
``batch_solve_duration{phase}`` observations. A ``warming`` solve is
profiled as a warm-up and neither counted nor observed.

The backend is ``CudaPlanesBackend`` unless the caller gives one, or
``KTPU_SOLVER=sharded`` asks for the sharded tier (``default_backend``):
the session's calls are the same on either.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.metrics.freshness_metrics import freshness_metrics
from kubernetes_tpu_torch.observability.devprof import get_devprof
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.ops.encode import BatchEncoder, EncodedCluster
from kubernetes_tpu_torch.ops.mirror import (
    DeltaJournal,
    DeviceClusterMirror,
    mirror_enabled,
)
from kubernetes_tpu_torch.ops.planes import prepare
from kubernetes_tpu_torch.ops.solve import CudaPlanesBackend
from kubernetes_tpu_torch.ops.solver import SolverParams, pack_podin
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot


SOLVER_ENV = "KTPU_SOLVER"


def _mesh_width(n_devices: int) -> int:
    """The sharded tier's node-axis width: the largest power of two at most
    ``n_devices``, which divides every padded node count (a multiple of
    128)."""
    width = 1
    while width * 2 <= n_devices:
        width *= 2
    return width


def default_backend(device=None):
    """The session's backend on ``device`` (the card unless "cpu"):
    ``KTPU_SOLVER=sharded`` forces the sharded tier, one mesh on the card;
    otherwise ``CudaPlanesBackend``, however many cards are visible (the
    multi-card tier is ROADMAP §A10). No mesh is built unless forced."""
    dev = resolve_device(device)
    if os.environ.get(SOLVER_ENV, "") == "sharded":
        from kubernetes_tpu_torch import parallel

        return parallel.ShardedBackend(
            parallel.make_mesh(_mesh_width(1), device=dev))
    return CudaPlanesBackend(dev)


class SolverSession:
    """Owns the device planes of one scheduler's batch path. ``mirror``
    defaults to the ``KTPU_MIRROR`` switch (on); ``backend``, when given,
    wins over ``default_backend(device)``."""

    def __init__(self, scheduler, params: SolverParams = SolverParams(),
                 device=None, mirror: Optional[bool] = None, backend=None):
        self.sched = scheduler
        self.params = params
        self.backend = backend if backend is not None \
            else default_backend(device)
        self._encoder: Optional[BatchEncoder] = None
        self._cluster: Optional[EncodedCluster] = None
        self._static = None   # static planes on the device
        self._state = None    # state planes on the device, carried
        self._last_seq = -1   # cache mutation_seq the state matches
        self._node_epoch = -1  # cache node_set_seq the encoding was built on
        self._poisoned = False
        self.incremental_hits = 0
        self.rebuilds = 0
        # rebuilds that kept the resident static planes (counted in
        # ``rebuilds`` too)
        self.state_only_rebuilds = 0
        self._static_fp = None   # fingerprint of the resident static planes
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
        # the first pod's scheduling cycle of the batch being solved: the
        # correlation key of the profiler's record and the solve spans
        self.trace_cycle = -1
        self._warming = False
        self._staleness_anchor = 0.0
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
        so the next solve re-encodes them and uploads them again."""
        self.invalidate()
        self._static_fp = None

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
              incremental_only: bool = False, warming: bool = False):
        """Solve one batch, its pod rows padded to ``pad``. Returns
        (assignments, cluster, seq_before): assignment i indexes
        ``cluster.node_names`` (-1 = no node). With ``lazy`` an
        incremental solve returns a handle instead, for
        ``last_materializer`` to turn into assignments later (a rebuild
        always solves eagerly, and ``last_materializer`` is then None).
        With ``incremental_only`` the call returns None instead of
        rebuilding. ``warming``: a warm-up solve (profiled as one, not
        observed; rebuilds still count)."""
        self._warming = warming
        cache = self.sched.cache
        seq_before = cache.mutation_seq
        scatter = None
        if (self._mirror is not None and self._state is not None
                and not self._poisoned
                and 0 <= self._last_seq != seq_before
                and self._node_epoch == cache.node_set_seq):
            t0 = time.monotonic()
            applied = self._mirror.catch_up(self._last_seq, seq_before)
            if applied is not None:
                self._last_seq = seq_before
            scatter = (time.monotonic() - t0, applied or 0)
            self.seconds["scatter"] += scatter[0]
        if (self._state is not None and seq_before == self._last_seq
                and self._node_epoch == cache.node_set_seq):
            dp = get_devprof()
            rec = dp.begin_cycle(cycle=self.trace_cycle, pad=pad,
                                 real=len(pods), warming=warming) \
                if dp.enabled else None
            if not warming:
                self._note_staleness(rec, dp)
            if scatter is not None:
                dp.phase("scatter", scatter[0])
                dp.add_bytes("scatter", scatter[1])
                self._observe("scatter", scatter[0])
            try:
                out = self._solve_incremental(pods, pad, lazy, dp, rec)
            except BaseException:
                dp.abort(rec)
                raise
            if out is not None:
                return out[0], self._cluster, seq_before
            # the pods fall outside the epoch's encoding space: no solve
            dp.abort(rec)
        if incremental_only:
            return None
        return self._rebuild_and_solve(pods, seq_before, pad)

    def _solve_incremental(self, pods: List, pad: int, lazy: bool, dp, rec):
        """The pod rows encoded against the epoch and solved on the
        carried state: (handle or assignments,), or None when a pod does
        not fit the epoch's encoding space."""
        t0 = time.monotonic()
        pb = self._encoder.encode_pods_only(pods, pad)
        if pb is None:
            return None
        self.last_profile_idx = pb.profile_idx
        self.last_inexpressible = pb.inexpressible
        t_pack = time.monotonic()
        ints, floats = pack_podin(pb)
        t1 = time.monotonic()
        self._observe("encode", t_pack - t0, end_mono=t_pack)
        self._observe("pack", t1 - t_pack, end_mono=t1)
        # the pod rows' encode is per-batch work: devprof books it under
        # pack, and keeps encode for cluster-plane builds
        dp.phase("pack", t1 - t0)
        chained = self._dispatch_seq > self._materialize_seq
        handle = self.backend.solve_lazy(
            self.params, self._static, self._state, ints, floats)
        t_disp = time.monotonic()
        dp.phase("dispatch", t_disp - t1)
        self._flush_backend_bytes(dp)
        if lazy:
            self.carry_chained += chained
            self.last_materializer = self._materializer(rec)
        else:
            out = self.backend.materialize(handle)
            dp.phase("block", time.monotonic() - t_disp)
            dp.phase("device", self.backend.device_seconds(handle))
            self._flush_backend_bytes(dp)
            handle = out
            self.last_materializer = None
        self.seconds["encode"] += t1 - t0
        self.seconds["device"] += time.monotonic() - t1
        self._observe("device", time.monotonic() - t1)
        dp.end_cycle(rec, pending_block=lazy)
        if not self._warming:
            self.incremental_hits += 1
        return (handle,)

    def _materializer(self, rec):
        """The backend's materialize for the handle just dispatched,
        timed: the wait completes the profiler's record (with the
        launch's timing-event seconds) and is a ``solve.block`` span; it
        advances the dispatch/materialize sequence ``carry_chained``
        reads."""
        self._dispatch_seq += 1
        token = self._dispatch_seq
        dp = get_devprof()
        cycle = self.trace_cycle

        def materialize(handle):
            t0 = time.monotonic()
            out = self.backend.materialize(handle)
            end = time.monotonic()
            waited = end - t0
            self.handoffs.append((t0 - handle.dispatched_at, waited))
            self.seconds["device"] += waited
            self._materialize_seq = max(self._materialize_seq, token)
            dp.note_block(rec, waited,
                          self.backend.take_transfer_bytes("d2h")["d2h"],
                          start_mono=t0,
                          device_s=self.backend.device_seconds(handle))
            tracer = get_tracer()
            if tracer.enabled:
                tracer.record("solve.block", t0, end, cycle=cycle)
            return out

        return materialize

    def _flush_backend_bytes(self, dp) -> None:
        """Book the bytes the backend moved since the last flush into the
        open profiler cycle."""
        for direction, n in self.backend.take_transfer_bytes().items():
            if n:
                dp.add_bytes(direction, n)

    def _note_staleness(self, rec, dp) -> None:
        """The snapshot-staleness SLI, once per cycle whose snapshot
        advanced since the last sample: the age of the newest watch batch
        the cache applied (``SchedulerCache.last_event_ts``). Kept on the
        profiler's record, observed into ``snapshot_staleness_seconds``
        and a ``solve.staleness`` instant."""
        ts = self.sched.cache.last_event_ts
        if not ts or ts == self._staleness_anchor:
            return
        self._staleness_anchor = ts
        stale = max(0.0, time.time() - ts)
        dp.note_staleness(rec, stale)
        fm = freshness_metrics()
        if fm.enabled:
            fm.snapshot_staleness_seconds.observe(stale)
            tracer = get_tracer()
            if tracer.enabled:
                tracer.event("solve.staleness", cycle=self.trace_cycle,
                             staleness_ms=round(stale * 1000, 2))

    def _observe(self, segment: str, seconds: float,
                 end_mono: Optional[float] = None) -> None:
        """``batch_solve_duration{segment}`` and a ``solve.<segment>``
        span ending at ``end_mono`` (now by default); not for warm-ups."""
        if self._warming:
            return
        self.sched.metrics.batch_solve_duration.observe(seconds, segment)
        tracer = get_tracer()
        if tracer.enabled:
            end = time.monotonic() if end_mono is None else end_mono
            tracer.record(f"solve.{segment}", end - seconds, end,
                          cycle=self.trace_cycle)

    def warm(self, pods: List, pad: int) -> float:
        """Solve ``pods`` once (building and loading the kernel, a
        rebuild), then once more on the carried state (the kernel
        loaded), and, with the mirror, run each scatter once on the
        planes built (loading the card's indexing kernels; the set writes
        back the value it finds, so the static planes and their
        fingerprint stay good); then drop the state: the pods were never
        committed. Returns the seconds of the second solve."""
        self.solve(pods, pad, warming=True)
        t0 = time.monotonic()
        self.solve(pods, pad, warming=True)
        seconds = time.monotonic() - t0
        if self._mirror is not None:
            pad_entries = np.zeros(8, dtype=np.int32)
            self.backend.scatter_state_add(self._state, *[pad_entries] * 3)
            same = np.full(8, int(self._static.ints[0, 0]), dtype=np.int32)
            self.backend.scatter_static_set(self._static, pad_entries,
                                            pad_entries, same)
        self.backend.take_transfer_bytes()
        self._warming = False
        self.invalidate()
        return seconds

    def warm_pad(self, pods: List, pad: int) -> Optional[int]:
        """Warm the ``pad``-row shape between cycles: its pinned-ring
        buffers and each kernel instance it routes to launched once. The
        solve runs on a copy of the carried state, which it discards: the
        carried planes and the session's validity are left as they are,
        and a held batch's handle stays good. Returns the compiles the
        profiler counted (0: nothing needed a load), or None when no
        epoch is resident or ``pods`` fall outside its encoding space."""
        if self._state is None or self._encoder is None:
            return None
        dp = get_devprof()
        rec = dp.begin_cycle(cycle=-1, pad=pad, real=len(pods),
                             warming=True) if dp.enabled else None
        try:
            pb = self._encoder.encode_pods_only(pods, pad)
            if pb is None:
                dp.abort(rec)
                rec = None
                return None
            ints, floats = pack_podin(pb)
            t0 = time.monotonic()
            handle = self.backend.solve_lazy(
                self.params, self._static,
                self.backend.warm_state(self._state), ints, floats)
            t_disp = time.monotonic()
            self.backend.materialize(handle)
            dp.phase("dispatch", t_disp - t0)
            dp.phase("block", time.monotonic() - t_disp)
            dp.phase("device", self.backend.device_seconds(handle))
            self._flush_backend_bytes(dp)
            return rec["compiles"] if rec is not None else 0
        except BaseException:
            dp.abort(rec)
            rec = None
            raise
        finally:
            dp.end_cycle(rec)

    def fresh_planes(self, pods: List, pad: int):
        """(static planes, state) built from scratch: a new snapshot of
        the cache, encoded with ``pods``, on the session's device. The
        session is left as it is; after a catch-up its planes equal
        these when ``pods`` span the same encoding space."""
        snapshot = Snapshot()
        self.sched.cache.update_snapshot(snapshot)
        cluster, batch = BatchEncoder(snapshot, self.sched.client).encode(
            pods, pad_pods=pad)
        return prepare(cluster, batch, self.backend.device)

    # the inputs whose equality makes the static planes bit for bit equal
    _STATIC_FP_CLUSTER = ("allocatable", "max_pods", "topo_codes")
    _STATIC_FP_BATCH = ("static_masks", "static_scores", "sc_key_idx",
                        "sc_max_skew", "sc_hard", "sc_domain", "term_key_idx")

    def _static_fingerprint(self, cluster: EncodedCluster, batch):
        # the shared-volume slot keys too: a new slot order re-keys
        # every pod's slot index
        sv_keys = cluster.sv_keys if cluster.sv_keys is not None \
            else np.empty(0, dtype=np.int64)
        return (
            [np.asarray(getattr(cluster, k)) for k in self._STATIC_FP_CLUSTER]
            + [np.asarray(getattr(batch, k)) for k in self._STATIC_FP_BATCH]
            + [sv_keys],
            (cluster.resource_names, batch.num_values,
             cluster.num_real_nodes))

    @staticmethod
    def _fingerprints_equal(a, b) -> bool:
        if a is None or b is None or a[1] != b[1]:
            return False
        return all(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(a[0], b[0]))

    def static_scattered(self) -> None:
        """The resident static planes were written in place: drop their
        fingerprint."""
        self._static_fp = None

    def _rebuild_and_solve(self, pods: List, seq_before: int, pad: int):
        self.rebuilds += 1
        self._poisoned = False
        cold = self._state is None
        # a handle discarded unmaterialized must not make later
        # dispatches read as chained
        self._materialize_seq = self._dispatch_seq
        dp = get_devprof()
        rec = dp.begin_cycle(cycle=self.trace_cycle, pad=pad, real=len(pods),
                             warming=self._warming, rebuild="full") \
            if dp.enabled else None
        if not self._warming:
            self._note_staleness(rec, dp)
        try:
            return self._rebuild_and_solve_inner(pods, seq_before, pad, cold,
                                                 dp, rec)
        except BaseException:
            dp.abort(rec)
            raise

    def _rebuild_and_solve_inner(self, pods: List, seq_before: int, pad: int,
                                 cold: bool, dp, rec):
        t0 = time.monotonic()
        # read before the snapshot: a node added meanwhile bumps the
        # mutation seq too, so the next solve revalidates either way
        self._node_epoch = self.sched.cache.node_set_seq
        self._encoder = BatchEncoder(self.sched.update_snapshot(),
                                     self.sched.client,
                                     node_shards=self.backend.encode_shards)
        cluster, batch = self._encoder.encode(pods, pad_pods=pad)
        self.static_masks_host = batch.static_masks
        self.last_profile_idx = batch.profile_idx
        self.last_inexpressible = batch.inexpressible
        t_pack = time.monotonic()
        ints, floats = pack_podin(batch)
        t1 = time.monotonic()
        self._observe("encode", t_pack - t0, end_mono=t_pack)
        self._observe("pack", t1 - t_pack, end_mono=t1)
        dp.phase("encode", t_pack - t0)
        dp.phase("pack", t1 - t_pack)
        fp = self._static_fingerprint(cluster, batch)
        if self._static is not None and self._fingerprints_equal(
                fp, self._static_fp):
            if rec is not None:
                rec["rebuild"] = "state_only"
            self._state = self.backend.prepare_state_only(cluster, batch)
            if not self._warming:
                self.state_only_rebuilds += 1
        else:
            # dropped first: an upload that fails leaves no fingerprint
            self._static_fp = None
            self._static, self._state = self.backend.prepare(cluster, batch)
            self._static_fp = fp
        handle = self.backend.solve_lazy(self.params, self._static,
                                         self._state, ints, floats)
        t_disp = time.monotonic()
        out = self.backend.materialize(handle)
        dp.phase("dispatch", t_disp - t1)
        dp.phase("block", time.monotonic() - t_disp)
        dp.phase("device", self.backend.device_seconds(handle))
        self._flush_backend_bytes(dp)
        self.seconds["encode"] += t1 - t0
        self.seconds["device"] += time.monotonic() - t1
        self._observe("device", time.monotonic() - t1)
        dp.end_cycle(rec)
        self._cluster = cluster
        self._last_seq = seq_before
        self.last_materializer = None
        if self._mirror is not None:
            self._mirror.note_seeded(cold)
        return out, cluster, seq_before
