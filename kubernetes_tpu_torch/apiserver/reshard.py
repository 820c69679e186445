"""ReshardCoordinator: live partition migration over the REST fabric.

The multi-process half of the elastic control plane. The in-process
``PartitionedStore`` migrates slices under its own locks; a REAL
deployment runs one apiserver process per partition, so the same
freeze → copy → flip → evict protocol has to be driven over the wire
through each server's ``/debug/partition`` admin surface:

1. **freeze** the moving slots on their source servers (writes to the
   slice answer 429 + computed Retry-After through the APF envelope —
   clients pause, nothing is dropped);
2. **copy** the slice out (``slice`` op, RVs preserved) and **adopt**
   it into the destination (the silent placement channel: no watch
   events, WAL-logged for failover);
3. **flip**: install the successor topology (epoch + 1) — destinations
   FIRST (so the first server to answer the new epoch can serve it),
   sources second (ending their ownership while the freeze still
   covers the slice — there is never a moment with two owners), then
   bystanders;
4. **evict** the source copies after a short grace (an in-flight
   fan-in list that chose its partition set pre-flip still finds the
   objects; dict-keyed consumers collapse the transient duplicate).

Crash discipline (the chaos suite's subject): every step is
idempotent-or-rollbackable. A destination that dies mid-copy → the
coordinator unfreezes the sources and evicts any orphan copies
(rollback; the old topology never stopped being true). A source that
dies after the flip → the committed topology stands; ``resolve()``
pushes the max epoch everywhere and ``evict_unowned`` clears orphans
when the corpse restarts from its WAL. The routing table is therefore
never torn: ownership changes only at the flip, and the flip is a
single epoch-guarded document install per server.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.apiserver.partition import PartitionTopology


class ReshardError(RuntimeError):
    """A migration step failed; the coordinator rolled back (or the
    failure happened after the flip, in which case the migration is
    COMMITTED and ``resolve()`` finishes the cleanup)."""

    def __init__(self, message: str, committed: bool = False):
        super().__init__(message)
        self.committed = committed


class ReshardCoordinator:
    """Drives slice migrations across a fleet of partition apiservers
    through a control-plane ``RestClusterClient``."""

    def __init__(self, client, freeze_eta: float = 5.0,
                 evict_grace_s: float = 0.25):
        self.client = client
        self.freeze_eta = float(freeze_eta)
        self.evict_grace_s = float(evict_grace_s)
        self.reports: List[dict] = []

    # -- admin plumbing ------------------------------------------------
    def _admin(self, partition: int, payload: dict) -> dict:
        code, resp = self.client._request(
            "POST", "/debug/partition", payload, body_binary=False,
            partition=partition)
        if code != 200:
            msg = resp.get("message") if isinstance(resp, dict) else resp
            raise ReshardError(
                f"partition {partition} admin op "
                f"{payload.get('op')!r} failed: HTTP {code} {msg}")
        return resp

    def _admin_get(self, partition: int) -> dict:
        code, resp = self.client._request(
            "GET", "/debug/partition", partition=partition)
        if code != 200:
            raise ReshardError(
                f"partition {partition} admin GET failed: HTTP {code}")
        return resp

    @staticmethod
    def _seam(name: str, t0: float, epoch: int, **attrs) -> None:
        """Record a first-class seam span into the fleet timeline
        (trace id ``seam:<epoch>``): the critical-path pass folds these
        windows into any sampled pod whose in-flight time overlaps
        them, so a queue.wait that straddles a freeze names the freeze
        instead of showing up as unattributed stall."""
        try:
            from kubernetes_tpu_torch.observability import get_tracer

            get_tracer().record(name, t0, trace=f"seam:{epoch}",
                                **attrs)
        except Exception:  # noqa: BLE001 — tracing must not fail a flip
            pass

    def stats(self) -> List[dict]:
        """Best-effort per-partition admin stats (the rebalancer's
        load feed over REST). Dead partitions report ``alive: False``
        — the failover trigger."""
        out = []
        for p in range(len(self.client.partition_urls)):
            try:
                got = self._admin_get(p)
                got["alive"] = True
            except Exception as e:  # noqa: BLE001 — dead partition
                got = {"partition": p, "alive": False,
                       "error": str(e)[:200]}
            out.append(got)
        return out

    def fetch_topology(self) -> PartitionTopology:
        """The committed topology: max epoch across live endpoints
        (a partially-flipped fleet answers with the newest — epoch
        installs are monotonic, so max is the one that won)."""
        best: Optional[PartitionTopology] = None
        last_err: Optional[Exception] = None
        for p in range(len(self.client.partition_urls)):
            try:
                # probe, not a request: a dead endpoint (the failover
                # this fetch serves) must cost one refused connect, not
                # a full retry-backoff ladder inside the outage window
                code, doc = self.client._request(
                    "GET", "/api/v1/partitiontopology", partition=p,
                    retries=0)
            except Exception as e:  # noqa: BLE001 — dead endpoint
                last_err = e
                continue
            if code != 200 or "owner" not in doc:
                continue
            topo = PartitionTopology.from_dict(doc)
            if best is None or topo.epoch > best.epoch:
                best = topo
        if best is None:
            raise ReshardError(
                f"no endpoint served a live topology ({last_err})")
        return best

    def install_topology(self, topo: PartitionTopology,
                         order: Optional[List[int]] = None,
                         strict: bool = True) -> List[int]:
        """Install ``topo`` on every (listed) server, returning the
        indices that accepted. ``strict`` raises on the first failure
        (mid-migration flip); non-strict is resolve()'s best-effort."""
        doc = topo.to_dict()
        targets = order if order is not None \
            else list(range(len(topo.urls or self.client.partition_urls)))
        done: List[int] = []
        for p in targets:
            try:
                self._admin(p, {"op": "topology", "topology": doc})
                done.append(p)
            except Exception as e:  # noqa: BLE001
                if strict:
                    raise ReshardError(
                        f"topology install failed on partition {p}: {e}",
                        committed=bool(done)) from e
        return done

    # -- the protocol --------------------------------------------------
    def _freeze(self, by_src: Dict[int, List[int]], eta: float) -> None:
        """Freeze each source's slots. A source answers once the writes
        it let through before the freeze have answered; one that could
        not drain them within ``eta`` aborts the freeze (every source
        thawed, ``ReshardError``): a copy taken now could miss them."""
        for src, slots in by_src.items():
            got = self._admin(src, {"op": "freeze", "slots": slots,
                                    "eta": eta})
            if got.get("drained") is False:
                self._unfreeze(by_src)
                raise ReshardError(
                    f"partition {src} did not drain its in-flight writes "
                    f"within the freeze budget ({eta} s)")

    def _unfreeze(self, by_src: Dict[int, List[int]]) -> None:
        for src, slots in by_src.items():
            try:
                self._admin(src, {"op": "unfreeze", "slots": slots})
            except Exception:  # noqa: BLE001 — freeze auto-thaws at eta
                pass

    def _verify_frozen(self, by_src: Dict[int, List[int]]) -> None:
        """Pre-flip guard: every moving slot must STILL be frozen on
        its source. A copy that outlived the freeze budget thawed
        writers back into the slice — flipping now would lose whatever
        they wrote since the copy. Abort (rollback) instead: the old
        topology never stopped being true, and the caller retries with
        a bigger budget."""
        for src, slots in by_src.items():
            got = self._admin_get(src)
            frozen_now = {int(s) for s in got.get("frozen") or ()}
            missing = [s for s in slots if s not in frozen_now]
            if missing:
                raise ReshardError(
                    f"freeze expired on partition {src} slots "
                    f"{missing} before the flip — aborting (copy "
                    f"outlived the freeze budget; retry with a "
                    f"larger freeze_eta)")

    def _copy(self, topo: PartitionTopology,
              new_topo: PartitionTopology,
              by_src: Dict[int, List[int]],
              namespace: Optional[str] = None,
              kill_hook=None) -> Tuple[int, Dict[int, Dict[str, list]],
                                       Dict[int, Dict[str, list]]]:
        """slice + adopt. Returns (moved, adopted_by_dest (wire),
        evict_keys_by_src). Slot membership is judged under the NEW
        topology's spread — a split cuts exactly where the new routing
        will read."""
        moved = 0
        adopted: Dict[int, Dict[str, list]] = {}
        evict: Dict[int, Dict[str, list]] = {}
        for src, slots in by_src.items():
            got = self._admin(src, {
                "op": "slice", "slots": slots,
                "spread": sorted(new_topo.spread),
                "slot_count": new_topo.slots,
                "namespace": namespace,
            })
            for kind, wires in (got.get("objects") or {}).items():
                for w in wires:
                    meta = w.get("metadata") or {}
                    ns, name = meta.get("namespace"), meta.get("name")
                    dest = new_topo.partition_of(kind, ns, name)
                    if dest == src:
                        continue
                    adopted.setdefault(dest, {}).setdefault(
                        kind, []).append(w)
                    evict.setdefault(src, {}).setdefault(
                        kind, []).append([ns, name])
                    moved += 1
        if kill_hook is not None:
            kill_hook("copied")   # chaos seam: crash after copy
        for dest, objmap in adopted.items():
            self._admin(dest, {"op": "adopt", "objects": objmap})
        return moved, adopted, evict

    def _rollback(self, by_src: Dict[int, List[int]],
                  adopted: Dict[int, Dict[str, list]]) -> None:
        """Undo a failed (pre-flip) migration: drop any orphan copies
        from reachable destinations, thaw the sources. The old
        topology never stopped being the committed one."""
        for dest, objmap in adopted.items():
            keys = {kind: [[w["metadata"].get("namespace"),
                            w["metadata"].get("name")] for w in ws]
                    for kind, ws in objmap.items()}
            try:
                self._admin(dest, {"op": "evict", "keys": keys})
            except Exception:  # noqa: BLE001 — dead dest: its WAL
                pass           # restart runs evict_unowned via resolve()
        self._unfreeze(by_src)

    def _run_migration(self, topo: PartitionTopology,
                       new_topo: PartitionTopology,
                       by_src: Dict[int, List[int]],
                       reason: str,
                       namespace: Optional[str] = None,
                       freeze_eta: Optional[float] = None,
                       kill_hook=None) -> dict:
        eta = freeze_eta if freeze_eta is not None else self.freeze_eta
        t0 = time.monotonic()
        self._freeze(by_src, eta)
        adopted: Dict[int, Dict[str, list]] = {}
        try:
            moved, adopted, evict = self._copy(
                topo, new_topo, by_src, namespace=namespace,
                kill_hook=kill_hook)
            # FLIP: destinations first, sources second (their freeze
            # still covers the slice — no double-ownership window),
            # bystanders last
            all_parts = list(range(len(new_topo.urls
                                       or self.client.partition_urls)))
            dests = [p for p in adopted if p not in by_src]
            srcs = list(by_src)
            rest = [p for p in all_parts
                    if p not in dests and p not in srcs]
            if kill_hook is not None:
                kill_hook("pre_flip")   # chaos seam: crash before flip
            self._verify_frozen(by_src)
            t_flip = time.monotonic()
            self.install_topology(new_topo, order=dests + srcs + rest)
            self._seam("reshard.flip", t_flip, new_topo.epoch,
                       reason=reason)
        except ReshardError as e:
            if not getattr(e, "committed", False):
                self._rollback(by_src, adopted)
                self._seam("reshard.rollback", t0, new_topo.epoch,
                           reason=reason)
                raise
            # flip partially landed: the new epoch exists somewhere —
            # the migration IS committed; finish via resolve()
            self.resolve(new_topo)
            raise
        except Exception:
            self._rollback(by_src, adopted)
            self._seam("reshard.rollback", t0, new_topo.epoch,
                       reason=reason)
            raise
        frozen_ms = (time.monotonic() - t0) * 1000.0
        self._unfreeze(by_src)   # install already dropped non-owned
        self._seam("reshard.freeze", t0, new_topo.epoch, reason=reason,
                   frozen_ms=round(frozen_ms, 3))
        if self.evict_grace_s > 0 and evict:
            time.sleep(self.evict_grace_s)
        evict_failures = {}
        for src, keys in evict.items():
            try:
                self._admin(src, {"op": "evict", "keys": keys})
            except Exception as e:  # noqa: BLE001 — resolve() can
                evict_failures[src] = f"{type(e).__name__}: {e}"[:300]
        # hand the coordinator's own client the new routing NOW (its
        # poller would also catch it; this avoids one stale round)
        try:
            self.client.apply_topology(new_topo)
        except Exception:  # noqa: BLE001
            pass
        report = {
            "reason": reason,
            "epoch": new_topo.epoch,
            "moved_objects": moved,
            "frozen_slots": sorted(s for ss in by_src.values()
                                   for s in ss),
            "frozen_ms": round(frozen_ms, 3),
        }
        if evict_failures:
            report["evict_failed"] = evict_failures
        self.reports.append(report)
        return report

    # -- operations ----------------------------------------------------
    def move_slots(self, assignments: Dict[int, int],
                   freeze_eta: Optional[float] = None,
                   kill_hook=None) -> dict:
        """MOVE hash slots to new owners ({slot: dest})."""
        topo = self.fetch_topology()
        owner = list(topo.owner)
        by_src: Dict[int, List[int]] = {}
        for slot, dest in assignments.items():
            if owner[slot] != dest:
                by_src.setdefault(owner[slot], []).append(int(slot))
                owner[slot] = int(dest)
        if not by_src:
            return {"reason": "move", "epoch": topo.epoch,
                    "moved_objects": 0, "frozen_slots": [],
                    "frozen_ms": 0.0}
        return self._run_migration(
            topo, topo.evolve(owner=owner), by_src, "move",
            freeze_eta=freeze_eta, kill_hook=kill_hook)

    def spread_namespace(self, namespace: str,
                         freeze_eta: Optional[float] = None,
                         kill_hook=None) -> dict:
        """SPLIT a hot namespace: its pods re-slot by (namespace,
        name), fanning one tenant across every partition."""
        topo = self.fetch_topology()
        if namespace in topo.spread:
            return {"reason": "split", "epoch": topo.epoch,
                    "moved_objects": 0, "frozen_slots": [],
                    "frozen_ms": 0.0}
        old_slot = topo.slot_of("Pod", namespace, None)
        src = topo.owner[old_slot]
        new_topo = topo.evolve(spread=topo.spread | {namespace})
        # the frozen slice is the namespace's OLD slot; the copy is
        # namespace-scoped and judged under the NEW spread
        return self._run_split(topo, new_topo, src, old_slot,
                               namespace, freeze_eta, kill_hook)

    def _run_split(self, topo, new_topo, src, old_slot, namespace,
                   freeze_eta, kill_hook) -> dict:
        """Split copy: the slice is 'every pod of the namespace whose
        NEW slot leaves src' — slice op scoped by namespace across all
        slots (the namespace's objects all live on src today)."""
        eta = freeze_eta if freeze_eta is not None else self.freeze_eta
        t0 = time.monotonic()
        by_src = {src: [old_slot]}
        self._freeze(by_src, eta)
        adopted: Dict[int, Dict[str, list]] = {}
        try:
            got = self._admin(src, {
                "op": "slice", "slots": list(range(new_topo.slots)),
                "spread": sorted(new_topo.spread),
                "slot_count": new_topo.slots,
                "namespace": namespace,
            })
            moved = 0
            evict: Dict[str, list] = {}
            for kind, wires in (got.get("objects") or {}).items():
                for w in wires:
                    meta = w.get("metadata") or {}
                    ns, name = meta.get("namespace"), meta.get("name")
                    dest = new_topo.partition_of(kind, ns, name)
                    if dest == src:
                        continue
                    adopted.setdefault(dest, {}).setdefault(
                        kind, []).append(w)
                    evict.setdefault(kind, []).append([ns, name])
                    moved += 1
            if kill_hook is not None:
                kill_hook("copied")
            for dest, objmap in adopted.items():
                self._admin(dest, {"op": "adopt", "objects": objmap})
            all_parts = list(range(len(new_topo.urls
                                       or self.client.partition_urls)))
            dests = [p for p in adopted if p != src]
            rest = [p for p in all_parts
                    if p not in dests and p != src]
            if kill_hook is not None:
                kill_hook("pre_flip")
            self._verify_frozen(by_src)
            t_flip = time.monotonic()
            self.install_topology(new_topo, order=dests + [src] + rest)
            self._seam("reshard.flip", t_flip, new_topo.epoch,
                       reason="split")
        except ReshardError as e:
            if not getattr(e, "committed", False):
                self._rollback(by_src, adopted)
                self._seam("reshard.rollback", t0, new_topo.epoch,
                           reason="split")
                raise
            self.resolve(new_topo)
            raise
        except Exception:
            self._rollback(by_src, adopted)
            self._seam("reshard.rollback", t0, new_topo.epoch,
                       reason="split")
            raise
        frozen_ms = (time.monotonic() - t0) * 1000.0
        self._unfreeze(by_src)
        self._seam("reshard.freeze", t0, new_topo.epoch,
                   reason="split", frozen_ms=round(frozen_ms, 3))
        if self.evict_grace_s > 0 and evict:
            time.sleep(self.evict_grace_s)
        evict_failed = ""
        if evict:
            try:
                self._admin(src, {"op": "evict", "keys": evict})
            except Exception as e:  # noqa: BLE001 — resolve() can
                evict_failed = f"{type(e).__name__}: {e}"[:300]
        try:
            self.client.apply_topology(new_topo)
        except Exception:  # noqa: BLE001
            pass
        report = {"reason": "split", "epoch": new_topo.epoch,
                  "moved_objects": moved,
                  "frozen_slots": [old_slot],
                  "frozen_ms": round(frozen_ms, 3),
                  "namespace": namespace}
        if evict_failed:
            report["evict_failed"] = evict_failed
        self.reports.append(report)
        return report

    def split_to(self, new_url: str,
                 slots: Optional[List[int]] = None,
                 freeze_eta: Optional[float] = None,
                 kill_hook=None) -> dict:
        """Grow the fleet: a freshly-booted partition server at
        ``new_url`` joins the topology and receives ``slots`` (default:
        an even share, taken round-robin from the most-loaded owners).
        The buy half is the control-plane autoscaler's job; this is
        the rebalance half."""
        topo = self.fetch_topology()
        urls = list(topo.urls or self.client.partition_urls)
        new_index = len(urls)
        urls.append(new_url.rstrip("/"))
        grown = topo.evolve(partitions=new_index + 1, urls=urls)
        # the coordinator's own client must learn the new endpoint
        # BEFORE it can drive it (the grown topology assigns it no
        # slots yet, so routing is unchanged — only the pool exists)
        self.client.apply_topology(grown, replumb=False)
        # push the grown (still slot-less) topology so every server —
        # including the new one — knows the fleet shape first
        self.install_topology(grown, order=[new_index] + list(
            range(new_index)))
        if slots is None:
            counts: Dict[int, int] = {}
            for o in grown.owner:
                counts[o] = counts.get(o, 0) + 1
            want = grown.slots // (new_index + 1)
            slots = []
            owners = sorted(counts, key=counts.get, reverse=True)
            per = {o: grown.slots_of_partition(o) for o in owners}
            while len(slots) < want:
                progressed = False
                for o in owners:
                    if per[o] and counts[o] > want:
                        slots.append(per[o].pop())
                        counts[o] -= 1
                        progressed = True
                        if len(slots) >= want:
                            break
                if not progressed:
                    break
        report = self.move_slots({s: new_index for s in slots},
                                 freeze_eta=freeze_eta,
                                 kill_hook=kill_hook)
        report["reason"] = "split_partition"
        report["new_partition"] = new_index
        return report

    def retire(self, index: int,
               freeze_eta: Optional[float] = None) -> dict:
        """MERGE a partition away: its slots drain to the survivors
        and it is marked retired (traffic-free; safe to tear down)."""
        topo = self.fetch_topology()
        live = [p for p in range(topo.partitions)
                if p != index and p not in topo.retired]
        if not live:
            raise ReshardError("cannot retire the last live partition")
        owner = list(topo.owner)
        moving = [s for s, o in enumerate(owner) if o == index]
        for k, slot in enumerate(moving):
            owner[slot] = live[k % len(live)]
        new_topo = topo.evolve(owner=owner,
                               retired=topo.retired | {index})
        report = self._run_migration(
            topo, new_topo, {index: moving}, "merge",
            freeze_eta=freeze_eta)
        return report

    # -- failure handling ----------------------------------------------
    def resolve(self, topo: Optional[PartitionTopology] = None) -> dict:
        """Converge after a failure: push the committed (max-epoch)
        topology to every reachable server and clear orphan copies
        (``evict_unowned``). Idempotent; safe to call any time."""
        topo = topo or self.fetch_topology()
        installed = self.install_topology(topo, strict=False)
        evicted: Dict[int, dict] = {}
        for p in range(len(topo.urls or self.client.partition_urls)):
            try:
                got = self._admin(p, {"op": "evict_unowned"})
                if got.get("evicted"):
                    evicted[p] = got["evicted"]
            except Exception:  # noqa: BLE001 — dead partition
                pass
        try:
            self.client.apply_topology(topo)
        except Exception:  # noqa: BLE001
            pass
        return {"epoch": topo.epoch, "installed": installed,
                "evicted": evicted}

    def reroute_after_restart(self, index: int, new_url: str) -> dict:
        """FAILOVER epilogue: a dead partition came back (WAL-restored)
        at ``new_url``. Bump the epoch with the updated endpoint so
        every client re-points its streams — their known maps carry
        them across the gap with at most a diff of THAT partition's
        slice."""
        topo = self.fetch_topology()
        urls = list(topo.urls or self.client.partition_urls)
        urls[index] = new_url.rstrip("/")
        new_topo = topo.evolve(urls=urls)
        t0 = time.monotonic()
        # re-point the coordinator's OWN routing first (routing-only):
        # the install below reaches the restarted server through its
        # new endpoint instead of the corpse's
        self.client.apply_topology(new_topo, replumb=False)
        self.install_topology(new_topo, strict=False)
        got = self.resolve(new_topo)
        self._seam("reshard.reroute", t0, new_topo.epoch,
                   reason="failover", partition=index)
        report = {"reason": "failover", "partition": index,
                  "epoch": new_topo.epoch, "resolve": got}
        self.reports.append(report)
        return report
