"""Per-solve-cycle device profiling.

The session opens a cycle record around each solve; phases accumulate
into it, and it completes at ``end_cycle`` or, for a lazy solve, at the
timed materializer's ``note_block``. Per cycle it keeps:

- **compiles**: on the card, the build and load of the solve kernels'
  library, the first launch of each kernel instance (cluster, slot or
  one-block, with shared-volume planes or without; under lazy module
  loading that first launch loads the module), and the pinned staging
  ring's first allocation of a buffer capacity (a pinned allocation can
  wait for the card).
  ``ops/solve.py`` reports each where it happens (``on_compile``), and
  the cycle open on the
  launching thread takes it, keyed by the cycle's pad bucket. One inside
  a measured (not warming) cycle is an ``unexpected_compile``: a counter,
  a tracer instant and a flight-recorder dump. There is no timing
  heuristic: ``compile_detector`` reads ``"cuda"``;
- the **dispatch / block split**: host seconds of the dispatch (the
  uploads and the launch, which do not wait for the card) against the
  seconds the materializer waited, and ``overlap_s``, the host work done
  between the dispatch and that wait;
- **device seconds** (``device_s``): the time between a pair of timing
  events the backend records around each launch, read at
  materialization (never inside the dispatch);
- **transfer bytes**: the pinned ring's uploads (pod streams, plane
  uploads, scatter entries) and readbacks (assignments);
- **pad occupancy**: real rows over padded rows.

Consumers: ``metrics/solver_metrics.py`` mirrors each completed measured
cycle; ``summary()`` is a harness row's ``telemetry``;
``KTPU_TELEMETRY=<dir>`` streams one JSONL record per completed cycle.
``KTPU_DEVPROF=off`` turns the profiler off.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

_logger = logging.getLogger(__name__)

DEFAULT_MAX_CYCLES = 4096


class _Cycle(dict):
    """One solve cycle's record: plain keys for the JSONL stream, and the
    control fields as attributes. ``dispatch_end`` is the host clock when
    a lazy dispatch returned; ``note_block`` turns the gap to the wait
    into ``overlap_s``."""

    __slots__ = ("pending_block", "done", "dispatch_end")


class DevProfiler:
    """Ring-buffered per-cycle recorder; one per process
    (``get_devprof()``)."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_cycles: int = DEFAULT_MAX_CYCLES,
                 telemetry_dir: Optional[str] = None):
        if enabled is None:
            enabled = os.environ.get("KTPU_DEVPROF", "") != "off"
        self.enabled = enabled
        self._ring: deque = deque(maxlen=max_cycles)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._seq = 0
        self.workload: str = ""
        self.warm_compiles = 0          # compiles inside warming cycles
        self.warm_compile_s = 0.0
        self.unexpected_compiles = 0    # compiles inside measured cycles
        self.background_compiles = 0    # compiles with no open cycle
        self._telemetry_path: Optional[str] = None
        self._telemetry_file = None
        tdir = telemetry_dir if telemetry_dir is not None \
            else os.environ.get("KTPU_TELEMETRY") or None
        if tdir:
            try:
                os.makedirs(tdir, exist_ok=True)
                self._telemetry_path = os.path.join(
                    tdir, f"solvercycles-{os.getpid()}.jsonl")
            except OSError:
                _logger.exception("KTPU_TELEMETRY dir unusable; stream off")

    # -- cycle lifecycle ----------------------------------------------
    def begin_cycle(self, cycle: int = -1, pad: int = 0, real: int = 0,
                    warming: bool = False,
                    rebuild: str = "none") -> Optional[_Cycle]:
        """Open a cycle record on this thread: ``cycle`` is the first
        pod's scheduling cycle (the tracer's correlation key), ``pad``
        the padded batch size, ``real`` the pods in it, ``rebuild``
        "full" for a solve that rebuilt the planes."""
        if not self.enabled:
            return None
        rec = _Cycle(
            seq=self._next_seq(), wall=time.time(), workload=self.workload,
            cycle=int(cycle), pad=int(pad), real=int(real),
            warming=bool(warming), rebuild=rebuild,
            encode_s=0.0, pack_s=0.0, scatter_s=0.0, dispatch_s=0.0,
            block_s=0.0, device_s=0.0, compiles=0, compile_s=0.0,
            h2d_bytes=0, d2h_bytes=0,
            donated_bytes=0, scatter_bytes=0)
        rec.pending_block = False
        rec.done = False
        rec.dispatch_end = None
        self._local.active = rec
        self._ring.append(rec)
        return rec

    def phase(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to the open cycle's ``<name>_s``."""
        rec = getattr(self._local, "active", None)
        if rec is not None and not rec.done:
            rec[name + "_s"] += seconds

    def note_staleness(self, rec: Optional[_Cycle], seconds: float) -> None:
        """The snapshot-staleness SLI of an open cycle."""
        if rec is not None and not rec.done:
            rec["staleness_s"] = round(float(seconds), 6)

    def add_bytes(self, direction: str, n: int) -> None:
        """Account ``n`` transfer bytes (``h2d``, ``d2h``, or ``scatter``,
        the share of ``h2d`` that scatter entries took) to the open
        cycle."""
        rec = getattr(self._local, "active", None)
        if rec is not None and not rec.done:
            rec[direction + "_bytes"] += int(n)

    def end_cycle(self, rec: Optional[_Cycle],
                  pending_block: bool = False) -> None:
        """Close the open cycle; with ``pending_block`` (a lazy solve) it
        stays open for ``note_block``."""
        if rec is None:
            return
        if getattr(self._local, "active", None) is rec:
            self._local.active = None
        if pending_block:
            rec.pending_block = True
            rec.dispatch_end = time.monotonic()
            return
        self._complete(rec)

    def abort(self, rec: Optional[_Cycle]) -> None:
        """Drop an open record that describes no solve."""
        if rec is None:
            return
        rec.done = True
        if getattr(self._local, "active", None) is rec:
            self._local.active = None
        try:
            self._ring.remove(rec)
        except ValueError:
            pass

    def note_block(self, rec: Optional[_Cycle], seconds: float,
                   d2h_bytes: int = 0, start_mono: Optional[float] = None,
                   device_s: float = 0.0) -> None:
        """Complete a lazy solve's record: the materializer waited
        ``seconds`` (from ``start_mono``), read ``d2h_bytes`` back, and
        the launch's timing events measured ``device_s``. May run on
        another thread, cycles after ``end_cycle``."""
        if rec is None or rec.done:
            return
        if start_mono is not None and rec.dispatch_end is not None:
            rec["overlap_s"] = round(max(0.0, start_mono - rec.dispatch_end),
                                     6)
        rec["block_s"] += seconds
        rec["device_s"] += device_s
        rec["d2h_bytes"] += int(d2h_bytes)
        rec.pending_block = False
        self._complete(rec)

    # -- compiles -----------------------------------------------------
    def on_compile(self, seconds: float) -> None:
        """A kernel library build and load, a kernel instance's first
        launch or a staging shape's first pinned allocation took
        ``seconds`` on this thread; the cycle open here takes it, else it
        counts as background."""
        if not self.enabled:
            return
        rec = getattr(self._local, "active", None)
        if rec is None or rec.done:
            self.background_compiles += 1
            return
        rec["compiles"] += 1
        rec["compile_s"] += seconds

    # -- completion ----------------------------------------------------
    def _complete(self, rec: _Cycle) -> None:
        if rec.done:
            return
        rec.done = True
        if rec["compiles"]:
            if rec["warming"]:
                self.warm_compiles += rec["compiles"]
                self.warm_compile_s += rec["compile_s"]
            else:
                self.unexpected_compiles += rec["compiles"]
                self._flag_unexpected(rec)
        self._mirror_metrics(rec)
        self._write_jsonl(rec)

    def _flag_unexpected(self, rec: _Cycle) -> None:
        from kubernetes_tpu_torch.metrics.solver_metrics import solver_metrics
        from kubernetes_tpu_torch.observability.tracer import get_tracer

        solver_metrics().unexpected_compiles_total.inc(
            amount=rec["compiles"])
        tracer = get_tracer()
        if tracer.enabled:
            tracer.event("solve.unexpected_compile", cycle=rec["cycle"],
                         pad=rec["pad"], compile_s=round(rec["compile_s"], 4))
            tracer.dump(reason="unexpected-compile", min_interval_s=5.0)

    def _mirror_metrics(self, rec: _Cycle) -> None:
        if rec["warming"]:
            return
        from kubernetes_tpu_torch.metrics.solver_metrics import solver_metrics

        sm = solver_metrics()
        bucket = str(rec["pad"])
        if rec["compiles"]:
            sm.compiles_total.inc(bucket, amount=rec["compiles"])
            if rec["compile_s"]:
                sm.compile_seconds.observe(rec["compile_s"])
        sm.device_wait_seconds.observe(rec["block_s"])
        sm.dispatch_seconds.observe(rec["dispatch_s"])
        if rec["pad"]:
            sm.pad_occupancy_ratio.set(rec["real"] / rec["pad"], bucket)
        if rec["h2d_bytes"]:
            sm.transfer_bytes_total.inc("h2d", amount=float(rec["h2d_bytes"]))
        if rec["d2h_bytes"]:
            sm.transfer_bytes_total.inc("d2h", amount=float(rec["d2h_bytes"]))

    def _write_jsonl(self, rec: _Cycle) -> None:
        if self._telemetry_path is None:
            return
        try:
            with self._lock:
                if self._telemetry_file is None:
                    self._telemetry_file = open(self._telemetry_path, "a")
                self._telemetry_file.write(json.dumps(rec) + "\n")
                self._telemetry_file.flush()
        except OSError:
            _logger.exception("telemetry stream write failed; stream off")
            self._telemetry_path = None

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    # -- consumers -----------------------------------------------------
    def cycles(self, include_warming: bool = False) -> List[dict]:
        """Completed cycle records still in the ring, oldest first."""
        return [r for r in list(self._ring)
                if r.done and (include_warming or not r["warming"])]

    def summary(self) -> dict:
        """The measured cycles in aggregate, a row's ``telemetry``: the
        JAX package's keys, plus ``device_s`` (the launches' timing-event
        seconds)."""
        recs = self.cycles()
        out = {
            "cycles": len(recs), "compiles": 0, "compile_s": 0.0,
            "unexpected_compiles": self.unexpected_compiles,
            "warm_compiles": self.warm_compiles,
            "device_wait_share": 0.0, "overlap_share": 0.0,
            "overlap_s": 0.0, "overlapped_cycles": 0, "dispatch_s": 0.0,
            "block_s": 0.0, "device_s": 0.0, "encode_s": 0.0,
            "scatter_s": 0.0, "encode_share": 0.0, "pad_waste_pct": 0.0,
            "h2d_bytes": 0, "d2h_bytes": 0, "donated_bytes": 0,
            "scatter_bytes": 0, "compile_detector": "cuda",
        }
        if not recs:
            return out
        tot = {"encode_s": 0.0, "pack_s": 0.0, "scatter_s": 0.0,
               "dispatch_s": 0.0, "block_s": 0.0}
        real = padded = 0
        device_s = 0.0
        slowest = None
        slowest_total = -1.0
        max_staleness = None
        # overlap over the lazy cycles only: an eager cycle's wait is a
        # barrier by construction
        ov_total = ov_block = 0.0
        overlapped = 0
        for r in recs:
            for k in tot:
                tot[k] += r.get(k, 0.0)
            device_s += r["device_s"]
            ov = r.get("overlap_s")
            if ov is not None:
                ov_total += ov
                ov_block += r["block_s"]
                overlapped += 1
            out["compiles"] += r["compiles"]
            out["compile_s"] += r["compile_s"]
            out["h2d_bytes"] += r["h2d_bytes"]
            out["d2h_bytes"] += r["d2h_bytes"]
            out["donated_bytes"] += r["donated_bytes"]
            out["scatter_bytes"] += r["scatter_bytes"]
            stale = r.get("staleness_s")
            if stale is not None and (max_staleness is None
                                      or stale > max_staleness):
                max_staleness = stale
            real += r["real"]
            padded += r["pad"] if r["pad"] else r["real"]
            cycle_total = (r["encode_s"] + r["pack_s"] + r["dispatch_s"]
                           + r["block_s"] + r["compile_s"])
            if cycle_total > slowest_total:
                slowest_total, slowest = cycle_total, r
        phase_total = sum(tot.values())
        out["dispatch_s"] = round(tot["dispatch_s"], 4)
        out["block_s"] = round(tot["block_s"], 4)
        out["device_s"] = round(device_s, 6)
        out["encode_s"] = round(tot["encode_s"] + tot["pack_s"], 4)
        out["scatter_s"] = round(tot["scatter_s"], 4)
        out["compile_s"] = round(out["compile_s"], 4)
        if phase_total > 0:
            out["device_wait_share"] = round(tot["block_s"] / phase_total, 4)
            # cluster-plane builds only: the pod rows' encode books under
            # pack
            out["encode_share"] = round(tot["encode_s"] / phase_total, 4)
        out["overlap_s"] = round(ov_total, 4)
        out["overlapped_cycles"] = overlapped
        if ov_total + ov_block > 0:
            out["overlap_share"] = round(ov_total / (ov_total + ov_block), 4)
        if padded > 0:
            out["pad_waste_pct"] = round(100.0 * (1.0 - real / padded), 2)
        if max_staleness is not None:
            out["max_staleness_s"] = round(max_staleness, 4)
        if slowest is not None:
            out["max_cycle"] = {
                "cycle": slowest["cycle"],
                "total_s": round(slowest_total, 4),
                "encode_s": round(slowest["encode_s"] + slowest["pack_s"], 4),
                "dispatch_s": round(slowest["dispatch_s"], 4),
                "block_s": round(slowest["block_s"], 4),
                "compiles": slowest["compiles"],
                "rebuild": slowest["rebuild"],
            }
        return out

    def reset(self, workload: str = "") -> None:
        """A fresh window for one harness row; the ``/metrics`` series
        keep accumulating."""
        self._ring.clear()
        self._local = threading.local()
        self.workload = workload
        self.warm_compiles = 0
        self.warm_compile_s = 0.0
        self.unexpected_compiles = 0
        self.background_compiles = 0

    def configure(self, enabled: Optional[bool] = None) -> None:
        if enabled is not None:
            self.enabled = enabled

    def close(self) -> None:
        with self._lock:
            if self._telemetry_file is not None:
                try:
                    self._telemetry_file.close()
                except OSError:
                    pass
                self._telemetry_file = None


_default: Optional[DevProfiler] = None
_default_lock = threading.Lock()


def get_devprof() -> DevProfiler:
    """The process-wide device profiler (``KTPU_DEVPROF=off`` disables
    it; ``KTPU_TELEMETRY=<dir>`` streams its cycles)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = DevProfiler()
    return _default


def set_devprof(prof: DevProfiler) -> DevProfiler:
    global _default
    _default = prof
    return prof
