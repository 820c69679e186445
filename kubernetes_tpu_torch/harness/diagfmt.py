"""One formatter and one parser for the ``diag:`` line.

The ``diag:`` line is a row's postmortem on stderr: phase totals, the
solver session's counters, the device profiler's summary, the e2e
latency histogram, and a segment per subsystem a row ran (churn,
autoscaler, APF, SLOs, shards, mesh, pipeline, replay, ...).

- every segment is rendered here (``format_*``), so the line has one
  writer;
- ``parse_diag`` reads the current format back into a dict, and the
  older hand-written format of the repo's committed ``BENCH_r*`` tails;
- the e2e bucket text comes from the metrics registry's histogram
  accessors (``bucket_counts`` and the interpolated ``quantile``), the
  series ``/metrics`` exposes, so the line and a scrape agree.

The strings equal the JAX package's ``harness/diagfmt.py`` character for
character, so one parser reads either package's rows.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# formatters (one writer for every diag segment)


def format_phases(stats: Dict[str, dict]) -> List[str]:
    """Tracer phase stats → ``solve.commit=4.32s/8~p99 540ms`` segments
    (``stats`` is ``Tracer.phase_stats()``)."""
    return [
        f"{phase}={s['total_s']:.2f}s/{s['count']}"
        f"~p99 {s['p99_s'] * 1000:.0f}ms"
        for phase, s in sorted(stats.items())
    ]


def format_hist_segments(hist) -> List[str]:
    """Fallback phase segments from the solver-segment histogram when
    the tracer is off (the A/B's off arm): ``device=1.34s/14``."""
    return [
        f"{labels[0]}={total_sum:.2f}s/{count}"
        for _name, labels, total_sum, count in sorted(hist.collect())
    ]


def format_session(session, chunk: int, max_cycle_s: float,
                   pad_warms: int) -> str:
    """The solver-session counters segment (mirror validity + tuner)."""
    return (f"session[hits={session.incremental_hits} "
            f"rebuilds={session.rebuilds} "
            f"state_only={session.state_only_rebuilds}] "
            f"chunk={chunk} "
            f"max_cycle={max_cycle_s:.2f}s "
            f"pad_warms={pad_warms}")


def format_devprof(summary: dict) -> str:
    """Device-profiler segment from ``DevProfiler.summary()``: compile
    ledger, dispatch-vs-block split, pad waste, transfer volume, and
    the slowest cycle's dominant phase."""
    parts = [
        f"cycles={summary['cycles']}",
        f"compiles={summary['compiles']}",
        f"unexpected={summary['unexpected_compiles']}",
        f"warm={summary['warm_compiles']}",
        f"wait_share={summary['device_wait_share']:.2f}",
        f"pad_waste={summary['pad_waste_pct']:.1f}%",
        f"h2d_mb={summary['h2d_bytes'] / 1e6:.1f}",
        f"d2h_mb={summary['d2h_bytes'] / 1e6:.1f}",
    ]
    mc = summary.get("max_cycle")
    if mc:
        parts.append(f"max_cycle_phase={max_cycle_phase(mc)}")
    if summary.get("donated_bytes"):
        # bytes donated device-resident buffers kept OFF the link this
        # window — printed only when the sharded donation path ran
        parts.append(f"donated_mb={summary['donated_bytes'] / 1e6:.1f}")
    parts.append(f"detector={summary['compile_detector']}")
    return "devprof[" + " ".join(parts) + "]"


def max_cycle_phase(max_cycle: dict) -> str:
    """Which phase made the slowest cycle slow — the first question
    every blown p99 asks. A cycle that compiled answers ``compile``
    regardless of the split (the compile IS the story)."""
    if max_cycle.get("compiles"):
        return "compile"
    phases = {k[:-2]: max_cycle.get(k, 0.0)
              for k in ("encode_s", "dispatch_s", "block_s")}
    return max(phases, key=phases.get) if any(phases.values()) else "none"


def format_slo(evaluation: dict) -> str:
    """The ``slo[...]`` segment from an ``SLOEngine.evaluate()`` dict,
    emitted ONLY when an objective is violated (mirrors the ``apf``
    segment's quiet-row convention — a green row prints nothing).
    Names every violated SLO and carries the worst offender's burn
    rates so a red row is attributable from the line alone."""
    slos = (evaluation or {}).get("slos") or {}
    bad = {n: s for n, s in slos.items() if s.get("violated")}
    if not bad:
        return ""
    worst_name = max(bad, key=lambda n: bad[n].get("burn_fast", 0.0))
    worst = bad[worst_name]
    parts = [
        "violated=" + ",".join(sorted(bad)),
        f"worst={worst_name}",
        f"burn_fast={worst.get('burn_fast', 0.0):.1f}",
        f"burn_slow={worst.get('burn_slow', 0.0):.1f}",
        f"budget={worst.get('budget_remaining_pct', 0.0):.1f}%",
    ]
    alerting = sorted(n for n, s in bad.items() if s.get("alerting"))
    if alerting:
        parts.append("alerting=" + ",".join(alerting))
    return "slo[" + " ".join(parts) + "]"


def format_shards(info: Dict) -> str:
    """The partitioned-control-plane segment: topology (partitions ×
    scheduler replicas), conflict ledger (same-pod CAS losses +
    capacity-guard refusals, all resolved by the stale-commit path),
    and the partition balance ratio (min/max objects per partition —
    1.0 is perfectly even). Emitted by the scale harness whenever the
    row ran sharded; parsed by the generic bracket scan in
    ``parse_diag`` (key ``shards``)."""
    if not info:
        return ""
    parts = [
        f"partitions={int(info.get('partitions', 1))}",
        f"replicas={int(info.get('replicas', 1))}",
        f"conflicts={int(info.get('conflicts', 0))}",
        f"capacity_rejects={int(info.get('capacity_rejects', 0))}",
    ]
    if info.get("balance") is not None:
        parts.append(f"balance={float(info['balance']):.2f}")
    if info.get("watch_streams") is not None:
        parts.append(f"watch_streams={int(info['watch_streams'])}")
    return "shards[" + " ".join(parts) + "]"


def format_mesh(info: Optional[Dict]) -> str:
    """The sharded-solve segment: mesh width (``devices``), node-axis
    shard count (``shards``), and whether the solve donates its state
    buffers (``donated`` 1/0). Emitted by bench rows whenever the
    session's ACTIVE backend is the mesh tier (``TPUBatchScheduler
    .mesh_info``); parsed by the generic bracket scan in ``parse_diag``
    (key ``mesh``) — tools/perf_report.py reads it to attribute a
    devscale regression to mesh shape or a donation regression."""
    if not info:
        return ""
    parts = [
        f"devices={int(info.get('devices', 1))}",
        f"shards={int(info.get('shards', 1))}",
        f"donated={1 if info.get('donated') else 0}",
    ]
    return "mesh[" + " ".join(parts) + "]"


def format_pipeline(info: Optional[Dict]) -> str:
    """The streaming-scheduler segment: pipeline depth (how many
    batches were in flight at once — drain/encode N+1, solve N, commit
    N−1 — max observed over the row) and the overlap share (fraction of
    the in-flight device window hidden under host work; 0.0 = the old
    barrier, 1.0 = the materializer never waited). Emitted by bench
    rows whenever the batch path ran with the pipeline enabled; parsed
    by the generic bracket scan in ``parse_diag`` (key ``pipeline``) —
    tools/perf_report.py reads it to attribute a sustained-arrival
    regression to lost overlap."""
    if not info:
        return ""
    parts = [
        f"depth={int(info.get('depth', 0))}",
        f"overlap={float(info.get('overlap', 0.0)):.2f}",
    ]
    if info.get("cycles") is not None:
        parts.append(f"cycles={int(info['cycles'])}")
    return "pipeline[" + " ".join(parts) + "]"


def format_replay(info: Optional[Dict]) -> str:
    """The trace-replay segment: which family ran, the offered
    open-loop arrival rate, the arrival→bind p99 (the latency a
    submitting user experiences), the preemption ledger, and the gang
    atomicity verdict (``gangs_intact`` 1/0 — 1 also when the trace
    carried no gangs). Emitted by every replay row/cell; parsed by the
    generic bracket scan in ``parse_diag`` (key ``replay``) —
    tools/perf_report.py reads it to gate the ``replay_*`` families."""
    if not info:
        return ""
    parts = [
        f"family={info.get('family', '?')}",
        f"rate={float(info.get('rate', 0.0)):.1f}",
        f"p99_arrival_to_bind="
        f"{float(info.get('p99_arrival_to_bind_ms', 0.0)):.0f}ms",
        f"preempted={int(info.get('preempted', 0))}",
        f"gangs_intact={1 if info.get('gangs_intact', True) else 0}",
    ]
    if info.get("lost") is not None:
        parts.append(f"lost={int(info['lost'])}")
    if info.get("expired") is not None:
        parts.append(f"expired={int(info['expired'])}")
    if info.get("inversions") is not None:
        parts.append(f"inversions={int(info['inversions'])}")
    return "replay[" + " ".join(parts) + "]"


def format_reshard(info: Optional[Dict]) -> str:
    """The elastic-control-plane segment: how many slice migrations the
    row performed (``moves`` — splits, moves, merges, failovers), the
    cumulative freeze-window time (``frozen_ms`` — the bounded
    unavailability the migrations cost), the topology epoch the row
    ended at, and ``lost_watches`` (informer-vs-server-truth delta at
    quiesce — MUST be 0; printed so a red row is attributable from the
    line alone). Emitted by the hotspot bench and reshard chaos cells;
    parsed by the generic bracket scan in ``parse_diag`` (key
    ``reshard``) — tools/perf_report.py reads it to gate the
    ``hotspot`` family."""
    if not info:
        return ""
    parts = [
        f"moves={int(info.get('moves', 0))}",
        f"frozen_ms={float(info.get('frozen_ms', 0.0)):.1f}",
        f"epoch={int(info.get('epoch', 0))}",
        f"lost_watches={int(info.get('lost_watches', 0))}",
    ]
    return "reshard[" + " ".join(parts) + "]"


def format_upgrade(info: Optional[Dict]) -> str:
    """The rolling-upgrade segment: how many processes the roll cycled
    (``rolled`` — partitions plus scheduler replicas, each exactly
    once), the widest per-partition write-freeze window
    (``frozen_ms_max`` — the bounded unavailability any one slice paid
    for its restart), ``reneg`` (codec re-negotiations observed by
    clients riding the seams — proof the mixed-version wire guard was
    exercised, not bypassed), and the two MUST-be-zero counters:
    ``lost`` (lost pods plus lost/duplicated watch events) and
    ``relists`` (relists of slices whose partition did not move).
    Emitted by the upgrade row and the upgrade chaos cells; parsed by
    the generic bracket scan in ``parse_diag`` (key ``upgrade``) —
    tools/perf_report.py reads it to gate the ``upgrade_flags``
    family."""
    if not info:
        return ""
    parts = [
        f"rolled={int(info.get('rolled', 0))}",
        f"frozen_ms_max={float(info.get('frozen_ms_max', 0.0)):.1f}",
        f"reneg={int(info.get('reneg', 0))}",
        f"lost={int(info.get('lost', 0))}",
        f"relists={int(info.get('relists', 0))}",
    ]
    return "upgrade[" + " ".join(parts) + "]"


def format_federation(info: Optional[Dict]) -> str:
    """The federation segment: fleet width (``clusters``), how many
    pods the saturation path steered off their home cluster
    (``spilled``), how many whole-cluster failovers fired
    (``failovers``), the MUST-be-zero fleet-wide ``lost`` counter, and
    the failover ``recovery`` ratio (share of the dead cell's unbound
    pods re-bound on survivors inside the recovery budget; 1.0 when no
    cluster died). Emitted by the federation rows and chaos cells;
    parsed by the generic bracket scan in ``parse_diag`` (key
    ``federation``) — tools/perf_report.py reads it to gate the
    ``federation_flags`` family."""
    if not info:
        return ""
    parts = [
        f"clusters={int(info.get('clusters', 0))}",
        f"spilled={int(info.get('spilled', 0))}",
        f"failovers={int(info.get('failovers', 0))}",
        f"lost={int(info.get('lost', 0))}",
        f"recovery={float(info.get('recovery', 0.0)):.2f}",
    ]
    return "federation[" + " ".join(parts) + "]"


def format_readtier(info: Optional[Dict]) -> str:
    """The read-tier segment: how wide the tier ran (``replicas``),
    how many list+watch streams rode it (``streams``), the worst
    replica's replication-lag p99 (``lag_p99_ms`` — the staleness the
    fence state machine judges against the lag budget), how many fence
    trips fired (``fenced`` — a replica past budget self-severing its
    readers), and ``relists`` (MUST be zero outside a killed or fenced
    process — the watch contract's confinement counter). Emitted by
    the watch-herd rows and the readtier chaos cells; parsed by the
    generic bracket scan in ``parse_diag`` (key ``readtier``) —
    tools/perf_report.py reads it to gate the ``readtier_flags``
    family."""
    if not info:
        return ""
    parts = [
        f"replicas={int(info.get('replicas', 0))}",
        f"streams={int(info.get('streams', 0))}",
        f"lag_p99_ms={float(info.get('lag_p99_ms', 0.0)):.1f}",
        f"fenced={int(info.get('fenced', 0))}",
        f"relists={int(info.get('relists', 0))}",
    ]
    return "readtier[" + " ".join(parts) + "]"


def format_mirror(info: Optional[Dict]) -> str:
    """The device-resident cluster-state segment: how many watch-event
    deltas the mirror scattered into the donated planes (``events``),
    the link cost of those index/value triples (``scatter_mb`` — the
    only per-event h2d the mirror path pays), the surviving per-cycle
    encode share (``encode_share`` — host encode + pack over the phase
    total; near zero on a sustained row), and
    ``reseeds`` (journal gaps, inexpressible deltas, or topology churn
    forcing a full host rebuild — a sustained row should show none
    after warmup). Emitted by bench rows whenever the session carries a
    mirror (``KTPU_MIRROR`` on AND a backend with scatter hooks);
    parsed by the generic bracket scan in ``parse_diag`` (key
    ``mirror``) — tools/perf_report.py reads it to gate the
    ``mirror_flags`` family."""
    if not info:
        return ""
    parts = [
        f"events={int(info.get('events', 0))}",
        f"scatter_mb={float(info.get('scatter_mb', 0.0)):.3f}",
    ]
    if info.get("encode_share") is not None:
        parts.append(f"encode_share={float(info['encode_share']):.4f}")
    parts.append(f"reseeds={int(info.get('reseeds', 0))}")
    return "mirror[" + " ".join(parts) + "]"


def format_critpath(info: Optional[Dict]) -> str:
    """The fleet critical-path segment: which phase owns the sampled
    pods' end-to-end latency (``top``/``share``), how much of the
    summed in-flight windows no phase span covers (``unattributed`` —
    the tracing gap, not a scheduling cost), and the worst clock-skew
    bound the cross-process merge carried (``skew_ms`` — how far two
    processes' spans may really be apart). Emitted by bench rows
    whenever the row collected a fleet trace (the ``critical_path``
    sub-object); parsed by the generic bracket scan in ``parse_diag``
    (key ``critpath``) — tools/perf_report.py reads it to gate the
    ``critpath_flags`` family."""
    if not info or not info.get("pods"):
        return ""
    parts = [
        f"top={info.get('top') or 'none'}",
        f"share={float(info.get('top_share', 0.0)):.2f}",
        f"unattributed={float(info.get('unattributed_share', 0.0)):.2f}",
        f"skew_ms={float(info.get('max_skew_ms', 0.0)):.1f}",
    ]
    if info.get("seam_windows"):
        parts.append(f"seams={int(info['seam_windows'])}")
    return "critpath[" + " ".join(parts) + "]"


def format_e2e(hist, label: str = "scheduled") -> List[str]:
    """E2e latency segments rendered from the metrics-registry
    histogram itself: interpolated p99 (``quantile``) plus the legacy
    bucket text (``bucket_counts``) — one series, two renderings."""
    counts = hist.bucket_counts(label)
    if not counts or not any(counts):
        return []
    p99 = hist.quantile(0.99, label)
    edges = list(hist.buckets) + ["inf"]
    nonzero = [f"<={edges[i]}:{c}" for i, c in enumerate(counts) if c]
    return [f"e2e[p99={p99 * 1000:.0f}ms]",
            "e2e_buckets[" + " ".join(nonzero) + "]"]


def format_diag(segments: List[str]) -> str:
    """The full line (bench.py prints this to stderr, indented so the
    captured tail keeps it attached to its row)."""
    return "    diag: " + " ".join(s for s in segments if s)


# ---------------------------------------------------------------------------
# parser (handles the current format AND the committed legacy artifacts)

_BRACKET_RE = re.compile(r"(\w+)\[([^\]]*)\]")
_PHASE_RE = re.compile(
    r"([\w.]+)=([0-9.]+)s/(\d+)(?:~p99\s+([0-9.]+)ms)?")
_SCALAR_RE = re.compile(r"([\w.]+)=([^\s\[\]]+)")
_BUCKET_RE = re.compile(r"<=([0-9.a-z]+):(\d+)")


def _coerce(value: str):
    """Numeric coercion with unit stripping (ms/s/%/plain)."""
    for suffix, scale in (("ms", 1.0), ("s", 1.0), ("%", 1.0), ("", 1.0)):
        if suffix and not value.endswith(suffix):
            continue
        body = value[: len(value) - len(suffix)] if suffix else value
        try:
            num = float(body) * scale
            return int(num) if num.is_integer() and "." not in body \
                else num
        except ValueError:
            continue
    return value


def _parse_kv(body: str) -> dict:
    return {k: _coerce(v) for k, v in _SCALAR_RE.findall(body)}


def parse_diag(line: str) -> Optional[dict]:
    """Parse one ``diag:`` line into a structured dict, or None when
    the line is not a diag line. Keys (all optional): ``phases``
    (name → total_s/count/p99_ms), ``session``, ``chunk``,
    ``max_cycle_s``, ``pad_warms``, ``devprof``, ``churn``,
    ``autoscaler``, ``apf``, ``slo``, ``shards``, ``mesh``,
    ``replay``, ``pipeline``, ``e2e_p99_ms``, ``e2e_buckets``
    (upper-edge str → count). Handles both the current diagfmt output
    and the legacy hand-rolled format in committed BENCH_r* tails."""
    marker = "diag:"
    idx = line.find(marker)
    if idx < 0:
        return None
    body = line[idx + len(marker):].strip()
    out: dict = {}
    # bracket segments first (their contents must not leak into the
    # flat phase/scalar scan below)
    for name, inner in _BRACKET_RE.findall(body):
        if name == "e2e_buckets":
            out["e2e_buckets"] = {
                edge: int(c) for edge, c in _BUCKET_RE.findall(inner)
            }
        elif name == "e2e":
            kv = _parse_kv(inner)
            if "p99" in kv:
                out["e2e_p99_ms"] = float(kv["p99"])
        else:
            out[name] = _parse_kv(inner)
    flat = _BRACKET_RE.sub(" ", body)
    phases: dict = {}
    for name, total, count, p99 in _PHASE_RE.findall(flat):
        phases[name] = {"total_s": float(total), "count": int(count)}
        if p99:
            phases[name]["p99_ms"] = float(p99)
    if phases:
        out["phases"] = phases
    flat = _PHASE_RE.sub(" ", flat)
    for key, value in _SCALAR_RE.findall(flat):
        if key in ("chunk", "pad_warms"):
            out[key] = int(float(value))
        elif key == "max_cycle":
            out["max_cycle_s"] = float(value.rstrip("s"))
        elif key == "tracer":
            out["tracer"] = value
    return out or None


def parse_diag_lines(text: str) -> List[dict]:
    """Every diag line in a blob (e.g. a captured stdout tail),
    in order."""
    out = []
    for line in text.splitlines():
        parsed = parse_diag(line)
        if parsed is not None:
            out.append(parsed)
    return out
