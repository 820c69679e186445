"""Multi-process metrics federation: scrape, parse, merge.

The REST harness spawns real child processes (the apiserver, the
creators) and each keeps its own metrics registry. Besides the
APF-specific ``/debug/apf`` JSON side channel mirrored by
``apf_metrics().absorb_snapshot``, one hand-written mapping per metric
family, this module is the generic path (the Prometheus federation
pattern):

- ``parse_exposition`` parses the Prometheus text format our own
  ``MetricsRegistry.expose`` renders (counters, gauges, full histograms
  with ``_bucket{le=...}`` lines) into structured families —
  ``parse(expose(x)) ≡ x``, so exposition drift cannot silently break
  scraping;
- ``MetricsFederation`` pulls ``/metrics`` from every component and
  merges the families into ONE registry with an ``instance`` label
  prepended (last scrape wins per instance, Prometheus sample
  semantics — repeated scrapes never double-count);
- ``fold=True`` additionally folds a remote instance's COUNTER families
  into this process's same-name counters by cumulative delta (with
  counter-reset detection for restarted children), which lets the
  harness read its usual local series for remote-server rows without
  one absorb function per family.

The merged view lives in the federation's own registry rather than the
process default registry: both processes run the same code, so every
child family name collides with a live local metric of a DIFFERENT
label shape — ``federation_registry().expose()`` is the cluster-wide
exposition, the default registry stays this process's own truth.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.metrics.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class ExpositionError(ValueError):
    """Malformed Prometheus text exposition."""


def _unescape(value: str) -> str:
    """Single left-to-right pass (sequential str.replace would decode
    an escaped backslash followed by 'n' — ``\\\\n`` on the wire, a
    literal backslash then the letter — as a newline)."""
    if "\\" not in value:
        return value
    out = []
    i = 0
    n = len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


@dataclass
class HistSeries:
    """One histogram series reconstructed from its exposition lines:
    per-bucket (upper edge, NON-cumulative count) pairs ordered by
    edge with the ``+Inf`` overflow last, plus sum/count."""

    bucket_edges: Tuple[float, ...] = ()     # finite edges only
    bucket_counts: List[int] = field(default_factory=list)
    sum: float = 0.0
    count: int = 0


@dataclass
class Family:
    name: str
    type: str = "untyped"
    help: str = ""
    label_names: Tuple[str, ...] = ()
    # counter/gauge: labels tuple -> value
    samples: Dict[Tuple[str, ...], float] = field(default_factory=dict)
    # histogram: labels tuple (without "le") -> HistSeries
    histograms: Dict[Tuple[str, ...], HistSeries] = field(
        default_factory=dict)


def _parse_labels(body: Optional[str]) -> Dict[str, str]:
    if not body:
        return {}
    out: Dict[str, str] = {}
    for m in _LABEL_PAIR_RE.finditer(body):
        out[m.group(1)] = _unescape(m.group(2))
    # commas between pairs + optional trailing comma are the only
    # other characters allowed; anything else is a torn label set
    rest = _LABEL_PAIR_RE.sub("", body).replace(",", "").strip()
    if rest:
        raise ExpositionError(f"malformed label set {{{body}}}")
    return out


def parse_exposition(text: str) -> Dict[str, Family]:
    """Prometheus text exposition → name → Family. Histogram families
    fold their ``_bucket``/``_sum``/``_count`` samples back into
    per-series bucket tables (de-cumulated). Raises ExpositionError on
    lines that are neither comments, blank, nor valid samples."""
    families: Dict[str, Family] = {}
    # histogram suffix routing: base name -> family (populated when a
    # TYPE histogram line is seen)
    hist_bases: Dict[str, Family] = {}

    def family(name: str) -> Family:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = Family(name)
        return fam

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            family(name).help = _unescape(help_text)
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, mtype = rest.partition(" ")
            fam = family(name)
            fam.type = mtype.strip()
            if fam.type == "histogram":
                hist_bases[name] = fam
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionError(f"malformed sample line: {line!r}")
        name, label_body, value_s = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(label_body)
        try:
            value = float(value_s)
        except ValueError:
            raise ExpositionError(f"malformed value in: {line!r}")
        base = None
        suffix = None
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and name[: -len(sfx)] in hist_bases:
                base, suffix = name[: -len(sfx)], sfx
                break
        if base is not None:
            fam = hist_bases[base]
            le = labels.pop("le", None)
            key_names = tuple(labels.keys())
            if not fam.label_names and key_names:
                fam.label_names = key_names
            key = tuple(labels[n] for n in fam.label_names) \
                if fam.label_names else ()
            series = fam.histograms.get(key)
            if series is None:
                series = fam.histograms[key] = HistSeries()
            if suffix == "_bucket":
                if le is None:
                    raise ExpositionError(
                        f"histogram bucket without le: {line!r}")
                edge = float("inf") if le == "+Inf" else float(le)
                # cumulative on the wire → de-cumulate against the
                # running total (edges arrive in ascending order)
                prev_cum = sum(series.bucket_counts)
                series.bucket_counts.append(int(value) - prev_cum)
                if edge != float("inf"):
                    series.bucket_edges = series.bucket_edges + (edge,)
            elif suffix == "_sum":
                series.sum = value
            else:
                series.count = int(value)
            continue
        fam = family(name)
        key_names = tuple(labels.keys())
        if not fam.label_names and key_names:
            fam.label_names = key_names
        key = tuple(labels.get(n, "") for n in fam.label_names) \
            if fam.label_names else ()
        fam.samples[key] = value
    return families


def families_from_registry(reg: MetricsRegistry) -> Dict[str, Family]:
    """The same Family structures built directly from the registry's
    live objects — the lint's ground truth for parse(expose(x)) ≡ x."""
    out: Dict[str, Family] = {}
    for m in reg.all_metrics():
        fam = Family(m.name, m.TYPE, m.help, tuple(m.label_names))
        if isinstance(m, Histogram):
            for labels, counts, total_sum, total in m.collect_full():
                fam.histograms[tuple(labels)] = HistSeries(
                    bucket_edges=tuple(float(b) for b in m.buckets),
                    bucket_counts=list(counts),
                    sum=total_sum, count=total)
        else:
            for _name, labels, value in m.collect():
                fam.samples[tuple(labels)] = float(value)
        out[m.name] = fam
    return out


def lint_family(fam: Family) -> List[str]:
    """Prometheus-validity problems with one family (metrics-lint)."""
    problems: List[str] = []
    if not METRIC_NAME_RE.match(fam.name):
        problems.append(f"invalid metric name {fam.name!r}")
    if fam.type not in ("counter", "gauge", "histogram", "untyped"):
        problems.append(f"{fam.name}: unknown type {fam.type!r}")
    for ln in fam.label_names:
        if not LABEL_NAME_RE.match(ln):
            problems.append(f"{fam.name}: invalid label name {ln!r}")
        if ln.startswith("__"):
            problems.append(f"{fam.name}: reserved label name {ln!r}")
    if fam.type == "histogram" and "le" in fam.label_names:
        problems.append(f"{fam.name}: histogram declares 'le' label")
    return problems


class MetricsFederation:
    """Pulls component expositions and maintains the merged,
    instance-labelled cluster view (see module docstring)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 fold_registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._fold_registry = fold_registry
        self._lock = threading.Lock()
        # (name, labels-sans-instance, instance) -> last folded
        # cumulative value (counter-reset detection baseline)
        self._folded: Dict[tuple, float] = {}
        self.scrape_errors: List[str] = []

    # -- ingestion -----------------------------------------------------
    def absorb_text(self, text: str, instance: str,
                    fold: bool = False) -> int:
        """Merge one component's exposition under ``instance``. Returns
        the number of families absorbed. Last scrape wins per instance;
        with ``fold``, counter families are ALSO folded (by cumulative
        delta) into this process's same-name counters."""
        families = parse_exposition(text)
        for fam in families.values():
            self._upsert(fam, instance)
            if fold:
                self._fold(fam, instance)
        return len(families)

    def absorb_registry(self, reg: MetricsRegistry, instance: str) -> int:
        """Mirror a LOCAL registry into the federation (the parent
        process is a component too). Rides the same render→parse path a
        remote scrape takes, so the merged view never depends on which
        side of a process boundary a component runs."""
        return self.absorb_text(reg.expose(), instance)

    def scrape(self, url: str, instance: str, token: str = "",
               timeout: float = 5.0, fold: bool = False) -> bool:
        """HTTP GET a component's ``/metrics`` and absorb it. ``url``
        is the server base (``http://host:port``) or the full /metrics
        URL. Best-effort by contract (a dying child must not fail the
        harness row): failures land in ``scrape_errors`` and return
        False."""
        import http.client

        if not url.endswith("/metrics"):
            url = url.rstrip("/") + "/metrics"
        rest = url.split("://", 1)[-1]
        hostport, _, path = rest.partition("/")
        host, _, port = hostport.partition(":")
        try:
            conn = http.client.HTTPConnection(
                host, int(port or 80), timeout=timeout)
            try:
                headers = {"Authorization": f"Bearer {token}"} \
                    if token else {}
                conn.request("GET", "/" + path, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise ExpositionError(
                        f"HTTP {resp.status} from {url}")
                self.absorb_text(body.decode(), instance, fold=fold)
                return True
            finally:
                conn.close()
        except Exception as e:  # noqa: BLE001 — scraping is best-effort
            self.scrape_errors.append(f"{instance} {url}: {e}")
            return False

    # -- merge ---------------------------------------------------------
    def _upsert(self, fam: Family, instance: str) -> None:
        label_names = ("instance",) + tuple(fam.label_names)
        with self._lock:
            metric = self.registry.get(fam.name)
            if fam.type == "histogram":
                edges = None
                for series in fam.histograms.values():
                    edges = series.bucket_edges
                    break
                if edges is None and not isinstance(metric, Histogram):
                    return      # empty family, nothing to merge yet
                if (not isinstance(metric, Histogram)
                        or metric.label_names != label_names
                        or (edges is not None
                            and tuple(metric.buckets) != tuple(edges))):
                    metric = self.registry.register(Histogram(
                        fam.name, fam.help, label_names,
                        buckets=edges or DEFAULT_BUCKETS))
                self._drop_instance_series(metric, instance)
                for labels, series in fam.histograms.items():
                    counts = list(series.bucket_counts)
                    want = len(metric.buckets) + 1
                    counts += [0] * (want - len(counts))
                    with metric._lock:
                        metric._series[(instance,) + labels] = [
                            counts[:want], series.sum, series.count]
                return
            cls = Counter if fam.type == "counter" else Gauge
            if (not isinstance(metric, (Counter, Gauge))
                    or metric.TYPE != cls.TYPE
                    or metric.label_names != label_names):
                metric = self.registry.register(
                    cls(fam.name, fam.help, label_names))
            self._drop_instance_series(metric, instance)
            with metric._lock:
                for labels, value in fam.samples.items():
                    # sample semantics: SET the mirrored series (a
                    # counter mirror is still monotonic per instance
                    # because the source is)
                    metric._values[(instance,) + labels] = value

    @staticmethod
    def _drop_instance_series(metric, instance: str) -> None:
        table = metric._series if isinstance(metric, Histogram) \
            else metric._values
        with metric._lock:
            for key in [k for k in table if k and k[0] == instance]:
                del table[key]

    def _fold(self, fam: Family, instance: str,
              into: Optional[MetricsRegistry] = None) -> None:
        """Fold a remote counter family into the local same-name
        counter by cumulative delta — the generic replacement for the
        per-family ``absorb_snapshot`` mappings. Counter resets (a
        fresh child under a reused instance name) restart the baseline
        so the new child's full total folds in."""
        into = into if into is not None else self._fold_registry
        if fam.type != "counter" or into is None:
            return
        target = into.get(fam.name)
        if not isinstance(target, Counter) \
                or target.label_names != tuple(fam.label_names):
            return
        for labels, value in fam.samples.items():
            key = (fam.name, labels, instance)
            with self._lock:
                prev = self._folded.get(key, 0.0)
                if value < prev:
                    prev = 0.0          # child restarted: counter reset
                self._folded[key] = value
            if value > prev:
                target.inc(*labels, amount=value - prev)

    def fold_samples(self, name: str, label_names: Tuple[str, ...],
                     samples: Dict[Tuple[str, ...], float],
                     instance: str,
                     into: Optional[MetricsRegistry] = None) -> None:
        """Fold one counter family given as plain samples — the compat
        entry point ``apf_metrics.absorb_snapshot`` wraps, so the
        legacy /debug/apf JSON path and the scrape path share ONE delta
        ledger. ``into`` overrides the fold-target registry."""
        fam = Family(name, "counter", "", tuple(label_names),
                     samples=dict(samples))
        self._fold(fam, instance, into=into)

    # -- queries -------------------------------------------------------
    def instances(self, name: Optional[str] = None) -> set:
        """Distinct ``instance`` label values merged so far (for one
        family, or across all) — the cardinality the federation
        acceptance asserts on."""
        out = set()
        for m in self.registry.all_metrics():
            if name is not None and m.name != name:
                continue
            table = m._series if isinstance(m, Histogram) else m._values
            with m._lock:
                out.update(k[0] for k in table if k)
        return out

    def counter_total(self, name: str) -> float:
        """Sum of one counter family across every instance + labels."""
        m = self.registry.get(name)
        if not isinstance(m, (Counter, Gauge)):
            return 0.0
        return sum(v for _n, _k, v in m.collect())

    def series(self, name: str):
        """The merged metric object (instance label first), or None."""
        return self.registry.get(name)

    def drop_instance(self, instance: str) -> None:
        """Forget one instance's merged series (fold baselines are
        kept: a re-scrape of the same still-running child must not
        double-fold)."""
        for m in self.registry.all_metrics():
            self._drop_instance_series(m, instance)

    def forget_instance(self, instance: str) -> None:
        """Forget one instance's merged series AND its fold baselines —
        for callers that reuse an instance name across child-process
        generations (the REST harness spawns a fresh apiserver per
        row): the next child's totals must fold in full, not as a
        delta against a dead process's counters."""
        self.drop_instance(instance)
        with self._lock:
            for key in [k for k in self._folded if k[2] == instance]:
                del self._folded[key]

    def clear(self) -> None:
        with self._lock:
            self._folded.clear()
            self.scrape_errors = []
        for m in self.registry.all_metrics():
            table = m._series if isinstance(m, Histogram) else m._values
            with m._lock:
                table.clear()


_default: Optional[MetricsFederation] = None
_default_lock = threading.Lock()


def metrics_federation() -> MetricsFederation:
    """Process-wide federation (the legacyregistry pattern): merged
    view in its own registry, counter folds target the process default
    registry."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                from kubernetes_tpu_torch.metrics import default_registry

                _default = MetricsFederation(
                    fold_registry=default_registry())
    return _default
