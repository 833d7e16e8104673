"""Process-wide metrics: counters, gauges, fixed-bucket histograms and
the slow-op flight recorder.

Copied from fluidframework_tpu/utils/metrics.py: the instruments and
registries (:65-401: `Counter`, `Gauge`, `Histogram`,
`_NullInstrument`, `NullRegistry`, `MetricsRegistry`), the default
registry with `get_registry` / `set_registry` / `set_enabled`
(:398-430), `merge_snapshots` and `histogram_quantile` (:441-470), and
`FlightRecorder` with `get_flight_recorder` / `set_flight_recorder`
(:577-698). The report formatters are not copied.

Design constraints, as in the reference:

- **Cheap**: instruments are plain attribute bumps under one lock; hot
  paths cache instrument objects at construction and record per-pump
  aggregates, never per-record work on the kernel path.
  `set_enabled(False)` swaps the default registry for a no-op
  `NullRegistry`.
- **Observational only**: nothing here feeds back into sequencing, so
  the stamped output is the same with instrumentation on or off.
- **Per-process with explicit merge**: registries do not share state
  across processes; a supervised role snapshots its registry into its
  heartbeat file and a supervisor folds the snapshots with
  `MetricsRegistry.merge` (counters and histograms add, gauges keep
  the last write).
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_MS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "get_flight_recorder",
    "get_registry",
    "histogram_quantile",
    "merge_snapshots",
    "set_enabled",
    "set_flight_recorder",
    "set_registry",
]

# Fixed latency buckets (ms): sub-millisecond ticks through 10s tails.
DEFAULT_LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str], lock):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str], lock):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class Histogram:
    """Fixed-bucket histogram (Prometheus `le`-inclusive upper bounds
    plus an implicit +Inf overflow bucket)."""

    __slots__ = ("name", "labels", "bounds", "counts", "sum", "count",
                 "_lock")

    def __init__(self, name: str, labels: Dict[str, str],
                 bounds: Tuple[float, ...], lock):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram bounds must be sorted unique: {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        # bisect_left: v == bound lands IN that bucket (le-inclusive).
        i = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1


class _NullInstrument:
    """Shared no-op instrument (disabled-registry mode)."""

    __slots__ = ()
    value = 0.0
    sum = 0.0
    count = 0

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Registry whose instruments do nothing — `set_enabled(False)`
    makes `get_registry()` return one, so instrumented components pay a
    single no-op call per record/pump."""

    namespace = "fluid"

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=None, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {"counters": [], "gauges": [], "histograms": []}

    def merge(self, snap: dict) -> None:
        pass

    def to_prometheus(self) -> str:
        return ""

    def reset(self) -> None:
        pass


class MetricsRegistry:
    """Lock-safe instrument registry with deterministic snapshots.

    One instance per process; instruments are create-or-return by
    (kind, name, labels) so call sites can either cache the instrument
    (hot paths) or re-look it up (cold paths)."""

    def __init__(self, namespace: str = "fluid"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._instruments: Dict[tuple, Any] = {}

    # ------------------------------------------------------ instruments

    def _get(self, kind: str, cls, name: str, labels: Dict[str, Any],
             *args):
        key = (kind, name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                for other_kind in ("counter", "gauge", "histogram"):
                    if other_kind != kind and any(
                        k[0] == other_kind and k[1] == name
                        for k in self._instruments
                    ):
                        raise ValueError(
                            f"metric {name!r} already registered as "
                            f"{other_kind}, not {kind}"
                        )
                inst = cls(name, dict(key[2]), *args, self._lock)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        bounds = tuple(buckets) if buckets else DEFAULT_LATENCY_BUCKETS_MS
        h = self._get("histogram", Histogram, name, labels, bounds)
        if h.bounds != tuple(float(b) for b in bounds):
            raise ValueError(
                f"histogram {name!r} re-registered with different buckets"
            )
        return h

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()

    # --------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """JSON-able, deterministic (sorted) state of every instrument.

        Histogram fields are copied UNDER the instruments' shared lock:
        counts, sum and count must come from one instant, or a
        concurrent `observe` between the field reads yields a torn
        snapshot whose explicit sum/count disagree with its buckets —
        and every downstream consumer (merge across process snapshots,
        quantile estimation, the mean column) silently inherits the
        skew."""
        counters, gauges, histograms = [], [], []
        with self._lock:
            items = sorted(self._instruments.items())
            for (kind, name, labels), inst in items:
                entry = {"name": name, "labels": dict(labels)}
                if kind == "counter":
                    counters.append({**entry, "value": inst.value})
                elif kind == "gauge":
                    gauges.append({**entry, "value": inst.value})
                else:
                    h = {
                        **entry, "buckets": list(inst.bounds),
                        "counts": list(inst.counts), "sum": inst.sum,
                        "count": inst.count,
                    }
                    histograms.append(h)
        for h in histograms:
            if h["count"] > 0:
                # Quantiles ride the snapshot (the /slo surface), but
                # they are DERIVED — merge() folds buckets/sum/count
                # and recomputes; None marks an estimate beyond the
                # last finite bucket (JSON has no Infinity).
                h["quantiles"] = {
                    q: (None if v == float("inf") else round(v, 4))
                    for q, v in (
                        ("p50", histogram_quantile(h, 0.5)),
                        ("p95", histogram_quantile(h, 0.95)),
                        ("p99", histogram_quantile(h, 0.99)),
                    )
                }
                h["mean"] = round(h["sum"] / h["count"], 4)
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    def merge(self, snap: dict) -> None:
        """Fold a child's `snapshot()` in: counters and histogram
        buckets ADD, gauges take the snapshot's value (children report
        disjoint label sets — e.g. role=... — so last-write is safe)."""
        for c in snap.get("counters", ()):
            self.counter(c["name"], **c["labels"]).inc(c["value"])
        for g in snap.get("gauges", ()):
            self.gauge(g["name"], **g["labels"]).set(g["value"])
        for h in snap.get("histograms", ()):
            inst = self.histogram(h["name"], buckets=h["buckets"],
                                  **h["labels"])
            with inst._lock:
                for i, n in enumerate(h["counts"]):
                    inst.counts[i] += n
                inst.sum += h["sum"]
                inst.count += h["count"]

    # ------------------------------------------------------- exposition

    @staticmethod
    def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
        parts = []
        for k, v in sorted(labels.items()):
            esc = str(v).replace("\\", "\\\\").replace('"', '\\"')
            parts.append('%s="%s"' % (k, esc))
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @staticmethod
    def _fmt_num(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else repr(float(v))

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        snap = self.snapshot()
        out: List[str] = []
        seen_type: set = set()

        def full(name: str) -> str:
            return f"{self.namespace}_{name}" if self.namespace else name

        for kind in ("counters", "gauges"):
            ptype = "counter" if kind == "counters" else "gauge"
            for m in snap[kind]:
                fname = full(m["name"])
                if fname not in seen_type:
                    out.append(f"# TYPE {fname} {ptype}")
                    seen_type.add(fname)
                out.append(
                    f"{fname}{self._fmt_labels(m['labels'])} "
                    f"{self._fmt_num(m['value'])}"
                )
        qlines: List[str] = []
        for m in snap["histograms"]:
            fname = full(m["name"])
            if fname not in seen_type:
                out.append(f"# TYPE {fname} histogram")
                seen_type.add(fname)
            cum = 0
            for bound, n in zip(
                list(m["buckets"]) + ["+Inf"], m["counts"]
            ):
                cum += n
                le = bound if bound == "+Inf" else self._fmt_num(bound)
                le_label = 'le="%s"' % le
                out.append(
                    f"{fname}_bucket"
                    f"{self._fmt_labels(m['labels'], le_label)} {cum}"
                )
            out.append(
                f"{fname}_sum{self._fmt_labels(m['labels'])} "
                f"{self._fmt_num(m['sum'])}"
            )
            out.append(
                f"{fname}_count{self._fmt_labels(m['labels'])} {m['count']}"
            )
            # Bucket-interpolated quantile estimates as a sibling gauge
            # family (`<name>_q{quantile=...}`) — NOT extra `<name>`
            # series, which a strict parser would reject under TYPE
            # histogram. Buffered and appended AFTER the histogram
            # loop: a metric family's samples must stay one contiguous
            # group, and a histogram name with several label sets
            # would otherwise interleave `<name>` and `<name>_q`.
            # Estimates beyond the last finite bucket are omitted
            # rather than faked.
            if m["count"] > 0:
                qname = f"{fname}_q"
                for q in (0.5, 0.95, 0.99):
                    v = histogram_quantile(m, q)
                    if v == float("inf"):
                        continue
                    if qname not in seen_type:
                        qlines.append(f"# TYPE {qname} gauge")
                        seen_type.add(qname)
                    qlabel = 'quantile="%s"' % q
                    qlines.append(
                        f"{qname}"
                        f"{self._fmt_labels(m['labels'], qlabel)}"
                        f" {self._fmt_num(round(v, 4))}"
                    )
        out.extend(qlines)
        return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# default registry + enable switch
# ---------------------------------------------------------------------------

_default_registry: Any = MetricsRegistry()
_null_registry = NullRegistry()
_enabled = True


def get_registry():
    """The process's default registry (a `NullRegistry` while
    `set_enabled(False)` is in effect)."""
    return _default_registry if _enabled else _null_registry


def set_registry(registry) -> Any:
    """Swap the default registry; returns the previous one (bench
    isolation: fresh registry per measured run)."""
    global _default_registry
    old = _default_registry
    _default_registry = registry
    return old


def set_enabled(flag: bool) -> bool:
    """Toggle instrumentation process-wide. Components that cached
    instruments keep them; components constructed while disabled get
    no-ops. Returns the previous setting."""
    global _enabled
    old = _enabled
    _enabled = bool(flag)
    return old


# ---------------------------------------------------------------------------
# snapshot merging
# ---------------------------------------------------------------------------


def merge_snapshots(snapshots: Iterable[dict]) -> MetricsRegistry:
    """Fold snapshots (or metrics.jsonl line dicts) into one registry."""
    reg = MetricsRegistry()
    for snap in snapshots:
        reg.merge(snap.get("snapshot", snap))
    return reg


def histogram_quantile(h: dict, q: float) -> float:
    """Estimate quantile `q` from a snapshot histogram entry by linear
    interpolation within its bucket; `inf` if it lands in overflow."""
    total = h["count"]
    if total <= 0:
        return 0.0
    target = q * total
    bounds = h["buckets"]
    cum = 0
    for i, n in enumerate(h["counts"]):
        if n == 0:
            continue
        if cum + n >= target:
            if i >= len(bounds):
                return float("inf")
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * max(0.0, target - cum) / n
        cum += n
    return float("inf")




# ---------------------------------------------------------------------------
# slow-op flight recorder (the /traces surface)
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring buffer of SLOW-op span records.

    Histograms answer "what is p99"; they cannot answer "which ops
    were the p99" — a tail-latency regression report needs the exact
    slow ops attached (doc/client/seq plus every stage timestamp).
    This keeps the last `capacity` spans whose end-to-end latency
    either exceeds a fixed `threshold_ms` or, when none is set, the
    ROLLING p99 of the last `window` observations — so the buffer
    always holds the current tail, never a firehose.

    Two-phase API so the hot path never builds a span dict it is about
    to drop:

        if recorder.note(e2e_ms):          # updates the rolling window
            recorder.add(e2e_ms, {...})    # admit the full span

    Observational only and lock-safe; `snapshot()` returns the spans
    oldest-first, each as ``{"e2e_ms": ..., **span}``.
    """

    RECALC_EVERY = 32  # rolling-p99 refresh cadence (observations)

    def __init__(self, capacity: int = 128,
                 threshold_ms: Optional[float] = None,
                 window: int = 512, min_samples: int = 32):
        from collections import deque

        self.capacity = int(capacity)
        self.threshold_ms = threshold_ms
        self.min_samples = int(min_samples)
        self._spans = deque(maxlen=self.capacity)
        self._recent = deque(maxlen=int(window))
        self._rolling_p99 = float("inf")
        self._since_recalc = 0
        self.seen = 0
        self.recorded = 0
        self._lock = threading.Lock()

    def _refresh_p99(self) -> None:
        n = len(self._recent)
        if n < self.min_samples:
            self._rolling_p99 = float("inf")
            return
        ordered = sorted(self._recent)
        self._rolling_p99 = ordered[min(n - 1, int(0.99 * (n - 1)))]

    def note(self, e2e_ms: float) -> bool:
        """Fold one end-to-end latency into the rolling window; True
        iff the op qualifies for the buffer (the caller then builds
        the span and calls `add`)."""
        with self._lock:
            self.seen += 1
            self._recent.append(float(e2e_ms))
            self._since_recalc += 1
            if self._since_recalc >= self.RECALC_EVERY:
                self._since_recalc = 0
                self._refresh_p99()
            if self.threshold_ms is not None:
                return e2e_ms >= self.threshold_ms
            return e2e_ms >= self._rolling_p99

    def add(self, e2e_ms: float, span: Dict[str, Any]) -> None:
        with self._lock:
            self.recorded += 1
            self._spans.append({"e2e_ms": round(float(e2e_ms), 4),
                                **span})

    def observe(self, e2e_ms: float, span: Dict[str, Any]) -> bool:
        """One-shot form for cold paths: note + add when admitted."""
        if self.note(e2e_ms):
            self.add(e2e_ms, span)
            return True
        return False

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._recent.clear()
            self._rolling_p99 = float("inf")
            self._since_recalc = 0
            self.seen = 0
            self.recorded = 0


def _env_slow_threshold() -> Optional[float]:
    """`FLUID_TRACE_SLOW_MS`: a FIXED slow-op threshold (ms) for the
    process's default flight recorder — spans at/above it are kept
    instead of the rolling-p99 gate. The scenario/chaos harnesses set
    it ("0" = keep every span, ring-bounded) so a short run's /traces
    evidence does not depend on the rolling window having armed;
    unset (the default) keeps the adaptive production behavior."""
    v = os.environ.get("FLUID_TRACE_SLOW_MS", "")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


_default_recorder = FlightRecorder(threshold_ms=_env_slow_threshold())


def get_flight_recorder() -> FlightRecorder:
    """The process's default slow-op recorder (fed by the runtime's
    apply-side trace fold and, in wire-trace mode, the farm's
    broadcaster role; served by `monitor.MetricsServer` `/traces`)."""
    return _default_recorder


def set_flight_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the default recorder; returns the previous one (bench/test
    isolation, like `set_registry`)."""
    global _default_recorder
    old = _default_recorder
    _default_recorder = recorder
    return old
