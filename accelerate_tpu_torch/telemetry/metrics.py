"""Process-local metrics registry: Counter / Gauge / Histogram instruments
(the port of `accelerate_tpu/telemetry/metrics.py`).

The serving engine, the Accelerator's step loop, and the bench scripts all need
the same three primitives — monotonic counts (requests finished, recompiles),
point-in-time values (queue depth, slots in use), and latency distributions
(TTFT, inter-token gaps). This module provides them with the constraints an
asynchronous device's hot path imposes:

  - **zero device syncs**: instruments accept host scalars only (perf_counter
    deltas, Python ints). Nothing here imports torch; passing a tensor (a CUDA
    one, a CPU one, a 0-d one) is a caller bug and raises before it can hide
    a blocking ``float()`` readback in the serving loop.
  - **bounded memory**: a Histogram is a FIXED vector of log-spaced bucket
    counts plus (sum, count) — observations are never retained individually, so
    a server can run for months without the registry growing. Quantiles are
    estimated by linear interpolation inside the owning bucket (the standard
    Prometheus-histogram estimator), accurate to the bucket resolution.
  - **thread-safe**: servers submit from request-handler threads while the
    drive loop finishes requests; every instrument guards its state with its
    own lock, and the registry locks instrument creation.

Instruments are identified by ``(name, labels)`` — the Prometheus data model —
so per-reason counters (``serving_requests_finished_total{reason="eos"}``) are
distinct time series sharing one name. Rendering/parsing of the Prometheus text
format and JSONL snapshots live in `export.py`.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

#: Prometheus metric-name charset (also enforced for label names).
_NAME_OK = lambda s: bool(s) and all(c.isalnum() or c in "_:" for c in s) and not s[0].isdigit()  # noqa: E731

#: (name, sorted labels) — one time series.
InstrumentKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _check_scalar(value) -> float:
    """The zero-device-sync gate: only host numbers may enter an instrument.

    A tensor (or anything array-like) reaching ``float()`` here would be a
    hidden blocking device->host readback on the hot path, so it is rejected
    loudly instead of silently syncing. `np.float64` passes (it subclasses
    float); `bool`, `np.int64`, arrays and every `torch.Tensor` raise.
    """
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(
            f"metrics take host scalars (int/float), got {type(value).__name__}: "
            "read device values at the step boundary (.item()/.cpu()) BEFORE "
            "recording them — an implicit conversion here would hide a device sync"
        )
    return float(value)


def log_spaced_buckets(lo: float = 1e-4, hi: float = 100.0, per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi].

    The default — 4/decade from 100 µs to 100 s — spans everything this repo
    times (a decode chunk, a TTFT, a checkpoint save) in 25 buckets, giving
    ~78% worst-case quantile resolution per bucket at constant memory.
    """
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError("need 0 < lo < hi and per_decade >= 1")
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    bounds = [lo * 10 ** (k / per_decade) for k in range(n + 1)]
    # ceil() should land the last bound at or above hi, but float error on
    # non-integer decade spans can leave it just below — enforce coverage so
    # values in (bounds[-1], hi] can't silently fall into the +Inf overflow.
    bounds[-1] = max(bounds[-1], float(hi))
    return tuple(round(b, 12) for b in bounds)


#: The shared latency bucket layout (seconds): every latency histogram in the
#: repo uses one layout so exported series are comparable across subsystems.
DEFAULT_LATENCY_BUCKETS = log_spaced_buckets()


class _Instrument:
    """Base: identity + lock. Subclasses own their state under `self._lock`."""

    kind = "untyped"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...], help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(_Instrument):
    """Monotonically increasing count (requests, inserts, recompiles)."""

    kind = "counter"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        amount = _check_scalar(amount)
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge for bidirectional values")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Point-in-time value (queue depth, slots in use, goodput fraction)."""

    kind = "gauge"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, value: float):
        value = _check_scalar(value)
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1.0):
        amount = _check_scalar(amount)
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-_check_scalar(amount))

    def set_max(self, value: float):
        """Retain the high-water mark (queue_peak semantics) atomically."""
        value = _check_scalar(value)
        with self._lock:
            if value > self._value:
                self._value = value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Instrument):
    """Fixed-bucket distribution: `len(buckets)+1` counts (the last is +Inf
    overflow), a running sum, and a total count — bounded memory forever."""

    kind = "histogram"

    def __init__(self, name, labels, help="", buckets: Optional[Sequence[float]] = None):
        super().__init__(name, labels, help)
        bounds = tuple(float(b) for b in (buckets if buckets is not None else DEFAULT_LATENCY_BUCKETS))
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError("histogram buckets must be a non-empty strictly-increasing sequence")
        self.bucket_bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        value = _check_scalar(value)
        idx = bisect_left(self.bucket_bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float) -> Optional[float]:
        """Prometheus-style estimate: find the bucket holding the q-th
        observation, interpolate linearly inside it. None when empty; the
        overflow bucket clamps to the top finite bound (the honest answer for
        "at least this much")."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1]")
        with self._lock:
            counts, total = list(self._counts), self._count
        if total == 0:
            return None
        rank = q * total
        cumulative = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cumulative + c >= rank:
                if i == len(self.bucket_bounds):  # +Inf overflow
                    return self.bucket_bounds[-1]
                lower = self.bucket_bounds[i - 1] if i > 0 else 0.0
                upper = self.bucket_bounds[i]
                frac = (rank - cumulative) / c
                return lower + (upper - lower) * min(max(frac, 0.0), 1.0)
            cumulative += c
        return self.bucket_bounds[-1]


class MetricsRegistry:
    """Get-or-create instrument store keyed on (name, labels).

    One registry per subsystem owner (an `Accelerator`, a `ContinuousBatcher`)
    or shared between them — instruments are cheap and export walks whatever is
    registered. Re-requesting an existing (name, labels) returns the SAME
    instrument (so wiring code never double-counts); requesting an existing
    name as a different kind is a bug and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[InstrumentKey, _Instrument] = {}

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]) -> InstrumentKey:
        if not _NAME_OK(name):
            raise ValueError(f"invalid metric name {name!r} (want [a-zA-Z_:][a-zA-Z0-9_:]*)")
        items = tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))
        for k, _v in items:
            if not _NAME_OK(k):
                raise ValueError(f"invalid label name {k!r}")
        return (name, items)

    def _get_or_create(self, cls, name, labels, help, **kwargs):
        key = self._key(name, labels)
        with self._lock:
            existing = self._instruments.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind}, not {cls.kind}"
                    )
                return existing
            instrument = cls(name, key[1], help=help, **kwargs)
            self._instruments[key] = instrument
            return instrument

    def counter(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, labels, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, labels, help, buckets=buckets)

    # ------------------------------------------------------------------ access
    def instruments(self) -> List[_Instrument]:
        """Stable-ordered view (sorted by name then labels) for exporters."""
        with self._lock:
            return [self._instruments[k] for k in sorted(self._instruments)]

    def get(self, name: str, labels: Optional[Dict[str, str]] = None) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(self._key(name, labels))

    def value(self, name: str, labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Counter/Gauge value (histograms expose .sum/.count/.quantile)."""
        instrument = self.get(name, labels)
        return None if instrument is None or isinstance(instrument, Histogram) else instrument.value

    def snapshot(self) -> List[dict]:
        """The full registry as plain data (what JSONL export and the bench
        telemetry blocks serialize). Histograms include their bucket layout so
        a snapshot is self-describing."""
        out = []
        for inst in self.instruments():
            entry = {"name": inst.name, "kind": inst.kind, "labels": inst.label_dict}
            if inst.help:
                entry["help"] = inst.help
            if isinstance(inst, Histogram):
                entry["sum"] = inst.sum
                entry["count"] = inst.count
                entry["buckets"] = list(inst.bucket_bounds)
                entry["bucket_counts"] = inst.bucket_counts()
                for q in (0.5, 0.99):
                    quantile = inst.quantile(q)
                    if quantile is not None:
                        entry[f"p{int(q * 100)}"] = quantile
            else:
                entry["value"] = inst.value
            out.append(entry)
        return out
