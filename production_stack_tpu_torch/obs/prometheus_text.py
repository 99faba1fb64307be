"""Counters, gauges and histograms with labels, rendered as Prometheus
text exposition 0.0.4, in plain Python.

The card's machine has no ``prometheus_client``, so the engine keeps its
metrics here. The text parses as ``prometheus_client``'s would for the
same values: ``# HELP`` and ``# TYPE`` lines a family, a counter ``x``
exported as ``x_total``, histograms as cumulative ``x_bucket{le=...}``
samples up to ``+Inf`` with ``x_sum`` and ``x_count``, label values
escaped. ``_created`` timestamps are not emitted.

Thread-safe: HTTP threads render while the step thread records. One lock
a registry guards every family in it.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    """A sample value or bound as Prometheus (and Go) writes floats."""
    v = float(v)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    s = repr(v)
    dot = s.find(".")
    if v > 0 and dot > 6:  # Go switches to exponents sooner than Python
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    body = ",".join(f'{n}="{_escape_label(v)}"' for n, v in zip(names, values))
    return "{" + body + "}"


class Registry:
    """Families in registration order; ``render()`` gives the text."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self._families: List["_Family"] = []

    def counter(self, name: str, doc: str, labelnames: Sequence[str] = ()
                ) -> "Counter":
        return self._add(Counter(self, name, doc, labelnames))

    def gauge(self, name: str, doc: str, labelnames: Sequence[str] = ()
              ) -> "Gauge":
        return self._add(Gauge(self, name, doc, labelnames))

    def histogram(self, name: str, doc: str, buckets: Sequence[float],
                  labelnames: Sequence[str] = ()) -> "Histogram":
        return self._add(Histogram(self, name, doc, labelnames, buckets))

    def _add(self, family):
        with self.lock:
            self._families.append(family)
        return family

    def render(self) -> str:
        with self.lock:
            return "".join(f.render() for f in self._families)


class _Family:
    kind = ""

    def __init__(self, registry: Registry, name: str, doc: str,
                 labelnames: Sequence[str]) -> None:
        self._registry = registry
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:  # exported at 0 before its first update
            self._children[()] = self._child()

    def labels(self, **kw):
        """The child of one label set (made on first use)."""
        if set(kw) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}")
        values = tuple(str(kw[n]) for n in self.labelnames)
        with self._registry.lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._child()
            return child

    def _only(self):
        """The one child of a family without labels."""
        if self.labelnames:
            raise ValueError(f"{self.name} needs labels {self.labelnames}")
        return self.labels()

    def render(self) -> str:
        name = self._sample_name()
        lines = [f"# HELP {name} {_escape_help(self.doc)}",
                 f"# TYPE {name} {self.kind}"]
        for values, child in self._children.items():
            lines += self._render_child(values, child)
        return "\n".join(lines) + "\n"

    def _sample_name(self) -> str:
        return self.name

    def _render_child(self, values, child) -> List[str]:
        return [f"{self._sample_name()}"
                f"{_labels(self.labelnames, values)} {_fmt(child.value)}"]


class _Value:
    def __init__(self, lock) -> None:
        self._lock = lock
        self.value = 0.0


class _CounterChild(_Value):
    def __init__(self, lock) -> None:
        super().__init__(lock)
        self._last_total = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("a counter only goes up")
        with self._lock:
            self.value += amount

    def to_total(self, total: float) -> None:
        """Follow a cumulative total kept elsewhere, as the JAX server's
        ``_counter_to`` does: add what it grew by; a total that fell was
        reset where it is kept, so everything counted since is ``total``:
        add that and re-baseline."""
        with self._lock:
            last = self._last_total
            if total > last:
                self.value += total - last
            elif total < last and total > 0:
                self.value += total
            if total != last:
                self._last_total = total


class _GaugeChild(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class _HistogramChild:
    def __init__(self, lock, bounds: Tuple[float, ...]) -> None:
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * len(bounds)  # per bucket, not cumulative
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.counts[i] += 1
                    break
            self.sum += value


class Counter(_Family):
    kind = "counter"

    def __init__(self, registry, name, doc, labelnames) -> None:
        # As prometheus_client: a counter named ``x_total`` is family ``x``.
        if name.endswith("_total"):
            name = name[: -len("_total")]
        super().__init__(registry, name, doc, labelnames)

    def _child(self):
        return _CounterChild(self._registry.lock)

    def _sample_name(self) -> str:
        return self.name + "_total"

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def to_total(self, total: float) -> None:
        self._only().to_total(total)


class Gauge(_Family):
    kind = "gauge"

    def _child(self):
        return _GaugeChild(self._registry.lock)

    def set(self, value: float) -> None:
        self._only().set(value)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, doc, labelnames, buckets) -> None:
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds):
            raise ValueError(f"{name}: buckets must be in increasing order")
        if not bounds or bounds[-1] != math.inf:
            bounds += (math.inf,)
        self.bounds = bounds
        super().__init__(registry, name, doc, labelnames)

    def _child(self):
        return _HistogramChild(self._registry.lock, self.bounds)

    def _render_child(self, values, child) -> List[str]:
        names = self.labelnames + ("le",)
        out, acc = [], 0
        for b, n in zip(child.bounds, child.counts):
            acc += n
            out.append(f"{self.name}_bucket"
                       f"{_labels(names, (*values, _fmt(b)))} {_fmt(acc)}")
        labels = _labels(self.labelnames, values)
        out.append(f"{self.name}_count{labels} {_fmt(acc)}")
        out.append(f"{self.name}_sum{labels} {_fmt(child.sum)}")
        return out
