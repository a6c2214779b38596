"""Metrics registry: counters, gauges, timers, histograms, phase walls.

The JAX package's ``obs/metrics.py`` on the port, unchanged in schema
(``math.fsum`` is its order-independent float sum).  One registry per
run.  Everything mutates under a single lock (worker threads emit
concurrently); reads for reports take a consistent snapshot.  Surfaces:

- **counters** — monotone ints (``count("windows")``);
- **gauges** — last-written values (``gauge("hybrid_workers", 2)``);
- **histograms** — streaming min/max/count/total plus a bounded,
  deterministic sample (the FIRST ``SAMPLE_CAP`` observations) for
  percentiles: per-window distributions (active hosts, window span)
  ride these;
- **phase walls** — the per-phase wall-time attribution
  (``phase_add("device_turn", dt)``), the numbers the Chrome-trace spans
  are cross-checked against;
- an optional **JSONL stream** (one record per span/mark, locked
  writes) for external consumers that want events, not aggregates.

``report()`` aggregates everything into the ``METRICS_*.json`` document
(schema in docs/observability.md).
"""

from __future__ import annotations

import json
import threading
import time as wall_time
from pathlib import Path
from typing import Optional

from math import fsum

SAMPLE_CAP = 65536  # deterministic histogram sample: first N observations

SCHEMA_VERSION = 1


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "sample")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.sample: list[float] = []

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v
        if len(self.sample) < SAMPLE_CAP:
            self.sample.append(v)

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        s = sorted(self.sample)

        def pct(q: float) -> float:
            return s[min(int(q * len(s)), len(s) - 1)]

        return {
            "count": self.count,
            "min": self.vmin,
            "max": self.vmax,
            "mean": self.total / self.count,
            "p50": pct(0.50),
            "p90": pct(0.90),
            "p99": pct(0.99),
        }


class MetricsRegistry:
    def __init__(
        self, run_id: str = "run", jsonl_path: Optional[str | Path] = None
    ) -> None:
        self.run_id = run_id
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, object] = {}
        self._hists: dict[str, _Hist] = {}
        # phase -> [span_count, total_wall_s]
        self._phases: dict[str, list] = {}
        self._t0 = wall_time.perf_counter()
        self._jsonl_f = None
        self.jsonl_path: Optional[Path] = None
        if jsonl_path is not None:
            self.jsonl_path = Path(jsonl_path)
            self.jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl_f = open(self.jsonl_path, "w")

    # -- write side --------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist()
            h.add(value)

    def phase_add(self, phase: str, dur_s: float) -> None:
        with self._lock:
            p = self._phases.get(phase)
            if p is None:
                self._phases[phase] = [1, dur_s]
            else:
                p[0] += 1
                p[1] += dur_s

    def timer(self, name: str) -> "_Timer":
        """``with metrics.timer("collect"):`` — observes the block's wall
        seconds into the histogram of the same name."""
        return _Timer(self, name)

    def stream(self, record: dict) -> None:
        """Append one JSONL record (no-op when streaming is off).  The
        write happens under the registry lock so concurrent emitters
        produce whole lines."""
        f = self._jsonl_f
        if f is None:
            return
        with self._lock:
            f.write(json.dumps(record) + "\n")

    # -- read side ---------------------------------------------------------

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def phase_wall_s(self) -> dict[str, float]:
        """phase -> total wall seconds (the bench breakdown keys)."""
        with self._lock:
            return {k: p[1] for k, p in self._phases.items()}

    def phase_report(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {"spans": p[0], "wall_s": p[1]}
                for k, p in sorted(self._phases.items())
            }

    def report(self, extra: Optional[dict] = None) -> dict:
        """The aggregated METRICS document (docs/observability.md)."""
        with self._lock:
            phases = {
                k: {"spans": p[0], "wall_s": p[1]}
                for k, p in sorted(self._phases.items())
            }
            doc = {
                "schema": SCHEMA_VERSION,
                "run_id": self.run_id,
                "recorder_wall_s": wall_time.perf_counter() - self._t0,
                "phase_wall_s": {k: v["wall_s"] for k, v in phases.items()},
                "phase_wall_total_s": fsum(
                    v["wall_s"] for v in phases.values()
                ),
                "phases": phases,
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
                "histograms": {
                    k: h.summary() for k, h in sorted(self._hists.items())
                },
            }
        if extra:
            doc.update(extra)
        return doc

    def write_report(
        self, path: str | Path, extra: Optional[dict] = None
    ) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.report(extra), indent=2) + "\n")
        return path

    def snapshot_lines(self) -> list[str]:
        """Human-readable snapshot (the run-control ``stats`` verb)."""
        with self._lock:
            phases = {k: (p[0], p[1]) for k, p in sorted(self._phases.items())}
            counters = dict(sorted(self._counters.items()))
            gauges = dict(sorted(self._gauges.items()))
        lines = []
        if phases:
            lines.append("phase walls:")
            for k, (n, s) in phases.items():
                lines.append(f"  {k}: {s:.6f}s over {n} span(s)")
        if counters:
            lines.append(
                "counters: "
                + " ".join(f"{k}={v}" for k, v in counters.items())
            )
        if gauges:
            lines.append(
                "gauges: " + " ".join(f"{k}={v}" for k, v in gauges.items())
            )
        if not lines:
            lines.append("no metrics recorded yet")
        return lines

    def close(self) -> None:
        f = self._jsonl_f
        if f is not None:
            self._jsonl_f = None
            f.close()


class _Timer:
    __slots__ = ("_m", "_name", "_t0")

    def __init__(self, m: MetricsRegistry, name: str) -> None:
        self._m = m
        self._name = name

    def __enter__(self) -> "_Timer":
        self._t0 = wall_time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._m.observe(self._name, wall_time.perf_counter() - self._t0)
