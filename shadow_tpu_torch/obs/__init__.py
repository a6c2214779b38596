"""Structured observability: span tracing, metrics and the network planes.

One :class:`Recorder` per run owns a
:class:`~shadow_tpu_torch.obs.metrics.MetricsRegistry` (counters,
gauges, timers, per-window histograms, per-phase wall attribution) and —
when tracing is enabled — a :class:`~shadow_tpu_torch.obs.tracer.Tracer`
(Chrome-trace/Perfetto span export).  Engines hold ``self.obs`` exactly
like ``self.perf_log``: ``None`` (the default) costs nothing — every hook
is behind an ``if obs is not None`` branch — and the facade
(:mod:`shadow_tpu_torch.engine.sim`) sets it from
``experimental.obs_metrics`` / ``obs_trace`` / ``obs_jsonl`` (and from
``netobs`` / ``flowtrace``, whose reports ride the same lifecycle).

obs reads wall clocks and engine counters and writes only its own
artifacts: it never feeds a value back into the simulation, so event
ordering is the same with obs on or off.  :mod:`.netobs` and
:mod:`.flowtrace` are the two simulated-network planes the lane kernels
record on the device.
"""

from __future__ import annotations

from .metrics import MetricsRegistry
from .recorder import PHASES, Recorder
from .tracer import Tracer

__all__ = ["MetricsRegistry", "PHASES", "Recorder", "Tracer"]
