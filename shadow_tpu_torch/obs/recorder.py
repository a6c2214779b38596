"""The per-run obs facade: phase spans feeding metrics AND the tracer.

The JAX package's ``obs/recorder.py`` on the port.  A phase span is the
unit of wall attribution::

    with obs.phase("device_turn", window_end=we):
        ...

On exit the measured duration lands in the metrics registry's per-phase
wall totals and — when tracing is on — as one Chrome-trace complete
event, from the *same* ``perf_counter`` pair, so the trace's summed span
wall per phase and the METRICS report's ``phase_wall_s`` agree by
construction.

The engine-facing phase vocabulary:

- ``window_compute``  — host-side window execution + barrier (cpu);
- ``device_turn``     — one device round and its readback (the lane
  engine's step driver, ``device_round``; the whole device loop in
  device mode, ``device_free_run``) or one hybrid dispatch;
- ``injection``       — staged-send block packing + H2D copy (hybrid);
- ``egress``          — egress-slice D2H read + delivery application
  (hybrid);
- ``syscall_service`` — managed hosts' syscall-plane round, barrier
  included (hybrid; on the multiprocess engine the collect leg of the
  round — the barrier wait that IS the workers' execution wall);
- ``worker_pipe``     — the pipe ship leg of a multiprocess hybrid
  round; disjoint from the collect leg, so phase walls tile the round
  without double-counting;
- ``fault_swap``      — fault-table epoch application at a window
  boundary (cpu backend).

``jax_annotations=True`` (the config key ``obs_jax_annotations`` keeps
the JAX package's name) additionally wraps every span in
``torch.profiler.record_function``, so the same phase names appear in a
``torch.profiler`` trace of the run — a pass-through, not a second
measurement.

The device-turn ledger (``obs_turns``, the JAX package's
``obs/turns.py``) is ROADMAP item 12 and not ported: ``turns`` is always
None here, and the config refuses ``obs_turns``.
"""

from __future__ import annotations

import time as wall_time
from pathlib import Path
from typing import Optional

from .metrics import MetricsRegistry
from .tracer import Tracer

PHASES = (
    "window_compute",
    "device_turn",
    "injection",
    "egress",
    "syscall_service",
    "worker_pipe",
    "fault_swap",
)


class _PhaseSpan:
    __slots__ = ("_rec", "phase", "name", "args", "_t0", "_ann")

    def __init__(
        self, rec: "Recorder", phase: str, name: Optional[str], args: dict
    ) -> None:
        self._rec = rec
        self.phase = phase
        self.name = name or phase
        self.args = args
        self._ann = None

    def __enter__(self) -> "_PhaseSpan":
        rec = self._rec
        if rec._annotate is not None:
            self._ann = rec._annotate(self.name)
            self._ann.__enter__()
        self._t0 = wall_time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t0 = self._t0
        dur = wall_time.perf_counter() - t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._rec._record(self.phase, self.name, t0, dur, self.args)


class Recorder:
    """Owns one run's metrics registry and (optionally) tracer.

    Engines carry ``self.obs: Optional[Recorder] = None`` and guard every
    hook with ``if obs is not None`` — disabled means zero overhead, the
    same contract as ``perf_log``."""

    def __init__(
        self,
        run_id: str = "run",
        out_dir: Optional[str | Path] = None,
        trace: bool = False,
        jsonl: bool = False,
        jax_annotations: bool = False,
        trace_capacity: Optional[int] = None,
    ) -> None:
        self.run_id = run_id
        self.out_dir = Path(out_dir) if out_dir is not None else None
        jsonl_path = (
            self.out_dir / f"metrics_{run_id}.jsonl"
            if (jsonl and self.out_dir is not None)
            else None
        )
        self.metrics = MetricsRegistry(run_id=run_id, jsonl_path=jsonl_path)
        self.tracer: Optional[Tracer] = None
        if trace:
            self.tracer = (
                Tracer() if trace_capacity is None else Tracer(trace_capacity)
            )
        # the device-turn ledger is not ported (ROADMAP item 12)
        self.turns = None
        self._annotate = None
        if jax_annotations:
            import torch.profiler

            self._annotate = torch.profiler.record_function
        self.finalized: Optional[dict] = None

    # -- span API ----------------------------------------------------------

    def phase(self, phase: str, name: Optional[str] = None, **args):
        return _PhaseSpan(self, phase, name, args)

    def record(
        self,
        phase: str,
        name: Optional[str],
        t0: float,
        dur_s: float,
        **args,
    ) -> None:
        """Record an already-measured span (``t0`` from
        ``wall_time.perf_counter()``): the hook for code that timed the
        block anyway (sync_stats, the step driver) — one clock pair, no
        second measurement."""
        self._record(phase, name or phase, t0, dur_s, args)

    def _record(
        self, phase: str, name: str, t0: float, dur_s: float, args: dict
    ) -> None:
        m = self.metrics
        m.phase_add(phase, dur_s)
        if m.jsonl_path is not None:
            rec = {"ev": "span", "phase": phase, "name": name,
                   "ts_s": t0 - m._t0, "dur_s": dur_s}
            if args:
                rec["args"] = args
            m.stream(rec)
        if self.tracer is not None:
            self.tracer.complete(name, phase, t0, dur_s, args or None)

    # -- finalize ----------------------------------------------------------

    def finalize(self, extra: Optional[dict] = None) -> dict:
        """Write the run artifacts (``METRICS_<run_id>.json`` and, when
        tracing, ``trace_<run_id>.json``) into ``out_dir`` and return
        ``{"report": ..., "metrics_path": ..., "trace_path": ...}``.
        Idempotent per recorder: the second call returns the first
        result."""
        if self.finalized is not None:
            return self.finalized
        out: dict = {}
        report_extra = dict(extra or {})
        if self.tracer is not None:
            report_extra.setdefault("trace_spans", self.tracer.span_count())
            report_extra.setdefault("trace_dropped", self.tracer.dropped)
        if self.out_dir is not None:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            if self.tracer is not None:
                out["trace_path"] = str(
                    self.tracer.export(
                        self.out_dir / f"trace_{self.run_id}.json",
                        extra={"run_id": self.run_id},
                    )
                )
            out["metrics_path"] = str(
                self.metrics.write_report(
                    self.out_dir / f"METRICS_{self.run_id}.json",
                    extra=report_extra,
                )
            )
        out["report"] = self.metrics.report(extra=report_extra)
        self.metrics.close()
        self.finalized = out
        return out
